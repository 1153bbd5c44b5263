"""Proposal linear algebra: covariance, clamped Cholesky, covariant sampling.

Rebuilds the reference's L2 layer (mcmc-fitting.lisp):
  - ``cholesky-decomp`` (583-598): lower-triangular factor with the diagonal
    clamp ``sqrt(max(0, .))`` (596) so a semi-definite input degrades
    instead of erroring.  (The legacy file instead added ``+1d-16``,
    mcmc-fitting_230522.lisp:481 — the "Cheater Addition"; the current
    clamp semantics are what we replicate.)
  - ``lplist-covariance`` (614-643): population-normalized sample covariance
    (divides by N, not N-1; line 643).
  - ``diagonal-covariance`` (710-727): parameter magnitudes placed directly
    on the diagonal; note the reference uses the result AS an L-matrix
    (proposal stddev per param = |param value|), e.g. mcmc-fitting.lisp:899.
  - ``get-covariant-sample`` (679-700): proposal = mean + L @ z, z ~ N(0, I).
  - Haario optimal scaling ``2.38^2/d`` applied to the L-matrix itself
    (mcmc-fitting.lisp:890) — the reference scales L, not the covariance;
    we replicate that exact policy for parity.

Design: everything is batched and jit-safe.  The Cholesky is an
unrolled column algorithm (d is small and static), with a division guard:
where the reference relies on condition handlers upstream (891-894) to keep
the previous L on numerical failure, we return an ``ok`` flag alongside L
and the caller selects with ``jnp.where`` — branchless failure recovery.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = [
    "cholesky_clamped",
    "sample_covariance",
    "moments_covariance",
    "diagonal_covariance",
    "covariant_sample",
    "haario_scale",
]


def cholesky_clamped(a):
    """Lower Cholesky factor with the reference's diagonal clamp.

    ``a``: (..., d, d) symmetric.  Returns ``(L, ok)`` where ``ok`` is True
    when the factorization is usable (finite, strictly positive diagonal).
    Off-diagonal entries in columns with a zero pivot are set to 0 rather
    than dividing by zero (the reference instead throws and the caller
    keeps the previous L — mcmc-fitting.lisp:891-894; the ok flag lets our
    caller do the same selection branchlessly).
    """
    d = a.shape[-1]
    dtype = a.dtype
    L = jnp.zeros_like(a)
    for j in range(d):
        # r = a[j:, j] - L[j:, :j] @ L[j, :j]
        lj = L[..., j, :j]
        # full f32: a TF32 product here would perturb every refreshed L
        r = a[..., j:, j] - jnp.einsum("...ik,...k->...i", L[..., j:, :j], lj,
                                       precision="highest")
        pivot = jnp.sqrt(jnp.maximum(jnp.asarray(0.0, dtype), r[..., 0]))
        safe = pivot > 0
        inv = jnp.where(safe, pivot, 1.0)
        col = jnp.where(safe[..., None], r[..., 1:] / inv[..., None], 0.0)
        L = L.at[..., j, j].set(pivot)
        if j + 1 < d:
            L = L.at[..., j + 1 :, j].set(col)
    diag = jnp.diagonal(L, axis1=-2, axis2=-1)
    ok = jnp.all(jnp.isfinite(L), axis=(-2, -1)) & jnp.all(diag > 0, axis=-1)
    return L, ok


def sample_covariance(samples, weights=None):
    """Population covariance of ``(..., M, d)`` samples over axis -2.

    ``weights``: optional (..., M) weights (e.g. acceptance masks); the
    normalization divides by the weight total — the reference's
    population normalization (mcmc-fitting.lisp:643) with masking folded
    in so padded/rejected rows contribute nothing.
    """
    samples = jnp.asarray(samples)
    if weights is None:
        count = jnp.asarray(samples.shape[-2], samples.dtype)
        mean = jnp.mean(samples, axis=-2, keepdims=True)
        centered = samples - mean
        # full f32: the refresh covariance must not round through TF32
        return jnp.einsum("...mi,...mj->...ij", centered, centered,
                          precision="highest") / count
    w = weights[..., None]
    count = jnp.maximum(jnp.sum(weights, axis=-1), 1.0)
    mean = jnp.sum(samples * w, axis=-2, keepdims=True) / count[..., None, None]
    centered = samples - mean
    # One factor of w total (sum w (x-mu)(x-mu)^T / sum w): weighting BOTH
    # einsum operands squared the weights — invisible for 0/1 masks,
    # silently wrong for fractional weights.
    return jnp.einsum("...mi,...mj->...ij", centered * w, centered,
                      precision="highest") / count[..., None, None]


def moments_covariance(m_sum, m_outer, m_count):
    """Covariance from accumulated first/second moments.

    ``m_sum``: (d,) sum of samples, ``m_outer``: (d, d) sum of outer
    products, ``m_count``: scalar count.  This is the streaming form of
    ``lplist-covariance`` used by the on-device adaptation (the on-device
    replacement for covariance-of-filtered-history; SURVEY §7 hard part b).
    Population-normalized like the reference (divide by count).
    """
    count = jnp.maximum(m_count, 1.0)
    mean = m_sum / count
    return m_outer / count - jnp.outer(mean, mean)


def diagonal_covariance(values):
    """``diagonal-covariance`` (mcmc-fitting.lisp:710-727): diag(values).

    The reference places the raw parameter values on the diagonal and uses
    the result directly as a proposal L-matrix (per-parameter proposal
    stddev = the parameter's magnitude).
    """
    values = jnp.asarray(values)
    return jnp.zeros(values.shape + values.shape[-1:], values.dtype).at[
        ..., jnp.arange(values.shape[-1]), jnp.arange(values.shape[-1])
    ].set(values)


def covariant_sample(key, mean, l_matrix):
    """Proposal draw: ``mean + L @ z`` (``get-covariant-sample``, 679-700).

    ``mean``: (..., d); ``l_matrix``: (d, d) shared across the batch (the
    pooled-adaptation design) or (..., d, d) per-walker.  Batched as one
    einsum: a single large contraction instead of the reference's
    per-step triple loop (690-697).
    """
    z = jax.random.normal(key, mean.shape, mean.dtype)
    # default precision: a symmetric draw stays symmetric under TF32
    if l_matrix.ndim == 2:
        return mean + jnp.einsum("ij,...j->...i", l_matrix, z)
    return mean + jnp.einsum("...ij,...j->...i", l_matrix, z)


def haario_scale(d: int):
    """The ``2.38^2 / d`` factor (mcmc-fitting.lisp:890).

    Note: the reference multiplies the *L-matrix* by this factor (not the
    covariance); callers replicate that exact behavior.
    """
    return 2.38**2 / d
