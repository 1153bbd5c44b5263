"""Prior system: flat priors, smooth bound penalties, constraint combinators.

Rebuilds the reference's prior layer (mcmc-fitting.lisp):
  - ``log-prior-flat`` (340-343): always 0.
  - ``prior-bounds-let`` macro (346-369): per-parameter (low, high) bounds
    with the smooth exterior penalty
        ``-1d10 * (exp(1d-5 * dist) - 1)``
    where ``dist`` is the distance to the *nearer* bound (358-360).  Inside
    the open interval the penalty is exactly 0.  The macro also exposes
    per-parameter penalties (``<name>-bound``) and their sum
    (``bounds-total``) so user priors can add extra terms.
  - data-dependent priors (``log-prior-fixer``, 837-840): a prior factory
    may return a specialized prior function when first called with data.
  - hard constraint style from ``nv-specific.lisp:31-34``: -1e9 penalties
    for inequality/ratio constraints between parameters.

Design: a prior is a pure function ``prior(params_dict, dataset)
-> scalar`` for one walker, vmapped over walkers by the kernel.  The bound
penalty is fully vectorized (`jnp.where`), so it fuses into the posterior
evaluation; there is no host-side control flow.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Mapping

import jax.numpy as jnp

__all__ = [
    "log_prior_flat",
    "bound_penalty",
    "prior_bounds",
    "make_bounds_prior",
    "constraint_penalty",
    "combine_priors",
    "resolve_prior",
    "Uniform",
    "Gaussian",
    "LogNormal",
    "PriorSpec",
    "as_prior_spec",
    "resolve_prior_spec",
    "MVGaussian",
]

# Exact constants from mcmc-fitting.lisp:360.
_PENALTY_SCALE = -1e10
_PENALTY_RATE = 1e-5


def log_prior_flat(params, dataset=None):
    """``log-prior-flat`` (mcmc-fitting.lisp:340-343)."""
    return jnp.asarray(0.0)


def bound_penalty(value, low, high):
    """Smooth exterior penalty for one parameter (mcmc-fitting.lisp:358-360).

    0 inside the open interval (low, high); outside,
    ``-1e10 * (exp(1e-5 * min(|v-high|, |v-low|)) - 1)`` — an exponential
    gradient pointing back toward the feasible region.
    """
    value = jnp.asarray(value)
    dist = jnp.minimum(jnp.abs(value - high), jnp.abs(value - low))
    outside = _PENALTY_SCALE * (jnp.exp(_PENALTY_RATE * dist) - 1.0)
    inside = (low < value) & (value < high)
    return jnp.where(inside, 0.0, outside)


def prior_bounds(params: Mapping, bounds: Mapping[str, tuple]) -> dict:
    """Per-parameter penalties + total, the ``prior-bounds-let`` anaphora.

    Returns ``{"<name>_bound": penalty, ..., "bounds_total": sum}`` — the
    vectorized analogue of the macro's generated ``<name>-bound`` variables
    and ``bounds-total`` (mcmc-fitting.lisp:366-368).
    """
    out = {}
    total = jnp.asarray(0.0)
    for name, (low, high) in bounds.items():
        key = name[1:] if name.startswith(":") else name
        p = bound_penalty(params[key], low, high)
        out[f"{key}_bound"] = p
        total = total + p
    out["bounds_total"] = total
    return out


def make_bounds_prior(bounds: Mapping[str, tuple], extra: Callable | None = None):
    """Build a prior from a bounds table; the common ``prior-bounds-let`` use.

    ``extra(params, penalties, dataset) -> scalar`` may add constraint terms
    on top of ``penalties["bounds_total"]`` (e.g. nv-specific.lisp:31-34).
    """

    def prior(params, dataset=None):
        penalties = prior_bounds(params, bounds)
        total = penalties["bounds_total"]
        if extra is not None:
            total = total + extra(params, penalties, dataset)
        return total

    # Checkpointability: the closure carries its own recipe, so
    # checkpoint.py can serialize the bounds table (+ the extra's NAME,
    # resolved from a registry on load) instead of refusing closures.
    prior._bounds = dict(bounds)
    prior._extra = extra
    prior.__name__ = "bounds_prior"
    return prior


def constraint_penalty(satisfied, penalty=-1e9):
    """Hard constraint term: 0 when satisfied, ``penalty`` otherwise.

    The vectorized form of nv-specific.lisp:31-34's
    ``(if (> mu1 mu2) -1e9 0e0)`` constraints.
    """
    return jnp.where(satisfied, 0.0, penalty)


def combine_priors(*priors: Callable):
    """Sum several priors into one."""

    def prior(params, dataset=None):
        total = jnp.asarray(0.0)
        for p in priors:
            total = total + p(params, dataset)
        return total

    return prior


def resolve_prior(prior, params, dataset):
    """Resolve a data-dependent prior factory (``log-prior-fixer``, 837-840).

    If calling the prior yields a callable, that callable is the actual
    prior (specialized to the data); a numeric result means it already was.
    """
    result = prior(params, dataset)
    if callable(result):
        return result
    return prior


# --------------------------------------------------------------------------
# Named prior specs (round-3: non-box priors through the evidence layer).
#
# The reference's prior contract is a log-density TERM added to the
# posterior (prior-bounds-let, mcmc-fitting.lisp:346-369; data-dependent
# fixers 837-845) — the MCMC core here accepts that already.  What it
# cannot express is the *measure* side: evidence estimators, SBC, and
# prior-predictive checks need to SAMPLE the prior and know its
# normalization.  A :class:`PriorSpec` carries both halves for a product
# of independent 1-D distributions:
#
#   - ``sample``   — exact draws (host RNG; seeding, SBC truths,
#     prior-predictive parameters);
#   - ``log_pdf``  — the normalized log-density (reporting, u-space math);
#   - ``installed``— the density term :meth:`PriorSpec.as_log_prior` adds
#     to the posterior (0 for Uniform, matching the reference's
#     zero-inside-bounds behavior; the normalized log-pdf for named
#     distributions);
#   - ``transform``/``inverse`` — the per-parameter inverse-CDF map from
#     the unit cube, the device-friendly reduction that lets every existing
#     box-based estimator (ladder, SMC, nested) run unchanged on a
#     u-space view of the fit where the declared prior IS the unit
#     Lebesgue measure (see fit.unit_cube_view).
#
# Convention (shared by evidence.py / smc.py / nested.py): the declared
# prior pi is the beta=0 reference measure and the "likelihood" is
# exp(logpost - installed), so the estimated Z is
#     Z = integral exp(logpost(theta) - installed(theta)) pi(theta) dtheta.
# For a pure-Uniform spec (installed = 0, pi = 1/V in the box) this is
# exactly the historical uniform-in-bounds convention; for a fit whose
# prior term is ``spec.as_log_prior()`` it is the true Bayesian evidence
# integral L * pi.


def _ndtr_np(x):
    from scipy.special import ndtr

    return ndtr(x)


def _ndtri_np(x):
    from scipy.special import ndtri

    return ndtri(x)


@dataclasses.dataclass(frozen=True)
class Uniform:
    """Uniform(low, high) — the reference's flat-in-bounds prior as a spec."""

    low: float
    high: float

    def __post_init__(self):
        if not self.high > self.low:
            raise ValueError(f"Uniform: need high > low, got ({self.low}, {self.high})")
        if not (math.isfinite(self.low) and math.isfinite(self.high)):
            # An infinite box has no normalizable width (log_pdf would be
            # -inf everywhere) and is_uniform=True with bounds=None would
            # crash the box-path dispatch downstream.
            raise ValueError(
                f"Uniform: bounds must be finite, got ({self.low}, {self.high}); "
                "use Gaussian/LogNormal for unbounded support")

    @property
    def support(self):
        return (float(self.low), float(self.high))

    def sample(self, rng, n):
        return rng.uniform(self.low, self.high, size=n)

    def log_pdf(self, x):
        x = jnp.asarray(x)
        inside = (self.low < x) & (x < self.high)
        return jnp.where(inside, -math.log(self.high - self.low), -jnp.inf)

    def installed_log_pdf(self, x):
        # Reference behavior: a bounds prior adds 0 inside the box
        # (normalization lives in the declared measure, not the term).
        return jnp.zeros_like(jnp.asarray(x, jnp.result_type(float)))

    def wall(self, x):
        return bound_penalty(x, self.low, self.high)

    def icdf(self, u):
        return self.low + (self.high - self.low) * u

    def cdf(self, x):
        return jnp.clip((x - self.low) / (self.high - self.low), 0.0, 1.0)

    def to_meta(self):
        return {"kind": "uniform", "low": float(self.low), "high": float(self.high)}


def _trunc_z(mu, sigma, low, high):
    """(z_low, z_high) CDF values of the truncation points."""
    za = 0.0 if math.isinf(low) else float(_ndtr_np((low - mu) / sigma))
    zb = 1.0 if math.isinf(high) else float(_ndtr_np((high - mu) / sigma))
    if not zb > za:
        raise ValueError(
            f"truncation ({low}, {high}) leaves no mass under "
            f"N({mu}, {sigma}^2)")
    return za, zb


@dataclasses.dataclass(frozen=True)
class Gaussian:
    """Gaussian(mu, sigma), optionally truncated to (low, high)."""

    mu: float
    sigma: float
    low: float = -math.inf
    high: float = math.inf

    def __post_init__(self):
        if not self.sigma > 0:
            raise ValueError(f"Gaussian: need sigma > 0, got {self.sigma}")
        if not self.high > self.low:
            raise ValueError(f"Gaussian: need high > low, got ({self.low}, {self.high})")
        _trunc_z(self.mu, self.sigma, self.low, self.high)  # validate mass

    @property
    def support(self):
        return (float(self.low), float(self.high))

    @property
    def _log_mass(self):
        za, zb = _trunc_z(self.mu, self.sigma, self.low, self.high)
        return math.log(zb - za)

    def sample(self, rng, n):
        za, zb = _trunc_z(self.mu, self.sigma, self.low, self.high)
        u = rng.uniform(za, zb, size=n)
        return self.mu + self.sigma * _ndtri_np(u)

    def _smooth_log_pdf(self, x):
        z = (jnp.asarray(x) - self.mu) / self.sigma
        return (-0.5 * z * z
                - math.log(self.sigma) - 0.5 * math.log(2.0 * math.pi)
                - self._log_mass)

    def log_pdf(self, x):
        x = jnp.asarray(x)
        inside = (self.low < x) & (x < self.high)
        return jnp.where(inside, self._smooth_log_pdf(x), -jnp.inf)

    def installed_log_pdf(self, x):
        return self._smooth_log_pdf(x)

    def wall(self, x):
        if math.isinf(self.low) and math.isinf(self.high):
            return jnp.zeros_like(jnp.asarray(x, jnp.result_type(float)))
        # bound_penalty handles an infinite edge exactly: |v - inf| = inf
        # loses every min() and the inside test stays correct.
        return bound_penalty(x, self.low, self.high)

    def icdf(self, u):
        from jax.scipy.special import ndtri

        za, zb = _trunc_z(self.mu, self.sigma, self.low, self.high)
        return self.mu + self.sigma * ndtri(za + (zb - za) * u)

    def cdf(self, x):
        from jax.scipy.special import ndtr

        za, zb = _trunc_z(self.mu, self.sigma, self.low, self.high)
        z = ndtr((jnp.asarray(x) - self.mu) / self.sigma)
        return jnp.clip((z - za) / (zb - za), 0.0, 1.0)

    def to_meta(self):
        return {"kind": "gaussian", "mu": float(self.mu), "sigma": float(self.sigma),
                "low": None if math.isinf(self.low) else float(self.low),
                "high": None if math.isinf(self.high) else float(self.high)}


@dataclasses.dataclass(frozen=True)
class LogNormal:
    """LogNormal: ``log x ~ N(mu, sigma^2)``, optionally truncated to (low, high)."""

    mu: float
    sigma: float
    low: float = 0.0
    high: float = math.inf

    def __post_init__(self):
        if not self.sigma > 0:
            raise ValueError(f"LogNormal: need sigma > 0, got {self.sigma}")
        if self.low < 0 or not self.high > self.low:
            raise ValueError(
                f"LogNormal: need 0 <= low < high, got ({self.low}, {self.high})")
        self._trunc_z()  # validate mass

    def _trunc_z(self):
        lo = -math.inf if self.low <= 0.0 else math.log(self.low)
        hi = math.inf if math.isinf(self.high) else math.log(self.high)
        return _trunc_z(self.mu, self.sigma, lo, hi)

    @property
    def support(self):
        return (float(self.low), float(self.high))

    @property
    def _log_mass(self):
        za, zb = self._trunc_z()
        return math.log(zb - za)

    def sample(self, rng, n):
        import numpy as np

        za, zb = self._trunc_z()
        u = rng.uniform(za, zb, size=n)
        return np.exp(self.mu + self.sigma * _ndtri_np(u))

    def _smooth_log_pdf(self, x):
        # Clamped log keeps the trace NaN-free at x <= 0; the quadratic
        # term then drives the density to -inf-like values there anyway.
        # The clamp must be dtype-aware: a literal 1e-300 underflows to
        # 0.0 in float32 (the production dtype), making the "clamp"
        # a no-op and the trace NaN at x <= 0.
        x = jnp.asarray(x)
        x = x.astype(jnp.result_type(x.dtype, float))
        lx = jnp.log(jnp.maximum(x, jnp.finfo(x.dtype).tiny))
        z = (lx - self.mu) / self.sigma
        return (-lx - 0.5 * z * z
                - math.log(self.sigma) - 0.5 * math.log(2.0 * math.pi)
                - self._log_mass)

    def log_pdf(self, x):
        x = jnp.asarray(x)
        inside = (x > self.low) & (x < self.high)
        return jnp.where(inside, self._smooth_log_pdf(x), -jnp.inf)

    def installed_log_pdf(self, x):
        return self._smooth_log_pdf(x)

    def wall(self, x):
        if self.low <= 0.0 and math.isinf(self.high):
            # Untruncated: the smooth density already collapses at x <= 0
            # (clamped-log quadratic), no wall needed.
            return jnp.zeros_like(jnp.asarray(x, jnp.result_type(float)))
        return bound_penalty(x, self.low, self.high)

    def icdf(self, u):
        from jax.scipy.special import ndtri

        za, zb = self._trunc_z()
        return jnp.exp(self.mu + self.sigma * ndtri(za + (zb - za) * u))

    def cdf(self, x):
        from jax.scipy.special import ndtr

        za, zb = self._trunc_z()
        lx = jnp.log(jnp.maximum(jnp.asarray(x), 1e-300))
        z = ndtr((lx - self.mu) / self.sigma)
        return jnp.clip((z - za) / (zb - za), 0.0, 1.0)

    def to_meta(self):
        return {"kind": "lognormal", "mu": float(self.mu), "sigma": float(self.sigma),
                "low": float(self.low),
                "high": None if math.isinf(self.high) else float(self.high)}


_DIST_KINDS = {"uniform": Uniform, "gaussian": Gaussian, "lognormal": LogNormal}


def _dist_from_meta(meta: dict):
    kind = meta["kind"]
    cls = _DIST_KINDS[kind]
    kwargs = {k: v for k, v in meta.items() if k != "kind"}
    if kind == "gaussian":
        kwargs["low"] = -math.inf if kwargs.get("low") is None else kwargs["low"]
        kwargs["high"] = math.inf if kwargs.get("high") is None else kwargs["high"]
    if kind == "lognormal":
        kwargs["high"] = math.inf if kwargs.get("high") is None else kwargs["high"]
    return cls(**kwargs)


class PriorSpec(Mapping):
    """A named prior: one independent 1-D distribution per parameter.

    Values may be :class:`Uniform`/:class:`Gaussian`/:class:`LogNormal`
    instances or ``(low, high)`` tuples (coerced to :class:`Uniform`, so
    every existing bounds table is a valid spec).  Mapping protocol
    exposes the distributions; :meth:`as_log_prior` builds the posterior
    term to fit with; the evidence/SBC/predictive layer consumes the
    spec directly (``prior=`` arguments, or recovery from a fitted
    term's ``_prior_spec``).
    """

    def __init__(self, dists: Mapping):
        out = {}
        for k, v in dists.items():
            key = k[1:] if isinstance(k, str) and k.startswith(":") else k
            if isinstance(v, (Uniform, Gaussian, LogNormal)):
                out[key] = v
            elif isinstance(v, (tuple, list)) and len(v) == 2:
                out[key] = Uniform(float(v[0]), float(v[1]))
            else:
                raise ValueError(
                    f"PriorSpec: parameter {key!r} must be a distribution or "
                    f"a (low, high) tuple, got {v!r}")
        self._dists = out

    # Mapping protocol — lets a PriorSpec stand in for a bounds dict
    # anywhere only .keys() iteration order matters (e.g. sbc_check).
    def __getitem__(self, k):
        return self._dists[k]

    def __iter__(self):
        return iter(self._dists)

    def __len__(self):
        return len(self._dists)

    def __repr__(self):
        inner = ", ".join(f"{k}: {v}" for k, v in self._dists.items())
        return f"PriorSpec({{{inner}}})"

    def __eq__(self, other):
        return isinstance(other, PriorSpec) and self._dists == other._dists

    @classmethod
    def from_bounds(cls, bounds: Mapping[str, tuple]) -> "PriorSpec":
        return cls(bounds)

    @property
    def is_uniform(self) -> bool:
        return all(isinstance(d, Uniform) for d in self._dists.values())

    @property
    def bounds(self):
        """Box table when every support is finite, else None."""
        box = {}
        for k, d in self._dists.items():
            lo, hi = d.support
            if math.isinf(lo) or math.isinf(hi):
                return None
            box[k] = (lo, hi)
        return box

    def _ordered(self, keys):
        missing = [k for k in keys if k not in self._dists]
        if missing:
            raise ValueError(f"PriorSpec: missing parameters {missing}")
        return [self._dists[k] for k in keys]

    # ------------------------------------------------------------- sampling
    def sample(self, rng, n: int, keys=None):
        """(n, d) exact prior draws (host numpy RNG), columns in ``keys`` order."""
        import numpy as np

        keys = list(keys) if keys is not None else list(self._dists)
        cols = [np.asarray(d.sample(rng, n)) for d in self._ordered(keys)]
        return np.stack(cols, axis=-1)

    # ------------------------------------------------------------ densities
    def log_pdf(self, params: Mapping, dataset=None):
        """Normalized log prior density at a params dict (jnp scalar)."""
        total = jnp.asarray(0.0)
        for k, d in self._dists.items():
            total = total + d.log_pdf(params[k])
        return total

    def installed_vec(self, theta, keys):
        """Sum of installed density terms at a (d,) parameter vector."""
        total = jnp.asarray(0.0, theta.dtype)
        for i, d in enumerate(self._ordered(keys)):
            total = total + d.installed_log_pdf(theta[i])
        return total

    # ------------------------------------------------------ unit-cube maps
    def transform(self, u, keys):
        """Inverse-CDF map: (d,) unit-cube point -> (d,) parameter vector.

        ``u`` is clamped away from {0, 1} so the map stays finite when a
        proposal steps outside the cube (the wall term rejects it).
        """
        eps = 1e-12 if jnp.asarray(u).dtype == jnp.float64 else 1e-6
        uc = jnp.clip(u, eps, 1.0 - eps)
        cols = [d.icdf(uc[i]) for i, d in enumerate(self._ordered(keys))]
        return jnp.stack(cols).astype(u.dtype)

    def inverse(self, theta, keys):
        """CDF map: (..., d) parameter array -> (..., d) unit-cube points."""
        theta = jnp.asarray(theta)
        cols = [d.cdf(theta[..., i]) for i, d in enumerate(self._ordered(keys))]
        return jnp.stack(cols, axis=-1)

    # ----------------------------------------------------------- fit priors
    def as_log_prior(self) -> Callable:
        """The posterior prior TERM to fit with.

        Uniform components contribute the reference's exterior bound
        penalty (0 inside — mcmc-fitting.lisp:358-360); named components
        contribute their normalized log-density (+ a penalty wall at any
        truncation edge).  The returned callable carries ``_prior_spec``
        (and, for pure-uniform specs, ``_bounds``) so the evidence layer
        and checkpointing can recover the recipe.
        """
        dists = self._dists

        def prior(params, dataset=None):
            total = jnp.asarray(0.0)
            for k, d in dists.items():
                total = total + d.installed_log_pdf(params[k]) + d.wall(params[k])
            return total

        prior._prior_spec = self
        prior.__name__ = "prior_spec"
        if self.is_uniform:
            prior._bounds = {k: d.support for k, d in dists.items()}
            prior._extra = None
        return prior

    # -------------------------------------------------------- serialization
    def to_meta(self) -> dict:
        return {k: d.to_meta() for k, d in self._dists.items()}

    @classmethod
    def from_meta(cls, meta: dict) -> "PriorSpec | MVGaussian":
        if "__mv_gaussian__" in meta:          # correlated-prior recipe
            return MVGaussian.from_meta(meta)
        return cls({k: _dist_from_meta(m) for k, m in meta.items()})


def as_prior_spec(prior_or_bounds) -> "PriorSpec":
    """Coerce a PriorSpec | bounds dict | dist dict into a PriorSpec.

    An :class:`MVGaussian` passes through untouched — coercing it via
    its Mapping face would keep only the marginals and silently drop
    the correlations it exists to carry.
    """
    if isinstance(prior_or_bounds, (PriorSpec, MVGaussian)):
        return prior_or_bounds
    if isinstance(prior_or_bounds, Mapping):
        return PriorSpec(prior_or_bounds)
    raise ValueError(
        f"expected a PriorSpec or a {{param: (low, high) | distribution}} "
        f"mapping, got {type(prior_or_bounds).__name__}")


def resolve_prior_spec(walker, prior=None, bounds=None):
    """Resolution order shared by the evidence/calibration layer.

    explicit ``prior=`` > explicit ``bounds=`` (as a Uniform spec) >
    a ``_prior_spec`` on a fitted term's prior > a ``_bounds`` table on a
    fitted term's prior (``make_bounds_prior``) > None.
    """
    if prior is not None:
        return as_prior_spec(prior)
    if bounds is not None:
        return as_prior_spec(bounds)
    for t in getattr(walker, "terms", None) or []:
        s = getattr(t.prior, "_prior_spec", None)
        if s is not None:
            return s
        b = getattr(t.prior, "_bounds", None)
        if b:
            return PriorSpec.from_bounds(b)
    return None


def unit_cube_wall(u):
    """Exterior penalty keeping a u-space walk inside the unit cube.

    The reference penalty's 1e-5 rate (mcmc-fitting.lisp:360) is tuned
    for physical parameter scales; on the unit cube it is too shallow to
    stay impenetrable at the evidence ladder's hottest rung
    (beta_min ~ 1e-5), so the u-space wall uses a unit rate:
    ``-1e10 * expm1(dist)`` is ~1e8 one percent outside the cube, which
    beta_min scales to ~1e3 — still a hard wall.
    """
    u = jnp.asarray(u)
    dist = jnp.maximum(jnp.maximum(-u, u - 1.0), 0.0)
    return jnp.sum(jnp.where(dist > 0, _PENALTY_SCALE * jnp.expm1(dist), 0.0))


class MVGaussian(Mapping):
    """Correlated Gaussian prior over several parameters jointly.

    The experiment-chaining prior: the posterior of one fit (summarized
    by :func:`~lisp_mcmc_tpu.laplace_approx` — see :meth:`from_laplace`)
    becomes the prior of the next, CORRELATIONS INCLUDED, which a
    product of 1-D :class:`Gaussian` components cannot express.

    Implements the same protocol as :class:`PriorSpec` (sample /
    log_pdf / installed / unit-cube transform+inverse / as_log_prior /
    recipe serialization), so it flows through every estimator the same
    way.  The unit-cube map is ``theta = mean + L @ ndtri(u)`` with
    ``L`` the covariance Cholesky — exactly Gaussian with the declared
    covariance, and still a coordinatewise-monotone-in-u bijection, so
    the u-space machinery (walls, live-set uniformity) is unchanged.

    Mapping access returns the 1-D MARGINAL ``Gaussian(mu_k,
    sqrt(cov_kk))`` — for display and component classification only
    (the joint density is what ``log_pdf``/``installed`` use).
    """

    def __init__(self, mean: Mapping, cov):
        import numpy as np

        self._keys = [k[1:] if isinstance(k, str) and k.startswith(":")
                      else k for k in mean]
        self._mean = np.asarray([float(mean[k]) for k in mean], np.float64)
        self._cov = np.asarray(cov, np.float64)
        d = len(self._keys)
        if self._cov.shape != (d, d):
            raise ValueError(
                f"MVGaussian: cov shape {self._cov.shape} != ({d}, {d})")
        self._cov = 0.5 * (self._cov + self._cov.T)
        try:
            self._chol = np.linalg.cholesky(self._cov)
        except np.linalg.LinAlgError:
            raise ValueError("MVGaussian: covariance is not positive "
                             "definite") from None
        self._log_norm = -0.5 * d * math.log(2.0 * math.pi) \
            - float(np.sum(np.log(np.diag(self._chol))))

    @classmethod
    def from_laplace(cls, laplace, inflate: float = 1.0) -> "MVGaussian":
        """Chain experiments: a LaplaceResult as the next fit's prior.

        ``inflate`` scales the standard deviations (covariance by its
        square) — a mild >1 hedges against the quadratic expansion
        being too confident.  Refuse degenerate curvature: a clamped
        Hessian direction means the 'posterior' never constrained it.
        """
        if getattr(laplace, "n_clamped", 0):
            raise ValueError(
                f"MVGaussian.from_laplace: {laplace.n_clamped} Hessian "
                "direction(s) were clamped — the Laplace covariance is "
                "unreliable along them; fix the fit (or build the prior "
                "by hand) instead of chaining a degenerate curvature")
        return cls(laplace.mode, float(inflate) ** 2 * laplace.cov)

    # ---- Mapping protocol (marginals)
    def __getitem__(self, k):
        import numpy as np

        try:
            i = self._keys.index(k)
        except ValueError:
            # Mapping protocol: __contains__ / missing-parameter checks
            # ("k not in spec") rely on KeyError, not list.index's
            # ValueError, which would crash them mid-comprehension.
            raise KeyError(k) from None
        return Gaussian(float(self._mean[i]),
                        float(np.sqrt(self._cov[i, i])))

    def __iter__(self):
        return iter(self._keys)

    def __len__(self):
        return len(self._keys)

    def __repr__(self):
        return f"MVGaussian(keys={self._keys}, mean={list(self._mean)})"

    def __eq__(self, other):
        import numpy as np

        return (isinstance(other, MVGaussian)
                and self._keys == other._keys
                and np.array_equal(self._mean, other._mean)
                and np.array_equal(self._cov, other._cov))

    @property
    def is_uniform(self) -> bool:
        return False

    @property
    def bounds(self):
        return None

    def _perm(self, keys):
        """Index of each requested key in the internal order."""
        keys = list(keys)
        missing = [k for k in keys if k not in self._keys]
        if missing:
            raise ValueError(f"MVGaussian: missing parameters {missing}")
        if len(keys) != len(self._keys):
            raise ValueError(
                "MVGaussian: a correlated prior covers ALL its parameters "
                f"jointly; asked for {keys}, declared {self._keys}")
        return [self._keys.index(k) for k in keys]      # internal -> keys

    # ---- sampling / densities
    def sample(self, rng, n: int, keys=None):
        import numpy as np

        keys = list(keys) if keys is not None else list(self._keys)
        p = self._perm(keys)
        z = rng.standard_normal((n, len(self._keys)))
        th = self._mean + z @ self._chol.T   # internal order; numpy f64 on host
        return th[:, p]

    def _theta_internal(self, theta, keys):
        p = self._perm(keys)
        inv = [0] * len(p)
        for j, i in enumerate(p):
            inv[i] = j
        return theta[..., jnp.asarray(inv)]

    def log_pdf(self, params: Mapping, dataset=None):
        theta = jnp.stack([jnp.asarray(params[k]) for k in self._keys])
        return self._installed_internal(theta)

    def _installed_internal(self, th_i):
        from jax.scipy.linalg import solve_triangular

        chol = jnp.asarray(self._chol, th_i.dtype)
        z = solve_triangular(chol, th_i - jnp.asarray(self._mean,
                                                      th_i.dtype),
                             lower=True)
        return -0.5 * jnp.sum(z * z) + jnp.asarray(self._log_norm,
                                                   th_i.dtype)

    def installed_vec(self, theta, keys):
        return self._installed_internal(self._theta_internal(theta, keys))

    # ---- unit-cube maps
    def transform(self, u, keys):
        from jax.scipy.special import ndtri

        p = self._perm(keys)
        eps = 1e-12 if jnp.asarray(u).dtype == jnp.float64 else 1e-6
        z_k = ndtri(jnp.clip(u, eps, 1.0 - eps))            # keys order
        inv = [0] * len(p)
        for j, i in enumerate(p):
            inv[i] = j
        z_i = z_k[jnp.asarray(inv)]                         # internal order
        th_i = jnp.asarray(self._mean, u.dtype) + jnp.matmul(
            jnp.asarray(self._chol, u.dtype), z_i,
            precision="highest")    # full f32: a prior map, not a draw
        return th_i[jnp.asarray(p)].astype(u.dtype)

    def inverse(self, theta, keys):
        from jax.scipy.special import ndtr

        theta = jnp.asarray(theta)
        from jax.scipy.linalg import solve_triangular

        th_i = self._theta_internal(theta, keys)
        chol = jnp.asarray(self._chol, theta.dtype)
        z = solve_triangular(chol, (th_i - jnp.asarray(
            self._mean, theta.dtype))[..., None], lower=True)[..., 0]
        u_i = ndtr(z)
        p = self._perm(keys)
        return u_i[..., jnp.asarray(p)]

    # ---- fit prior + recipe
    def as_log_prior(self) -> Callable:
        def prior(params, dataset=None):
            return self.log_pdf(params)

        prior._prior_spec = self
        prior.__name__ = "mv_gaussian_prior"
        return prior

    def to_meta(self) -> dict:
        return {"__mv_gaussian__": {
            "keys": list(self._keys),
            "mean": [float(v) for v in self._mean],
            "cov": [[float(v) for v in row] for row in self._cov],
        }}

    @classmethod
    def from_meta(cls, meta: dict) -> "MVGaussian":
        m = meta["__mv_gaussian__"]
        return cls(dict(zip(m["keys"], m["mean"])), m["cov"])
