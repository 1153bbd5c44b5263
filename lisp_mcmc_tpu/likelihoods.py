"""Log-probability density library and dataset likelihood reductions.

Rebuilds the reference's L1 statistical primitives (mcmc-fitting.lisp):
  - ``log-normal`` (372-377), ``log-poisson`` + ``log-factorial`` (379-383)
  - ``log-liklihood-normal`` (393-400): sum of Gaussian log-pdfs of the
    residuals over all data points
  - ``log-liklihood-normal-cutoff`` (419-427): per-point log-pdf clamped to
    ``max(-5000, .)``
  - ``create-log-liklihood-function`` (402-417): HOF building a dataset
    likelihood from a per-point ``(y, model, error) -> logp`` function
  - ``log-liklihood-normal-weighted`` (README.md:19-25, defined only in the
    README): weighted normal with scalar-error broadcast — broadcast here is
    handled once at data-cleaning time, so this is the standard reduction
  - data-dependent likelihoods (``log-liklihood-fixer``, 842-845): a
    likelihood factory may return a specialized function when first called

Design: each likelihood is a pure function
``likelihood(fn, params_dict, dataset) -> scalar`` evaluated for ONE walker;
the fitting kernel ``vmap``s it over the ``(W, d)`` walker batch so all N
data points x W walkers become one fused elementwise block + masked
reduction under XLA.  Masked sums give static shapes (padding contributes
exactly 0).  The whole-chunk GPU kernel (``ops/chunk_pallas.py``)
re-derives the library reductions in its own term algebra; these
implementations are the ground truth for its tests.

The misspelling "liklihood" is deliberate in the reference; this rebuild
uses the correct spelling and keeps aliases for discoverability.
"""

from __future__ import annotations

import math
from typing import Callable

import jax.numpy as jnp
from jax.scipy.special import gammaln

from .data import Dataset

__all__ = [
    "log_normal",
    "log_poisson",
    "log_factorial",
    "log_likelihood_normal",
    "log_likelihood_normal_cutoff",
    "log_likelihood_normal_weighted",
    "log_likelihood_poisson",
    "make_student_t_likelihood",
    "make_noise_scale_likelihood",
    "make_x_error_likelihood",
    "create_log_likelihood_function",
    "resolve_likelihood",
    "pointwise_log_likelihood",
    "pointwise_cdf",
]

_LOG_2PI = math.log(2.0 * math.pi)


def log_normal(x, mu, sigma):
    """Gaussian log-pdf (``log-normal``, mcmc-fitting.lisp:372-377)."""
    z = (x - mu) / sigma
    return -0.5 * _LOG_2PI - jnp.log(sigma) - 0.5 * z * z


def log_factorial(n):
    """``log-factorial`` (379-380) via lgamma: exact for integer n >= 0."""
    return gammaln(n + 1.0)


def log_poisson(lam, k):
    """Poisson log-pmf (``log-poisson``, 382-383)."""
    return k * jnp.log(lam) - lam - log_factorial(k)


def _model_eval(fn, params, x):
    """Evaluate the user model on the dataset's x column(s)."""
    return fn(x, params)


def log_likelihood_normal(fn, params, dataset: Dataset):
    """Masked sum of Gaussian log-pdfs (``log-liklihood-normal``, 393-400).

    Algebraically identical to ``sum(mask * log_normal(y, mu, sigma))`` but
    with the walker-independent terms (``-log sigma - log(2 pi)/2`` and the
    ``1/sigma`` normalization) precomputed on the dataset, so the per-walker
    hot block is multiplies and one reduction — no divides or logs.
    """
    mu = _model_eval(fn, params, dataset.x)
    z = (dataset.y - mu) * dataset.inv_sigma
    return dataset.log_norm_const - 0.5 * jnp.sum(z * z)


def log_likelihood_normal_cutoff(fn, params, dataset: Dataset, cutoff=-5000.0):
    """Clamped per-point normal (``log-liklihood-normal-cutoff``, 419-427)."""
    mu = _model_eval(fn, params, dataset.x)
    z = (dataset.y - mu) * dataset.inv_sigma
    lp = jnp.maximum(cutoff, dataset.log_norm_const_point - 0.5 * z * z)
    return jnp.sum(lp * dataset.mask)


# The README's weighted variant (README.md:19-25) differs from the plain
# normal reduction only by broadcasting a scalar error over the points —
# which Dataset.create already performs — so it is the same reduction.
log_likelihood_normal_weighted = log_likelihood_normal


def log_likelihood_poisson(fn, params, dataset: Dataset):
    """Poisson counting-data likelihood: model = rate, y = counts.

    The reference ships ``log-poisson`` (382) as a primitive without a
    dataset reduction; BASELINE.json config 3 makes the Poisson kernel path
    a first-class target, so the reduction is provided here.
    """
    lam = _model_eval(fn, params, dataset.x)
    # lgamma(y!) is walker-independent and cached on the Dataset (already
    # masked), so it never enters the per-step hot block.
    lp = (dataset.y * jnp.log(lam) - lam) * dataset.mask
    return jnp.sum(lp) - jnp.sum(dataset.log_fact_y)


def make_student_t_likelihood(nu: float = 4.0):
    """Outlier-robust Student-t likelihood factory (new surface).

    The Gaussian reduction (``log_likelihood_normal``) lets a single
    bad point veto the fit — its quadratic tail charges z^2/2 per
    sigma.  Student-t with ``nu`` degrees of freedom charges only
    (nu+1)/2 * log(1 + z^2/nu): outliers are *discounted*, not fatal,
    and the fit converges to the consensus of the inliers (tested
    against a contaminated line fit).  ``nu -> inf`` recovers the
    Gaussian; nu=4 is a good general-purpose default (finite variance
    needs nu > 2).  Nearest reference analogue: the hard clamp of
    ``log-liklihood-normal-cutoff`` (mcmc-fitting.lisp:419-427), which
    flattens the tail entirely instead of heavy-tailing it.

    Ships its per-point form (WAIC/PSIS-LOO ready) and a predictive
    sampler, so the whole predictive toolchain works unchanged.
    """
    nu = float(nu)
    if nu <= 0:
        raise ValueError("make_student_t_likelihood: nu must be > 0")
    const = float(gammaln((nu + 1.0) / 2.0) - gammaln(nu / 2.0)
                  - 0.5 * math.log(nu * math.pi))
    half = 0.5 * (nu + 1.0)

    def likelihood(fn, params, dataset: Dataset):
        mu = _model_eval(fn, params, dataset.x)
        z = (dataset.y - mu) * dataset.inv_sigma         # masked
        # log sigma term reuses the cached Gaussian constant: the
        # per-point Student-t constant differs from the Gaussian's
        # -log(2 pi)/2 by (const + log(2 pi)/2), a scalar.
        n_real = jnp.sum(dataset.mask)
        return (dataset.log_norm_const
                + (const + 0.5 * _LOG_2PI) * n_real
                - half * jnp.sum(jnp.log1p(z * z / nu)))

    def _pointwise(fn, params, dataset: Dataset):
        mu = _model_eval(fn, params, dataset.x)
        z = (dataset.y - mu) * dataset.inv_sigma
        per = (dataset.log_norm_const_point
               + (const + 0.5 * _LOG_2PI) * dataset.mask
               - half * jnp.log1p(z * z / nu))
        return per * dataset.mask

    def _sampler(key, mu, dataset):
        import jax

        sigma = jnp.asarray(dataset.sigma)[None, : mu.shape[1]]
        return mu + sigma * jax.random.t(key, nu, mu.shape, mu.dtype)

    def _cdf(fn, params, dataset: Dataset):
        from jax.scipy.special import betainc

        mu = _model_eval(fn, params, dataset.x)
        z = (dataset.y - mu) * dataset.inv_sigma
        # Student-t CDF via the regularized incomplete beta: for z >= 0,
        # F(z) = 1 - I_{nu/(nu+z^2)}(nu/2, 1/2) / 2, mirrored below 0.
        tail = 0.5 * betainc(nu / 2.0, 0.5, nu / (nu + z * z))
        return jnp.where(z >= 0.0, 1.0 - tail, tail)

    def _sbc_simulator(rng, mu, sigma, params):
        # Host-side generative twin for sbc_check: one simulated dataset
        # per call (numpy rng; mu/sigma are (P,) for the shared grid).
        return mu + sigma * rng.standard_t(nu, mu.shape)

    likelihood.__name__ = f"student_t_likelihood_nu{nu:g}"
    likelihood._pointwise = _pointwise
    likelihood._predictive_sampler = _sampler
    likelihood._pointwise_cdf = _cdf
    likelihood._sbc_simulator = _sbc_simulator
    likelihood._nu = nu
    return likelihood


def make_noise_scale_likelihood(key: str = "noise_scale"):
    """Gaussian likelihood with the noise level as a FITTED parameter.

    The reference (and ``log_likelihood_normal``) require ``data_error``
    known up front; in practice it often is not.  This factory reads a
    noise-scale parameter ``params[key]`` (k) and scales every sigma by
    it: ``sigma_eff = k * sigma``.  With ``data_error=1`` the parameter
    IS the noise level.  The whole correction is closed-form on top of
    the cached constants — ``-N log k`` and ``/k^2`` on the cached
    z-sum — so the hot block stays multiplies plus one reduction.

    Give k a positive bounds prior (e.g. ``(1e-3, 1e3)``); k <= 0 hits
    the NaN floor.  The posterior for k is the classic scale posterior
    (~ sqrt of reduced chi-square at the best fit).  Ships pointwise
    (WAIC/LOO) and a params-aware predictive sampler, so coverage checks
    reflect the FITTED noise, closing the understated-``data_error``
    failure mode the SBC/PPC tests demonstrate.
    """

    def likelihood(fn, params, dataset: Dataset):
        k = params[key]
        mu = _model_eval(fn, params, dataset.x)
        z = (dataset.y - mu) * dataset.inv_sigma
        n_real = jnp.sum(dataset.mask)
        return (dataset.log_norm_const - n_real * jnp.log(k)
                - 0.5 * jnp.sum(z * z) / (k * k))

    def _pointwise(fn, params, dataset: Dataset):
        k = params[key]
        mu = _model_eval(fn, params, dataset.x)
        z = (dataset.y - mu) * dataset.inv_sigma
        per = (dataset.log_norm_const_point - jnp.log(k) * dataset.mask
               - 0.5 * z * z / (k * k))
        return per * dataset.mask

    def _sampler(rng_key, mu, dataset, params_s):
        import jax

        sigma = jnp.asarray(dataset.sigma)[None, : mu.shape[1]]
        k = jnp.asarray(params_s[key])[:, None]          # (S, 1)
        return mu + k * sigma * jax.random.normal(rng_key, mu.shape, mu.dtype)

    def _cdf(fn, params, dataset: Dataset):
        from jax.scipy.special import ndtr

        k = params[key]
        mu = _model_eval(fn, params, dataset.x)
        z = (dataset.y - mu) * dataset.inv_sigma
        return ndtr(z / k)

    def _sbc_simulator(rng, mu, sigma, params):
        # Generative twin: the TRUE k scales the noise (k is a fitted
        # parameter, so sbc_check draws it from the prior spec too).
        k = float(params[key])
        return mu + k * sigma * rng.standard_normal(mu.shape)

    likelihood.__name__ = f"noise_scale_likelihood[{key}]"
    likelihood._pointwise = _pointwise
    likelihood._predictive_sampler = _sampler
    likelihood._pointwise_cdf = _cdf
    likelihood._sbc_simulator = _sbc_simulator
    likelihood._noise_key = key
    return likelihood


def make_x_error_likelihood(sigma_x):
    """Errors-in-variables (York/ODR) likelihood: x AND y uncertain.

    Ordinary least squares with noisy abscissae suffers regression
    dilution: the fitted slope biases toward zero by the factor
    ``1/(1 + sigma_x^2/Var(x_true))`` (tested).  The consistent remedy
    is the PROFILE likelihood over the latent true abscissae — for a
    locally linear model that is York's (1966) / orthogonal-distance
    objective

        -sum_i r_i^2 / (2 sigma_eff_i^2),
        sigma_eff_i^2 = sigma_y_i^2 + (df/dx|_{x_i})^2 sigma_x^2

    with NO parameter-dependent log-normalization term.  That omission
    is load-bearing, and this factory's own test derived it the hard
    way: the marginal ("flat prior on true x") likelihood carries
    -log(sigma_eff)/point, which penalizes steep slopes and leaves the
    MLE attenuated almost as badly as OLS (measured 4.41 vs truth 5.0,
    OLS 4.47 — the Neyman-Scott incidental-parameter effect); the
    profile form is stationary at the true slope (measured 4.86 +-
    sampling error on the same data, within 3%).

    ``jax.jvp`` supplies the elementwise df/dx for ANY model at one
    extra forward pass — no user derivative, something the Lisp
    reference could never offer generically.  ``sigma_x``: scalar or
    per-point (the user's N points; lane padding is handled here).
    1-D x only — with linked multi-column abscissae an isotropic
    sigma_x is ambiguous (and the all-ones jvp tangent would sum
    partials across columns).  Note this is a pseudo-likelihood
    (normalization anchored at sigma_y): per-point values support
    WAIC/LOO comparison only between models sharing the same sigma_x
    structure.
    """
    import jax

    sigma_x = jnp.asarray(sigma_x)
    if sigma_x.ndim > 1:
        raise ValueError("make_x_error_likelihood: sigma_x must be a "
                         "scalar or a 1-D per-point array")

    def _xe(dataset: Dataset):
        """sigma_x aligned to the dataset's padded lane length."""
        if jnp.ndim(dataset.x) != 1:
            raise ValueError(
                "make_x_error_likelihood: multi-column x is unsupported "
                "(an isotropic sigma_x is ambiguous across columns)")
        if sigma_x.ndim == 0:
            return sigma_x
        p = dataset.sigma.shape[0]
        n = sigma_x.shape[0]
        if n > p:
            raise ValueError(
                f"make_x_error_likelihood: sigma_x has {n} entries but "
                f"the dataset holds {int(dataset.n)} points")
        if n < p:                      # pad lanes carry 0 (masked anyway)
            return jnp.concatenate(
                [sigma_x, jnp.zeros(p - n, sigma_x.dtype)])
        return sigma_x

    def _mu_dmu(fn, params, x):
        return jax.jvp(lambda xx: _model_eval(fn, params, xx),
                       (x,), (jnp.ones_like(x),))

    def _per_point(fn, params, dataset: Dataset):
        mu, dmu = _mu_dmu(fn, params, dataset.x)
        var_eff = dataset.sigma**2 + (dmu * _xe(dataset)) ** 2
        r = dataset.y - mu
        return (dataset.log_norm_const_point
                - 0.5 * r * r / var_eff) * dataset.mask

    def likelihood(fn, params, dataset: Dataset):
        return jnp.sum(_per_point(fn, params, dataset))

    def _sampler(key, mu, dataset):
        # mu here is the (S, P) curve block; the effective sigma needs
        # dmu per sample — approximate with the per-point y-sigma plus
        # the x-error mapped through the local finite slope of each
        # sampled curve.  The spacing's SIGN is irrelevant (dx is
        # squared below), so clamp its magnitude — clamping the signed
        # value turned descending-x grids into 1e-300 spacings and
        # infinite replicates (review finding).
        import jax as _jax

        p = mu.shape[1]
        sigma_y = jnp.asarray(dataset.sigma)[None, :p]
        x = jnp.asarray(dataset.x)[:p]
        spacing = jnp.gradient(x)
        spacing = jnp.where(jnp.abs(spacing) < 1e-30, 1e-30, spacing)
        dx = jnp.gradient(mu, axis=1) / spacing[None, :]
        xe = _xe(dataset)
        xe = xe[None, :p] if xe.ndim else xe
        sig = jnp.sqrt(sigma_y**2 + (dx * xe) ** 2)
        return mu + sig * _jax.random.normal(key, mu.shape, mu.dtype)

    likelihood.__name__ = "x_error_likelihood"
    likelihood._pointwise = _per_point
    likelihood._predictive_sampler = _sampler
    likelihood._sigma_x = sigma_x
    return likelihood


def create_log_likelihood_function(point_log_likelihood: Callable):
    """HOF: per-point ``(y, model, sigma) -> logp`` to a dataset likelihood.

    Mirrors ``create-log-liklihood-function`` (mcmc-fitting.lisp:402-417).
    """

    def likelihood(fn, params, dataset: Dataset):
        mu = _model_eval(fn, params, dataset.x)
        lp = point_log_likelihood(dataset.y, mu, dataset.sigma)
        return jnp.sum(lp * dataset.mask)

    def _pointwise(fn, params, dataset: Dataset):
        mu = _model_eval(fn, params, dataset.x)
        return point_log_likelihood(dataset.y, mu, dataset.sigma) * dataset.mask

    likelihood.__name__ = getattr(point_log_likelihood, "__name__", "custom") + "_likelihood"
    likelihood._pointwise = _pointwise
    return likelihood


# The library reductions pointwise_log_likelihood recognizes by
# identity.  Guards that ask "does this likelihood have a per-point
# form?" (diagnostics._require_per_point) must consult THIS tuple plus
# the `_pointwise` attribute — a private copy of the list would drift.
LIBRARY_POINTWISE = None  # assigned below (the branches define the set)


def pointwise_log_likelihood(likelihood, fn, params, dataset: Dataset):
    """Per-point log-density vector for one walker (padded lanes -> 0).

    The un-reduced form of the dataset likelihoods above — the raw
    material for predictive model comparison (``diagnostics.waic``).
    Library reductions are recognized by identity; likelihoods built by
    :func:`create_log_likelihood_function` carry their own per-point
    form.  Summing the result reproduces the reduction exactly (the
    cached walker-independent constants are included per point).
    """
    if likelihood is log_likelihood_normal:
        mu = _model_eval(fn, params, dataset.x)
        z = (dataset.y - mu) * dataset.inv_sigma     # inv_sigma is masked
        return dataset.log_norm_const_point - 0.5 * z * z
    if likelihood is log_likelihood_normal_cutoff:
        mu = _model_eval(fn, params, dataset.x)
        z = (dataset.y - mu) * dataset.inv_sigma
        lp = jnp.maximum(-5000.0, dataset.log_norm_const_point - 0.5 * z * z)
        return lp * dataset.mask
    if likelihood is log_likelihood_poisson:
        lam = _model_eval(fn, params, dataset.x)
        return (dataset.y * jnp.log(lam) - lam) * dataset.mask - dataset.log_fact_y
    pw = getattr(likelihood, "_pointwise", None)
    if pw is not None:
        return pw(fn, params, dataset)
    raise ValueError(
        "pointwise_log_likelihood: unrecognized likelihood "
        f"{getattr(likelihood, '__name__', likelihood)!r} — use a library "
        "reduction or create_log_likelihood_function (custom reductions "
        "have no recoverable per-point form)")


LIBRARY_POINTWISE = (log_likelihood_normal, log_likelihood_normal_cutoff,
                     log_likelihood_poisson)


def pointwise_cdf(likelihood, fn, params, dataset: Dataset):
    """Per-point predictive CDF ``P(Y_i <= y_i | theta)`` for one walker.

    The probability-integral-transform counterpart of
    :func:`pointwise_log_likelihood` — the raw material for LOO-PIT
    calibration (``diagnostics.loo_pit``).  Continuous likelihoods
    return the exact CDF at the observed point; the discrete Poisson
    returns the deterministic mid-p value ``F(y) - p(y)/2`` (the
    expectation of the randomized PIT).  Padded lanes return 0.5 (they
    are dropped by the caller's mask anyway).
    """
    from jax.scipy.special import ndtr

    if likelihood in (log_likelihood_normal, log_likelihood_normal_cutoff):
        mu = _model_eval(fn, params, dataset.x)
        z = (dataset.y - mu) * dataset.inv_sigma       # pads: z = 0 -> 0.5
        return ndtr(z)
    if likelihood is log_likelihood_poisson:
        from jax.scipy.special import gammaincc

        lam = _model_eval(fn, params, dataset.x)
        # P(Y <= y) for Poisson(lam) = Q(y+1, lam) (regularized upper
        # incomplete gamma); mid-p subtracts half the point mass.
        cdf_y = gammaincc(dataset.y + 1.0, lam)
        pmf = jnp.exp(dataset.y * jnp.log(lam) - lam - dataset.log_fact_y)
        return jnp.where(dataset.mask > 0, cdf_y - 0.5 * pmf, 0.5)
    cdf = getattr(likelihood, "_pointwise_cdf", None)
    if cdf is not None:
        return cdf(fn, params, dataset)
    raise ValueError(
        "pointwise_cdf: no per-point predictive CDF for likelihood "
        f"{getattr(likelihood, '__name__', likelihood)!r} — LOO-PIT needs "
        "a library reduction or a factory that ships _pointwise_cdf "
        "(student-t and noise-scale do; custom reductions don't)")


def resolve_likelihood(likelihood, fn, params, dataset: Dataset):
    """Resolve a data-dependent likelihood factory to a plain likelihood.

    The reference lets a likelihood *return a function* specialized to the
    data on first call (``log-liklihood-fixer``, mcmc-fitting.lisp:842-845).
    If calling ``likelihood`` yields a callable, that callable replaces it;
    a numeric result means it already is the likelihood.
    """
    result = likelihood(fn, params, dataset)
    if callable(result):
        return result
    return likelihood
