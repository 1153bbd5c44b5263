"""ADVI — automatic-differentiation variational inference (new surface).

A Gaussian posterior approximation fit by stochastic gradient ascent on
the ELBO (Kucukelbir et al. 2017), sitting between
:meth:`~lisp_mcmc_tpu.fit.Walker.optimize` (a point) and a full MCMC run
(exact samples): seconds of wall clock buy a mean, a covariance, and a
calibrated evidence reading.  The reference (mcmc-fitting.lisp) has no
analogue — this is the autodiff surface its single-chain MH could never
reach, same as the MALA/HMC kernels.

What it adds to the existing stack:

- **A 5th evidence estimator.**  ``VIResult.log_z`` is the importance-
  sampled evidence ``logmeanexp(logpost + log|J| - log q)`` under the
  fitted q, with a Pareto-k tail diagnostic on the weights (same
  Zhang–Stephens machinery as PSIS-LOO) saying whether to trust it;
  ``VIResult.elbo`` is the guaranteed lower bound.  Both follow the
  shared evidence convention (priors.py "Convention"), so they
  cross-check ``laplace_approx`` / ``log_evidence`` / ``smc_sample`` /
  ``nested_sample`` directly.
- **Experiment chaining without MCMC.** ``VIResult.to_mvgaussian()``
  moment-matches q in parameter space — the
  :class:`~lisp_mcmc_tpu.priors.MVGaussian` correlated prior of the next
  fit, exactly like ``MVGaussian.from_laplace`` but valid when the MAP
  curvature is degenerate (q is fit to the whole posterior, not one
  Hessian).
- **A warm start.** ``VIResult.seed_walker(walker)`` re-draws the
  ensemble from q — a posterior-shaped initialization that skips most
  of the annealing schedule.

Device-first shape: the whole optimization is ONE jitted ``lax.scan``
(``n_steps`` iterations x ``n_samples`` reparameterized draws per
iteration), datasets passed through as pytree arguments — same
compile-once contract as the chunk kernel.  The unconstrained
reparameterization rides the SAME prior machinery as the evidence
layer: with a resolvable :class:`~lisp_mcmc_tpu.priors.PriorSpec` (or
:class:`MVGaussian`), ``theta = F^-1(sigmoid(z))`` maps q's support
onto exactly the declared prior's support (the unit-cube view's map,
fit.py:unit_cube_view), so no q mass is wasted outside a hard bound;
with no spec (custom priors) q lives in ensemble-whitened theta space
and the bound walls act as soft barriers.

Accuracy contract, measured (tests/test_vi.py): on an exactly-Gaussian
posterior ``rank="full"`` recovers mean/cov and its ``log_z`` matches
the Laplace closed form; on the banana-correlated and bounded cases the
Pareto-k flags exactly when the Gaussian family is too small.  ADVI is
an APPROXIMATION — for final numbers on a hard posterior, seed MCMC
from it and sample.

When the Pareto-k flags the Gaussian family itself as too small,
:func:`flow_advi` upgrades q to a RealNVP normalizing flow over the
same z-space — identity-initialized couplings that bend only when the
posterior is curved (tests/test_flow_vi.py: recovers the closed-form
banana evidence the Gaussian family is 0.5 nats biased on).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

__all__ = ["VIResult", "FlowVIResult", "NeutraResult", "advi",
           "flow_advi", "advi_per_dataset", "flow_advi_per_dataset",
           "load_flow"]

_LOG_2PI = math.log(2.0 * math.pi)


def _logmeanexp(x: np.ndarray) -> float:
    m = float(np.max(x))
    if not np.isfinite(m):
        return m
    return m + math.log(float(np.mean(np.exp(x - m))))


def _pareto_k(lw: np.ndarray) -> float:
    """PSIS-style tail-shape diagnostic on log importance weights.

    Fits the generalized Pareto to the largest ``M = min(n/5,
    3 sqrt(n))`` raw weights (Vehtari et al. 2024 recipe, via the shared
    :func:`diagnostics._gpd_fit`).  k < 0.7: the IS estimate is
    trustworthy; larger: q's tails are too light against the posterior
    — trust ``elbo`` as a bound and rerun MCMC for the number.
    """
    from .diagnostics import _gpd_fit

    lw = np.asarray(lw, np.float64)
    lw = lw[np.isfinite(lw)]
    n = lw.size
    if n < 25:
        return float("nan")
    if np.all(lw < -1e10):
        # Every draw hit the non-finite floor (-1e12 "reject"): q found
        # NO region of finite posterior density (e.g. f32 sigmoid
        # saturation when the whole mass hugs a prior-box edge).  The
        # weights are uniform, which would fool the relative-ESS guard
        # below into blessing garbage — report the worst tail instead.
        return float("inf")
    wn = np.exp(lw - lw.max())
    r_eff = float(np.sum(wn) ** 2 / (n * np.sum(wn * wn)))
    if r_eff > 0.95:
        # Near-uniform weights (IS relative ESS > 95%): the estimate is
        # certifiably stable — no draw can dominate — but the GPD tail
        # fit would run on per-mil numerical noise and report garbage
        # (measured k ~ 1.3 on a flow whose elbo matched log_z to 3
        # decimals; k is scale-free by design, which is exactly wrong
        # when the whole weight range is negligible).  Report the
        # healthy tail directly.
        return 0.0
    w = np.exp(lw - lw.max())
    w.sort()
    m = int(min(0.2 * n, 3.0 * math.sqrt(n)))
    cutoff = w[-m - 1]
    excess = w[-m:] - cutoff
    k, _ = _gpd_fit(np.sort(excess))
    return float(k)


@dataclasses.dataclass(frozen=True)
class VIResult:
    """A fitted Gaussian variational posterior.

    ``mean``/``sd`` are parameter-space summaries (moment-matched from
    ``n_eval`` q draws); ``cov`` the matching covariance.  ``elbo`` is
    the evidence lower bound and ``log_z`` the importance-sampled
    evidence estimate (both on the shared convention; ``None`` without
    a resolvable prior spec), ``log_z_error`` its Monte-Carlo batch
    standard error, and ``pareto_k`` the weight-tail diagnostic —
    ``converged_evidence`` summarizes "is log_z trustworthy".
    ``elbo_trace`` is the per-step ELBO for convergence checks.
    """

    keys: tuple
    mean: dict
    sd: dict
    cov: np.ndarray
    elbo: float | None
    log_z: float | None
    log_z_error: float | None
    pareto_k: float
    elbo_trace: np.ndarray
    rank: str
    n_steps: int
    # private machinery for .sample()/.seed_walker(): the z-space
    # Gaussian (mu, L) and the jitted z -> theta map.
    _mu: np.ndarray = dataclasses.field(repr=False)
    _chol: np.ndarray = dataclasses.field(repr=False)
    _theta_of_z: object = dataclasses.field(repr=False)
    _dtype: object = dataclasses.field(repr=False)

    @property
    def converged_evidence(self) -> bool:
        """True when ``log_z`` carries a healthy weight tail (k < 0.7)."""
        return self.log_z is not None and np.isfinite(self.pareto_k) \
            and self.pareto_k < 0.7

    def sample(self, n: int, seed: int = 0) -> np.ndarray:
        """(n, d) parameter-space draws from q."""
        import jax
        import jax.numpy as jnp

        key = jax.random.PRNGKey(seed)
        eps = jax.random.normal(key, (int(n), self._mu.size), self._dtype)
        z = jnp.asarray(self._mu, self._dtype) \
            + eps @ jnp.asarray(self._chol, self._dtype).T
        return np.asarray(self._theta_of_z(z), np.float64)

    def summary(self) -> dict:
        return {k: (self.mean[k], self.sd[k]) for k in self.keys}

    def to_mvgaussian(self, inflate: float = 1.0):
        """Moment-matched correlated prior for the NEXT experiment.

        Like :meth:`MVGaussian.from_laplace` but from the fitted q, so
        it stays valid when the MAP curvature is degenerate.  ``inflate``
        scales the standard deviations (covariance by its square).
        """
        from .priors import MVGaussian

        return MVGaussian({k: self.mean[k] for k in self.keys},
                          float(inflate) ** 2 * self.cov)

    def seed_walker(self, walker, seed: int = 0):
        """Re-draw ``walker``'s ensemble from q (posterior-shaped start).

        Same contract as :func:`~lisp_mcmc_tpu.smc.seed_prior_box`: the
        ensemble is replaced wholesale, so retained history / best-step
        tracking reset to the fresh draws.  Proposal state (L, moments)
        is kept — follow with adaptive steps to re-tune, then sample.
        """
        import dataclasses as _dc

        import jax.numpy as jnp

        pos = jnp.asarray(self.sample(walker.n_walkers, seed=seed),
                          walker.dtype)
        walker.state = _dc.replace(walker.state, position=pos)
        lp = walker._eval_batch(pos)
        walker.reset()
        walker.state = _dc.replace(walker.state, logprob=lp,
                                   best_position=pos, best_logprob=lp)
        return walker

    def __repr__(self):
        z = "None" if self.log_z is None else f"{self.log_z:.4f}"
        e = "None" if self.elbo is None else f"{self.elbo:.4f}"
        return (f"VIResult(rank={self.rank!r}, elbo={e}, log_z={z}, "
                f"pareto_k={self.pareto_k:.3f}, "
                f"trust_log_z={self.converged_evidence})")


def _z_space_setup(walker, prior, bounds, scales=None):
    """Shared unconstrained-space plumbing for the VI families.

    Resolves the prior spec (explicit > fitted ``_prior_spec`` > fitted
    ``_bounds``), builds the ``z -> theta`` map (the declared prior's
    inverse-CDF unit-cube map with a spec — q's support IS the prior's
    support — or the ensemble-whitened identity without), and returns
    the z-space log-posterior with its Jacobian correction, plus the
    ensemble's z-space coordinates for moment initialization.
    ``scales``: externally fixed whitening scales for the no-spec map
    (checkpoint reload — the map must match the SAVED flow, not the
    current ensemble); ignored when a spec resolves.  The resolved
    scales (or None with a spec) come back as the last element.
    """
    import jax
    import jax.numpy as jnp

    from .priors import Uniform, resolve_prior_spec

    keys = list(walker.spec.keys)
    d = len(keys)
    data = walker._posterior_data()
    base = walker._log_post_one
    spec = resolve_prior_spec(walker, prior, bounds)
    if spec is not None:
        missing = [k for k in keys if k not in spec]
        if missing:
            raise ValueError(f"advi: prior/bounds missing {missing}")

    pos = np.asarray(walker.state.position, np.float64)

    if spec is not None:
        # z -> u -> theta through the declared prior's inverse CDF: q's
        # support IS the prior's support, and |J| makes the z-space
        # target exactly the theta-space posterior measure.
        def theta_of_z(z):
            u = jax.nn.sigmoid(z)
            return spec.transform(u, keys)

        # f32 sigmoid saturates at |z| ~ 17 (1 - u rounds to 0), which
        # zeroes the Jacobian and floors every draw — keep the init
        # inside the dtype's representable sigmoid range.
        u_eps = 1e-6 if np.dtype(walker.dtype).itemsize <= 4 else 1e-9
        u0 = np.clip(np.asarray(spec.inverse(pos, keys), np.float64),
                     u_eps, 1.0 - u_eps)
        z0 = np.log(u0) - np.log1p(-u0)
        log_v = float(sum(math.log(spec[k].high - spec[k].low)
                          for k in keys if isinstance(spec[k], Uniform)))
    else:
        # Whitened identity map; bound walls act as soft barriers.
        from .fit import _nonzero_scales

        if scales is None:
            scales = _nonzero_scales(np.median(np.abs(pos), axis=0))
        scales = np.asarray(scales, np.float64)

        def theta_of_z(z):
            return jnp.asarray(scales, z.dtype) * z

        z0 = pos / scales
        log_v = 0.0

    # PriorSpec's inverse-CDF map (and the no-spec whitened identity)
    # are COMPONENTWISE, so the Jacobian is diagonal: one jvp with a
    # ones tangent reads the whole diagonal.  The generic
    # jacfwd+slogdet path (d transform passes + an LU whose gradient is
    # a dense inverse) is kept only for correlated maps (MVGaussian) —
    # it measured ~20x slower inside NeuTra's per-leapfrog gradient.
    from .priors import PriorSpec as _PS

    elementwise = spec is None or isinstance(spec, _PS)

    if elementwise:
        def logdet_j(z):
            _, dz = jax.jvp(theta_of_z, (z,), (jnp.ones_like(z),))
            return jnp.sum(jnp.log(jnp.abs(dz)))
    else:
        def logdet_j(z):
            jac = jax.jacfwd(theta_of_z)(z)
            _, ld = jnp.linalg.slogdet(jac)
            return ld

    def logp_z(z, data):
        lp = base(theta_of_z(z), data) + logdet_j(z)
        return jnp.where(jnp.isfinite(lp), lp, jnp.asarray(-1e12, lp.dtype))

    return (keys, d, data, spec, theta_of_z, z0, log_v, logp_z,
            scales if spec is None else None)


def _build_q(rank: str, d: int):
    """q-parameter pytree helpers: init/L-build/entropy for the rank."""
    import jax.numpy as jnp

    if rank == "full":
        def build_l(p):
            return jnp.tril(p["low"], k=-1) + jnp.diag(jnp.exp(p["raw"]))
    elif rank == "meanfield":
        def build_l(p):
            return jnp.diag(jnp.exp(p["raw"]))
    else:
        raise ValueError(f"rank must be 'full' or 'meanfield', got {rank!r}")

    def entropy(p):
        return jnp.sum(p["raw"]) + 0.5 * d * (1.0 + _LOG_2PI)

    return build_l, entropy


def advi(walker, prior=None, bounds=None, rank: str = "full",
         n_steps: int = 1500, n_samples: int = 8,
         learning_rate: float = 0.05, n_eval: int = 2048,
         seed: int = 0) -> VIResult:
    """Fit a Gaussian variational posterior to the walker's target.

    ``rank="full"`` fits a dense Cholesky (captures correlations — the
    default; d here is small), ``"meanfield"`` a diagonal (faster,
    ignores correlations, ELBO strictly weaker).  ``prior``/``bounds``
    resolve exactly like :func:`~lisp_mcmc_tpu.evidence.laplace_approx`
    (explicit > fitted ``_prior_spec`` > fitted ``_bounds``); with a
    resolved spec q is fit through the prior's inverse-CDF map so its
    support matches the prior's, and ``elbo``/``log_z`` follow the
    shared evidence convention.  Without one, q lives in whitened
    parameter space and the evidence fields are ``None``.

    q initializes from the CURRENT ensemble's z-space moments — on a
    converged fit ADVI is a polish; on a fresh one run a short anneal
    (or :meth:`Walker.optimize`) first so the init sees the basin.

    The walker's state is untouched (use :meth:`VIResult.seed_walker`
    to adopt the result).  Grouped/aux ensembles: fit per-dataset
    walkers (``BatchedFit.dataset_view``) instead.
    """
    import jax
    import jax.numpy as jnp
    import optax

    if getattr(walker, "aux", None) is not None:
        raise ValueError("advi: grouped/aux ensembles have no single "
                         "posterior surface; use "
                         "BatchedFit.advi_per_dataset (one vmapped scan "
                         "fits every dataset's q)")
    if n_steps <= 0 or n_samples <= 0:
        raise ValueError("n_steps and n_samples must be positive")

    keys, d, data, spec, theta_of_z, z0, log_v, logp_z, _ = _z_space_setup(
        walker, prior, bounds)
    dtype = walker.dtype

    build_l, entropy = _build_q(rank, d)

    # z-space moment init from the ensemble (a converged ensemble's
    # z-covariance IS the answer; a scattered one still sets the scale).
    mu0 = z0.mean(axis=0)
    if z0.shape[0] >= 2:
        sd0 = np.maximum(z0.std(axis=0, ddof=1), 1e-3)
        cov0 = np.atleast_2d(np.cov(z0.T)) + np.diag(1e-6 * sd0 ** 2)
    else:
        sd0 = np.full(d, 0.1)
        cov0 = np.diag(sd0 ** 2)
    params = {"mu": jnp.asarray(mu0, dtype),
              "raw": jnp.asarray(np.log(sd0), dtype)}
    if rank == "full":
        try:
            l0 = np.linalg.cholesky(cov0)
        except np.linalg.LinAlgError:
            l0 = np.diag(sd0)
        params = {"mu": params["mu"],
                  "raw": jnp.asarray(np.log(np.diag(l0)), dtype),
                  "low": jnp.asarray(np.tril(l0, k=-1), dtype)}

    n_mc = int(n_samples)

    def neg_elbo(p, key, data):
        eps = jax.random.normal(key, (n_mc, d), dtype)
        chol = build_l(p)
        z = p["mu"][None, :] + eps @ chol.T
        lp = jax.vmap(logp_z, in_axes=(0, None))(z, data)
        return -(jnp.mean(lp) + entropy(p))

    sched = optax.cosine_decay_schedule(learning_rate, max(n_steps, 1),
                                        alpha=0.05)
    opt = optax.chain(optax.clip_by_global_norm(10.0), optax.adam(sched))
    # Polyak tail average: with a finite-sample ELBO gradient the iterates
    # never settle — they orbit the optimum with lr-sized spread (measured
    # +-10% on the exactly-Gaussian line fit).  Averaging the last quarter
    # of the trajectory removes that orbit without touching the schedule.
    avg_from = int(0.75 * n_steps)

    def run(params, key, data):
        opt_state = opt.init(params)
        acc = jax.tree_util.tree_map(jnp.zeros_like, params)

        def step(carry, i):
            p, s, k, acc = carry
            k, sub = jax.random.split(k)
            loss, g = jax.value_and_grad(neg_elbo)(p, sub, data)
            # A single NaN gradient (a q draw hitting a non-finite model
            # region) must not poison Adam's moments: zero it and let the
            # finite draws carry the step.
            g = jax.tree_util.tree_map(
                lambda t: jnp.where(jnp.isfinite(t), t, 0.0), g)
            upd, s = opt.update(g, s, p)
            p = optax.apply_updates(p, upd)
            take = (i >= avg_from).astype(p["mu"].dtype)
            acc = jax.tree_util.tree_map(lambda a, t: a + take * t, acc, p)
            return (p, s, k, acc), -loss

        (params, _, _, acc), trace = jax.lax.scan(
            step, (params, opt_state, jax.random.PRNGKey(seed), acc),
            jnp.arange(n_steps))
        n_avg = max(n_steps - avg_from, 1)
        params = jax.tree_util.tree_map(lambda a: a / n_avg, acc)
        return params, trace

    params, trace = jax.jit(run)(params, jax.random.PRNGKey(seed), data)

    # ---- evaluation draws: summaries + IS evidence + Pareto-k ---------
    def evaluate(p, key, data):
        eps = jax.random.normal(key, (int(n_eval), d), dtype)
        chol = build_l(p)
        z = p["mu"][None, :] + eps @ chol.T
        theta = jax.vmap(theta_of_z)(z)
        lp = jax.vmap(logp_z, in_axes=(0, None))(z, data)
        # log q(z) for the reparameterized draws: eps is the whitened
        # residual by construction.
        logq = -0.5 * jnp.sum(eps * eps, axis=1) \
            - 0.5 * d * _LOG_2PI - jnp.sum(jnp.log(jnp.diag(chol)))
        return theta, lp - logq

    theta, lw = jax.jit(evaluate)(params, jax.random.PRNGKey(seed + 1), data)
    theta = np.asarray(theta, np.float64)
    lw = np.asarray(lw, np.float64)

    mean_vec = theta.mean(axis=0)
    cov = np.atleast_2d(np.cov(theta.T))
    mean = {k: float(mean_vec[i]) for i, k in enumerate(keys)}
    sd = {k: float(math.sqrt(max(cov[i, i], 0.0))) for i, k in enumerate(keys)}

    elbo = log_z = log_z_err = None
    if spec is not None:
        elbo = float(np.mean(lw)) - log_v
        log_z = _logmeanexp(lw) - log_v
        n_b = 8
        per = lw.size // n_b
        if per >= 2:
            batched = [_logmeanexp(lw[i * per:(i + 1) * per])
                       for i in range(n_b)]
            log_z_err = float(np.std(batched) / math.sqrt(n_b))

    mu_np = np.asarray(params["mu"], np.float64)
    chol_np = np.asarray(build_l(params), np.float64)
    return VIResult(
        keys=tuple(keys), mean=mean, sd=sd, cov=cov,
        elbo=elbo, log_z=log_z, log_z_error=log_z_err,
        pareto_k=_pareto_k(lw),
        elbo_trace=np.asarray(trace, np.float64), rank=rank,
        n_steps=int(n_steps),
        _mu=mu_np, _chol=chol_np,
        _theta_of_z=jax.jit(jax.vmap(theta_of_z)), _dtype=dtype,
    )


def advi_per_dataset(fit, prior=None, bounds=None, rank: str = "full",
                     n_steps: int = 1500, n_samples: int = 8,
                     learning_rate: float = 0.05, n_eval: int = 1024,
                     seed: int = 0) -> list:
    """S per-dataset ADVI fits as ONE vmapped program.

    The batched counterpart of :func:`advi` and the variational sibling
    of :meth:`BatchedFit.laplace_per_dataset`: every dataset block gets
    its own Gaussian q (initialized from its OWN walker block's
    z-moments), and all S optimizations run as a single
    ``vmap(lax.scan)`` — the per-dataset ELBO gradients batch into the
    same fused device program the ensemble kernel uses, so S spectra
    cost one program launch, not S.  Gradient clipping and Adam state
    live inside the vmapped axis (per dataset), never pooled.

    ``prior``/``bounds`` resolve like the scalar verb (shared across
    datasets — the scan-grid convention of ``laplace_per_dataset``).
    Returns a list of S :class:`VIResult`; each carries its own
    ``log_z`` / ``pareto_k`` guard, so a scan-grid model comparison is
    ``[r.log_z for r in results]`` with per-spectrum trust flags.
    """
    import jax
    import jax.numpy as jnp
    import optax

    from .priors import Uniform, resolve_prior_spec

    if getattr(fit, "n_datasets", None) is None:
        raise ValueError("advi_per_dataset needs a BatchedFit")
    if n_steps <= 0 or n_samples <= 0:
        raise ValueError("n_steps and n_samples must be positive")

    keys = list(fit.spec.keys)
    d = len(keys)
    dtype = fit.dtype
    data = fit._posterior_data()
    S = int(fit.n_datasets)
    spec = resolve_prior_spec(fit, prior, bounds)
    if spec is not None:
        missing = [k for k in keys if k not in spec]
        if missing:
            raise ValueError(f"advi_per_dataset: prior/bounds missing "
                             f"{missing}")

    pos = np.asarray(fit.state.position, np.float64).reshape(S, -1, d)

    if spec is not None:
        def theta_of_z(z, s):
            u = jax.nn.sigmoid(z)
            return spec.transform(u, keys)

        u_eps = 1e-6 if np.dtype(dtype).itemsize <= 4 else 1e-9
        u0 = np.clip(np.asarray(
            spec.inverse(pos.reshape(-1, d), keys), np.float64),
            u_eps, 1.0 - u_eps).reshape(S, -1, d)
        z0 = np.log(u0) - np.log1p(-u0)
        log_v = float(sum(math.log(spec[k].high - spec[k].low)
                          for k in keys if isinstance(spec[k], Uniform)))
        scales = None
    else:
        from .fit import _nonzero_scales

        scales = np.stack([_nonzero_scales(np.median(np.abs(pos[s]), axis=0))
                           for s in range(S)])

        def theta_of_z(z, s):
            return jnp.asarray(scales, z.dtype)[s] * z

        z0 = pos / scales[:, None, :]
        log_v = 0.0

    from .priors import PriorSpec as _PS

    if spec is None or isinstance(spec, _PS):
        def logdet_j(z, s):
            _, dz = jax.jvp(lambda zz: theta_of_z(zz, s), (z,),
                            (jnp.ones_like(z),))
            return jnp.sum(jnp.log(jnp.abs(dz)))
    else:
        def logdet_j(z, s):
            jac = jax.jacfwd(lambda zz: theta_of_z(zz, s))(z)
            _, ld = jnp.linalg.slogdet(jac)
            return ld

    def logp_z(z, s, data):
        lp = fit._custom_log_post(theta_of_z(z, s), s, data) + logdet_j(z, s)
        return jnp.where(jnp.isfinite(lp), lp, jnp.asarray(-1e12, lp.dtype))

    build_l, entropy = _build_q(rank, d)

    # Per-dataset z-space moment init from each walker block.
    mu0 = z0.mean(axis=1)                                        # (S, d)
    sd0 = np.maximum(z0.std(axis=1, ddof=1), 1e-3)               # (S, d)
    params = {"mu": jnp.asarray(mu0, dtype),
              "raw": jnp.asarray(np.log(sd0), dtype)}
    if rank == "full":
        lows = []
        for s in range(S):
            cov0 = np.atleast_2d(np.cov(z0[s].T)) \
                + np.diag(1e-6 * sd0[s] ** 2)
            try:
                l0 = np.linalg.cholesky(cov0)
            except np.linalg.LinAlgError:
                l0 = np.diag(sd0[s])
            lows.append(l0)
        l0 = np.stack(lows)
        params = {"mu": params["mu"],
                  "raw": jnp.asarray(
                      np.log(np.diagonal(l0, axis1=1, axis2=2)), dtype),
                  "low": jnp.asarray(np.tril(l0, k=-1), dtype)}

    n_mc = int(n_samples)
    sched = optax.cosine_decay_schedule(learning_rate, max(n_steps, 1),
                                        alpha=0.05)
    opt = optax.chain(optax.clip_by_global_norm(10.0), optax.adam(sched))
    avg_from = int(0.75 * n_steps)

    def run_one(params, key, s, data_):
        def neg_elbo(p, k):
            eps = jax.random.normal(k, (n_mc, d), dtype)
            z = p["mu"][None, :] + eps @ build_l(p).T
            lp = jax.vmap(logp_z, in_axes=(0, None, None))(z, s, data_)
            return -(jnp.mean(lp) + entropy(p))

        opt_state = opt.init(params)
        acc = jax.tree_util.tree_map(jnp.zeros_like, params)

        def step(carry, i):
            p, st, k, acc = carry
            k, sub = jax.random.split(k)
            loss, g = jax.value_and_grad(neg_elbo)(p, sub)
            g = jax.tree_util.tree_map(
                lambda t: jnp.where(jnp.isfinite(t), t, 0.0), g)
            upd, st = opt.update(g, st, p)
            p = optax.apply_updates(p, upd)
            take = (i >= avg_from).astype(p["mu"].dtype)
            acc = jax.tree_util.tree_map(lambda a, t: a + take * t, acc, p)
            return (p, st, k, acc), -loss

        (params, _, _, acc), trace = jax.lax.scan(
            step, (params, opt_state, key, acc), jnp.arange(n_steps))
        params = jax.tree_util.tree_map(
            lambda a: a / max(n_steps - avg_from, 1), acc)

        # Evaluation draws (inside the same vmapped program).
        k_eval = jax.random.fold_in(key, 1)
        eps = jax.random.normal(k_eval, (int(n_eval), d), dtype)
        chol = build_l(params)
        z = params["mu"][None, :] + eps @ chol.T
        theta = jax.vmap(theta_of_z, in_axes=(0, None))(z, s)
        lp = jax.vmap(logp_z, in_axes=(0, None, None))(z, s, data_)
        logq = -0.5 * jnp.sum(eps * eps, axis=1) \
            - 0.5 * d * _LOG_2PI - jnp.sum(jnp.log(jnp.diag(chol)))
        return params, trace, theta, lp - logq

    run_keys = jax.vmap(jax.random.PRNGKey)(
        seed + jnp.arange(S, dtype=jnp.uint32))
    # Datasets ride as a jit ARGUMENT (broadcast across the vmapped
    # axis), never a closure constant — the repo-wide compile-cache
    # contract (CLAUDE.md).
    params, traces, thetas, lws = jax.jit(jax.vmap(
        run_one, in_axes=(0, 0, 0, None)))(params, run_keys,
                                           jnp.arange(S, dtype=jnp.int32),
                                           data)

    thetas = np.asarray(thetas, np.float64)
    lws = np.asarray(lws, np.float64)
    traces = np.asarray(traces, np.float64)
    mus = np.asarray(params["mu"], np.float64)
    chols = np.asarray(jax.vmap(build_l)(params), np.float64)

    results = []
    for s in range(S):
        theta, lw = thetas[s], lws[s]
        mean_vec = theta.mean(axis=0)
        cov = np.atleast_2d(np.cov(theta.T))
        mean = {k: float(mean_vec[i]) for i, k in enumerate(keys)}
        sd = {k: float(math.sqrt(max(cov[i, i], 0.0)))
              for i, k in enumerate(keys)}
        elbo = log_z = log_z_err = None
        if spec is not None:
            elbo = float(np.mean(lw)) - log_v
            log_z = _logmeanexp(lw) - log_v
            per = lw.size // 8
            if per >= 2:
                batched = [_logmeanexp(lw[i * per:(i + 1) * per])
                           for i in range(8)]
                log_z_err = float(np.std(batched) / math.sqrt(8))
        import jax as _jax
        theta_map = _jax.jit(_jax.vmap(
            lambda z, _s=s: theta_of_z(z, _s)))
        results.append(VIResult(
            keys=tuple(keys), mean=mean, sd=sd, cov=cov,
            elbo=elbo, log_z=log_z, log_z_error=log_z_err,
            pareto_k=_pareto_k(lw), elbo_trace=traces[s], rank=rank,
            n_steps=int(n_steps), _mu=mus[s], _chol=chols[s],
            _theta_of_z=theta_map, _dtype=dtype,
        ))
    return results


def _flow_masks(d: int, n_layers: int, dtype):
    import jax.numpy as jnp

    return jnp.asarray(
        np.stack([(np.arange(d) % 2 == k % 2).astype(np.float64)
                  for k in range(n_layers)]), dtype)


def _flow_forward_fn(d: int, n_layers: int, s_cap: float, dtype):
    """Shared RealNVP forward builder: (params, eps) -> (z, logdet)."""
    import jax.numpy as jnp

    masks_j = _flow_masks(d, n_layers, dtype)
    cap = jnp.asarray(float(s_cap), dtype)

    def flow_forward(p, eps):
        y = eps
        ld = jnp.zeros(eps.shape[:-1], dtype)
        for k, lp_ in enumerate(p["layers"]):
            m = masks_j[k]
            h = jnp.tanh((y * m) @ lp_["w1"] + lp_["b1"])
            h = jnp.tanh(h @ lp_["w2"] + lp_["b2"])
            out = h @ lp_["w3"] + lp_["b3"]
            s = cap * jnp.tanh(out[..., :d] / cap)   # bounded log-scale
            t = out[..., d:]
            y = m * y + (1.0 - m) * (y * jnp.exp(s) + t)
            ld = ld + jnp.sum((1.0 - m) * s, axis=-1)
        z = p["mu"] + jnp.exp(p["raw"]) * y
        return z, ld + jnp.sum(p["raw"])

    return flow_forward


@dataclasses.dataclass(frozen=True)
class FlowVIResult(VIResult):
    """A fitted normalizing-flow variational posterior (see
    :func:`flow_advi`).

    The Gaussian summary fields (``mean``/``sd``/``cov`` and the private
    ``_mu``/``_chol``) are MOMENT-MATCHED from flow draws, so
    ``summary()``/``to_mvgaussian()`` work unchanged; :meth:`sample`
    (hence ``seed_walker``) draws through the flow itself, and
    ``n_layers`` records the coupling-stack depth.
    """

    _z_of_eps: object = dataclasses.field(default=None, repr=False)
    # un-jitted single/batched forward (eps -> (z, logdet)) and the
    # z-space log posterior ((z, data) -> lp): the NeuTra surface.
    _fwd: object = dataclasses.field(default=None, repr=False)
    _logp_z: object = dataclasses.field(default=None, repr=False)
    # checkpointable pieces: trained parameters, architecture scalars,
    # and (no-spec fits) the frozen whitening scales the z-map used.
    _params: object = dataclasses.field(default=None, repr=False)
    _hidden: int = dataclasses.field(default=0, repr=False)
    _s_cap: float = dataclasses.field(default=3.0, repr=False)
    _scales: object = dataclasses.field(default=None, repr=False)
    n_layers: int = 0

    def sample(self, n: int, seed: int = 0) -> np.ndarray:
        import jax

        key = jax.random.PRNGKey(seed)
        eps = jax.random.normal(key, (int(n), len(self.keys)), self._dtype)
        return np.asarray(self._theta_of_z(self._z_of_eps(eps)), np.float64)

    def save(self, path: str) -> None:
        """Checkpoint the trained transport (``.npz``).

        Train once, reuse across sessions: :func:`load_flow` rebuilds
        the full result — ``sample``/``seed_walker``/``neutra_sample``
        included — against a walker of the same model (the z-map comes
        from the walker's resolved prior spec, or from the whitening
        scales frozen here for custom-prior fits).  Summaries
        (mean/sd/cov, elbo, log_z, Pareto-k) travel with the file.
        """
        import json

        if self._params is None:
            raise ValueError("this FlowVIResult predates the checkpoint "
                             "surface; refit with flow_advi")
        arrays = {
            "mu": np.asarray(self._params["mu"], np.float64),
            "raw": np.asarray(self._params["raw"], np.float64),
            "cov": np.asarray(self.cov, np.float64),
            "elbo_trace": np.asarray(self.elbo_trace, np.float64),
            "flow_mu": np.asarray(self._mu, np.float64),
            "flow_chol": np.asarray(self._chol, np.float64),
        }
        for k, lay in enumerate(self._params["layers"]):
            for name, a in lay.items():
                arrays[f"layer{k}_{name}"] = np.asarray(a, np.float64)
        if self._scales is not None:
            arrays["scales"] = np.asarray(self._scales, np.float64)
        header = {
            "kind": "flow_advi", "keys": list(self.keys),
            "n_layers": int(self.n_layers), "hidden": int(self._hidden),
            "s_cap": float(self._s_cap), "rank": self.rank,
            "n_steps": int(self.n_steps),
            "dtype": np.dtype(self._dtype).name,
            "mean": {k: float(v) for k, v in self.mean.items()},
            "sd": {k: float(v) for k, v in self.sd.items()},
            "elbo": self.elbo, "log_z": self.log_z,
            "log_z_error": self.log_z_error,
            "pareto_k": float(self.pareto_k),
        }
        arrays["__flow_header__"] = np.array(json.dumps(header))
        np.savez(path, **arrays)

    def neutra_sample(self, walker, n_steps: int = 4000,
                      kernel: str = "chees", n_walkers: int | None = None,
                      seed: int = 0, **config_overrides) -> "NeutraResult":
        """Exact posterior samples by MCMC in the flow's LATENT space.

        NeuTra (Hoffman, Sountsov et al. 2019): reparameterize the
        posterior by the fitted transport ``T`` and run the kernel on
        ``eps`` with target ``log p(T(eps)) + log|det dT/deps|`` — if
        the flow fit well, that target is nearly ``N(0, I)`` and ANY
        kernel mixes near-iid, with every accepted point mapping back
        to an EXACT posterior sample (reparameterization preserves MCMC
        exactness; no importance weights, no Pareto-k caveat).  This is
        what :meth:`seed_walker` cannot do: seeding only moves the
        STARTING ensemble, while NeuTra changes the geometry the kernel
        walks for the whole run — on the banana target the latent-space
        quadratic coefficient reads ~1.0 with near-unity per-step ESS
        (tests/test_flow_vi.py).

        Builds a fresh latent-space fit (the caller's walker is
        untouched) seeded ``eps ~ N(0, I)``, runs ``n_steps`` cold
        steps with ``kernel`` (default chees: it self-tunes to the
        latent geometry), and maps the retained history back through
        ``T``.  NOTE: the original fit's datasets ride the latent
        posterior as a closure constant here — one extra compile per
        ``neutra_sample`` call, unlike the main fit path's
        data-as-arguments contract (acceptable for a terminal sampling
        verb; do not copy this pattern into chunked drivers).
        """
        import jax
        import jax.numpy as jnp

        from .fit import walker_create
        from .kernel import FitConfig

        if self._fwd is None or self._logp_z is None:
            raise ValueError("neutra_sample: this FlowVIResult predates "
                             "the NeuTra surface; refit with flow_advi")
        keys = list(self.keys)
        d = len(keys)
        n_w = int(n_walkers or walker.n_walkers)
        data = walker._posterior_data()
        fwd, logp_z = self._fwd, self._logp_z

        def latent_loglik(fn, params, dataset):
            eps = jnp.stack([params[k] for k in keys])
            z, ld = fwd(eps)
            return logp_z(z, data) + ld

        def null_model(x, p):
            return jnp.zeros_like(x)

        cfg = FitConfig(kernel=kernel, **config_overrides)
        latent = walker_create(
            function=null_model, data=([0.0, 1.0], [0.0, 0.0]),
            params={k: 0.0 for k in keys}, log_likelihood=latent_loglik,
            n_walkers=n_w, seed=seed, walker_jitter=0.0, config=cfg,
            dtype=self._dtype)
        key = jax.random.PRNGKey(seed + 7)
        eps0 = jax.random.normal(key, (n_w, d), self._dtype)
        lp0 = latent._eval_batch(eps0)
        latent.state = dataclasses.replace(
            latent.state, position=eps0, logprob=lp0,
            best_position=eps0, best_logprob=lp0)
        # The latent target is ~N(0, I) exactly when the flow fit well,
        # so the identity (Haario-scaled) IS the right starting proposal
        # — the default magnitude heuristic sees the 0.0 guesses and
        # starts ~1e-3, which the chunkwise steering would need dozens
        # of chunks to recover from (measured: acceptance pinned at 1.0
        # and 50x worse ESS on the banana before this line).
        from .ops.linalg import haario_scale

        latent._set_l_matrix(float(haario_scale(d)) * np.eye(d))
        latent.adaptive_steps(int(n_steps), temperature=1.0, auto=None)

        eps_hist, lp_hist = latent._history(None)          # (T, W, d)
        T, W, _ = eps_hist.shape
        flat = jnp.asarray(eps_hist.reshape(-1, d), self._dtype)
        z, _ = fwd(flat)
        theta = np.asarray(self._theta_of_z(z), np.float64)
        return NeutraResult(
            keys=tuple(keys),
            samples=theta,
            samples_by_step=theta.reshape(T, W, d),
            logprobs=np.asarray(lp_hist, np.float64).reshape(-1),
            acceptance=float(latent.acceptance()),
            latent=latent,
        )

    def __repr__(self):
        z = "None" if self.log_z is None else f"{self.log_z:.4f}"
        e = "None" if self.elbo is None else f"{self.elbo:.4f}"
        return (f"FlowVIResult(n_layers={self.n_layers}, elbo={e}, "
                f"log_z={z}, pareto_k={self.pareto_k:.3f}, "
                f"trust_log_z={self.converged_evidence})")


@dataclasses.dataclass(frozen=True)
class NeutraResult:
    """Exact posterior draws from :meth:`FlowVIResult.neutra_sample`.

    ``samples`` is the flat ``(T*W, d)`` parameter-space history,
    ``samples_by_step`` its ``(T, W, d)`` chain view (for ESS/R-hat via
    ``ops.reductions``), ``latent`` the latent-space fit itself (all
    Walker diagnostics apply to it — its ESS equals the mapped chain's
    per monotone coordinate transport).
    """

    keys: tuple
    samples: np.ndarray
    samples_by_step: np.ndarray
    logprobs: np.ndarray
    acceptance: float
    latent: object = dataclasses.field(repr=False)

    def mean(self) -> dict:
        m = self.samples.mean(axis=0)
        return {k: float(m[i]) for i, k in enumerate(self.keys)}

    def min_ess(self, max_chains: int = 64) -> float:
        """Frozen-chain-honest min ESS over parameters of the mapped
        chains (subsampled to ``max_chains`` walkers for cost)."""
        from .ops.reductions import effective_sample_size

        T, W, d = self.samples_by_step.shape
        take = min(W, max_chains)
        idx = np.linspace(0, W - 1, take).astype(int)
        chains = self.samples_by_step[:, idx, :]
        return min(float(effective_sample_size(chains[:, :, j]))
                   for j in range(d))

    def __repr__(self):
        return (f"NeutraResult(n={self.samples.shape[0]}, "
                f"acceptance={self.acceptance:.3f})")


def flow_advi(walker, prior=None, bounds=None, n_layers: int = 4,
              hidden: int = 32, n_steps: int = 12000, n_samples: int = 256,
              learning_rate: float = 1e-3, s_cap: float = 3.0,
              n_eval: int = 4096, seed: int = 0) -> FlowVIResult:
    """Fit a RealNVP normalizing-flow posterior (Dinh et al. 2017).

    The non-Gaussian upgrade of :func:`advi`: ``q = T(N(0, I))`` where T
    is ``n_layers`` affine coupling layers (alternating halves, each a
    small tanh MLP of width ``hidden`` emitting shift + soft-clamped
    log-scale) followed by a global affine layer initialized from the
    ensemble's z-space moments.  Coupling MLPs initialize to the
    identity (zero last layer), so step 0 IS the Gaussian ``advi`` init
    and training only ever bends it — on an exactly-Gaussian posterior
    the flow reduces to ADVI; on curved/banana posteriors (where the
    Gaussian family's Pareto-k blows past 0.7) the couplings absorb the
    curvature and the importance-sampled ``log_z`` becomes trustworthy
    again.  The ELBO uses per-draw ``log q`` via the flow's triangular
    Jacobian (couplings pay a sum, never a determinant).

    Rides the same machinery as :func:`advi`: the declared-prior
    inverse-CDF z-space (evidence convention preserved; evidence fields
    ``None`` without a resolvable spec), one jitted ``lax.scan`` of
    reparameterized Adam steps with a Polyak tail average, Pareto-k
    guarded IS evidence (6th estimator arm), ``seed_walker`` warm
    starts, ``to_mvgaussian`` chaining (moment-matched).

    d must be >= 2 for the couplings to act (at d=1 the flow degrades
    to the global affine = meanfield ADVI, which is already exact there).
    """
    import jax
    import jax.numpy as jnp
    import optax

    if getattr(walker, "aux", None) is not None:
        raise ValueError("flow_advi: grouped/aux ensembles have no single "
                         "posterior surface; fit per-dataset views")
    if n_steps <= 0 or n_samples <= 0 or n_layers <= 0 or hidden <= 0:
        raise ValueError("n_steps, n_samples, n_layers, hidden must be "
                         "positive")

    keys, d, data, spec, theta_of_z, z0, log_v, logp_z, w_scales = \
        _z_space_setup(walker, prior, bounds)
    dtype = walker.dtype

    # Global affine init from the ensemble's z-space moments (same init
    # as advi's meanfield): mu + exp(raw) * y.
    mu0 = z0.mean(axis=0)
    sd0 = (np.maximum(z0.std(axis=0, ddof=1), 1e-3)
           if z0.shape[0] >= 2 else np.full(d, 0.1))

    rng = np.random.default_rng(seed)

    def _layer_init():
        return {
            "w1": jnp.asarray(rng.normal(0, 0.01, (d, hidden)), dtype),
            "b1": jnp.zeros((hidden,), dtype),
            "w2": jnp.asarray(rng.normal(0, 0.01, (hidden, hidden)), dtype),
            "b2": jnp.zeros((hidden,), dtype),
            # zero last layer -> exact identity coupling at init
            "w3": jnp.zeros((hidden, 2 * d), dtype),
            "b3": jnp.zeros((2 * d,), dtype),
        }

    params = {
        "mu": jnp.asarray(mu0, dtype),
        "raw": jnp.asarray(np.log(sd0), dtype),
        "layers": [_layer_init() for _ in range(int(n_layers))],
    }
    flow_forward = _flow_forward_fn(d, int(n_layers), s_cap, dtype)

    def draw_lw(p, key, n, data_):
        """n reparameterized draws -> (z, log p(z) - log q(z))."""
        eps = jax.random.normal(key, (n, d), dtype)
        z, ld = flow_forward(p, eps)
        logq = (-0.5 * jnp.sum(eps * eps, axis=1)
                - 0.5 * d * _LOG_2PI - ld)
        lp = jax.vmap(logp_z, in_axes=(0, None))(z, data_)
        return z, lp - logq

    n_mc = int(n_samples)

    def neg_elbo(p, key, data_):
        _, lw = draw_lw(p, key, n_mc, data_)
        return -jnp.mean(lw)

    # Flow training needs a different regime than the Gaussian family
    # (measured on the banana target, tests/test_flow_vi.py): the
    # near-identity couplings' curvature gradient is TINY at the start,
    # so the MC batch must be large enough for that signal to beat the
    # ELBO gradient noise — n_samples=64 stalled a third of the way into
    # the curvature (ELBO 0.7 nats below optimum, Pareto-k ~0.8, every
    # seed), 128 mostly escaped, 256 reached the optimum for every seed
    # (curvature 0.99, log_z within 0.02 nats, k < 0.45).  Likewise
    # ADVI's fast cosine decay is softened (alpha=0.3) and the Polyak
    # average covers only the final 10% (the couplings move until late).
    sched = optax.cosine_decay_schedule(learning_rate, max(n_steps, 1),
                                        alpha=0.3)
    opt = optax.chain(optax.clip_by_global_norm(10.0), optax.adam(sched))
    avg_from = int(0.9 * n_steps)

    def run(params, key, data_):
        opt_state = opt.init(params)
        acc = jax.tree_util.tree_map(jnp.zeros_like, params)

        def step(carry, i):
            p, s, k, acc = carry
            k, sub = jax.random.split(k)
            loss, g = jax.value_and_grad(neg_elbo)(p, sub, data_)
            g = jax.tree_util.tree_map(
                lambda t: jnp.where(jnp.isfinite(t), t, 0.0), g)
            upd, s = opt.update(g, s, p)
            p = optax.apply_updates(p, upd)
            take = (i >= avg_from).astype(p["mu"].dtype)
            acc = jax.tree_util.tree_map(lambda a, t: a + take * t, acc, p)
            return (p, s, k, acc), -loss

        (params, _, _, acc), trace = jax.lax.scan(
            step, (params, opt_state, jax.random.PRNGKey(seed), acc),
            jnp.arange(n_steps))
        n_avg = max(n_steps - avg_from, 1)
        params = jax.tree_util.tree_map(lambda a: a / n_avg, acc)
        return params, trace

    params, trace = jax.jit(run)(params, jax.random.PRNGKey(seed), data)

    def evaluate(p, key, data_):
        z, lw = draw_lw(p, key, int(n_eval), data_)
        return jax.vmap(theta_of_z)(z), lw

    theta, lw = jax.jit(evaluate)(params, jax.random.PRNGKey(seed + 1), data)
    theta = np.asarray(theta, np.float64)
    lw = np.asarray(lw, np.float64)

    mean_vec = theta.mean(axis=0)
    cov = np.atleast_2d(np.cov(theta.T))
    mean = {k: float(mean_vec[i]) for i, k in enumerate(keys)}
    sd = {k: float(math.sqrt(max(cov[i, i], 0.0)))
          for i, k in enumerate(keys)}

    elbo = log_z = log_z_err = None
    if spec is not None:
        elbo = float(np.mean(lw)) - log_v
        log_z = _logmeanexp(lw) - log_v
        n_b = 8
        per = lw.size // n_b
        if per >= 2:
            batched = [_logmeanexp(lw[i * per:(i + 1) * per])
                       for i in range(n_b)]
            log_z_err = float(np.std(batched) / math.sqrt(n_b))

    z_of_eps = jax.jit(lambda eps: flow_forward(params, eps)[0])
    return FlowVIResult(
        keys=tuple(keys), mean=mean, sd=sd, cov=cov,
        elbo=elbo, log_z=log_z, log_z_error=log_z_err,
        pareto_k=_pareto_k(lw),
        elbo_trace=np.asarray(trace, np.float64), rank="flow",
        n_steps=int(n_steps),
        _mu=np.asarray(params["mu"], np.float64),
        _chol=np.diag(np.exp(np.asarray(params["raw"], np.float64))),
        _theta_of_z=jax.jit(jax.vmap(theta_of_z)), _dtype=dtype,
        _z_of_eps=z_of_eps,
        _fwd=lambda eps: flow_forward(params, eps),
        _logp_z=logp_z,
        _params=jax.tree_util.tree_map(lambda a: np.asarray(a), params),
        _hidden=int(hidden), _s_cap=float(s_cap), _scales=w_scales,
        n_layers=int(n_layers),
    )


def flow_advi_per_dataset(fit, prior=None, bounds=None, n_layers: int = 4,
                          hidden: int = 32, n_steps: int = 12000,
                          n_samples: int = 256, learning_rate: float = 1e-3,
                          s_cap: float = 3.0, n_eval: int = 2048,
                          seed: int = 0) -> list:
    """S per-dataset RealNVP flow fits as ONE vmapped program.

    The flow counterpart of :func:`advi_per_dataset`: every dataset
    block trains its own coupling stack (initialized to the identity on
    its OWN walker block's z-moments) inside a single
    ``vmap(lax.scan)`` device program — the per-dataset coupling MLPs
    batch along the vmapped axis exactly like the Gaussian q's
    parameters, so S curved spectra cost one program launch.  Keep
    ``n_samples`` at its 256-scale default: the batch-size cliff
    measured for the scalar verb (couplings stall at partial curvature
    below it) applies per dataset unchanged.

    Returns a list of S :class:`FlowVIResult`; each carries its own
    Pareto-k-guarded ``log_z`` and its own NeuTra surface
    (``results[s].neutra_sample(fit.dataset_view(s), ...)``).
    """
    import jax
    import jax.numpy as jnp
    import optax

    from .priors import Uniform, resolve_prior_spec

    if getattr(fit, "n_datasets", None) is None:
        raise ValueError("flow_advi_per_dataset needs a BatchedFit")
    if n_steps <= 0 or n_samples <= 0 or n_layers <= 0 or hidden <= 0:
        raise ValueError("n_steps, n_samples, n_layers, hidden must be "
                         "positive")

    keys = list(fit.spec.keys)
    d = len(keys)
    dtype = fit.dtype
    data = fit._posterior_data()
    S = int(fit.n_datasets)
    spec = resolve_prior_spec(fit, prior, bounds)
    if spec is not None:
        missing = [k for k in keys if k not in spec]
        if missing:
            raise ValueError(f"flow_advi_per_dataset: prior/bounds missing "
                             f"{missing}")

    pos = np.asarray(fit.state.position, np.float64).reshape(S, -1, d)

    if spec is not None:
        def theta_of_z(z, s):
            u = jax.nn.sigmoid(z)
            return spec.transform(u, keys)

        u_eps = 1e-6 if np.dtype(dtype).itemsize <= 4 else 1e-9
        u0 = np.clip(np.asarray(
            spec.inverse(pos.reshape(-1, d), keys), np.float64),
            u_eps, 1.0 - u_eps).reshape(S, -1, d)
        z0 = np.log(u0) - np.log1p(-u0)
        log_v = float(sum(math.log(spec[k].high - spec[k].low)
                          for k in keys if isinstance(spec[k], Uniform)))
    else:
        from .fit import _nonzero_scales

        scales = np.stack([_nonzero_scales(np.median(np.abs(pos[s]), axis=0))
                           for s in range(S)])

        def theta_of_z(z, s):
            return jnp.asarray(scales, z.dtype)[s] * z

        z0 = pos / scales[:, None, :]
        log_v = 0.0

    from .priors import PriorSpec as _PS

    if spec is None or isinstance(spec, _PS):
        # componentwise map -> diagonal Jacobian via one jvp (see
        # _z_space_setup for the measured rationale)
        def logdet_j(z, s):
            _, dz = jax.jvp(lambda zz: theta_of_z(zz, s), (z,),
                            (jnp.ones_like(z),))
            return jnp.sum(jnp.log(jnp.abs(dz)))
    else:
        def logdet_j(z, s):
            jac = jax.jacfwd(lambda zz: theta_of_z(zz, s))(z)
            _, ld = jnp.linalg.slogdet(jac)
            return ld

    def logp_z(z, s, data_):
        lp = fit._custom_log_post(theta_of_z(z, s), s, data_) + logdet_j(z, s)
        return jnp.where(jnp.isfinite(lp), lp, jnp.asarray(-1e12, lp.dtype))

    flow_forward = _flow_forward_fn(d, int(n_layers), s_cap, dtype)

    mu0 = z0.mean(axis=1)                                        # (S, d)
    sd0 = np.maximum(z0.std(axis=1, ddof=1), 1e-3)               # (S, d)
    rng = np.random.default_rng(seed)
    params = {
        "mu": jnp.asarray(mu0, dtype),
        "raw": jnp.asarray(np.log(sd0), dtype),
        "layers": [
            {"w1": jnp.asarray(rng.normal(0, 0.01, (S, d, hidden)), dtype),
             "b1": jnp.zeros((S, hidden), dtype),
             "w2": jnp.asarray(
                 rng.normal(0, 0.01, (S, hidden, hidden)), dtype),
             "b2": jnp.zeros((S, hidden), dtype),
             "w3": jnp.zeros((S, hidden, 2 * d), dtype),
             "b3": jnp.zeros((S, 2 * d), dtype)}
            for _ in range(int(n_layers))
        ],
    }

    n_mc = int(n_samples)
    # Flow training regime (measured, see flow_advi): gentle decay
    # floor, last-10% Polyak, 256-scale MC batches.
    sched = optax.cosine_decay_schedule(learning_rate, max(n_steps, 1),
                                        alpha=0.3)
    opt = optax.chain(optax.clip_by_global_norm(10.0), optax.adam(sched))
    avg_from = int(0.9 * n_steps)

    def run_one(params, key, s, data_):
        def draw_lw(p, k, n):
            eps = jax.random.normal(k, (n, d), dtype)
            z, ld = flow_forward(p, eps)
            logq = (-0.5 * jnp.sum(eps * eps, axis=1)
                    - 0.5 * d * _LOG_2PI - ld)
            lp = jax.vmap(logp_z, in_axes=(0, None, None))(z, s, data_)
            return z, lp - logq

        def neg_elbo(p, k):
            _, lw = draw_lw(p, k, n_mc)
            return -jnp.mean(lw)

        opt_state = opt.init(params)
        acc = jax.tree_util.tree_map(jnp.zeros_like, params)

        def step(carry, i):
            p, st, k, acc = carry
            k, sub = jax.random.split(k)
            loss, g = jax.value_and_grad(neg_elbo)(p, sub)
            g = jax.tree_util.tree_map(
                lambda t: jnp.where(jnp.isfinite(t), t, 0.0), g)
            upd, st = opt.update(g, st, p)
            p = optax.apply_updates(p, upd)
            take = (i >= avg_from).astype(p["mu"].dtype)
            acc = jax.tree_util.tree_map(lambda a, t: a + take * t, acc, p)
            return (p, st, k, acc), -loss

        (params, _, _, acc), trace = jax.lax.scan(
            step, (params, opt_state, key, acc), jnp.arange(n_steps))
        params = jax.tree_util.tree_map(
            lambda a: a / max(n_steps - avg_from, 1), acc)

        k_eval = jax.random.fold_in(key, 1)
        z, lw = draw_lw(params, k_eval, int(n_eval))
        theta = jax.vmap(theta_of_z, in_axes=(0, None))(z, s)
        return params, trace, theta, lw

    run_keys = jax.vmap(jax.random.PRNGKey)(
        seed + jnp.arange(S, dtype=jnp.uint32))
    # Datasets as a jit argument, not a closure constant (CLAUDE.md).
    params, traces, thetas, lws = jax.jit(jax.vmap(
        run_one, in_axes=(0, 0, 0, None)))(params, run_keys,
                                           jnp.arange(S, dtype=jnp.int32),
                                           data)

    thetas = np.asarray(thetas, np.float64)
    lws = np.asarray(lws, np.float64)
    traces = np.asarray(traces, np.float64)

    results = []
    for s in range(S):
        theta, lw = thetas[s], lws[s]
        mean_vec = theta.mean(axis=0)
        cov = np.atleast_2d(np.cov(theta.T))
        mean = {k: float(mean_vec[i]) for i, k in enumerate(keys)}
        sd = {k: float(math.sqrt(max(cov[i, i], 0.0)))
              for i, k in enumerate(keys)}
        elbo = log_z = log_z_err = None
        if spec is not None:
            elbo = float(np.mean(lw)) - log_v
            log_z = _logmeanexp(lw) - log_v
            per = lw.size // 8
            if per >= 2:
                batched = [_logmeanexp(lw[i * per:(i + 1) * per])
                           for i in range(8)]
                log_z_err = float(np.std(batched) / math.sqrt(8))
        params_s = jax.tree_util.tree_map(lambda a, _s=s: a[_s], params)
        theta_map = jax.jit(jax.vmap(lambda z, _s=s: theta_of_z(z, _s)))
        results.append(FlowVIResult(
            keys=tuple(keys), mean=mean, sd=sd, cov=cov,
            elbo=elbo, log_z=log_z, log_z_error=log_z_err,
            pareto_k=_pareto_k(lw), elbo_trace=traces[s], rank="flow",
            n_steps=int(n_steps),
            _mu=np.asarray(params_s["mu"], np.float64),
            _chol=np.diag(np.exp(np.asarray(params_s["raw"], np.float64))),
            _theta_of_z=theta_map, _dtype=dtype,
            _z_of_eps=jax.jit(
                lambda eps, _p=params_s: flow_forward(_p, eps)[0]),
            _fwd=lambda eps, _p=params_s: flow_forward(_p, eps),
            _logp_z=lambda z, data_, _s=s: logp_z(z, _s, data_),
            _params=jax.tree_util.tree_map(lambda a: np.asarray(a),
                                           params_s),
            _hidden=int(hidden), _s_cap=float(s_cap),
            _scales=None if spec is not None else np.asarray(scales[s]),
            n_layers=int(n_layers),
        ))
    return results


def load_flow(path: str, walker, prior=None, bounds=None) -> FlowVIResult:
    """Reload a :meth:`FlowVIResult.save` checkpoint against ``walker``.

    The walker supplies the posterior surface and (via the usual
    resolution order) the prior spec whose inverse-CDF map the flow was
    trained through; for custom-prior fits the whitening scales frozen
    in the file reproduce the exact training-time z-map regardless of
    where the ensemble has moved since.  Returns a fully-armed
    :class:`FlowVIResult` (sampling, seeding, NeuTra) with the SAVED
    summaries — no retraining, no re-evaluation.
    """
    import json

    import jax
    import jax.numpy as jnp

    with np.load(path, allow_pickle=False) as z:
        if "__flow_header__" not in z.files:
            raise ValueError(f"{path}: not a flow_advi checkpoint")
        header = json.loads(str(z["__flow_header__"][()]))
        arrays = {k: z[k] for k in z.files if k != "__flow_header__"}

    keys_saved = list(header["keys"])
    if list(walker.spec.keys) != keys_saved:
        raise ValueError(
            f"load_flow: walker parameters {list(walker.spec.keys)} do not "
            f"match the checkpoint's {keys_saved}")
    scales = arrays.get("scales")
    keys, d, data, spec, theta_of_z, _z0, _log_v, logp_z, _ = _z_space_setup(
        walker, prior, bounds, scales=scales)
    if (spec is None) != (scales is not None):
        raise ValueError(
            "load_flow: the checkpoint was trained "
            + ("WITHOUT" if scales is not None else "WITH")
            + " a resolvable prior spec, but this walker resolves the "
            "opposite — the z-space maps would disagree; reload against a "
            "fit constructed like the one that trained the flow")

    dtype = jnp.float64 if header["dtype"] == "float64" else jnp.float32
    n_layers = int(header["n_layers"])
    params = {
        "mu": jnp.asarray(arrays["mu"], dtype),
        "raw": jnp.asarray(arrays["raw"], dtype),
        "layers": [
            {name: jnp.asarray(arrays[f"layer{k}_{name}"], dtype)
             for name in ("w1", "b1", "w2", "b2", "w3", "b3")}
            for k in range(n_layers)
        ],
    }
    flow_forward = _flow_forward_fn(d, n_layers, float(header["s_cap"]),
                                    dtype)
    return FlowVIResult(
        keys=tuple(keys_saved),
        mean=dict(header["mean"]), sd=dict(header["sd"]),
        cov=np.asarray(arrays["cov"], np.float64),
        elbo=header["elbo"], log_z=header["log_z"],
        log_z_error=header["log_z_error"],
        pareto_k=float(header["pareto_k"]),
        elbo_trace=np.asarray(arrays["elbo_trace"], np.float64),
        rank=header["rank"], n_steps=int(header["n_steps"]),
        _mu=np.asarray(arrays["flow_mu"], np.float64),
        _chol=np.asarray(arrays["flow_chol"], np.float64),
        _theta_of_z=jax.jit(jax.vmap(theta_of_z)), _dtype=dtype,
        _z_of_eps=jax.jit(lambda eps: flow_forward(params, eps)[0]),
        _fwd=lambda eps: flow_forward(params, eps),
        _logp_z=logp_z,
        _params=jax.tree_util.tree_map(lambda a: np.asarray(a), params),
        _hidden=int(header["hidden"]), _s_cap=float(header["s_cap"]),
        _scales=None if scales is None else np.asarray(scales, np.float64),
        n_layers=n_layers,
    )
