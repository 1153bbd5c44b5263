"""Hierarchical (partial-pooling) fits: S datasets, shared population.

The reference's batch workflow fits every spectrum of a scan grid
independently (``dir->nv-walkers`` advances a Lisp list of walkers one
at a time, nv-specific.lisp:58-66) and its only cross-spectrum coupling
is the *shared-parameter global fit* (same value for every dataset,
test.lisp:58-70).  Between those two extremes sits the model this module
adds: per-dataset parameters drawn from a common population,

    theta[s, p] ~ Normal(mu_p, tau_p)        for pooled parameter p,
    mu_p, tau_p ~ declared hyperpriors,

so sparse spectra borrow strength from the rest of the grid instead of
each fending for itself.

Device-first design decisions:

- **Non-centered parameterization is the representation, not an
  option.**  The walk coordinates are ``z[s, p]`` with
  ``theta = mu + tau * z``; the decode happens inside the jitted
  posterior.  Two payoffs: (a) the funnel geometry that makes centered
  hierarchical posteriors hard at small per-dataset data (Neal's funnel:
  the theta-tau valley) becomes a near-independent Gaussian in z, and
  (b) the ENTIRE prior is a product of independent 1-D distributions —
  ``z ~ N(0,1)``, hypers and non-pooled locals from their declared
  specs — i.e. exactly a :class:`~lisp_mcmc_tpu.PriorSpec`.  Every
  estimator built on the named-prior convention (``nested_sample``,
  ``smc_sample``, ``log_evidence``, ``laplace_approx``,
  ``advi``/``flow_advi``) therefore consumes a hierarchical fit with
  zero new math; :meth:`prior_predictive` adds only the decode,
  returning one per-dataset draw set.
- **One stacked ensemble, no gathers.**  Each walker carries the whole
  grid: positions are ``(W, 2*P + S*d_local)`` and the likelihood
  evaluates all ``(W, S)`` dataset terms as one vmapped program against
  the stacked ``(S, N)`` Dataset pytree (the same argument-passing
  contract as :class:`~lisp_mcmc_tpu.BatchedFit` — data rides through
  jit as a pytree argument, never a closure constant).
- **Full-covariance adaptation absorbs the z–hyper coupling.**  The
  classic centered-vs-non-centered tradeoff (non-centered couples z to
  (mu, tau) when the data are strong) is softened here because the
  proposal is the adaptive full-d covariance (Haario scaling,
  mcmc-fitting.lisp:929-942 lineage): the learned L carries the
  z–mu–tau correlations.  For large grids prefer the gradient kernels
  (``kernel="chees"``) — d grows as ``2P + S*d_local``.

Reference citations: the pooled likelihood term generalizes the
independent-walker batch driver (nv-specific.lisp:58-66); prior
semantics follow the bounds/penalty conventions of
mcmc-fitting.lisp:346-369 via the PriorSpec machinery (priors.py
"Convention").
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Mapping, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from .data import Dataset
from .fit import Walker, _Term
from .likelihoods import log_likelihood_normal
from .params import ParamSpec
from .priors import Gaussian, LogNormal, PriorSpec, Uniform, log_prior_flat

__all__ = ["HierarchicalFit", "LOGOResult"]


@dataclasses.dataclass(frozen=True)
class LOGOResult:
    """Leave-one-group-out CV summary (:meth:`HierarchicalFit.logo`).

    ``elpd``: sum over datasets of log p(y_s | y_{-s}) — the expected
    log predictive density for an entire NEW group drawn from the
    population; ``elpd_per_dataset``: the per-group terms (a very
    negative entry flags a dataset the population does not describe);
    ``se``: standard error of ``elpd`` across groups (sqrt(n * var)
    over the FINITE per-group terms, ddof=1 — the loo/kfold
    convention; an all-underflow group contributes -inf to ``elpd``
    but not NaN to ``se``).
    """

    elpd: float
    se: float
    elpd_per_dataset: np.ndarray
    # Per-group convergence gate (diagnostics.grouped_refit_health): a
    # False entry means that group's leave-out refit failed to mix and
    # its elpd entry is unreliable (kept, loudly warned, marked here).
    refit_ok: np.ndarray | None = None

    def __repr__(self):
        return (f"LOGOResult(elpd={self.elpd:.2f}, se={self.se:.2f}, "
                f"S={len(self.elpd_per_dataset)})")


def _as_dist(v, what):
    if isinstance(v, (Uniform, Gaussian, LogNormal)):
        return v
    if isinstance(v, (tuple, list)) and len(v) == 2:
        return Uniform(float(v[0]), float(v[1]))
    raise ValueError(f"{what}: expected a distribution or (low, high) "
                     f"tuple, got {v!r}")


def _dist_median(d) -> float:
    return float(np.asarray(d.icdf(jnp.asarray(0.5))))


def _term_branch_model(fns, one_col: bool):
    """The synthesized branching model of the term-id-column recipe
    (shared by the constructor and ``hierarchical_load``, which rebuilds
    it from the serialized term-function NAMES)."""
    T = len(fns)

    def model(x, p):
        tid = x[..., -1]
        xin = x[..., 0] if one_col else x[..., :-1]
        out = fns[0](xin, p)
        for t in range(1, T):
            out = jnp.where(tid < t - 0.5, out, fns[t](xin, p))
        return out

    model.__name__ = "hier_multiterm[" + ",".join(
        getattr(f, "__name__", "f") for f in fns) + "]"
    model._term_fns = tuple(fns)
    model._term_one_col = one_col
    return model


def _build_term_id_blocks(fns, datasets, data_error):
    """First-class multi-term blocks (VERDICT r4 #8): apply the
    documented term-id-column recipe (docs/API.md "Multi-term blocks")
    inside the constructor.

    ``fns`` is the per-term function list (the reference's global-fit
    shape, test.lisp:52-78) and each dataset is a list of T ``(x, y)``
    pairs.  Builds per dataset ONE multi-column x whose LAST column is
    the term id, concatenates y (and per-term sigmas), and synthesizes
    the branching model ``where(tid < t, ..., fns[t](x0, p))`` — the
    exact graph the hand-written recipe produces, so the posterior is
    bitwise the recipe's (pinned in test_hier_multiterm.py).  Every
    term evaluates on every point (fine for closed-form models; give
    expensive terms their own dataset rows instead).
    """
    T = len(fns)
    S = len(datasets)
    if T < 1:
        raise ValueError("function=[]: need at least one term function")
    new_sets = []
    ndims = set()
    for s, terms in enumerate(datasets):
        if not isinstance(terms, (list, tuple)) or len(terms) != T or \
                not all(isinstance(t, (list, tuple)) and len(t) == 2
                        for t in terms):
            raise ValueError(
                f"function is a list of {T} terms, so each dataset must "
                f"be a list of {T} (x, y) pairs — dataset {s} is "
                f"{type(terms).__name__} of len "
                f"{len(terms) if hasattr(terms, '__len__') else '?'}")
        xs = [np.asarray(x, np.float64) for x, _ in terms]
        ys = [np.asarray(y, np.float64) for _, y in terms]
        ndims.update(x.ndim for x in xs)
        if len(ndims) > 1:
            raise ValueError("multi-term blocks: every term's x must "
                             "have the same column count")
        cols = []
        for t, x in enumerate(xs):
            x2 = x[:, None] if x.ndim == 1 else x
            cols.append(np.concatenate(
                [x2, np.full((x2.shape[0], 1), float(t))], axis=1))
        new_sets.append((np.concatenate(cols, axis=0),
                         np.concatenate(ys)))

    one_col = ndims == {1}
    model = _term_branch_model(fns, one_col)

    if data_error is None or np.isscalar(data_error):
        new_err = data_error
    else:
        if len(data_error) != S:
            raise ValueError(f"data_error: {len(data_error)} entries "
                             f"for {S} datasets")
        new_err = []
        for s, e in enumerate(data_error):
            ns = [np.asarray(x).shape[0] for x, _ in datasets[s]]
            if isinstance(e, (list, tuple)) and len(e) == T:
                new_err.append(np.concatenate(
                    [np.broadcast_to(np.asarray(et, np.float64), (n,))
                     for et, n in zip(e, ns)]))
            else:
                arr = np.asarray(e, np.float64)
                if arr.ndim == 0:
                    new_err.append(float(arr))
                elif arr.shape == (sum(ns),):
                    new_err.append(arr)
                else:
                    raise ValueError(
                        f"data_error[{s}]: expected a scalar, a per-term "
                        f"list of {T} entries, or a flat array of "
                        f"{sum(ns)} sigmas, got shape {arr.shape}")
    return model, new_sets, new_err


class _HierarchicalView:
    """Single-dataset facade over a HierarchicalFit, in NATURAL space.

    Presents exactly the surface the predictive/diagnostic toolchain
    dispatches on (``steps``/``spec``/``dtype``/``terms``, no group_ids,
    no custom posterior): history positions are decoded from the walk's
    (z, mu, tau) coordinates to dataset ``s``'s theta, so
    ``diagnostics.waic/loo/loo_pit`` and
    ``predictive.posterior_predictive`` run unmodified per dataset.
    The logprob column is the fit's JOINT log-posterior (only position
    columns feed the per-dataset verbs).
    """

    group_ids = None
    _custom_log_post = None
    _custom_batched = None
    # Refit-CV on a view would rebuild a DIFFERENT model (single-dataset
    # likelihood, flat prior, no population term) and return plausible
    # but wrong "exact" elpds — _global_batched_refit checks this marker.
    _refit_unsupported = (
        "hierarchical dataset views cannot be refit: the rebuilt "
        "posterior would drop the population prior (a different model "
        "than the one that produced the Pareto-k flags); use waic/loo "
        "on the view, or the joint toolchain on the full fit")
    # Power-scaling the view's flat stand-in prior would trivially read
    # "robust" for every parameter — the pooled prior lives in walk
    # space.  diagnostics.prior_sensitivity checks this marker (audit
    # records it as skipped).
    _prior_sensitivity_unsupported = (
        "hierarchical dataset views carry a flat stand-in prior (the "
        "pooled prior lives in walk space), so per-dataset power-"
        "scaling would trivially read 'robust'; run prior_sensitivity "
        "on the FULL fit instead")

    def __init__(self, fit: "HierarchicalFit", s: int):
        self.spec = fit.local_spec
        self.dtype = fit.dtype
        self.terms = [_Term(fn=fit.terms[0].fn, dataset=fit._datasets[s],
                            likelihood=fit._likelihood,
                            prior=log_prior_flat)]
        self._fit = fit
        self._s = s

    def _history(self, take=None):
        pos, lp = self._fit._history(take)          # (T, W, d), (T, W)
        nat = self._fit._decode_np_one(np.asarray(pos), self._s)
        return nat, np.asarray(lp)

    def steps(self, take=None):
        pos, lp = self._history(take)
        return pos.reshape(-1, pos.shape[-1]), lp.reshape(-1)

    def most_likely_params(self) -> dict:
        return self._fit.params_per_dataset("best")[self._s]


class _SeededLWalker(Walker):
    """Walker whose initial proposal L is supplied by the caller.

    Walk-space coordinates like the non-centered z start near 0, so the
    base diag-of-magnitudes policy (fit.py ``_initial_l_matrix``,
    mcmc-fitting.lisp:899 lineage) would hand them meaningless fallback
    scales; refit ensembles instead inherit the parent fit's ADAPTED
    factor and re-adapt from there."""

    def __init__(self, *args, l_seed=None, **kwargs):
        self._l_seed_matrix = l_seed
        super().__init__(*args, **kwargs)

    def _initial_l_matrix(self, vec):
        if getattr(self, "_l_seed_matrix", None) is None:
            return super()._initial_l_matrix(vec)
        return jnp.asarray(self._l_seed_matrix, self.dtype)


class HierarchicalFit(Walker):
    """Partial pooling across S datasets as ONE walker ensemble.

    ``function``: one model ``f(x, params) -> y`` shared by all
    datasets.  ``datasets``: list of ``(x, y)`` pairs (ragged lengths
    pad like :class:`~lisp_mcmc_tpu.BatchedFit`).  ``params``: one guess
    dict or a per-dataset list.  ``pooled``: names of local parameters
    drawn from the population (default: all of them); the rest stay
    independent per dataset.  ``hyper``: ``{name: (mu_prior,
    tau_prior)}`` hyperprior overrides — distributions or ``(low,
    high)`` tuples; ``tau`` priors must have non-negative support.
    Defaults are magnitude-derived weakly-informative choices
    (``mu ~ Gaussian(guess, |guess|)``, ``tau ~
    LogNormal(log(|guess|/4), 1)``) — fine for exploration, declare
    ``hyper=`` for real work.  ``local_priors``: priors for NON-pooled
    per-dataset parameters (same entries per dataset); when every
    non-pooled name has one, :attr:`prior_spec` is a complete
    :class:`~lisp_mcmc_tpu.PriorSpec` and the whole evidence/
    calibration layer applies (otherwise those locals are flat and
    evidence verbs see no resolvable prior).

    ``correlation="full"`` upgrades the diagonal population to a
    CORRELATED one: ``theta_s = mu + diag(tau) (I + C) z_s`` with ``C``
    strictly lower triangular (P(P-1)/2 extra walk coordinates, one per
    pooled pair, each under ``corr_prior`` — default ``Gaussian(0,
    0.5)``, shrinking toward the diagonal model).  Real scan grids have
    correlated per-spectrum parameters (the reference's own NV physics
    couples locals: nv-specific.lisp:31-34) and a diagonal population
    cannot shrink along the correlation.  ``tau_p`` becomes the
    conditional (unit-slant) scale; :meth:`population_covariance`
    reports the implied marginal covariance.

    Walk-space parameter names (``spec.keys``):
    ``{p}__mu`` / ``{p}__tau`` hypers, ``{p_i}__c_{p_j}`` population
    slants (``correlation="full"``), ``{p}__z{s}`` standardized
    per-dataset offsets for pooled ``p``, ``{p}__{s}`` natural values
    for non-pooled ``p``.  Natural-space access:
    :meth:`params_per_dataset`, :meth:`hyper_params`,
    :meth:`dataset_view`.
    """

    def __init__(
        self,
        function: Callable,
        datasets: Sequence,
        params,
        data_error=None,
        *,
        pooled: Sequence[str] | None = None,
        hyper: Mapping | None = None,
        local_priors: Mapping | None = None,
        log_likelihood: Callable | None = None,
        n_walkers: int = 256,
        seed: int = 0,
        walker_jitter: float = 0.02,
        dtype=None,
        config=None,
        proposal: str = "auto",
        correlation: str = "diag",
        corr_prior=None,
    ):
        from .batched import BatchedFit
        from .fit import default_dtype

        if proposal not in ("auto", "dense", "block"):
            raise ValueError(
                f"proposal must be 'auto', 'dense' or 'block', got {proposal!r}")
        if correlation not in ("diag", "full"):
            raise ValueError(f"correlation must be 'diag' or 'full', "
                             f"got {correlation!r}")
        if isinstance(function, (list, tuple)):
            # First-class multi-term blocks: function=[f1, f2, ...] with
            # data=[[(x1, y1), (x2, y2), ...], ...] applies the term-id
            # -column recipe internally (docs/API.md "Multi-term
            # blocks"); the synthesized model is exposed afterwards as
            # ``self.terms[0].fn`` (checkpoints of it need an explicit
            # function= on load, the unserializable-callable contract).
            function, datasets, data_error = _build_term_id_blocks(
                list(function), datasets, data_error)

        dtype = dtype or default_dtype()
        S = len(datasets)
        if S < 2:
            raise ValueError("HierarchicalFit: need >= 2 datasets to pool "
                             "(one dataset has no population to share)")

        guesses = params if isinstance(params, (list, tuple)) else [params] * S
        if len(guesses) != S:
            raise ValueError(f"{len(guesses)} parameter guesses for {S} datasets")
        local_spec = ParamSpec.from_params(guesses[0])
        local_keys = local_spec.keys
        dl = local_spec.ndim

        pooled = list(local_keys) if pooled is None else \
            [k[1:] if k.startswith(":") else k for k in pooled]
        unknown = [p for p in pooled if p not in local_keys]
        if unknown:
            raise ValueError(f"pooled names {unknown} not in params "
                             f"{list(local_keys)}")
        if not pooled:
            raise ValueError("HierarchicalFit: pooled=[] pools nothing — "
                             "use BatchedFit for independent fits")
        dp = len(pooled)
        pooled_cols = np.asarray([local_spec.index(p) for p in pooled])

        # ----- hyperpriors (mu_p, tau_p) --------------------------------
        g0 = np.asarray([float(np.mean([float(g[k]) for g in guesses]))
                         for k in local_keys])
        from .fit import _nonzero_scales

        scales = _nonzero_scales(g0)
        hyper = dict(hyper or {})
        self._hyper = {}
        for p in pooled:
            j = local_spec.index(p)
            if p in hyper:
                mu_d, tau_d = hyper.pop(p)
                mu_d = _as_dist(mu_d, f"hyper[{p}].mu")
                tau_d = _as_dist(tau_d, f"hyper[{p}].tau")
            else:
                s_p = abs(float(scales[j]))
                mu_d = Gaussian(float(g0[j]), s_p)
                tau_d = LogNormal(float(np.log(s_p / 4.0)), 1.0)
            if tau_d.support[0] < 0:
                raise ValueError(
                    f"hyper[{p}]: tau prior must have non-negative support, "
                    f"got {tau_d.support}")
            self._hyper[p] = (mu_d, tau_d)
        if hyper:
            raise ValueError(f"hyper entries for non-pooled names: "
                             f"{sorted(hyper)}")

        # ----- non-pooled local priors ----------------------------------
        non_pooled = [k for k in local_keys if k not in pooled]
        local_priors = {
            (k[1:] if k.startswith(":") else k): v
            for k, v in dict(local_priors or {}).items()}
        unknown = [k for k in local_priors if k not in non_pooled]
        if unknown:
            raise ValueError(
                f"local_priors for {unknown} — only NON-pooled local "
                f"parameters take one (pooled parameters get theirs from "
                f"the population; non-pooled here: {non_pooled})")
        self._local_dists = {k: _as_dist(v, f"local_priors[{k}]")
                             for k, v in local_priors.items()}

        # ----- population correlation (VERDICT r4 #1) -------------------
        # correlation="full" upgrades the diagonal population to
        # theta_s = mu + L_pop @ z_s with L_pop = diag(tau) @ Ltilde,
        # Ltilde unit-lower-triangular with free entries c_{ij}
        # (dimensionless slants, one walk coordinate each).  The prior
        # stays a product of independent 1-D dists — each c_{ij} gets
        # ``corr_prior`` (default Gaussian(0, 0.5), shrinking toward the
        # diagonal population like a weak LKJ) — so the whole PriorSpec
        # evidence/SBC/calibration layer rides unchanged.  tau_p is the
        # UNIT-SLANT scale (the conditional sd of theta_p given the
        # earlier pooled coordinates); the implied marginal population
        # covariance is :meth:`population_covariance`.  Physics
        # motivation: the reference's own NV constraints couple local
        # parameters across a device (0.9 < scale1/scale2 < 1.1,
        # mu2 - mu1 >= 6 — nv-specific.lisp:31-34); a diagonal
        # population cannot shrink along that correlation.
        if correlation == "full" and dp < 2:
            raise ValueError(
                "correlation='full' needs >= 2 pooled parameters "
                f"(got {dp}: {list(pooled)}) — there is no off-diagonal "
                "to correlate")
        nc = dp * (dp - 1) // 2 if correlation == "full" else 0
        self.correlation = correlation
        self.n_corr = nc
        corr_pairs = [(i, j) for i in range(dp) for j in range(i)] if nc \
            else []
        self._corr_pairs = np.asarray(corr_pairs, dtype=int).reshape(nc, 2)
        if nc:
            self._corr_dist = (Gaussian(0.0, 0.5) if corr_prior is None
                               else _as_dist(corr_prior, "corr_prior"))
        elif corr_prior is not None:
            raise ValueError("corr_prior= given but correlation='diag' "
                             "(set correlation='full' to use it)")
        else:
            self._corr_dist = None

        # ----- walk-space layout ----------------------------------------
        # [mu (dp) | tau (dp) | c (nc, full-correlation only) |
        #  s-major local blocks (S, dl)]
        keys = [f"{p}__mu" for p in pooled] + [f"{p}__tau" for p in pooled]
        keys += [f"{pooled[i]}__c_{pooled[j]}" for i, j in corr_pairs]
        for s in range(S):
            keys += [f"{k}__z{s}" if k in pooled else f"{k}__{s}"
                     for k in local_keys]
        spec = ParamSpec(tuple(keys))
        self.local_spec = local_spec
        self.pooled = tuple(pooled)
        self.n_datasets = S
        self._n_hyper = 2 * dp + nc
        self._pooled_cols = pooled_cols

        # ----- proposal structure (VERDICT r3 #5) ------------------------
        # The walk space is [2P hypers | S local blocks of dl] and the
        # posterior's coupling is hyper<->local only — block-diagonal by
        # construction.  "block" applies/refreshes L per block
        # (kernel.py config.block_*): O(4P^2 + S*dl^2) proposal math per
        # walker-step instead of O(d^2), per-block covariance
        # sufficiency (counts > max block instead of counts > d — dense
        # refresh is impossible at W < d, exactly the scan-grid
        # regime), at the price of dropping z<->hyper proposal
        # correlations.  "auto" switches to block at d >= 96 (measured
        # crossover region, benchmarks/hierarchical_scaling.py — dense
        # wins below, where the full covariance's coupling capture
        # matters more than the d^2 term).
        import dataclasses as _dc

        d_walk = spec.ndim
        base_cfg = config if config is not None else None
        want_block = proposal == "block" or (proposal == "auto"
                                             and d_walk >= 96)
        if want_block:
            from .kernel import FitConfig

            base = base_cfg or FitConfig()
            if base.kernel in ("rwm", "mala", "hmc", "chees"):
                config = _dc.replace(base, block_hyper=2 * dp + nc,
                                     block_local=dl, block_count=S)
            elif proposal == "block":
                raise ValueError(
                    f"proposal='block' needs an L-matrix kernel "
                    f"(rwm/mala/hmc/chees), not {base.kernel!r} "
                    "(stretch/demc/slice are L-free)")

        # Static decode matrices: P (dl, dp) selects pooled hyper columns;
        # closure constants are structural (fixed for the fit), datasets
        # still ride through jit as arguments (CLAUDE.md invariant).
        P = np.zeros((dl, dp))
        P[pooled_cols, np.arange(dp)] = 1.0
        mask = np.zeros(dl)
        mask[pooled_cols] = 1.0
        P_j = jnp.asarray(P, dtype)
        mask_j = jnp.asarray(mask, dtype)
        self._P_np, self._mask_np = P, mask
        # Scatter basis for the strictly-lower slant matrix: C = sum_k
        # c_k E_k, so building the (..., dp, dp) matrix per walker is a
        # single small einsum (nc <= dp(dp-1)/2, static).
        E = np.zeros((max(nc, 1), dp, dp))
        for k, (i, j) in enumerate(corr_pairs):
            E[k, i, j] = 1.0
        E_j = jnp.asarray(E, dtype)
        self._E_np = E
        nh = 2 * dp + nc

        def decode(theta):
            """(..., d) walk coordinates -> (..., S, dl) natural theta."""
            mu = theta[..., :dp]
            tau = theta[..., dp:2 * dp]
            loc = theta[..., nh:]
            loc = loc.reshape(loc.shape[:-1] + (S, dl))
            if nc:
                # Unit-slant mix: z_eff = (I + C) z in the pooled
                # columns, then the diagonal decode applies unchanged
                # (theta = mu + tau * z_eff).  nc == 0 skips this at
                # trace time — the diagonal path stays bitwise what it
                # was.
                c = theta[..., 2 * dp:nh]
                z = loc @ P_j                           # (..., S, dp)
                C = jnp.einsum("...k,kpq->...pq", c, E_j)
                cz = jnp.einsum("...pq,...sq->...sp", C, z)
                loc = loc + cz @ P_j.T
            mu_cols = mu @ P_j.T                        # (..., dl)
            tau_cols = (1.0 - mask_j) + tau @ P_j.T
            return loc * tau_cols[..., None, :] + mu_cols[..., None, :]

        self._decode = decode

        # ----- data stack (BatchedFit's custom-likelihood contract) -----
        errors = BatchedFit._normalize_errors(data_error, datasets)
        n_max = max(len(np.asarray(d[0])) for d in datasets)
        dsets = [Dataset.create(x, y, err, dtype=dtype, min_len=n_max)
                 for (x, y), err in zip(datasets, errors)]
        self._datasets = dsets
        batch_data = {"ds": Dataset(
            x=jnp.stack([ds.x for ds in dsets]),
            y=jnp.stack([ds.y for ds in dsets]),
            sigma=jnp.stack([ds.sigma for ds in dsets]),
            mask=jnp.stack([ds.mask for ds in dsets]),
            n=int(dsets[0].x.shape[0]),
            inv_sigma=jnp.stack([ds.inv_sigma for ds in dsets]),
            log_norm_const=jnp.stack([ds.log_norm_const for ds in dsets]),
            log_norm_const_point=jnp.stack(
                [ds.log_norm_const_point for ds in dsets]),
            log_fact_y=jnp.stack([ds.log_fact_y for ds in dsets]),
        )}

        if log_likelihood is not None \
                and log_likelihood is not log_likelihood_normal:
            from .likelihoods import resolve_likelihood

            likelihood = resolve_likelihood(
                log_likelihood, function, guesses[0], dsets[0])
        else:
            likelihood = log_likelihood_normal
        self._likelihood = likelihood

        # ----- prior: product of independent 1-D dists ------------------
        dists = {f"{p}__mu": self._hyper[p][0] for p in pooled}
        dists.update({f"{p}__tau": self._hyper[p][1] for p in pooled})
        dists.update({f"{pooled[i]}__c_{pooled[j]}": self._corr_dist
                      for i, j in corr_pairs})
        for s in range(S):
            for k in local_keys:
                if k in pooled:
                    dists[f"{k}__z{s}"] = Gaussian(0.0, 1.0)
                elif k in self._local_dists:
                    dists[f"{k}__{s}"] = self._local_dists[k]
        self._complete_prior = len(dists) == spec.ndim
        if self._complete_prior:
            # Every coordinate named -> the full evidence/calibration
            # layer applies (resolve_prior_spec finds _prior_spec).
            self.prior_spec = PriorSpec(dists)
            prior = self.prior_spec.as_log_prior()
        else:
            # Flat non-pooled locals: still a valid posterior, but no
            # normalizable prior measure for the evidence verbs.
            self.prior_spec = None
            partial = PriorSpec(dists).as_log_prior()

            def prior(params, dataset=None, _partial=partial, _d=dists):
                sub = {k: params[k] for k in _d}
                return _partial(sub, dataset)

            prior.__name__ = "hierarchical_partial_prior"

        def log_post(theta, data):
            nat = decode(theta)                        # (S, dl)

            def per_ds(th_s, ds_s):
                return likelihood(function, local_spec.unflatten(th_s), ds_s)

            lik = jnp.sum(jax.vmap(per_ds)(nat, data["ds"]))
            return lik + prior(spec.unflatten(theta), None)

        # ----- initial ensemble -----------------------------------------
        rng = np.random.default_rng(seed)
        mu0 = g0[pooled_cols]
        tau0 = np.asarray([_dist_median(self._hyper[p][1]) for p in pooled])
        guess_mat = np.asarray(
            [[float(g[k]) for k in local_keys] for g in guesses])  # (S, dl)
        z0 = (guess_mat[:, pooled_cols] - mu0) / np.maximum(tau0, 1e-300)
        z0 = np.clip(z0, -3.0, 3.0)

        pos = np.empty((n_walkers, spec.ndim))
        jit = walker_jitter
        mu_scale = np.maximum(np.abs(mu0), tau0)   # spread even at mu0 = 0
        pos[:, :dp] = mu0 + jit * mu_scale * rng.standard_normal(
            (n_walkers, dp))
        pos[:, dp:2 * dp] = tau0 * np.exp(
            jit * rng.standard_normal((n_walkers, dp)))
        if nc:
            # Slants start at the prior median (0 for the default
            # Gaussian: the diagonal population) with jitter at the
            # prior's central spread.
            c0 = _dist_median(self._corr_dist)
            c_scale = float(np.asarray(
                self._corr_dist.icdf(jnp.asarray(0.84))
                - self._corr_dist.icdf(jnp.asarray(0.16)))) / 2.0
            pos[:, 2 * dp:nh] = c0 + jit * c_scale * rng.standard_normal(
                (n_walkers, nc))
        loc = np.broadcast_to(guess_mat, (n_walkers, S, dl)).copy()
        loc[:, :, pooled_cols] = (
            z0 + 0.3 * rng.standard_normal((n_walkers, S, dp)))
        np_cols = np.asarray([j for j in range(dl) if j not in pooled_cols],
                             dtype=int)
        if np_cols.size:
            # Additive jitter at the parameter's derived scale: identical
            # to the base class's multiplicative jitter for nonzero
            # guesses, but a zero guess (e.g. a background term) still
            # gets ensemble spread instead of a degenerate column.
            loc[:, :, np_cols] += (
                jit * np.abs(scales[np_cols])[None, None, :]
                * rng.standard_normal((n_walkers, S, np_cols.size)))
        pos[:, nh:] = loc.reshape(n_walkers, S * dl)

        # Proposal seed scales in WALK space: z ~ 0.5, mu ~ tau0 (the
        # population spread is mu's natural step), tau ~ tau0/2,
        # c slants ~ half their prior spread,
        # non-pooled locals ~ their magnitudes (base-class policy).
        l_scales = np.empty(spec.ndim)
        l_scales[:dp] = np.maximum(tau0, np.abs(mu0) * 1e-3 + 1e-300)
        l_scales[dp:2 * dp] = 0.5 * tau0
        if nc:
            l_scales[2 * dp:nh] = 0.5 * max(c_scale, 1e-3)
        lscale_loc = np.empty((S, dl))
        lscale_loc[:, pooled_cols] = 0.5
        if np_cols.size:
            # Scales derived from the FULL guess vector (zero guesses
            # inherit a fallback from the other magnitudes, the base
            # class's _nonzero_scales policy) — deriving from the
            # non-pooled subset alone would hand an all-zero subset a
            # meaningless 1e-3.
            lscale_loc[:, np_cols] = np.abs(scales[np_cols])[None, :]
        l_scales[nh:] = lscale_loc.reshape(-1)
        self._l_seed = l_scales

        ds0 = dsets[0]
        super().__init__(
            terms=[_Term(fn=function, dataset=ds0,
                         likelihood=likelihood, prior=prior)],
            spec=spec,
            initial_vector=jnp.asarray(pos, dtype),
            n_walkers=n_walkers,
            seed=seed,
            walker_jitter=0.0,   # jitter applied above, walk-space aware
            config=config,
            dtype=dtype,
            log_posterior=log_post,
            posterior_data=batch_data,
        )

    def _initial_l_matrix(self, vec):
        """Walk-space proposal seed (z coordinates start at ~0, so the
        base diag-of-magnitudes policy, fit.py _initial_l_matrix, would
        hand them a meaningless fallback scale)."""
        if getattr(self, "_l_seed", None) is None:  # base-class init order
            return super()._initial_l_matrix(vec)
        return jnp.asarray(np.diag(self._l_seed), self.dtype)

    # ------------------------------------------------------------ decode

    def _slant_np(self, pos: np.ndarray) -> np.ndarray:
        """(..., d) walk vectors -> (..., dp, dp) strictly-lower slant
        matrix C (zeros when correlation='diag')."""
        dp = len(self.pooled)
        c = pos[..., 2 * dp:self._n_hyper]
        return np.einsum("...k,kpq->...pq", c, self._E_np[:self.n_corr])

    def _decode_np(self, pos: np.ndarray) -> np.ndarray:
        """Host twin of the jitted decode: (..., d) -> (..., S, dl)."""
        dp = len(self.pooled)
        S, dl = self.n_datasets, self.local_spec.ndim
        nh = self._n_hyper
        mu = pos[..., :dp]
        tau = pos[..., dp:2 * dp]
        loc = pos[..., nh:].reshape(pos.shape[:-1] + (S, dl))
        if self.n_corr:
            z = loc @ self._P_np                       # (..., S, dp)
            C = self._slant_np(pos)
            cz = np.einsum("...pq,...sq->...sp", C, z)
            loc = loc + cz @ self._P_np.T
        mu_cols = mu @ self._P_np.T
        tau_cols = (1.0 - self._mask_np) + tau @ self._P_np.T
        return loc * tau_cols[..., None, :] + mu_cols[..., None, :]

    def _decode_np_one(self, pos: np.ndarray, s: int) -> np.ndarray:
        """Decode ONLY dataset ``s``'s block: (..., d) -> (..., dl).

        The per-dataset view loops (waic/loo/loo_pit/audit over S
        views) call this instead of :meth:`_decode_np` — decoding the
        full (..., S, dl) grid per view would make those loops O(S^2)
        in decode work and S-times peak memory.
        """
        dp = len(self.pooled)
        dl = self.local_spec.ndim
        nh = self._n_hyper
        mu = pos[..., :dp]
        tau = pos[..., dp:2 * dp]
        loc = pos[..., nh + s * dl:nh + (s + 1) * dl]
        if self.n_corr:
            z = loc @ self._P_np                       # (..., dp)
            C = self._slant_np(pos)
            cz = np.einsum("...pq,...q->...p", C, z)
            loc = loc + cz @ self._P_np.T
        mu_cols = mu @ self._P_np.T
        tau_cols = (1.0 - self._mask_np) + tau @ self._P_np.T
        return loc * tau_cols + mu_cols

    def decode_params(self, theta) -> np.ndarray:
        """Walk-space vector(s) -> natural (..., S, d_local) array."""
        return self._decode_np(np.asarray(theta, np.float64))

    # ----------------------------------------------------------- queries

    def _best_vector(self) -> np.ndarray:
        best_lp = np.asarray(self.state.best_logprob)
        return np.asarray(self.state.best_position)[int(best_lp.argmax())]

    def params_per_dataset(self, kind: str = "best") -> list[dict]:
        """Per-dataset NATURAL parameter dicts.

        ``kind="best"``: decode of the ensemble's most-likely walk point
        (the joint MAP estimate — one coherent (hypers, locals) vector).
        ``kind="median"``: per-coordinate posterior median of the
        decoded history (marginal summaries).
        """
        if kind == "best":
            nat = self._decode_np(self._best_vector())
        elif kind == "median":
            pos, _ = self._history(None)
            nat = np.median(self._decode_np(np.asarray(pos)), axis=(0, 1))
        else:
            raise ValueError(f"kind must be 'best' or 'median', got {kind!r}")
        return [self.local_spec.make(nat[s].tolist())
                for s in range(self.n_datasets)]

    def hyper_params(self, kind: str = "best") -> dict:
        """Population summary: ``{"mu": {name: v}, "tau": {name: v}}``;
        with ``correlation="full"`` also ``"c"`` (the raw unit-slant
        entries, keyed ``"{p_i}|{p_j}"``) — the implied covariance
        matrix is :meth:`population_covariance`."""
        dp = len(self.pooled)
        if kind == "best":
            vec = self._best_vector()
        elif kind == "median":
            pos, _ = self._history(None)
            vec = np.median(np.asarray(pos).reshape(-1, self.spec.ndim),
                            axis=0)
        else:
            raise ValueError(f"kind must be 'best' or 'median', got {kind!r}")
        out = {"mu": dict(zip(self.pooled, vec[:dp].tolist())),
               "tau": dict(zip(self.pooled, vec[dp:2 * dp].tolist()))}
        if self.n_corr:
            out["c"] = {
                f"{self.pooled[i]}|{self.pooled[j]}": float(vec[2 * dp + k])
                for k, (i, j) in enumerate(self._corr_pairs)}
        return out

    def population_covariance(self, kind: str = "best") -> np.ndarray:
        """Implied population covariance over the pooled parameters
        (order :attr:`pooled`): ``Sigma = D (I+C) (I+C)^T D`` with
        ``D = diag(tau)`` and ``C`` the strictly-lower slant matrix —
        the marginal sd of pooled ``p`` is ``sqrt(Sigma[p, p])``, NOT
        ``tau_p``, once slants are nonzero.  ``kind="draws"`` returns
        the (n, P, P) posterior of Sigma over the collected history
        (for credible intervals on a correlation)."""
        dp = len(self.pooled)
        if kind == "draws":
            pos, _ = self._history(None)
            vecs = np.asarray(pos, np.float64).reshape(-1, self.spec.ndim)
        elif kind in ("best", "median"):
            hp = self.hyper_params(kind)
            vecs = np.concatenate([
                np.asarray([hp["mu"][p] for p in self.pooled]),
                np.asarray([hp["tau"][p] for p in self.pooled]),
                np.asarray([hp.get("c", {}).get(
                    f"{self.pooled[i]}|{self.pooled[j]}", 0.0)
                    for i, j in self._corr_pairs]),
                np.zeros(self.spec.ndim - self._n_hyper)])[None, :]
        else:
            raise ValueError(
                f"kind must be 'best', 'median' or 'draws', got {kind!r}")
        tau = vecs[:, dp:2 * dp]
        Lt = np.eye(dp)[None, :, :] + self._slant_np(vecs)
        L = tau[:, :, None] * Lt
        sigma = np.einsum("npq,nrq->npr", L, L)
        return sigma if kind == "draws" else sigma[0]

    def dataset_view(self, s: int) -> _HierarchicalView:
        """Natural-space single-dataset view (predictive toolchain
        surface: ``diagnostics.waic/loo/loo_pit``,
        ``posterior_predictive`` run unmodified on it)."""
        if not 0 <= s < self.n_datasets:
            raise IndexError(f"dataset {s} of {self.n_datasets}")
        return _HierarchicalView(self, s)

    def waic_per_dataset(self, **kwargs) -> list:
        from .diagnostics import waic

        return [waic(self.dataset_view(s), **kwargs)
                for s in range(self.n_datasets)]

    def loo_per_dataset(self, **kwargs) -> list:
        from .diagnostics import loo

        return [loo(self.dataset_view(s), **kwargs)
                for s in range(self.n_datasets)]

    def posterior_predictive_per_dataset(self, **kwargs) -> list:
        from .predictive import posterior_predictive

        return [posterior_predictive(self.dataset_view(s), **kwargs)[0]
                for s in range(self.n_datasets)]

    def loo_pit_per_dataset(self, **kwargs) -> list:
        from .diagnostics import loo_pit

        return [loo_pit(self.dataset_view(s), **kwargs)
                for s in range(self.n_datasets)]

    # ----------------------------------------- joint pointwise toolchain

    def _pointwise_matrix(self, samples, pointwise_fn, tag: str):
        """(n, d) walk samples -> (n, N_real) per-point values over ALL
        datasets (dataset-major), via decode + the stacked Dataset."""
        data = self._posterior_data()["ds"]
        fn = self.terms[0].fn
        lik, lsp, decode = self._likelihood, self.local_spec, self._decode
        key = ("_pointwise", tag)
        jitted = self._runner_cache.get(key)
        if jitted is None:
            def one(vec, ds):
                nat = decode(vec)                      # (S, dl)

                def per(th_s, ds_s):
                    return pointwise_fn(lik, fn, lsp.unflatten(th_s), ds_s)

                return jax.vmap(per)(nat, ds).reshape(-1)   # (S*P,)

            jitted = jax.jit(jax.vmap(one, in_axes=(0, None)))
            self._runner_cache[key] = jitted
        out = np.asarray(jitted(samples, data), np.float64)
        real = np.asarray(data.mask).reshape(-1) > 0.0
        return out[:, real]

    def _pointwise_ll(self, samples):
        """Joint pointwise log-likelihood hook: the walk space is custom
        but the LIKELIHOOD decomposes per point at the decoded params,
        so whole-fit waic/loo/loo_pit/prior_sensitivity apply (compare
        pooled vs unpooled models on the same total data)."""
        from .likelihoods import pointwise_log_likelihood

        return self._pointwise_matrix(samples, pointwise_log_likelihood,
                                      "ll")

    def _pointwise_cdf(self, samples):
        from .likelihoods import pointwise_cdf

        return self._pointwise_matrix(samples, pointwise_cdf, "cdf")

    def audit_per_dataset(self, **kwargs) -> list:
        """Per-dataset calibration report cards (``diagnostics.audit``
        on each natural-space view; prior-side power-scaling records as
        ``skipped`` — the pooled prior lives in walk space, so run
        ``diagnostics.prior_sensitivity`` on the full fit for it)."""
        from .diagnostics import audit

        return [audit(self.dataset_view(s), **kwargs)
                for s in range(self.n_datasets)]

    def prior_predictive(self, n_samples: int = 256, seed: int = 0,
                         sampler=None) -> list:
        """Per-dataset prior predictive draws — the before-fitting check.

        Samples the FULL declared prior (hypers, z, non-pooled locals),
        decodes each draw to natural per-dataset parameters, and
        replicates every dataset under its own term: one
        :class:`~lisp_mcmc_tpu.predictive.PredictiveDraws` per dataset.
        Requires a complete prior (``local_priors`` for every non-pooled
        name), like the evidence verbs.
        """
        from .predictive import _replicate

        if self.prior_spec is None:
            raise ValueError(
                "prior_predictive: the prior is incomplete (non-pooled "
                "locals without local_priors have no measure to draw "
                "from) — declare local_priors for every non-pooled name")
        rng = np.random.default_rng(seed)
        samples = self.prior_spec.sample(rng, n_samples, self.spec.keys)
        nat = self._decode_np(np.asarray(samples, np.float64))  # (n, S, dl)
        return [
            _replicate(self.dataset_view(s),
                       jnp.asarray(nat[:, s, :], self.dtype),
                       seed + s, sampler, "prior_predictive")[0]
            for s in range(self.n_datasets)
        ]

    def predict_new(self, x, noise=None, take: int | None = None,
                    max_samples: int = 256, seed: int = 0,
                    population_mean: bool = False,
                    fixed: Mapping | None = None):
        """Posterior prediction for an UNSEEN dataset from the population.

        The partial-pooling answer to "what will the NEXT spectrum look
        like?" — the one question the fitted per-dataset views cannot
        answer, because a new group has no data yet.  For each posterior
        draw of the hypers, a new group's pooled parameters are decoded
        exactly the way the fitted groups' are (theta = mu + tau * z,
        the non-centered decode) but with a FRESH z ~ N(0, 1): the
        marginal posterior predictive over new groups, which is wider
        than any fitted dataset's own band because it carries both the
        population spread tau and the posterior uncertainty in
        (mu, tau).  In the conjugate normal-normal hierarchy this is
        exactly theta_new | y ~ N(E[mu|y], Var(mu|y) + tau^2) — pinned
        closed-form in tests/test_hierarchical.py.

        Non-pooled local parameters have no population to draw from:
        they sample their declared ``local_priors`` entry, or take a
        caller-pinned value from ``fixed={name: value}``; a non-pooled
        name with neither raises instead of guessing.

        ``population_mean=True`` pins z = 0, giving a credible band for
        the population-TYPICAL curve (the forest plot's population band,
        evaluated on a grid) rather than the next-group prediction.

        ``noise``: scalar or (N,) sigma adds GAUSSIAN observation noise
        so ``band()`` becomes a prediction interval for new OBSERVATIONS
        (same contract as :func:`~lisp_mcmc_tpu.predictive.predict`).
        Note the assumption: for fits built with a robust likelihood
        factory (student-t / noise-scale), a Gaussian noise band is too
        tight in the tails — use the factory's predictive sampler via
        :func:`~lisp_mcmc_tpu.predictive.posterior_predictive` on a
        fitted dataset, or pass the heavier-tailed draws yourself.
        Returns a :class:`~lisp_mcmc_tpu.predictive.Prediction`.
        """
        from .predictive import Prediction

        pos, _ = self.steps(take)
        if pos.shape[0] == 0:
            raise ValueError(
                "predict_new: no collected history (run adaptive_steps "
                "with collect_history=True first)")
        n_avail = pos.shape[0]
        idx = np.unique(np.linspace(0, n_avail - 1,
                                    min(max_samples, n_avail)).astype(int))
        samples = np.asarray(pos, np.float64)[idx]
        n = samples.shape[0]
        dp = len(self.pooled)
        mu = samples[:, :dp]
        tau = samples[:, dp:2 * dp]
        rng = np.random.default_rng(seed)
        z = np.zeros((n, dp)) if population_mean \
            else rng.standard_normal((n, dp))
        if self.n_corr:
            # A fresh group's pooled parameters are drawn CORRELATED:
            # theta = mu + tau * ((I + C) z), the same unit-slant decode
            # the fitted groups use (population_mean pins z = 0 either
            # way).
            z = z + np.einsum("npq,nq->np", self._slant_np(samples), z)

        dl = self.local_spec.ndim
        loc = np.empty((n, dl))
        loc[:, self._pooled_cols] = mu + tau * z
        fixed = {(k[1:] if k.startswith(":") else k): float(v)
                 for k, v in dict(fixed or {}).items()}
        bad = [k for k in fixed
               if k not in self.local_spec.keys or k in self.pooled]
        if bad:
            raise ValueError(
                f"predict_new: fixed= entries {bad} are not non-pooled "
                f"local parameters (non-pooled: "
                f"{[k for k in self.local_spec.keys if k not in self.pooled]})")
        for j, k in enumerate(self.local_spec.keys):
            if k in self.pooled:
                continue
            if k in fixed:
                loc[:, j] = fixed[k]
            elif k in self._local_dists:
                loc[:, j] = np.asarray(self._local_dists[k].sample(rng, n))
            else:
                raise ValueError(
                    f"predict_new: non-pooled local {k!r} has no "
                    f"population to draw from — declare "
                    f"local_priors[{k!r}] or pin it via fixed=")

        x_arr = jnp.asarray(np.asarray(x, np.float64), self.dtype)
        fn = self.terms[0].fn
        lspec = self.local_spec

        def curve(vec, xg):
            return fn(xg, lspec.unflatten(vec))

        mu_curves = np.asarray(jax.jit(jax.vmap(curve, in_axes=(0, None)))(
            jnp.asarray(loc, self.dtype), x_arr))
        y_rep = None
        if noise is not None:
            sigma = np.broadcast_to(np.asarray(noise, np.float64),
                                    mu_curves.shape[1:])
            y_rep = mu_curves + sigma * rng.standard_normal(mu_curves.shape)
        return Prediction(x=np.asarray(x), mu=mu_curves, y_rep=y_rep)

    # ------------------------------------------------------------ refit-CV

    def _grouped_joint_walker(self, refit_data, K: int, B: int, seed: int,
                              pos0, config=None) -> "_SeededLWalker":
        """K independent copies of this fit's JOINT posterior, each over
        its own stacked (S, N) Dataset block, as adaptation groups of
        ONE grouped ensemble.

        ``refit_data = {"ds": <(K, S, N) Dataset stack>}``; block g's
        posterior is the full non-centered joint model (hyperpriors,
        z-priors, every dataset's likelihood) against block g's data.
        Shared machinery of :meth:`_refit_cv` (blocks = leave-out
        masks) and hierarchical SBC (blocks = simulated grids): the
        same chip-filling trick ``BatchedFit`` uses, applied to whole
        hierarchical posteriors.  ``pos0``: (K*B, d) walk-space initial
        positions (refits resample the parent's live ensemble; SBC
        draws fresh prior points to audit burn-in too).
        """
        import dataclasses

        from .kernel import FitConfig

        if config is None and self.config.block_count > 0:
            # A blocked parent keeps its proposal structure in the
            # refit/SBC blocks too (same walk space, same coupling; the
            # grouped layout composes — groups are per-walker, blocks
            # per-coordinate).
            config = dataclasses.replace(
                FitConfig(), block_hyper=self.config.block_hyper,
                block_local=self.config.block_local,
                block_count=self.config.block_count)

        decode, lik, lsp = self._decode, self._likelihood, self.local_spec
        fn = self.terms[0].fn
        prior, spec = self.terms[0].prior, self.spec
        d = spec.ndim

        def _joint(theta, ds_block):
            nat = decode(theta)                               # (S, dl)

            def per_ds(th_s, ds_s):
                return lik(fn, lsp.unflatten(th_s), ds_s)

            lp = jnp.sum(jax.vmap(per_ds)(nat, ds_block))
            return lp + prior(spec.unflatten(theta), None)

        def log_post(theta, block_idx, rdata):
            ds_k = jax.tree_util.tree_map(lambda a: a[block_idx],
                                          rdata["ds"])
            return _joint(theta, ds_k)

        def batched_log_post(positions, rdata):
            pos_k = positions.reshape(K, B, d)

            def per_block_lp(theta_block, ds_block):
                return jax.vmap(lambda t: _joint(t, ds_block))(theta_block)

            lps = jax.vmap(per_block_lp)(pos_k, rdata["ds"])
            return lps.reshape(positions.shape[0])

        group_ids = np.repeat(np.arange(K, dtype=np.int32), B)
        fit = _SeededLWalker(
            terms=list(self.terms), spec=spec,
            initial_vector=jnp.asarray(pos0, self.dtype),
            n_walkers=K * B, seed=seed, walker_jitter=0.0,
            dtype=self.dtype, config=config,
            aux=jnp.asarray(group_ids), group_ids=group_ids, n_groups=K,
            log_posterior=log_post, posterior_data=refit_data,
            batched_log_posterior=batched_log_post,
            l_seed=np.asarray(self.state.l_matrix)[0],
        )
        if fit.config.history_walkers and fit.config.history_walkers < K * B:
            # Scoring/ranking needs every block retained (same guard as
            # _global_batched_refit / sbc_check).
            fit.config = dataclasses.replace(fit.config, history_walkers=0)
        return fit

    @property
    def _n_real_points(self) -> int:
        """Length of the dataset-major real-point axis (the axis every
        joint pointwise verb uses: waic/loo/loo_pit/_pointwise_matrix)."""
        data = self._posterior_data()["ds"]
        return int(np.sum(np.asarray(data.mask) > 0.0))

    def _refit_cv(self, name: str, holdouts, n_steps: int,
                  temperature: float, walkers_per_dataset: int,
                  burn_fraction: float, max_samples: int, seed: int):
        """Leave-out refits of the JOINT hierarchical posterior, as
        adaptation groups of ONE grouped Walker — the hook
        ``diagnostics._batched_refit`` dispatches ``reloo``/``kfold``
        through.

        Each holdout (a boolean keep-mask over the dataset-major
        real-point axis) rebuilds the stacked (S, N) Dataset with the
        held-out points' MASK zeroed — per dataset, so every cached
        walker-independent constant (inv_sigma, per-point and per-
        dataset log-normalizations, log y!) is exact for the reduced
        point set; reductions are mask-exact by construction (data.py).
        The K leave-out posteriors — each the FULL non-centered joint
        model: hyperpriors, z-priors, every dataset's likelihood — run
        as K adaptation groups of one ensemble.  This is the
        hierarchical twin of ``_global_batched_refit`` (the round-3
        multi-term machinery); the pooled-vs-unpooled comparison it
        enables is this fit class's reason to exist.

        Warm-start economics: leave-ONE-out posteriors are tiny
        perturbations of the fitted joint posterior, so each block's
        walkers start at a resample of the PARENT's live ensemble and
        the proposal L seeds from the parent's adapted factor — the
        anneal then only has to repair the one-point dent, not rediscover
        a (2P + S*d_local)-dim geometry from scratch.

        Returns ``(fit, score_block)``: ``score_block(j) -> (n, N_real)``
        pointwise log-likelihood of the ORIGINAL data (dataset-major
        real points — loo's axis) under block j's posterior draws at the
        decoded parameters.
        """
        from .diagnostics import _require_per_point
        from .fit import history_block_columns

        _require_per_point(name, self._likelihood)
        data = self._posterior_data()["ds"]
        mask_np = np.asarray(data.mask, np.float64)          # (S, N)
        flat = mask_np.reshape(-1)
        real_pos = np.where(flat > 0.0)[0]
        K = len(holdouts)
        B = walkers_per_dataset
        d = self.spec.ndim

        per_block = []
        for keep in holdouts:
            keep = np.asarray(keep)
            if keep.shape != (real_pos.size,):
                raise ValueError(
                    f"{name}: holdout mask has shape {keep.shape}, "
                    f"expected ({real_pos.size},) (dataset-major real-"
                    "point axis)")
            new_flat = flat.copy()
            new_flat[real_pos] *= keep.astype(np.float64)
            new_mask = new_flat.reshape(mask_np.shape)
            # Rebuild per dataset so __post_init__ recomputes each
            # dataset's cached constants (a direct (S, N) rebuild would
            # collapse log_norm_const to ONE scalar across all S).
            dsets = [Dataset(x=ds.x, y=ds.y, sigma=ds.sigma,
                             mask=jnp.asarray(new_mask[s],
                                              np.asarray(ds.mask).dtype),
                             n=ds.n)
                     for s, ds in enumerate(self._datasets)]
            per_block.append(jax.tree_util.tree_map(
                lambda *a: jnp.stack(a), *dsets))
        stacked = jax.tree_util.tree_map(lambda *a: jnp.stack(a),
                                         *per_block)          # (K, S, N)
        refit_data = {"ds": stacked}

        rng = np.random.default_rng(seed)
        live = np.asarray(self.state.position)                # (W, d)
        pos0 = live[rng.integers(0, live.shape[0], size=K * B)]
        fit = self._grouped_joint_walker(refit_data, K, B, seed, pos0)
        fit.adaptive_steps(n_steps, temperature=temperature, auto=None)
        fit.reset()                                # drop warm anneal rows
        fit.sampling_steps(max(2000, n_steps // 2), kernel="mala")
        fit.burn_steps(int(len(fit) * burn_fraction))

        _cache: dict = {}

        def score_block(j):
            if "pos" not in _cache:
                pos, _ = fit._history(None)                   # (T, K*B, d)
                _cache["pos"] = np.asarray(pos)
                _cache["cols"] = history_block_columns(
                    fit, _cache["pos"].shape[1])
            pos = _cache["pos"]
            block = pos[:, _cache["cols"][j], :].reshape(-1, d)
            idx = np.unique(np.linspace(
                0, block.shape[0] - 1,
                min(max_samples, block.shape[0])).astype(int))
            # Score the ORIGINAL data at the decoded params: exactly the
            # joint pointwise hook, which evaluates against the
            # UNREDUCED stacked Dataset.
            return self._pointwise_ll(jnp.asarray(block[idx], self.dtype))

        return fit, score_block

    def logo(self, n_steps: int = 6000, temperature: float = 2.0,
             walkers_per_dataset: int = 64, burn_fraction: float = 0.3,
             max_samples: int = 128, n_z: int = 16,
             seed: int = 0) -> LOGOResult:
        """Leave-one-GROUP-out CV: does the population predict a dataset
        it never saw?

        :func:`~lisp_mcmc_tpu.diagnostics.reloo`/``kfold`` answer the
        WITHIN-group question (predicting a held-out point of a fitted
        dataset); ``logo`` answers the population-level one — the
        generalization axis :meth:`predict_new` draws curves for, scored
        as a proper CV.  For each dataset s the FULL joint posterior is
        refit with s's entire block masked out (the existing
        :meth:`_refit_cv` machinery — all S leave-out posteriors run as
        adaptation groups of ONE grouped ensemble), then

            elpd_s = log p(y_s | y_{-s})
                   = log E[ p(y_s | theta_new) ],
            theta_new = mu + tau * z,  fresh z ~ N(0,1) per draw,

        estimated by the MIXED predictive: hyper draws come from block
        s's chain, the held-out group's coordinates are REDRAWN from
        their priors ``n_z`` times per retained draw (the held-out
        block's own z never touches the likelihood, so only the
        (mu, tau) marginal has to mix — the fresh-z redraw then gives a
        strictly lower-variance estimator than the chain's prior-
        distributed z).  Exact refits, no PSIS approximation.  Closed-
        form conjugate anchor (y_s | y_{-s} is multivariate normal in
        the tau-pinned hierarchy) pinned in tests/test_hierarchical.py.

        Requires a complete prior (``local_priors`` for every non-pooled
        name): a held-out group's flat local would make its refit
        posterior improper AND leave the predictive nothing to draw
        from.
        """
        if not self._complete_prior:
            raise ValueError(
                "logo: non-pooled locals without local_priors make the "
                "held-out group's refit posterior improper and give the "
                "new-group predictive nothing to draw from — declare "
                "local_priors for every non-pooled name")
        from .fit import history_block_columns

        data = self._posterior_data()["ds"]
        mask_np = np.asarray(data.mask, np.float64)
        S = self.n_datasets
        N = mask_np.shape[1]
        real_pos = np.where(mask_np.reshape(-1) > 0.0)[0]
        ds_of_real = real_pos // N
        holdouts = [ds_of_real != s for s in range(S)]
        fit, _ = self._refit_cv("logo", holdouts, n_steps, temperature,
                                walkers_per_dataset, burn_fraction,
                                max_samples, seed)
        from .diagnostics import grouped_refit_health

        refit_ok = grouped_refit_health(fit, "logo")

        pos, _ = fit._history(None)                       # (T, S*B, d)
        pos = np.asarray(pos, np.float64)
        cols = history_block_columns(fit, pos.shape[1])
        dp = len(self.pooled)
        dl = self.local_spec.ndim
        pooled_cols = np.asarray(self._pooled_cols)
        np_cols = np.asarray(
            [j for j in range(dl) if j not in set(pooled_cols.tolist())],
            dtype=int)
        rng = np.random.default_rng(seed + 1)
        elpd = np.empty(S)
        for s in range(S):
            block = pos[:, cols[s], :].reshape(-1, self.spec.ndim)
            idx = np.unique(np.linspace(
                0, block.shape[0] - 1,
                min(max_samples, block.shape[0])).astype(int))
            draws = np.repeat(block[idx], n_z, axis=0)    # (n*n_z, d)
            lo = self._n_hyper + s * dl
            draws[:, lo + pooled_cols] = rng.standard_normal(
                (draws.shape[0], dp))
            for j in np_cols:
                k = self.local_spec.keys[j]
                draws[:, lo + j] = np.asarray(
                    self._local_dists[k].sample(rng, draws.shape[0]))
            ll = self._pointwise_ll(jnp.asarray(draws, self.dtype))
            joint = ll[:, ds_of_real == s].sum(axis=1)    # log p(y_s|th)
            m = joint.max()
            if not np.isfinite(m):
                # Every mixed-predictive draw underflowed (an extreme
                # alien group): the log-mean-exp is -inf, not NaN —
                # keep the "population cannot describe this group"
                # signal instead of silently corrupting elpd/se
                # (advisor finding, round 4).
                elpd[s] = -np.inf
                continue
            elpd[s] = m + np.log(np.mean(np.exp(joint - m)))
        # SE over the FINITE groups only: an all-underflow group sets
        # its elpd to -inf (the intended signal) and np.var over an
        # array containing -inf is NaN — which would corrupt the very
        # headline the guard above protects (review finding r5).  The
        # -inf still dominates elpd.sum(); per-group values stay
        # readable in elpd_per_dataset.
        fin = elpd[np.isfinite(elpd)]
        se = float(np.sqrt(fin.size * np.var(fin, ddof=1))) \
            if fin.size > 1 else 0.0
        return LOGOResult(elpd=float(elpd.sum()), se=se,
                          elpd_per_dataset=elpd, refit_ok=refit_ok)

    def expressions_per_dataset(self, expr: str) -> list[float]:
        """Evaluate a derived-quantity expression at each dataset's
        decoded best-fit params (the hierarchical counterpart of
        ``walker-set-get-f``, nv-specific.lisp:87)."""
        from .expressions import eval_expression

        return [eval_expression(expr, p)
                for p in self.params_per_dataset("best")]
