"""Batched nested sampling: evidence + posterior from one run.

The fourth evidence estimator (ladder stepping-stone, SMC, Laplace,
and now nested sampling — `examples/modern_workflow.py` triangulates
the first three; this one has *independent* failure modes: no
temperature ladder to tune, no anneal schedule, and its error estimate
``sqrt(H/n_live)`` comes from information theory, not Monte-Carlo
batching).  New capability beyond the reference, which has no model
comparison at all.

Accelerator-first shape of the classic algorithm (Skilling 2006):

- the live set is a fixed ``(n_live, d)`` array — static shapes, one
  device-resident state;
- instead of deleting one point per iteration (serial, the classic
  bottleneck), each round deletes the worst ``k_batch`` points AT ONCE
  and refills them in parallel.  The prior-volume bookkeeping stays
  exact: dead points are processed in likelihood order, the j-th
  deletion overall shrinking ``log X`` by ``1/n_live`` — batching
  changes the schedule of hardware work, not the statistics, because
  every refill samples above the batch's HIGHEST deleted likelihood
  (the surviving set's minimum), which is a valid constrained-prior
  draw for every slot it fills;
- refills evolve clones of random survivors with ``n_repeat``
  hard-constrained differential-evolution moves (ter Braak pair
  differences from the live set — affine-invariant, so the proposal
  geometry tracks the constrained region as it shrinks without any
  covariance estimation; the same trick as ``kernel="demc"``), all
  ``k_batch`` chains advancing in one jitted ``lax.scan``;
- the outer loop is a host loop over jitted rounds, exactly the
  chunk-driver split used everywhere else in this framework.

Convention matches :func:`~lisp_mcmc_tpu.evidence.log_evidence` and
``smc_sample``: the walker's log-posterior plays the likelihood, the
implied uniform-in-bounds prior supplies the measure, and ``log_z``
estimates ``log[(∫_box L dθ) / V]`` — directly comparable across all
four estimators.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

__all__ = ["NestedResult", "nested_sample", "nested_per_dataset"]


@dataclasses.dataclass(frozen=True)
class NestedResult:
    """Nested-sampling run summary.

    ``log_z`` the evidence (uniform-in-bounds convention),
    ``log_z_err`` the information-based ``sqrt(H/n_live)`` standard
    error, ``h`` the information (nats of prior-to-posterior
    compression), ``samples``/``log_weights`` the dead points with
    their (unnormalized log) posterior weights, ``ess`` the
    Kish effective sample size of those weights, ``n_iter`` the number
    of deletion rounds, ``logl_max`` the best likelihood seen.
    ``insertion_p``: KS uniformity p of the refill insertion ranks
    (Fowlie et al. 2020) — low means the constrained walks are
    directionally biased within the shell and ``log_z`` is suspect;
    note it is blind to pure clone-correlation (a barely-moved clone
    keeps a uniform rank), which the ``n_repeat`` default guards
    instead.
    """

    log_z: float
    log_z_err: float
    h: float
    samples: np.ndarray       # (n_dead, d)
    log_weights: np.ndarray   # (n_dead,) unnormalized log posterior mass
    logl: np.ndarray          # (n_dead,)
    ess: float
    n_iter: int
    logl_max: float
    insertion_p: float        # uniformity p of refill insertion ranks

    def posterior_draws(self, n: int = 1000, seed: int = 0) -> np.ndarray:
        """Equal-weight posterior draws by weighted resampling."""
        w = np.exp(self.log_weights - self.log_weights.max())
        w = w / w.sum()
        idx = np.random.default_rng(seed).choice(
            len(w), size=n, replace=True, p=w)
        return self.samples[idx]

    def __repr__(self):
        return (f"NestedResult(log_z={self.log_z:.4f} +- "
                f"{self.log_z_err:.4f}, h={self.h:.2f} nats, "
                f"n_iter={self.n_iter}, ess={self.ess:.0f}, "
                f"insertion_p={self.insertion_p:.3g})")


def _logsumexp(a):
    m = np.max(a)
    if not np.isfinite(m):
        return m
    return float(m + np.log(np.sum(np.exp(a - m))))


def _nested_budget(n_live, k_batch, n_repeat, d, caller="nested_sample"):
    """Shared validation + defaults for the deletion/refill budget.

    ``caller`` prefixes the errors (nested_per_dataset shares this
    validation; a "nested_sample:" message would misdirect its users).
    """
    if k_batch is None:
        k_batch = max(1, n_live // 4)
    if not 1 <= k_batch <= n_live // 2:
        raise ValueError(f"{caller}: need 1 <= k_batch <= n_live/2 "
                         "(refills draw donors from survivors)")
    if n_live - k_batch <= d + 1:
        raise ValueError(
            f"{caller}: {n_live - k_batch} surviving donors span "
            f"at most a {n_live - k_batch - 1}-dim affine subspace of "
            f"the {d}-dim prior — raise n_live or lower k_batch")
    if n_repeat is None:
        # Decorrelation budget per refill.  Measured on the two-peak
        # spectrum fit (d=6, h~40 nats): 2d+16=28 repeats left a -0.7
        # clone-correlation bias with seed scatter 0.38 vs quoted error
        # 0.20; 8d+16=64 repeats removed it (mean within SMC's estimate,
        # scatter 0.26).  Evidence quality is the point of this module,
        # so the default buys the repeats — they are vectorized over
        # k_batch chains and cost seconds.
        n_repeat = 8 * d + 16
    return k_batch, n_repeat


def _accumulate_round(log_z, h, log_x_cur, dead_lp_np, delta):
    """One round of Skilling's recurrences (exact order-statistic
    shrinkage — see the harmonic-number comment in nested_sample).

    Returns ``(log_z, h, log_x_cur, logw)`` for the round's dead points
    (``dead_lp_np`` ascending in likelihood).
    """
    log_x_hi = log_x_cur - delta[:-1]              # X_(j-1)
    log_x_lo = log_x_cur - delta[1:]               # X_(j)
    log_dx = log_x_hi + np.log1p(-np.exp(log_x_lo - log_x_hi))
    logw = log_dx + dead_lp_np
    log_z_new = _logsumexp([log_z, _logsumexp(logw)])
    if np.isfinite(log_z_new) and log_z_new > -1e290:
        terms = np.exp(logw - log_z_new) * dead_lp_np
        h = (math.exp(log_z - log_z_new) * (h + log_z)
             + float(terms.sum())) - log_z_new if np.isfinite(log_z) \
            else float(terms.sum()) - log_z_new
    return log_z_new, h, log_x_cur - float(delta[-1]), logw


def _close_live(log_z, h, log_x_cur, live_lp_np, n_live):
    """Fold the surviving live set into the estimate: each survivor gets
    ``X_final / n_live``.  Returns ``(log_z, h, logw_live)``."""
    logw_live = log_x_cur - math.log(n_live) + live_lp_np
    log_z_new = _logsumexp([log_z, _logsumexp(logw_live)])
    terms = np.exp(logw_live - log_z_new) * live_lp_np
    h = (math.exp(log_z - log_z_new) * (h + log_z)
         + float(terms.sum())) - log_z_new
    return log_z_new, max(h, 0.0), logw_live


def _insertion_pvalue(ins, n_live, k_batch):
    """KS uniformity p of refill insertion ranks (Fowlie et al. 2020).

    Ranks live on {0..n_live-k_batch}; map to (0,1) with a half-offset.
    """
    from scipy.stats import kstest

    ins = np.asarray(ins, np.float64)
    if ins.size < 20:
        return float("nan")
    return float(kstest(
        (ins + 0.5) / (n_live - k_batch + 1.0), "uniform").pvalue)


def _adapt_scale(scale, acc, lo=0.15, hi=0.7, cap=10.0):
    """DE-walk step-scale steering toward ~50% constrained acceptance."""
    if acc < lo:
        return scale * 0.7
    if acc > hi:
        return min(scale * 1.3, cap)
    return scale


def nested_sample(
    walker,
    bounds=None,
    n_live: int = 1024,
    k_batch: int | None = None,
    n_repeat: int | None = None,
    stop_frac: float = 1e-4,
    max_iter: int = 10_000,
    seed: int = 0,
    prior=None,
    on_round=None,
) -> NestedResult:
    """Run batched nested sampling on the walker's posterior.

    ``bounds``: box prior table; ``prior``: a
    :class:`~lisp_mcmc_tpu.priors.PriorSpec` for named (Gaussian /
    log-normal / truncated) priors — the run then happens in the
    unit-cube parameterization (the classic nested-sampling prior
    transform: ``theta = F^-1(u)``, live set uniform in u), the
    constrained walks move in u, and ``log_z`` is the true evidence
    ``integral L * pi`` under the shared framework convention
    (priors.py).  Either may be omitted when the fitted terms carry a
    recoverable prior recipe (``make_bounds_prior`` / ``PriorSpec``).
    ``samples`` are always returned in PHYSICAL parameter space.
    ``k_batch`` points (default ``n_live // 4``) are deleted and
    refilled per round; ``n_repeat`` constrained DE moves (default
    ``2 d + 16``) decorrelate each refill from its parent clone.
    Stops when the live set's maximum remaining contribution
    ``max L_live * X`` drops below ``stop_frac`` of the accumulated
    evidence.  The walker's ensemble state is untouched — nested
    sampling runs on its own live set.  ``on_round(info)``: per-round
    observability hook with ``{"round", "log_x", "log_z_partial",
    "acceptance", "scale", "logl_max_live"}``; returning True closes
    the run early with the live set (a valid, less converged estimate).

    Validated against: analytic Gaussian evidences, equal/unequal-mass
    bimodal mass splits, and the other three estimators on the same
    fit (tests/test_nested.py; Gaussian-prior conjugate anchor in
    tests/test_prior_spec.py).
    """
    import jax
    import jax.numpy as jnp
    from jax import lax

    if getattr(walker, "aux", None) is not None:
        raise ValueError("nested_sample: batched/grouped fits run one "
                         "live set per dataset — use nested_per_dataset "
                         "(one vmapped device program for all S runs)")
    from .priors import resolve_prior_spec

    spec = resolve_prior_spec(walker, prior, bounds)
    if spec is None:
        raise ValueError("nested_sample: pass bounds= or prior= (no "
                         "prior recipe found on the fitted terms)")
    keys = walker.spec.keys
    missing = [k for k in keys if k not in spec]
    if missing:
        raise ValueError(f"nested_sample: prior/bounds missing {missing}")
    d = len(keys)
    k_batch, n_repeat = _nested_budget(n_live, k_batch, n_repeat, d)

    dtype = walker.dtype
    data = walker._posterior_data()
    if spec.is_uniform:
        box = spec.bounds
        lo = np.asarray([box[k][0] for k in keys], np.float64)
        hi = np.asarray([box[k][1] for k in keys], np.float64)
        log_post_one = walker._log_post_one
        to_theta = None
    else:
        # Named prior: the classic prior transform.  The run lives in
        # u-space (live set + walks uniform under the prior measure);
        # the u-posterior is logpost(F^-1(u)) - installed + wall, i.e.
        # the pure likelihood against the prior (see priors.py).
        from .priors import unit_cube_wall

        lo = np.zeros(d)
        hi = np.ones(d)
        base = walker._log_post_one

        def log_post_one(u, data):
            th = spec.transform(u, keys)
            return base(th, data) - spec.installed_vec(th, keys) \
                + unit_cube_wall(u)

        to_theta = jax.jit(jax.vmap(lambda u: spec.transform(u, keys)))
    loglike = jax.jit(jax.vmap(log_post_one, in_axes=(0, None)))

    from .kernel import _neg_floor

    rng = np.random.default_rng(seed)
    # dtype-aware: -1e300 literal overflows on cast to float32 (the
    # device default), spraying RuntimeWarnings on every trace.
    neg_floor = _neg_floor(dtype)
    live = jnp.asarray(rng.uniform(lo, hi, size=(n_live, d)), dtype)
    # Same NaN floor as the refill moves: a NaN here (e.g. a Poisson
    # model going negative somewhere in the box) sorts as the BEST live
    # point forever — never deleted, termination never fires, and the
    # run burns max_iter rounds to return log_z = NaN.
    live_lp = loglike(live, data)
    live_lp = jnp.where(jnp.isfinite(live_lp), live_lp, neg_floor)

    gamma0 = 2.38 / math.sqrt(2.0 * d)

    def refill_round(live, live_lp, key, scale, data):
        """Delete the k_batch worst, refill by constrained DE walks.

        Returns (new_live, new_live_lp, dead_pos, dead_lp, accept_rate)
        with dead points sorted ascending in likelihood.
        """
        order = jnp.argsort(live_lp)
        dead_idx = order[:k_batch]
        dead_pos = live[dead_idx]
        dead_lp = live_lp[dead_idx]
        # Constraint = the HIGHEST deleted likelihood L_(K): survivors
        # conditioned on the order statistics are uniform in
        # {L > L_(K)}, and refills drawn there keep the whole live set
        # uniform in that region (volume X_(K)).  Using the surviving
        # minimum L_(K+1) instead over-constrains refills and biases Z
        # (measured +0.65 on the analytic Gaussian before this fix).
        lmin = live_lp[order[k_batch - 1]]

        k_clone, k_scan = jax.random.split(key)
        # Clone random survivors into the dead slots.
        surv_idx = order[k_batch:]
        clone_pick = jax.random.randint(k_clone, (k_batch,), 0,
                                        n_live - k_batch)
        pos0 = live[surv_idx[clone_pick]]
        lp0 = live_lp[surv_idx[clone_pick]]

        live_surv = live[surv_idx]              # (n_live-k, d) donors

        def one_move(carry, k):
            pos, lp, acc = carry
            kj, kg, ku = jax.random.split(k, 3)
            j = jax.random.randint(kj, (k_batch, 2), 0,
                                   jnp.asarray([n_live - k_batch,
                                                n_live - k_batch - 1]))
            j1 = j[:, 0]
            j2 = (j1 + 1 + j[:, 1]) % (n_live - k_batch)
            diff = live_surv[j1] - live_surv[j2]
            u = jax.random.uniform(kg, (k_batch,), dtype, 0.5, 1.5)
            prop = pos + (scale * gamma0) * u[:, None] * diff
            lp_prop = loglike(prop, data)
            lp_prop = jnp.where(jnp.isfinite(lp_prop), lp_prop, neg_floor)
            ok = lp_prop > lmin                  # hard NS constraint
            pos = jnp.where(ok[:, None], prop, pos)
            lp = jnp.where(ok, lp_prop, lp)
            return (pos, lp, acc + jnp.mean(ok.astype(dtype))), None

        keys_scan = jax.random.split(k_scan, n_repeat)
        (pos, lp, acc), _ = lax.scan(one_move, (pos0, lp0,
                                                jnp.zeros((), dtype)),
                                     keys_scan)
        new_live = live.at[dead_idx].set(pos)
        new_lp = live_lp.at[dead_idx].set(lp)
        # Insertion indices (Fowlie, Handley & Su 2020): a refill drawn
        # correctly from the constrained prior has a likelihood rank
        # uniform among the survivors'.  A LOW p flags a directionally
        # biased refill walk (systematically high/low in the shell).
        # Measured blind spot: pure clone-correlation (n_repeat too
        # small) passes this test — a barely-moved clone inherits its
        # parent's survivor-uniform rank — so a healthy insertion_p
        # does NOT certify decorrelation; the n_repeat default carries
        # that burden (see its comment).
        surv_lp = live_lp[surv_idx]
        ins = jnp.sum(surv_lp[None, :] < lp[:, None], axis=1)
        return new_live, new_lp, dead_pos, dead_lp, acc / n_repeat, ins

    # Datasets pass through jit as ARGUMENTS, never closure constants
    # (CLAUDE.md invariant: compile-once-per-shape + persistent-cache
    # behavior depends on it).
    refill = jax.jit(refill_round)

    # Host-side accumulation (Skilling's recurrences, per dead point).
    # Exact order-statistic shrinkage: the j-th worst of n_live uniform
    # volumes sits at E[ln X_(j)] = -(H_n - H_{n-j}) (harmonic-number
    # difference), and a K-deletion round contracts the live region to
    # X_(K).  The linear -j/n approximation is only valid for j << n;
    # at the default k_batch = n/4 it under-shrinks every round by
    # (ln(4/3) - 1/4) ~ 0.038 nats, which measured a +0.65 evidence
    # bias on the analytic Gaussian (claimed error 0.09) before this
    # used the exact form.
    harmonic = np.concatenate(
        [[0.0], np.cumsum(1.0 / np.arange(1, n_live + 1))])
    delta = harmonic[n_live] - harmonic[n_live - np.arange(k_batch + 1)]
    # delta[j] = E[-ln(X_(j)/X_round_start)], delta[0] = 0.
    dead_pos_all, dead_lp_all, logw_all, insertion_all = [], [], [], []
    log_z = -np.inf
    h = 0.0
    log_x_cur = 0.0
    scale = 1.0
    key = jax.random.PRNGKey(seed)
    n_iter = 0
    for n_iter in range(1, max_iter + 1):
        key, sub = jax.random.split(key)
        live, live_lp, dead_pos, dead_lp, acc, ins = refill(
            live, live_lp, sub, jnp.asarray(scale, dtype), data)
        insertion_all.append(np.asarray(ins, np.int64))
        dead_lp_np = np.asarray(dead_lp, np.float64)   # ascending
        # Information/evidence updates (Skilling's recurrences).
        log_z, h, log_x_cur, logw = _accumulate_round(
            log_z, h, log_x_cur, dead_lp_np, delta)
        dead_pos_all.append(np.asarray(dead_pos, np.float64))
        dead_lp_all.append(dead_lp_np)
        logw_all.append(logw)

        # Adapt the DE scale toward ~50% constrained acceptance.
        acc_f = float(acc)
        scale = _adapt_scale(scale, acc_f)

        # Termination: remaining max contribution vs accumulated Z.
        logl_max_live = float(jnp.max(live_lp))
        if on_round is not None and on_round({
                "round": n_iter, "log_x": log_x_cur,
                "log_z_partial": float(log_z), "acceptance": acc_f,
                "scale": scale, "logl_max_live": logl_max_live}):
            # Observability hook requested an early close: unlike SMC's
            # ladder, a truncated nested run closed with its live set is
            # still a VALID (just less converged) estimate.
            break
        if logl_max_live + log_x_cur < log_z + math.log(stop_frac):
            break

    # Close with the live set: each survivor gets X_final / n_live.
    live_np = np.asarray(live, np.float64)
    live_lp_np = np.asarray(live_lp, np.float64)
    log_z, h, logw_live = _close_live(log_z, h, log_x_cur, live_lp_np,
                                      n_live)
    order = np.argsort(live_lp_np)
    dead_pos_all.append(live_np[order])
    dead_lp_all.append(live_lp_np[order])
    logw_all.append(logw_live[order])

    samples = np.concatenate(dead_pos_all)
    if to_theta is not None:
        # Dead points were collected in u-space; report physical params.
        samples = np.asarray(to_theta(jnp.asarray(samples, dtype)),
                             np.float64)
    logl = np.concatenate(dead_lp_all)
    logw = np.concatenate(logw_all)
    wn = np.exp(logw - logw.max())
    ess = float(wn.sum() ** 2 / np.sum(wn ** 2))

    insertion_p = _insertion_pvalue(np.concatenate(insertion_all),
                                    n_live, k_batch)
    # The log_z above integrates L over normalized prior volume X; the
    # framework convention already divides by V because X IS the
    # normalized box measure — nothing further to subtract.
    return NestedResult(
        log_z=float(log_z), log_z_err=float(math.sqrt(h / n_live)),
        h=float(h), samples=samples, log_weights=logw, logl=logl,
        ess=ess, n_iter=n_iter, logl_max=float(np.max(logl)),
        insertion_p=insertion_p,
    )


def nested_per_dataset(
    fit,
    bounds=None,
    n_live: int = 512,
    k_batch: int | None = None,
    n_repeat: int | None = None,
    stop_frac: float = 1e-4,
    max_iter: int = 10_000,
    seed: int = 0,
    prior=None,
    on_round=None,
) -> list[NestedResult]:
    """S independent nested-sampling runs as ONE vmapped device program.

    The batched counterpart of :func:`nested_sample` for grouped fits
    (:class:`~lisp_mcmc_tpu.BatchedFit` scan grids): every dataset gets
    its own ``(n_live, d)`` live set, stacked into one ``(S, n_live, d)``
    state, and each round's delete/refill runs for ALL datasets in a
    single jitted ``vmap`` — S evidences + posteriors for the price of
    the slowest run's wall time, not their sum (the reference's walker
    lists pay k full fits, nv-specific.lisp:58-66).  Completes the
    per-dataset estimator toolchain (``laplace/advi/flow_advi
    _per_dataset``, SMC's ``log_z_per_group``) with the one estimator
    whose error bar is information-theoretic rather than Monte-Carlo.

    Semantics per dataset are EXACTLY :func:`nested_sample`'s: same
    constrained-DE refills, same exact harmonic-number shrinkage, same
    per-dataset step-scale steering and insertion-rank diagnostics.
    Each dataset terminates on its OWN ``stop_frac`` criterion — its
    live set is snapshotted at that round and its estimate closed there,
    while the shared device program keeps evolving stragglers (finished
    blocks ride along as wasted lanes; with same-shape spectra the
    straggler spread is small).  ``prior``/``bounds`` follow the shared
    resolution rules (one prior for the batch, like the fit itself).

    ``on_round(info)`` sees per-round arrays (``log_z_partial``,
    ``acceptance``, ``done`` each ``(S,)``); returning True closes every
    unfinished run early with its current live set.

    Returns ``list[NestedResult]`` of length S, comparable element-wise
    with ``laplace_per_dataset`` / ``smc_sample().log_z_per_group``.
    """
    import jax
    import jax.numpy as jnp
    from jax import lax

    if getattr(fit, "aux", None) is None \
            or getattr(fit, "n_groups", 1) in (None, 1):
        raise ValueError("nested_per_dataset: needs a grouped/batched fit "
                         "(plain fits use nested_sample)")
    S = int(fit.n_groups)
    from .priors import resolve_prior_spec

    spec = resolve_prior_spec(fit, prior, bounds)
    if spec is None:
        raise ValueError("nested_per_dataset: pass bounds= or prior= (no "
                         "prior recipe found on the fitted terms)")
    keys = fit.spec.keys
    missing = [k for k in keys if k not in spec]
    if missing:
        raise ValueError(f"nested_per_dataset: prior/bounds missing {missing}")
    d = len(keys)
    k_batch, n_repeat = _nested_budget(n_live, k_batch, n_repeat, d,
                                      caller="nested_per_dataset")

    dtype = fit.dtype
    data = fit._posterior_data()
    base = fit._log_post_one          # grouped signature: (theta, s, data)
    if spec.is_uniform:
        box = spec.bounds
        lo = np.asarray([box[k][0] for k in keys], np.float64)
        hi = np.asarray([box[k][1] for k in keys], np.float64)
        log_post_one = base
        to_theta = None
    else:
        # Named prior: the classic prior transform, per dataset (the
        # transform itself is dataset-independent; only the likelihood
        # reads s).  Convention identical to nested_sample's u-space.
        from .priors import unit_cube_wall

        lo = np.zeros(d)
        hi = np.ones(d)

        def log_post_one(u, s, data):
            th = spec.transform(u, keys)
            return base(th, s, data) - spec.installed_vec(th, keys) \
                + unit_cube_wall(u)

        to_theta = jax.jit(jax.vmap(lambda u: spec.transform(u, keys)))

    from .kernel import _neg_floor

    rng = np.random.default_rng(seed)
    neg_floor = _neg_floor(dtype)
    live = jnp.asarray(rng.uniform(lo, hi, size=(S, n_live, d)), dtype)
    gidx = jnp.arange(S, dtype=fit.aux.dtype)
    loglike_all = jax.jit(jax.vmap(
        jax.vmap(log_post_one, in_axes=(0, None, None)),
        in_axes=(0, 0, None)))
    live_lp = loglike_all(live, gidx, data)
    live_lp = jnp.where(jnp.isfinite(live_lp), live_lp, neg_floor)

    gamma0 = 2.38 / math.sqrt(2.0 * d)
    loglike_k = jax.vmap(log_post_one, in_axes=(0, None, None))

    def refill_round(live, live_lp, key, scale, s, data):
        """One dataset's delete/refill — the body of nested_sample's
        round with the dataset index threaded to the likelihood; the
        caller vmaps it over the leading S axis."""
        order = jnp.argsort(live_lp)
        dead_idx = order[:k_batch]
        dead_pos = live[dead_idx]
        dead_lp = live_lp[dead_idx]
        lmin = live_lp[order[k_batch - 1]]   # constraint: highest deleted L

        k_clone, k_scan = jax.random.split(key)
        surv_idx = order[k_batch:]
        clone_pick = jax.random.randint(k_clone, (k_batch,), 0,
                                        n_live - k_batch)
        pos0 = live[surv_idx[clone_pick]]
        lp0 = live_lp[surv_idx[clone_pick]]
        live_surv = live[surv_idx]

        def one_move(carry, k):
            pos, lp, acc = carry
            kj, kg, ku = jax.random.split(k, 3)
            j = jax.random.randint(kj, (k_batch, 2), 0,
                                   jnp.asarray([n_live - k_batch,
                                                n_live - k_batch - 1]))
            j1 = j[:, 0]
            j2 = (j1 + 1 + j[:, 1]) % (n_live - k_batch)
            diff = live_surv[j1] - live_surv[j2]
            u = jax.random.uniform(kg, (k_batch,), dtype, 0.5, 1.5)
            prop = pos + (scale * gamma0) * u[:, None] * diff
            lp_prop = loglike_k(prop, s, data)
            lp_prop = jnp.where(jnp.isfinite(lp_prop), lp_prop, neg_floor)
            ok = lp_prop > lmin
            pos = jnp.where(ok[:, None], prop, pos)
            lp = jnp.where(ok, lp_prop, lp)
            return (pos, lp, acc + jnp.mean(ok.astype(dtype))), None

        keys_scan = jax.random.split(k_scan, n_repeat)
        (pos, lp, acc), _ = lax.scan(one_move, (pos0, lp0,
                                                jnp.zeros((), dtype)),
                                     keys_scan)
        new_live = live.at[dead_idx].set(pos)
        new_lp = live_lp.at[dead_idx].set(lp)
        surv_lp = live_lp[surv_idx]
        ins = jnp.sum(surv_lp[None, :] < lp[:, None], axis=1)
        return new_live, new_lp, dead_pos, dead_lp, acc / n_repeat, ins

    # One compiled program advances all S runs (datasets stay ARGUMENTS,
    # per the repo-wide compile-cache contract).
    refill = jax.jit(jax.vmap(refill_round,
                              in_axes=(0, 0, 0, 0, 0, None)))

    harmonic = np.concatenate(
        [[0.0], np.cumsum(1.0 / np.arange(1, n_live + 1))])
    delta = harmonic[n_live] - harmonic[n_live - np.arange(k_batch + 1)]

    dead_pos_all = [[] for _ in range(S)]
    dead_lp_all = [[] for _ in range(S)]
    logw_all = [[] for _ in range(S)]
    insertion_all = [[] for _ in range(S)]
    log_z = np.full(S, -np.inf)
    h = np.zeros(S)
    log_x_cur = np.zeros(S)
    scale = np.ones(S)
    done = np.zeros(S, bool)
    n_iter_s = np.zeros(S, np.int64)
    live_final = [None] * S
    live_lp_final = [None] * S
    key = jax.random.PRNGKey(seed)
    for n_iter in range(1, max_iter + 1):
        key, sub = jax.random.split(key)
        subs = jax.random.split(sub, S)
        live, live_lp, dead_pos, dead_lp, acc, ins = refill(
            live, live_lp, subs, jnp.asarray(scale, dtype), gidx, data)
        dead_lp_np = np.asarray(dead_lp, np.float64)   # (S, k) ascending
        dead_pos_np = np.asarray(dead_pos, np.float64)
        acc_np = np.asarray(acc, np.float64)
        ins_np = np.asarray(ins, np.int64)
        live_lp_np = None
        for s in range(S):
            if done[s]:
                continue
            insertion_all[s].append(ins_np[s])
            log_z[s], h[s], log_x_cur[s], logw = _accumulate_round(
                log_z[s], h[s], log_x_cur[s], dead_lp_np[s], delta)
            dead_pos_all[s].append(dead_pos_np[s])
            dead_lp_all[s].append(dead_lp_np[s])
            logw_all[s].append(logw)
            n_iter_s[s] = n_iter
            scale[s] = _adapt_scale(scale[s], float(acc_np[s]))
            if live_lp_np is None:
                live_lp_np = np.asarray(live_lp, np.float64)
            if (live_lp_np[s].max() + log_x_cur[s]
                    < log_z[s] + math.log(stop_frac)):
                # This dataset's run is over: close it with TODAY's live
                # set (the shared program keeps evolving the block, but
                # those later moves belong to a deeper shell than this
                # estimate's bookkeeping).
                done[s] = True
                live_final[s] = np.asarray(live[s], np.float64)
                live_lp_final[s] = live_lp_np[s].copy()
        stop_all = False
        if on_round is not None and on_round({
                "round": n_iter, "log_x": log_x_cur.copy(),
                "log_z_partial": log_z.copy(), "acceptance": acc_np,
                "scale": scale.copy(), "done": done.copy()}):
            stop_all = True
        if done.all() or stop_all:
            break

    live_np_all = np.asarray(live, np.float64)
    live_lp_np_all = np.asarray(live_lp, np.float64)
    results = []
    for s in range(S):
        if live_final[s] is None:     # max_iter / early close: current set
            live_final[s] = live_np_all[s]
            live_lp_final[s] = live_lp_np_all[s]
        lz, hh, logw_live = _close_live(log_z[s], h[s], log_x_cur[s],
                                        live_lp_final[s], n_live)
        order = np.argsort(live_lp_final[s])
        dead_pos_all[s].append(live_final[s][order])
        dead_lp_all[s].append(live_lp_final[s][order])
        logw_all[s].append(logw_live[order])

        samples = np.concatenate(dead_pos_all[s])
        if to_theta is not None:
            samples = np.asarray(to_theta(jnp.asarray(samples, dtype)),
                                 np.float64)
        logl = np.concatenate(dead_lp_all[s])
        logw = np.concatenate(logw_all[s])
        wn = np.exp(logw - logw.max())
        ess = float(wn.sum() ** 2 / np.sum(wn ** 2))
        results.append(NestedResult(
            log_z=float(lz), log_z_err=float(math.sqrt(hh / n_live)),
            h=float(hh), samples=samples, log_weights=logw, logl=logl,
            ess=ess, n_iter=int(n_iter_s[s]), logl_max=float(np.max(logl)),
            insertion_p=_insertion_pvalue(
                np.concatenate(insertion_all[s]), n_live, k_batch),
        ))
    return results
