"""Run diagnostics: metrics dict, convergence summary, failure detectors.

Rebuilds the reference's observability surface (SURVEY §5): the
``walker-get`` metric verbs (acceptance 506, likelihood trace 540,
stddev-params 525, covariance 541) become a structured per-run metrics
dict, extended with the ensemble statistics the single-chain reference
could not have (ESS, split R-hat across walkers) — the rebuild's primary
metric pair is chain-steps/sec and ESS/sec (BASELINE.md).
"""

from __future__ import annotations

from typing import Any

import jax.numpy as jnp
import numpy as np

from .ops.reductions import (effective_sample_size, mcse_mean,
                             rank_normalized_rhat, split_rhat, tail_ess)

__all__ = ["metrics", "ess_per_param", "ess_from_history", "rhat_per_param",
           "rhat_from_history", "rank_rhat_per_param", "tail_ess_per_param",
           "mcse_per_param", "convergence", "convergence_per_dataset",
           "summary", "trace_profile",
           "WAICResult", "waic", "waic_compare",
           "LOOResult", "loo", "loo_compare", "reloo",
           "KFoldResult", "kfold", "model_weights", "evidence_weights",
           "LOOPITResult", "loo_pit",
           "PriorSensitivityResult", "prior_sensitivity",
           "AuditResult", "audit"]


def trace_profile(log_dir: str = "/tmp/lisp_mcmc_tpu_trace"):
    """Context manager: capture a ``jax.profiler`` trace of a fit.

    The rebuild's tracing subsystem (SURVEY §5: the reference had only ad
    hoc ``time`` forms in comment blocks, mcmc-fitting.lisp:59-63).  View
    the result with TensorBoard or Perfetto::

        with trace_profile("/tmp/fit_trace"):
            walker.adaptive_steps(30000)
    """
    import jax

    return jax.profiler.trace(log_dir)


def _history_blocks(walker, take):
    """Yield per-population (T, B, d) history blocks.

    A plain walker is one population.  Grouped/batched fits hold S
    independent posteriors side by side in one ensemble — pooling their
    walkers would compare chains that target DIFFERENT distributions
    (R-hat reads huge, ESS nonsense), so every walker-level diagnostic
    iterates the dataset blocks and reports the worst case (converged
    means every dataset converged).
    """
    from .fit import history_block_columns

    pos, _ = walker._history(take)
    pos = jnp.asarray(pos)
    cols = history_block_columns(walker, pos.shape[1])
    if len(cols) == 1:
        yield pos
        return
    for c in cols:
        yield pos[:, jnp.asarray(c), :]


def ess_per_param(walker, take: int | None = None) -> dict[str, float]:
    """Effective sample size per parameter (worst dataset for batched
    fits; ESS totals within a population, never across)."""
    out = None
    for block in _history_blocks(walker, take):
        e = ess_from_history(block, walker.spec.keys)
        out = e if out is None else {k: min(out[k], e[k]) for k in e}
    return out or {}


def ess_from_history(positions, keys) -> dict[str, float]:
    """ESS per parameter from a device-resident ``(T, W, d)`` history.

    The whole reduction runs on device; only ``d`` scalars transfer to the
    host (BASELINE.json: "diagnostics reduce on device before host
    transfer" — host round-trips of the raw history dominate otherwise).
    """
    positions = jnp.asarray(positions)
    return {
        k: float(effective_sample_size(positions[:, :, i]))
        for i, k in enumerate(keys)
    }


def rhat_per_param(walker, take: int | None = None) -> dict[str, float]:
    """Split R-hat per parameter (worst dataset for batched fits —
    chains are only comparable within one dataset's population)."""
    out = None
    for block in _history_blocks(walker, take):
        r = rhat_from_history(block, walker.spec.keys)
        out = r if out is None else {k: max(out[k], r[k]) for k in r}
    return out or {}


def rhat_from_history(positions, keys) -> dict[str, float]:
    """Split R-hat per parameter from an already-fetched (T, W, d) history."""
    positions = jnp.asarray(positions)
    return {
        k: float(split_rhat(positions[:, :, i])) for i, k in enumerate(keys)
    }


def rank_rhat_per_param(walker, take: int | None = None) -> dict[str, tuple[float, float]]:
    """(bulk, tail) rank-normalized split R-hat per parameter.

    The Vehtari et al. (2021) convergence standard — strictly stronger
    than :func:`rhat_per_param` (robust to heavy tails; the folded tail
    statistic catches scale-only disagreement).  Pass when
    ``max(bulk, tail) < 1.01``.  Batched fits report the worst dataset.
    """
    out = None
    for pos in _history_blocks(walker, take):
        r = {
            k: tuple(float(v) for v in rank_normalized_rhat(pos[:, :, i]))
            for i, k in enumerate(walker.spec.keys)
        }
        out = r if out is None else {
            k: (max(out[k][0], r[k][0]), max(out[k][1], r[k][1])) for k in r}
    return out or {}


def tail_ess_per_param(walker, take: int | None = None) -> dict[str, float]:
    """Tail (5%/95% exceedance) effective sample size per parameter.

    Bulk ESS certifies the posterior mean; tail ESS certifies the
    credible-interval endpoints.  Quote interval bounds only when this
    is comfortably above ~100.  Batched fits report the worst dataset.
    """
    out = None
    for pos in _history_blocks(walker, take):
        t = {
            k: float(tail_ess(pos[:, :, i]))
            for i, k in enumerate(walker.spec.keys)
        }
        out = t if out is None else {k: min(out[k], t[k]) for k in t}
    return out or {}


def mcse_per_param(walker, take: int | None = None) -> dict[str, float]:
    """Monte Carlo standard error of each parameter's posterior mean
    (worst dataset for batched fits)."""
    out = None
    for pos in _history_blocks(walker, take):
        m = {
            k: float(mcse_mean(pos[:, :, i]))
            for i, k in enumerate(walker.spec.keys)
        }
        out = m if out is None else {k: max(out[k], m[k]) for k in m}
    return out or {}


def merge_worst_verdict(out: dict[str, Any], v: dict[str, Any],
                        keys) -> None:
    """Fold verdict ``v`` into ``out`` in place, keeping the worst case
    per key (max rank-R-hat, min tail ESS, max MCSE).

    The single source of the worst-case policy — :func:`convergence`
    (block loop) and ``BatchedFit.convergence`` (per-dataset loop) both
    call it, so a policy change cannot silently diverge the two.
    """
    for k in keys:
        if k in out["rank_rhat"]:
            b0, t0 = out["rank_rhat"][k]
            b1, t1 = v["rank_rhat"][k]
            out["rank_rhat"][k] = (max(b0, b1), max(t0, t1))
            out["tail_ess"][k] = min(out["tail_ess"][k], v["tail_ess"][k])
            out["mcse"][k] = max(out["mcse"][k], v["mcse"][k])
        else:
            out["rank_rhat"][k] = v["rank_rhat"][k]
            out["tail_ess"][k] = v["tail_ess"][k]
            out["mcse"][k] = v["mcse"][k]


def _verdict_failures(out, keys, rhat_tol: float, min_tail_ess: float
                      ) -> list[str]:
    """Vehtari-2021 threshold checks on an accumulated verdict dict."""
    failures = []
    for k in keys:
        bulk, tail = out["rank_rhat"][k]
        if max(bulk, tail) >= rhat_tol:
            failures.append(f"{k}: rank R-hat {max(bulk, tail):.4f} "
                            f">= {rhat_tol}")
        if out["tail_ess"][k] < min_tail_ess:
            failures.append(f"{k}: tail ESS {out['tail_ess'][k]:.0f} "
                            f"< {min_tail_ess:.0f}")
    return failures


def _block_verdict(pos, keys, rhat_tol: float, min_tail_ess: float
                   ) -> dict[str, Any]:
    """Vehtari-2021 pass/fail verdict for ONE (T, B, d) history block."""
    out: dict[str, Any] = {"rank_rhat": {}, "tail_ess": {}, "mcse": {}}
    for i, k in enumerate(keys):
        x = pos[:, :, i]
        bulk, tail = (float(v) for v in rank_normalized_rhat(x))
        out["rank_rhat"][k] = (bulk, tail)
        out["tail_ess"][k] = float(tail_ess(x))
        out["mcse"][k] = float(mcse_mean(x))
    failures = _verdict_failures(out, keys, rhat_tol, min_tail_ess)
    out["ok"] = not failures
    out["failures"] = failures
    return out


def convergence(walker, take: int | None = None,
                rhat_tol: float = 1.01, min_tail_ess: float = 100.0
                ) -> dict[str, Any]:
    """One-call convergence report with a pass/fail verdict.

    Applies the Vehtari et al. (2021) criteria per parameter —
    rank-normalized bulk AND tail R-hat below ``rhat_tol``, tail ESS
    above ``min_tail_ess`` — and returns ``{"ok": bool, "failures":
    [...], "rank_rhat": ..., "tail_ess": ..., "mcse": ...}``.  Batched
    fits are judged per dataset block with the worst case reported
    (converged means EVERY dataset converged); each block's statistics
    share one history pass.  For the per-block breakdown use
    :func:`convergence_per_dataset` (or the first-class
    ``BatchedFit.convergence``, which returns both).
    """
    keys = walker.spec.keys
    out: dict[str, Any] = {"rank_rhat": {}, "tail_ess": {}, "mcse": {}}
    failures: list[str] = []
    for pos in _history_blocks(walker, take):
        merge_worst_verdict(
            out, _block_verdict(pos, keys, rhat_tol, min_tail_ess), keys)
    failures.extend(_verdict_failures(out, keys, rhat_tol, min_tail_ess))
    out["ok"] = not failures
    out["failures"] = failures
    return out


def convergence_per_dataset(walker, take: int | None = None,
                            rhat_tol: float = 1.01,
                            min_tail_ess: float = 100.0
                            ) -> list[dict[str, Any]]:
    """Per-dataset-block convergence verdicts for grouped/batched fits.

    One :func:`convergence`-shaped dict per dataset block (a plain fit
    returns a single-element list).  The batched scaling workflow's
    quality gate (nv-specific.lisp:58-66 is the reference's one-at-a-
    time analogue): a scan-grid fit is DONE when every block's ``ok``
    is True — and when one is not, its index says which spectrum to
    rerun rather than restarting the whole grid.
    """
    keys = walker.spec.keys
    return [_block_verdict(pos, keys, rhat_tol, min_tail_ess)
            for pos in _history_blocks(walker, take)]


# Collapse gate for GROUPED REFIT programs (reloo/kfold/logo/SBC).
# Deliberately NOT an R-hat gate: refit blocks warm-start AT the
# parent posterior (the design: "the anneal only repairs the one-point
# dent"), and rank-R-hat measures mixing from DISPERSED starts — a
# healthy warm-started 2500-step/64-walker hierarchical refit measures
# bulk rank-R-hat 1.7-2.6 on the slow hyper coordinates while its tail
# ESS sits at 80-360 and its draws score correctly (measured r5,
# test_hier_refit fixture; plain mala refits measure 1.10-1.22 the
# same way).  What actually distinguishes collapse:
#   - tail ESS < ~20: chains frozen with few walkers (each zero-
#     variance chain counts 1, ops/reductions.py) or mixing truly dead;
#   - move fraction ~ 0: chains frozen with MANY walkers — ESS then
#     reads ~W (one posterior draw each, never adapted to the
#     leave-out dent), so ESS alone would pass it.
# The gate's job is to catch blocks whose "exact" elpd / ranks would
# silently corrupt the result (the WAIC hot-straggler failure mode,
# CLAUDE.md) — not to re-litigate convergence.
REFIT_GATE_MIN_ESS = 20.0
REFIT_GATE_MIN_MOVE = 0.05


def grouped_refit_health(fit, name: str,
                         min_tail_ess: float = REFIT_GATE_MIN_ESS,
                         min_move_frac: float = REFIT_GATE_MIN_MOVE,
                         warn: bool = True) -> np.ndarray:
    """Per-block COLLAPSE gate for a grouped refit ensemble.

    ``fit`` is the grouped Walker that ran K leave-out/simulation
    posteriors as adaptation groups (``_batched_refit`` /
    ``HierarchicalFit._refit_cv`` / ``sbc_check*``); returns a (K,)
    boolean array — block j True when its retained history has tail
    ESS >= ``min_tail_ess`` on every coordinate AND a walker-row move
    fraction >= ``min_move_frac`` (frozen ensembles never repaired the
    leave-out dent; see the threshold rationale above) — and warns
    loudly on failures.  Callers MARK the failing blocks' outputs
    rather than silently merging them (VERDICT r4 #3).
    """
    import warnings

    d = fit.spec.ndim
    ok_list, why = [], []
    for j, pos in enumerate(_history_blocks(fit, None)):
        # Device-side reductions (the CLAUDE.md transfer rule): only
        # scalars reach the host.  Tail ESS per coordinate is the
        # only statistic the gate needs — R-hat is deliberately not
        # computed (see the rationale above).
        pos = jnp.asarray(pos)                         # (T, B, d)
        if pos.shape[0] <= 1:
            # A single retained row (incl. the _history no-rows
            # fallback, fit.py) means the block SAMPLED NOTHING: every
            # chain is trivially zero-variance (ESS reads ~W) and no
            # movement is observable — fail it outright rather than
            # pass the many-frozen-walker case the move check closes.
            ok_list.append(False)
            why.append(f"block {j}: <= 1 retained history row")
            continue
        worst = min(float(tail_ess(pos[:, :, i])) for i in range(d))
        moved = float(jnp.mean(jnp.any(
            jnp.diff(pos, axis=0) != 0.0, axis=-1)))
        block_ok = worst >= min_tail_ess and moved >= min_move_frac
        ok_list.append(block_ok)
        if not block_ok:
            why.append(f"block {j}: min tail ESS {worst:.0f}, "
                       f"move fraction {moved:.3f}")
    ok = np.asarray(ok_list, dtype=bool)
    if warn and not ok.all():
        warnings.warn(
            f"{name}: {int((~ok).sum())}/{ok.size} refit blocks failed "
            f"the collapse gate (tail ESS >= {min_tail_ess} and move "
            f"fraction >= {min_move_frac}): {'; '.join(why)} — their "
            "values are marked unreliable in the result; raise "
            "n_steps / walkers_per_dataset or simplify the held-out "
            "geometry", stacklevel=3)
    return ok


def metrics(walker, take: int | None = None, elapsed_seconds: float | None = None) -> dict[str, Any]:
    """Structured metrics snapshot for logging/observability.

    Includes the reference's per-run quantities (acceptance, best
    log-posterior, stddevs) plus ESS/R-hat and throughput when timing is
    provided.
    """
    from .fit import history_block_columns

    lp_best, best = walker.most_likely_step()
    # ONE history fetch for everything below (_history concatenates the
    # whole retained chunk list per call — gigabytes of traffic on long
    # runs); ESS/R-hat/MCSE compute per dataset block on it (a
    # BatchedFit pools walkers targeting DIFFERENT posteriors), worst
    # case reported.
    pos, lp = walker._history(take)
    pos = jnp.asarray(pos)
    keys = walker.spec.keys
    ess, rhat, mcse = None, None, None
    for cols in history_block_columns(walker, pos.shape[1]):
        blk = pos[:, jnp.asarray(cols), :]
        e = ess_from_history(blk, keys)
        r = rhat_from_history(blk, keys)
        m = {k: float(jnp.sqrt(jnp.var(blk[:, :, i], ddof=1)
                               / max(e[k], 1.0)))
             for i, k in enumerate(keys)}
        ess = e if ess is None else {k: min(ess[k], e[k]) for k in e}
        rhat = r if rhat is None else {k: max(rhat[k], r[k]) for k in r}
        mcse = m if mcse is None else {k: max(mcse[k], m[k]) for k in m}
    ess, rhat, mcse = ess or {}, rhat or {}, mcse or {}
    out = {
        "age": walker.age,
        "n_walkers": walker.n_walkers,
        "acceptance": walker.acceptance(take),
        "best_logprob": lp_best,
        "best_params": best,
        "logprob_quantiles": {
            "p05": float(np.quantile(lp, 0.05)),
            "p50": float(np.quantile(lp, 0.50)),
            "p95": float(np.quantile(lp, 0.95)),
        },
        "ess": ess,
        "min_ess": min(ess.values()) if ess else 0.0,
        "rhat": rhat,
        "mcse": mcse,
    }
    if elapsed_seconds:
        out["chain_steps_per_sec"] = walker.age * walker.n_walkers / elapsed_seconds
        out["ess_per_sec"] = out["min_ess"] / elapsed_seconds
    return out


def summary(walker, take: int | None = None) -> str:
    """Human-readable fit report (the printed walker-step analogue,
    test.lisp:26-30)."""
    m = metrics(walker, take)
    lines = [
        f"walker ensemble: {m['n_walkers']} walkers x {m['age']} steps, "
        f"acceptance {m['acceptance']:.3f}",
        f"best log-posterior: {m['best_logprob']:.6f}",
        "params (best | MCSE | R-hat | ESS):",
    ]
    for k in walker.spec.keys:
        lines.append(
            f"  {k:>12s} = {m['best_params'][k]: .8g} "
            f"+- {m['mcse'][k]:.2g}   "
            f"R-hat {m['rhat'][k]:.3f}   ESS {m['ess'][k]:.0f}"
        )
    if getattr(walker, "config", None) is not None \
            and walker.config.kernel == "chees" \
            and hasattr(walker, "chees_trajectory"):
        tr = walker.chees_trajectory()
        cap = " AT CAP — raise chees_max_leapfrog" if tr["at_cap"] else ""
        t = ", ".join(f"{v:.1f}" for v in np.atleast_1d(tr["leapfrog"]))
        lines.append(f"chees trajectory: {t} leapfrog steps "
                     f"(budget {tr['budget']}{cap})")
    return "\n".join(lines)


# ------------------------------------------------------------------ WAIC

import dataclasses


@dataclasses.dataclass(frozen=True)
class WAICResult:
    """Widely Applicable Information Criterion for one fitted walker.

    ``elpd`` is the WAIC estimate of expected log pointwise predictive
    density (higher is better), ``p_waic`` the effective parameter
    count, ``lppd`` the in-sample log pointwise predictive density, and
    ``se`` the standard error of ``elpd`` over data points.  ``waic``
    is the deviance-scale convention ``-2 * elpd``.
    """

    elpd: float
    p_waic: float
    lppd: float
    se: float
    n_points: int
    n_samples: int
    pointwise: np.ndarray  # per-point elpd_i, real points only

    @property
    def waic(self) -> float:
        return -2.0 * self.elpd

    def __repr__(self):
        return (f"WAICResult(elpd={self.elpd:.3f} +- {self.se:.3f}, "
                f"p_waic={self.p_waic:.2f}, n_points={self.n_points}, "
                f"n_samples={self.n_samples})")


def _pointwise_ll_matrix(walker, name: str, take: int | None,
                         max_samples: int) -> np.ndarray:
    """(S, N) pointwise log-likelihood over history subsamples x real points.

    Shared front end of :func:`waic` / :func:`loo` /
    :func:`prior_sensitivity`: validates the walker is decomposable,
    thins the collected history to at most ``max_samples`` evenly spaced
    rows, evaluates ``likelihoods.pointwise_log_likelihood`` on device
    as one jitted vmap per dataset term, and drops padded lanes.
    Returns ``(ll, samples)`` — the matrix plus the exact (S, d)
    parameter rows it was evaluated at.
    """
    import jax

    if getattr(walker, "group_ids", None) is not None:
        raise ValueError(f"{name}: grouped/batched fits mix per-dataset "
                         "populations in one history; compute per "
                         "dataset (BatchedFit -> per-dataset walkers)")
    hook = getattr(walker, "_pointwise_ll", None)
    if hook is None and (getattr(walker, "_custom_log_post", None) is not None
                         or getattr(walker, "_custom_batched", None) is not None):
        raise ValueError(f"{name}: custom posteriors have no per-point "
                         "likelihood decomposition")
    from .likelihoods import pointwise_log_likelihood

    pos, _ = walker.steps(take)                      # ((T*W), d) on host
    if pos.shape[0] == 0:
        raise ValueError(f"{name}: no collected history (run adaptive_steps "
                         "with collect_history=True first)")
    n_avail = pos.shape[0]
    idx = np.unique(np.linspace(0, n_avail - 1,
                                min(max_samples, n_avail)).astype(int))
    samples = jnp.asarray(np.asarray(pos)[idx], walker.dtype)
    spec = walker.spec

    if hook is not None:
        # Structured ensembles whose LIKELIHOOD is still decomposable
        # even though the walk space is custom (HierarchicalFit: the
        # coordinates are (hypers, z) but each dataset's per-point
        # Gaussian/robust density is well-defined at the decoded
        # params).  The hook returns ((n, N) ll over REAL points, in
        # dataset-major point order) for the given sample rows.
        return np.asarray(hook(samples), np.float64), samples

    ll_blocks, mask_blocks = [], []
    for t in walker.terms:
        def one(vec, _t=t):
            return pointwise_log_likelihood(
                _t.likelihood, _t.fn, spec.unflatten(vec), _t.dataset)

        ll_blocks.append(np.asarray(jax.jit(jax.vmap(one))(samples),
                                    np.float64))
        mask_blocks.append(np.asarray(t.dataset.mask, np.float64))

    ll = np.concatenate(ll_blocks, axis=1)
    real = np.concatenate(mask_blocks) > 0.0
    return ll[:, real], samples                      # (S, N) real points


def waic(walker, take: int | None = None, max_samples: int = 512) -> WAICResult:
    """WAIC predictive model comparison from the walker's history.

    Complements the *marginal-likelihood* comparisons already in the
    framework (``Walker.log_evidence`` / ``log_bayes_factor`` /
    ``smc_sample``): evidence asks "which model explains the data given
    its prior", WAIC asks "which model predicts new points better" and
    needs no prior normalization or tempering run — just the posterior
    history that ``adaptive_steps`` already collected.

    Per data point i and posterior sample s the pointwise log-density
    ``ll[s, i]`` (``likelihoods.pointwise_log_likelihood``) gives

        lppd_i = log mean_s exp(ll[s, i])
        p_i    = var_s ll[s, i]                  (WAIC-2 variance form)
        elpd   = sum_i (lppd_i - p_i),  se = sqrt(n * var_i(elpd_i))

    The (samples x points) matrix is evaluated on device as one jitted
    vmap per dataset term; only the per-point reductions transfer.
    Requires library (or ``create_log_likelihood_function``-built)
    likelihood terms and collected history.  Grouped/batched fits have
    per-dataset populations — compute WAIC on the per-dataset walkers
    instead.

    The history must be POSTERIOR samples: burn the annealing phase
    first (``walker.burn_steps(...)``) or pass ``take=`` to restrict to
    the converged tail — hot-phase rows inflate ``var_s`` and hence
    ``p_waic`` far past the true effective parameter count.  Likewise
    walkers left stuck in a far-off mode after annealing (they cannot
    cross at T=1) dominate the variance; on hard multimodal fits run
    ``walker.reset_to_most_likely()`` before the cold sampling phase —
    a ``p_waic`` orders of magnitude above the parameter count is the
    tell (measured 7.2e6 vs 7.4 on the flagship fit with/without it).
    """
    ll, _ = _pointwise_ll_matrix(walker, "waic", take, max_samples)
    s_count = ll.shape[0]
    mx = ll.max(axis=0)
    lppd_i = mx + np.log(np.mean(np.exp(ll - mx), axis=0))
    p_i = ll.var(axis=0, ddof=1) if s_count > 1 else np.zeros_like(lppd_i)
    elpd_i = lppd_i - p_i
    n = int(elpd_i.size)
    se = float(np.sqrt(n * elpd_i.var(ddof=1))) if n > 1 else 0.0
    return WAICResult(
        elpd=float(elpd_i.sum()), p_waic=float(p_i.sum()),
        lppd=float(lppd_i.sum()), se=se, n_points=n, n_samples=int(s_count),
        pointwise=elpd_i,
    )


def waic_compare(a: WAICResult, b: WAICResult) -> dict[str, float]:
    """Paired WAIC comparison of two models fitted to the SAME data.

    Returns ``elpd_diff = elpd(a) - elpd(b)`` (positive favors ``a``)
    with the paired standard error ``sqrt(n * var_i(diff_i))`` — much
    tighter than differencing the marginal ``se``s, because per-point
    difficulty cancels.  A ``|elpd_diff| > ~2 se_diff`` is the usual
    "clearly better" reading.
    """
    return _paired_elpd_compare(a, b, "waic_compare")


def _paired_elpd_compare(a, b, name: str) -> dict[str, float]:
    if a.n_points != b.n_points:
        raise ValueError(
            f"{name}: models were scored on different data "
            f"({a.n_points} vs {b.n_points} points)")
    d = a.pointwise - b.pointwise
    n = d.size
    se = float(np.sqrt(n * d.var(ddof=1))) if n > 1 else 0.0
    return {"elpd_diff": float(d.sum()), "se_diff": se}


# ------------------------------------------------------------- PSIS-LOO

@dataclasses.dataclass(frozen=True)
class LOOResult:
    """Pareto-smoothed importance-sampling leave-one-out cross-validation.

    ``elpd`` estimates expected log pointwise predictive density under
    exact leave-one-out refitting (higher is better); ``p_loo`` is the
    implied effective parameter count ``lppd - elpd``.  ``pareto_k``
    holds the per-point generalized-Pareto tail-shape diagnostics: a
    point with k > 0.7 has an importance-ratio tail too heavy for the
    estimate to be reliable (that observation is so influential the
    posterior changes substantially when it is left out) — ``n_bad_k``
    counts them, and a nonzero count is itself a useful influence
    diagnostic.  ``looic`` is the deviance-scale ``-2 * elpd``.
    """

    elpd: float
    p_loo: float
    lppd: float
    se: float
    n_points: int
    n_samples: int
    pointwise: np.ndarray   # per-point elpd_i, real points only
    pareto_k: np.ndarray    # per-point GPD shape diagnostic
    # reloo only: indices of flagged points whose exact leave-out refit
    # FAILED the convergence gate — their PSIS value and pareto_k were
    # KEPT (an unmixed "exact" refit is worse than the flagged estimate
    # it would replace).  Empty for plain loo() and healthy reloo runs.
    refit_failed: tuple = ()

    @property
    def looic(self) -> float:
        return -2.0 * self.elpd

    @property
    def n_bad_k(self) -> int:
        return int(np.sum(self.pareto_k > 0.7))

    def __repr__(self):
        return (f"LOOResult(elpd={self.elpd:.3f} +- {self.se:.3f}, "
                f"p_loo={self.p_loo:.2f}, n_points={self.n_points}, "
                f"n_samples={self.n_samples}, max_k={self.pareto_k.max():.2f}, "
                f"n_bad_k={self.n_bad_k})")


def _gpd_fit(excess: np.ndarray) -> tuple[float, float]:
    """Empirical-Bayes generalized-Pareto fit (shape k, scale sigma).

    Zhang & Stephens (2009) profile-posterior estimator, with the weak
    k-prior regularization recommended by Vehtari et al. (2024, JMLR
    "Pareto smoothed importance sampling") for small tails.  ``excess``
    must be the ascending positive exceedances over the tail cutoff.
    Convention: k > 0 is a heavy (polynomial) tail; the k = 0 limit is
    exponential.  Returns ``(nan, nan)`` when the profile grid
    degenerates (all exceedances identical).
    """
    x = np.asarray(excess, np.float64)
    n = x.size
    if n < 5 or not np.isfinite(x[-1]) or x[-1] <= 0.0:
        return float("nan"), float("nan")
    # Profile the likelihood over theta = -k/sigma on the paper's grid,
    # anchored at the first-quartile exceedance and the maximum.
    quart = x[max(int(n / 4.0 + 0.5) - 1, 0)]
    if quart <= 0.0:
        return float("nan"), float("nan")
    m = 30 + int(np.sqrt(n))
    j = np.arange(1.0, m + 1.0)
    theta = 1.0 / x[-1] + (1.0 - np.sqrt(m / (j - 0.5))) / (3.0 * quart)
    # Profile log-likelihood of each theta (k estimated by its MLE).
    k_of_theta = np.mean(np.log1p(-theta[:, None] * x[None, :]), axis=1)
    with np.errstate(divide="ignore", invalid="ignore"):
        prof = n * (np.log(-theta / k_of_theta) - k_of_theta - 1.0)
    prof = np.where(np.isfinite(prof), prof, -np.inf)
    if not np.any(np.isfinite(prof)):
        return float("nan"), float("nan")
    # Posterior-mean theta under the (normalized) profile weights.
    w = np.exp(prof - prof.max())
    w_sum = w.sum()
    if not np.isfinite(w_sum) or w_sum <= 0.0:
        return float("nan"), float("nan")
    theta_hat = float(np.sum(theta * w) / w_sum)
    k_hat = float(np.mean(np.log1p(-theta_hat * x)))
    # sigma comes from the UNregularized (theta, k) pair — they satisfy
    # sigma = -k/theta > 0 by construction; regularizing k first can
    # flip its sign and break that.
    sigma = -k_hat / theta_hat
    # Weak prior nudging k toward 0.5 stabilizes tiny tails (PSIS paper
    # section 3; prior weight 10 pseudo-observations).
    k_hat = (n * k_hat + 10.0 * 0.5) / (n + 10.0)
    if not np.isfinite(sigma) or sigma <= 0.0 or not np.isfinite(k_hat):
        return float("nan"), float("nan")
    return k_hat, sigma


def _gpd_quantile(p: np.ndarray, k: float, sigma: float) -> np.ndarray:
    """Inverse CDF of the generalized Pareto (same convention as _gpd_fit)."""
    if abs(k) < 1e-12:
        return sigma * (-np.log1p(-p))
    return sigma * np.expm1(-k * np.log1p(-p)) / k


def _psis_smooth(lw: np.ndarray) -> tuple[np.ndarray, float]:
    """Pareto-smooth one vector of log importance ratios.

    Fits a generalized Pareto to the largest ``M = min(S/5, 3*sqrt(S))``
    ratios and replaces them with the fit's expected order statistics
    (Vehtari, Simpson, Gelman, Yao & Gabry — PSIS), then truncates at
    the raw maximum.  Returns the smoothed (max-shifted, unnormalized)
    log-weights and the tail-shape diagnostic k.
    """
    s = lw.size
    lw = lw - lw.max()
    m = int(min(0.2 * s, 3.0 * np.sqrt(s)))
    if m < 5:
        return lw, float("inf")
    order = np.argsort(lw)
    tail_ids = order[-m:]
    cutoff = np.exp(lw[order[-m - 1]])
    tail = np.exp(lw[tail_ids])                  # ascending, >= cutoff
    excess = tail - cutoff
    if excess[-1] <= 0.0:                        # tail flat at the cutoff
        return lw, float("inf")
    k, sigma = _gpd_fit(excess)
    if not np.isfinite(k):
        return lw, float("inf")
    probs = (np.arange(m) + 0.5) / m
    smoothed = np.log(cutoff + _gpd_quantile(probs, k, sigma))
    # tail_ids is already ordered by raw weight; order statistics align.
    lw = lw.copy()
    lw[tail_ids] = np.minimum(smoothed, 0.0)     # never exceed raw max
    return lw, k


def loo(walker, take: int | None = None, max_samples: int = 512) -> LOOResult:
    """PSIS-LOO cross-validation from the walker's history.

    The accuracy upgrade over :func:`waic`: both estimate the same
    out-of-sample elpd, but LOO via importance sampling degrades
    gracefully on influential observations where WAIC's quadratic
    variance correction breaks down — and, unlike WAIC, it tells you
    *when* to distrust it, per point, through the Pareto-k diagnostics
    (``pareto_k``/``n_bad_k``; k > 0.7 means that point's leave-one-out
    posterior differs too much for reweighting to reach).  Same
    requirements and caveats as :func:`waic` (posterior history only —
    burn the anneal phase; decomposable likelihoods; per-dataset walkers
    for batched fits).

    For each point the leave-one-out posterior is reached by importance
    reweighting the full-posterior samples with ratios 1/p(y_i|theta_s);
    the ratio tails are Pareto-smoothed (:func:`_psis_smooth`) before
    the self-normalized estimate

        elpd_i = log( sum_s w_si p(y_i|theta_s) / sum_s w_si ).

    Reference: Vehtari, Gelman & Gabry, "Practical Bayesian model
    evaluation using leave-one-out cross-validation and WAIC" (2017).
    """
    ll, _ = _pointwise_ll_matrix(walker, "loo", take, max_samples)
    s_count, n = ll.shape
    mx = ll.max(axis=0)
    lppd_i = mx + np.log(np.mean(np.exp(ll - mx), axis=0))

    elpd_i = np.empty(n)
    k_i = np.empty(n)
    for i in range(n):
        lw, k_i[i] = _psis_smooth(-ll[:, i])
        lw = lw - _logsumexp(lw)                 # normalized log-weights
        elpd_i[i] = _logsumexp(lw + ll[:, i])
    se = float(np.sqrt(n * elpd_i.var(ddof=1))) if n > 1 else 0.0
    return LOOResult(
        elpd=float(elpd_i.sum()), p_loo=float((lppd_i - elpd_i).sum()),
        lppd=float(lppd_i.sum()), se=se, n_points=int(n),
        n_samples=int(s_count), pointwise=elpd_i, pareto_k=k_i,
    )


def _logsumexp(a: np.ndarray) -> float:
    mx = a.max()
    return float(mx + np.log(np.sum(np.exp(a - mx))))


def loo_compare(a: LOOResult, b: LOOResult) -> dict[str, float]:
    """Paired LOO comparison — same contract as :func:`waic_compare`
    (positive ``elpd_diff`` favors ``a``; per-point differencing makes
    the standard error much tighter than the marginal ``se``s)."""
    return _paired_elpd_compare(a, b, "loo_compare")


# --------------------------------------------------------------- LOO-PIT

@dataclasses.dataclass(frozen=True)
class LOOPITResult:
    """Leave-one-out probability-integral-transform calibration check.

    ``pit[i]`` estimates ``P(y_rep <= y_i)`` under point i's
    leave-one-out predictive distribution; for a well-calibrated model
    the collection is Uniform(0, 1).  ``ks_stat`` / ``p_value`` test
    that uniformity (Kolmogorov-Smirnov, asymptotic p); systematic
    pile-up at 0/1 means the model is over-confident (understated
    noise), a hump at 0.5 under-confident, and a sloped profile a
    biased mean model.  ``pareto_k`` carries the per-point PSIS
    reliability flags (same convention as :class:`LOOResult`).
    """

    pit: np.ndarray
    ks_stat: float
    p_value: float
    n_points: int
    n_samples: int
    pareto_k: np.ndarray
    threshold: float = 0.05

    @property
    def ok(self) -> bool:
        return bool(self.p_value > self.threshold)

    @property
    def n_bad_k(self) -> int:
        return int(np.sum(self.pareto_k > 0.7))

    def __repr__(self):
        return (f"LOOPITResult(ok={self.ok}, ks={self.ks_stat:.3f}, "
                f"p={self.p_value:.3g}, n_points={self.n_points}, "
                f"n_bad_k={self.n_bad_k})")


def _ks_uniform(pit: np.ndarray) -> tuple[float, float]:
    """One-sample KS statistic against Uniform(0,1) + asymptotic p.

    p uses the Kolmogorov series with the Stephens small-n correction
    ``(sqrt(n) + 0.12 + 0.11/sqrt(n)) * D``.
    """
    n = pit.size
    s = np.sort(pit)
    i = np.arange(1, n + 1, dtype=np.float64)
    d = float(max(np.max(i / n - s), np.max(s - (i - 1.0) / n)))
    lam = (np.sqrt(n) + 0.12 + 0.11 / np.sqrt(n)) * d
    k = np.arange(1, 101, dtype=np.float64)
    p = 2.0 * np.sum((-1.0) ** (k - 1.0) * np.exp(-2.0 * (k * lam) ** 2))
    return d, float(min(max(p, 0.0), 1.0))


def loo_pit(walker, take: int | None = None,
            max_samples: int = 512) -> LOOPITResult:
    """LOO-PIT calibration: is each point's observed value a plausible
    draw from its own leave-one-out predictive distribution?

    The out-of-sample sharpening of :func:`~lisp_mcmc_tpu.predictive.
    ppc_pvalue`: posterior-predictive checks reuse every point to judge
    itself (double-dipping that hides over-fitting), while LOO-PIT
    reweights the history with the SAME smoothed importance ratios as
    :func:`loo` so each point is judged by a posterior that never saw
    it:

        pit_i = sum_s w_si * F(y_i | theta_s),   w_si ~ PSIS(1/p(y_i|theta_s))

    with F the per-point predictive CDF (``likelihoods.pointwise_cdf``;
    exact for the Gaussian/student-t/noise-scale families, mid-p for
    Poisson counts).  Uniform pit = calibrated; see
    :class:`LOOPITResult` for the failure-shape reading.  Same
    requirements as :func:`waic`/:func:`loo` (posterior history only —
    burn the anneal phase; decomposable likelihoods; per-dataset
    walkers for batched fits).

    Reference: Gabry, Simpson, Vehtari, Betancourt & Gelman (2019),
    "Visualization in Bayesian workflow".  No reference-code analogue
    (mcmc-fitting.lisp stops at residual plots, 1271); this extends the
    same model-criticism story the predictive trio started.
    """
    import jax

    from .likelihoods import pointwise_cdf

    ll, samples = _pointwise_ll_matrix(walker, "loo_pit", take, max_samples)
    spec = walker.spec
    cdf_hook = getattr(walker, "_pointwise_cdf", None)
    if cdf_hook is not None:
        # Same structured-ensemble escape as _pointwise_ll_matrix: the
        # hook returns (n, N) predictive CDFs over real points in the
        # same dataset-major order as the ll matrix.
        cdf = np.asarray(cdf_hook(samples), np.float64)
        return _loo_pit_from(ll, cdf)
    cdf_blocks, mask_blocks = [], []
    for t in walker.terms:
        def one(vec, _t=t):
            return pointwise_cdf(
                _t.likelihood, _t.fn, spec.unflatten(vec), _t.dataset)

        cdf_blocks.append(np.asarray(jax.jit(jax.vmap(one))(samples),
                                     np.float64))
        mask_blocks.append(np.asarray(t.dataset.mask, np.float64))
    cdf = np.concatenate(cdf_blocks, axis=1)
    real = np.concatenate(mask_blocks) > 0.0
    return _loo_pit_from(ll, cdf[:, real])


def _loo_pit_from(ll: np.ndarray, cdf: np.ndarray) -> "LOOPITResult":
    """PSIS-weighted PIT + KS verdict from matched (n, N) matrices."""
    s_count, n = ll.shape
    pit = np.empty(n)
    k_i = np.empty(n)
    for i in range(n):
        lw, k_i[i] = _psis_smooth(-ll[:, i])
        w = np.exp(lw - _logsumexp(lw))
        pit[i] = float(np.sum(w * cdf[:, i]))
    d, p = _ks_uniform(pit)
    return LOOPITResult(pit=pit, ks_stat=d, p_value=p, n_points=int(n),
                        n_samples=int(s_count), pareto_k=k_i)


# ----------------------------------------------------------------- audit

@dataclasses.dataclass(frozen=True)
class AuditResult:
    """One-call fit report card (see :func:`audit`).

    ``ok`` is True only when every check that RAN passed; ``skipped``
    maps checks that could not run (custom posterior, grouped fit, no
    informative prior) to the reason, so a skipped check can never be
    mistaken for a passed one.  ``advice`` holds actionable readings of
    the failures, worst first.
    """

    ok: bool
    convergence: dict
    loo_pit: "LOOPITResult | None"
    prior_sensitivity: "PriorSensitivityResult | None"
    advice: list[str]
    skipped: dict[str, str]

    def __repr__(self):
        ran = [n for n, v in (("convergence", self.convergence),
                              ("loo_pit", self.loo_pit),
                              ("prior_sensitivity", self.prior_sensitivity))
               if v is not None]
        return (f"AuditResult(ok={self.ok}, ran={ran}, "
                f"skipped={list(self.skipped) or 'none'}, "
                f"advice={len(self.advice)} item(s))")


def audit(walker, take: int | None = None, prior=None,
          max_samples: int = 512, rhat_tol: float = 1.01,
          min_tail_ess: float = 100.0) -> AuditResult:
    """Run the cheapest-first calibration ladder in one call.

    The TUNING.md recipe as a verb: (1) :func:`convergence` — did the
    sampler converge; (2) :func:`loo_pit` — is the model calibrated
    out-of-sample; (3) :func:`prior_sensitivity` — is the prior
    load-bearing or in conflict.  Each failure contributes a plain-
    language reading to ``advice`` (over/under-confident PIT shapes are
    distinguished, unreliable importance tails are attributed to warm
    history rather than the model).  Checks that cannot run on this fit
    (custom posteriors have no pointwise decomposition; grouped fits
    need per-dataset views) are recorded in ``skipped`` with the
    library's own error message — never silently passed.

    SBC is deliberately NOT part of the ladder (it costs real fits; run
    :func:`~lisp_mcmc_tpu.sbc_check` once per model family).  Same
    history contract as everything else here: cold posterior rows only.
    """
    advice: list[str] = []
    skipped: dict[str, str] = {}

    conv = convergence(walker, take, rhat_tol=rhat_tol,
                       min_tail_ess=min_tail_ess)
    if not conv["ok"]:
        advice.append(
            "not converged (" + "; ".join(conv["failures"][:3]) +
            (" …" if len(conv["failures"]) > 3 else "") +
            ") — sample further (auto='rank-rhat') before trusting "
            "anything below")

    pit = None
    try:
        pit = loo_pit(walker, take, max_samples)
    except ValueError as e:
        skipped["loo_pit"] = str(e)
    if pit is not None:
        if pit.n_bad_k > max(2, pit.n_points // 20):
            advice.append(
                f"loo_pit: {pit.n_bad_k}/{pit.n_points} importance tails "
                "unreliable (pareto_k > 0.7) — warm history rows (burn "
                "the anneal phase) or pervasive misspecification")
        if not pit.ok:
            extremes = float(np.mean(pit.pit < 0.1) + np.mean(pit.pit > 0.9))
            center = float(np.mean((pit.pit > 0.4) & (pit.pit < 0.6)))
            if extremes > 0.35:
                advice.append(
                    "loo_pit: over-confident (PIT piles at 0/1) — "
                    "observation errors understated; consider "
                    "make_noise_scale_likelihood and refit")
            elif center > 0.35:
                advice.append(
                    "loo_pit: under-confident (PIT humps at 0.5) — "
                    "observation errors overstated")
            else:
                advice.append(
                    f"loo_pit: miscalibrated (KS p={pit.p_value:.2g}, "
                    f"mean PIT {pit.pit.mean():.2f}) — a sloped/one-sided "
                    "profile usually means a biased mean model")

    sens = None
    try:
        sens = prior_sensitivity(walker, prior=prior, take=take,
                                 max_samples=max_samples)
    except ValueError as e:
        skipped["prior_sensitivity"] = str(e)
    if sens is not None and not sens.ok:
        for k, d in sens.diagnosis.items():
            if d != "robust":
                advice.append(f"prior_sensitivity: {k}: {d} "
                              f"(prior {sens.prior[k]:.3f} / likelihood "
                              f"{sens.likelihood[k]:.3f})")

    ok = bool(conv["ok"]
              and (pit is None or pit.ok)
              and (sens is None or sens.ok))
    return AuditResult(ok=ok, convergence=conv, loo_pit=pit,
                       prior_sensitivity=sens, advice=advice,
                       skipped=skipped)


# ------------------------------------------------- power-scaling sensitivity

@dataclasses.dataclass(frozen=True)
class PriorSensitivityResult:
    """Power-scaling sensitivity of the posterior to prior and likelihood.

    ``prior[k]`` / ``likelihood[k]`` are per-parameter sensitivity
    indices (normalized CJS distance per unit of log2 power — see
    :func:`prior_sensitivity`); ``diagnosis[k]`` applies the Kallioinen
    et al. (2023) decision table at ``threshold``:

    - both above threshold → ``"prior-data conflict"`` (the prior pulls
      against what the data say — revisit one of them),
    - prior above, likelihood below → ``"strong prior / weak
      likelihood"`` (the data barely constrain this parameter; the
      posterior is mostly the prior),
    - prior below → ``"robust"`` (likelihood sensitivity alone is
      expected — data SHOULD inform the posterior).

    ``pareto_k`` holds the importance-weight tail diagnostics per
    scaling direction (> 0.7 = unreliable reweighting; NaN = weights
    too uniform to fit a tail, which is itself benign).
    """

    prior: dict[str, float]
    likelihood: dict[str, float]
    diagnosis: dict[str, str]
    pareto_k: dict[str, float]
    threshold: float
    alpha: float
    n_samples: int

    @property
    def ok(self) -> bool:
        """True when every parameter's diagnosis is "robust"."""
        return all(d == "robust" for d in self.diagnosis.values())

    def __repr__(self):
        flagged = {k: d for k, d in self.diagnosis.items() if d != "robust"}
        worst = max(self.prior, key=lambda k: self.prior[k])
        return (f"PriorSensitivityResult(ok={self.ok}, "
                f"max_prior_sens={self.prior[worst]:.3f} ({worst}), "
                f"flagged={flagged or 'none'}, "
                f"n_samples={self.n_samples})")


def _cjs_distance(x: np.ndarray, w: np.ndarray) -> float:
    """Normalized cumulative Jensen-Shannon distance between the
    empirical distribution of ``x`` and its ``w``-reweighted version.

    Nguyen & Vreeken (2015) on the empirical CDFs P (uniform weights)
    and Q (weights ``w``), evaluated on the sorted sample support with
    bin widths ``dx``:

        CJS_sym = sum dx * [ P log2(2P/(P+Q)) + Q log2(2Q/(P+Q)) ]
        dist    = sqrt( CJS_sym / sum dx * (P+Q) )   in [0, 1]

    (the divergences' linear correction terms cancel in the symmetric
    sum; the denominator is the tight upper bound, reached by disjoint
    supports).
    """
    order = np.argsort(x)
    xs = x[order]
    bins = np.diff(xs)
    if not np.any(bins > 0.0):                   # degenerate marginal
        return 0.0
    s = xs.size
    p = np.arange(1.0, s) / s                    # ECDF at left bin edges
    q = np.minimum(np.cumsum(w[order])[:-1], 1.0)
    pq = p + q
    safe = np.where(pq > 0.0, pq, 1.0)
    with np.errstate(divide="ignore", invalid="ignore"):
        tp = np.where(p > 0.0, p * np.log2(np.where(p > 0.0, 2.0 * p, 1.0) / safe), 0.0)
        tq = np.where(q > 0.0, q * np.log2(np.where(q > 0.0, 2.0 * q, 1.0) / safe), 0.0)
    total = float(np.sum(bins * (tp + tq)))
    bound = float(np.sum(bins * pq))
    if bound <= 0.0:
        return 0.0
    return float(np.sqrt(max(total, 0.0) / bound))


def prior_sensitivity(walker, prior=None, take: int | None = None,
                      max_samples: int = 1024, alpha: float = 1.01,
                      threshold: float = 0.05,
                      expressions=None) -> PriorSensitivityResult:
    """Power-scaling sensitivity analysis: does the prior matter, and
    does it fight the data?

    Completes the named-prior workflow (PriorSpec / MVGaussian fits):
    after declaring an informative prior, this answers "was that prior
    load-bearing?" WITHOUT any refitting.  The posterior is perturbed to
    ``prior^a * likelihood`` and ``prior * likelihood^a`` for ``a`` near
    1 by importance-reweighting the samples ``adaptive_steps`` already
    collected (Kallioinen, Paananen, Bürkner & Vehtari 2023, "Detecting
    and diagnosing prior and likelihood sensitivity with power-scaling");
    the sensitivity index per parameter is the normalized CJS distance
    (:func:`_cjs_distance`) between base and perturbed marginals per
    unit of log2 power, averaged over ``a = 1/alpha`` and ``a = alpha``:

        sens = mean_a  CJS(theta_k, w_a) / |log2 a|,
        log w_a = (a - 1) * log prior(theta_s)        (prior scaling)
        log w_a = (a - 1) * log likelihood(theta_s)   (likelihood scaling)

    The weights are Pareto-smoothed (:func:`_psis_smooth`) and their
    tail-shape diagnostics reported.  A flat (Uniform box) prior is
    invariant under power-scaling, so its prior sensitivity is exactly 0
    — informative priors are where this earns its keep.

    The prior density defaults to the declared spec recovered from the
    fit (``log_prior=PriorSpec(...)``), else the fit's own prior term
    (walls included); pass ``prior=`` to scale a specific spec.  Same
    history requirements as :func:`waic`: burn the anneal phase first,
    and compute per dataset on batched fits (``dataset_view``).

    ``expressions=["(/ 1 :tau)", ...]`` adds derived quantities to the
    audit: each s-expression (or Python-string) is evaluated over the
    same posterior draws and gets its own sensitivity indices and
    diagnosis, keyed by the expression string — a parameter can look
    robust while the physical quantity built from it is not.

    Reference prior contract: mcmc-fitting.lisp:346-369 (bounds macro)
    and 837-845 (data-dependent fixers) define what "the prior" is here;
    this diagnostic treats that whole term as the scaled density.
    """
    import jax

    if not 1.0 < alpha < 2.0:
        raise ValueError(f"prior_sensitivity: alpha must be in (1, 2), "
                         f"got {alpha} (it is a perturbation around 1)")
    unsupported = getattr(walker, "_prior_sensitivity_unsupported", None)
    if unsupported:
        # Facade views whose installed prior is a flat stand-in (the real
        # prior lives elsewhere): scaling it would trivially diagnose
        # every parameter "robust" — refuse instead of misreporting.
        raise ValueError(f"prior_sensitivity: {unsupported}")
    from .priors import resolve_prior_spec

    ll, samples = _pointwise_ll_matrix(
        walker, "prior_sensitivity", take, max_samples)
    loglik = ll.sum(axis=1)                      # (S,) total log-likelihood
    param_spec = walker.spec
    if prior is not None:
        # Scale exactly the density the caller names.
        spec = resolve_prior_spec(walker, prior=prior)

        def _log_prior_one(vec):
            return spec.log_pdf(param_spec.unflatten(vec), None)
    else:
        # Scale what the posterior actually contains: the INSTALLED
        # prior terms.  On a T-term global fit a shared prior is
        # installed once per term (reference semantics, fit.py log_post)
        # so the sampled measure is prior^T — recovering the spec and
        # scaling it once would under-perturb by a factor of T and a
        # real conflict could read "robust".  For single-term named
        # priors the installed term IS the normalized log-pdf, so this
        # path matches the spec path up to a CJS-invariant constant.
        terms = walker.terms

        def _log_prior_one(vec):
            p = param_spec.unflatten(vec)
            total = 0.0
            for t in terms:
                total = total + t.prior(p, t.dataset)
            return total

    logprior = np.asarray(
        jax.jit(jax.vmap(_log_prior_one))(samples), np.float64)
    if not np.all(np.isfinite(logprior)):
        raise ValueError(
            "prior_sensitivity: some posterior draws have non-finite "
            "prior density — the history predates the prior (or crosses "
            "a truncation wall); refit with log_prior=spec or burn the "
            "offending phase")

    theta = np.asarray(samples, np.float64)      # (S, d)
    s_count = theta.shape[0]
    keys = param_spec.keys
    columns = {k: theta[:, i] for i, k in enumerate(keys)}
    if expressions:
        from .expressions import _evaluate

        for expr in expressions:
            columns[expr] = np.asarray(
                _evaluate(expr, dict(columns)), np.float64)
    alphas = (1.0 / alpha, alpha)
    denom = abs(np.log2(alpha))
    sens = {"prior": logprior, "likelihood": loglik}
    out: dict[str, dict[str, float]] = {}
    k_worst: dict[str, float] = {}
    for name, logterm in sens.items():
        if np.ptp(logterm) == 0.0:
            # A constant log-density (flat box prior) is exactly
            # invariant under power-scaling — don't let float rounding
            # through sqrt(CJS) report ~1e-6 instead of 0.
            out[name] = {k: 0.0 for k in columns}
            k_worst[name] = float("nan")
            continue
        per_col = {k: 0.0 for k in columns}
        k_max = -np.inf
        for a in alphas:
            lw, k_hat = _psis_smooth((a - 1.0) * logterm)
            if np.isfinite(k_hat):
                k_max = max(k_max, k_hat)
            w = np.exp(lw - _logsumexp(lw))
            for k, col in columns.items():
                per_col[k] += _cjs_distance(col, w) / denom
        out[name] = {k: float(v / len(alphas)) for k, v in per_col.items()}
        k_worst[name] = float(k_max) if np.isfinite(k_max) else float("nan")

    diagnosis = {}
    for k in columns:
        ps, ls = out["prior"][k], out["likelihood"][k]
        if ps >= threshold and ls >= threshold:
            diagnosis[k] = "prior-data conflict"
        elif ps >= threshold:
            diagnosis[k] = "strong prior / weak likelihood"
        else:
            diagnosis[k] = "robust"
    return PriorSensitivityResult(
        prior=out["prior"], likelihood=out["likelihood"],
        diagnosis=diagnosis, pareto_k=k_worst, threshold=threshold,
        alpha=alpha, n_samples=int(s_count),
    )


def _require_per_point(name: str, likelihood):
    """Refits/scoring need a per-point form; refuse loudly otherwise."""
    from .likelihoods import LIBRARY_POINTWISE

    if likelihood not in LIBRARY_POINTWISE \
            and not hasattr(likelihood, "_pointwise"):
        raise ValueError(
            f"{name}: refits need a likelihood with a per-point form "
            "(a library reduction or a create_log_likelihood_function/"
            "factory likelihood shipping _pointwise); this fit uses "
            f"{getattr(likelihood, '__name__', likelihood)!r} "
            "— refit without the held-out points by hand")


def _global_batched_refit(walker, name: str, holdouts, n_steps: int,
                          temperature: float, walkers_per_dataset: int,
                          burn_fraction: float, max_samples: int,
                          seed: int):
    """Multi-term twin of :func:`_batched_refit`: leave-out refits of a
    GLOBAL fit (shared parameters, T dataset terms — the test.lisp:58-70
    workflow) as adaptation groups of one grouped Walker.

    Held-out points are removed by MASK, not by slicing: each block's
    per-term :class:`~lisp_mcmc_tpu.data.Dataset` is rebuilt with the
    reduced mask, so every cached walker-independent constant
    (inv_sigma, per-point log-normalizations, log y!) is exact for the
    reduced point set — reductions are mask-exact by construction
    (data.py), and every block keeps ONE static shape (the device-native
    form of "delete a point").  The K leave-out posteriors — each the
    FULL T-term sum — run as K adaptation groups of one Walker, with
    the stacked per-term Datasets riding jit as arguments.

    Returns ``(fit, score_block)`` with ``score_block(j) -> (S, N)``
    pointwise log-likelihood of the ORIGINAL data (term-major real
    points, the same axis :func:`_pointwise_ll_matrix` builds) under
    block j's posterior draws.
    """
    import jax

    from .data import Dataset
    from .fit import Walker, history_block_columns
    from .likelihoods import pointwise_log_likelihood

    unsupported = getattr(walker, "_refit_unsupported", None)
    if unsupported:
        # Facade views (HierarchicalFit.dataset_view) null the custom-
        # posterior attributes below, but refitting their single-dataset
        # terms would silently drop the population prior — a DIFFERENT
        # model than the one that produced the flags.
        raise ValueError(f"{name}: {unsupported}")
    if getattr(walker, "_custom_log_post", None) is not None or \
            getattr(walker, "_custom_batched", None) is not None:
        # Without this guard the rebuild below would unflatten WALK-space
        # coordinates into the model and fail deep in tracing — or
        # worse, fit the wrong posterior.  (HierarchicalFit never
        # reaches here: it ships _refit_cv, dispatched by
        # _batched_refit.)
        raise ValueError(
            f"{name}: refit-CV rebuilds the posterior from the fit's "
            "terms; custom-posterior fits are not reconstructible — "
            "use waic/loo (pointwise) instead")
    terms = walker.terms
    for t in terms:
        _require_per_point(name, t.likelihood)
    # Multi-column x needs no special case: holdouts are removed by
    # MASK (shape (N,) regardless of x being (N,) or (N, C)) and the
    # rebuilt Datasets keep x verbatim — pinned at 1e-9 against a
    # sliced-data refit in test_multicolumn_x.py (VERDICT r4 #5; the
    # pre-r5 refusal here was a capability cliff inside one workflow).
    K = len(holdouts)
    B = walkers_per_dataset
    spec = walker.spec
    # Holdouts index the REAL-point (mask > 0) axis — the axis loo's
    # pareto_k and every pointwise elpd array use (_pointwise_ll_matrix
    # drops padded lanes and any interior masked point).  Mapping each
    # term's segment back through its mask>0 padded positions keeps
    # flagged points and held-out points aligned even for datasets that
    # carry interior masked points (advisor finding, round 3).
    real_pos = [np.where(np.asarray(t.dataset.mask, np.float64) > 0.0)[0]
                for t in terms]
    offsets = np.concatenate([[0], np.cumsum([p.size for p in real_pos])])

    blocks = []
    for ti, term in enumerate(terms):
        ds = term.dataset
        per_block = []
        for keep in holdouts:
            seg = np.asarray(keep[offsets[ti]:offsets[ti + 1]], np.float64)
            mask = np.asarray(ds.mask, np.float64).copy()
            mask[real_pos[ti]] *= seg
            per_block.append(Dataset(
                x=ds.x, y=ds.y, sigma=ds.sigma,
                mask=jnp.asarray(mask, np.asarray(ds.mask).dtype), n=ds.n))
        blocks.append(jax.tree_util.tree_map(
            lambda *a: jnp.stack(a), *per_block))
    # Originals ride along for prior fixer semantics (837-845): the
    # prior terms evaluate against the UNREDUCED datasets, like the
    # single-term path's _refit_prior.  Both live in the data pytree
    # (datasets pass through jit as arguments, never closure constants).
    data = {"blocks": tuple(blocks),
            "orig": tuple(t.dataset for t in terms)}

    def _terms_lp(p, datasets, origs, dtype):
        total = jnp.asarray(0.0, dtype)
        for term, ds_t, ods in zip(terms, datasets, origs):
            total = total + term.likelihood(term.fn, p, ds_t)
            total = total + term.prior(p, ods)
        return total

    def log_post(theta, block_idx, data):
        """Per-walker posterior (diagnostics path): gather block slice."""
        p = spec.unflatten(theta)
        ds_k = tuple(jax.tree_util.tree_map(lambda a: a[block_idx], st)
                     for st in data["blocks"])
        return _terms_lp(p, ds_k, data["orig"], theta.dtype)

    def batched_log_post(positions, data):
        """Hot path: (K, B, d) blocks against the stacked term Datasets."""
        pos_k = positions.reshape(K, B, -1)

        def per_block(theta_block, *ds_blocks):
            def one(theta):
                p = spec.unflatten(theta)
                return _terms_lp(p, ds_blocks, data["orig"], theta.dtype)

            return jax.vmap(one)(theta_block)

        lps = jax.vmap(per_block, in_axes=(0,) + (0,) * len(terms))(
            pos_k, *data["blocks"])
        return lps.reshape(positions.shape[0])

    group_ids = np.repeat(np.arange(K, dtype=np.int32), B)
    fit = Walker(
        terms=list(terms), spec=spec,
        initial_vector=spec.flatten(walker.most_likely_params(),
                                    dtype=walker.dtype),
        n_walkers=K * B, seed=seed, walker_jitter=0.02,
        dtype=walker.dtype,
        aux=jnp.asarray(group_ids), group_ids=group_ids, n_groups=K,
        log_posterior=log_post, posterior_data=data,
        batched_log_posterior=batched_log_post,
    )
    if fit.config.history_walkers and fit.config.history_walkers < K * B:
        # Scoring needs every block retained; the evenly-spaced walker
        # subsample would cross blocks (same guard as sbc_check).
        fit.config = dataclasses.replace(fit.config, history_walkers=0)
    fit.adaptive_steps(n_steps, temperature=temperature, auto=None)
    fit.reset()                                   # drop warm anneal rows
    fit.sampling_steps(max(2000, n_steps // 2), kernel="mala")
    fit.burn_steps(int(len(fit) * burn_fraction))

    def _ll_full(vec):
        p = spec.unflatten(vec)
        return jnp.concatenate([
            pointwise_log_likelihood(t.likelihood, t.fn, p, t.dataset)
            for t in terms])

    ll_fn = jax.jit(jax.vmap(_ll_full))
    real = np.concatenate([np.asarray(t.dataset.mask, np.float64)
                           for t in terms]) > 0.0

    # Materialize the history ONCE: score_block runs K times and the
    # (T, K*B, d) host conversion + column mapping are identical calls.
    _hist_cache: dict = {}

    def score_block(j):
        if "pos" not in _hist_cache:
            pos, _ = fit._history(None)           # (T, K*B, d)
            _hist_cache["pos"] = np.asarray(pos)
            _hist_cache["cols"] = history_block_columns(
                fit, _hist_cache["pos"].shape[1])
        pos = _hist_cache["pos"]
        block = pos[:, _hist_cache["cols"][j], :].reshape(-1, spec.ndim)
        idx = np.unique(np.linspace(0, block.shape[0] - 1,
                                    min(max_samples,
                                        block.shape[0])).astype(int))
        ll = np.asarray(ll_fn(jnp.asarray(block[idx], walker.dtype)),
                        np.float64)
        return ll[:, real]

    return fit, score_block


def _batched_refit(walker, name: str, holdouts, n_steps: int,
                   temperature: float, walkers_per_dataset: int,
                   burn_fraction: float, max_samples: int, seed: int):
    """Shared refit scaffolding of :func:`reloo` and :func:`kfold`.

    Builds one leave-out posterior per entry of ``holdouts`` (a boolean
    keep-mask over the term-major concatenated real-point axis), fits
    them as adaptation groups of ONE grouped ensemble (anneal, then a
    cold mala sampling phase — ranking/scoring from warm anneal rows
    would bias every "exact" elpd low, the same caveat :func:`waic`
    documents), and returns ``(fit, score_block)`` where
    ``score_block(j)`` gives the (S, N) pointwise log-likelihood of the
    ORIGINAL data under block j's posterior draws.

    Guards: likelihoods with a recoverable per-point
    form (any library reduction or a factory that ships ``_pointwise``
    — student-t / noise-scale / Poisson / x-error all qualify; the
    refits sample under the fit's OWN likelihood).

    All refit-CV rides :func:`_global_batched_refit`'s mask-based
    grouped-Walker machinery — a single-term fit is just the T=1 case.
    The pre-r3s3 single-term path held points out by SLICING the
    arrays instead; that computes the same leave-out posterior for
    in-dataset likelihoods but silently MISALIGNS per-point closures:
    ``make_x_error_likelihood(sigma_x_array)`` pads its full-length
    sigma_x against the sliced grid, giving every point after the
    first held-out index its neighbor's sigma_x (review finding, r3
    session 3).  Masking keeps point positions fixed, so per-point
    closures stay aligned by construction.

    Structured ensembles that know how to refit THEMSELVES (a
    :class:`~lisp_mcmc_tpu.HierarchicalFit`'s joint non-centered
    posterior with one point masked out of one dataset's stacked
    block) ship a ``_refit_cv`` hook with this exact signature.
    """
    hook = getattr(walker, "_refit_cv", None)
    if hook is not None:
        return hook(name, holdouts, n_steps, temperature,
                    walkers_per_dataset, burn_fraction, max_samples, seed)
    return _global_batched_refit(
        walker, name, holdouts, n_steps, temperature,
        walkers_per_dataset, burn_fraction, max_samples, seed)


def _refit_n_points(walker) -> int:
    """Length of the real-point axis refit-CV holdouts index over.

    This is the axis every pointwise elpd array uses: mask > 0 points,
    term-major (dataset-major for hierarchical fits, which expose it
    directly as ``_n_real_points`` — their ``terms`` hold only one
    representative dataset).
    """
    n = getattr(walker, "_n_real_points", None)
    if n is not None:
        return int(n)
    return int(sum(int(np.sum(np.asarray(t.dataset.mask, np.float64) > 0.0))
                   for t in walker.terms))


def reloo(walker, result: LOOResult | None = None,
          k_threshold: float = 0.7, max_refits: int = 32,
          n_steps: int = 8000, temperature: float = 4.0,
          walkers_per_dataset: int = 64, burn_fraction: float = 0.33,
          max_samples: int = 512, seed: int = 0) -> LOOResult:
    """Exact leave-one-out refits for every Pareto-k-flagged point.

    PSIS-LOO's k > ``k_threshold`` flags mean "this point is so
    influential that reweighting cannot reach its leave-one-out
    posterior" — the honest fix is to actually refit without it.  The
    classical tooling refits one MCMC run per flagged point; here ALL
    flagged points' leave-one-out posteriors are dataset blocks of a
    SINGLE :class:`~lisp_mcmc_tpu.batched.BatchedFit`, so k refits cost
    one vectorized ensemble run (the same chip-filling trick
    ``sbc_check`` uses).  Returns a :class:`LOOResult` whose flagged
    ``pointwise`` entries are replaced by the exact

        elpd_i = log mean_s p(y_i | theta_s^{(-i)})

    over each block's posterior draws, with those ``pareto_k`` set to
    0.0 (exact — no importance ratio left to diagnose).  Unflagged
    points keep their PSIS estimates.

    A large flag count is a model problem, not a compute problem —
    ``max_refits`` guards against refitting your way past
    misspecification (fix the likelihood; see
    ``make_student_t_likelihood`` / :func:`loo_pit`).

    Restrictions (see :func:`_batched_refit`):
    likelihoods with a per-point form (multi-column x is fine — masks
    do the holdout work) (library reductions and the
    robust factories all qualify; refits sample under the fit's own
    likelihood).  Multi-term GLOBAL fits are supported: flagged points
    index the term-major concatenated axis (:func:`loo`'s), and each
    leave-out posterior keeps every term, with the held-out point
    removed by mask (:func:`_global_batched_refit`).
    :class:`~lisp_mcmc_tpu.HierarchicalFit` is supported the same way:
    flagged points index the dataset-major real-point axis, and each
    leave-out block refits the FULL joint non-centered posterior
    (hypers + every dataset) with that one point masked out of its
    stacked block (``HierarchicalFit._refit_cv``) — the
    pooled-vs-unpooled comparison this enables is the fit class's
    reason to exist.  The refits
    anneal then draw from a cold mala phase (``burn_fraction`` applies
    to that phase), so the "exact" values never see warm rows.  No
    reference analogue: the reference has no LOO machinery at all; this
    closes the reliability loop its ``pareto_k`` flags open.
    """
    if result is None:
        result = loo(walker, max_samples=max_samples)
    flagged = np.where(result.pareto_k > k_threshold)[0]
    if flagged.size == 0:
        return result
    if flagged.size > max_refits:
        raise ValueError(
            f"reloo: {flagged.size} points flagged (> max_refits="
            f"{max_refits}) — that many influential points means the "
            "model is misspecified; fix the likelihood instead of "
            "refitting around it")
    n = _refit_n_points(walker)
    refit, score_block = _batched_refit(
        walker, "reloo", [np.arange(n) != i for i in flagged],
        n_steps, temperature, walkers_per_dataset, burn_fraction,
        max_samples, seed)
    block_ok = grouped_refit_health(refit, "reloo")
    new_pointwise = result.pointwise.copy()
    new_k = result.pareto_k.copy()
    refit_failed = []
    for j, i in enumerate(flagged):
        if not block_ok[j]:
            # Keep the PSIS value AND its pareto_k flag: replacing a
            # flagged estimate with an unmixed block's "exact" one
            # would be a silent downgrade (VERDICT r4 #3).
            refit_failed.append(int(i))
            continue
        ll_i = score_block(j)[:, i]
        new_pointwise[i] = _logsumexp(ll_i) - np.log(ll_i.size)
        new_k[i] = 0.0
    n_pts = new_pointwise.size
    se = float(np.sqrt(n_pts * new_pointwise.var(ddof=1))) if n_pts > 1 else 0.0
    return LOOResult(
        elpd=float(new_pointwise.sum()),
        p_loo=float(result.lppd - new_pointwise.sum()),
        lppd=result.lppd, se=se, n_points=result.n_points,
        n_samples=result.n_samples, pointwise=new_pointwise, pareto_k=new_k,
        refit_failed=tuple(refit_failed),
    )


@dataclasses.dataclass(frozen=True)
class KFoldResult:
    """Exact K-fold cross-validation elpd.

    Duck-compatible with :class:`WAICResult`/:class:`LOOResult` where it
    matters: ``pointwise``/``n_points`` feed :func:`loo_compare`-style
    paired comparisons and :func:`model_weights`.
    """

    elpd: float
    se: float
    n_points: int
    n_samples: int
    k: int
    pointwise: np.ndarray
    folds: np.ndarray
    # Per-fold convergence gate verdicts (grouped_refit_health): a
    # False entry means that fold's refit failed to mix and its held-
    # out points' elpd entries are unreliable (kept, loudly warned,
    # marked here — never silently merged as healthy).
    fold_ok: np.ndarray | None = None

    def __repr__(self):
        return (f"KFoldResult(elpd={self.elpd:.3f} +- {self.se:.3f}, "
                f"k={self.k}, n_points={self.n_points}, "
                f"n_samples={self.n_samples})")


def kfold(walker, k: int = 10, folds=None, n_steps: int = 8000,
          temperature: float = 4.0, walkers_per_dataset: int = 64,
          burn_fraction: float = 0.33, max_samples: int = 512,
          seed: int = 0) -> KFoldResult:
    """Exact K-fold cross-validation: all K refits as ONE BatchedFit.

    The fallback when PSIS-LOO is unreliable wholesale (many Pareto-k
    flags — so many that :func:`reloo` rightly refuses): partition the
    points into ``k`` folds, fit each fold's complement, and score each
    held-out point against the posterior that never saw it

        elpd_i = log mean_s p(y_i | theta_s^{(-fold(i))}).

    Importance sampling never enters, so there is nothing left to
    diagnose — at the price of K refits, which here cost ONE vectorized
    ensemble run (fold-complement datasets are blocks of a single
    :class:`~lisp_mcmc_tpu.batched.BatchedFit`, the same chip-filling
    layout ``sbc_check`` and :func:`reloo` use; K fits ride one chunked
    scan, so on an accelerator this is nearly the cost of one fit).

    ``folds`` overrides the seeded random partition with explicit fold
    ids (length n, values 0..k-1) — use it for grouped/structured data
    (leave-one-segment-out over the term-major concatenated axis for
    global fits).  Same restrictions and refit recipe as :func:`reloo`
    (see :func:`_batched_refit`): likelihoods with a
    per-point form (the fit's own likelihood drives the refits),
    multi-term global fits via mask-based holdouts; anneal + cold mala
    phase.

    Reference: Vehtari, Gelman & Gabry (2017), section on K-fold CV.
    No reference-code analogue (the Lisp original has no cross-
    validation machinery at all).
    """
    n = _refit_n_points(walker)

    if folds is not None:
        folds = np.asarray(folds, np.int64)
        if folds.shape != (n,):
            raise ValueError(f"kfold: folds must have shape ({n},), "
                             f"got {folds.shape}")
        k = int(folds.max()) + 1
        if set(np.unique(folds)) != set(range(k)):
            raise ValueError("kfold: fold ids must cover 0..k-1")
    else:
        if not 2 <= k <= n // 2:
            raise ValueError(f"kfold: need 2 <= k <= n/2 = {n // 2}, got {k}")
        # seeded round-robin over a random permutation: fold sizes differ
        # by at most 1
        folds = np.empty(n, np.int64)
        folds[np.random.default_rng(seed).permutation(n)] = \
            np.arange(n) % k

    holdouts = []
    for j in range(k):
        keep = folds != j
        if not np.any(keep) or np.all(keep):
            raise ValueError(f"kfold: fold {j} is empty or everything")
        holdouts.append(keep)
    refit, score_block = _batched_refit(
        walker, "kfold", holdouts, n_steps, temperature,
        walkers_per_dataset, burn_fraction, max_samples, seed)
    fold_ok = grouped_refit_health(refit, "kfold")
    pointwise = np.empty(n)
    s_used = 0
    for j in range(k):
        ll = score_block(j)                            # (S, P)
        s_used = max(s_used, ll.shape[0])
        held = np.where(folds == j)[0]
        mx = ll[:, held].max(axis=0)
        pointwise[held] = mx + np.log(
            np.mean(np.exp(ll[:, held] - mx), axis=0))
    se = float(np.sqrt(n * pointwise.var(ddof=1))) if n > 1 else 0.0
    return KFoldResult(elpd=float(pointwise.sum()), se=se, n_points=int(n),
                       n_samples=int(s_used), k=int(k),
                       pointwise=pointwise, folds=folds, fold_ok=fold_ok)


def model_weights(results, method: str = "stacking",
                  seed: int = 0, n_boot: int = 1000) -> np.ndarray:
    """Model-averaging weights from WAIC/LOO results on the SAME data.

    Completes the comparison story: when no single model wins decisively,
    average their predictions instead of picking one.  Two methods
    (Yao, Vehtari, Simpson & Gelman 2018, "Using stacking to average
    Bayesian predictive distributions"):

    - ``"stacking"`` (default, recommended): maximize the pooled
      leave-one-out log score ``sum_i log sum_k w_k exp(elpd_ik)`` over
      the simplex — weights reflect how models COMBINE (two models each
      good on half the data both get weight even if one dominates on
      totals).  Concave; solved by projected ascent on a softmax
      parameterization.
    - ``"pseudo-bma+"``: Bayesian-bootstrap-regularized
      exp(elpd)-proportional weights — cheaper, but over-concentrates
      when models are similar.

    Pass >= 2 :class:`WAICResult`/:class:`LOOResult` (mixable — both
    carry per-point ``pointwise`` elpds).  Returns weights summing to 1
    in input order.
    """
    if len(results) < 2:
        raise ValueError("model_weights: need >= 2 models")
    n = results[0].n_points
    if any(r.n_points != n for r in results):
        raise ValueError("model_weights: models were scored on different "
                         f"data ({[r.n_points for r in results]} points)")
    elpd = np.stack([np.asarray(r.pointwise, np.float64) for r in results])

    if method == "pseudo-bma+":
        rng = np.random.default_rng(seed)
        # Bayesian bootstrap over points: Dirichlet(1) weights.
        alpha = rng.dirichlet(np.ones(n), size=n_boot)     # (B, n)
        totals = alpha @ elpd.T * n                        # (B, K)
        z = totals - totals.max(axis=1, keepdims=True)
        w = np.exp(z) / np.exp(z).sum(axis=1, keepdims=True)
        return w.mean(axis=0)

    if method != "stacking":
        raise ValueError(f"model_weights: unknown method {method!r}")
    # Projected gradient ascent on softmax(theta); objective is concave
    # in w and the simplex is tiny (K models), so this converges fast.
    k_models = elpd.shape[0]
    mx = elpd.max(axis=0)
    p = np.exp(elpd - mx)                                  # (K, n)
    theta = np.zeros(k_models)
    lr = 1.0
    for _ in range(2000):
        w = np.exp(theta - theta.max())
        w = w / w.sum()
        mix = w @ p                                        # (n,)
        grad_w = (p / mix).mean(axis=1)                    # d/dw mean log
        # Chain rule through softmax.
        grad_theta = w * (grad_w - float(w @ grad_w))
        theta_new = theta + lr * grad_theta
        theta = theta_new - theta_new.max()
    w = np.exp(theta)
    return w / w.sum()


def evidence_weights(results, log_prior_odds=None) -> np.ndarray:
    """Posterior model probabilities from marginal evidences (BMA).

    The evidence-side sibling of :func:`model_weights`: where stacking /
    pseudo-BMA+ weight models by *predictive* score (WAIC/LOO pointwise
    elpds), this is plain Bayesian model averaging —
    ``P(M_k | data) ∝ Z_k * P(M_k)`` — from any of the framework's five
    evidence estimators.  ``results``: floats (log Z) or any mix of
    objects carrying ``.log_z`` (``EvidenceResult``, ``LaplaceResult``,
    ``NestedResult``, ``SMCResult``, ``VIResult``, ``FlowVIResult``).
    ``log_prior_odds``: optional per-model log prior weights (default
    equal).  Returns probabilities summing to 1 in input order.

    Caveat the WAIC/LOO docstrings don't need: evidences depend on the
    declared PRIOR (an M-closed notion), so only compare models whose
    log_z share the framework convention (priors.py "Convention") — the
    per-dataset comparison columns in
    ``examples/scan_model_comparison.py`` do.
    """
    if len(results) < 2:
        raise ValueError("evidence_weights: need >= 2 models")
    vals = []
    for i, r in enumerate(results):
        try:
            vals.append(float(getattr(r, "log_z", r)))
        except (TypeError, ValueError):
            raise ValueError(
                f"evidence_weights: results[{i}] = {r!r} carries no log_z "
                "and is not a float — pass evidence results (Evidence/"
                "Laplace/Nested/SMC/VI/FlowVI) or raw log Z floats; "
                "WAIC/LOO results belong in model_weights") from None
    lz = np.asarray(vals, np.float64)
    if not np.all(np.isfinite(lz)):
        raise ValueError(f"evidence_weights: non-finite log_z in {lz}")
    if log_prior_odds is not None:
        lpo = np.asarray(log_prior_odds, np.float64)
        if lpo.shape != lz.shape:
            raise ValueError("evidence_weights: log_prior_odds must match "
                             f"results ({lpo.shape} vs {lz.shape})")
        lz = lz + lpo
    z = lz - lz.max()
    w = np.exp(z)
    return w / w.sum()
