"""Tempered Sequential Monte Carlo over the walker ensemble.

New capability beyond the reference: the walker ensemble IS a particle
population, so the classic tempered-SMC sampler (Del Moral, Doucet &
Jasra 2006) maps onto this framework with no new state — particles are
walkers, importance reweighting is a (W,) elementwise op, resampling is
a cumsum+searchsorted, and the MCMC move kernel is the existing chunked
runner held at the stage temperature through the runtime override
(kernel.py ``resolve_temp`` — a traced argument, so a fresh ``beta``
every stage costs no recompile).

Against MCMC annealing, SMC buys three things:
- **Population correctness on multimodal posteriors**: resampling keeps
  mass allocated by actual posterior weight, where annealed MH loses
  modes to whichever basin its walkers happen to cool into.
- **An evidence estimate for free**: ``log Z = sum_stages
  (logsumexp(dbeta * lp) - log W)`` under the same uniform-in-bounds
  ``beta = 0`` reference measure as evidence.py — the two estimators
  cross-check each other from entirely different machinery.
- **An adaptive schedule**: each ``dbeta`` is chosen by bisection so the
  relative effective sample size of the weights stays at
  ``target_ress`` — steep likelihoods automatically get dense
  temperature ladders.

The ``beta = 0`` population must SAMPLE the prior, so ``bounds`` is
required and the ensemble is re-drawn uniform in the box (the
reference-style flat-in-bounds prior; see evidence.py for the
measure-theoretic fine print).
"""

from __future__ import annotations

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["SMCResult", "smc_sample", "seed_prior_box"]


def seed_prior_box(walker, bounds, seed: int = 0):
    """Re-draw the walker ensemble uniform in the ``bounds`` box.

    Shared beta=0 initialization for :func:`smc_sample` and
    :func:`lisp_mcmc_tpu.evidence.log_evidence`: validates the box (every
    parameter present, ``high > low``), replaces positions with exact
    prior draws, and recomputes ``logprob``.  Returns the per-parameter
    ``(lows, highs)`` arrays.
    """
    import jax
    import jax.numpy as jnp

    spec_keys = list(walker.spec.keys)
    missing = [k for k in spec_keys if k not in bounds]
    if missing:
        raise ValueError(f"bounds required for every parameter; missing {missing}")
    dtype = walker.dtype
    lows = jnp.asarray([float(bounds[k][0]) for k in spec_keys], dtype)
    highs = jnp.asarray([float(bounds[k][1]) for k in spec_keys], dtype)
    if not bool(jnp.all(highs > lows)):
        raise ValueError("every bound must have high > low")
    k0 = jax.random.PRNGKey(seed)
    pos = lows + (highs - lows) * jax.random.uniform(
        k0, (walker.n_walkers, walker.ndim), dtype)
    walker.state = dataclasses.replace(walker.state, position=pos)
    lp = walker._eval_batch(pos)
    # The ensemble is replaced wholesale: retained history/accept traces
    # and best-step now describe a DIFFERENT (pre-SMC) run, and leaving
    # them would make steps()/diagnostics silently report stale samples
    # as posterior draws.  Drop them and restart best tracking at the
    # fresh draws.
    walker.reset()
    walker.state = dataclasses.replace(
        walker.state, logprob=lp, best_position=pos, best_logprob=lp)
    return lows, highs


@dataclasses.dataclass(frozen=True)
class SMCResult:
    """Realized SMC run: evidence, schedule, and per-stage health.

    For batched/grouped fits ``log_z_per_group`` holds each dataset's own
    evidence (the groups are independent fits, so ``log_z`` is their sum
    — the joint evidence) and the ladder is shared, chosen as the most
    conservative group's ``dbeta`` each stage.
    """

    log_z: float
    betas: np.ndarray          # realized ladder, 0 -> 1 inclusive
    acceptance: np.ndarray     # move acceptance per stage
    n_stages: int
    log_z_per_group: np.ndarray | None = None

    def __repr__(self):
        return (f"SMCResult(log_z={self.log_z:.4f}, n_stages={self.n_stages}, "
                f"final_acceptance={self.acceptance[-1]:.3f})")


def _next_beta(lp: np.ndarray, beta: float, target_ress: float) -> float:
    """Largest ``beta' <= 1`` whose incremental weights keep
    ``rESS >= target_ress``, by bisection on ``dbeta``."""

    def ress(dbeta: float) -> float:
        w = dbeta * (lp - lp.max())
        w = np.exp(w - w.max())
        return float(w.sum() ** 2 / (len(w) * (w * w).sum()))

    if ress(1.0 - beta) >= target_ress:
        return 1.0
    lo, hi = 0.0, 1.0 - beta
    for _ in range(50):
        mid = 0.5 * (lo + hi)
        if ress(mid) >= target_ress:
            lo = mid
        else:
            hi = mid
    return beta + max(lo, 1e-9)


def smc_sample(walker, bounds=None, n_move: int = 200, target_ress: float = 0.5,
               max_stages: int = 200, seed: int = 0, prior=None,
               target_moves: float | None = 120.0,
               on_stage=None) -> SMCResult:
    """Run tempered SMC; leaves the walker's ensemble ~ posterior.

    ``bounds``: ``{param: (low, high)}`` for EVERY parameter — defines
    the ``beta = 0`` uniform reference the particles start from (and the
    measure ``log_z`` is taken against).  ``prior``: a
    :class:`~lisp_mcmc_tpu.priors.PriorSpec` instead — named (Gaussian /
    log-normal / truncated) priors run the SAME schedule on the
    unit-cube view (:func:`~lisp_mcmc_tpu.fit.unit_cube_view`), where
    the declared prior is the beta=0 measure, so ``log_z`` is the true
    evidence integral ``L * pi``; one of the two is required (or a
    recoverable spec on the fitted terms).  ``n_move``: MCMC steps per
    stage (rounded up to whole chunks; the stage temperature rides the
    runtime override so every stage reuses one compiled runner).
    ``target_ress``: relative weight-ESS that picks each ``dbeta``.
    ``target_moves`` (the default policy): adaptive per-stage budget —
    after the ``n_move`` floor, keep stepping until the expected
    ACCEPTED moves per particle reach this count (capped at 10x the
    floor).  Fixed budgets under-serve exactly the sticky stages where
    diversity matters; measured on the stiff two-peak fit (4 seeds vs
    the Laplace anchor): fixed 200 -> log_z sd 43.7, fixed 800 ->
    sd 0.36 at 50 s/run, adaptive 120-over-200 -> sd 0.41 at 20 s/run —
    large-fixed-budget quality at 40% of its cost, and CHEAPER than the
    old fixed-400 default on easy stages (high acceptance reaches the
    target in one chunk).  ``target_moves=None`` restores a fixed
    ``n_move`` budget.

    ``on_stage(info)``: per-stage observability hook (the ``on_chunk``
    of this sampler): called at each stage boundary with ``{"stage",
    "beta", "dbeta", "acceptance", "moved", "chunks", "log_z_partial"}``;
    return True to request a graceful stop (raises like estop — a
    partial ladder is not a valid evidence).

    The walker's configured kernel drives the moves; per-stage
    L-adaptation runs as usual, so proposals re-tune as the target
    sharpens.  Raises if the schedule fails to reach ``beta = 1`` within
    ``max_stages``.
    """
    if not 0.0 < target_ress < 1.0:
        raise ValueError(f"target_ress must be in (0, 1), got {target_ress}")
    from .priors import resolve_prior_spec

    spec = resolve_prior_spec(walker, prior, bounds)
    if spec is None:
        raise ValueError("smc_sample: pass bounds= or prior= (no prior "
                         "recipe found on the fitted terms)")
    if not spec.is_uniform:
        from .fit import unit_cube_view

        uw = unit_cube_view(walker, spec, seed=seed)
        ubox = {k: (0.0, 1.0) for k in walker.spec.keys}
        result = smc_sample(uw, ubox, n_move=n_move, target_ress=target_ress,
                            max_stages=max_stages, seed=seed,
                            target_moves=target_moves, on_stage=on_stage)
        # Keep this function's contract: the ORIGINAL ensemble ends
        # posterior-distributed.  Map the u-particles back to theta and
        # install them with the same reset semantics as seed_prior_box.
        theta = uw._theta_of_u(uw.state.position).astype(walker.dtype)
        lp = walker._eval_batch(theta)
        walker.reset()
        walker.state = dataclasses.replace(
            walker.state, position=theta, logprob=lp,
            best_position=theta, best_logprob=lp)
        return result
    bounds = spec.bounds

    W = walker.n_walkers

    # Grouped (batched) fits: independent particle populations, one per
    # contiguous walker block.  Requires the regular block layout (the
    # one BatchedFit builds).
    G = getattr(walker, "n_groups", 1) or 1
    if G > 1:
        gids = np.asarray(walker.group_ids)
        B = W // G
        if not np.array_equal(gids, np.repeat(np.arange(G), B)):
            raise ValueError("smc_sample: grouped fits need contiguous "
                             "equal-size walker blocks per group")
    else:
        B = W

    # beta = 0 population: exact draws from the uniform-in-box prior.
    seed_prior_box(walker, bounds, seed=seed)
    key = jax.random.PRNGKey(seed + 1)

    runner = walker._runner(with_history=False)
    data = walker._posterior_data()
    chunk = walker.config.chunk_size
    n_chunks = max(1, -(-n_move // chunk))

    from . import control

    beta = 0.0
    log_z = np.zeros(G)
    betas, accs = [0.0], []
    for _ in range(max_stages):
        if control.stop_requested():
            # estop (mfit-walker-estop parity): stop at a stage boundary;
            # the partial result is still a valid SMC run up to `beta`,
            # but log_z only covers [0, beta] — raise rather than return
            # a silently-truncated evidence.
            raise RuntimeError(
                f"smc_sample: emergency stop at beta={beta:.4f}; "
                f"partial evidence discarded")
        lp_g = np.asarray(walker.state.logprob, np.float64).reshape(G, B)
        # Shared ladder: every group must keep its weight-ESS healthy, so
        # the stage takes the most conservative group's dbeta.
        new_beta = min(_next_beta(lp_g[g], beta, target_ress) for g in range(G))
        dbeta = new_beta - beta

        # Per-group evidence increments + within-block systematic resample.
        key, k_u = jax.random.split(key)
        u = np.asarray(jax.random.uniform(k_u, (G,)), np.float64)
        idx = np.empty((G, B), np.int64)
        for g in range(G):
            shifted = dbeta * (lp_g[g] - lp_g[g].max())
            w = np.exp(shifted)
            log_z[g] += math.log(w.mean()) + dbeta * lp_g[g].max()
            w /= w.sum()
            local = np.searchsorted(np.cumsum(w), (u[g] + np.arange(B)) / B)
            idx[g] = np.minimum(local, B - 1) + g * B
        idx = idx.reshape(-1)
        st = walker.state
        walker.state = dataclasses.replace(
            st,
            position=st.position[idx],
            logprob=st.logprob[idx],
        )

        # Diversify: MCMC move steps held at T = 1/beta via the runtime
        # temperature override (see kernel.resolve_temp).  With
        # target_moves set, keep stepping past the n_move floor until
        # the particles have actually MOVED that many times (expected
        # accepted moves/particle = sum of per-chunk acceptance x chunk)
        # — a fixed budget under-serves exactly the sticky stages where
        # diversity matters (measured on the stiff two-peak fit, 4 seeds:
        # n_move=200 -> log_z sd 43.7 / bias -30 vs the Laplace anchor;
        # 400 -> sd 1.8; 800 -> sd 0.36; adaptivity buys the tight
        # budget only where needed).
        temp_override = 1.0 / new_beta
        out = None
        acc_parts = []  # device scalars; no host sync until a decision
        chunks_done = 0
        while True:
            walker.state, out = runner(
                walker.state, True, True, temp_override, data)
            chunks_done += 1
            acc_parts.append(out["accept_rate"])
            if chunks_done < n_chunks:
                continue
            if target_moves is None or chunks_done >= 10 * n_chunks:
                # Fixed budget (or cap): exit without ever reading
                # acceptance back — a per-chunk float() here serialized
                # dispatch on a host round trip for nothing.
                break
            # Adaptive budget: one host read per decision, only past the
            # n_move floor where the decision actually exists.
            if float(sum(acc_parts)) * chunk >= target_moves:
                break
        moved = float(sum(acc_parts)) * chunk
        beta = new_beta
        betas.append(beta)
        accs.append(float(out["accept_rate"]))
        if on_stage is not None and on_stage({
                "stage": len(accs), "beta": beta, "dbeta": dbeta,
                "acceptance": accs[-1], "moved": moved,
                "chunks": chunks_done, "log_z_partial": float(log_z.sum())}):
            raise RuntimeError(
                f"smc_sample: on_stage requested stop at beta={beta:.4f}; "
                f"partial evidence discarded")
        if beta >= 1.0:
            break
    else:
        raise RuntimeError(
            f"smc_sample: beta reached only {beta:.4f} in {max_stages} "
            f"stages; raise max_stages or target_ress")

    return SMCResult(log_z=float(log_z.sum()), betas=np.asarray(betas),
                     acceptance=np.asarray(accs), n_stages=len(accs),
                     log_z_per_group=log_z.copy() if G > 1 else None)
