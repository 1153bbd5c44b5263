"""The adaptive Metropolis-Hastings kernel: a jitted, chunked ``lax.scan``.

This is the accelerator-native rebuild of the reference's hot loop
(mcmc-fitting.lisp):
  - ``walker-take-step`` (1072-1095): propose via ``mean + L @ z``, accept
    iff ``prob1 > prob0`` or ``(prob1-prob0)/T > log U(0,1)`` (1091-1092).
  - ``walker-pretend-take-step`` (1097-1122): the greedy variant (no
    temperature term) used by the region-sampling tuner.
  - ``walker-adaptive-steps-full`` (862-942): cosine-oscillating annealing
    (877-878), acceptance-window L adaptation every 200 steps with the
    0.2-0.4 band and x0.1 / x1.9 rescales (929-942), covariance refresh
    with the Haario ``2.38^2/d`` factor applied to L (888-895).

Accelerator-first redesign (SURVEY §3.2/§7): one chain's mutable do-loop
becomes a ``(W, d)`` walker *ensemble* advanced by a jitted ``lax.scan`` over a
200-step chunk.  Everything data-dependent inside the chunk is branchless
(``jnp.where``); adaptation happens at chunk boundaries inside the same
jit via masked updates, and the host driver (fit.py) only handles
auto-stop, logging, estop, and checkpointing between chunks — the device
never waits on Python during the hot loop.

Covariance adaptation on device: instead of the reference's covariance of
diffs-of-forward-steps from a filtered history list (543, 614), the kernel
accumulates first/second moments of *accepted proposal displacements*
pooled over walkers (the fixed-size on-device representation of "recent
accepted moves" — SURVEY §7 hard part b).  Under jit with chain-axis
sharding these reductions lower to the single allreduce BASELINE.json
specifies.

Adaptation *groups*: walkers may be partitioned into G groups (one per
spectrum in batched walker-set fits, nv-specific.lisp:58-66), each with
its own proposal factor and acceptance window.  When groups are
contiguous equal-size blocks (the batched-fit layout) the per-group
reductions are (G, B, ...) reshape-sums and the proposal is a (G, B, d)
einsum; per-step ``segment_sum`` scatter-adds and (W, d, d) gathers
remain only as the fallback for irregular groupings.  G=1 (the default)
is the plain single-fit ensemble.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Any, Callable

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from .ops.linalg import cholesky_clamped, haario_scale, moments_covariance

__all__ = ["FitConfig", "WalkerState", "init_state", "temperature_schedule",
           "build_chunk_runner", "resolve_accept_band"]


@dataclasses.dataclass(frozen=True)
class FitConfig:
    """All adaptation knobs, with the reference's exact defaults.

    Mirrors the keyword arguments + inline magic constants of
    ``walker-adaptive-steps-full`` (mcmc-fitting.lisp:862-942).  Frozen and
    hashable so it can be a jit static argument.
    """

    n_steps: int = 30000                 # walker-adaptive-steps default (946)
    temperature: float = 10.0            # wrapper default (947); -full default is 1d3 (862)
    chunk_size: int = 200                # adaptation cadence (929-931)
    accept_low: float = 0.2              # acceptance band (934)
    accept_high: float = 0.4
    scale_down: float = 0.1              # L rescale factors (940-942)
    scale_up: float = 1.9
    refresh_damping: float = 1.0         # rwm band-adaptation damping gamma in (0, 1]:
                                         # in-band refresh becomes the blend
                                         # (1-g)*L + g*candidate and out-of-band rescales
                                         # become scale^g.  1.0 = the reference's exact
                                         # hard jump/rescale (929-942), bit-identical.
                                         # At high d the hard policy limit-cycles
                                         # (~6-chunk acceptance cycles 0.3->0.96->0.3
                                         # measured at d=48, DESIGN.md "high-d rwm");
                                         # g~0.25 settles monotonically into the band.
    temp_period: int = 5000              # annealing divisor (878)
    settle_multiplier: int = 10          # steps-to-settle = 10*max(50, d) (873)
    settle_floor: int = 50
    kernel: str = "rwm"                  # "rwm" (reference MH) | "mala" (gradient-based
                                         # SAMPLING kernel: autodiff drift, ~7x ESS/step;
                                         # drift activates only at T=1 — anneal with rwm
                                         # first, then sample with mala at temperature=1)
                                         # | "stretch" (affine-invariant ensemble moves,
                                         # Goodman-Weare red-black: no proposal covariance
                                         # to adapt at all — walkers propose along lines
                                         # through complementary walkers, so anisotropy/
                                         # correlation handle themselves; sample_region
                                         # tuning is a no-op for it)
                                         # | "hmc" (Hamiltonian sampling kernel: leapfrog
                                         # in L-whitened coordinates, hmc_leapfrog grad
                                         # evals per step — highest ESS per step on smooth
                                         # targets; like mala, best used at temperature=1)
                                         # | "demc" (differential-evolution ensemble
                                         # moves, ter Braak 2006 red-black: propose along
                                         # the difference of two complementary walkers,
                                         # y = x + gamma (x_a - x_b); like stretch there
                                         # is no covariance to adapt, but the step
                                         # DIRECTION is a genuine ensemble-covariance
                                         # draw, so it holds up at high d where the
                                         # stretch move's single-line proposals thin out)
                                         # | "slice" (ensemble slice sampling, Karamanis-
                                         # Beutler 2021 red-black: Neal stepping-out +
                                         # shrinkage along a walker-pair difference
                                         # direction — gradient-free AND scale-free like
                                         # demc, but rejection-free: every step lands in
                                         # the slice, at the cost of a few posterior
                                         # evals per step)
                                         # | "chees" (ChEES-HMC, Hoffman-Radul-Sountsov
                                         # 2021: HMC whose trajectory LENGTH self-tunes
                                         # by on-device gradient ascent of the ChEES
                                         # criterion over the ensemble — the
                                         # SIMD-hardware answer to NUTS, whose recursive
                                         # tree doubling cannot batch.  Per step every
                                         # walker runs the SAME jittered leapfrog count,
                                         # so the bounded while_loop pays only the steps
                                         # actually taken; hmc_leapfrog seeds t)
    stretch_a: float = 2.0               # stretch-move scale a (z ~ g(z) on [1/a, a]);
                                         # lower toward 1 if acceptance collapses at high d
    demc_gamma: float = 0.0              # demc base scale; 0 = the 2.38/sqrt(2d)
                                         # optimal-scaling default (ter Braak 2006)
    demc_jitter: float = 0.1             # demc per-walker multiplicative scale jitter b:
                                         # gamma_i = gamma (1 + U(-b, b)) — breaks the
                                         # fixed-lattice degeneracy of exact gamma
    demc_jump_prob: float = 0.1          # probability of a gamma=1 "mode jump" step
                                         # (proposes the full difference vector — lets
                                         # walkers hop between modes the scaled move
                                         # cannot reach)
    slice_mu: float = 1.0                # slice direction scale: eta = mu (x_a - x_b);
                                         # the pair difference already carries the
                                         # ensemble covariance, so 1.0 is the zeus
                                         # default.  Raise if expansion exhausts its
                                         # budget (acceptance < 1), lower if shrinkage
                                         # iterates long on cheap posteriors
    slice_max_expand: int = 4            # stepping-out budget m (Neal 2003 fig 3:
                                         # J ~ U{0..m-1} left, m-1-J right — the
                                         # budgeted procedure stays exactly invariant);
                                         # interval can reach m units of |eta|
    slice_max_shrink: int = 32           # shrinkage-loop cap; an unfinished walker
                                         # stays put (counted: acceptance < 1 flags
                                         # budget pressure).  32 is measured on the
                                         # flagship's ridge-degenerate post-anneal
                                         # ensemble: landed 0.80/0.98/0.999 at
                                         # 16/24/32 for the SAME wall time (the
                                         # while_loop exits when everyone lands, so
                                         # headroom only costs when it is used)
    hmc_leapfrog: int = 8                # leapfrog steps per HMC proposal; also the
                                         # INITIAL trajectory length (in leapfrog
                                         # units) for kernel='chees'
    hmc_jitter: bool = True              # jitter trajectory length per step over
                                         # [hmc_leapfrog/2, hmc_leapfrog] (breaks
                                         # resonant orbits, Neal 2011 5.4.3.2)
    chees_max_leapfrog: int = 64         # chees trajectory-length budget (hard cap
                                         # on leapfrog steps per proposal; the
                                         # bounded while_loop's worst case).  The
                                         # adapted length t lives in [1, budget] —
                                         # raise it if Walker.chees_trajectory()
                                         # reports t pinned at the cap
    chees_lr: float = 0.025              # Adam learning rate on log t (the ChEES
                                         # paper's setting, Hoffman et al. 2021)
    rescue: bool = True                  # gradient kernels: independence-MH regeneration
                                         # round at chunk boundaries (teleports walkers
                                         # frozen by huge gradients back into the typical
                                         # set; adaptive move with O(1/W) invariance
                                         # error — see independence_rescue docstring —
                                         # ~1 extra posterior eval per chunk).  No-op for
                                         # rwm/stretch, whose stragglers mix on their own.
    tempering_rungs: int = 0             # >1 = parallel tempering SEARCH phase (new):
                                         # walker blocks hold a geometric T-ladder from 1
                                         # to `temperature`, replica swaps at chunk ends;
                                         # rungs double as adaptation groups
    tempering_betas: tuple = ()          # explicit ladder (descending from 1.0, one per
                                         # rung) overriding the geometric default —
                                         # Walker.tempered_steps(betas=/auto_ladder=)
                                         # sets it (tuple: configs are jit-cache keys)
    auto: str | None = "prob-settle"     # :prob-settle | :slope-settle (862) |
                                         # "rhat" (ensemble split-R-hat < 1.01, new) | None
    sampling_optimization: str = "covariance"  # L-refresh source: "covariance" | "best-value" (862, 888-895)
    refresh_every: int = 0               # in-band refresh cadence in steps; 0 = every
                                         # chunk (ensemble default — pooled moments make
                                         # one chunk a large sample; the reference's
                                         # single-chain cadence is 2*settle, 929-931)
    max_history: int = 30000             # max-walker-length analogue (923-927)
    max_history_bytes: int = 2 << 30     # hard byte cap on host history (positions +
                                         # logprobs); rows are dropped oldest-first once
                                         # either cap is hit.  2 GiB default keeps the
                                         # README quickstart at W=131072 host-safe.
    history_walkers: int = 4096          # keep host history for at most this many
                                         # walkers (evenly-spaced subsample, sliced ON
                                         # DEVICE before transfer); 0 = all walkers.
                                         # Full state stays on device regardless —
                                         # best-step, covariance, and acceptance use
                                         # every walker; only the retained trace is
                                         # subsampled.
    thin: int = 10                       # history thinning (device->host traffic)
    greedy: bool = False                 # pretend-take-step accept rule (1117)
    pooled_covariance: bool = True       # pool moments across the full ensemble
    covariance_source: str = "moves"     # "moves" (reference policy) | "ensemble"
    jitter: float = 0.0                  # optional diagonal jitter on refresh
    posterior_impl: str = "auto"         # "auto" (the XLA scan) | "pallas_chunk"
                                         # (whole-chunk GPU kernel, ops/chunk_pallas.py;
                                         # non-history chunks of ungrouped f32 rwm
                                         # fits only — everything else keeps the XLA
                                         # scan; raises off the GPU)
    prng_impl: str = "rbg"               # "rbg" | "threefry2x32"
    # Structured block-diagonal proposals (hierarchical scan grids,
    # VERDICT r3 #5): the walk space decomposes as one block_hyper-dim
    # hyper block followed by block_count equal block_local-dim local
    # blocks (d = block_hyper + block_count*block_local).  When
    # block_count > 0, the proposal applies L per block —
    # O(h^2 + S*dl^2) math per walker-step instead of O(d^2) — and the
    # covariance refresh masks cross-block entries before the Cholesky
    # (the true coupling of a non-centered hierarchy is hyper<->local
    # only; the dense estimate spends O(d^2) samples learning zeros).
    # Storage stays DENSE (G, d, d) with zero off-blocks, so every host
    # verb, checkpoint format, and the adapt/steering machinery work
    # unchanged.  Only the L-matrix kernels (rwm/mala/hmc/chees) use
    # it; stretch/demc/slice are L-free.  NOTE: rwm under blocking
    # refreshes from the ENSEMBLE covariance (positions at chunk
    # boundaries) instead of accepted-move moments — the per-step dense
    # (W, d, d) moment outer products are exactly the cost being
    # removed.
    block_hyper: int = 0
    block_local: int = 0
    block_count: int = 0

    def __post_init__(self):
        # Checkpoint JSON round-trips tuples as lists; configs key the
        # jit runner cache, so the field must come back hashable.
        if not isinstance(self.tempering_betas, tuple):
            object.__setattr__(self, "tempering_betas",
                               tuple(self.tempering_betas))
        if self.posterior_impl not in ("auto", "pallas_chunk"):
            raise ValueError(
                f"posterior_impl must be 'auto' or 'pallas_chunk', got "
                f"{self.posterior_impl!r}")
        if self.kernel not in ("rwm", "stretch", "demc", "mala", "hmc",
                               "slice", "chees"):
            # An unknown name would silently fall through to the rwm
            # dispatch — fail loudly instead.
            raise ValueError(
                f"kernel must be one of rwm/stretch/demc/mala/hmc/slice/"
                f"chees, got {self.kernel!r}")

    def steps_to_settle(self, ndim: int) -> int:
        return self.settle_multiplier * max(self.settle_floor, ndim)

    def temp_steps(self, ndim: int) -> int:
        # temp-steps = max(n, 10*steps-to-settle) (875)
        return max(self.n_steps, 10 * self.steps_to_settle(ndim))


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class WalkerState:
    """Ensemble chain state: the pytree that lives in the scan carry.

    The reference's mutable ``walker`` struct (mcmc-fitting.lisp:467-479)
    becomes this immutable batch-of-chains pytree; ``walker-modify``'s
    ``:add-step`` bookkeeping (549-555) becomes pure updates inside the
    scan.  ``W`` = walkers, ``d`` = parameters, ``G`` = adaptation groups.
    """

    key: Any               # PRNG key
    position: Any          # (W, d) current params
    logprob: Any           # (W,) current log-posterior
    best_position: Any     # (W, d) per-walker most-likely params (503-505)
    best_logprob: Any      # (W,)
    l_matrix: Any          # (G, d, d) per-group proposal factor
    m_sum: Any             # (G, d)  accepted-move moment accumulators
    m_outer: Any           # (G, d, d)
    m_count: Any           # (G,)   accepted moves per group
    age: Any               # ()     lifetime steps (walker-age, 473)
    anneal_step: Any = 0   # ()     per-run annealing index (reference's i, 919)
    chees: Any = 0         # (G, 4) ChEES trajectory-length adaptation state per
                           # group: [log(t / hmc_leapfrog), adam_m, adam_v,
                           # adam_step].  Zeros = fresh start at t=hmc_leapfrog;
                           # only kernel='chees' reads or writes it.


def init_state(key, position, logprob, l_matrix, n_groups: int = 1) -> WalkerState:
    """Build the initial ensemble state (``walker-create``'s first step).

    ``l_matrix`` may be (d, d) (broadcast to all groups) or (G, d, d).
    """
    W, d = position.shape
    dtype = position.dtype
    l_matrix = jnp.asarray(l_matrix, dtype)
    if l_matrix.ndim == 2:
        l_matrix = jnp.broadcast_to(l_matrix, (n_groups, d, d))
    return WalkerState(
        key=key,
        position=position,
        logprob=logprob,
        best_position=position,
        best_logprob=logprob,
        l_matrix=l_matrix,
        m_sum=jnp.zeros((n_groups, d), dtype),
        m_outer=jnp.zeros((n_groups, d, d), dtype),
        m_count=jnp.zeros((n_groups,), dtype),
        age=jnp.zeros((), jnp.int32),
        anneal_step=jnp.zeros((), jnp.int32),
        chees=jnp.zeros((n_groups, 4), dtype),
    )


def temperature_schedule(i, ndim: int, config: FitConfig):
    """The cosine-oscillating annealing temperature (mcmc-fitting.lisp:878).

    ``temps[i] = max(1, cos(i * pi * (1 + 2*floor(TS/5000)) / (2*TS)) * T)``
    for ``i < TS`` (TS = temp-steps); 1 afterwards.  The odd multiplier
    makes the argument hit a cos zero exactly at ``i = TS``; the ``max``
    clamps the negative lobes so temperature oscillates between 1 and T
    with a ~``temp_period`` half-period (920-921).
    """
    ts = config.temp_steps(ndim)
    mult = 1 + 2 * (ts // config.temp_period)
    phase = i * math.pi * mult / (2.0 * ts)
    t = jnp.maximum(1.0, jnp.cos(phase) * config.temperature)
    return jnp.where(i < ts, t, 1.0)


def _neg_floor(dtype):
    """Large-negative stand-in for -inf that keeps (lp1-lp0)/T finite."""
    return jnp.asarray(jnp.finfo(dtype).min / 4, dtype)


def resolve_accept_band(config: FitConfig) -> tuple[float, float]:
    """The adaptation acceptance band for the configured kernel.

    MALA's optimal acceptance is ~0.574 (vs ~0.234 for random walk), so
    the band shifts to (0.45, 0.7) when the user kept the reference
    defaults; HMC's optimum is ~0.65, band (0.55, 0.85).  Shared by the
    kernel's adapt step and the driver's auto-stop gate (which, like the
    reference's 0.2 < acc < 0.5 check at mcmc-fitting.lisp:911, allows
    band_high + 0.1).
    """
    low, high = config.accept_low, config.accept_high
    if not config.greedy and (low, high) == (0.2, 0.4):
        if config.kernel == "mala":
            return 0.45, 0.7
        if config.kernel in ("hmc", "chees"):
            return 0.55, 0.85
    return low, high


def build_chunk_runner(log_posterior: Callable, ndim: int, config: FitConfig,
                       group_ids=None, n_groups: int = 1, aux=None,
                       batched_posterior: Callable | None = None,
                       takes_data: bool = False,
                       pallas_chunk: Callable | None = None):
    """Compile the chunked MH scan for a given posterior.

    ``log_posterior`` evaluates ONE walker and is vmapped here over the
    ``(W, d)`` batch (one fused (W, N) elementwise block + masked sum per
    step).  Its signature depends on the build flags:
    ``(theta) -> scalar`` plain; ``(theta, aux_w)`` with ``aux``;
    ``(theta, data)`` with ``takes_data``; ``(theta, aux_w, data)`` with
    both.  ``takes_data`` passes the dataset pytree as a runtime ARGUMENT
    (never a trace constant), so one compiled chunk serves every
    same-shaped dataset.

    ``group_ids``: (W,) int32 mapping walkers to adaptation groups (None
    means one global group).  ``aux``: per-walker auxiliary pytree with
    leading axis W (e.g. spectrum indices for batched walker-set fits),
    closed over as a constant.  ``batched_posterior``: whole-batch
    override ``(positions (W, d), data) -> (W,)``.

    Returns ``(run, run_with_history)``; each maps
    ``(state, adapt_enabled, allow_refresh, force_cold=False, data=None)
    -> (state, out)``.  The three flags are traced booleans (no retrace on
    flips); ``data`` is required when built with ``takes_data``.
    """
    # ``takes_data``: the posterior receives the dataset pytree as a
    # runtime ARGUMENT (log_posterior(theta[, aux_w], data)) instead of a
    # closure constant, so one compiled chunk serves every same-shaped
    # dataset and the persistent compilation cache hits across data files.
    if batched_posterior is not None:
        # Whole-batch posterior: ``batched_posterior(positions, data) ->
        # (W,)``.  Used by structured ensembles (e.g. BatchedNVFit's
        # reshape-based per-spectrum evaluation, which avoids per-walker
        # data gathers).
        eval_lp = batched_posterior
    elif aux is None:
        if takes_data:
            batched_logpost = jax.vmap(log_posterior, in_axes=(0, None))
            eval_lp = lambda pos, data: batched_logpost(pos, data)
        else:
            batched_logpost = jax.vmap(log_posterior)
            eval_lp = lambda pos, data: batched_logpost(pos)
    else:
        if takes_data:
            batched_logpost = jax.vmap(log_posterior, in_axes=(0, 0, None))
            eval_lp = lambda pos, data: batched_logpost(pos, aux, data)
        else:
            batched_logpost = jax.vmap(log_posterior, in_axes=(0, 0))
            eval_lp = lambda pos, data: batched_logpost(pos, aux)

    chunk = config.chunk_size
    thin = max(1, min(config.thin, chunk))
    grouped = group_ids is not None and n_groups > 1
    # Contiguous equal-size groups (repeat(arange(G), B)) are the common
    # layout (one block of walkers per spectrum).  For them both the
    # per-group reductions and the per-walker L lookup become reshapes
    # instead of scatter-adds (segment_sum) and (W, d, d) gathers.
    group_block = None
    if grouped:
        gi = np.asarray(group_ids)
        W_g = gi.shape[0]
        if W_g % n_groups == 0:
            B = W_g // n_groups
            if (gi == np.repeat(np.arange(n_groups), B)).all():
                group_block = B
    if group_ids is not None:
        group_ids = jnp.asarray(group_ids, jnp.int32)

    def seg_sum(x):
        """Sum per adaptation group; plain sum when ungrouped (G=1)."""
        if grouped and group_block is not None:
            return jnp.sum(
                x.reshape((n_groups, group_block) + x.shape[1:]), axis=1
            )
        if grouped:
            return jax.ops.segment_sum(x, group_ids, num_segments=n_groups)
        total = jnp.sum(x, axis=0)
        return total[None]

    # Parallel tempering (new surface): each contiguous walker block is a
    # rung on a geometric temperature ladder T_k = temperature^(k/(K-1)),
    # rung 0 cold.  Rungs must coincide with the adaptation groups (the
    # caller synthesizes group_ids per rung) so each rung adapts its own
    # proposal scale.
    tempered = config.tempering_rungs > 1 and not config.greedy
    if tempered:
        if config.kernel in ("mala", "stretch", "hmc", "demc", "slice",
                             "chees"):
            raise ValueError("parallel tempering is a search phase; use kernel='rwm' "
                             "(sample afterwards with sampling_steps)")
        if group_block is None or n_groups != config.tempering_rungs:
            raise ValueError(
                "tempering requires contiguous equal walker blocks, one "
                "adaptation group per rung (use Walker.tempered_steps)"
            )
        K = config.tempering_rungs
        if config.tempering_betas:
            rung_betas_np = np.asarray(config.tempering_betas, np.float64)
            if rung_betas_np.shape != (K,):
                raise ValueError(
                    f"tempering_betas must have one entry per rung "
                    f"({K}), got {rung_betas_np.shape}")
            if rung_betas_np[0] != 1.0 or rung_betas_np[-1] <= 0.0 \
                    or np.any(np.diff(rung_betas_np) >= 0.0):
                raise ValueError(
                    "tempering_betas must strictly descend from 1.0 to > 0")
            rung_temps_np = 1.0 / rung_betas_np
        else:
            rung_temps_np = np.asarray(
                [config.temperature ** (k / (K - 1)) for k in range(K)],
                np.float64)
            rung_betas_np = 1.0 / rung_temps_np

    # Affine-invariant stretch moves (new surface, Goodman & Weare
    # 2010): each walker proposes along the line through a random walker of
    # the complementary half-ensemble, y = x_j + z (x_k - x_j) with
    # z ~ g(z) ∝ 1/sqrt(z) on [1/a, a], accepted with probability
    # min(1, z^(d-1) [pi(y)/pi(x)]^(1/T)).  The red-black scheme (update
    # half 0 against half 1, then half 1 against the UPDATED half 0) keeps
    # exact detailed balance — the walker ensemble the framework already
    # carries IS the proposal distribution, so there is no L-matrix to
    # adapt and the kernel is invariant to affine reparameterizations.
    stretch = config.kernel == "stretch" and not config.greedy
    # Differential-evolution ensemble moves (ter Braak 2006) share the
    # stretch kernel's red-black machinery: the active half proposes from
    # DIFFERENCES of two distinct complementary-half walkers,
    # y = x + gamma (x_a - x_b), a symmetric proposal (no z-Jacobian)
    # whose direction distribution IS the ensemble covariance — the
    # pair-difference trick that makes Haario-style adaptation free.
    demc = config.kernel == "demc" and not config.greedy
    # Ensemble slice sampling (Karamanis & Beutler 2021) rides the same
    # red-black machinery: the active half slices along walker-pair
    # DIFFERENCE directions of the complementary half (the differential
    # move), with Neal's budgeted stepping-out + shrinkage inside the
    # step — gradient-free, scale-free, and rejection-free.
    slice_k = config.kernel == "slice" and not config.greedy

    def _ensemble_span_check(name: str, b: int) -> None:
        """Ensemble moves live in the affine span of the start ensemble.

        Both red-black kernels propose within span(x_1..x_B): stretch
        along lines through pairs, demc along pair differences — B
        points span at most a (B-1)-dim affine subspace, so B <= ndim
        walkers per group sample a SLICE of the posterior while every
        per-coordinate health signal (spread, acceptance) looks fine.
        The zero-spread guard cannot catch it; this can.
        """
        if b - 1 < ndim:
            raise ValueError(
                f"{name} kernel: {b} walkers per group span at most a "
                f"{b - 1}-dim affine subspace of the {ndim}-dim "
                f"posterior — the fit would silently sample a slice. "
                f"Use > {ndim} (recommended >= {2 * ndim}) walkers per "
                "group, or the rwm/mala/hmc kernels")

    if stretch or demc or slice_k:
        if grouped and group_block is None:
            raise ValueError(
                f"{config.kernel} kernel needs contiguous equal-size walker "
                "blocks per adaptation group (complementary halves must stay "
                "within a group)"
            )

        def _half_eval(aux_half):
            """Per-walker posterior eval for one half-ensemble (flat (Wh, d))."""
            if aux_half is None:
                if takes_data:
                    f = jax.vmap(log_posterior, in_axes=(0, None))
                    return lambda pos, data: f(pos, data)
                f = jax.vmap(log_posterior)
                return lambda pos, data: f(pos)
            if takes_data:
                f = jax.vmap(log_posterior, in_axes=(0, 0, None))
                return lambda pos, data: f(pos, aux_half, data)
            f = jax.vmap(log_posterior, in_axes=(0, 0))
            return lambda pos, data: f(pos, aux_half)

        if batched_posterior is None and aux is not None:
            # aux leaves have leading axis W (concrete at build time): slice
            # them to the red/black halves once, in the grouped block layout
            # so ordering matches the flattened half positions.
            def _slice_aux(lo: bool):
                def sl(a):
                    a = jnp.asarray(a)
                    if grouped:
                        g = a.reshape((n_groups, group_block) + a.shape[1:])
                        bh = group_block // 2
                        g = g[:, :bh] if lo else g[:, bh:]
                        return g.reshape((-1,) + a.shape[1:])
                    h = a.shape[0] // 2
                    return a[:h] if lo else a[h:]
                return jax.tree_util.tree_map(sl, aux)

            _eval_lo = _half_eval(_slice_aux(True))
            _eval_hi = _half_eval(_slice_aux(False))
        elif batched_posterior is None:
            _eval_lo = _eval_hi = _half_eval(None)
        else:
            _eval_lo = _eval_hi = None  # full-ensemble fallback (see below)

    mala = config.kernel == "mala" and not config.greedy
    hmc = config.kernel == "hmc" and not config.greedy
    chees = config.kernel == "chees" and not config.greedy
    # Everything the gradient kernels share (autodiff surface, typical-set
    # covariance refresh, step-size steering, independence rescue).
    gradk = mala or hmc or chees
    if gradk:
        # Per-walker value+gradient of the posterior (the autodiff surface
        # the Lisp reference could never have).
        if batched_posterior is not None:
            def eval_vg(pos, data):
                lp, vjp = jax.vjp(lambda p: batched_posterior(p, data), pos)
                (g,) = vjp(jnp.ones_like(lp))
                return lp, g
        elif aux is None:
            if takes_data:
                _vg = jax.vmap(jax.value_and_grad(log_posterior), in_axes=(0, None))
                eval_vg = lambda pos, data: _vg(pos, data)
            else:
                _vg = jax.vmap(jax.value_and_grad(log_posterior))
                eval_vg = lambda pos, data: _vg(pos)
        else:
            if takes_data:
                _vg = jax.vmap(jax.value_and_grad(log_posterior), in_axes=(0, 0, None))
                eval_vg = lambda pos, data: _vg(pos, aux, data)
            else:
                _vg = jax.vmap(jax.value_and_grad(log_posterior), in_axes=(0, 0))
                eval_vg = lambda pos, data: _vg(pos, aux)

    accept_low, accept_high = resolve_accept_band(config)

    # Full f32 in every L apply: rwm's symmetric step would survive TF32,
    # but MALA/HMC/rescue densities assume the exact L z and L^T g.
    hi = lax.Precision.HIGHEST

    def mul_l(l_matrix, v):
        """L @ v per walker, respecting the grouping layout."""
        if grouped and group_block is not None:
            v_g = v.reshape(n_groups, group_block, ndim)
            return jnp.einsum("gij,gbj->gbi", l_matrix, v_g,
                              precision=hi).reshape(v.shape)
        if grouped:
            return jnp.einsum("wij,wj->wi", l_matrix[group_ids], v, precision=hi)
        return jnp.einsum("ij,wj->wi", l_matrix[0], v, precision=hi)

    def mul_lt(l_matrix, v):
        """L^T @ v per walker."""
        if grouped and group_block is not None:
            v_g = v.reshape(n_groups, group_block, ndim)
            return jnp.einsum("gji,gbj->gbi", l_matrix, v_g,
                              precision=hi).reshape(v.shape)
        if grouped:
            return jnp.einsum("wji,wj->wi", l_matrix[group_ids], v, precision=hi)
        return jnp.einsum("ji,wj->wi", l_matrix[0], v, precision=hi)

    # ---- structured block-diagonal proposal operators (config.block_*) ----
    # The PROPOSAL call sites (state.l_matrix only) ride mul_L/mul_Lt;
    # the rescue move keeps the dense mul_l for its own full-covariance
    # q — an independence sampler benefits from the cross-block
    # correlations, and its O(d^2) cost is per CHUNK, not per step.
    # Block fields are simply INERT for the L-free kernels (stretch/
    # demc/slice have no L to structure): a blocked HierarchicalFit can
    # sampling_steps(kernel="slice") without unsetting anything — the
    # review r4 regression was raising here, which broke kernel
    # switching on every auto-blocked large fit.
    blocked = (config.block_count > 0
               and config.kernel in ("rwm", "mala", "hmc", "chees"))
    if blocked:
        b_h, b_l, n_b = (config.block_hyper, config.block_local,
                         config.block_count)
        if b_h + n_b * b_l != ndim:
            raise ValueError(
                f"block layout {b_h} + {n_b}*{b_l} != ndim={ndim}")
        if grouped and group_block is None:
            raise ValueError(
                "blocked proposals need contiguous equal-size walker "
                "groups (or a single group)")
        _bm = np.zeros((ndim, ndim))
        _bm[:b_h, :b_h] = 1.0
        for _s in range(n_b):
            _i0 = b_h + _s * b_l
            _bm[_i0:_i0 + b_l, _i0:_i0 + b_l] = 1.0
        block_mask = jnp.asarray(_bm)

        def _l_blocks(l):
            """Dense (G, d, d) block-diagonal L -> per-block factors.

            The diagonal-block extraction is an einsum with a repeated
            index (a strided gather of G*S*dl^2 elements — no (S, dl,
            S, dl) intermediate materializes).
            """
            g_ = l.shape[0]
            l_h = l[:, :b_h, :b_h]
            l_loc = jnp.einsum(
                "gsisj->gsij",
                l[:, b_h:, b_h:].reshape(g_, n_b, b_l, n_b, b_l))
            return l_h, l_loc

        def _blocked_apply(l, v, trans: bool):
            l_h, l_loc = _l_blocks(l)
            if grouped and group_block is not None:
                v_g = v.reshape(n_groups, group_block, ndim)
                parts = []
                if b_h:
                    parts.append(jnp.einsum(
                        "gji,gbj->gbi" if trans else "gij,gbj->gbi",
                        l_h, v_g[..., :b_h], precision=hi))
                e_l = jnp.einsum(
                    "gsji,gbsj->gbsi" if trans else "gsij,gbsj->gbsi",
                    l_loc,
                    v_g[..., b_h:].reshape(n_groups, group_block, n_b, b_l),
                    precision=hi)
                parts.append(e_l.reshape(n_groups, group_block, n_b * b_l))
                return jnp.concatenate(parts, axis=-1).reshape(v.shape)
            w_ = v.shape[0]
            parts = []
            if b_h:
                parts.append(jnp.einsum(
                    "ji,wj->wi" if trans else "ij,wj->wi",
                    l_h[0], v[:, :b_h], precision=hi))
            e_l = jnp.einsum(
                "sji,wsj->wsi" if trans else "sij,wsj->wsi",
                l_loc[0], v[:, b_h:].reshape(w_, n_b, b_l), precision=hi)
            parts.append(e_l.reshape(w_, n_b * b_l))
            return jnp.concatenate(parts, axis=-1)

        # Per-block einsums on every backend: on the CPU they beat one
        # dense (W, d) @ (d, d) product by 2.7x at S=8 and 33x at S=32;
        # on the H100 at W=256 the two applies time within run-to-run
        # noise of each other up to S=64 (PERF.md), so one path serves
        # both.  LISP_MCMC_BLOCK_APPLY=0 forces the dense apply, for
        # benchmarks that compare the two.
        _blocked_apply_on = os.environ.get("LISP_MCMC_BLOCK_APPLY") != "0"
        if not _blocked_apply_on:
            mul_L, mul_Lt = mul_l, mul_lt
        else:
            mul_L = lambda l, v: _blocked_apply(l, v, False)
            mul_Lt = lambda l, v: _blocked_apply(l, v, True)
    else:
        block_mask = None
        mul_L, mul_Lt = mul_l, mul_lt

    def _apply_step(state, key, proposal, lp_prop, step_vec, accept,
                    accumulate_moments: bool):
        """Shared accept/update tail: position, bookkeeping, best tracking.

        ``accumulate_moments`` is off for the gradient kernels (their
        refresh uses the typical-set ensemble covariance, so the moments
        would be an O(W d^2) dead weight per step) and for stretch (no
        proposal state to adapt at all).
        """
        dtype = state.position.dtype
        acc = accept[:, None]
        accf = accept.astype(dtype)
        new_position = jnp.where(acc, proposal, state.position)
        new_logprob = jnp.where(accept, lp_prop, state.logprob)

        if accumulate_moments:
            # Accepted-move moments for covariance adaptation, per group.
            delta = step_vec * acc.astype(dtype)
            m_sum = state.m_sum + seg_sum(delta)
            m_outer = state.m_outer + seg_sum(delta[:, :, None] * delta[:, None, :])
            m_count = state.m_count + seg_sum(accf)
        else:
            m_sum, m_outer, m_count = state.m_sum, state.m_outer, state.m_count

        # Most-likely-step tracking (553-555), per walker.
        better = new_logprob > state.best_logprob
        best_position = jnp.where(better[:, None], new_position, state.best_position)
        best_logprob = jnp.where(better, new_logprob, state.best_logprob)

        new_state = WalkerState(
            key=key,
            position=new_position,
            logprob=new_logprob,
            best_position=best_position,
            best_logprob=best_logprob,
            l_matrix=state.l_matrix,
            m_sum=m_sum,
            m_outer=m_outer,
            m_count=m_count,
            age=state.age + 1,
            anneal_step=state.anneal_step + 1,
            chees=state.chees,
        )
        out = {
            "logprob_max": jnp.max(new_logprob),
            "logprob_mean": jnp.mean(new_logprob),
            "logprob_min": jnp.min(new_logprob),
        }
        return new_state, accf, out

    def resolve_temp(force_cold, state, dtype):
        """``force_cold`` doubles as a numeric temperature override.

        True (== 1.0) pins T=1 — the reference's shutdown phase and
        walker-many-steps both sample the *untempered* posterior
        (mcmc-fitting.lisp:915-917, 849-853).  Any float > 0 pins that
        temperature instead (the SMC driver holds each stage at its own
        1/beta without recompiling — the override rides the traced
        argument, not the config).  False (== 0.0) follows the annealing
        schedule, which is indexed by the per-run counter (reset by the
        driver at the start of each adaptive run), matching the
        reference's do-loop i (mcmc-fitting.lisp:902,919-921) — NOT
        lifetime age.
        """
        tover = jnp.asarray(force_cold, dtype)
        return jnp.where(
            tover > 0, tover,
            temperature_schedule(state.anneal_step, ndim, config).astype(dtype),
        )

    def one_step(carry, i, data=None):
        state, accept_counts, force_cold = carry
        dtype = state.position.dtype
        key, k_prop, k_accept = jax.random.split(state.key, 3)
        if tempered:
            # Static per-walker temperature ladder (rung blocks), not the
            # annealing schedule; the cold finish still pins T=1 (and a
            # numeric override pins every rung to that temperature).
            ladder = jnp.repeat(
                jnp.asarray(rung_temps_np, dtype), group_block, total_repeat_length=state.position.shape[0]
            )
            tover = jnp.asarray(force_cold, dtype)
            temp = jnp.where(tover > 0, tover, ladder)
        else:
            temp = resolve_temp(force_cold, state, dtype)

        z = jax.random.normal(k_prop, state.position.shape, dtype)
        step_vec = mul_L(state.l_matrix, z)
        proposal = state.position + step_vec
        lp_prop = eval_lp(proposal, data)
        # NaN/Inf guard: the walker-check-for-complex-walks analogue (483)
        # — a non-finite posterior is treated as "reject hard".
        lp_prop = jnp.where(jnp.isfinite(lp_prop), lp_prop, _neg_floor(dtype))

        log_u = jnp.log(jax.random.uniform(k_accept, state.logprob.shape, dtype))
        if config.greedy:
            # walker-pretend-take-step accept rule (1117-1119)
            accept = lp_prop > state.logprob
        else:
            # walker-take-step accept rule (1091-1092)
            accept = (lp_prop > state.logprob) | ((lp_prop - state.logprob) / temp > log_u)

        new_state, accf, out = _apply_step(
            state, key, proposal, lp_prop, step_vec, accept, not blocked
        )
        return (new_state, accept_counts + accf, force_cold), out

    def one_step_stretch(carry, i, data=None):
        """Affine-invariant stretch step (kernel='stretch'), red-black.

        One scan step = one full-ensemble update: the low half proposes
        against the high half, then the high half proposes against the
        *updated* low half (the sequential two-phase scheme that keeps the
        Goodman-Weare move exact).  Cost per step matches rwm — two half-
        ensemble posterior evaluations instead of one full one.  Grouped
        ensembles (batched fits) pair strictly within their own group
        block, so every proposal stays on its own dataset's posterior.
        """
        state, accept_counts, force_cold = carry
        dtype = state.position.dtype
        key, k_lo, k_hi = jax.random.split(state.key, 3)
        temp = resolve_temp(force_cold, state, dtype)

        W = state.position.shape[0]
        if grouped and group_block is not None:
            G, B = n_groups, group_block
        else:
            G, B = 1, W
        if B % 2:
            raise ValueError(
                "stretch kernel needs an even number of walkers per group"
            )
        _ensemble_span_check("stretch", B)
        Bh = B // 2
        pos = state.position.reshape(G, B, ndim)
        lp = state.logprob.reshape(G, B)
        a = config.stretch_a

        def half(k, xk, lpk, comp, eval_fn, lo: bool):
            kj, kz, ka = jax.random.split(k, 3)
            j = jax.random.randint(kj, lpk.shape, 0, Bh)
            xj = jnp.take_along_axis(comp, j[..., None], axis=1)     # (G,Bh,d)
            u = jax.random.uniform(kz, lpk.shape, dtype)
            # Inverse-CDF draw of g(z) ∝ 1/sqrt(z) on [1/a, a].
            z = ((a - 1.0) * u + 1.0) ** 2 / a
            prop = xj + z[..., None] * (xk - xj)
            if eval_fn is not None:
                lp_prop = eval_fn(prop.reshape(-1, ndim), data).reshape(lpk.shape)
            else:
                # Structured whole-batch posterior (shape-specialized to the
                # full ensemble): evaluate the full batch with the active
                # half replaced by its proposals and slice the active part.
                halves = [prop, comp] if lo else [comp, prop]
                full = jnp.concatenate(halves, axis=1).reshape(-1, ndim)
                lp_full = batched_posterior(full, data).reshape(G, B)
                lp_prop = lp_full[:, :Bh] if lo else lp_full[:, Bh:]
            lp_prop = jnp.where(jnp.isfinite(lp_prop), lp_prop, _neg_floor(dtype))
            log_alpha = (ndim - 1.0) * jnp.log(z) + (lp_prop - lpk) / temp
            acc = jnp.log(jax.random.uniform(ka, lpk.shape, dtype)) < log_alpha
            return prop, lp_prop, acc

        x_lo, l_lo = pos[:, :Bh], lp[:, :Bh]
        x_hi, l_hi = pos[:, Bh:], lp[:, Bh:]
        p_lo, lp_lo, a_lo = half(k_lo, x_lo, l_lo, x_hi, _eval_lo, True)
        x_lo_new = jnp.where(a_lo[..., None], p_lo, x_lo)
        p_hi, lp_hi, a_hi = half(k_hi, x_hi, l_hi, x_lo_new, _eval_hi, False)

        proposal = jnp.concatenate([p_lo, p_hi], axis=1).reshape(W, ndim)
        lp_prop = jnp.concatenate([lp_lo, lp_hi], axis=1).reshape(W)
        accept = jnp.concatenate([a_lo, a_hi], axis=1).reshape(W)
        new_state, accf, out = _apply_step(
            state, key, proposal, lp_prop, proposal - state.position, accept, False
        )
        return (new_state, accept_counts + accf, force_cold), out

    def one_step_demc(carry, i, data=None):
        """Differential-evolution step (kernel='demc'), red-black.

        Each active-half walker k draws two DISTINCT complementary-half
        walkers a, b and proposes

            y = x_k + gamma_k (x_a - x_b)

        with gamma_k = gamma (1 + U(-b, b)) and, with probability
        ``demc_jump_prob``, gamma_k = 1 exactly (the mode-jump move: a
        full difference vector can carry a walker between modes whose
        separation matches the ensemble spread).  The difference of two
        ensemble members is a draw whose covariance is 2 Sigma_ensemble,
        so gamma = 2.38/sqrt(2d) reproduces Haario optimal scaling with
        no covariance estimation, no Cholesky, and affine invariance —
        like stretch, but with full-rank step directions (a stretch
        proposal moves along ONE line through x_j; at high d that
        single-direction thinning is what collapses its acceptance).
        The proposal is symmetric given the (fixed) complementary half,
        so acceptance is the plain tempered MH ratio; the red-black
        update order (low half against high, high against UPDATED low)
        keeps the move exact, as for stretch.

        Sharding note: unlike rwm/mala/stretch (bitwise-identical
        sharded vs unsharded, test_parallel.py), demc is *statistically*
        but not bitwise sharding-invariant — XLA's fusion choices for
        this graph differ between partitionings by 1-ULP rounding
        (measured: input-dependent, flips with unrelated graph edits),
        which chaos-amplifies over a chunk.  Same random stream, same
        distribution, different trajectories.
        """
        state, accept_counts, force_cold = carry
        dtype = state.position.dtype
        key, k_lo, k_hi = jax.random.split(state.key, 3)
        temp = resolve_temp(force_cold, state, dtype)

        W = state.position.shape[0]
        if grouped and group_block is not None:
            G, B = n_groups, group_block
        else:
            G, B = 1, W
        if B % 2:
            raise ValueError(
                "demc kernel needs an even number of walkers per group"
            )
        _ensemble_span_check("demc", B)
        Bh = B // 2
        if Bh < 2:
            raise ValueError(
                "demc kernel needs >= 4 walkers per group (two distinct "
                "complementary donors per proposal)"
            )
        pos = state.position.reshape(G, B, ndim)
        lp = state.logprob.reshape(G, B)
        gamma0 = config.demc_gamma if config.demc_gamma > 0.0 else (
            2.38 / math.sqrt(2.0 * ndim))

        def half(k, xk, lpk, comp, eval_fn, lo: bool):
            kj, kg, kjump, ka = jax.random.split(k, 4)
            # Two distinct donors: j2 = (j1 + 1 + U[0, Bh-2]) mod Bh.
            j = jax.random.randint(kj, lpk.shape + (2,), 0,
                                   jnp.asarray([Bh, Bh - 1]))
            j1 = j[..., 0]
            j2 = (j1 + 1 + j[..., 1]) % Bh
            xa = jnp.take_along_axis(comp, j1[..., None], axis=1)
            xb = jnp.take_along_axis(comp, j2[..., None], axis=1)
            b = config.demc_jitter
            u = jax.random.uniform(kg, lpk.shape, dtype, 1.0 - b, 1.0 + b)
            jump = jax.random.uniform(kjump, lpk.shape, dtype) < config.demc_jump_prob
            gamma = jnp.where(jump, jnp.asarray(1.0, dtype), gamma0 * u)
            prop = xk + gamma[..., None] * (xa - xb)
            if eval_fn is not None:
                lp_prop = eval_fn(prop.reshape(-1, ndim), data).reshape(lpk.shape)
            else:
                halves = [prop, comp] if lo else [comp, prop]
                full = jnp.concatenate(halves, axis=1).reshape(-1, ndim)
                lp_full = batched_posterior(full, data).reshape(G, B)
                lp_prop = lp_full[:, :Bh] if lo else lp_full[:, Bh:]
            lp_prop = jnp.where(jnp.isfinite(lp_prop), lp_prop, _neg_floor(dtype))
            log_alpha = (lp_prop - lpk) / temp
            acc = jnp.log(jax.random.uniform(ka, lpk.shape, dtype)) < log_alpha
            return prop, lp_prop, acc

        x_lo, l_lo = pos[:, :Bh], lp[:, :Bh]
        x_hi, l_hi = pos[:, Bh:], lp[:, Bh:]
        p_lo, lp_lo, a_lo = half(k_lo, x_lo, l_lo, x_hi, _eval_lo, True)
        x_lo_new = jnp.where(a_lo[..., None], p_lo, x_lo)
        p_hi, lp_hi, a_hi = half(k_hi, x_hi, l_hi, x_lo_new, _eval_hi, False)

        proposal = jnp.concatenate([p_lo, p_hi], axis=1).reshape(W, ndim)
        lp_prop = jnp.concatenate([lp_lo, lp_hi], axis=1).reshape(W)
        accept = jnp.concatenate([a_lo, a_hi], axis=1).reshape(W)
        new_state, accf, out = _apply_step(
            state, key, proposal, lp_prop, proposal - state.position, accept, False
        )
        return (new_state, accept_counts + accf, force_cold), out

    def one_step_slice(carry, i, data=None):
        """Ensemble slice step (kernel='slice'), red-black.

        Ensemble slice sampling (Karamanis & Beutler 2021, the "zeus"
        algorithm; no analogue in the reference — mcmc-fitting.lisp has
        one MH rule at 1091-1092): each active-half walker draws a
        DIFFERENCE direction from two distinct complementary-half
        walkers, eta = mu (x_a - x_b) — the demc differential move, so
        the direction distribution is the ensemble covariance and the
        kernel is affine-invariant with nothing to adapt — then runs
        univariate slice sampling along t in x + t eta on the tempered
        target:

        1. level:    log y = log pi(x)/T - Exp(1)
        2. interval: [L, L+1) placed uniformly around t=0, stepped OUT
           with Neal's (2003, fig 3) budgeted procedure — J ~ U{0..m-1}
           left expansions, m-1-J right — which is exactly invariant at
           ANY budget m (the random budget split is what makes the
           truncated interval reversible).
        3. shrink:   t ~ U(L, R); accept if inside the slice, else the
           interval shrinks toward 0 and redraws, up to
           ``slice_max_shrink`` times.

        Every draw inside the slice is accepted — no MH rejection — so
        one slice step costs a handful of half-ensemble evaluations
        (while_loops bound the cost: expansion stops when every walker's
        interval is bracketed, shrinkage when every walker has landed)
        and "acceptance" here reports the fraction of walkers whose
        shrink loop LANDED (stragglers stay put; sustained < 1 means
        raise the budgets or lower ``slice_mu``).  The red-black order
        (low half against high, high against the UPDATED low) keeps the
        move exact, as for stretch/demc; like demc the kernel is
        statistically but not bitwise sharding-invariant.
        """
        state, accept_counts, force_cold = carry
        dtype = state.position.dtype
        key, k_lo, k_hi = jax.random.split(state.key, 3)
        temp = resolve_temp(force_cold, state, dtype)

        W = state.position.shape[0]
        if grouped and group_block is not None:
            G, B = n_groups, group_block
        else:
            G, B = 1, W
        if B % 2:
            raise ValueError(
                "slice kernel needs an even number of walkers per group"
            )
        _ensemble_span_check("slice", B)
        Bh = B // 2
        if Bh < 2:
            raise ValueError(
                "slice kernel needs >= 4 walkers per group (two distinct "
                "complementary donors per direction)"
            )
        pos = state.position.reshape(G, B, ndim)
        lp = state.logprob.reshape(G, B)
        mu = jnp.asarray(config.slice_mu, dtype)
        m_exp = int(config.slice_max_expand)
        m_shr = int(config.slice_max_shrink)

        def half(k, xk, lpk, comp, eval_fn, lo: bool):
            kj, ke, ki, kjk, kshr = jax.random.split(k, 5)
            # Differential direction from two distinct donors (as demc).
            j = jax.random.randint(kj, lpk.shape + (2,), 0,
                                   jnp.asarray([Bh, Bh - 1]))
            j1 = j[..., 0]
            j2 = (j1 + 1 + j[..., 1]) % Bh
            raw = (jnp.take_along_axis(comp, j1[..., None], axis=1)
                   - jnp.take_along_axis(comp, j2[..., None], axis=1))
            # Outlier-donor clamp: a straggler-tail pair difference can be
            # ~1e6x the typical spread, and the shrink loop pays
            # log2(|eta|/slice width) draws — measured on the flagship's
            # post-anneal ensemble: unclamped landed fraction 0.67 at
            # budget 16 and still 0.86 at 64.  Clamping outlier norms to
            # 3x the group median (a function of the FIXED complementary
            # half only, so exactness is untouched) restores ~1 at the
            # default budget without shrinking typical directions.
            nrm = jnp.linalg.norm(raw, axis=-1)                    # (G,Bh)
            med = jnp.median(nrm, axis=1, keepdims=True)           # (G,1)
            floor = jnp.asarray(jnp.finfo(dtype).tiny, dtype)
            clip = jnp.minimum(1.0, 3.0 * med / jnp.maximum(nrm, floor))
            eta = mu * raw * clip[..., None]

            def eval_at(t):
                cand = xk + t[..., None] * eta
                if eval_fn is not None:
                    lpc = eval_fn(cand.reshape(-1, ndim), data).reshape(lpk.shape)
                else:
                    halves = [cand, comp] if lo else [comp, cand]
                    full = jnp.concatenate(halves, axis=1).reshape(-1, ndim)
                    lp_full = batched_posterior(full, data).reshape(G, B)
                    lpc = lp_full[:, :Bh] if lo else lp_full[:, Bh:]
                return jnp.where(jnp.isfinite(lpc), lpc, _neg_floor(dtype))

            # Slice level on the tempered target.
            e = -jnp.log(jax.random.uniform(ke, lpk.shape, dtype))
            log_y = lpk / temp - e

            # Unit interval placed uniformly around t=0; Neal budget split.
            u0 = jax.random.uniform(ki, lpk.shape, dtype)
            L = -u0
            R = L + 1.0
            if m_exp > 1:
                jmax = jax.random.randint(kjk, lpk.shape, 0, m_exp)
                kmax = (m_exp - 1) - jmax

                def expand_body(c):
                    L, R, jb, kb, it = c
                    lp_l = eval_at(L)
                    lp_r = eval_at(R)
                    grow_l = (jb > 0) & (lp_l / temp > log_y)
                    grow_r = (kb > 0) & (lp_r / temp > log_y)
                    L = jnp.where(grow_l, L - 1.0, L)
                    R = jnp.where(grow_r, R + 1.0, R)
                    # Budget zeroes on the first non-grow: the while-loop
                    # semantics of Neal's procedure, not a running mask.
                    jb = jnp.where(grow_l, jb - 1, 0)
                    kb = jnp.where(grow_r, kb - 1, 0)
                    return (L, R, jb, kb, it + 1)

                def expand_cond(c):
                    _, _, jb, kb, it = c
                    return ((it < m_exp - 1)
                            & (jnp.any(jb > 0) | jnp.any(kb > 0)))

                L, R, _, _, _ = lax.while_loop(
                    expand_cond, expand_body,
                    (L, R, jmax, kmax, jnp.asarray(0, jnp.int32)))

            # Shrinkage: t_sel starts at 0 (== stay at x) and lp_sel at
            # the current logprob, so budget stragglers degrade to a
            # rejected step instead of leaving the slice.
            def shrink_body(c):
                Lh, Rh, t_sel, lp_sel, done, ks, it = c
                ks, k1 = jax.random.split(ks)
                u = jax.random.uniform(k1, lpk.shape, dtype)
                t = Lh + u * (Rh - Lh)
                lpc = eval_at(t)
                ok = lpc / temp > log_y
                newly = ok & ~done
                t_sel = jnp.where(newly, t, t_sel)
                lp_sel = jnp.where(newly, lpc, lp_sel)
                still = ~(done | ok)
                Lh = jnp.where(still & (t < 0.0), t, Lh)
                Rh = jnp.where(still & (t >= 0.0), t, Rh)
                return (Lh, Rh, t_sel, lp_sel, done | ok, ks, it + 1)

            def shrink_cond(c):
                done, it = c[4], c[6]
                return (it < m_shr) & ~jnp.all(done)

            _, _, t_sel, lp_sel, done, _, _ = lax.while_loop(
                shrink_cond, shrink_body,
                (L, R, jnp.zeros_like(lpk), lpk,
                 jnp.zeros(lpk.shape, bool), kshr,
                 jnp.asarray(0, jnp.int32)))

            prop = xk + t_sel[..., None] * eta
            return prop, lp_sel, done

        x_lo, l_lo = pos[:, :Bh], lp[:, :Bh]
        x_hi, l_hi = pos[:, Bh:], lp[:, Bh:]
        p_lo, lp_lo, a_lo = half(k_lo, x_lo, l_lo, x_hi, _eval_lo, True)
        x_lo_new = jnp.where(a_lo[..., None], p_lo, x_lo)
        p_hi, lp_hi, a_hi = half(k_hi, x_hi, l_hi, x_lo_new, _eval_hi, False)

        proposal = jnp.concatenate([p_lo, p_hi], axis=1).reshape(W, ndim)
        lp_prop = jnp.concatenate([lp_lo, lp_hi], axis=1).reshape(W)
        accept = jnp.concatenate([a_lo, a_hi], axis=1).reshape(W)
        new_state, accf, out = _apply_step(
            state, key, proposal, lp_prop, proposal - state.position, accept, False
        )
        return (new_state, accept_counts + accf, force_cold), out

    def one_step_mala(carry, i, data=None):
        """Preconditioned MALA step (new surface, not in the reference).

        With M = L L^T (the adapted proposal covariance as preconditioner)
        and tempered target pi^(1/T):

            proposal = x + (1/(2T)) M g + L z,   z ~ N(0, I)

        In whitened coordinates y = L^{-1} x the forward draw is exactly
        ``z`` and the reverse draw is ``-(z + (u + u')/(2T))`` with
        ``u = L^T g``, giving the Hastings correction without any
        triangular solves.  The same acceptance-band machinery adapts L
        (band shifted to MALA's ~0.574 optimum).
        """
        state, accept_counts, force_cold, g = carry
        dtype = state.position.dtype
        key, k_prop, k_accept = jax.random.split(state.key, 3)
        temp = resolve_temp(force_cold, state, dtype)
        inv_t = 1.0 / temp
        # Langevin drift only in the cold phase: during annealing (T > 1)
        # the gradient drift chases tempered plateaus and can carry the
        # ensemble far from the data (observed on the reference fit), so
        # hot steps behave as the random walk and the drift switches on
        # when T reaches 1.  With lam = 0 the Hastings correction reduces
        # exactly to the plain MH rule.
        lam = jnp.where(temp > 1.001, 0.0, 1.0).astype(dtype)

        u = lam * mul_Lt(state.l_matrix, g)                   # (W, d)
        z = jax.random.normal(k_prop, state.position.shape, dtype)
        step_vec = mul_L(state.l_matrix, z + 0.5 * inv_t * u)
        proposal = state.position + step_vec

        lp_prop, g_prop = eval_vg(proposal, data)
        lp_prop = jnp.where(jnp.isfinite(lp_prop), lp_prop, _neg_floor(dtype))
        g_prop = jnp.where(jnp.isfinite(g_prop), g_prop, 0.0)
        u_prop = lam * mul_Lt(state.l_matrix, g_prop)

        rev = z + 0.5 * inv_t * (u + u_prop)
        log_q_diff = 0.5 * (jnp.sum(z * z, axis=1) - jnp.sum(rev * rev, axis=1))
        log_alpha = (lp_prop - state.logprob) * inv_t + log_q_diff
        log_u_draw = jnp.log(jax.random.uniform(k_accept, state.logprob.shape, dtype))
        accept = log_alpha > log_u_draw

        new_state, accf, out = _apply_step(
            state, key, proposal, lp_prop, step_vec, accept, False
        )
        new_grad = jnp.where(accept[:, None], g_prop, g)
        return (new_state, accept_counts + accf, force_cold, new_grad), out

    def one_step_hmc(carry, i, data=None):
        """Hamiltonian step (kernel='hmc', new surface).

        Leapfrog integration in L-whitened coordinates: with momentum
        ``p ~ N(0, I)`` in whitened space and tempered potential
        ``U = -logpi / T``, the drift is ``x += L p`` and the kick is
        ``p += (1/2T) L^T grad logpi`` — the adapted proposal factor L is
        simultaneously the mass-matrix preconditioner and the step size
        (the acceptance band rescales it toward HMC's ~0.65 optimum).
        ``hmc_leapfrog`` gradient evaluations per proposal; a divergent
        (non-finite) trajectory is rejected hard, never propagated.

        The trajectory LENGTH is jittered uniformly over
        [hmc_leapfrog/2, hmc_leapfrog] per step (``hmc_jitter``): fixed
        lengths resonate with the target's periods (Neal 2011 §5.4.3.2 —
        a trajectory that U-turns back to its start every step explores
        nothing at full cost).  The draw is masked inside the
        static-length scan — iterations past the drawn length carry the
        state through unchanged — because a data-dependent trip count
        would force a `while_loop` that defeats XLA's pipelining; the
        masked iterations' gradient evals are the price of the static
        shape (expected 25% of the scan).
        """
        state, accept_counts, force_cold, g = carry
        dtype = state.position.dtype
        key, k_mom, k_accept, k_len = jax.random.split(state.key, 4)
        temp = resolve_temp(force_cold, state, dtype)
        inv_t = (1.0 / temp).astype(dtype)
        L = state.l_matrix

        p0 = jax.random.normal(k_mom, state.position.shape, dtype)
        # First half kick, then hmc_leapfrog x (drift + full kick), then
        # un-kick half at the end — the standard splitting, with every
        # kick riding mul_lt (no triangular solves anywhere).
        p = p0 + 0.5 * inv_t * mul_Lt(L, g)

        n_steps = max(1, config.hmc_leapfrog)
        if config.hmc_jitter and n_steps > 1:
            n_leap = jax.random.randint(k_len, (), (n_steps + 1) // 2, n_steps + 1)
        else:
            n_leap = n_steps

        def leap(inner, i):
            x_i, p_i, lp_i, g_i, bad = inner
            active = i < n_leap
            x_n = x_i + mul_L(L, p_i)
            lp_n, g_n = eval_vg(x_n, data)
            bad_n = bad | ~jnp.isfinite(lp_n) | ~jnp.all(jnp.isfinite(g_n), axis=1)
            g_n = jnp.where(jnp.isfinite(g_n), g_n, 0.0)
            lp_n = jnp.where(jnp.isfinite(lp_n), lp_n, _neg_floor(dtype))
            p_n = p_i + inv_t * mul_Lt(L, g_n)
            keep = lambda new, old: jnp.where(active, new, old)
            return (keep(x_n, x_i), keep(p_n, p_i), keep(lp_n, lp_i),
                    keep(g_n, g_i), keep(bad_n, bad)), None

        bad0 = jnp.zeros(state.logprob.shape, bool)
        (x1, p1, lp1, g1, bad), _ = lax.scan(
            leap, (state.position, p, state.logprob, g, bad0),
            jnp.arange(n_steps),
        )
        p1 = p1 - 0.5 * inv_t * mul_Lt(L, g1)

        # Delta H = U(x0) - U(x1) + (|p0|^2 - |p1|^2)/2 in whitened space.
        log_alpha = (lp1 - state.logprob) * inv_t + 0.5 * (
            jnp.sum(p0 * p0, axis=1) - jnp.sum(p1 * p1, axis=1)
        )
        log_alpha = jnp.where(bad, -jnp.inf, log_alpha)
        log_u = jnp.log(jax.random.uniform(k_accept, state.logprob.shape, dtype))
        accept = log_alpha > log_u

        new_state, accf, out = _apply_step(
            state, key, x1, lp1, x1 - state.position, accept, False
        )
        new_grad = jnp.where(accept[:, None], g1, g)
        return (new_state, accept_counts + accf, force_cold, new_grad), out

    def one_step_chees(carry, i, data=None, adapt=True):
        """ChEES-HMC step (kernel='chees', Hoffman, Radul & Sountsov 2021).

        HMC whose trajectory length tunes ITSELF: NUTS's recursive tree
        doubling cannot batch onto SIMD hardware (every chain would take a
        different number of gradient evaluations per step), so ChEES
        instead adapts one continuous trajectory time t by stochastic
        gradient ascent of the Change-in-the-Estimator-of-the-Expected-
        Square criterion

            ChEES(t) = (1/4) E[ (||x' - E x'||^2 - ||x - E x||^2)^2 ],

        whose per-walker gradient d/dt needs only the endpoint velocity
        the leapfrog integrator already has (dx'/dt = L p').  The walker
        ensemble provides the expectations in ONE step — the same
        inversion the rest of this framework runs on (chains are a batch
        axis, DESIGN.md) — so adaptation is fully on-device, per
        adaptation group, with Adam on log t riding the scan carry.

        Per step a group-shared jitter u ~ U(0,1) sets the leapfrog count
        n = ceil(u t) (paper §4: jittering is what lets a single t mimic
        NUTS's range of trajectory lengths).  ``adapt`` (the driver's
        traced adapt_enabled) gates the per-step Adam write itself —
        a boundary-only reset would leave "frozen" phases running a
        drifting t inside each chunk and snapping back at its end.  Because u is SHARED across
        the group's walkers, every walker integrates the same n steps and
        the bounded ``while_loop`` pays exactly n gradient evaluations —
        no per-walker masking waste (expected cost t/2 evals/step, against
        a hard ``chees_max_leapfrog`` cap).  Step SIZE (the L scale) keeps
        the continuous acceptance steering all gradient kernels share
        (target 0.65).  Trajectory state persists across chunks in
        ``WalkerState.chees`` (zeros = start at t = hmc_leapfrog).
        """
        state, accept_counts, force_cold, g = carry
        dtype = state.position.dtype
        W, d = state.position.shape
        key, k_mom, k_accept, k_u = jax.random.split(state.key, 4)
        temp = resolve_temp(force_cold, state, dtype)
        inv_t = (1.0 / temp).astype(dtype)
        L = state.l_matrix

        t_init = jnp.asarray(float(max(1, config.hmc_leapfrog)), dtype)
        budget = int(max(1, config.chees_max_leapfrog))
        off_lo = jnp.log(1.0 / t_init)
        off_hi = jnp.log(jnp.asarray(float(budget), dtype) / t_init)
        offset = jnp.clip(state.chees[:, 0], off_lo, off_hi)      # (G,)
        t_g = t_init * jnp.exp(offset)                            # (G,)

        u_g = jax.random.uniform(k_u, (n_groups,), dtype)         # (G,)
        n_leap_g = jnp.clip(
            jnp.ceil(u_g * t_g).astype(jnp.int32), 1, budget)     # (G,)
        if grouped and group_block is not None:
            n_leap_w = jnp.repeat(
                n_leap_g, group_block, total_repeat_length=W)     # (W,)
            u_w = jnp.repeat(u_g, group_block, total_repeat_length=W)
        elif grouped:
            n_leap_w = n_leap_g[group_ids]
            u_w = u_g[group_ids]
        else:
            n_leap_w = jnp.broadcast_to(n_leap_g[0], (W,))
            u_w = jnp.broadcast_to(u_g[0], (W,))
        n_max = jnp.max(n_leap_g)

        p0 = jax.random.normal(k_mom, state.position.shape, dtype)
        p_half = p0 + 0.5 * inv_t * mul_Lt(L, g)
        bad0 = jnp.zeros((W,), bool)

        def leap_cond(c):
            return c[0] < n_max

        def leap_body(c):
            i_l, x_i, p_i, lp_i, g_i, bad = c
            act = i_l < n_leap_w                                  # (W,)
            x_n = x_i + mul_L(L, p_i)
            lp_n, g_n = eval_vg(x_n, data)
            bad_n = bad | ~jnp.isfinite(lp_n) | ~jnp.all(jnp.isfinite(g_n), axis=1)
            g_n = jnp.where(jnp.isfinite(g_n), g_n, 0.0)
            lp_n = jnp.where(jnp.isfinite(lp_n), lp_n, _neg_floor(dtype))
            p_n = p_i + inv_t * mul_Lt(L, g_n)
            keep = lambda new, old: jnp.where(act[:, None], new, old)
            return (i_l + 1, keep(x_n, x_i), keep(p_n, p_i),
                    jnp.where(act, lp_n, lp_i), keep(g_n, g_i),
                    jnp.where(act, bad_n, bad))

        _, x1, p1, lp1, g1, bad = lax.while_loop(
            leap_cond, leap_body,
            (jnp.zeros((), jnp.int32), state.position, p_half,
             state.logprob, g, bad0),
        )
        p1 = p1 - 0.5 * inv_t * mul_Lt(L, g1)

        log_alpha = (lp1 - state.logprob) * inv_t + 0.5 * (
            jnp.sum(p0 * p0, axis=1) - jnp.sum(p1 * p1, axis=1)
        )
        log_alpha = jnp.where(bad, -jnp.inf, log_alpha)
        log_u = jnp.log(jax.random.uniform(k_accept, state.logprob.shape, dtype))
        accept = log_alpha > log_u

        # --- ChEES gradient ascent on log t (per group, Adam) ---------
        # alpha-weighted proposal statistics use every PROPOSED endpoint
        # (paper eq. 8): rejected trajectories still inform the criterion.
        alpha = jnp.where(bad, 0.0, jnp.exp(jnp.minimum(log_alpha, 0.0)))
        tiny = jnp.asarray(1e-12, dtype)
        ones = jnp.ones((W,), dtype)
        count_g = jnp.maximum(seg_sum(ones), 1.0)                 # (G,)
        a_sum = jnp.maximum(seg_sum(alpha), tiny)                 # (G,)
        xbar = seg_sum(state.position) / count_g[:, None]         # (G, d)
        xbar_p = seg_sum(alpha[:, None] * x1) / a_sum[:, None]    # (G, d)
        if grouped and group_block is not None:
            xbar_w = jnp.repeat(xbar, group_block, axis=0,
                                total_repeat_length=W)
            xbar_p_w = jnp.repeat(xbar_p, group_block, axis=0,
                                  total_repeat_length=W)
        elif grouped:
            xbar_w, xbar_p_w = xbar[group_ids], xbar_p[group_ids]
        else:
            xbar_w, xbar_p_w = xbar[0], xbar_p[0]
        dx1 = x1 - xbar_p_w
        dx0 = state.position - xbar_w
        delta = jnp.sum(dx1 * dx1, axis=1) - jnp.sum(dx0 * dx0, axis=1)
        v1 = mul_L(L, p1)                                          # endpoint velocity
        # d/dt ||x'(u t) - mu||^2 = 2 u (x'-mu) . v'; the outer square
        # contributes delta, the 1/4 and 2 fold into the (scale-free) Adam.
        per_w = alpha * delta * jnp.sum(dx1 * v1, axis=1) * u_w
        grad_log_t = (seg_sum(per_w) / a_sum) * t_g                # (G,)
        grad_log_t = jnp.where(jnp.isfinite(grad_log_t), grad_log_t, 0.0)

        b1 = jnp.asarray(0.9, dtype)
        b2 = jnp.asarray(0.999, dtype)
        m = b1 * state.chees[:, 1] + (1.0 - b1) * grad_log_t
        v = b2 * state.chees[:, 2] + (1.0 - b2) * grad_log_t ** 2
        cnt = state.chees[:, 3] + 1.0
        mhat = m / (1.0 - jnp.power(b1, cnt))
        vhat = v / (1.0 - jnp.power(b2, cnt))
        lr = jnp.asarray(config.chees_lr, dtype)
        new_off = jnp.clip(
            offset + lr * mhat / (jnp.sqrt(vhat) + 1e-8), off_lo, off_hi)
        new_chees = jnp.where(
            jnp.asarray(adapt),
            jnp.stack([new_off, m, v, cnt], axis=1).astype(dtype),
            state.chees)

        new_state, accf, out = _apply_step(
            state, key, x1, lp1, x1 - state.position, accept, False
        )
        new_state = dataclasses.replace(new_state, chees=new_chees)
        new_grad = jnp.where(accept[:, None], g1, g)
        return (new_state, accept_counts + accf, force_cold, new_grad), out

    def _mala_carry(state, zero_counts, force_cold, data):
        """Initial MALA/HMC carry: one value+grad eval per chunk (kept out
        of WalkerState to avoid widening every consumer's pytree; costs one
        posterior evaluation per chunk_size steps, ~0.5%)."""
        _, g0 = eval_vg(state.position, data)
        g0 = jnp.where(jnp.isfinite(g0), g0, 0.0)
        return (state, zero_counts, force_cold, g0)

    # Regular groupings reshape to (G, B); irregular ones can't take the
    # per-group quantile below, so trimming (and the rescue) stay off there.
    regular = not grouped or group_block is not None

    def typical_weights(logprob):
        """Per-walker weights selecting each group's chi^2-TYPICAL set.

        Window: within d/2 + 4 sqrt(d/2) + 2 log-units of the group max
        (the chi^2_d typical-set depth below the mode, 4 sigma of slack) —
        a wider window measured 50x-inflated covariance scales per axis
        from the straggler tail.  Floored at the top K walkers by logprob
        (K = max(2d+4, 32), enough support for a rank-d covariance):
        while the population is still wide (hot anneal handoff leaves a
        ~4e4-log-unit tail on the flagship fit) the tight window can hold
        fewer than d walkers, which starved both the refresh covariance
        and the rescue's q-fit exactly when they were needed (measured:
        raw-covariance refresh inflated L 27,000x and the rescue stayed
        disabled for ~15 chunks).  The floor must be top-K, not a
        quantile: a top-QUARTILE floor was measured to span thousands of
        log-units on that same population, re-inflating the fit it was
        supposed to protect.  Returns ``(wgt (W,), counts (G,))``.
        """
        dtype = logprob.dtype
        cut = jnp.asarray(0.5 * ndim + 4.0 * math.sqrt(0.5 * ndim) + 2.0, dtype)
        if grouped and group_block is not None:
            k = min(group_block, max(2 * ndim + 4, 32))
            lp_g = logprob.reshape(n_groups, group_block)
            top = jnp.max(lp_g, axis=1)
            kth = jnp.sort(lp_g, axis=1)[:, group_block - k]       # (G,)
            thresh = jnp.minimum(top - cut, kth)                   # (G,)
            keep = (lp_g >= thresh[:, None]).reshape(-1)
        else:
            n = logprob.shape[0]
            k = min(n, max(2 * ndim + 4, 32))
            kth = jnp.sort(logprob)[n - k]
            thresh = jnp.minimum(jnp.max(logprob) - cut, kth)
            keep = logprob >= thresh
        wgt = keep.astype(dtype)
        counts = jnp.maximum(seg_sum(wgt), 1.0)                 # (G,)
        return wgt, counts

    def adapt(state: WalkerState, group_accept, allow_refresh):
        """Chunk-boundary L update (mcmc-fitting.lisp:929-942), branchless
        and batched over adaptation groups."""
        dtype = state.position.dtype
        d = ndim

        # Candidate refresh L per group.  sampling_optimization selects the
        # source exactly like the reference's get-optimal-mcmc-l-matrix
        # (mcmc-fitting.lisp:888-895): "covariance" = Haario 2.38^2/d x
        # Cholesky of recent-move covariance; "best-value" = 1e-5 x diag of
        # the per-group most-likely parameter magnitudes.
        if config.sampling_optimization == "best-value":
            if gradk:
                raise ValueError(
                    "sampling_optimization='best-value' is the random-walk "
                    "diagonal-refresh policy (mcmc-fitting.lisp:888-895); the "
                    "gradient kernels adapt by continuous step-size steering "
                    "and an absolute-scale refresh was measured to limit-cycle "
                    "them (see the steering branch below) — use the default "
                    "'covariance' with kernel='mala'/'hmc'"
                )
            if grouped and group_block is not None:
                lp_g = state.best_logprob.reshape(n_groups, group_block)
                idx = jnp.argmax(lp_g, axis=1)                     # (G,)
                pos_g = state.best_position.reshape(n_groups, group_block, d)
                best = jnp.take_along_axis(
                    pos_g, idx[:, None, None], axis=1
                )[:, 0, :]                                         # (G, d)
            else:  # ungrouped (or irregular grouping: use the global best)
                w = jnp.argmax(state.best_logprob)
                best = jnp.broadcast_to(state.best_position[w], (n_groups, d))
            mags = jnp.abs(best)
            mags = jnp.where(mags > 0, mags, 1e-3)
            candidate = 1e-5 * jax.vmap(jnp.diag)(mags).astype(dtype)
            refresh_ok = jnp.broadcast_to(jnp.asarray(allow_refresh), (n_groups,))
            in_band = (accept_low < group_accept) & (group_accept < accept_high)
            too_low = group_accept <= accept_low
            g = float(config.refresh_damping)  # same damping as the
            # covariance branch; g = 1 is the reference's hard policy.
            blended = (1.0 - g) * state.l_matrix + g * candidate if g < 1.0 else candidate
            l_refreshed = jnp.where(refresh_ok[:, None, None], blended, state.l_matrix)
            l_rescaled = jnp.where(
                too_low[:, None, None],
                (config.scale_down ** g) * state.l_matrix,
                (config.scale_up ** g) * state.l_matrix,
            )
            new_l = jnp.where(in_band[:, None, None], l_refreshed, l_rescaled)
            return dataclasses.replace(state, l_matrix=new_l.astype(dtype))

        # Candidate refresh covariance per group.  The gradient kernels
        # precondition with the TARGET covariance, which the walker
        # ensemble's position spread estimates directly (accepted-move
        # covariance was benchmarked as the refresh source: robust to
        # stragglers, but a measurably worse preconditioner shape — it is
        # proposal-filtered — costing ~2-3x ESS on correlated targets).
        # For MALA/HMC the estimate is TRIMMED to the typical set: the raw
        # ensemble covariance is quadratically contaminated by the
        # straggler tail (measured 27,000x L inflation on the flagship
        # fit's post-anneal population, locking a refresh -> collapse ->
        # re-refresh limit cycle), and the independence-rescue round below
        # heals that tail walker by walker, so the trimmed estimate is the
        # one that matches the population the kernel actually steps.
        if gradk and regular:
            wgt, counts = typical_weights(state.logprob)
            mean = seg_sum(state.position * wgt[:, None]) / counts[:, None]
            mean_w = mean[group_ids] if grouped else mean[0]
            centered = (state.position - mean_w) * wgt[:, None]
            cov = seg_sum(centered[:, :, None] * centered[:, None, :]) / counts[:, None, None]
            enough = counts > (max(config.block_hyper, config.block_local)
                               if blocked else d)
        elif config.covariance_source == "ensemble" or gradk or blocked:
            ones = jnp.ones((state.position.shape[0],), dtype)
            counts = jnp.maximum(seg_sum(ones), 1.0)            # (G,)
            mean = seg_sum(state.position) / counts[:, None]
            if grouped:
                centered = state.position - mean[group_ids]
            else:
                centered = state.position - mean[0]
            cov = seg_sum(centered[:, :, None] * centered[:, None, :]) / counts[:, None, None]
            enough = counts > (max(config.block_hyper, config.block_local)
                               if blocked else d)
        else:
            cov = jax.vmap(moments_covariance)(state.m_sum, state.m_outer, state.m_count)
            enough = state.m_count > d
        if blocked:
            # The non-centered hierarchy's true coupling is hyper<->local
            # only: zero the cross-block entries so the candidate L is
            # exactly block-diagonal (a dense Cholesky of a block-
            # diagonal matrix IS block-diagonal) and the O(d^2) sample
            # noise in the off-blocks never enters the proposal.
            cov = cov * block_mask.astype(dtype)
        if config.jitter > 0:
            cov = cov + config.jitter * jnp.eye(d, dtype=dtype)
        chol, ok = cholesky_clamped(cov)                           # (G,d,d), (G,)
        # Reference scales the L-matrix by 2.38^2/d (890) — replicated.
        candidate = jnp.asarray(haario_scale(d), dtype) * chol
        refresh_ok = ok & enough & allow_refresh                   # (G,)

        in_band = (accept_low < group_accept) & (group_accept < accept_high)
        too_low = group_accept <= accept_low

        if gradk:
            # Gradient-kernel adaptation: continuous step-size steering +
            # SHAPE-only refresh.  The gradient kernels must never trust
            # the covariance estimate's ABSOLUTE scale: on posteriors with
            # a near-degenerate ridge (the flagship fit's background-only
            # plateau sits within ~1 log-unit of the real peak, leaving
            # linewidth/mix/x0 unconstrained along it) even the typical-set
            # covariance is legitimately orders wider than a stable
            # Langevin/leapfrog step, and an absolute-scale refresh at
            # 1.65 d^(-1/6) (MALA) was measured to inflate L ~300x and
            # lock a refresh -> collapse -> re-refresh limit cycle.
            # Instead the scalar whitened step steers multiplicatively
            # toward the Roberts-Rosenthal/Beskos optimum every chunk —
            # asymmetric rates (<=1.19x/chunk up, down to 0.52x/chunk on
            # collapse) because the integrator's stability cliff drops
            # acceptance ~1 -> ~0 over a few percent of eps: overshoot
            # recovers in a couple of chunks on the fast down-rate, while
            # equally-fast symmetric rates limit-cycle across the cliff.
            # The direction basis refreshes from the trimmed ensemble
            # covariance only at healthy (in-band) acceptance, with the
            # current magnitude carried over via
            # s = (det L / det chol)^(1/d).
            target = 0.65 if (hmc or chees) else 0.574
            corr = jnp.where(
                group_accept >= target,
                jnp.exp(0.5 * (group_accept - target)),
                jnp.exp(group_accept - target),
            ).astype(dtype)                                        # (G,)
            diag_l = jnp.abs(jnp.diagonal(state.l_matrix, axis1=1, axis2=2))
            diag_c = jnp.abs(jnp.diagonal(chol, axis1=1, axis2=2))
            floor = jnp.asarray(jnp.finfo(dtype).tiny, dtype)
            log_s = jnp.clip(
                jnp.mean(jnp.log(jnp.maximum(diag_l, floor)), axis=1)
                - jnp.mean(jnp.log(jnp.maximum(diag_c, floor)), axis=1),
                -20.0, 20.0,
            )
            cand_shape = (jnp.exp(log_s) * corr)[:, None, None] * chol
            refresh_now = refresh_ok & in_band
            new_l = jnp.where(
                refresh_now[:, None, None], cand_shape,
                corr[:, None, None] * state.l_matrix,
            )
            return dataclasses.replace(state, l_matrix=new_l.astype(dtype))

        # Damped update (refresh_damping < 1): blend toward the candidate
        # instead of jumping, and soften the rescale factors to scale^g.
        # The blend of two lower-triangular factors stays lower-triangular
        # with nonnegative diagonal, so it is a valid proposal L.  g = 1
        # reproduces the reference's hard policy exactly (929-942).
        g = float(config.refresh_damping)
        blended = (1.0 - g) * state.l_matrix + g * candidate if g < 1.0 else candidate
        l_refreshed = jnp.where(refresh_ok[:, None, None], blended, state.l_matrix)
        l_rescaled = jnp.where(
            too_low[:, None, None],
            (config.scale_down ** g) * state.l_matrix,
            (config.scale_up ** g) * state.l_matrix,
        )
        new_l = jnp.where(in_band[:, None, None], l_refreshed, l_rescaled)

        # Reset move moments after a refresh so the window stays recent.
        reset = refresh_ok & in_band                               # (G,)
        return dataclasses.replace(
            state,
            l_matrix=new_l.astype(dtype),
            m_sum=jnp.where(reset[:, None], 0.0, state.m_sum).astype(dtype),
            m_outer=jnp.where(reset[:, None, None], 0.0, state.m_outer).astype(dtype),
            m_count=jnp.where(reset, 0.0, state.m_count).astype(dtype),
        )

    # Regeneration applies to the gradient kernels (whose stragglers are
    # frozen); rwm/stretch stragglers mix on their own and keep the
    # reference's pure-kernel semantics.  Irregular groupings would need a
    # per-walker (W,d,d) triangular solve — not worth it for that corner.
    rescue_on = config.rescue and gradk and regular

    # Shared pieces of the rescue move (see independence_rescue).
    _RESCUE_NU = 2.0

    def _rescue_log_q_t(z):
        # log multivariate-t density up to the (cancelling) det/const:
        # -((nu+d)/2) log(1 + |z|^2/nu)
        return -0.5 * (_RESCUE_NU + ndim) * jnp.log1p(
            jnp.sum(z * z, axis=-1) / _RESCUE_NU)

    def _rescue_t_draw(k_z, k_v, shape, dtype):
        # Multivariate t draw: z_t = z_normal * sqrt(nu / V), V ~ chi^2_nu
        # (one V per walker — tails are radial, not per-axis).  nu = 2 is
        # load-bearing twice over: the tails (see independence_rescue),
        # and chi^2_2 = Exp(mean 2) = -2 log U, which avoids
        # jax.random.gamma, whose rejection-sampling loop costs more than
        # a whole 200-step chunk at ensemble scale.
        z_n = jax.random.normal(k_z, shape, dtype)
        u = jax.random.uniform(k_v, shape[:-1], dtype,
                               minval=jnp.finfo(dtype).tiny)
        v_chi2 = -2.0 * jnp.log(u)
        return z_n * jnp.sqrt(
            _RESCUE_NU / jnp.maximum(v_chi2, 1e-12))[..., None]

    def _rescue_fit_q(fit_pos, fit_lp):
        """Fit the t-proposal q on a (G, Bf, d) walker block.

        chi^2-typical window with a top-K floor, per group — the same
        policy as typical_weights (which see for the measured failure
        modes of a wider window and the unfloored one), restricted to
        the walkers in ``fit_pos``.  1.3x overdispersed so q covers the
        target's shoulders.  Returns (mean (G,d), chol (G,d,d), ok (G,)).
        """
        dtype = fit_lp.dtype
        bf = fit_lp.shape[1]
        cut = jnp.asarray(0.5 * ndim + 4.0 * math.sqrt(0.5 * ndim) + 2.0,
                          dtype)
        k = min(bf, max(2 * ndim + 4, 32))
        top = jnp.max(fit_lp, axis=1)
        kth = jnp.sort(fit_lp, axis=1)[:, bf - k]
        thresh = jnp.minimum(top - cut, kth)
        wgt = (fit_lp >= thresh[:, None]).astype(dtype)            # (G, Bf)
        counts = jnp.maximum(jnp.sum(wgt, axis=1), 1.0)            # (G,)
        mean = jnp.sum(fit_pos * wgt[..., None], axis=1) / counts[:, None]
        centered = (fit_pos - mean[:, None, :]) * wgt[..., None]
        # full f32: the fitted q's covariance, as in the refresh
        cov = jnp.einsum("gbi,gbj->gij", centered, centered,
                         precision=hi) / counts[:, None, None]
        chol, ok = cholesky_clamped(1.69 * cov)
        ok = ok & (counts > ndim)
        return mean, chol, ok

    def independence_rescue(state: WalkerState, force_cold, data):
        """One independence-MH regeneration round (chunk boundary).

        The walker ensemble always carries a straggler tail (chains
        stranded far from the mode by the hot annealing phase; measured
        lp spread of 4.2e4 log-units on the flagship fit at rwm
        convergence).  Under the gradient kernels stragglers are
        effectively frozen — their gradients are enormous, so every
        trajectory rejects.  This move fixes the population itself:
        propose ``y ~ q``, a multivariate Student-t(nu=2) fitted per
        group on a chi^2-typical walker window (see _rescue_fit_q),
        accepted with the independence-sampler ratio

            log a = beta (lp(y) - lp(x)) + ((nu+d)/2) *
                    [log(1 + |z_x|^2/nu) - log(1 + |z_y|^2/nu)]

        (the log-det terms cancel — same q both sides).  The HEAVY tails
        are load-bearing: walkers stuck on posterior plateaus sit ~1e8
        whitened-log-units into a Gaussian q's tail, making pi(x)/q(x)
        astronomical and the teleport never accepted (measured); under
        the t the same point costs only ~((nu+d)/2) log|z_x|^2 and the
        posterior term dominates, so stragglers teleport with
        probability ~1 while healthy walkers move only when the
        posterior ratio allows.  One extra posterior evaluation per
        walker per chunk (~0.5% cost).

        Invariance (round-3 fix, VERDICT r2 #5): q is fitted on the
        COMPLEMENTARY half-ensemble, stretch-style.  Each group block
        splits into two fixed halves; half 0 updates with q fitted on
        half 1, then half 1 updates with q fitted on the UPDATED half 0.
        Given the fitting half, the move is a plain independence MH step
        whose proposal does not depend on the states being updated, so
        the composition is exactly pi^(1/T)-invariant (the Goodman-Weare
        argument) — the rescue may stay on during sampling phases at any
        W.  Only an ODD walkers-per-group count falls back to the old
        whole-ensemble fit, which is adaptive MCMC with an O(1/W)
        invariance error (fine at ensemble scale, W >= 1e4; use even
        block sizes — the default layouts all are).
        """
        W = state.position.shape[0]
        G = n_groups if grouped else 1
        B = group_block if (grouped and group_block is not None) else W
        if B % 2 != 0:
            return _rescue_adaptive_full(state, force_cold, data)

        dtype = state.position.dtype
        keys = jax.random.split(state.key, 7)
        key = keys[0]
        temp = resolve_temp(force_cold, state, dtype)
        inv_t = (1.0 / temp).astype(dtype)
        neg_floor = _neg_floor(dtype)
        bh = B // 2
        jit_eps = jnp.asarray(jnp.finfo(dtype).tiny, dtype)
        eye = jnp.eye(ndim, dtype=dtype)

        def eval_act(prop, pos_g, s, data):
            """Posterior of the active half's proposals ((G*bh,) out)."""
            a0 = s * bh
            if batched_posterior is not None:
                # Whole-batch posteriors are shape-specialized to W:
                # evaluate a full ensemble with the proposals scattered
                # into the active slots (the complement's values are
                # discarded — one redundant half-eval, the price of the
                # opaque signature).
                full = pos_g.at[:, a0:a0 + bh].set(
                    prop.reshape(G, bh, ndim)).reshape(W, ndim)
                lp_full = batched_posterior(full, data)
                return lp_full.reshape(G, B)[:, a0:a0 + bh].reshape(-1)
            if aux is None:
                return eval_lp(prop, data)     # vmap: any leading dim
            def sl(a):
                a = jnp.asarray(a)
                g = a.reshape((G, B) + a.shape[1:])
                return g[:, a0:a0 + bh].reshape((-1,) + a.shape[1:])
            aux_act = jax.tree_util.tree_map(sl, aux)
            if takes_data:
                return jax.vmap(log_posterior, in_axes=(0, 0, None))(
                    prop, aux_act, data)
            return jax.vmap(log_posterior, in_axes=(0, 0))(prop, aux_act)

        def half_round(pos_g, lp_g, s, k_z, k_v, k_u):
            a0, c0 = s * bh, (1 - s) * bh
            mean, chol, ok = _rescue_fit_q(pos_g[:, c0:c0 + bh],
                                           lp_g[:, c0:c0 + bh])
            act_pos = pos_g[:, a0:a0 + bh]                     # (G, bh, d)
            act_lp = lp_g[:, a0:a0 + bh]                       # (G, bh)

            z_y = _rescue_t_draw(k_z, k_v, (G, bh, ndim), dtype)
            # full f32: the independence ratio assumes exactly this y
            prop_g = mean[:, None, :] + jnp.einsum("gij,gbj->gbi", chol, z_y,
                                                   precision=hi)
            lp_prop = eval_act(prop_g.reshape(G * bh, ndim), pos_g, s, data)
            lp_prop = jnp.where(jnp.isfinite(lp_prop), lp_prop, neg_floor)
            lp_prop_g = lp_prop.reshape(G, bh)

            chol_safe = chol + jit_eps * eye
            diff = act_pos - mean[:, None, :]
            z_x = jax.vmap(
                lambda c, v: jax.scipy.linalg.solve_triangular(
                    c, v.T, lower=True).T
            )(chol_safe, diff)                                 # (G, bh, d)
            z_x = jnp.where(jnp.isfinite(z_x), z_x, jnp.asarray(1e6, dtype))

            log_alpha = (lp_prop_g - act_lp) * inv_t \
                + _rescue_log_q_t(z_x) - _rescue_log_q_t(z_y)
            accept = ok[:, None] & (
                jnp.log(jax.random.uniform(k_u, (G, bh), dtype)) < log_alpha)
            pos_g = pos_g.at[:, a0:a0 + bh].set(
                jnp.where(accept[..., None], prop_g, act_pos))
            lp_g = lp_g.at[:, a0:a0 + bh].set(
                jnp.where(accept, lp_prop_g, act_lp))
            return pos_g, lp_g

        pos_g = state.position.reshape(G, B, ndim)
        lp_g = state.logprob.reshape(G, B)
        pos_g, lp_g = half_round(pos_g, lp_g, 0, keys[1], keys[2], keys[3])
        pos_g, lp_g = half_round(pos_g, lp_g, 1, keys[4], keys[5], keys[6])
        new_position = pos_g.reshape(W, ndim)
        new_logprob = lp_g.reshape(W)
        better = new_logprob > state.best_logprob
        return dataclasses.replace(
            state,
            key=key,
            position=new_position,
            logprob=new_logprob,
            best_position=jnp.where(better[:, None], new_position,
                                    state.best_position),
            best_logprob=jnp.where(better, new_logprob, state.best_logprob),
        )

    def _rescue_adaptive_full(state: WalkerState, force_cold, data):
        """Fallback rescue for ODD per-group block sizes: the round-2
        whole-ensemble q-fit.  Adaptive MCMC (q depends on the states
        being updated) with an O(1/W) invariance error — fine at
        ensemble scale; see independence_rescue for the exact variant.
        """
        dtype = state.position.dtype
        key, k_z, k_v, k_u = jax.random.split(state.key, 4)
        temp = resolve_temp(force_cold, state, dtype)
        inv_t = (1.0 / temp).astype(dtype)

        wgt, counts = typical_weights(state.logprob)
        mean = seg_sum(state.position * wgt[:, None]) / counts[:, None]
        mean_w = mean[group_ids] if grouped else mean[0]
        centered = (state.position - mean_w) * wgt[:, None]
        cov = seg_sum(centered[:, :, None] * centered[:, None, :]) / counts[:, None, None]
        # 1.3x overdispersed so q covers the target's shoulders.
        chol, ok = cholesky_clamped(1.69 * cov)
        ok = ok & (counts > ndim)                                  # (G,)

        z_y = _rescue_t_draw(k_z, k_v, state.position.shape, dtype)
        prop = mean_w + mul_l(chol, z_y)
        lp_prop = eval_lp(prop, data)
        lp_prop = jnp.where(jnp.isfinite(lp_prop), lp_prop, _neg_floor(dtype))

        # Whiten the CURRENT positions under the same q (per group).
        jit_eps = jnp.asarray(jnp.finfo(dtype).tiny, dtype)
        chol_safe = chol + jit_eps * jnp.eye(ndim, dtype=dtype)
        diff = state.position - mean_w                             # (W, d)
        if grouped and group_block is not None:
            diff_g = diff.reshape(n_groups, group_block, ndim)
            z_x = jax.vmap(
                lambda c, v: jax.scipy.linalg.solve_triangular(c, v.T, lower=True).T
            )(chol_safe, diff_g).reshape(diff.shape)
        else:
            z_x = jax.scipy.linalg.solve_triangular(chol_safe[0], diff.T, lower=True).T
        z_x = jnp.where(jnp.isfinite(z_x), z_x, jnp.asarray(1e6, dtype))

        log_alpha = (lp_prop - state.logprob) * inv_t \
            + _rescue_log_q_t(z_x) - _rescue_log_q_t(z_y)
        ok_w = ok[group_ids] if grouped else ok[0]
        accept = ok_w & (
            jnp.log(jax.random.uniform(k_u, state.logprob.shape, dtype)) < log_alpha
        )
        acc = accept[:, None]
        new_position = jnp.where(acc, prop, state.position)
        new_logprob = jnp.where(accept, lp_prop, state.logprob)
        better = new_logprob > state.best_logprob
        return dataclasses.replace(
            state,
            key=key,
            position=new_position,
            logprob=new_logprob,
            best_position=jnp.where(better[:, None], new_position, state.best_position),
            best_logprob=jnp.where(better, new_logprob, state.best_logprob),
        )

    def replica_swap(state: WalkerState, force_cold):
        """One replica-exchange round between adjacent rungs (tempered mode).

        Pairs (k, k+1) with alternating parity per chunk; walker i of rung
        k swaps with walker i of rung k+1 with probability
        ``min(1, exp((beta_k - beta_{k+1}) (logpi_{k+1} - logpi_k)))`` —
        ``logprob`` is always the UNTEMPERED posterior, so swaps move
        states between rungs without re-evaluation.
        """
        dtype = state.position.dtype
        key, k_swap = jax.random.split(state.key)
        K, B = n_groups, group_block
        pos = state.position.reshape(K, B, ndim)
        lp = state.logprob.reshape(K, B)

        parity = (state.age // chunk) % 2
        # Under force_cold every rung samples at T=1: the only valid
        # exchange between equal-temperature chains is dbeta = 0 (swaps
        # become unbiased permutations); the ladder betas would sort
        # states by likelihood and break detailed balance.
        dbeta = jnp.asarray(rung_betas_np[:-1] - rung_betas_np[1:], dtype)  # (K-1,)
        # Any override (cold T=1 or a numeric SMC temperature) makes every
        # rung equal-temperature, where dbeta = 0 is the only valid swap.
        dbeta = jnp.where(jnp.asarray(force_cold, dtype) > 0, 0.0, dbeta).astype(dtype)
        log_alpha = dbeta[:, None] * (lp[1:] - lp[:-1])                    # (K-1, B)
        u = jnp.log(jax.random.uniform(k_swap, (K - 1, B), dtype))
        pair_on = (jnp.arange(K - 1) % 2) == parity                        # (K-1,)
        do_swap = (u < log_alpha) & pair_on[:, None]                       # (K-1, B)

        # Alternating parity makes the active pairs disjoint, so one
        # where-pass with rolled neighbors applies every swap at once.
        take_next = jnp.zeros((K, B), bool).at[:-1].set(do_swap)
        take_prev = jnp.zeros((K, B), bool).at[1:].set(do_swap)
        pos_next = jnp.roll(pos, -1, axis=0)
        pos_prev = jnp.roll(pos, 1, axis=0)
        lp_next = jnp.roll(lp, -1, axis=0)
        lp_prev = jnp.roll(lp, 1, axis=0)
        new_pos = jnp.where(take_next[:, :, None], pos_next,
                            jnp.where(take_prev[:, :, None], pos_prev, pos))
        new_lp = jnp.where(take_next, lp_next, jnp.where(take_prev, lp_prev, lp))
        # Per-pair swap rate this round; inactive-parity pairs report NaN
        # so the host can nanmean across chunks (ladder observability —
        # a pair stuck near 0 is the actionable "raise rungs/t_max").
        swap_rate = jnp.where(pair_on,
                              jnp.mean(do_swap.astype(dtype), axis=1),
                              jnp.nan)
        return dataclasses.replace(
            state,
            key=key,
            position=new_pos.reshape(state.position.shape),
            logprob=new_lp.reshape(state.logprob.shape),
        ), swap_rate

    def _finish(state, accept_counts, trace, adapt_enabled, allow_refresh):
        dtype = state.position.dtype
        ones = jnp.ones_like(accept_counts)
        group_total = jnp.maximum(seg_sum(ones) * chunk, 1.0)   # (G,)
        group_accept = seg_sum(accept_counts) / group_total     # (G,)
        if stretch or demc or slice_k:
            # Affine invariance: nothing to adapt.  Clear any moments
            # carried in from an earlier rwm phase so a later refresh
            # never sees stale displacement statistics.
            adapted = dataclasses.replace(
                state,
                m_sum=jnp.zeros_like(state.m_sum),
                m_outer=jnp.zeros_like(state.m_outer),
                m_count=jnp.zeros_like(state.m_count),
            )
        else:
            adapted = adapt(state, group_accept, allow_refresh)
        # When adaptation is off (many_steps, sample_region) the move
        # moments are zeroed rather than kept: otherwise greedy-tuner or
        # fixed-L displacements accumulate and poison the first covariance
        # refresh of a later adaptive run (the reference's covariance
        # window naturally ages such moves out).
        not_adapted = dataclasses.replace(
            state,
            m_sum=jnp.zeros_like(state.m_sum),
            m_outer=jnp.zeros_like(state.m_outer),
            m_count=jnp.zeros_like(state.m_count),
        )
        state = jax.tree_util.tree_map(
            lambda a, b: jnp.where(adapt_enabled, a, b), adapted, not_adapted
        )
        out = {
            "logprob_max": trace["logprob_max"],      # (chunk,)
            "logprob_mean": trace["logprob_mean"],    # (chunk,)
            "logprob_min": trace["logprob_min"],      # (chunk,)
            "accept_rate": jnp.mean(accept_counts) / chunk,  # () pooled
            "group_accept": group_accept,             # (G,)
        }
        return state, out

    def run(state: WalkerState, adapt_enabled, allow_refresh, force_cold=False,
            data=None):
        """One chunk: ``chunk_size`` MH steps + one adaptation update.

        ``adapt_enabled``/``allow_refresh``/``force_cold`` are traced
        booleans so the driver can disable adaptation (walker-many-steps,
        849-853), disable refresh, or pin T=1 (the shutdown phase,
        915-917) without recompiling.  ``data`` is the posterior's dataset
        pytree when built with ``takes_data`` (a scan constant, not carried).
        """
        if pallas_chunk is not None:
            # Whole-chunk kernel (ops/chunk_pallas.py): the inner
            # 200 steps run as one Pallas kernel; adaptation and
            # the trace contract stay on the XLA side via _finish.  The
            # in-kernel RNG stream replaces jax.random for the chunk; a
            # fresh per-chunk seed derives from the carried key so chunks
            # stay independent and resumable.
            dtype = state.position.dtype
            key, sub = jax.random.split(state.key)
            seed = jax.random.key_data(sub).reshape(-1)[-1].astype(jnp.int32)
            res = pallas_chunk(
                state.position, state.logprob, state.best_position,
                state.best_logprob, state.l_matrix[0],
                state.anneal_step, jnp.asarray(force_cold, jnp.float32), seed)
            state = WalkerState(
                key=key,
                position=res["position"].astype(dtype),
                logprob=res["logprob"].astype(dtype),
                best_position=res["best_position"].astype(dtype),
                best_logprob=res["best_logprob"].astype(dtype),
                l_matrix=state.l_matrix,
                m_sum=state.m_sum + res["m_sum"][None].astype(dtype),
                m_outer=state.m_outer + res["m_outer"][None].astype(dtype),
                m_count=state.m_count + res["m_count"][None].astype(dtype),
                age=state.age + chunk,
                anneal_step=state.anneal_step + chunk,
                chees=state.chees,
            )
            trace = {
                "logprob_max": res["trace_max"].astype(dtype),
                "logprob_mean": res["trace_mean"].astype(dtype),
                "logprob_min": res["trace_min"].astype(dtype),
            }
            return _finish(state, res["accept_counts"].astype(dtype),
                           trace, adapt_enabled, allow_refresh)
        zero_counts = jnp.zeros((state.position.shape[0],), state.position.dtype)
        if gradk:
            if chees:
                # Trajectory adaptation honors adapt_enabled PER STEP
                # (many_steps freezes t like it freezes L — gating the
                # write, not resetting at the boundary, so a frozen
                # phase never runs a drifting kernel inside the chunk).
                step_fn = lambda carry, i: one_step_chees(
                    carry, i, data, adapt_enabled)
            else:
                grad_step = one_step_mala if mala else one_step_hmc
                step_fn = lambda carry, i: grad_step(carry, i, data)
            (state, accept_counts, _, _), trace = lax.scan(
                step_fn,
                _mala_carry(state, zero_counts, force_cold, data), jnp.arange(chunk)
            )
        else:
            plain_step = (one_step_stretch if stretch
                          else one_step_demc if demc
                          else one_step_slice if slice_k else one_step)
            (state, accept_counts, _), trace = lax.scan(
                lambda carry, i: plain_step(carry, i, data),
                (state, zero_counts, force_cold), jnp.arange(chunk)
            )
        state, out = _finish(state, accept_counts, trace, adapt_enabled, allow_refresh)
        if tempered:
            state, out["swap_rate"] = replica_swap(state, force_cold)
        if rescue_on:
            state = independence_rescue(state, force_cold, data)
        return state, out

    def run_with_history(state: WalkerState, adapt_enabled, allow_refresh,
                         force_cold=False, data=None):
        """Chunk runner that also returns thinned position history.

        History is collected on device as ``(chunk//thin, W, d)`` (every
        ``thin``-th step) — the ring-buffer replacement for the
        reference's cons-list walk (SURVEY §3.3) — and thinned *before*
        any host transfer.
        """
        if mala:
            step = one_step_mala
        elif hmc:
            step = one_step_hmc
        elif chees:
            def step(carry, i, data=None):
                return one_step_chees(carry, i, data, adapt_enabled)
        elif stretch:
            step = one_step_stretch
        elif demc:
            step = one_step_demc
        elif slice_k:
            step = one_step_slice
        else:
            step = one_step

        def one_step_hist(carry, i):
            carry, out = step(carry, i, data)
            return carry, (out, carry[0].position, carry[0].logprob)

        zero_counts = jnp.zeros((state.position.shape[0],), state.position.dtype)
        if gradk:
            carry0 = _mala_carry(state, zero_counts, force_cold, data)
        else:
            carry0 = (state, zero_counts, force_cold)

        if chunk % thin == 0 and thin > 1:
            # Nested scans: inner `thin` steps emit no ys, the outer scan
            # records only the block-final position — the stacked device
            # history is (chunk/thin, W, d) instead of (chunk, W, d)
            # before slicing (629 MB -> 63 MB at the W=131072 defaults).
            def inner(carry, i):
                return step(carry, i, data)

            def outer(carry, k):
                carry, trace_blk = lax.scan(
                    inner, carry, k * thin + jnp.arange(thin))
                st = carry[0]
                return carry, (trace_blk, st.position, st.logprob)

            carry, (trace_blocks, positions, logprobs) = lax.scan(
                outer, carry0, jnp.arange(chunk // thin))
            # (K, thin, ...) -> (chunk, ...) per-step traces for _finish.
            trace = jax.tree_util.tree_map(
                lambda a: a.reshape((chunk,) + a.shape[2:]), trace_blocks)
        else:
            carry, (trace, all_positions, all_logprobs) = lax.scan(
                one_step_hist, carry0, jnp.arange(chunk))
            positions = all_positions[thin - 1 :: thin]
            logprobs = all_logprobs[thin - 1 :: thin]

        if gradk:
            state, accept_counts = carry[0], carry[1]
        else:
            state, accept_counts, _ = carry
        state, out = _finish(state, accept_counts, trace, adapt_enabled, allow_refresh)
        if tempered:
            state, out["swap_rate"] = replica_swap(state, force_cold)
        if rescue_on:
            state = independence_rescue(state, force_cold, data)
        out["positions"] = positions                        # (chunk//thin, W, d)
        out["logprobs"] = logprobs                          # (chunk//thin, W)
        return state, out

    return run, run_with_history
