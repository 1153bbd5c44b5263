"""High-level fitting API: Walker facade, adaptive driver, mcmc_fit.

Rebuilds the reference's L4 layer (mcmc-fitting.lisp):
  - ``walker-create`` (1132-1163): normalize fn/data/error/likelihood/prior
    to parallel lists, resolve data-dependent closures, evaluate the first
    step.  Global multi-dataset fitting is this same path with lists
    (shared parameters by name; test.lisp:58-70).
  - ``walker-adaptive-steps[-full]`` (862-947): the adaptive driver — here
    split at the host->device boundary: the 200-step chunks run as one jitted
    scan (kernel.py); the host loop below only does auto-stop, estop,
    history capture, and the shutdown schedule between chunks.
  - ``walker-many-steps`` (849-853): fixed-L stepping.
  - ``walker-sample-region`` (949-969): greedy proposal-scale tuner.
  - ``walker-get`` (487-543) / ``walker-modify`` (547-580): the query and
    mutation verbs, as methods on :class:`Walker`.
  - ``mcmc-fit`` (1165-1176): create + adaptive steps.

The Walker here is a *host facade* over an on-device ensemble
(:class:`~lisp_mcmc_tpu.kernel.WalkerState`): one reference walker = one
row of the ``(W, d)`` batch.  ``n_walkers=1`` reproduces the reference's
single-chain behavior; large W is the accelerator scaling story (SURVEY §3.4).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Mapping, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from . import control
from .data import Dataset, clean_data, clean_data_error
from .kernel import (
    FitConfig,
    build_chunk_runner,
    init_state,
    resolve_accept_band,
)
from .likelihoods import log_likelihood_normal, resolve_likelihood
from .ops.linalg import cholesky_clamped, sample_covariance
from .params import ParamSpec, normalize_params
from .priors import log_prior_flat, resolve_prior

__all__ = ["Walker", "walker_create", "mcmc_fit", "default_dtype",
           "unit_cube_view"]


def default_dtype():
    """float64 when x64 is enabled (parity runs), else float32 (device runs)."""
    return jnp.float64 if jax.config.jax_enable_x64 else jnp.float32


def _force_list(item):
    """``force-list`` (mcmc-fitting.lisp:755-759)."""
    if isinstance(item, (list, tuple)):
        return list(item)
    return [item]


def _split_rhat_host(pos: np.ndarray) -> np.ndarray:
    """Vectorized split Gelman-Rubin over a host (T, W, d) history -> (d,).

    Returns +inf for degenerate histories (fewer than 4 retained steps:
    each half-chain needs >= 2 samples for a ddof=1 variance), so callers
    treat "not enough history" as "not converged" rather than crashing.
    """
    t2 = pos.shape[0] // 2 * 2
    if t2 < 4:
        return np.full(pos.shape[-1], np.inf)
    halves = np.concatenate([pos[: t2 // 2], pos[t2 // 2 : t2]], axis=1)  # (T/2, 2W, d)
    n = halves.shape[0]
    chain_means = halves.mean(axis=0)                 # (2W, d)
    chain_vars = halves.var(axis=0, ddof=1)           # (2W, d)
    w = chain_vars.mean(axis=0)                       # (d,)
    b = n * chain_means.var(axis=0, ddof=1)
    var_plus = (n - 1) / n * w + b / n
    # Frozen ensemble reads NOT-converged, matching the device split_rhat
    # (ops/reductions.py) — see the relative-guard comment there.
    ok = w > 1e-12 * var_plus
    return np.where(ok, np.sqrt(var_plus / np.where(ok, w, 1.0)), np.inf)


def make_adam_sgdr_runner(vg, n_steps: int):
    """Whitened-Adam with cosine warm restarts: the shared ascent core.

    ``vg(pos, data) -> (values, grads)`` batched over walkers; returns
    ``run(pos0, s, lr, data)``.  Used by :meth:`Walker.optimize` and
    :func:`~lisp_mcmc_tpu.profile_likelihood` (which zeroes the pinned
    coordinate through ``s`` — a zero whitening scale makes its update
    exactly zero) so the measured tuning lives in ONE place.

    Cosine-annealed warm restarts (SGDR): Adam at constant lr stalls at
    a finite radius inside narrow correlated valleys (the line fit's
    (m, b) trough), and one long cosine decay runs out of step before
    reaching the bottom; cycles of decay-to-zero then fresh-moment
    restart measured exact least-squares convergence where both
    single-schedule variants missed at 3 decimals.
    """
    b1, b2, eps = 0.9, 0.999, 1e-8
    cycle = min(n_steps, 200)

    def run(pos0, s, lr, data):
        def step(carry, i):
            pos, m, v = carry
            ic = (i % cycle).astype(pos.dtype)
            fresh = ic == 0
            m = jnp.where(fresh, 0.0, m)
            v = jnp.where(fresh, 0.0, v)
            _, g = vg(pos, data)
            gz = jnp.where(jnp.isfinite(g), g, 0.0) * s
            m = b1 * m + (1 - b1) * gz
            v = b2 * v + (1 - b2) * gz * gz
            mhat = m / (1 - b1 ** (ic + 1.0))
            vhat = v / (1 - b2 ** (ic + 1.0))
            lr_t = lr * 0.5 * (1.0 + jnp.cos(jnp.pi * ic / cycle))
            pos = pos + lr_t * s * mhat / (jnp.sqrt(vhat) + eps)
            return (pos, m, v), None

        z = jnp.zeros_like(pos0)
        (pos, _, _), _ = lax.scan(step, (pos0, z, z),
                                  jnp.arange(n_steps), unroll=False)
        return pos

    return run


def history_block_columns(walker, width: int) -> list[np.ndarray]:
    """Column-index arrays, one per population, for a history of ``width``
    walker columns.

    The retained history may hold (a) every walker, or (b) the
    evenly-spaced ``history_walkers`` subsample, or (c) — when no rows
    were collected — ``_history``'s fallback to the FULL live ensemble.
    Group-aware consumers (diagnostics blocks, BatchedFit dataset
    views, the rhat stop rules) must map group ids through whichever
    ordering actually produced ``width``; assuming the subsample when
    the fallback fired silently scores one dataset with another's
    walkers (review finding, round 2).
    """
    g = getattr(walker, "group_ids", None)
    if g is None or getattr(walker, "n_groups", 1) <= 1:
        return [np.arange(width)]
    g = np.asarray(g)
    if width != g.size:
        retained = walker._history_walker_idx()
        if retained is not None and width == len(np.asarray(retained)):
            g = g[np.asarray(retained)]
        else:
            raise ValueError(
                f"history width {width} matches neither the ensemble "
                f"({g.size}) nor the retained walker subsample — "
                "cannot map dataset blocks")
    return [np.nonzero(g == s)[0] for s in range(int(walker.n_groups))]


def _rank_normalize_host(pos: np.ndarray) -> np.ndarray:
    """Average-rank normal scores per parameter over a (T, W, d) block.

    Host twin of ops/reductions._rank_normalize (same Blom scores, same
    tie policy — average ranks keep a frozen ensemble degenerate so the
    split-R-hat inf guard still fires)."""
    from scipy.special import ndtri
    from scipy.stats import rankdata

    t, w, d = pos.shape
    flat = pos.reshape(-1, d)
    r = rankdata(flat, method="average", axis=0)
    z = ndtri((r - 0.375) / (t * w + 0.25))
    return z.reshape(t, w, d)


def _nonzero_scales(vec):
    """Per-parameter magnitudes with zeros replaced by a small derived
    scale (so no proposal coordinate is permanently stuck)."""
    v = np.asarray(vec, dtype=np.float64)
    nonzero = np.abs(v[v != 0])
    fallback = 1e-3 * nonzero.mean() if nonzero.size else 1e-3
    return np.where(v == 0, fallback, v)


@dataclasses.dataclass
class _Term:
    """One (function, dataset, likelihood, prior) posterior term."""

    fn: Callable
    dataset: Dataset
    likelihood: Callable
    prior: Callable


class Walker:
    """Host facade over a vmapped walker ensemble.

    Query verbs (``walker-get``, mcmc-fitting.lisp:487-543) are methods:
    ``most_likely_params``, ``median_params``, ``stddev_params``,
    ``acceptance``, ``log_likelihoods``, ``covariance_matrix``,
    ``l_matrix``, ``unique_steps``, ``forward_steps`` ...
    Mutation verbs (``walker-modify``, 547-580) are ``reset``,
    ``reset_to_most_likely``, ``burn_steps``, ``keep_steps``,
    ``add_steps``, ``delete``.
    """

    def __init__(
        self,
        terms: list[_Term],
        spec: ParamSpec,
        initial_vector,
        *,
        n_walkers: int = 1,
        seed: int = 0,
        walker_jitter: float = 0.0,
        config: FitConfig | None = None,
        dtype=None,
        aux=None,
        group_ids=None,
        n_groups: int = 1,
        log_posterior: Callable | None = None,
        posterior_data=None,
        batched_log_posterior: Callable | None = None,
    ):
        self._custom_log_post = log_posterior
        self._custom_data = posterior_data
        # Optional whole-batch posterior ``(positions (W,d), data) -> (W,)``
        # for structured ensembles where per-walker vmap would gather.
        self._custom_batched = batched_log_posterior
        self.terms = terms
        self.spec = spec
        self.config = config or FitConfig()
        self.dtype = dtype or default_dtype()
        self.n_walkers = int(n_walkers)
        self._runner_cache: dict[Any, Any] = {}
        # Batched walker-set support: per-walker aux data + adaptation
        # groups (one per spectrum/dataset in vectorized set fits).
        self.aux = aux
        self.group_ids = None if group_ids is None else jnp.asarray(group_ids, jnp.int32)
        self.n_groups = int(n_groups)

        d = spec.ndim
        # prng_impl: both are deterministic per seed on a given backend
        # (which is faster on the GPU is not measured yet).
        key = jax.random.key(seed, impl=self.config.prng_impl)
        key, k_init = jax.random.split(key)
        initial_vector = jnp.asarray(initial_vector)
        if initial_vector.ndim == 2 and initial_vector.shape[0] > 1:
            if initial_vector.shape[1] != d:
                raise ValueError(
                    f"initial_vector has {initial_vector.shape[1]} parameters "
                    f"but the spec defines {d} ({spec.keys})"
                )
            position = jnp.asarray(initial_vector, self.dtype)
            vec = position[0]
            # A (W, d) start defines the ensemble size; an explicit
            # contradictory n_walkers is an error, the default (1) adopts it.
            if self.n_walkers not in (1, position.shape[0]):
                raise ValueError(
                    f"initial_vector has {position.shape[0]} walkers but "
                    f"n_walkers={self.n_walkers}"
                )
            self.n_walkers = int(position.shape[0])
        else:
            initial_vector = initial_vector.reshape(-1)
            vec = jnp.asarray(initial_vector, self.dtype)
            position = jnp.broadcast_to(vec, (self.n_walkers, d)).astype(self.dtype)
        if walker_jitter > 0:
            noise = jax.random.normal(k_init, position.shape, self.dtype)
            position = position * (1.0 + walker_jitter * noise)

        self._log_post_one = self._build_log_posterior()
        logprob = self._eval_batch(position)
        l0 = self._initial_l_matrix(vec)
        self.state = init_state(key, position, logprob, l0, n_groups=self.n_groups)

        # Host-side thinned history ring (the walker's "walk", 471).
        self._hist_positions: list[np.ndarray] = []  # each (K, W, d)
        self._hist_logprobs: list[np.ndarray] = []   # each (K, W)
        # Chunk logs hold DEVICE scalars/arrays (lazy conversion — see
        # _record_chunk); consumers go through numpy which syncs on read.
        self._accept_log: list = []                  # per-chunk pooled acceptance
        self._swap_trace: list = []                  # per-chunk (K-1,) swap rates
        self._swap_betas: np.ndarray | None = None   # last tempered ladder
        self._lpmax_trace: list = []                 # per-step max-logprob traces
        self._lpmean_trace: list = []                # per-step ensemble means

    # ------------------------------------------------------------------ build

    def _build_log_posterior(self):
        """Posterior for ONE walker: ``log_post(theta[, aux_w], data)``.

        ``data`` is the pytree from :meth:`_posterior_data`, passed as a
        runtime argument (never a trace constant) so one compiled kernel
        serves every same-shaped dataset — fitting a new file of the same
        shape costs no recompile.
        """
        if getattr(self, "_custom_log_post", None) is not None:
            return self._custom_log_post
        terms = self.terms
        spec = self.spec

        def log_post(theta, datasets):
            params = spec.unflatten(theta)
            total = jnp.asarray(0.0, theta.dtype)
            for t, ds in zip(terms, datasets):
                total = total + t.likelihood(t.fn, params, ds)
                total = total + t.prior(params, ds)
            return total

        return log_post

    def _posterior_data(self):
        """The dataset pytree passed to the posterior at run time."""
        if getattr(self, "_custom_data", None) is not None:
            return self._custom_data
        return tuple(t.dataset for t in self.terms)

    def _initial_l_matrix(self, vec):
        """Cold-start proposal: diag of parameter values (mcmc-fitting.lisp:899).

        Deviation from the reference: an exactly-zero parameter would give a
        zero proposal stddev and a permanently stuck coordinate, so zeros are
        replaced by a small scale derived from the other parameters.
        """
        return jnp.asarray(np.diag(_nonzero_scales(vec)), self.dtype)

    def _eval_batch(self, positions):
        # jit (cached) rather than eager vmap: on remote-compile backends an
        # eager batch evaluation compiles every op separately (minutes for a
        # large custom posterior); one jitted program compiles once.
        fn = self._runner_cache.get("_eval_batch")
        if fn is None:
            if self._custom_batched is not None:
                fn = jax.jit(self._custom_batched)
            elif self.aux is None:
                fn = jax.jit(jax.vmap(self._log_post_one, in_axes=(0, None)))
            else:
                fn = jax.jit(jax.vmap(self._log_post_one, in_axes=(0, 0, None)))
            self._runner_cache["_eval_batch"] = fn
        if self._custom_batched is not None or self.aux is None:
            lp = fn(positions, self._posterior_data())
        else:
            lp = fn(positions, self.aux, self._posterior_data())
        # Same non-finite guard as the kernel's proposal path: a NaN initial
        # posterior would otherwise freeze every accept comparison forever.
        from .kernel import _neg_floor

        return jnp.where(jnp.isfinite(lp), lp, _neg_floor(lp.dtype))

    def _check_term_algebra(self):
        """Check the chunk kernel's term algebra against the XLA posterior.

        The kernel evaluates priors with ``dataset=None``.  A prior that
        branches on None (instead of raising) traces cleanly yet computes
        a different posterior, which shape tracing cannot see; one
        comparison at the current ensemble can.  Returns False when the
        terms are outside the kernel's coverage; raises when they
        disagree (the user opted in, so fail loudly).
        """
        from .ops.chunk_pallas import fused_terms_posterior

        fused = fused_terms_posterior(self.terms, self.spec, self.dtype)
        if fused is None:
            return False
        ref = np.asarray(self._eval_batch(self.state.position), np.float64)
        got = np.asarray(jax.jit(fused)(self.state.position), np.float64)
        finite = np.isfinite(ref) & np.isfinite(got)
        scale = np.maximum(np.abs(ref[finite]), 1.0)
        if finite.any() and np.max(np.abs(ref[finite] - got[finite]) / scale) > 1e-4:
            raise ValueError(
                "posterior_impl='pallas_chunk': the kernel's posterior "
                "disagrees with the XLA posterior at the current ensemble "
                "(a prior that reads its dataset argument cannot run in "
                "the kernel, which evaluates it with dataset=None); use "
                "the default XLA path for this fit")
        return True

    def _runner(self, greedy: bool = False, with_history: bool = True):
        cfg = dataclasses.replace(self.config, greedy=greedy)
        if cfg.tempering_rungs > 1:
            # n_steps is host-side only in tempered mode (the static rung
            # ladder replaces the schedule, which is n_steps-dependent);
            # normalize it out so different run lengths reuse the compiled
            # kernel instead of retracing.
            cfg = dataclasses.replace(cfg, n_steps=0)
        cache_key = (cfg, with_history)
        if cache_key not in self._runner_cache:
            pallas_chunk = None
            if (cfg.posterior_impl == "pallas_chunk" and not with_history
                    and getattr(self, "mesh", None) is None
                    and self.aux is None and self.group_ids is None
                    and self._custom_log_post is None
                    and self._custom_batched is None):
                # Whole-chunk kernel (ops/chunk_pallas.py); history
                # chunks and out-of-scope fits keep the XLA scan.  Priors
                # see dataset=None in the kernel, so a dataset-reading
                # prior fails loudly here, never silently in-kernel.
                if self._check_term_algebra():
                    from .ops.chunk_pallas import build_chunk_pallas

                    pallas_chunk = build_chunk_pallas(
                        self.terms, self.spec, cfg, self.n_walkers,
                        self.dtype)
            run, run_hist = build_chunk_runner(
                self._log_post_one, self.spec.ndim, cfg,
                group_ids=self.group_ids, n_groups=self.n_groups, aux=self.aux,
                batched_posterior=self._custom_batched,
                takes_data=True,
                pallas_chunk=pallas_chunk,
            )
            fn = run_hist if with_history else run
            jitted = jax.jit(fn)
            self._runner_cache[cache_key] = jitted
        return self._runner_cache[cache_key]

    # ------------------------------------------------------------- driver loop

    def shard(self, mesh=None):
        """Spread the walker ensemble across a device mesh (chain-axis DP).

        The kernel's pooled reductions become collectives automatically
        under jit (see :mod:`lisp_mcmc_tpu.parallel.mesh`).  Returns self.
        """
        from .parallel import make_mesh, replicated, shard_state

        mesh = mesh if mesh is not None else make_mesh()
        self.mesh = mesh
        self.state = shard_state(self.state, mesh)
        if jax.process_count() == 1:
            # Every shard reads the datasets: replicate them once, so no
            # chunk broadcasts them again from the first device.
            rep = replicated(mesh)
            put = lambda tree: jax.tree_util.tree_map(
                lambda a: jax.device_put(a, rep) if isinstance(a, jax.Array)
                else a, tree)
            self.terms = [dataclasses.replace(t, dataset=put(t.dataset))
                          for t in self.terms]
            self._custom_data = put(self._custom_data)
        self._runner_cache.clear()  # runners must rebuild without the chunk kernel
        return self

    @property
    def ndim(self) -> int:
        return self.spec.ndim

    @property
    def age(self) -> int:
        return int(self.state.age)

    @property
    def _thin(self) -> int:
        """History thinning as the kernel actually applies it
        (kernel.py clamps to ``min(thin, chunk_size)``); every host-side
        steps<->rows conversion must use this, not raw ``config.thin``,
        or lengths desynchronize 5x at thin=1000/chunk=200."""
        return max(1, min(self.config.thin, self.config.chunk_size))

    def __len__(self) -> int:
        """Retained history length in steps (walker-length analogue)."""
        return sum(h.shape[0] for h in self._hist_positions) * self._thin

    def adaptive_steps(self, n: int | None = None, *, temperature: float | None = None,
                       auto: str | None = "default", collect_history: bool = True,
                       progress: bool = False, l_matrix=None,
                       on_chunk: Callable | None = None):
        """Adaptive MH driver (``walker-adaptive-steps[-full]``, 862-947).

        Runs up to ``n`` steps in jitted 200-step chunks.  Auto-stop
        (``:prob-settle`` / ``:slope-settle``), annealing shutdown, estop,
        and history capture happen here, between chunks — the device/host split of
        the reference's do-loop (SURVEY §3.2).  ``l_matrix`` seeds the
        proposal factor (the reference's ``l-matrix`` kwarg, 862).
        """
        if l_matrix is not None:
            self._set_l_matrix(l_matrix)
        cfg = self.config
        if n is not None or temperature is not None or auto != "default":
            cfg = dataclasses.replace(
                cfg,
                n_steps=int(n) if n is not None else cfg.n_steps,
                temperature=float(temperature) if temperature is not None else cfg.temperature,
                auto=cfg.auto if auto == "default" else auto,
            )
        prev_config = self.config
        self.config = cfg
        try:
            self._adaptive_loop(cfg, collect_history, progress, on_chunk)
        finally:
            self.config = prev_config

    def _adaptive_loop(self, cfg: FitConfig, collect_history: bool,
                       progress: bool, on_chunk: Callable | None = None):
        control.clear_stop()
        if cfg.auto in ("rhat", "rank-rhat") and not collect_history:
            raise ValueError(
                f"auto={cfg.auto!r} computes split R-hat from the retained "
                "walker history; run with collect_history=True (or another "
                "auto mode)"
            )
        if cfg.kernel in ("stretch", "demc", "slice") and not cfg.greedy:
            # Pure ensemble moves CANNOT create spread they do not have:
            # a coordinate every walker agrees on exactly stays frozen
            # forever (stretch: prop_c = x_j,c + z (x_k,c - x_j,c) =
            # x_k,c; demc/slice: the donor difference is 0), with acceptance
            # pinned at 1 — a fit that silently does nothing.  The two
            # ways to get there are walker_jitter=0 creation and
            # reset_to_most_likely(); both are caught here, per
            # adaptation group (a single collapsed group in a batched
            # fit is just as frozen).
            pos = np.asarray(self.state.position)
            if self.group_ids is not None and self.n_groups:
                g = pos.reshape(self.n_groups, -1, pos.shape[-1])
                collapsed = (np.ptp(g, axis=1) == 0.0).any()
            else:
                collapsed = (np.ptp(pos, axis=0) == 0.0).any()
            if collapsed:
                raise ValueError(
                    f"{cfg.kernel} kernel: the ensemble has zero spread in "
                    "at least one coordinate (per adaptation group), which "
                    "ensemble moves can never escape — create the walker "
                    "with walker_jitter > 0 AND nonzero initial guesses "
                    "(the jitter is multiplicative, so a parameter guessed "
                    "at exactly 0 stays 0 for every walker), or run an rwm "
                    "anneal first (after reset_to_most_likely, take some "
                    "rwm steps before switching kernels)")
        # Each adaptive run gets a fresh annealing clock (the reference
        # indexes its temps list by the do-loop's own counter, 919-921).
        self.state = dataclasses.replace(
            self.state, anneal_step=jnp.zeros((), jnp.int32)
        )
        d = self.ndim
        settle = cfg.steps_to_settle(d)
        chunk = cfg.chunk_size
        n_chunks = max(1, math.ceil(cfg.n_steps / chunk))
        # The cold finish is for posterior-producing runs; a tempered
        # SEARCH phase keeps its ladder for the whole budget (users sample
        # afterwards) — otherwise the max(2000, settle) cold tail would
        # dominate short tempered runs with the ladder disabled.
        if cfg.tempering_rungs > 1:
            shutdown_chunks = 0
        else:
            shutdown_chunks = max(1, math.ceil(max(2000, settle) / chunk))
        runner = self._runner(greedy=False, with_history=collect_history)

        shutting_down = False
        remaining = n_chunks
        i_chunk = 0
        pending_out = None  # previous chunk's metrics: recorded AFTER the
        # next chunk is dispatched so the (blocking) history transfer
        # overlaps device execution instead of stalling the pipeline.
        with control.interruptible():
            while remaining > 0 and not control.stop_requested():
                # Shutdown = the reference's cold finish (915-917): refresh
                # disabled and temperature pinned to 1 (force_cold).
                # In-band refresh cadence: the reference refreshes from its
                # single-chain history only every 2*settle steps (929-931);
                # this ensemble pools accepted-move moments over W walkers,
                # so one chunk already holds ~W*chunk*acc samples and the
                # default refreshes every chunk (markedly faster adaptation,
                # measured).  Set FitConfig.refresh_every=2*settle for the
                # reference cadence.  Flags are traced device booleans so
                # flipping them mid-run does NOT retrace/recompile.
                if cfg.refresh_every > 0:
                    refresh_due = ((i_chunk + 1) * chunk) % cfg.refresh_every < chunk
                else:
                    refresh_due = True
                state, out = runner(
                    self.state,
                    jnp.asarray(True),
                    jnp.asarray(refresh_due and not shutting_down),
                    jnp.asarray(shutting_down),
                    self._posterior_data(),
                )
                self.state = state
                if pending_out is not None:
                    self._record_chunk(pending_out, collect_history)
                pending_out = out
                i_chunk += 1
                remaining -= 1
                step = i_chunk * chunk

                if on_chunk is not None:
                    # Observability hook (SURVEY §5 metrics): per-chunk
                    # scalars; return True to request a graceful stop.
                    if on_chunk(step, {
                        "accept_rate": float(out["accept_rate"]),
                        "logprob_max": float(out["logprob_max"][-1]),
                        "logprob_mean": float(out["logprob_mean"][-1]),
                        "shutting_down": shutting_down,
                    }):
                        control.request_stop()
                if progress and i_chunk % 25 == 0:
                    print(
                        f"step {step}: acc={float(out['accept_rate']):.3f} "
                        f"best={float(jnp.max(self.state.best_logprob)):.3f}"
                    )

                if shutting_down:
                    continue
                # Enter shutdown when close to the end (906) ...
                if remaining <= shutdown_chunks:
                    shutting_down = True
                    continue
                # ... or when auto-stop triggers (907-917).  The gate uses
                # the kernel's resolved acceptance band (the reference's
                # 0.2 < acc < 0.5 is band_high + 0.1 for random walk;
                # MALA's band sits at ~0.574, so the hardcoded gate would
                # never fire there).
                if (cfg.auto and step % 1000 < chunk and step > 2 * settle
                        and self._accept_log):
                    k = max(1, 1000 // chunk)  # last ~1000 steps of chunks
                    acc = float(np.mean(np.asarray(self._accept_log[-k:])))
                    gate_low, gate_high = resolve_accept_band(cfg)
                    if (gate_low < acc < gate_high + 0.1
                            and self._auto_settled(cfg, settle)):
                        shutting_down = True
                        remaining = max(1, shutdown_chunks)
            if pending_out is not None:
                self._record_chunk(pending_out, collect_history)

    def _record_chunk(self, out, collect_history: bool):
        # Store DEVICE values: converting here (float()/np.asarray) would
        # block the dispatch pipeline on every chunk — measured 3x
        # end-to-end slowdown on high-latency hosts.  Consumers convert
        # lazily (auto-stop every ~1000 steps, queries on demand).
        self._accept_log.append(out["accept_rate"])
        self._lpmax_trace.append(out["logprob_max"])
        self._lpmean_trace.append(out["logprob_mean"])
        if "swap_rate" in out:
            self._swap_trace.append(out["swap_rate"])   # device (K-1,)
        # Cap the auto-stop traces: only the last few settle windows are
        # ever read, so multi-million-step runs must not grow them
        # unboundedly (one (chunk,) array per chunk).
        max_trace_chunks = max(
            1, 4 * max(self.config.steps_to_settle(self.ndim), 2500)
            // self.config.chunk_size
        )
        if len(self._lpmax_trace) > 2 * max_trace_chunks:
            del self._lpmax_trace[:-max_trace_chunks]
            del self._lpmean_trace[:-max_trace_chunks]
            del self._accept_log[:-max_trace_chunks]
        if len(self._swap_trace) > 2 * max_trace_chunks:
            del self._swap_trace[:-max_trace_chunks]
        if collect_history and "positions" in out:
            pos, lp = out["positions"], out["logprobs"]
            idx = self._history_walker_idx()
            if idx is not None:
                # Slice ON DEVICE before the host transfer:
                # full (K, 131072, d) chunks are ~9.4 GB/run at defaults;
                # the subsample keeps diagnostics sound and the host alive.
                pos = jnp.take(pos, idx, axis=1)
                lp = jnp.take(lp, idx, axis=1)
            self._hist_positions.append(np.asarray(pos))
            self._hist_logprobs.append(np.asarray(lp))
            self._trim_history()

    def _history_walker_idx(self):
        """Evenly-spaced walker subsample for host history retention, or
        None when every walker's trace is kept (W <= history_walkers)."""
        k = self.config.history_walkers
        if not k or self.n_walkers <= k:
            return None
        cached = getattr(self, "_hist_idx", None)
        if cached is None or cached[0] != (k, self.n_walkers):
            self._hist_idx = ((k, self.n_walkers), jnp.asarray(
                np.linspace(0, self.n_walkers - 1, k).astype(np.int32)))
        return self._hist_idx[1]

    def _trim_history(self):
        max_entries = max(1, self.config.max_history // self._thin)
        # Byte cap (VERDICT r1 #4): positions + logprobs per retained row.
        first = self._hist_positions[0]
        row_bytes = (first.shape[1] * (first.shape[2] + 1)) * first.dtype.itemsize
        max_entries = min(max_entries,
                          max(1, self.config.max_history_bytes // row_bytes))
        total = sum(h.shape[0] for h in self._hist_positions)
        while total > max_entries and len(self._hist_positions) > 1:
            total -= self._hist_positions.pop(0).shape[0]
            self._hist_logprobs.pop(0)

    def _auto_settled(self, cfg: FitConfig, settle: int) -> bool:
        trace = np.concatenate(self._lpmax_trace) if self._lpmax_trace else np.empty(0)
        if trace.size < max(settle, 400):
            return False
        if cfg.auto == "prob-settle":
            # stable-probs-p (880-885): stable max values + healthy spread.
            window = trace[-settle:]
            early_max = window[:200].max()
            late_max = window[-200:].max()
            if self.n_walkers == 1:
                # Reference semantics: a single chain's trace wanders by a
                # few log-units when healthy (the 4..9 band).
                return (abs(early_max - late_max) < 0.5
                        and 4 < (early_max - window.min()) < 9)
            # Ensemble semantics: the max over W walkers is nearly flat
            # once settled (the reference band would never trigger), so
            # require both the max trace and the ensemble-mean trace to
            # have stopped drifting.
            if not self._lpmean_trace:
                return abs(early_max - late_max) < 0.5
            mean_trace = np.concatenate(self._lpmean_trace)[-settle:]
            mean_drift = abs(mean_trace[:200].mean() - mean_trace[-200:].mean())
            return abs(early_max - late_max) < 0.5 and mean_drift < 0.5
        if cfg.auto in ("rhat", "rank-rhat"):
            # Ensemble-native convergence (new surface): stop when the
            # split Gelman-Rubin statistic over the walker ensemble drops
            # below 1.01 for every parameter — a principled criterion the
            # single-chain reference could not compute.  Pure numpy on the
            # already-host-resident history (no device round-trips).
            # "rank-rhat" applies the Vehtari-2021 upgrade: rank-normal
            # bulk AND folded-tail statistics (the tail catches
            # scale-only disagreement the classic test is blind to).
            if not self._hist_positions:
                return False
            pos, _ = self._history(max(settle, 1000))  # (T, W, d) numpy
            if pos.shape[0] * self._thin < settle:
                return False
            # Per-population blocks: a BatchedFit pools walkers that
            # target DIFFERENT posteriors, so the pooled statistic
            # reads >> 1 forever and the stop could never fire —
            # converged means EVERY dataset's block converged.
            for cols in history_block_columns(self, pos.shape[1]):
                blk = pos[:, cols, :]
                if cfg.auto == "rhat":
                    if float(np.max(_split_rhat_host(blk))) >= 1.01:
                        return False
                    continue
                bulk = _split_rhat_host(_rank_normalize_host(blk))
                folded = np.abs(blk - np.median(blk, axis=(0, 1),
                                                keepdims=True))
                tail = _split_rhat_host(_rank_normalize_host(folded))
                if float(max(np.max(bulk), np.max(tail))) >= 1.01:
                    return False
            return True
        if cfg.auto == "slope-settle":
            # stable-prob-slope-p (886-887) rebuilt as a closed-form OLS
            # slope on the trace instead of the reference's nested MCMC
            # line fit: stop when the drift over the window is < 1 in
            # log-likelihood units.
            window = trace[-max(2500, settle):]
            x = np.arange(window.size, dtype=np.float64)
            slope = np.polyfit(x, window, 1)[0]
            return abs(slope) * window.size < 1.0
        return False

    def _set_l_matrix(self, l_matrix):
        l = jnp.asarray(l_matrix, self.dtype)
        if l.ndim == 2:
            l = jnp.broadcast_to(l, (self.n_groups,) + l.shape)
        self.state = dataclasses.replace(self.state, l_matrix=l)

    def tempered_steps(self, n: int, rungs: int = 8, t_max: float | None = None,
                       collect_history: bool = False, betas=None,
                       auto_ladder: bool = False):
        """Parallel-tempering SEARCH phase (replica exchange, new surface).

        Splits the ensemble into ``rungs`` contiguous blocks holding a
        geometric temperature ladder from 1 to ``t_max`` (default: the
        config temperature, at least 10); replicas swap between adjacent
        rungs at every chunk boundary.  Hot rungs cross likelihood
        barriers, swaps carry good states down to the cold rung — far
        stronger global search than the reference's annealing on
        multimodal posteriors.  Best-step tracking remains exact
        (``logprob`` is always untempered); retained history mixes
        temperatures, so it is off by default — draw posterior samples
        afterwards with :meth:`adaptive_steps` or :meth:`sampling_steps`.

        ``betas`` overrides the geometric spacing with an explicit
        descending ladder (first entry 1.0).  ``auto_ladder=True``
        spends the first ~fifth of ``n`` as a pilot on the starting
        ladder, measures the per-pair swap rates (:meth:`swap_rates`),
        re-spaces the rungs to equalize the measured communication
        barrier (:func:`respace_ladder` — endpoints fixed, pairs with
        high rejection get rungs packed between them), and runs the
        remainder on the new ladder (one extra compile).  The final
        ladder is what :meth:`swap_rates` and
        :meth:`log_evidence`'s TI integrand see.  With
        ``collect_history=True``, ``auto_ladder`` RESETS retained
        history at the respace so every collected row belongs to the
        final ladder (``log_evidence`` depends on this purity).
        """
        if self.aux is not None or self.group_ids is not None:
            raise ValueError("tempering is unavailable for batched/grouped fits")
        K = int(rungs)
        if K < 2 or self.n_walkers % K:
            raise ValueError(f"rungs must be >= 2 and divide n_walkers={self.n_walkers}")
        prev_config = self.config
        prev_groups = (self.group_ids, self.n_groups)
        d = self.ndim
        # One adaptation group per rung: widen the group-axis state.
        self.group_ids = jnp.asarray(
            np.repeat(np.arange(K, dtype=np.int32), self.n_walkers // K)
        )
        self.n_groups = K
        prev_chees = self.state.chees
        self.state = dataclasses.replace(
            self.state,
            l_matrix=jnp.broadcast_to(
                self.state.l_matrix[0], (K, d, d)
            ).astype(self.dtype),
            m_sum=jnp.zeros((K, d), self.dtype),
            m_outer=jnp.zeros((K, d, d), self.dtype),
            m_count=jnp.zeros((K,), self.dtype),
            chees=jnp.zeros((K, 4), self.dtype),
        )
        self.config = dataclasses.replace(
            self.config,
            tempering_rungs=K,
            kernel="rwm",
            n_steps=int(n),
            auto=None,
            temperature=float(t_max if t_max is not None
                              else max(self.config.temperature, 10.0)),
            tempering_betas=tuple(float(b) for b in betas) if betas is not None
            else (),
        )
        # Fresh ladder observability for THIS run (kernel.py ladder).
        self._swap_trace = []
        self._swap_betas = np.asarray(self.config.tempering_betas, np.float64) \
            if self.config.tempering_betas else 1.0 / np.asarray(
                [self.config.temperature ** (k / (K - 1)) for k in range(K)],
                np.float64)
        try:
            if auto_ladder:
                # Pilot on the starting ladder: measure the pair swap
                # rates, then re-space and run the remainder.  History
                # stays off for the pilot; when the caller collects
                # history (log_evidence), the pre-respace rows must not
                # contaminate the final ladder's samples.
                chunk = self.config.chunk_size
                n_pilot = min(max(8 * chunk, int(n) // 5),
                              max(chunk, int(n) // 2))
                n_pilot = max(2 * chunk, (n_pilot // chunk) * chunk)
                self.config = dataclasses.replace(self.config,
                                                  n_steps=int(n_pilot))
                self._adaptive_loop(self.config, False, False)
                rates = self.swap_rates()["pair_rates"]
                new_betas = respace_ladder(self._swap_betas, rates)
                self._swap_trace = []
                self._swap_betas = new_betas
                if collect_history:
                    self.reset()
                self.config = dataclasses.replace(
                    self.config,
                    n_steps=int(max(chunk, int(n) - n_pilot)),
                    tempering_betas=tuple(float(b) for b in new_betas))
            self._adaptive_loop(self.config, collect_history, False)
        finally:
            self.config = prev_config
            self.group_ids, self.n_groups = prev_groups
            # Collapse the group axis back: keep the cold rung's proposal.
            self.state = dataclasses.replace(
                self.state,
                l_matrix=self.state.l_matrix[:1],
                m_sum=jnp.zeros((1, d), self.dtype),
                m_outer=jnp.zeros((1, d, d), self.dtype),
                m_count=jnp.zeros((1,), self.dtype),
                # restore the pre-run trajectory state (a rwm tempered
                # search never touches it; zeroing would discard a
                # chees fit's learned t and re-pay the adaptation
                # transient on the next sampling phase)
                chees=jnp.asarray(prev_chees, self.dtype)[:1],
            )

    def chees_trajectory(self) -> dict:
        """ChEES-HMC trajectory-length diagnostics (``kernel="chees"``).

        Returns ``{"leapfrog": (G,), "budget": int, "at_cap": bool}`` —
        the adapted expected trajectory length per adaptation group in
        leapfrog units (``t``; each step integrates ``ceil(U(0,1) * t)``
        steps, so the mean cost is ``t/2`` gradient evaluations), the
        ``chees_max_leapfrog`` cap, and whether any group is pinned
        within 1% of it (raise the cap if so).  Before any chees steps
        the length reads the ``hmc_leapfrog`` starting value.
        """
        t_init = float(max(1, self.config.hmc_leapfrog))
        off = np.asarray(self.state.chees)[:, 0]
        t = t_init * np.exp(off)
        budget = int(self.config.chees_max_leapfrog)
        return {
            "leapfrog": t,
            "budget": budget,
            "at_cap": bool(np.any(t >= 0.99 * budget)),
        }

    def swap_rates(self) -> dict:
        """Replica-exchange diagnostics of the last tempered run.

        Returns ``{"betas": (K,), "pair_rates": (K-1,), "min_rate",
        "ok"}`` — ``pair_rates[k]`` is the measured swap acceptance
        between rungs k and k+1 (nanmean over chunks; parity
        alternation makes each pair active every other chunk).  The
        actionable reading: a pair near 0 is a ladder GAP (states never
        cross it — the hot rungs' exploration cannot reach the cold
        chain; raise ``rungs`` or lower ``t_max``), while rates near 1
        mean wasted rungs.  The classic healthy band is ~0.2-0.6.
        ``ok`` is True when every pair clears 0.05.  Valid after
        :meth:`tempered_steps` or :meth:`log_evidence` (both run the
        same ladder).  No reference analogue (the reference has no
        replica exchange).
        """
        if not self._swap_trace or self._swap_betas is None:
            raise ValueError("swap_rates: no tempered run recorded — call "
                             "tempered_steps/log_evidence first")
        rates = np.nanmean(
            np.asarray([np.asarray(r, np.float64) for r in self._swap_trace]),
            axis=0)
        return {"betas": self._swap_betas.copy(),
                "pair_rates": rates,
                "min_rate": float(np.nanmin(rates)),
                "ok": bool(np.nanmin(rates) > 0.05)}

    def log_evidence(self, n_steps: int = 20000, rungs: int = 16,
                     t_max: float = 1e5, **kwargs):
        """Marginal-likelihood estimate off the tempering ladder.

        Stepping-stone + thermodynamic-integration estimates of ``log Z``
        under the implied uniform-in-bounds prior — or, with a named
        ``prior=`` :class:`~lisp_mcmc_tpu.PriorSpec` (recovered
        automatically from a ``log_prior=spec`` fit), the true Bayesian
        integral ``L * pi`` (see :mod:`lisp_mcmc_tpu.evidence` for the
        measure-theoretic fine print and diagnostics).  The box path
        mutates the ensemble (it ends spread over the ladder) — re-anneal
        or :meth:`reset_to_most_likely` before drawing posterior samples;
        the named-prior path runs on a u-space view and leaves this
        ensemble untouched.
        """
        from .evidence import log_evidence as _log_evidence
        return _log_evidence(self, n_steps=n_steps, rungs=rungs,
                             t_max=t_max, **kwargs)

    def smc_sample(self, bounds=None, **kwargs):
        """Tempered Sequential Monte Carlo: prior box -> posterior.

        Re-draws the ensemble from the prior (uniform in ``bounds``, or
        exact draws from a named ``prior=`` spec), then runs the
        adaptive reweight/resample/move schedule of
        :func:`lisp_mcmc_tpu.smc.smc_sample` (which see).  Returns an
        ``SMCResult`` with the evidence estimate; the ensemble is left
        distributed as the posterior with mode weights preserved —
        the population-correct alternative to annealing on multimodal
        fits, and a from-different-machinery cross-check of
        :meth:`log_evidence`.
        """
        from .smc import smc_sample as _smc
        return _smc(self, bounds, **kwargs)

    def sampling_steps(self, n: int, kernel: str = "mala", **kwargs):
        """Cold sampling phase at T=1 with the given kernel.

        The production recipe for hard fits: anneal/converge with
        :meth:`adaptive_steps` (random walk), then draw posterior samples
        here — with ``kernel="mala"`` the gradient drift yields ~7x the
        effective samples per step (measured; see DESIGN.md).
        ``kernel="stretch"`` selects the affine-invariant ensemble moves
        instead (no gradients needed; robust to strong correlation and
        scale mismatch without any proposal adaptation), and
        ``kernel="demc"`` the differential-evolution moves (same
        adaptation-free robustness via walker-pair differences, with
        full-rank step directions that hold up at higher d and a
        gamma=1 mode-jump move for multimodal posteriors).
        ``kernel="slice"`` runs ensemble slice sampling (Karamanis &
        Beutler 2021): demc's pair-difference directions with Neal
        stepping-out/shrinkage instead of an MH rejection — every step
        lands in the slice, at a few posterior evaluations per step;
        the strongest gradient-free per-step mixing when evaluations
        are cheap.  ``kernel="chees"`` runs ChEES-HMC (Hoffman et al.
        2021): HMC whose trajectory length self-tunes on device by
        ensemble gradient ascent of the ChEES criterion — pick it over
        ``"hmc"`` when you don't want to guess ``hmc_leapfrog``
        (inspect the adapted length with :meth:`chees_trajectory`).
        """
        prev_config = self.config
        self.config = dataclasses.replace(self.config, kernel=kernel)
        try:
            self.adaptive_steps(n, temperature=1.0,
                                auto=kwargs.pop("auto", None), **kwargs)
        finally:
            self.config = prev_config

    def many_steps(self, n: int, l_matrix=None):
        """Fixed-L stepping, no adaptation, T=1 (``walker-many-steps``,
        849-853: "No temperature or any other intelligent features")."""
        if l_matrix is not None:
            self._set_l_matrix(l_matrix)
        else:
            # Reference default: diag(1e-2 * median params) (851), with the
            # same zero-parameter guard as the cold start (a zero entry
            # would freeze that coordinate permanently).
            med = self.median_params_vector()
            self._set_l_matrix(np.diag(1e-2 * _nonzero_scales(med)))
        runner = self._runner(greedy=False, with_history=True)
        chunks = max(1, math.ceil(n / self.config.chunk_size))
        control.clear_stop()
        with control.interruptible():
            for _ in range(chunks):
                if control.stop_requested():
                    break
                state, out = runner(  # cold, no adaptation
                    self.state, False, False, True, self._posterior_data()
                )
                self.state = state
                self._record_chunk(out, True)

    def sample_region(self, initial_scale: float = 1e-3, n: int = 3000):
        """Greedy proposal tuner (``walker-sample-region``, 949-969).

        Pretend-steps (greedy accept, no temperature) with aggressive L
        rescaling: x0.25 when acceptance collapses, x1.7 when it's high
        (967-968), checked on a 50-step cadence like the reference's
        50-step acceptance window.
        """
        control.clear_stop()
        best = _nonzero_scales(self.best_params_vector())
        self._set_l_matrix(initial_scale * np.diag(best))
        prev_config = self.config
        self.config = dataclasses.replace(self.config, chunk_size=50)
        try:
            self._sample_region_loop(n)
        finally:
            self.config = prev_config

    def _sample_region_loop(self, n: int):
        runner = self._runner(greedy=True, with_history=False)
        chunks = max(1, math.ceil(n / self.config.chunk_size))
        # Tuner statistics stay OUT of the adaptive run's chunk logs
        # (different chunk size and accept semantics would desynchronize
        # acceptance() windows and the auto-stop traces).
        self.tuner_accept_log: list[float] = []
        for _ in range(chunks):
            if control.stop_requested():
                break
            state, out = runner(self.state, False, False, True, self._posterior_data())
            acc = float(out["accept_rate"])
            scale = 0.25 if acc <= 0.02 else (1.7 if acc > 0.08 else 1.0)
            state = dataclasses.replace(state, l_matrix=state.l_matrix * scale)
            self.state = state
            self.tuner_accept_log.append(acc)

    def force_step(self):
        """Re-evaluate the posterior at the current params
        (``walker-force-take-step``, 1124-1129; used after dataset hot-swap)."""
        logprob = self._eval_batch(self.state.position)
        self.state = dataclasses.replace(self.state, logprob=logprob)

    def swap_data(self, datasets: Sequence[Dataset]):
        """Replace the datasets term-by-term, then re-evaluate in place."""
        if self._custom_log_post is not None:
            raise ValueError(
                "swap_data: this walker uses a custom log-posterior that "
                "closes over its data (e.g. BatchedNVFit); recreate the fit "
                "with the new data instead"
            )
        if len(datasets) != len(self.terms):
            raise ValueError("swap_data: dataset count must match term count")
        self.terms = [dataclasses.replace(t, dataset=d) for t, d in zip(self.terms, datasets)]
        self._log_post_one = self._build_log_posterior()
        self._runner_cache.clear()
        self.force_step()
        # Best-step tracking restarts under the new posterior — the old
        # best_logprob belongs to a different distribution and would never
        # be beaten (or would win spuriously).
        self.state = dataclasses.replace(
            self.state,
            best_position=self.state.position,
            best_logprob=self.state.logprob,
        )

    # ------------------------------------------------------------- query verbs

    def _history(self, take: int | None = None):
        """Stacked host history: (T, W, d) positions, (T, W) logprobs."""
        if not self._hist_positions:
            pos = np.asarray(self.state.position)[None]
            lp = np.asarray(self.state.logprob)[None]
        else:
            pos = np.concatenate(self._hist_positions, axis=0)
            lp = np.concatenate(self._hist_logprobs, axis=0)
        if take is not None:
            k = max(1, int(take) // self._thin)
            pos, lp = pos[-k:], lp[-k:]
        return pos, lp

    def steps(self, take: int | None = None):
        """Flattened samples: ((T*W), d) params + (T*W,) logprobs (``:steps``)."""
        pos, lp = self._history(take)
        return pos.reshape(-1, self.ndim), lp.reshape(-1)

    def unique_steps(self, take: int | None = None, walker: int = 0):
        """Per-walker dedup of consecutive equal-prob steps (``:unique-steps``, 492)."""
        pos, lp = self._history(take)
        p, l = pos[:, walker], lp[:, walker]
        keep = np.ones(len(l), dtype=bool)
        keep[1:] = l[1:] != l[:-1]
        return p[keep]

    def forward_steps(self, take: int | None = None, walker: int = 0):
        """Steps that improved the posterior (``:forward-steps``, 497-502)."""
        pos, lp = self._history(take)
        p, l = pos[:, walker], lp[:, walker]
        keep = np.zeros(len(l), dtype=bool)
        keep[1:] = l[1:] > l[:-1]
        keep[0] = True
        return p[keep]

    def best_params_vector(self):
        """Flat (d,) vector of the global best step's parameters."""
        best_walker = int(jnp.argmax(self.state.best_logprob))
        return self.state.best_position[best_walker]

    def most_likely_step(self):
        """Global best step over all walkers (``:most-likely-step``, 503)."""
        best_walker = int(jnp.argmax(self.state.best_logprob))
        return (
            float(self.state.best_logprob[best_walker]),
            self.spec.make(np.asarray(self.state.best_position[best_walker]).tolist()),
        )

    def most_likely_params(self) -> dict[str, float]:
        """``:most-likely-params`` (511-515)."""
        return self.most_likely_step()[1]

    def median_params_vector(self, take: int | None = None):
        """Flat (d,) per-parameter posterior medians over history."""
        pos, _ = self._history(take)
        return np.median(pos.reshape(-1, self.ndim), axis=0)

    def median_params(self, take: int | None = None) -> dict[str, float]:
        """Posterior median over retained history (``:median-params``, 516-523)."""
        return self.spec.make(self.median_params_vector(take).tolist())

    def mean_params(self, take: int | None = None) -> dict[str, float]:
        """Posterior mean of each parameter over retained history."""
        pos, _ = self._history(take)
        return self.spec.make(np.mean(pos.reshape(-1, self.ndim), axis=0).tolist())

    def acceptance(self, take: int | None = None) -> float:
        """Exact pooled acceptance rate over recent chunks (``:acceptance``, 506).

        The reference estimates acceptance by deduplicating consecutive
        probabilities of one chain; the kernel tracks accept decisions
        directly, so this is exact.
        """
        if not self._accept_log:
            return 0.0
        k = max(1, (take or 1000) // self.config.chunk_size)
        return float(np.mean(self._accept_log[-k:]))

    def log_likelihoods(self, take: int | None = None, walker: int | None = None):
        """Logprob trace (``:log-liklihoods``, 540): (T, W) or (T,) for one walker."""
        _, lp = self._history(take)
        return lp if walker is None else lp[:, walker]

    def param_trace(self, name: str, take: int | None = None, walker: int = 0):
        """One parameter's trace for one walker (``:param``, 509)."""
        pos, _ = self._history(take)
        return pos[:, walker, self.spec.index(name)]

    def covariance_matrix(self, take: int | None = None):
        """Covariance of retained unique samples (``:covariance-matrix``, 541).

        Vectorized over the whole (T, W) history: consecutive equal-prob
        steps are masked per walker in one pass (not one history
        materialization per walker).
        """
        pos, lp = self._history(take)                   # (T, W, d), (T, W)
        keep = np.ones(lp.shape, dtype=bool)
        keep[1:] = lp[1:] != lp[:-1]
        samples = pos[keep]                             # (K, d)
        # Host-side population covariance (reference normalization /N,
        # mcmc-fitting.lisp:643); diagnostics avoid device round-trips.
        centered = samples - samples.mean(axis=0, keepdims=True)
        return centered.T @ centered / max(1, samples.shape[0])

    def l_matrix_estimate(self, take: int | None = None):
        """Cholesky of covariance of diffs of forward steps (``:l-matrix``, 543)."""
        pos, lp = self._history(take)                   # one host materialization
        fwd = np.zeros(lp.shape, dtype=bool)
        fwd[1:] = lp[1:] > lp[:-1]
        fwd[0] = True
        diffs = []
        for w in range(pos.shape[1]):
            f = pos[fwd[:, w], w]
            if len(f) > 1:
                diffs.append(np.diff(f, axis=0))
        if not diffs:
            return np.zeros((self.ndim, self.ndim))
        diffs = np.concatenate(diffs, axis=0)
        centered = diffs - diffs.mean(axis=0, keepdims=True)
        cov = centered.T @ centered / max(1, diffs.shape[0])
        chol, _ = cholesky_clamped(jnp.asarray(cov))
        return np.asarray(chol)

    def stddev_params(self, take: int | None = None) -> dict[str, float]:
        """Per-param proposal stddevs = diag of history L (``:stddev-params``, 525-539).

        Returns zeros when fewer than 10 retained steps, like the reference
        (527-528).
        """
        if len(self) < 10:
            return self.spec.make([0.0] * self.ndim)
        l = self.l_matrix_estimate(take)
        return self.spec.make(np.diag(l).tolist())

    def check_for_nonfinite(self, take: int | None = None):
        """NaN/Inf leak detector — ``walker-check-for-complex-walks`` (483-485)
        reborn: complex numbers cannot arise in this design, but non-finite
        posteriors/params are the equivalent failure."""
        pos, lp = self._history(take)
        bad_pos = ~np.isfinite(pos).all(axis=(0, 2))
        bad_lp = ~np.isfinite(lp).all(axis=0)
        bad = np.flatnonzero(bad_pos | bad_lp)
        return bad.tolist() if bad.size else None

    def diagnose_params(self, params: Mapping[str, float], aux_index: int = 0):
        """Probe the posterior at given params (``walker-diagnose-params``, 1200-1204).

        For batched fits with per-walker aux data (e.g. BatchedNVFit),
        ``aux_index`` selects which walker's aux (spectrum) to probe.
        """
        vec = self.spec.flatten(params, dtype=self.dtype)
        if self.aux is not None:
            aux_w = jax.tree_util.tree_map(lambda a: a[aux_index], self.aux)
            return float(self._log_post_one(vec, aux_w, self._posterior_data()))
        return float(self._log_post_one(vec, self._posterior_data()))

    # ---------------------------------------------------------- mutation verbs

    def reset(self):
        """Drop history, keep current position (``:reset``, 570-573)."""
        self._hist_positions.clear()
        self._hist_logprobs.clear()
        self._accept_log.clear()
        self._lpmax_trace.clear()
        self._lpmean_trace.clear()

    def optimize(self, n_steps: int = 500, learning_rate: float = 0.05,
                 rounds: int = 1):
        """Multi-start gradient ascent on the log-posterior (new surface).

        Every walker runs Adam in per-parameter-whitened coordinates
        (``z = theta / s``, ``s`` the ensemble's median parameter
        magnitudes — Adam's per-coordinate normalization then makes one
        ``learning_rate`` serve parameters spanning 13 orders of
        magnitude, e.g. x0~2e3 vs bg1~1e-10 on the flagship fit), all in
        one jitted ``lax.scan`` — W walkers are W optimization starts for
        free on the chain axis.  Ascent is LOCAL: it polishes whatever
        basin each walker occupies.  Production use: after annealing, a
        few hundred steps sharpen the MAP estimate far past what
        finite-acceptance MH polishing does; or from a deliberately wide
        ``walker_jitter`` as a multi-start global search.

        ``rounds`` reruns the whole schedule with the whitening scales
        REFIT to the improved ensemble between rounds — on stiff
        posteriors the first round's scales (from the scattered initial
        ensemble) are orders too coarse for the sharp optimum, and the
        refit is what converges them.  On the flagship fit from a cold
        walker_jitter=0.5 start, ``optimize(400, rounds=3)`` reaches the
        reference's basin without an anneal, whose temperature schedule
        is sequential (multi-start ascent is
        not).

        A walker only moves if its endpoint genuinely improved its
        log-posterior (non-finite excursions are discarded wholesale), so
        the ensemble never degrades.  Proposal state (L, moments) is
        untouched — follow with :meth:`adaptive_steps` /
        :meth:`sampling_steps` to re-adapt and draw posterior samples;
        a pure optimize->report workflow skips that entirely.
        """
        if n_steps <= 0:
            raise ValueError(f"n_steps must be positive, got {n_steps}")
        if rounds <= 0:
            raise ValueError(f"rounds must be positive, got {rounds}")
        for _ in range(rounds):
            if control.stop_requested():
                break  # estop: completed rounds already improved the state
            self._optimize_round(n_steps, learning_rate)

    def _optimize_round(self, n_steps: int, learning_rate: float):
        data = self._posterior_data()
        s = jnp.asarray(
            _nonzero_scales(np.median(np.abs(np.asarray(self.state.position)), axis=0)),
            self.dtype,
        )

        key = ("optimize", int(n_steps))
        fn = self._runner_cache.get(key)
        if fn is None:
            if self.aux is None:
                _vg = jax.vmap(jax.value_and_grad(self._log_post_one),
                               in_axes=(0, None))
                vg = lambda pos, data: _vg(pos, data)
            else:
                _vg = jax.vmap(jax.value_and_grad(self._log_post_one),
                               in_axes=(0, 0, None))
                aux = self.aux
                vg = lambda pos, data: _vg(pos, aux, data)
            fn = jax.jit(make_adam_sgdr_runner(vg, n_steps))
            self._runner_cache[key] = fn

        lr = jnp.asarray(learning_rate, self.dtype)
        new_pos = fn(self.state.position, s, lr, data)
        new_pos = jnp.where(jnp.all(jnp.isfinite(new_pos), axis=1)[:, None],
                            new_pos, self.state.position)
        new_lp = self._eval_batch(new_pos)
        improved = new_lp > self.state.logprob
        position = jnp.where(improved[:, None], new_pos, self.state.position)
        logprob = jnp.where(improved, new_lp, self.state.logprob)
        better = logprob > self.state.best_logprob
        self.state = dataclasses.replace(
            self.state,
            position=position.astype(self.dtype),
            logprob=logprob.astype(self.dtype),
            best_position=jnp.where(better[:, None], position,
                                    self.state.best_position).astype(self.dtype),
            best_logprob=jnp.where(better, logprob,
                                   self.state.best_logprob).astype(self.dtype),
        )

    def reset_to_most_likely(self):
        """Restart every walker at the global best (``:reset-to-most-likely``, 574-578)."""
        best_walker = int(jnp.argmax(self.state.best_logprob))
        best_pos = self.state.best_position[best_walker]
        best_lp = self.state.best_logprob[best_walker]
        W = self.n_walkers
        self.state = dataclasses.replace(
            self.state,
            position=jnp.broadcast_to(best_pos, (W, self.ndim)).astype(self.dtype),
            logprob=jnp.broadcast_to(best_lp, (W,)).astype(self.dtype),
        )
        self.reset()

    def burn_steps(self, burn_number: int):
        """Drop the oldest ``burn_number`` steps (``:burn-walks``, 566-567)."""
        if not self._hist_positions:
            return  # nothing retained; don't store _history()'s synthetic fallback
        k = burn_number // self._thin
        pos, lp = self._history()
        pos, lp = pos[k:], lp[k:]
        self._hist_positions = [pos] if pos.size else []
        self._hist_logprobs = [lp] if lp.size else []

    def keep_steps(self, keep_number: int):
        """Keep only the newest ``keep_number`` steps (``:keep-walks``, 568-569)."""
        if not self._hist_positions:
            return  # nothing retained; don't store _history()'s synthetic fallback
        k = max(1, keep_number // self._thin)
        pos, lp = self._history()
        self._hist_positions = [pos[-k:]]
        self._hist_logprobs = [lp[-k:]]

    def add_steps(self, positions, logprobs):
        """Append externally produced history (``:add-walks``, 556-565) —
        which the reference version silently dropped (SURVEY §2.2); this one
        actually appends, and refreshes the best step."""
        positions = np.asarray(positions)
        logprobs = np.asarray(logprobs)
        if positions.ndim == 2:  # (T, d) single-walker -> broadcast to (T, W, d)
            positions = np.repeat(positions[:, None], self.n_walkers, axis=1)
            logprobs = np.repeat(logprobs[:, None], self.n_walkers, axis=1)
        self._hist_positions.append(positions)
        self._hist_logprobs.append(logprobs)
        # PER-WALKER best refresh: each walker may only adopt its OWN
        # column's maximum (a global argmax would hand every improved
        # walker the same position — in grouped fits, a point from a
        # different spectrum's posterior, contaminating best-value
        # refreshes and reset_to_most_likely).
        state = self.state
        col_best = logprobs.max(axis=0)                          # (W,)
        col_arg = logprobs.argmax(axis=0)                        # (W,)
        cand_pos = positions[col_arg, np.arange(positions.shape[1])]  # (W, d)
        better = jnp.asarray(col_best, self.dtype) > state.best_logprob
        self.state = dataclasses.replace(
            state,
            best_position=jnp.where(better[:, None],
                                    jnp.asarray(cand_pos, self.dtype),
                                    state.best_position),
            best_logprob=jnp.where(better, jnp.asarray(col_best, self.dtype),
                                   state.best_logprob),
        )

    def delete(self):
        """Free everything (``:delete``, 579-580)."""
        self.reset()
        self.terms = []
        self._runner_cache.clear()

    # ------------------------------------------------------------- plot verbs
    # Thin delegates to the plotting layer so the reference's walker-*
    # plot verbs read the same here: w.plot_data_and_fit(), w.corner_plot().

    def plot_data_and_fit(self, *args, **kwargs):
        from . import plotting

        return plotting.plot_data_and_fit(self, *args, **kwargs)

    def plot_residuals(self, *args, **kwargs):
        from . import plotting

        return plotting.plot_residuals(self, *args, **kwargs)

    def caterpillar_plots(self, *args, **kwargs):
        from . import plotting

        return plotting.caterpillar_plots(self, *args, **kwargs)

    def likelihood_plot(self, *args, **kwargs):
        from . import plotting

        return plotting.likelihood_plot(self, *args, **kwargs)

    def autocorrelation_plot(self, *args, **kwargs):
        from . import plotting

        return plotting.autocorrelation_plot(self, *args, **kwargs)

    def corner_plot(self, *args, **kwargs):
        from . import plotting

        return plotting.corner_plot(self, *args, **kwargs)

    def all_corner_plots(self, *args, **kwargs):
        from . import plotting

        return plotting.all_corner_plots(self, *args, **kwargs)

    def param_histogram(self, *args, **kwargs):
        from . import plotting

        return plotting.param_histogram(self, *args, **kwargs)

    def ppc_plot(self, *args, **kwargs):
        from . import plotting

        return plotting.ppc_plot(self, *args, **kwargs)

    def posterior_predictive(self, *args, **kwargs):
        """Replicated datasets from the posterior (``predictive`` module)."""
        from .predictive import posterior_predictive

        return posterior_predictive(self, *args, **kwargs)

    def ppc_pvalue(self, *args, **kwargs):
        """Posterior predictive p-value for a data statistic."""
        from .predictive import ppc_pvalue

        return ppc_pvalue(self, *args, **kwargs)

    def prior_predictive(self, *args, **kwargs):
        """Replicated datasets from the PRIOR (before-fitting check)."""
        from .predictive import prior_predictive

        return prior_predictive(self, *args, **kwargs)

    def laplace_approx(self, *args, **kwargs):
        """Curvature covariance + Laplace evidence at the MAP."""
        from .evidence import laplace_approx

        return laplace_approx(self, *args, **kwargs)

    def advi(self, *args, **kwargs):
        """Gaussian variational posterior + IS evidence (``variational``)."""
        from .variational import advi

        return advi(self, *args, **kwargs)

    def flow_advi(self, *args, **kwargs):
        """Normalizing-flow variational posterior + IS evidence
        (``variational.flow_advi``) — the non-Gaussian upgrade of
        :meth:`advi` for curved posteriors."""
        from .variational import flow_advi

        return flow_advi(self, *args, **kwargs)

    def predict(self, x, **kwargs):
        """Posterior prediction (curve band / prediction interval) at
        new abscissae."""
        from .predictive import predict

        return predict(self, x, **kwargs)

    def nested_sample(self, bounds=None, **kwargs):
        """Batched nested sampling: evidence + posterior in one run."""
        from .nested import nested_sample

        return nested_sample(self, bounds, **kwargs)

    def profile_likelihood(self, name: str, **kwargs):
        """Profile-likelihood CI for one parameter (batched masked Adam)."""
        from .profile import profile_likelihood

        return profile_likelihood(self, name, **kwargs)

    def summary(self, take: int | None = None) -> str:
        """Human-readable fit report (``diagnostics.summary``)."""
        from .diagnostics import summary

        return summary(self, take)

    def metrics(self, take: int | None = None,
                elapsed_seconds: float | None = None) -> dict:
        """Structured metrics snapshot (``diagnostics.metrics``)."""
        from .diagnostics import metrics

        return metrics(self, take, elapsed_seconds)

    def convergence(self, take: int | None = None, **kwargs) -> dict:
        """One-call Vehtari-2021 convergence verdict
        (``diagnostics.convergence``)."""
        from .diagnostics import convergence

        return convergence(self, take, **kwargs)

    def prior_sensitivity(self, prior=None, **kwargs):
        """Power-scaling prior/likelihood sensitivity + conflict verdict
        (``diagnostics.prior_sensitivity``)."""
        from .diagnostics import prior_sensitivity

        return prior_sensitivity(self, prior=prior, **kwargs)

    def audit(self, **kwargs):
        """One-call calibration report card: convergence + LOO-PIT +
        prior sensitivity with actionable advice (``diagnostics.audit``)."""
        from .diagnostics import audit

        return audit(self, **kwargs)

    def with_expression(self, expr: str, take: int | None = 1000):
        """Derived quantity at the most-likely params (``walker-with-exp``)."""
        from .expressions import walker_with_expression

        return walker_with_expression(self, expr, take)


def respace_ladder(betas, pair_rates, floor: float = 0.05) -> np.ndarray:
    """Equalize the measured communication barrier over a tempering ladder.

    Treat each adjacent pair's swap REJECTION (1 - rate) as the barrier
    mass in its beta interval, accumulate it at the rung edges, and
    place the new interior rungs at equal barrier increments (inverted
    by interpolation in log-beta; endpoints stay fixed).  Pairs with
    high rejection get rungs packed between them; near-free pairs donate
    theirs.  ``floor`` keeps fully-accepting pairs from collapsing to
    zero width (and substitutes for NaN rates from a pilot too short to
    activate both parities).  Deterministic given the measured rates —
    the measurement loop lives in ``tempered_steps(auto_ladder=True)``.
    """
    betas = np.asarray(betas, np.float64)
    rates = np.nan_to_num(np.asarray(pair_rates, np.float64), nan=1.0 - floor)
    if rates.shape != (betas.size - 1,):
        raise ValueError(f"respace_ladder: need {betas.size - 1} pair rates, "
                         f"got {rates.shape}")
    barrier = np.maximum(1.0 - rates, floor)
    lam = np.concatenate([[0.0], np.cumsum(barrier)])
    logb = np.log(betas)
    targets = np.linspace(0.0, lam[-1], betas.size)
    out = np.exp(np.interp(targets, lam, logb))
    out[0], out[-1] = betas[0], betas[-1]
    for i in range(1, out.size):               # strict descent guard
        out[i] = min(out[i], out[i - 1] * (1.0 - 1e-9))
    return out


# ------------------------------------------------------------------ factories


def unit_cube_view(walker, prior_spec, seed: int = 0) -> "Walker":
    """A u-space view of a fit: the declared prior becomes the unit cube.

    Every parameter is reparameterized through its prior's inverse CDF
    (``theta = F^-1(u)``), so on the returned walker the declared
    :class:`~lisp_mcmc_tpu.priors.PriorSpec` is exactly the Lebesgue
    measure on ``(0, 1)^d`` — which is what the box-based evidence
    machinery (ladder stepping-stone, SMC, nested sampling) assumes.
    Its posterior is

        ``logpost_u(u) = logpost(F^-1(u)) - installed(F^-1(u)) + wall(u)``

    where ``installed`` is the prior density term
    :meth:`PriorSpec.as_log_prior` adds (so the u-posterior is the pure
    likelihood against the prior measure: ``exp(logpost_u) du =
    L(theta) pi(theta) dtheta`` inside the cube) and ``wall`` the
    unit-rate exterior penalty.  The u-ensemble starts at the CDF image
    of the walker's current ensemble (the "fit-seeded" option); the
    estimators re-seed it uniform when prior-seeding is requested.

    The returned Walker shares the original's datasets, config, dtype,
    grouping, and custom-posterior structure; stepping it never touches
    the original fit's state.
    """
    from .priors import as_prior_spec, unit_cube_wall

    spec = as_prior_spec(prior_spec)
    keys = walker.spec.keys
    missing = [k for k in keys if k not in spec]
    if missing:
        raise ValueError(f"unit_cube_view: prior spec missing {missing}")
    base = walker._log_post_one

    def _theta(u):
        return spec.transform(u, keys)

    def _loglike_shift(u, th):
        return -spec.installed_vec(th, keys) + unit_cube_wall(u)

    if walker.aux is None:
        def log_post_u(u, data):
            th = _theta(u)
            return base(th, data) + _loglike_shift(u, th)
    else:
        def log_post_u(u, aux_w, data):
            th = _theta(u)
            return base(th, aux_w, data) + _loglike_shift(u, th)

    batched_u = None
    if getattr(walker, "_custom_batched", None) is not None:
        base_batched = walker._custom_batched

        def batched_u(positions, data):
            th = jax.vmap(_theta)(positions)
            shift = jax.vmap(_loglike_shift)(positions, th)
            return base_batched(th, data) + shift

    # CDF image of the current ensemble, clamped off the cube faces
    # (a start pinned AT 0/1 maps to +-inf parameters).
    eps = 1e-12 if walker.dtype == jnp.float64 else 1e-6
    u0 = np.clip(np.asarray(spec.inverse(walker.state.position, keys),
                            np.float64), eps, 1.0 - eps)
    uw = Walker(
        [], walker.spec, u0, seed=seed,
        config=walker.config, dtype=walker.dtype,
        aux=walker.aux, group_ids=walker.group_ids, n_groups=walker.n_groups,
        log_posterior=log_post_u, posterior_data=walker._posterior_data(),
        batched_log_posterior=batched_u,
    )
    if getattr(walker, "mesh", None) is not None:
        uw.shard(walker.mesh)
    uw._unit_cube_spec = spec
    uw._theta_of_u = jax.jit(jax.vmap(_theta))
    return uw


def walker_create(
    *,
    function,
    data,
    params,
    data_error=None,
    log_likelihood=None,
    log_prior=None,
    n_walkers: int = 1,
    seed: int = 0,
    walker_jitter: float = 0.0,
    config: FitConfig | None = None,
    dtype=None,
) -> Walker:
    """Create a fit (``walker-create``, mcmc-fitting.lisp:1132-1163).

    ``function``: model ``f(x, params_dict) -> y`` or a list of models for
    global multi-dataset fits (shared params by name, test.lisp:58-70).
    ``data``: ``(x, y)`` or a list of such pairs.  ``data_error``: scalar,
    per-dataset scalars, or per-point arrays (broadcast like
    ``clean-data-error``, 774-805).  ``log_likelihood`` / ``log_prior``:
    single callables or per-dataset lists; data-dependent factories are
    resolved once, like ``log-liklihood-fixer``/``log-prior-fixer``
    (837-845).
    """
    dtype = dtype or default_dtype()
    functions = _force_list(function)
    cleaned = clean_data(data, len(functions))
    errors = clean_data_error(data_error, cleaned)

    if isinstance(log_likelihood, (list, tuple)):
        likelihoods = [ll or log_likelihood_normal for ll in log_likelihood]
    else:
        likelihoods = [log_likelihood or log_likelihood_normal] * len(functions)
    def _coerce_prior(lp):
        # A PriorSpec/MVGaussian is accepted anywhere a prior callable
        # is: the term fits with its as_log_prior() density, and the
        # evidence layer recovers the full spec from _prior_spec.
        return lp.as_log_prior() if hasattr(lp, "as_log_prior") else lp

    if isinstance(log_prior, (list, tuple)):
        priors = [_coerce_prior(lp) or log_prior_flat for lp in log_prior]
    else:
        priors = [_coerce_prior(log_prior) or log_prior_flat] * len(functions)
    if not (len(functions) == len(cleaned) == len(likelihoods) == len(priors)):
        raise ValueError("walker_create: function/data/likelihood/prior counts must match")

    spec, vec = normalize_params(params, dtype=dtype)
    params_dict = spec.unflatten(vec)

    terms = []
    for fn, (x, y), err, ll, lp in zip(functions, cleaned, errors, likelihoods, priors):
        ds = Dataset.create(x, y, err, dtype=dtype)
        ll = resolve_likelihood(ll, fn, params_dict, ds)
        lp = resolve_prior(lp, params_dict, ds)
        terms.append(_Term(fn=fn, dataset=ds, likelihood=ll, prior=lp))

    return Walker(
        terms,
        spec,
        vec,
        n_walkers=n_walkers,
        seed=seed,
        walker_jitter=walker_jitter,
        config=config,
        dtype=dtype,
    )


def mcmc_fit(
    *,
    function,
    data,
    params,
    data_error=None,
    log_likelihood=None,
    log_prior=None,
    n_steps: int | None = None,
    n_walkers: int = 1,
    seed: int = 0,
    walker_jitter: float = 0.0,
    config: FitConfig | None = None,
    dtype=None,
) -> Walker:
    """Create a walker and run adaptive steps (``mcmc-fit``, 1165-1176)."""
    walker = walker_create(
        function=function,
        data=data,
        params=params,
        data_error=data_error,
        log_likelihood=log_likelihood,
        log_prior=log_prior,
        n_walkers=n_walkers,
        seed=seed,
        walker_jitter=walker_jitter,
        config=config,
        dtype=dtype,
    )
    walker.adaptive_steps(n_steps)
    return walker
