"""Whole-chunk MH stepping as one Pallas kernel on the GPU (Triton route).

The XLA chunk is a ``lax.scan`` whose body launches several kernels per
step (random draws, the posterior fusion, accept, moments), and whose
carry (positions, logprob, best step, moment accumulators: W(2d+2)
floats) makes a round trip through device memory every step.  This
kernel runs a walker block's whole ``chunk_size``-step chunk in one
program instead: proposal draw (counter hash + Box-Muller), model
evaluation, MH accept (mcmc-fitting.lisp:1091-1092), best tracking
(553-555) and the accepted-move moment sums stay in registers.

Layout: a grid over walker blocks of ``WB`` (a power of two) walkers.
Each parameter is its own ``(WB,)`` vector.  The dataset is padded to a
power of two and walked in ``(TN, WB)`` tiles inside each step, so a
tile's intermediates fit in registers.  Blocks load L and the scalars
themselves.  Per-block partial moments and trace rows are reduced
outside the kernel (no atomics).

Scope (callers keep the XLA scan outside it): ungrouped rwm, the library
likelihood reductions over 1-D x, no tempering, float32.  Priors run
in-kernel with ``dataset=None``; :func:`fused_terms_posterior` is the
same term algebra in plain ``jnp``, and the driver checks it against the
XLA posterior before using the kernel.  The random stream differs from
``jax.random``, so the kernel is validated statistically, not bitwise
(tests/test_chunk_pallas.py).
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

__all__ = ["build_chunk_pallas", "fusable_terms", "fused_terms_posterior",
           "pick_block"]

_CUTOFF_DEFAULT = -5000.0


def _likelihood_kind(likelihood) -> str | None:
    """Classify a likelihood reduction for in-kernel fusion.

    Identity-based: only the library reductions have known algebra.  A
    custom or data-specialized likelihood returns ``None`` (not fusable).
    """
    from ..likelihoods import (
        log_likelihood_normal,
        log_likelihood_normal_cutoff,
        log_likelihood_poisson,
    )

    if likelihood is log_likelihood_normal:  # weighted variant is an alias
        return "normal"
    if likelihood is log_likelihood_normal_cutoff:
        return "normal_cutoff"
    if likelihood is log_likelihood_poisson:
        return "poisson"
    return None


def fusable_terms(terms) -> bool:
    """True if every posterior term can run inside the chunk kernel."""
    for t in terms:
        if _likelihood_kind(t.likelihood) is None:
            return False
        if np.ndim(t.dataset.x) != 1:
            return False  # multi-column x: the XLA path handles it
    return True


def pick_block(n_walkers: int, preferred: int = 128) -> int | None:
    """Largest power-of-two walker block <= ``preferred`` dividing W (>= 16)."""
    wb = 1 << (max(int(preferred), 1).bit_length() - 1)
    while wb >= 16:
        if n_walkers % wb == 0:
            return wb
        wb //= 2
    return None


def _prepare_terms(terms, dtype, n_pad: int | None = None):
    """Walker-independent per-term inputs, shared by kernel and reference.

    Returns ``(term_inputs, term_meta, scalar_const)``: per-term tuples of
    1-D arrays (the first ``n`` real points, padded to ``n_pad`` with
    zero-weight copies of the last point), ``(kind, fn, prior, n_points)``
    metadata, and the walker-independent normalization constant, which
    cancels in MH ratios and is added outside the kernel.
    """
    term_inputs, term_meta = [], []
    scalar_const = 0.0
    for t in terms:
        kind = _likelihood_kind(t.likelihood)
        ds = t.dataset
        n = int(ds.n)
        size = n if n_pad is None else n_pad

        def col(a, fill_edge=True):
            a = np.asarray(a, np.float64)[:n]
            pad = size - n
            if pad:
                a = np.pad(a, (0, pad), mode="edge" if fill_edge else "constant")
            return jnp.asarray(a, dtype)

        x, y = col(ds.x), col(ds.y)
        if kind == "normal":
            scalar_const += float(ds.log_norm_const)
            term_inputs.append((x, y, col(ds.inv_sigma, False)))
        elif kind == "normal_cutoff":
            term_inputs.append((x, y, col(ds.inv_sigma, False),
                                col(ds.log_norm_const_point, False),
                                col(ds.mask, False)))
        else:  # poisson
            scalar_const -= float(np.sum(np.asarray(ds.log_fact_y)))
            term_inputs.append((x, y, col(ds.mask, False)))
        term_meta.append((kind, t.fn, t.prior, n))
    return term_inputs, term_meta, scalar_const


def _term_loglik(kind, fn, inputs, params):
    """Per-point log-likelihood of one term on a ``(P, 1)`` x ``(1, W)`` tile."""
    x, y = inputs[0], inputs[1]
    mu = fn(x, params)
    if kind == "normal":
        z = (y - mu) * inputs[2]
        return -0.5 * z * z
    if kind == "normal_cutoff":
        z = (y - mu) * inputs[2]
        return jnp.maximum(_CUTOFF_DEFAULT, inputs[3] - 0.5 * z * z) * inputs[4]
    return (y * jnp.log(mu) - mu) * inputs[2]


def fused_terms_posterior(terms, spec, dtype):
    """The kernel's term algebra in plain ``jnp``: ``(W, d) -> (W,)``.

    Priors are evaluated with ``dataset=None``, exactly as in the kernel.
    Returns ``None`` when a term is outside the kernel's coverage.
    """
    if not fusable_terms(terms):
        return None
    term_inputs, term_meta, scalar_const = _prepare_terms(terms, dtype)

    def logpost(positions):
        params = {k: positions[:, j] for j, k in enumerate(spec.keys)}
        rows = {k: v[None, :] for k, v in params.items()}
        total = jnp.zeros((positions.shape[0],), dtype)
        for inputs, (kind, fn, prior, _n) in zip(term_inputs, term_meta):
            cols = tuple(a[:, None] for a in inputs)
            total = total + jnp.sum(_term_loglik(kind, fn, cols, rows), axis=0)
            total = total + prior(params, None)
        return total + scalar_const

    return logpost


def _uniform_from_bits(bits):
    """uint32 random bits -> f32 uniform strictly inside (0, 1).

    The top 24 bits, centred in their cell: ``(k + 0.5) / 2**24``.
    """
    k = (bits >> 8).astype(jnp.int32).astype(jnp.float32)
    return (k + 0.5) * jnp.float32(2.0 ** -24)


def _hash_u32(idx, key1, key2):
    """Keyed counter hash (two murmur3-finalizer rounds), uint32.

    ``idx`` is the counter (the global walker index inside the kernel);
    the key words are XOR-mixed in BETWEEN the rounds, so distinct keys
    select independent permutations of the counter space and consecutive
    seeds cannot replay bits.  Pure integer ops: it lowers through Triton
    and runs in interpret mode alike.
    """
    def fin(x, m1, m2):
        x = x ^ (x >> 16)
        x = x * jnp.uint32(m1)
        x = x ^ (x >> 13)
        x = x * jnp.uint32(m2)
        x = x ^ (x >> 16)
        return x

    x = fin(idx ^ key1, 0x7FEB352D, 0x846CA68B)
    return fin(x ^ key2, 0x85EBCA6B, 0xC2B2AE35)


_DRAW_STRIDE = 0x68E31DA4   # key2 offset between the 2d+1 draws of a step
_STEP_MULT = 0xB5297A4D     # key2 multiplier of the in-chunk step index


def build_chunk_pallas(terms, spec, config, n_walkers: int, dtype, *,
                       block_walkers: int = 128, tile_points: int = 16,
                       num_warps: int = 4, num_stages: int = 2,
                       interpret: bool = False):
    """Build a whole-chunk MH stepper as one Pallas kernel, or None.

    Returns None when the fit is outside the kernel's scope.  Raises when
    it is inside the scope but the default backend is not a GPU and
    ``interpret`` is off: the kernel is compiled for the GPU only.

    The defaults are the fastest configuration measured on an H100 at the
    flagship chunk (W = 131072, d = 6, N = 334; benchmarks/
    chunk_pallas_bench.py, PERF.md): 128 walkers per block, 16 points
    per tile, 4 warps, 2 stages.

    The returned callable maps
    ``(position (W,d), logprob (W,), best_position (W,d),
    best_logprob (W,), l_matrix (d,d), anneal_step, temp_override, seed)``
    to a dict with the updated arrays plus ``accept_counts (W,)``,
    ``m_sum (d,)``, ``m_outer (d,d)``, ``m_count ()``, and per-step
    ``trace_max/mean/min (chunk,)``: what the chunk driver's
    ``_finish``/adapt step consumes.
    """
    if jnp.dtype(dtype) != jnp.float32:
        return None  # the hash uniforms are f32; x64 runs keep XLA
    if not fusable_terms(terms):
        return None
    if config.tempering_rungs > 1 or config.kernel != "rwm":
        return None
    wb = pick_block(n_walkers, block_walkers)
    if wb is None:
        return None
    if not interpret and jax.default_backend() != "gpu":
        raise ValueError(
            "posterior_impl='pallas_chunk' is compiled for the GPU only; "
            f"the default backend is {jax.default_backend()!r}. Use the "
            "default posterior_impl on other backends.")

    d = spec.ndim
    keys = spec.keys
    chunk = config.chunk_size
    n_blk = n_walkers // wb
    tn = tile_points
    n_max = max(int(t.dataset.n) for t in terms)
    n_pad = max(pl.next_power_of_2(n_max), tn)
    term_inputs, term_meta, scalar_const = _prepare_terms(
        terms, jnp.float32, n_pad)
    flat_inputs = [a for tup in term_inputs for a in tup]
    n_data = len(flat_inputs)

    # Scalars the blocks load themselves: ints (seed, anneal step) and
    # floats (temperature override, then L row-major), padded to powers
    # of two.  Moment partials: m_sum (d) then m_outer (d*d) per block.
    n_f = pl.next_power_of_2(1 + d * d)
    n_m = pl.next_power_of_2(d + d * d)
    n_ch = pl.next_power_of_2(chunk)

    # Annealing schedule constants (temperature_schedule, kernel.py).
    ts = float(config.temp_steps(d))
    mult = 1 + 2 * (int(ts) // config.temp_period)
    phase_rate = math.pi * mult / (2.0 * ts)
    temp_amp = float(config.temperature)
    greedy = bool(config.greedy)
    neg_floor = float(np.finfo(np.float32).min / 4)
    two_pi = float(2.0 * math.pi)
    upper = [(r, c) for r in range(d) for c in range(r, d)]

    def pick(vec, iota, k, zero):
        return jnp.sum(jnp.where(iota == k, vec, zero), dtype=vec.dtype)

    def eval_block(params, data_refs):
        """Log-posterior (WB,), less the constant, for (WB,) parameters."""
        row = {k: v[None, :] for k, v in params.items()}
        total = jnp.zeros((wb,), jnp.float32)
        idx = 0
        for inputs, (kind, fn, prior, n) in zip(term_inputs, term_meta):
            refs_t = data_refs[idx: idx + len(inputs)]
            idx += len(inputs)

            def tile(t, acc, refs_t=refs_t, kind=kind, fn=fn):
                sl = pl.ds(pl.multiple_of(t * tn, tn), tn)
                cols = tuple(r[sl][:, None] for r in refs_t)
                return acc + jnp.sum(_term_loglik(kind, fn, cols, row), axis=0)

            total = jax.lax.fori_loop(jnp.int32(0), jnp.int32(pl.cdiv(n, tn)),
                                      tile, total)
            total = total + jnp.broadcast_to(
                jnp.asarray(prior(params, None), jnp.float32), (wb,))
        return total

    def kernel(iscal_ref, fscal_ref, *refs):
        pos_refs = refs[:d]
        lp_ref = refs[d]
        best_refs = refs[d + 1: 2 * d + 1]
        blp_ref = refs[2 * d + 1]
        data_refs = refs[2 * d + 2: 2 * d + 2 + n_data]
        outs = refs[2 * d + 2 + n_data:]
        pos_outs, lp_out = outs[:d], outs[d]
        best_outs, blp_out = outs[d + 1: 2 * d + 1], outs[2 * d + 1]
        acc_out, mom_out = outs[2 * d + 2], outs[2 * d + 3]
        tmax_out, tsum_out, tmin_out = outs[2 * d + 4: 2 * d + 7]

        ivec = iscal_ref[...]
        iota_i = jax.lax.broadcasted_iota(jnp.int32, ivec.shape, 0)
        seed = pick(ivec, iota_i, 0, 0)
        astep0 = pick(ivec, iota_i, 1, 0)
        fvec = fscal_ref[...]
        iota_f = jax.lax.broadcasted_iota(jnp.int32, fvec.shape, 0)
        tover = pick(fvec, iota_f, 0, 0.0)
        lmat = [[pick(fvec, iota_f, 1 + r * d + c, 0.0) for c in range(d)]
                for r in range(d)]

        pid = pl.program_id(0)
        gidx = (pid * wb + jax.lax.broadcasted_iota(
            jnp.int32, (wb,), 0)).astype(jnp.uint32)
        key1 = seed.astype(jnp.uint32) * jnp.uint32(0x9E3779B9)
        ch_iota = jax.lax.broadcasted_iota(jnp.int32, (n_ch,), 0)

        def draw(step_i, slot):
            key2 = (step_i.astype(jnp.uint32) * jnp.uint32(_STEP_MULT)
                    + jnp.uint32((slot * _DRAW_STRIDE) & 0xFFFFFFFF))
            return _uniform_from_bits(_hash_u32(gidx, key1, key2))

        def body(i, carry):
            pos, lp, best, blp, acc, msum, mout, tmax, tsum, tmin = carry

            # temperature: cosine annealing, or the pinned override
            step_f = (astep0 + i).astype(jnp.float32)
            sched = jnp.maximum(1.0, jnp.cos(step_f * phase_rate) * temp_amp)
            sched = jnp.where(step_f < ts, sched, 1.0)
            temp = jnp.where(tover > 0, tover, sched)

            # proposal: z ~ N(0, 1) by Box-Muller, step = L z
            z = [jnp.sqrt(-2.0 * jnp.log(draw(i, j)))
                 * jnp.cos(two_pi * draw(i, d + j)) for j in range(d)]
            step = []
            for r in range(d):
                s = lmat[r][0] * z[0]
                for c in range(1, d):
                    s = s + lmat[r][c] * z[c]
                step.append(s)
            prop = tuple(p + s for p, s in zip(pos, step))

            lp_prop = eval_block(dict(zip(keys, prop)), data_refs)
            lp_prop = jnp.where(jnp.isfinite(lp_prop), lp_prop, neg_floor)

            # MH accept (mcmc-fitting.lisp:1091-1092)
            if greedy:
                accept = lp_prop > lp
            else:
                log_u = jnp.log(draw(i, 2 * d))
                accept = (lp_prop > lp) | ((lp_prop - lp) / temp > log_u)
            accf = accept.astype(jnp.float32)
            new_pos = tuple(jnp.where(accept, q, p) for q, p in zip(prop, pos))
            new_lp = jnp.where(accept, lp_prop, lp)

            # accepted-move moments, per walker until the chunk ends
            delta = [s * accf for s in step]
            msum = tuple(m + dl for m, dl in zip(msum, delta))
            mout = tuple(m + delta[r] * delta[c]
                         for m, (r, c) in zip(mout, upper))

            # best tracking (553-555)
            better = new_lp > blp
            best = tuple(jnp.where(better, q, b) for q, b in zip(new_pos, best))
            blp = jnp.where(better, new_lp, blp)

            at_i = ch_iota == i
            tmax = jnp.where(at_i, jnp.max(new_lp), tmax)
            tsum = jnp.where(at_i, jnp.sum(new_lp), tsum)
            tmin = jnp.where(at_i, jnp.min(new_lp), tmin)
            return (new_pos, new_lp, best, blp, acc + accf, msum, mout,
                    tmax, tsum, tmin)

        zeros = jnp.zeros((wb,), jnp.float32)
        zch = jnp.zeros((n_ch,), jnp.float32)
        carry0 = (tuple(r[...] for r in pos_refs), lp_ref[...],
                  tuple(r[...] for r in best_refs), blp_ref[...], zeros,
                  (zeros,) * d, (zeros,) * len(upper), zch, zch, zch)
        pos, lp, best, blp, acc, msum, mout, tmax, tsum, tmin = \
            jax.lax.fori_loop(jnp.int32(0), jnp.int32(chunk), body, carry0)

        for r, v in zip(pos_outs, pos):
            r[...] = v
        lp_out[...] = lp
        for r, v in zip(best_outs, best):
            r[...] = v
        blp_out[...] = blp
        acc_out[...] = acc
        m_iota = jax.lax.broadcasted_iota(jnp.int32, (n_m,), 0)
        mom = jnp.zeros((n_m,), jnp.float32)
        for j in range(d):
            mom = jnp.where(m_iota == j, jnp.sum(msum[j]), mom)
        for m, (r, c) in zip(mout, upper):
            s = jnp.sum(m)
            mom = jnp.where((m_iota == d + r * d + c)
                            | (m_iota == d + c * d + r), s, mom)
        mom_out[...] = mom
        tmax_out[...] = tmax
        tsum_out[...] = tsum
        tmin_out[...] = tmin

    vec = pl.BlockSpec((wb,), lambda b: (b,))
    whole = lambda n: pl.BlockSpec((n,), lambda b: (0,))
    per_blk = lambda n: pl.BlockSpec((n,), lambda b: (b,))
    f32 = jnp.float32
    w_shape = jax.ShapeDtypeStruct((n_walkers,), f32)
    call = pl.pallas_call(
        kernel,
        grid=(n_blk,),
        in_specs=[whole(8), whole(n_f), *([vec] * (2 * d + 2)),
                  *([whole(n_pad)] * n_data)],
        out_specs=[*([vec] * (2 * d + 3)), per_blk(n_m),
                   *([per_blk(n_ch)] * 3)],
        out_shape=[*([w_shape] * (2 * d + 3)),
                   jax.ShapeDtypeStruct((n_blk * n_m,), f32),
                   *([jax.ShapeDtypeStruct((n_blk * n_ch,), f32)] * 3)],
        compiler_params=plgpu.CompilerParams(num_warps=num_warps,
                                             num_stages=num_stages),
        backend="triton",
        interpret=interpret,
        name="mh_chunk",
    )

    def run_chunk(position, logprob, best_position, best_logprob, l_matrix,
                  anneal_step, temp_override, seed):
        iscal = jnp.zeros((8,), jnp.int32).at[0].set(
            jnp.asarray(seed, jnp.int32)).at[1].set(
            jnp.asarray(anneal_step, jnp.int32))
        fscal = jnp.zeros((n_f,), f32).at[0].set(
            jnp.asarray(temp_override, f32)).at[1:1 + d * d].set(
            l_matrix.reshape(-1).astype(f32))
        pos = position.astype(f32)
        best = best_position.astype(f32)
        outs = call(
            iscal, fscal,
            *(pos[:, j] for j in range(d)),
            (logprob - scalar_const).astype(f32),
            *(best[:, j] for j in range(d)),
            (best_logprob - scalar_const).astype(f32),
            *flat_inputs,
        )
        pos_o = jnp.stack(outs[:d], axis=1)
        best_o = jnp.stack(outs[d + 1: 2 * d + 1], axis=1)
        acc = outs[2 * d + 2]
        mom = outs[2 * d + 3].reshape(n_blk, n_m).sum(axis=0)
        tmax, tsum, tmin = (o.reshape(n_blk, n_ch)[:, :chunk]
                            for o in outs[2 * d + 4:])
        return {
            "position": pos_o,
            "logprob": outs[d] + scalar_const,
            "best_position": best_o,
            "best_logprob": outs[2 * d + 1] + scalar_const,
            "accept_counts": acc,
            "m_sum": mom[:d],
            "m_outer": mom[d:d + d * d].reshape(d, d),
            "m_count": jnp.sum(acc),
            "trace_max": jnp.max(tmax, axis=0) + scalar_const,
            "trace_mean": jnp.sum(tsum, axis=0) / n_walkers + scalar_const,
            "trace_min": jnp.min(tmin, axis=0) + scalar_const,
        }

    # Trace once now, so a model or prior the kernel cannot express falls
    # back at build time rather than failing inside the driver.
    try:
        i32 = jnp.int32
        jax.eval_shape(
            run_chunk,
            jax.ShapeDtypeStruct((n_walkers, d), f32),
            jax.ShapeDtypeStruct((n_walkers,), f32),
            jax.ShapeDtypeStruct((n_walkers, d), f32),
            jax.ShapeDtypeStruct((n_walkers,), f32),
            jax.ShapeDtypeStruct((d, d), f32),
            jax.ShapeDtypeStruct((), i32),
            jax.ShapeDtypeStruct((), f32),
            jax.ShapeDtypeStruct((), i32),
        )
    except Exception:
        return None

    return run_chunk
