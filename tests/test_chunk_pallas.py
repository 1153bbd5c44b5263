"""Whole-chunk Pallas stepper: statistical validation vs the XLA scan.

The in-kernel counter-hash RNG stream necessarily differs from
jax.random, so the kernel cannot be bitwise-compared to the XLA chunk;
these tests validate it the way a sampler must be validated — RNG
quality, accept-rule behavior, and agreement of the SAMPLED POSTERIOR
with both the XLA kernel and the analytic target.

The kernel runs in interpret mode here; tests/test_gpu.py compiles it
for the card.
"""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import lisp_mcmc_tpu as mfit
from lisp_mcmc_tpu.models import line
from lisp_mcmc_tpu.ops import chunk_pallas
from lisp_mcmc_tpu.ops.chunk_pallas import (
    _hash_u32,
    _uniform_from_bits,
    build_chunk_pallas,
)


def _hash_bits(shape, key1, key2):
    """Hash bits over a row-major counter of ``shape``."""
    n = int(np.prod(shape))
    idx = jnp.arange(n, dtype=jnp.uint32).reshape(shape)
    return _hash_u32(idx, jnp.uint32(key1), jnp.uint32(key2))


@pytest.fixture
def interpret(monkeypatch):
    """Let the driver build the kernel in interpret mode on the CPU."""
    monkeypatch.setattr(chunk_pallas, "build_chunk_pallas", functools.partial(
        build_chunk_pallas, interpret=True))


@pytest.fixture(scope="module")
def f32():
    """The chunk kernel is f32-only; flip x64 off for this module."""
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", prev)


def _line_walker(n_walkers=256, seed=0, config=None):
    x = np.linspace(0.0, 10.0, 50)
    y = 2.0 * x + 1.0
    return mfit.walker_create(
        function=line, data=(x, y), params={"m": 2.0, "b": 1.0},
        data_error=0.5, n_walkers=n_walkers, seed=seed, walker_jitter=0.1,
        config=config)


def test_hash_rng_quality(f32):
    """Keyed-hash uniforms: moments + adjacent-index decorrelation."""
    zero = jnp.uint32(0)
    bits = np.asarray(_hash_bits((64, 4096), jnp.uint32(12345), zero))
    u = np.asarray(_uniform_from_bits(jnp.asarray(bits))).ravel()
    assert abs(u.mean() - 0.5) < 2e-3
    assert abs(u.std() - 1.0 / np.sqrt(12.0)) < 2e-3
    # lag-1 correlation along the index direction
    r = np.corrcoef(u[:-1], u[1:])[0, 1]
    assert abs(r) < 5e-3, r
    # distinct key1 words give independent permutations
    u2 = np.asarray(_uniform_from_bits(
        _hash_bits((64, 4096), jnp.uint32(99999), zero))).ravel()
    assert abs(np.corrcoef(u, u2)[0, 1]) < 5e-3
    # ... and so do distinct key2 (step/draw) words under the same key1
    u3 = np.asarray(_uniform_from_bits(
        _hash_bits((64, 4096), jnp.uint32(12345), jnp.uint32(0x68E31DA4)))).ravel()
    assert abs(np.corrcoef(u, u3)[0, 1]) < 5e-3
    # adjacent key1 words (consecutive chunk seeds) must not replay bits:
    # the old additive-counter scheme failed exactly this
    u4 = np.asarray(_uniform_from_bits(
        _hash_bits((64, 4096), jnp.uint32(12346), zero))).ravel()
    assert abs(np.corrcoef(u, u4)[0, 1]) < 5e-3
    assert not np.any(u[:1000] == u4[:1000])


def test_box_muller_normals(f32):
    """The kernel's normal draw (Box-Muller over hash uniforms)."""
    key = jnp.uint32(7)
    u1 = _uniform_from_bits(_hash_bits((128, 2048), key, jnp.uint32(0)))
    u2 = _uniform_from_bits(_hash_bits((128, 2048), key, jnp.uint32(0x68E31DA4)))
    z = np.asarray(jnp.sqrt(-2.0 * jnp.log(u1))
                   * jnp.cos(2.0 * np.pi * u2)).ravel()
    assert abs(z.mean()) < 5e-3
    assert abs(z.std() - 1.0) < 5e-3
    assert abs(((z ** 3).mean())) < 2e-2          # symmetry
    assert abs((z ** 4).mean() - 3.0) < 5e-2      # kurtosis


def test_chunk_pallas_matches_xla_posterior(f32):
    """Both kernels must sample the same (conjugate-Gaussian) posterior."""
    w = _line_walker(n_walkers=512, seed=0)
    rc = build_chunk_pallas(w.terms, w.spec, w.config, w.n_walkers, w.dtype,
                            block_walkers=128, interpret=True)
    assert rc is not None

    # XLA reference: sample at T=1 with adaptation (the normal path).
    w.adaptive_steps(4000, auto=None, temperature=1.0)
    xla_pos = np.asarray(w.state.position)
    l_tuned = w.state.l_matrix[0]

    # Pallas: same tuned proposal, same start, 20 chunks at T=1.
    w2 = _line_walker(n_walkers=512, seed=0)
    st = w2.state
    pos, lp = st.position, st.logprob
    best, best_lp = st.best_position, st.best_logprob
    acc_total = 0.0
    for c in range(20):
        out = rc(pos, lp, best, best_lp, l_tuned, 0, 1.0, 1000 + c)
        pos, lp = out["position"], out["logprob"]
        best, best_lp = out["best_position"], out["best_logprob"]
        acc_total += float(np.mean(np.asarray(out["accept_counts"])))
    acc_rate = acc_total / (20 * w2.config.chunk_size)
    assert 0.05 < acc_rate < 0.95, acc_rate

    p_pos = np.asarray(pos)
    # Posterior for this setup: mean ~ (2, 1); compare ensembles.
    np.testing.assert_allclose(p_pos.mean(0), xla_pos.mean(0), atol=0.05)
    # Spread agreement within 2x (500 walkers of MC noise + thin tails).
    sx = xla_pos.std(0)
    sp = p_pos.std(0)
    assert np.all(sp < 2.0 * sx + 1e-3) and np.all(sp > 0.5 * sx - 1e-3), (sp, sx)
    # Consistency of the kernel's own bookkeeping.
    assert float(np.max(np.asarray(best_lp))) >= float(np.max(np.asarray(lp))) - 1e-5
    assert np.all(np.isfinite(np.asarray(out["m_outer"])))
    assert float(np.asarray(out["m_count"])) == pytest.approx(
        float(np.sum(np.asarray(out["accept_counts"]))), rel=1e-6)


def test_chunk_pallas_trace_and_moments_shapes(f32):
    w = _line_walker(n_walkers=256, seed=3)
    rc = build_chunk_pallas(w.terms, w.spec, w.config, w.n_walkers, w.dtype,
                            block_walkers=128, interpret=True)
    st = w.state
    out = rc(st.position, st.logprob, st.best_position, st.best_logprob,
             st.l_matrix[0], 0, 0.0, 7)    # 0.0 = follow annealing schedule
    chunk = w.config.chunk_size
    assert out["trace_max"].shape == (chunk,)
    assert np.all(np.asarray(out["trace_max"]) >= np.asarray(out["trace_mean"]) - 1e-4)
    assert np.all(np.asarray(out["trace_mean"]) >= np.asarray(out["trace_min"]) - 1e-4)
    # logprob consistency: recompute posterior at final positions.
    lp_re = np.asarray(w._eval_batch(out["position"]))
    np.testing.assert_allclose(lp_re, np.asarray(out["logprob"]),
                               rtol=1e-4, atol=1e-3)


def test_posterior_impl_pallas_chunk_integration(f32, interpret):
    """The opt-in rides the normal driver: adaptive_steps with
    collect_history=False uses the Pallas chunk (interpreted here) and
    converges; history phases transparently fall back to the XLA scan."""
    cfg = mfit.FitConfig(posterior_impl="pallas_chunk")
    w = _line_walker(n_walkers=256, seed=1, config=cfg)
    w.adaptive_steps(2000, auto=None, temperature=1.0, collect_history=False)
    best = w.most_likely_params()
    assert best["m"] == pytest.approx(2.0, abs=0.1)
    assert best["b"] == pytest.approx(1.0, abs=0.4)
    assert 0.0 < w.acceptance() < 1.0
    # History collection still works (XLA fallback path).
    w.adaptive_steps(400, auto=None, temperature=1.0)
    assert len(w) > 0


def test_pallas_chunk_dataset_reading_prior_fails_loudly(f32, interpret):
    """A prior that silently branches on dataset=None computes a
    different posterior in-kernel; the term-algebra check that gates
    pallas_chunk must raise, never run the wrong kernel."""
    import numpy as np

    def sneaky_prior(params, dataset):
        # Traces cleanly both ways, but shifts the posterior only when
        # it can see its dataset — exactly what the probe exists for.
        if dataset is None:
            return jnp.asarray(0.0)
        return jnp.asarray(-1000.0) + 0.0 * params["m"]

    x = np.linspace(0.0, 10.0, 50)
    y = 2.0 * x + 1.0
    cfg = mfit.FitConfig(posterior_impl="pallas_chunk")
    w = mfit.walker_create(
        function=line, data=(x, y), params={"m": 2.0, "b": 1.0},
        data_error=0.5, n_walkers=256, seed=0, walker_jitter=0.1,
        log_prior=sneaky_prior, config=cfg)
    with pytest.raises(ValueError, match="disagrees"):
        w.adaptive_steps(400, auto=None, temperature=1.0,
                         collect_history=False)


def test_chunk_pallas_scope_gating(f32):
    """Out-of-scope configs return None (callers fall back to XLA)."""
    import dataclasses

    w = _line_walker()
    assert build_chunk_pallas(
        w.terms, w.spec, dataclasses.replace(w.config, kernel="mala"),
        w.n_walkers, w.dtype) is None
    assert build_chunk_pallas(
        w.terms, w.spec, w.config, w.n_walkers, jnp.float64) is None


def test_pallas_chunk_off_gpu_raises(f32):
    """Off the GPU the kernel is never interpreted behind the user's back:
    asking for it through the driver raises."""
    cfg = mfit.FitConfig(posterior_impl="pallas_chunk")
    w = _line_walker(n_walkers=256, seed=0, config=cfg)
    with pytest.raises(ValueError, match="GPU"):
        w.adaptive_steps(400, auto=None, collect_history=False)
