"""Checks that need a card: f32 on the GPU against f64 on the CPU.

Every test takes the ``gpu`` fixture and skips without a GPU;
``chip_smoke.py`` runs them on the card.  Tolerances are stated where
they are used, with their reason.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import lisp_mcmc_tpu as mfit
from lisp_mcmc_tpu.likelihoods import (log_likelihood_normal_cutoff,
                                       log_likelihood_poisson)
from lisp_mcmc_tpu.models import gaussian_peak, line
from lisp_mcmc_tpu.ops.linalg import cholesky_clamped, sample_covariance

pytestmark = pytest.mark.gpu

# f32 sums of a few hundred per-point terms against f64 at the same
# (f32-representable) inputs: the rounding is relative to the size of the
# terms summed, which the walker-independent constant can cancel down to
# a small log-posterior, so the scale is |lp| + |constant| + 1.
# Relative rounding is ~1e-6 of that; 1e-4 leaves room for one rounded
# reciprocal or log per point.
LP_RTOL = 1e-4


def _lp_scale(kind, lp, dataset):
    const = float(np.sum(np.asarray(dataset.log_fact_y))) if kind == "poisson" \
        else float(dataset.log_norm_const)
    return np.abs(lp) + abs(const) + 1.0


def _case(kind):
    rng = np.random.default_rng(3)
    x = np.linspace(0.0, 4.0, 300)
    if kind == "normal":
        y = 2.0 * x + 1.0 + 0.1 * rng.standard_normal(x.size)
        return dict(function=line, data=(x, y), params={"m": 2.0, "b": 1.0},
                    data_error=0.1)
    if kind == "normal_cutoff":
        y = np.exp(-0.5 * (x - 2.0) ** 2) + 0.02 * rng.standard_normal(x.size)
        return dict(function=gaussian_peak, data=(x, y),
                    params={"scale": 1.0, "x0": 2.0, "sigma": 1.0},
                    data_error=1e-3,
                    log_likelihood=log_likelihood_normal_cutoff)
    counts = rng.poisson(lam=5.0 + 2.0 * x).astype(float)
    return dict(function=line, data=(x, counts), params={"m": 2.0, "b": 5.0},
                log_likelihood=log_likelihood_poisson)


def _f32_inputs(spec):
    x, y = spec["data"]
    return dict(spec, data=(np.float32(x).astype(np.float64),
                            np.float32(y).astype(np.float64)))


@pytest.mark.parametrize("kind", ["normal", "normal_cutoff", "poisson"])
def test_gpu_posterior_matches_cpu_f64(gpu, kind):
    spec = _f32_inputs(_case(kind))
    w = mfit.walker_create(**spec, n_walkers=4096, seed=0, walker_jitter=0.05,
                           dtype=jnp.float32)
    pos = w.state.position
    lp_gpu = np.asarray(w._eval_batch(pos), np.float64)
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        ref = mfit.walker_create(**spec, n_walkers=1, dtype=jnp.float64)
        lp_cpu = np.asarray(ref._eval_batch(
            jax.device_put(np.asarray(pos, np.float64), cpu)))
    scale = _lp_scale(kind, lp_cpu, ref.terms[0].dataset)
    err = np.abs(lp_gpu - lp_cpu) / scale
    assert err.max() <= LP_RTOL, err.max()


def test_gpu_refresh_is_full_f32(gpu):
    """The refresh covariance and Cholesky in f32 on the card agree with
    f64 to ~1e-6; a TF32 product (10-bit mantissa) would miss by ~1e-3."""
    rng = np.random.default_rng(0)
    a = rng.standard_normal((6, 6))
    cov_true = a @ a.T + 0.1 * np.eye(6)
    s = rng.multivariate_normal(np.zeros(6), cov_true, size=65536)
    cov = sample_covariance(jnp.asarray(s, jnp.float32))
    chol, ok = cholesky_clamped(cov)
    cov64 = np.cov(s.T, bias=True)
    chol64 = np.linalg.cholesky(cov64)
    assert bool(ok)
    scale = np.max(np.abs(cov64))
    assert np.max(np.abs(np.asarray(cov, np.float64) - cov64)) / scale < 1e-4
    assert np.max(np.abs(np.asarray(chol, np.float64) - chol64)) \
        / np.max(np.abs(chol64)) < 1e-4


@pytest.mark.parametrize("kernel", ["rwm", "mala"])
def test_gpu_chunk_state_is_consistent(gpu, kernel):
    """After chunks on the card, every walker's carried logprob is the
    posterior at its position (same f32 evaluation, so tight)."""
    spec = _case("normal")
    w = mfit.walker_create(**spec, n_walkers=8192, seed=1, walker_jitter=0.05,
                           dtype=jnp.float32)
    w.adaptive_steps(2000, temperature=1.0, auto=None, collect_history=False)
    w.sampling_steps(1000, kernel=kernel, collect_history=False)
    lp = np.asarray(w.state.logprob, np.float64)
    lp_re = np.asarray(w._eval_batch(w.state.position), np.float64)
    assert np.all(np.isfinite(lp))
    np.testing.assert_allclose(lp, lp_re, rtol=1e-5, atol=1e-3)
    assert np.all(np.asarray(w.state.best_logprob) >= np.asarray(lp) - 1e-3)
    assert 0.05 < w.acceptance() < 0.95


def test_gpu_chunk_kernel_samples_the_xla_posterior(gpu):
    """The chunk kernel compiled for the card samples the line posterior
    like the XLA scan (the same check as the interpret-mode test)."""
    from lisp_mcmc_tpu.ops.chunk_pallas import build_chunk_pallas

    x = np.linspace(0.0, 10.0, 50)

    def walker():
        return mfit.walker_create(
            function=line, data=(x, 2.0 * x + 1.0), params={"m": 2.0, "b": 1.0},
            data_error=0.5, n_walkers=16384, seed=0, walker_jitter=0.1,
            dtype=jnp.float32)

    w = walker()
    w.adaptive_steps(4000, auto=None, temperature=1.0)
    xla_pos = np.asarray(w.state.position)
    l_tuned = w.state.l_matrix[0]

    w2 = walker()
    rc = jax.jit(build_chunk_pallas(w2.terms, w2.spec, w2.config, w2.n_walkers,
                                    w2.dtype))
    st = w2.state
    pos, lp, best, blp = st.position, st.logprob, st.best_position, st.best_logprob
    for c in range(20):
        out = rc(pos, lp, best, blp, l_tuned, 0, 1.0, 1000 + c)
        pos, lp = out["position"], out["logprob"]
        best, blp = out["best_position"], out["best_logprob"]
    p_pos = np.asarray(pos)
    sx = xla_pos.std(0)
    # 16384 walkers: the mean's MC error is ~1% of the posterior sd
    np.testing.assert_allclose(p_pos.mean(0), xla_pos.mean(0), atol=0.05 * sx.max())
    assert np.all(np.abs(p_pos.std(0) / sx - 1.0) < 0.1), (p_pos.std(0), sx)
    lp_re = np.asarray(w2._eval_batch(pos), np.float64)
    np.testing.assert_allclose(np.asarray(lp, np.float64), lp_re,
                               rtol=1e-5, atol=1e-3)
    assert float(out["m_count"]) == float(np.sum(np.asarray(out["accept_counts"])))
