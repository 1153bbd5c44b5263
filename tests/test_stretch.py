"""Affine-invariant stretch kernel (FitConfig(kernel='stretch')) — new
surface: Goodman-Weare ensemble moves with red-black half updates, sharing
the chunked-scan machinery with the reference's random-walk MH.  The
ensemble itself is the proposal distribution, so there is no L-matrix to
adapt."""

import jax.numpy as jnp
import numpy as np
import pytest

import lisp_mcmc_tpu as mfit
from lisp_mcmc_tpu.kernel import FitConfig
from lisp_mcmc_tpu.ops.chunk_pallas import build_chunk_pallas
from lisp_mcmc_tpu.models import line


def _gaussian_walker(n_walkers=64, seed=0, cov=None, **cfg):
    target_mean = np.array([1.0, -2.0])
    target_cov = np.array([[2.0, 0.6], [0.6, 0.5]]) if cov is None else np.asarray(cov)
    prec = np.linalg.inv(target_cov)

    def model(x, p):
        return jnp.zeros_like(x)

    def loglik(fn, params, dataset):
        v = jnp.stack([params["a"], params["b"]]) - jnp.asarray(target_mean)
        return -0.5 * v @ jnp.asarray(prec) @ v

    w = mfit.walker_create(
        function=model,
        data=([0.0, 1.0], [0.0, 0.0]),
        params={"a": 0.5, "b": -1.0},
        log_likelihood=loglik,
        n_walkers=n_walkers,
        seed=seed,
        walker_jitter=0.1,
        config=FitConfig(kernel="stretch", **cfg),
    )
    return w, target_mean, target_cov


def test_stretch_samples_known_gaussian():
    """Stretch must target the same invariant distribution as MH — this
    validates the z^(d-1) Jacobian factor and the red-black sequencing."""
    w, mean, cov = _gaussian_walker()
    w.adaptive_steps(8000, temperature=1.0, auto=None)
    pos, _ = w.steps(take=4000)
    np.testing.assert_allclose(pos.mean(axis=0), mean, atol=0.25)
    np.testing.assert_allclose(np.cov(pos.T, bias=True), cov, atol=0.5)


def test_stretch_affine_invariance_no_adaptation():
    """The selling point: a 1e6-condition-number target sampled correctly
    with NO proposal adaptation at all — the complementary ensemble
    supplies the geometry that rwm needs a covariance refresh to learn."""
    cov = np.array([[1.0e4, 0.0], [0.0, 1.0e-2]])
    w, mean, _ = _gaussian_walker(n_walkers=128, cov=cov)
    w.adaptive_steps(12000, temperature=1.0, auto=None)
    pos, _ = w.steps(take=6000)
    assert 0.1 < w.acceptance() < 0.9
    np.testing.assert_allclose(pos.mean(axis=0) / np.sqrt(np.diag(cov)),
                               mean / np.sqrt(np.diag(cov)), atol=0.2)
    np.testing.assert_allclose(pos.var(axis=0) / np.diag(cov),
                               np.ones(2), rtol=0.35)


def test_stretch_line_fit():
    rng = np.random.default_rng(0)
    x = np.linspace(0.0, 10.0, 50)
    y = 2.0 * x + 1.0 + 0.1 * rng.standard_normal(50)
    w = mfit.walker_create(
        function=line, data=(x, y), params={"m": 1.5, "b": 0.5},
        data_error=0.1, n_walkers=32, seed=0, walker_jitter=0.05,
        config=FitConfig(kernel="stretch"),
    )
    w.adaptive_steps(4000, auto=None)
    best = w.most_likely_params()
    assert best["m"] == pytest.approx(2.0, abs=0.05)
    assert best["b"] == pytest.approx(1.0, abs=0.3)


def test_anneal_rwm_then_sample_stretch():
    """Anneal with the random walk, then sample with stretch moves — the
    kernel switch at a chunk boundary must preserve best-fit quality."""
    from lisp_mcmc_tpu.models import gaussian_peak

    rng = np.random.default_rng(0)
    x = np.linspace(-5.0, 5.0, 120)
    y = 3.0 * np.exp(-0.5 * ((x - 0.7) / 1.3) ** 2) + 0.05 * rng.standard_normal(120)
    w = mfit.walker_create(
        function=gaussian_peak, data=(x, y),
        params={"scale": 1.0, "x0": 0.0, "sigma": 1.0},
        data_error=0.05, n_walkers=32, seed=1, walker_jitter=0.2,
    )
    w.adaptive_steps(8000, auto=None)
    lp_rwm = w.most_likely_step()[0]
    w.sampling_steps(3000, kernel="stretch")
    lp_stretch, best = w.most_likely_step()
    assert lp_stretch >= lp_rwm - 1e-9
    assert best["x0"] == pytest.approx(0.7, abs=0.1)
    assert 0.1 < w.acceptance() < 0.8


def test_stretch_batched_fit():
    """Grouped batched fits pair within their own walker block and use the
    whole-batch posterior fallback (proposals never cross datasets)."""
    from lisp_mcmc_tpu.models import exponential_decay

    rng = np.random.default_rng(1)
    x = np.linspace(0.0, 10.0, 96)
    taus = [1.0, 4.0]
    ds = [(x, 2.0 * np.exp(-x / t) + 0.1 + 0.01 * rng.standard_normal(96))
          for t in taus]
    fit = mfit.BatchedFit(
        exponential_decay, ds, {"scale": 1.5, "tau": 2.0, "bg0": 0.2},
        data_error=0.01, walkers_per_dataset=32, seed=0,
        config=FitConfig(kernel="stretch"),
    )
    fit.adaptive_steps(5000, auto=None)
    for tau, p in zip(taus, fit.best_params_per_dataset()):
        assert p["tau"] == pytest.approx(tau, rel=0.15)


def test_stretch_rejects_tempering():
    w, _, _ = _gaussian_walker(tempering_rungs=4)
    with pytest.raises(ValueError, match="rwm"):
        w.adaptive_steps(400, auto=None)


def test_stretch_ignores_forced_pallas():
    """posterior_impl='pallas_chunk' must silently keep the XLA scan (the
    chunk kernel covers rwm only)."""
    rng = np.random.default_rng(0)
    x = np.linspace(0.0, 10.0, 50)
    y = 2.0 * x + 1.0 + 0.1 * rng.standard_normal(50)
    w = mfit.walker_create(
        function=line, data=(x, y), params={"m": 1.5, "b": 0.5},
        data_error=0.1, n_walkers=128, seed=0, walker_jitter=0.05,
        config=FitConfig(kernel="stretch", posterior_impl="pallas_chunk"),
        dtype=jnp.float32,
    )
    assert build_chunk_pallas(w.terms, w.spec, w.config, w.n_walkers,
                              w.dtype) is None
    w.adaptive_steps(600, auto=None, collect_history=False)
    assert np.isfinite(w.most_likely_step()[0])
