"""Gradient-based MALA kernel (FitConfig(kernel='mala')) — new
surface: preconditioned Langevin proposals via autodiff, sharing the
chunked-scan/adaptation machinery with the reference's random-walk MH."""

import jax.numpy as jnp
import numpy as np
import pytest

import lisp_mcmc_tpu as mfit
from lisp_mcmc_tpu.kernel import FitConfig
from lisp_mcmc_tpu.ops.chunk_pallas import build_chunk_pallas
from lisp_mcmc_tpu.models import line


def _gaussian_walker(kernel, n_walkers=64, seed=0):
    target_mean = np.array([1.0, -2.0])
    target_cov = np.array([[2.0, 0.6], [0.6, 0.5]])
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
        config=FitConfig(kernel=kernel),
    )
    return w, target_mean, target_cov


def test_mala_samples_known_gaussian():
    """MALA must target the same invariant distribution as MH (exact
    moments to MC precision) — this validates the Hastings correction."""
    w, mean, cov = _gaussian_walker("mala")
    w.adaptive_steps(8000, temperature=1.0, auto=None)
    pos, _ = w.steps(take=4000)
    np.testing.assert_allclose(pos.mean(axis=0), mean, atol=0.25)
    np.testing.assert_allclose(np.cov(pos.T, bias=True), cov, atol=0.5)


def test_mala_acceptance_adapts_to_mala_band():
    w, _, _ = _gaussian_walker("mala")
    w.adaptive_steps(6000, temperature=1.0, auto=None)
    # band auto-shifts to MALA's ~0.574 optimum (0.45, 0.7)
    assert 0.35 < w.acceptance() < 0.8


def test_mala_beats_rwm_ess():
    """The whole point: more effective samples per step on smooth targets
    of moderate dimension (measured ~7x at d=6; at d=2 a well-adapted
    random walk is already near-optimal, so the test uses d=6)."""
    from lisp_mcmc_tpu.diagnostics import ess_per_param

    d = 6
    rng = np.random.default_rng(42)
    A = rng.standard_normal((d, d))
    cov = A @ A.T + 0.05 * np.eye(d)
    prec = np.linalg.inv(cov)
    mean = rng.standard_normal(d)
    keys = [f"p{i}" for i in range(d)]

    def model(x, p):
        return jnp.zeros_like(x)

    def loglik(fn, params, dataset):
        v = jnp.stack([params[k] for k in keys]) - jnp.asarray(mean)
        return -0.5 * v @ jnp.asarray(prec) @ v

    ess = {}
    for kernel in ("rwm", "mala"):
        w = mfit.walker_create(
            function=model, data=([0.0, 1.0], [0.0, 0.0]),
            params={k: 0.1 for k in keys}, log_likelihood=loglik,
            n_walkers=32, seed=3, walker_jitter=0.5,
            config=FitConfig(kernel=kernel),
        )
        w.adaptive_steps(8000, temperature=1.0, auto=None)
        ess[kernel] = min(ess_per_param(w, take=4000).values())
    assert ess["mala"] > 2.0 * ess["rwm"], ess


def test_mala_line_fit():
    rng = np.random.default_rng(0)
    x = np.linspace(0.0, 10.0, 50)
    y = 2.0 * x + 1.0 + 0.1 * rng.standard_normal(50)
    w = mfit.walker_create(
        function=line, data=(x, y), params={"m": 1.5, "b": 0.5},
        data_error=0.1, n_walkers=32, seed=0, walker_jitter=0.05,
        config=FitConfig(kernel="mala"),
    )
    w.adaptive_steps(4000, auto=None)
    best = w.most_likely_params()
    assert best["m"] == pytest.approx(2.0, abs=0.05)
    assert best["b"] == pytest.approx(1.0, abs=0.3)


def test_anneal_rwm_then_sample_mala():
    """The production recipe for hard fits: anneal with the random walk,
    then switch the kernel to MALA for the sampling phase — the drift
    activates at T=1 and the best-fit quality is preserved/improved."""
    import lisp_mcmc_tpu as mfit_

    rng = np.random.default_rng(0)
    x = np.linspace(-5.0, 5.0, 120)
    from lisp_mcmc_tpu.models import gaussian_peak

    y = 3.0 * np.exp(-0.5 * ((x - 0.7) / 1.3) ** 2) + 0.05 * rng.standard_normal(120)
    w = mfit_.walker_create(
        function=gaussian_peak, data=(x, y),
        params={"scale": 1.0, "x0": 0.0, "sigma": 1.0},
        data_error=0.05, n_walkers=32, seed=1, walker_jitter=0.2,
    )
    w.adaptive_steps(10000, auto=None)                # rwm anneal
    lp_rwm = w.most_likely_step()[0]
    w.sampling_steps(3000)                            # mala sampling phase
    lp_mala, best = w.most_likely_step()
    assert lp_mala >= lp_rwm - 1e-9
    assert best["x0"] == pytest.approx(0.7, abs=0.1)
    assert 0.3 < w.acceptance() < 0.85


def test_mala_auto_stop_uses_shifted_band():
    """Auto-stop must gate on MALA's acceptance band (~0.574): a converged
    MALA fit stops early rather than burning every step."""
    rng = np.random.default_rng(0)
    x = np.linspace(0.0, 10.0, 50)
    y = 2.0 * x + 1.0 + 0.05 * rng.standard_normal(50)
    w = mfit.walker_create(
        function=line, data=(x, y), params={"m": 2.0, "b": 1.0},
        data_error=0.05, n_walkers=64, seed=0, walker_jitter=0.02,
        config=FitConfig(kernel="mala", temperature=2.0),
    )
    w.adaptive_steps(40000, auto="rhat")
    assert w.age < 40000


def test_mala_falls_back_from_pallas():
    """pallas_call has no autodiff rule; kernel='mala' must keep the XLA
    scan even when posterior_impl='pallas_chunk' is asked for."""
    rng = np.random.default_rng(0)
    x = np.linspace(0.0, 10.0, 50)
    y = 2.0 * x + 1.0 + 0.1 * rng.standard_normal(50)
    w = mfit.walker_create(
        function=line, data=(x, y), params={"m": 1.5, "b": 0.5},
        data_error=0.1, n_walkers=128, seed=0, walker_jitter=0.05,
        config=FitConfig(kernel="mala", posterior_impl="pallas_chunk"),
        dtype=jnp.float32,
    )
    assert build_chunk_pallas(w.terms, w.spec, w.config, w.n_walkers,
                              w.dtype) is None
    w.adaptive_steps(600, auto=None, collect_history=False)  # must not crash in linearization
    assert np.isfinite(w.most_likely_step()[0])


def test_rhat_requires_history():
    rng = np.random.default_rng(0)
    x = np.linspace(0.0, 10.0, 50)
    y = 2.0 * x + 1.0 + 0.1 * rng.standard_normal(50)
    w = mfit.walker_create(
        function=line, data=(x, y), params={"m": 1.5, "b": 0.5},
        data_error=0.1, n_walkers=16, seed=0,
    )
    with pytest.raises(ValueError, match="collect_history"):
        w.adaptive_steps(1000, auto="rhat", collect_history=False)


def test_mala_batched_fit():
    """MALA composes with grouped batched fits (vjp through the
    whole-batch posterior)."""
    from lisp_mcmc_tpu.models import exponential_decay

    rng = np.random.default_rng(1)
    x = np.linspace(0.0, 10.0, 96)
    taus = [1.0, 4.0]
    ds = [(x, 2.0 * np.exp(-x / t) + 0.1 + 0.01 * rng.standard_normal(96))
          for t in taus]
    fit = mfit.BatchedFit(
        exponential_decay, ds, {"scale": 1.5, "tau": 2.0, "bg0": 0.2},
        data_error=0.01, walkers_per_dataset=32, seed=0,
        config=FitConfig(kernel="mala"),
    )
    fit.adaptive_steps(5000, auto=None)
    for tau, p in zip(taus, fit.best_params_per_dataset()):
        assert p["tau"] == pytest.approx(tau, rel=0.15)
