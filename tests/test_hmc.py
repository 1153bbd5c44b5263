"""Hamiltonian kernel (FitConfig(kernel='hmc')) — new surface:
leapfrog trajectories in L-whitened coordinates via autodiff, sharing the
chunked-scan/adaptation machinery (band shifted to HMC's ~0.65 optimum,
L refreshed from the ensemble position covariance)."""

import jax.numpy as jnp
import numpy as np
import pytest

import lisp_mcmc_tpu as mfit
from lisp_mcmc_tpu.kernel import FitConfig
from lisp_mcmc_tpu.models import line


def _gaussian_walker(kernel, n_walkers=64, seed=0, **cfg):
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
        config=FitConfig(kernel=kernel, **cfg),
    )
    return w, target_mean, target_cov


def test_hmc_samples_known_gaussian():
    """HMC must target the same invariant distribution as MH — validates
    the leapfrog reversibility and the Hamiltonian accept rule."""
    w, mean, cov = _gaussian_walker("hmc")
    w.adaptive_steps(6000, temperature=1.0, auto=None)
    pos, _ = w.steps(take=3000)
    np.testing.assert_allclose(pos.mean(axis=0), mean, atol=0.25)
    np.testing.assert_allclose(np.cov(pos.T, bias=True), cov, atol=0.5)


def test_hmc_acceptance_adapts_to_hmc_band():
    w, _, _ = _gaussian_walker("hmc")
    w.adaptive_steps(4000, temperature=1.0, auto=None)
    # band auto-shifts to HMC's ~0.65 optimum (0.55, 0.85)
    assert 0.4 < w.acceptance() < 0.95


def test_hmc_beats_rwm_ess_per_step():
    """Long leapfrog trajectories decorrelate in O(1) steps where the
    random walk needs O(d) — per-STEP effective samples must dominate
    (per-second depends on hmc_leapfrog x gradient cost)."""
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
    for kernel in ("rwm", "hmc"):
        w = mfit.walker_create(
            function=model, data=([0.0, 1.0], [0.0, 0.0]),
            params={k: 0.1 for k in keys}, log_likelihood=loglik,
            n_walkers=32, seed=3, walker_jitter=0.5,
            config=FitConfig(kernel=kernel),
        )
        w.adaptive_steps(8000, temperature=1.0, auto=None)
        ess[kernel] = min(ess_per_param(w, take=4000).values())
    assert ess["hmc"] > 3.0 * ess["rwm"], ess


def test_hmc_line_fit():
    rng = np.random.default_rng(0)
    x = np.linspace(0.0, 10.0, 50)
    y = 2.0 * x + 1.0 + 0.1 * rng.standard_normal(50)
    w = mfit.walker_create(
        function=line, data=(x, y), params={"m": 1.5, "b": 0.5},
        data_error=0.1, n_walkers=32, seed=0, walker_jitter=0.05,
        config=FitConfig(kernel="hmc"),
    )
    w.adaptive_steps(3000, auto=None)
    best = w.most_likely_params()
    assert best["m"] == pytest.approx(2.0, abs=0.05)
    assert best["b"] == pytest.approx(1.0, abs=0.3)


def test_anneal_rwm_then_sample_hmc():
    """Anneal with the random walk, then draw posterior samples with HMC
    at T=1 — the recommended pattern (same as MALA's)."""
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
    w.sampling_steps(2000, kernel="hmc")
    lp_hmc, best = w.most_likely_step()
    assert lp_hmc >= lp_rwm - 1e-9
    assert best["x0"] == pytest.approx(0.7, abs=0.1)


def test_hmc_rejects_tempering():
    w, _, _ = _gaussian_walker("hmc", tempering_rungs=4)
    with pytest.raises(ValueError, match="rwm"):
        w.adaptive_steps(400, auto=None)


def test_hmc_divergence_rejected_not_propagated():
    """A posterior with a hard cliff (non-finite outside a box) must
    reject divergent trajectories and keep every retained position
    finite and inside the support."""
    def model(x, p):
        return jnp.zeros_like(x)

    def loglik(fn, params, dataset):
        a = params["a"]
        return jnp.where(jnp.abs(a) < 3.0, -0.5 * a ** 2, -jnp.inf)

    w = mfit.walker_create(
        function=model, data=([0.0], [0.0]), params={"a": 0.5},
        log_likelihood=loglik, n_walkers=32, seed=0, walker_jitter=0.3,
        config=FitConfig(kernel="hmc"),
    )
    w.adaptive_steps(2000, temperature=1.0, auto=None)
    pos, lp = w.steps(take=1000)
    assert np.isfinite(pos).all() and np.isfinite(lp).all()
    assert (np.abs(pos) < 3.0).all()
    assert w.acceptance() > 0.05
