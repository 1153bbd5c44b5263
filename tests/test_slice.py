"""Ensemble slice kernel (FitConfig(kernel='slice')) — new surface:
Karamanis & Beutler (2021) ensemble slice sampling on the same red-black
chunked-scan machinery as stretch/demc.  Directions are walker-pair
differences (the differential move), the 1-d move is Neal (2003)
stepping-out + shrinkage with budgeted, exactly-invariant expansion —
gradient-free, scale-free, and rejection-free."""

import jax.numpy as jnp
import numpy as np
import pytest

import lisp_mcmc_tpu as mfit
from lisp_mcmc_tpu.kernel import FitConfig
from lisp_mcmc_tpu.models import line


def _gaussian_walker(n_walkers=64, seed=0, cov=None, mean=None, **cfg):
    target_mean = np.array([1.0, -2.0]) if mean is None else np.asarray(mean)
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
        config=FitConfig(kernel="slice", **cfg),
    )
    return w, target_mean, target_cov


def test_slice_samples_known_gaussian():
    """The budgeted stepping-out/shrinkage must leave the target exactly
    invariant — the moments test that pins every kernel in the family."""
    w, mean, cov = _gaussian_walker()
    w.adaptive_steps(6000, temperature=1.0, auto=None)
    pos, _ = w.steps(take=3000)
    np.testing.assert_allclose(pos.mean(axis=0), mean, atol=0.25)
    np.testing.assert_allclose(np.cov(pos.T, bias=True), cov, atol=0.5)


def test_slice_is_rejection_free():
    """Every walker whose shrink loop lands moves — 'acceptance' (the
    landed fraction) must sit at ~1, unlike any MH kernel's band."""
    w, _, _ = _gaussian_walker()
    w.adaptive_steps(2000, temperature=1.0, auto=None)
    assert w.acceptance() > 0.97


def test_slice_affine_invariance_no_adaptation():
    """1e6 condition number with NO proposal adaptation: the pair
    differences carry the anisotropy, exactly as for demc."""
    cov = np.array([[1.0e4, 0.0], [0.0, 1.0e-2]])
    w, mean, _ = _gaussian_walker(n_walkers=128, cov=cov)
    w.adaptive_steps(8000, temperature=1.0, auto=None)
    pos, _ = w.steps(take=4000)
    np.testing.assert_allclose(pos.mean(axis=0) / np.sqrt(np.diag(cov)),
                               mean / np.sqrt(np.diag(cov)), atol=0.2)
    np.testing.assert_allclose(pos.var(axis=0) / np.diag(cov),
                               np.ones(2), rtol=0.35)


def test_slice_correlated_target():
    cov = np.array([[1.0, 0.99], [0.99, 1.0]])
    w, mean, _ = _gaussian_walker(n_walkers=128, cov=cov)
    w.adaptive_steps(8000, temperature=1.0, auto=None)
    pos, _ = w.steps(take=4000)
    rho = np.corrcoef(pos.T)[0, 1]
    assert rho == pytest.approx(0.99, abs=0.05)


def test_slice_line_fit():
    rng = np.random.default_rng(0)
    x = np.linspace(0.0, 10.0, 50)
    y = 2.0 * x + 1.0 + 0.1 * rng.standard_normal(50)
    w = mfit.walker_create(
        function=line, data=(x, y), params={"m": 1.5, "b": 0.5},
        data_error=0.1, n_walkers=32, seed=0, walker_jitter=0.05,
        config=FitConfig(kernel="slice"),
    )
    w.adaptive_steps(3000, auto=None)
    best = w.most_likely_params()
    assert best["m"] == pytest.approx(2.0, abs=0.05)
    assert best["b"] == pytest.approx(1.0, abs=0.3)


def test_anneal_rwm_then_sample_slice():
    """Kernel switch at a chunk boundary preserves best-fit quality."""
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
    w.sampling_steps(2000, kernel="slice")
    lp_slice, best = w.most_likely_step()
    assert lp_slice >= lp_rwm - 1e-9
    assert best["x0"] == pytest.approx(0.7, abs=0.1)
    assert w.acceptance() > 0.9


def test_slice_per_step_mixing_beats_demc():
    """The design claim behind the kernel: on a cheap correlated target
    the rejection-free move decorrelates faster PER STEP than demc's
    MH-filtered moves (each slice step costs more evaluations — the
    trade documented in TUNING.md).  Measured at this exact setup:
    slice 5742 / demc 4260 / stretch 1501 min-ESS — asserted with
    margin below the measured 1.35x / 3.8x ratios."""
    from lisp_mcmc_tpu.diagnostics import ess_per_param

    d = 8
    rng = np.random.default_rng(4)
    q, _ = np.linalg.qr(rng.standard_normal((d, d)))
    scales = np.geomspace(1.0, 100.0, d) ** 0.5
    cov = (q * scales**2) @ q.T
    prec = jnp.asarray(np.linalg.inv(cov))
    keys = [f"p{i}" for i in range(d)]

    def model(x, p):
        return jnp.zeros_like(x)

    def loglik(fn, params, dataset):
        v = jnp.stack([params[k] for k in keys])
        return -0.5 * v @ prec @ v

    ess = {}
    for kern in ("demc", "slice", "stretch"):
        w = mfit.walker_create(
            function=model, data=([0.0, 1.0], [0.0, 0.0]),
            params={k: 0.1 for k in keys}, log_likelihood=loglik,
            n_walkers=64, seed=0, walker_jitter=1.0,
            config=FitConfig(kernel=kern))
        w.adaptive_steps(2000, temperature=1.0, auto=None,
                         collect_history=False)
        w.adaptive_steps(2000, temperature=1.0, auto=None)
        ess[kern] = min(ess_per_param(w).values())
    assert ess["slice"] > 1.15 * ess["demc"], ess
    assert ess["slice"] > 2.5 * ess["stretch"], ess


def test_slice_batched_fit():
    """Grouped batched fits slice within their own walker block."""
    from lisp_mcmc_tpu.models import exponential_decay

    rng = np.random.default_rng(1)
    x = np.linspace(0.0, 10.0, 96)
    taus = [1.0, 4.0]
    ds = [(x, 2.0 * np.exp(-x / t) + 0.1 + 0.01 * rng.standard_normal(96))
          for t in taus]
    fit = mfit.BatchedFit(
        exponential_decay, ds, {"scale": 1.5, "tau": 2.0, "bg0": 0.2},
        data_error=0.01, walkers_per_dataset=32, seed=0,
        config=FitConfig(kernel="slice"),
    )
    fit.adaptive_steps(4000, auto=None)
    for tau, p in zip(taus, fit.best_params_per_dataset()):
        assert p["tau"] == pytest.approx(tau, rel=0.15)


def test_slice_guards_shared_with_ensemble_kernels():
    """Zero-spread, rank-deficiency, and minimum-ensemble guards cover
    the slice kernel exactly as they do stretch/demc."""
    def model(x, p):
        return jnp.zeros_like(x)

    w = mfit.walker_create(
        function=model, data=([0.0, 1.0], [0.0, 0.0]),
        params={"a": 0.5, "b": -1.0},
        log_likelihood=lambda fn, p, ds: -0.5 * (p["a"] ** 2 + p["b"] ** 2),
        n_walkers=16, seed=0, walker_jitter=0.0,
        config=FitConfig(kernel="slice"),
    )
    with pytest.raises(ValueError, match="zero spread"):
        w.adaptive_steps(200, auto=None)

    # rank deficiency: B <= d walkers span an affine subspace
    d = 8
    keys = [f"p{i}" for i in range(d)]
    w2 = mfit.walker_create(
        function=model, data=([0.0, 1.0], [0.0, 0.0]),
        params={k: 0.1 for k in keys},
        log_likelihood=lambda fn, p, ds: -0.5 * sum(p[k] ** 2 for k in keys),
        n_walkers=8, seed=0, walker_jitter=0.1,
        config=FitConfig(kernel="slice"),
    )
    with pytest.raises(ValueError, match="affine subspace"):
        w2.adaptive_steps(200, auto=None)


def test_slice_tempering_switches_to_rwm():
    """tempered_steps forces kernel='rwm' for the ladder search phase and
    restores the configured kernel afterwards (same contract as demc)."""
    w, _, _ = _gaussian_walker(n_walkers=32)
    w.tempered_steps(400, rungs=4)
    assert w.config.kernel == "slice"
    # Right after the ladder the ensemble is hot-rung-wide: pair
    # differences dwarf the cold slice, so some shrink loops exhaust
    # their budget (landed fraction < 1) — it recovers as the ensemble
    # contracts onto the posterior.
    w.adaptive_steps(400, temperature=1.0, auto=None)
    assert w.acceptance() > 0.5
    w.adaptive_steps(800, temperature=1.0, auto=None)
    assert w.acceptance() > 0.9


def test_slice_checkpoint_roundtrip(tmp_path):
    """FitConfig's slice fields ride the recipe checkpoint; resumed fits
    keep stepping with the same kernel."""
    rng = np.random.default_rng(0)
    x = np.linspace(0.0, 10.0, 50)
    y = 2.0 * x + 1.0 + 0.1 * rng.standard_normal(50)
    w = mfit.walker_create(
        function=line, data=(x, y), params={"m": 1.5, "b": 0.5},
        data_error=0.1, n_walkers=32, seed=0, walker_jitter=0.05,
        config=FitConfig(kernel="slice", slice_max_expand=3,
                         slice_max_shrink=12),
    )
    w.adaptive_steps(1000, auto=None)
    path = str(tmp_path / "slice_ckpt.npz")
    mfit.walker_save(w, path)
    w2 = mfit.walker_load(path)
    assert w2.config.kernel == "slice"
    assert w2.config.slice_max_expand == 3
    w2.adaptive_steps(500, temperature=1.0, auto=None)
    assert w2.most_likely_params()["m"] == pytest.approx(2.0, abs=0.05)


def test_unknown_kernel_name_raises():
    """An unknown kernel string must fail loudly at config construction,
    never silently fall through to the rwm dispatch."""
    with pytest.raises(ValueError, match="kernel must be one of"):
        FitConfig(kernel="slicee")
