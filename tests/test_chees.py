"""ChEES-HMC kernel (FitConfig(kernel='chees')) — new surface.

ChEES (Hoffman, Radul & Sountsov 2021) is the batched-hardware answer to
NUTS: instead of per-chain recursive tree doubling (which cannot batch —
every chain would need a different number of gradient evaluations), one
continuous trajectory length t adapts by stochastic gradient ascent of
the ChEES criterion, estimated across the walker ensemble in a single
step.  The reference has no analogue (its only kernel is the adaptive
random walk, mcmc-fitting.lisp:1072-1095); this is the rebuild's own
surface, sharing the gradient-kernel machinery (whitened leapfrog,
step-size steering to the 0.65 optimum, typical-set refresh, rescue).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

import lisp_mcmc_tpu as mfit
from lisp_mcmc_tpu.kernel import FitConfig, init_state


def _gaussian_walker(kernel, n_walkers=128, seed=0, **cfg):
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


def test_chees_samples_known_gaussian():
    """Invariance: the jittered-length leapfrog + MH rule must leave the
    target exact regardless of where the length adaptation wanders."""
    w, mean, cov = _gaussian_walker("chees")
    w.adaptive_steps(5000, temperature=1.0, auto=None)
    pos, _ = w.steps(take=2500)
    np.testing.assert_allclose(pos.mean(axis=0), mean, atol=0.25)
    np.testing.assert_allclose(np.cov(pos.T, bias=True), cov, atol=0.5)


def test_chees_acceptance_steers_to_hmc_band():
    w, _, _ = _gaussian_walker("chees")
    w.adaptive_steps(3000, temperature=1.0, auto=None)
    assert 0.4 < w.acceptance() < 0.95


def test_chees_trajectory_adapts_and_respects_cap():
    w, _, _ = _gaussian_walker("chees", chees_max_leapfrog=16)
    t0 = w.chees_trajectory()
    assert t0["leapfrog"].shape == (1,)
    assert t0["leapfrog"][0] == pytest.approx(w.config.hmc_leapfrog)
    w.adaptive_steps(2000, temperature=1.0, auto=None)
    t1 = w.chees_trajectory()
    # Adam on log t must have moved t off its start, inside [1, cap].
    assert t1["leapfrog"][0] != pytest.approx(t0["leapfrog"][0])
    assert 1.0 <= t1["leapfrog"][0] <= 16.0
    assert t1["budget"] == 16


def test_chees_frozen_without_adaptation():
    """many_steps runs with adaptation off: t must not drift (same switch
    that freezes L)."""
    w, _, _ = _gaussian_walker("chees")
    w.adaptive_steps(1000, temperature=1.0, auto=None)
    before = w.chees_trajectory()["leapfrog"].copy()
    w.many_steps(600)
    after = w.chees_trajectory()["leapfrog"]
    np.testing.assert_allclose(after, before)


def test_chees_checkpoint_roundtrip(tmp_path):
    """The adapted trajectory state must survive save/load (a resumed
    sampling run should not re-learn t from scratch) — and pre-chees
    checkpoints (no 'chees' array) must load with a fresh zero state."""
    def model(x, p):
        return p["m"] * jnp.asarray(x) + p["b"]

    rng = np.random.default_rng(0)
    x = np.linspace(0.0, 10.0, 50)
    y = 2.0 * x + 1.0 + 0.1 * rng.standard_normal(50)
    w = mfit.walker_create(
        function=model, data=(x, y), params={"m": 1.5, "b": 0.5},
        data_error=0.1, n_walkers=64, seed=0, walker_jitter=0.05,
        config=FitConfig(kernel="chees"),
    )
    w.adaptive_steps(1000, temperature=1.0, auto=None)
    saved = np.asarray(w.state.chees).copy()
    assert np.any(saved != 0.0)
    path = str(tmp_path / "chees.npz")
    mfit.walker_save(w, path)
    loaded = mfit.walker_load(path, function=model)
    np.testing.assert_allclose(np.asarray(loaded.state.chees), saved)
    # legacy checkpoint: strip the chees array, reload -> zeros
    with np.load(path, allow_pickle=False) as z:
        arrays = {k: z[k] for k in z.files if k != "chees"}
    np.savez(str(tmp_path / "legacy.npz"), **arrays)
    legacy = mfit.walker_load(str(tmp_path / "legacy.npz"), function=model)
    np.testing.assert_allclose(np.asarray(legacy.state.chees), 0.0)


def test_chees_config_validation():
    assert FitConfig(kernel="chees").kernel == "chees"
    with pytest.raises(ValueError, match="chees"):
        FitConfig(kernel="nuts")


def test_chees_beats_rwm_ess_per_step():
    """Like HMC, ChEES trajectories must decorrelate in O(1) steps where
    the random walk needs O(d) — with the trajectory length found by the
    criterion, not by hand."""
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
    for kernel in ("rwm", "chees"):
        w = mfit.walker_create(
            function=model, data=([0.0, 1.0], [0.0, 0.0]),
            params={k: 0.1 for k in keys}, log_likelihood=loglik,
            n_walkers=32, seed=3, walker_jitter=0.5,
            config=FitConfig(kernel=kernel),
        )
        w.adaptive_steps(8000, temperature=1.0, auto=None)
        ess[kernel] = min(ess_per_param(w, take=4000).values())
    assert ess["chees"] > 3.0 * ess["rwm"], ess


def test_chees_grouped_state_per_group():
    """Grouped fits adapt one trajectory length per group; the state must
    stay (G, 4) and finite through a grouped run (BatchedFit layout)."""
    from lisp_mcmc_tpu.batched import BatchedFit

    rng = np.random.default_rng(0)
    x = np.linspace(0.0, 1.0, 16)
    datasets = []
    for s in range(2):
        y = (2.0 + s) * x + 0.5 + 0.05 * rng.normal(size=x.size)
        datasets.append((x, y))

    def model(x, p):
        return p["m"] * x + p["b"]

    bf = BatchedFit(
        function=model,
        datasets=datasets,
        params={"m": 1.0, "b": 0.0},
        data_error=0.05,
        walkers_per_dataset=64,
        seed=0,
        walker_jitter=0.2,
        config=FitConfig(kernel="chees"),
    )
    bf.adaptive_steps(600, temperature=1.0, auto=None)
    ch = np.asarray(bf.state.chees)
    assert ch.shape == (2, 4)
    assert np.all(np.isfinite(ch))
    # both groups moved off the zero start
    assert np.all(ch[:, 3] > 0)


def test_chees_groups_adapt_independently():
    """Spectra with very different posterior widths must land on
    DIFFERENT trajectory lengths (measured: 6.1 vs 19.4 leapfrog for
    sigma 0.01 vs 0.3 line fits) — one shared t would defeat the point
    of per-group adaptation."""
    from lisp_mcmc_tpu.batched import BatchedFit

    rng = np.random.default_rng(0)
    x = np.linspace(0.0, 1.0, 32)
    sigmas = [0.01, 0.3]
    datasets = [(x, 2.0 * x + 0.5 + sg * rng.normal(size=x.size))
                for sg in sigmas]

    def model(x, p):
        return p["m"] * x + p["b"]

    bf = BatchedFit(model, datasets, {"m": 1.0, "b": 0.0}, sigmas,
                    walkers_per_dataset=128, seed=0, walker_jitter=0.2,
                    config=FitConfig(kernel="chees"))
    bf.adaptive_steps(3000, temperature=1.0, auto=None)
    off = np.asarray(bf.state.chees)[:, 0]
    assert abs(off[0] - off[1]) > 0.3, off


def test_chees_state_defaults_zero():
    import jax

    st = init_state(jax.random.key(0), jnp.zeros((8, 3)), jnp.zeros((8,)),
                    jnp.eye(3), n_groups=2)
    assert st.chees.shape == (2, 4)
    np.testing.assert_allclose(np.asarray(st.chees), 0.0)


def test_chees_greedy_tuner_compatible():
    """sample_region's greedy tuner runs pretend-MH steps regardless of
    kernel; a chees-configured fit must tune without touching the
    trajectory state (greedy disables all gradient-kernel machinery)."""
    w, _, _ = _gaussian_walker("chees", n_walkers=64)
    w.adaptive_steps(800, temperature=1.0, auto=None)
    before = np.asarray(w.state.chees).copy()
    w.sample_region(400)
    np.testing.assert_allclose(np.asarray(w.state.chees), before)
    assert np.isfinite(np.asarray(w.state.logprob)).all()


def test_chees_drives_smc_moves():
    """SMC moves run whatever kernel the fit configured — the chees
    chunk under SMC's per-stage numeric temperature override must
    produce a correct evidence (pinned against Laplace)."""
    from lisp_mcmc_tpu.models import line

    sigma = 0.05
    rng = np.random.default_rng(0)
    x = np.linspace(0.0, 2.0, 40)
    y = 1.0 + 0.5 * x + sigma * rng.standard_normal(x.size)
    bounds = {"b": (-3.0, 5.0), "m": (-2.0, 4.0)}
    w = mfit.walker_create(
        function=line, data=(x, y), params={"b": 1.0, "m": 0.5},
        data_error=sigma, log_prior=mfit.make_bounds_prior(bounds),
        n_walkers=256, seed=0, walker_jitter=0.1,
        config=FitConfig(kernel="chees"))
    res = w.smc_sample(bounds, n_move=100)
    w.optimize(300, rounds=2)
    lap = w.laplace_approx()
    assert res.log_z == pytest.approx(lap.log_z, abs=0.5)


def test_chees_sbc_calibrated():
    """Simulation-based calibration through a chees sampling phase: the
    strongest end-to-end exactness audit a kernel can get — uniform
    ranks require the self-tuning trajectories to leave the posterior
    exactly invariant across 40 independent simulated fits."""
    from lisp_mcmc_tpu.models import line

    x = np.linspace(0.0, 10.0, 40)
    bounds = {"m": (0.5, 3.0), "b": (-2.0, 2.0)}
    res = mfit.sbc_check(line, bounds, x, 0.3, n_sims=40,
                         walkers_per_dataset=32, n_steps=2000, seed=1,
                         sampling_steps=2000, sampling_kernel="chees",
                         burn_fraction=0.33)
    assert res.ok()
    assert all(p > 0.005 for p in res.p_values.values())
