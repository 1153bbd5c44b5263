"""Differential-evolution kernel (FitConfig(kernel='demc')) — new
surface: ter Braak (2006) ensemble moves, red-black half updates on the
same chunked-scan machinery as rwm/stretch.  Proposals step along the
DIFFERENCE of two distinct complementary walkers, so the step-direction
distribution is the ensemble covariance itself — Haario optimal scaling
with no covariance estimation, no Cholesky, and affine invariance."""

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
        config=FitConfig(kernel="demc", **cfg),
    )
    return w, target_mean, target_cov


def test_demc_samples_known_gaussian():
    """DE-MC must target the same invariant distribution as MH — this
    validates the symmetric accept rule and the red-black sequencing."""
    w, mean, cov = _gaussian_walker()
    w.adaptive_steps(8000, temperature=1.0, auto=None)
    pos, _ = w.steps(take=4000)
    np.testing.assert_allclose(pos.mean(axis=0), mean, atol=0.25)
    np.testing.assert_allclose(np.cov(pos.T, bias=True), cov, atol=0.5)


def test_demc_affine_invariance_no_adaptation():
    """A 1e6-condition-number target sampled correctly with NO proposal
    adaptation — the pair differences supply the full anisotropy."""
    cov = np.array([[1.0e4, 0.0], [0.0, 1.0e-2]])
    w, mean, _ = _gaussian_walker(n_walkers=128, cov=cov)
    w.adaptive_steps(12000, temperature=1.0, auto=None)
    pos, _ = w.steps(take=6000)
    assert 0.1 < w.acceptance() < 0.9
    np.testing.assert_allclose(pos.mean(axis=0) / np.sqrt(np.diag(cov)),
                               mean / np.sqrt(np.diag(cov)), atol=0.2)
    np.testing.assert_allclose(pos.var(axis=0) / np.diag(cov),
                               np.ones(2), rtol=0.35)


def test_demc_correlated_target_acceptance():
    """Strong correlation (rho=0.99): single-line stretch proposals and
    unadapted rwm both struggle there; DE-MC's ensemble-covariance
    directions keep acceptance healthy and recover the correlation."""
    cov = np.array([[1.0, 0.99], [0.99, 1.0]])
    w, mean, _ = _gaussian_walker(n_walkers=128, cov=cov)
    w.adaptive_steps(12000, temperature=1.0, auto=None)
    pos, _ = w.steps(take=6000)
    assert 0.1 < w.acceptance() < 0.9
    rho = np.corrcoef(pos.T)[0, 1]
    assert rho == pytest.approx(0.99, abs=0.05)


def test_demc_line_fit():
    rng = np.random.default_rng(0)
    x = np.linspace(0.0, 10.0, 50)
    y = 2.0 * x + 1.0 + 0.1 * rng.standard_normal(50)
    w = mfit.walker_create(
        function=line, data=(x, y), params={"m": 1.5, "b": 0.5},
        data_error=0.1, n_walkers=32, seed=0, walker_jitter=0.05,
        config=FitConfig(kernel="demc"),
    )
    w.adaptive_steps(4000, auto=None)
    best = w.most_likely_params()
    assert best["m"] == pytest.approx(2.0, abs=0.05)
    assert best["b"] == pytest.approx(1.0, abs=0.3)


def test_anneal_rwm_then_sample_demc():
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
    w.sampling_steps(3000, kernel="demc")
    lp_demc, best = w.most_likely_step()
    assert lp_demc >= lp_rwm - 1e-9
    assert best["x0"] == pytest.approx(0.7, abs=0.1)
    assert 0.1 < w.acceptance() < 0.9


def test_demc_mode_jump_bimodal():
    """The gamma=1 jump move carries walkers between well-separated modes
    whose spacing matches the ensemble spread (the property scaled moves
    lack — with demc_jump_prob=0 the between-mode flow collapses)."""
    sep = 8.0

    def model(x, p):
        return jnp.zeros_like(x)

    def loglik(fn, params, dataset):
        a = params["a"]
        return jnp.logaddexp(-0.5 * (a - sep / 2) ** 2,
                             -0.5 * (a + sep / 2) ** 2) \
            - 0.5 * params["b"] ** 2

    def make(jump_prob):
        w = mfit.walker_create(
            function=model, data=([0.0, 1.0], [0.0, 0.0]),
            params={"a": 0.1, "b": 0.1}, log_likelihood=loglik,
            n_walkers=256, seed=2, walker_jitter=6.0,
            config=FitConfig(kernel="demc", demc_jump_prob=jump_prob),
        )
        w.adaptive_steps(6000, temperature=1.0, auto=None)
        pos, _ = w.steps(take=2000)
        frac_hi = float(np.mean(pos[:, 0] > 0))
        return frac_hi

    frac = make(0.1)
    # Both modes populated near 50/50 (equal weights by construction).
    assert 0.3 < frac < 0.7


def test_demc_batched_fit():
    """Grouped batched fits pair within their own walker block (proposals
    never cross datasets)."""
    from lisp_mcmc_tpu.models import exponential_decay

    rng = np.random.default_rng(1)
    x = np.linspace(0.0, 10.0, 96)
    taus = [1.0, 4.0]
    ds = [(x, 2.0 * np.exp(-x / t) + 0.1 + 0.01 * rng.standard_normal(96))
          for t in taus]
    fit = mfit.BatchedFit(
        exponential_decay, ds, {"scale": 1.5, "tau": 2.0, "bg0": 0.2},
        data_error=0.01, walkers_per_dataset=32, seed=0,
        config=FitConfig(kernel="demc"),
    )
    fit.adaptive_steps(5000, auto=None)
    for tau, p in zip(taus, fit.best_params_per_dataset()):
        assert p["tau"] == pytest.approx(tau, rel=0.15)


def test_demc_beats_stretch_per_step_at_high_d():
    """The design claim behind the kernel (pinned at CPU scale): at high
    dimension the stretch move's
    single-line proposals thin out while demc's full-rank pair
    differences keep decorrelating — demc's min-ESS per step must beat
    stretch's on the same correlated target."""
    import jax.numpy as jnp

    from lisp_mcmc_tpu.diagnostics import ess_per_param

    d = 16
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
    for kern in ("stretch", "demc"):
        w = mfit.walker_create(
            function=model, data=([0.0, 1.0], [0.0, 0.0]),
            params={k: 0.1 for k in keys}, log_likelihood=loglik,
            n_walkers=128, seed=0, walker_jitter=1.0,
            config=FitConfig(kernel=kern))
        w.adaptive_steps(3000, temperature=1.0, auto=None,
                         collect_history=False)
        w.adaptive_steps(3000, temperature=1.0, auto=None)
        ess[kern] = min(ess_per_param(w).values())
    assert ess["demc"] > 1.3 * ess["stretch"], ess


def test_demc_rejects_collapsed_ensemble():
    """Pure ensemble moves cannot create spread they do not have: a
    zero-jitter start (or reset_to_most_likely) must raise, not silently
    freeze with acceptance pinned at 1 (measured failure mode)."""
    import jax.numpy as jnp

    def model(x, p):
        return jnp.zeros_like(x)

    w = mfit.walker_create(
        function=model, data=([0.0, 1.0], [0.0, 0.0]),
        params={"a": 0.5, "b": -1.0},
        log_likelihood=lambda fn, p, ds: -0.5 * (p["a"] ** 2 + p["b"] ** 2),
        n_walkers=16, seed=0, walker_jitter=0.0,   # <- degenerate start
        config=FitConfig(kernel="demc"),
    )
    with pytest.raises(ValueError, match="zero spread"):
        w.adaptive_steps(200, auto=None)


def test_reset_then_ensemble_kernel_guarded():
    """The documented reset->sample recipe must fail loudly for the
    ensemble kernels (reset_to_most_likely collapses every walker to
    one point) and work again after regenerating spread with rwm."""
    w, _, _ = _gaussian_walker(n_walkers=32)
    w.adaptive_steps(1000, temperature=1.0, auto=None)
    w.reset_to_most_likely()
    with pytest.raises(ValueError, match="zero spread"):
        w.sampling_steps(200, kernel="demc")
    with pytest.raises(ValueError, match="zero spread"):
        w.sampling_steps(200, kernel="stretch")
    w.sampling_steps(400, kernel="rwm")   # regenerate spread with rwm
    w.sampling_steps(400, kernel="demc")
    assert 0.0 < w.acceptance() < 1.0


def test_demc_needs_four_walkers_per_group():
    w, _, _ = _gaussian_walker(n_walkers=2)
    with pytest.raises(ValueError, match="affine subspace|>= 4 walkers"):
        w.adaptive_steps(100, auto=None)


def test_ensemble_kernels_reject_rank_deficient_ensembles():
    """B <= d walkers per group span a strict affine subspace: the fit
    would silently sample a slice of the posterior with healthy-looking
    acceptance — both red-black kernels must refuse (the zero-spread
    guard cannot catch this)."""
    import jax.numpy as jnp

    d = 8
    keys = [f"p{i}" for i in range(d)]

    def model(x, p):
        return jnp.zeros_like(x)

    def loglik(fn, params, dataset):
        return -0.5 * sum(params[k] ** 2 for k in keys)

    for kern in ("demc", "stretch"):
        w = mfit.walker_create(
            function=model, data=([0.0, 1.0], [0.0, 0.0]),
            params={k: 0.1 for k in keys}, log_likelihood=loglik,
            n_walkers=8, seed=0, walker_jitter=0.1,   # 8 walkers, d=8
            config=FitConfig(kernel=kern),
        )
        with pytest.raises(ValueError, match="affine subspace"):
            w.adaptive_steps(200, auto=None)


def test_demc_tempering_switches_to_rwm():
    """tempered_steps forces kernel='rwm' for the ladder search phase and
    restores the configured kernel afterwards (same contract as stretch:
    tempering is a search tool, the red-black kernels are samplers)."""
    w, _, _ = _gaussian_walker(n_walkers=32)
    w.tempered_steps(400, rungs=4)
    assert w.config.kernel == "demc"
    w.adaptive_steps(400, temperature=1.0, auto=None)
    assert 0.0 < w.acceptance() < 1.0
