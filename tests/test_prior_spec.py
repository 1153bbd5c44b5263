"""Named priors (PriorSpec) through the evidence/calibration layer.

Round-3 surface (VERDICT r2 #3): the reference's MCMC core accepts any
prior density term (mcmc-fitting.lisp:346-369, 837-845), but everything
built on a beta=0 reference measure needed a uniform box.  These tests
pin the generalization: Gaussian/log-normal/truncated priors flow
through ``log_evidence`` / ``smc_sample`` / ``nested_sample`` /
``laplace_approx`` / ``prior_predictive`` / ``sbc_check`` via the
unit-cube prior transform, and the four evidence estimators agree with
an analytic (quadrature) conjugate-Gaussian anchor.
"""

import numpy as np
import jax.numpy as jnp
import pytest

import lisp_mcmc_tpu as mfit
from lisp_mcmc_tpu.priors import (
    Gaussian,
    LogNormal,
    PriorSpec,
    Uniform,
    as_prior_spec,
    make_bounds_prior,
    resolve_prior_spec,
    unit_cube_wall,
)


# ----------------------------------------------------------------- dists

def test_distribution_roundtrips_and_masses():
    rng = np.random.default_rng(0)
    for dist in [
        Uniform(-2.0, 5.0),
        Gaussian(2.0, 0.5),
        Gaussian(0.0, 1.0, low=-1.0, high=2.0),
        LogNormal(0.0, 0.75),
        LogNormal(-1.0, 0.5, low=0.05, high=3.0),
    ]:
        u = jnp.linspace(0.01, 0.99, 23)
        x = dist.icdf(u)
        assert np.allclose(np.asarray(dist.cdf(x)), np.asarray(u), atol=1e-9)
        lo, hi = dist.support
        s = np.asarray(dist.sample(rng, 4000))
        assert (s > lo).all() and (s < hi).all()
        # normalized density: numeric mass ~ 1 over the support
        glo = lo if np.isfinite(lo) else float(dist.icdf(jnp.asarray(1e-7)))
        ghi = hi if np.isfinite(hi) else float(dist.icdf(jnp.asarray(1 - 1e-7)))
        g = np.linspace(glo + 1e-9, ghi - 1e-9, 200001)
        mass = np.trapezoid(np.exp(np.asarray(dist.log_pdf(g))), g)
        assert abs(mass - 1.0) < 2e-3, (dist, mass)


def test_truncated_gaussian_sample_moments():
    rng = np.random.default_rng(1)
    d = Gaussian(0.0, 1.0, low=-1.0, high=2.0)
    s = d.sample(rng, 200000)
    g = np.linspace(-1, 2, 100001)
    pdf = np.exp(np.asarray(d.log_pdf(g)))
    mean_ref = np.trapezoid(g * pdf, g)
    assert abs(s.mean() - mean_ref) < 5e-3


def test_spec_coercion_and_validation():
    spec = as_prior_spec({"a": (0, 2), "b": Gaussian(1.0, 0.3)})
    assert isinstance(spec["a"], Uniform) and not spec.is_uniform
    assert spec.bounds is None  # unbounded Gaussian support
    assert as_prior_spec({"a": (0, 1)}).is_uniform
    assert PriorSpec.from_meta(spec.to_meta()) == spec
    with pytest.raises(ValueError):
        PriorSpec({"a": "nope"})
    with pytest.raises(ValueError):
        Uniform(1.0, 1.0)
    with pytest.raises(ValueError):
        Gaussian(0.0, 0.0)
    with pytest.raises(ValueError):
        Gaussian(0.0, 1.0, low=50.0, high=51.0)  # no mass
    with pytest.raises(ValueError):
        LogNormal(0.0, 1.0, low=-1.0)


def test_as_log_prior_uniform_matches_bounds_prior():
    bounds = {"a": (0.0, 2.0), "b": (-1.0, 1.0)}
    p_spec = PriorSpec(bounds).as_log_prior()
    p_box = make_bounds_prior(bounds)
    for a, b in [(1.0, 0.0), (3.0, 0.0), (-0.5, 2.0), (0.5, -0.99)]:
        params = {"a": jnp.asarray(a), "b": jnp.asarray(b)}
        assert float(p_spec(params)) == pytest.approx(float(p_box(params)),
                                                      rel=1e-12)
    # recovery hooks
    assert p_spec._bounds == bounds
    assert resolve_prior_spec(None, prior=p_spec._prior_spec).is_uniform


def test_as_log_prior_named_density():
    spec = PriorSpec({"m": Gaussian(1.0, 0.5)})
    p = spec.as_log_prior()
    v = float(p({"m": jnp.asarray(1.5)}))
    expect = -0.5 - np.log(0.5 * np.sqrt(2 * np.pi))
    assert v == pytest.approx(expect, rel=1e-12)


def test_unit_cube_wall():
    assert float(unit_cube_wall(jnp.asarray([0.3, 0.9]))) == 0.0
    w = float(unit_cube_wall(jnp.asarray([1.01, 0.5])))
    assert w < -1e7  # impenetrable even at beta_min ~ 1e-5


# ----------------------------------------------- the conjugate anchor fit

SIGMA = 0.5


def _line(xg, p):
    return p["m"] + p["b"] * xg


@pytest.fixture(scope="module")
def conjugate():
    """Gaussian likelihood x Gaussian prior with a quadrature logZ."""
    rng = np.random.default_rng(42)
    x = np.linspace(0.0, 1.0, 20)
    y = 1.3 + SIGMA * rng.standard_normal(20)
    spec = PriorSpec({"m": Gaussian(0.0, 2.0), "b": Gaussian(0.0, 1.5)})

    mg = np.linspace(-8, 8, 641)
    bg = np.linspace(-6, 6, 641)
    M, B = np.meshgrid(mg, bg, indexing="ij")
    ll = np.zeros_like(M)
    for xi, yi in zip(x, y):
        ll += (-0.5 * ((yi - (M + B * xi)) / SIGMA) ** 2
               - 0.5 * np.log(2 * np.pi * SIGMA ** 2))
    lp = ll \
        + (-0.5 * (M / 2.0) ** 2 - np.log(2.0 * np.sqrt(2 * np.pi))) \
        + (-0.5 * (B / 1.5) ** 2 - np.log(1.5 * np.sqrt(2 * np.pi)))
    peak = lp.max()
    log_z = peak + np.log(np.trapezoid(
        np.trapezoid(np.exp(lp - peak), bg, axis=1), mg))
    return x, y, spec, float(log_z)


def _make_fit(x, y, spec, seed=0, n_walkers=512):
    return mfit.walker_create(
        function=_line, data=(x, y), params={"m": 0.5, "b": 0.1},
        data_error=SIGMA, n_walkers=n_walkers, seed=seed,
        walker_jitter=0.3, log_prior=spec)


def test_conjugate_evidence_ladder_and_laplace(conjugate):
    x, y, spec, log_z_ref = conjugate
    w = _make_fit(x, y, spec)
    ev = w.log_evidence(n_steps=12000, rungs=16, t_max=1e4, prior=spec)
    assert ev.log_z == pytest.approx(log_z_ref, abs=0.25)

    w2 = _make_fit(x, y, spec, seed=3)
    w2.adaptive_steps(2000, temperature=2.0, auto=None)
    w2.optimize(300)
    la = w2.laplace_approx()          # spec recovered from the fitted term
    # Gaussian x Gaussian: the Laplace approximation is EXACT.
    assert la.log_z == pytest.approx(log_z_ref, abs=2e-3)
    assert la.n_clamped == 0


def test_conjugate_evidence_smc_and_posterior(conjugate):
    x, y, spec, log_z_ref = conjugate
    w = _make_fit(x, y, spec, seed=1)
    res = w.smc_sample(prior=spec, n_move=200)
    assert res.log_z == pytest.approx(log_z_ref, abs=0.3)
    # the ORIGINAL ensemble must end posterior-distributed in theta-space
    pos = np.asarray(w.state.position)
    lp_ref = np.asarray(w.state.logprob)
    assert np.isfinite(lp_ref).all()
    # conjugate posterior mean for comparison (from quadrature moments)
    A = np.stack([np.ones_like(x), x], axis=1)
    prior_prec = np.diag([1 / 2.0 ** 2, 1 / 1.5 ** 2])
    post_prec = prior_prec + A.T @ A / SIGMA ** 2
    post_mean = np.linalg.solve(post_prec, A.T @ y / SIGMA ** 2)
    assert abs(pos[:, 0].mean() - post_mean[0]) < 0.08
    assert abs(pos[:, 1].mean() - post_mean[1]) < 0.15


def test_conjugate_evidence_nested(conjugate):
    x, y, spec, log_z_ref = conjugate
    w = _make_fit(x, y, spec, seed=2, n_walkers=64)
    ns = w.nested_sample(n_live=512, stop_frac=1e-5, seed=7)
    assert ns.log_z == pytest.approx(log_z_ref, abs=max(0.3, 4 * ns.log_z_err))
    # samples come back in PHYSICAL space: the posterior-mean check
    draws = ns.posterior_draws(4000, seed=0)
    A = np.stack([np.ones_like(x), x], axis=1)
    prior_prec = np.diag([1 / 2.0 ** 2, 1 / 1.5 ** 2])
    post_mean = np.linalg.solve(prior_prec + A.T @ A / SIGMA ** 2,
                                A.T @ y / SIGMA ** 2)
    assert np.allclose(draws.mean(axis=0), post_mean, atol=0.1)


def test_uniform_spec_is_bitwise_the_bounds_path(conjugate):
    """prior=PriorSpec(box) must route through the EXACT legacy path."""
    x, y, _, _ = conjugate
    box = {"m": (-4.0, 4.0), "b": (-3.0, 3.0)}
    w1 = mfit.walker_create(function=_line, data=(x, y),
                            params={"m": 0.5, "b": 0.1}, data_error=SIGMA,
                            n_walkers=64, seed=5,
                            log_prior=make_bounds_prior(box))
    w2 = mfit.walker_create(function=_line, data=(x, y),
                            params={"m": 0.5, "b": 0.1}, data_error=SIGMA,
                            n_walkers=64, seed=5,
                            log_prior=PriorSpec(box))
    n1 = w1.nested_sample(bounds=box, n_live=128, stop_frac=1e-3, seed=3)
    n2 = w2.nested_sample(prior=PriorSpec(box), n_live=128, stop_frac=1e-3,
                          seed=3)
    assert n1.log_z == n2.log_z
    assert np.array_equal(n1.samples, n2.samples)


def test_prior_predictive_named(conjugate):
    x, y, spec, _ = conjugate
    w = _make_fit(x, y, spec, seed=6, n_walkers=16)
    draws = w.prior_predictive(n_samples=512)[0]
    # prior replicates: mean curve ~ prior mean of m + b*x = 0
    assert abs(draws.mu.mean()) < 0.3
    # and spread reflects the prior scale, far wider than the noise
    assert draws.mu.std() > 1.0


def test_sbc_with_gaussian_prior():
    x = np.linspace(0, 1, 32)
    spec = PriorSpec({"m": Gaussian(1.0, 0.5), "b": Uniform(-1.0, 1.0)})
    res = mfit.sbc_check(_line, spec, x, 0.1, n_sims=32,
                         walkers_per_dataset=32, n_steps=2500, seed=3)
    assert res.ok(), res.p_values
    assert res.true_params.shape == (32, 2)


def test_checkpoint_roundtrip_spec_prior(tmp_path, conjugate):
    from lisp_mcmc_tpu.checkpoint import walker_load, walker_save

    x, y, spec, _ = conjugate
    w = _make_fit(x, y, spec, seed=8, n_walkers=16)
    w.adaptive_steps(400, temperature=2.0, auto=None)
    path = str(tmp_path / "spec_fit.npz")
    walker_save(w, path)
    w2 = walker_load(path, function=_line)
    got = getattr(w2.terms[0].prior, "_prior_spec", None)
    assert got == spec
    # the loaded posterior matches at the ensemble
    lp1 = np.asarray(w._eval_batch(w.state.position))
    lp2 = np.asarray(w2._eval_batch(w.state.position))
    assert np.allclose(lp1, lp2, rtol=1e-12)


def test_unit_cube_view_posterior_identity(conjugate):
    """logpost_u(u) == logpost(F^-1(u)) - installed(F^-1(u)) in the cube."""
    x, y, spec, _ = conjugate
    w = _make_fit(x, y, spec, seed=9, n_walkers=8)
    uw = mfit.unit_cube_view(w, spec)
    data = w._posterior_data()
    u = jnp.asarray([0.3, 0.7], w.dtype)
    th = spec.transform(u, w.spec.keys)
    lhs = float(uw._log_post_one(u, data))
    rhs = float(w._log_post_one(th, data)) \
        - float(spec.installed_vec(th, w.spec.keys))
    assert lhs == pytest.approx(rhs, rel=1e-12)
    # outside the cube the wall dominates
    assert float(uw._log_post_one(jnp.asarray([1.2, 0.5], w.dtype), data)) < -1e7
    # and the view never mutates the original
    before = np.asarray(w.state.position).copy()
    uw.adaptive_steps(200, temperature=2.0, auto=None)
    assert np.array_equal(before, np.asarray(w.state.position))


def test_lognormal_prior_through_nested():
    """A log-normal scale prior: nested vs 1-d quadrature."""
    rng = np.random.default_rng(5)
    x = np.linspace(0, 1, 16)
    true_a = 2.0
    y = true_a * np.exp(-x) + 0.2 * rng.standard_normal(16)

    def decay(xg, p):
        return p["a"] * jnp.exp(-xg)

    dist = LogNormal(0.5, 0.6)
    spec = PriorSpec({"a": dist})
    w = mfit.walker_create(function=decay, data=(x, y), params={"a": 1.0},
                           data_error=0.2, n_walkers=64, seed=0,
                           walker_jitter=0.1, log_prior=spec)
    ns = w.nested_sample(prior=spec, n_live=400, stop_frac=1e-5, seed=1)
    g = np.linspace(1e-4, 12.0, 200001)
    ll = np.zeros_like(g)
    for xi, yi in zip(x, y):
        ll += (-0.5 * ((yi - g * np.exp(-xi)) / 0.2) ** 2
               - 0.5 * np.log(2 * np.pi * 0.2 ** 2))
    lp = ll + np.asarray(dist.log_pdf(g))
    peak = lp.max()
    log_z_ref = peak + np.log(np.trapezoid(np.exp(lp - peak), g))
    assert ns.log_z == pytest.approx(log_z_ref,
                                     abs=max(0.3, 4 * ns.log_z_err))
    assert (ns.samples > 0).all()


# ----------------------------------------------- correlated (MV) priors

from lisp_mcmc_tpu.priors import MVGaussian


def test_mv_gaussian_protocol():
    cov = np.array([[0.09, 0.04], [0.04, 0.16]])
    mv = MVGaussian({"a": 1.0, "b": -0.5}, cov)
    rng = np.random.default_rng(0)
    s = mv.sample(rng, 100000, ["a", "b"])
    assert np.allclose(s.mean(axis=0), [1.0, -0.5], atol=0.01)
    assert np.allclose(np.cov(s.T), cov, atol=0.01)
    # unit-cube roundtrip, including a permuted key order
    u = jnp.asarray([0.3, 0.8])
    th = mv.transform(u, ["a", "b"])
    assert np.allclose(np.asarray(mv.inverse(th, ["a", "b"])),
                       np.asarray(u), atol=1e-10)
    th_ba = mv.transform(u[::-1], ["b", "a"])
    assert np.allclose(np.asarray(th_ba), np.asarray(th)[::-1])
    # joint density vs scipy
    from scipy.stats import multivariate_normal

    ref = multivariate_normal([1.0, -0.5], cov).logpdf([1.2, -0.3])
    got = float(mv.log_pdf({"a": jnp.asarray(1.2), "b": jnp.asarray(-0.3)}))
    assert got == pytest.approx(ref, rel=1e-12)
    # recipe roundtrip through the PriorSpec dispatcher
    assert PriorSpec.from_meta(mv.to_meta()) == mv
    # the Mapping face exposes MARGINALS, but coercion must NOT flatten
    assert isinstance(mv["a"], Gaussian)
    assert as_prior_spec(mv) is mv
    with pytest.raises(ValueError):
        MVGaussian({"a": 0.0, "b": 0.0}, np.array([[1.0, 2.0], [2.0, 1.0]]))
    with pytest.raises(ValueError):
        mv.transform(u, ["a"])       # a correlated prior is all-or-nothing


def test_mv_gaussian_evidence_conjugate(conjugate):
    """Correlated prior through Laplace + nested vs 2-d quadrature."""
    x, y, _, _ = conjugate
    cov = np.array([[4.0, 1.5], [1.5, 2.25]])       # correlated!
    mv = MVGaussian({"m": 0.0, "b": 0.0}, cov)

    mg = np.linspace(-8, 8, 641)
    bg = np.linspace(-6, 6, 641)
    M, B = np.meshgrid(mg, bg, indexing="ij")
    ll = np.zeros_like(M)
    for xi, yi in zip(x, y):
        ll += (-0.5 * ((yi - (M + B * xi)) / SIGMA) ** 2
               - 0.5 * np.log(2 * np.pi * SIGMA ** 2))
    from scipy.stats import multivariate_normal

    lp = ll + multivariate_normal([0.0, 0.0], cov).logpdf(
        np.stack([M, B], axis=-1))
    peak = lp.max()
    log_z_ref = peak + np.log(np.trapezoid(
        np.trapezoid(np.exp(lp - peak), bg, axis=1), mg))

    w = mfit.walker_create(function=_line, data=(x, y),
                           params={"m": 0.5, "b": 0.1}, data_error=SIGMA,
                           n_walkers=128, seed=4, walker_jitter=0.3,
                           log_prior=mv)
    w.adaptive_steps(2000, temperature=2.0, auto=None)
    w.optimize(300)
    la = w.laplace_approx()          # mv recovered from the fitted term
    assert la.log_z == pytest.approx(log_z_ref, abs=2e-3)   # conjugate: exact
    ns = w.nested_sample(n_live=400, stop_frac=1e-5, seed=2)
    assert ns.log_z == pytest.approx(log_z_ref,
                                     abs=max(0.3, 4 * ns.log_z_err))


def test_experiment_chaining_from_laplace(conjugate):
    """Fit 1's Laplace posterior becomes fit 2's prior, correlations kept."""
    x, y, _, _ = conjugate
    flat = mfit.make_bounds_prior({"m": (-5, 5), "b": (-5, 5)})
    w1 = mfit.walker_create(function=_line, data=(x, y),
                            params={"m": 0.5, "b": 0.1}, data_error=SIGMA,
                            n_walkers=128, seed=0, walker_jitter=0.3,
                            log_prior=flat)
    w1.adaptive_steps(2000, temperature=2.0, auto=None)
    w1.optimize(300)
    la1 = w1.laplace_approx()
    chained = MVGaussian.from_laplace(la1, inflate=1.0)

    # second, independent dataset from the SAME truth
    rng = np.random.default_rng(99)
    y2 = 1.3 + SIGMA * rng.standard_normal(len(x))
    w2 = mfit.walker_create(function=_line, data=(x, y2),
                            params={"m": 0.5, "b": 0.1}, data_error=SIGMA,
                            n_walkers=128, seed=1, walker_jitter=0.3,
                            log_prior=chained)
    w2.adaptive_steps(2000, temperature=2.0, auto=None)
    w2.optimize(300)
    la2 = w2.laplace_approx()
    # chaining two equal-information experiments halves the covariance
    assert np.all(np.diag(la2.cov) < 0.6 * np.diag(la1.cov))
    assert np.isfinite(la2.log_z)

    # from_laplace refuses degenerate curvature
    import dataclasses as dc

    degenerate = dc.replace(la1, n_clamped=1)
    with pytest.raises(ValueError):
        MVGaussian.from_laplace(degenerate)


def test_batched_named_prior_smc_per_dataset_evidence():
    """Grouped fits through the u-space view: per-dataset true evidences."""
    rng = np.random.default_rng(0)
    x = np.linspace(0, 1, 24)
    SIG = 0.3
    ys = [1.0 + 0.5 * x + SIG * rng.standard_normal(24),
          -0.5 + 2.0 * x + SIG * rng.standard_normal(24)]
    spec = PriorSpec({"m": Gaussian(0.0, 2.0), "b": Gaussian(0.0, 2.0)})
    fit = mfit.BatchedFit(_line, [(x, y) for y in ys], {"m": 0.2, "b": 0.2},
                          data_error=SIG, log_prior=spec,
                          walkers_per_dataset=256, seed=0)
    res = fit.smc_sample(prior=spec, n_move=150)
    assert res.log_z_per_group is not None and len(res.log_z_per_group) == 2

    for s, y in enumerate(ys):
        mg = np.linspace(-8, 8, 561)
        bg = np.linspace(-8, 8, 561)
        M, B = np.meshgrid(mg, bg, indexing="ij")
        ll = np.zeros_like(M)
        for xi, yi in zip(x, y):
            ll += (-0.5 * ((yi - (M + B * xi)) / SIG) ** 2
                   - 0.5 * np.log(2 * np.pi * SIG ** 2))
        lp = ll + (-0.5 * (M / 2) ** 2 - np.log(2 * np.sqrt(2 * np.pi))) \
                + (-0.5 * (B / 2) ** 2 - np.log(2 * np.sqrt(2 * np.pi)))
        pk = lp.max()
        zr = pk + np.log(np.trapezoid(
            np.trapezoid(np.exp(lp - pk), bg, axis=1), mg))
        assert res.log_z_per_group[s] == pytest.approx(zr, abs=0.5)

    # push-back contract: each block's ensemble ~ ITS posterior in theta
    pos = np.asarray(fit.state.position).reshape(2, 256, 2)
    A = np.stack([np.ones_like(x), x], axis=1)
    prior_prec = np.diag([0.25, 0.25])
    for s, y in enumerate(ys):
        post_mean = np.linalg.solve(prior_prec + A.T @ A / SIG ** 2,
                                    A.T @ y / SIG ** 2)
        assert np.allclose(pos[s].mean(axis=0), post_mean, atol=0.25), s


def test_truncated_wide_lognormal_wall_no_overflow():
    """Regression: LogNormal(sigma>0.7, low>0) walls used math.exp(mu+1e3*sigma)
    -> OverflowError; bound_penalty takes the infinite edge directly."""
    d = LogNormal(0.0, 1.0, low=0.1)
    w_in = float(d.wall(jnp.asarray(1.0)))
    w_out = float(d.wall(jnp.asarray(0.01)))
    assert w_in == 0.0 and w_out < 0.0
    g = Gaussian(0.0, 1.0, low=-1.0)          # half-open truncation
    assert float(g.wall(jnp.asarray(0.0))) == 0.0
    assert float(g.wall(jnp.asarray(-2.0))) < 0.0
    p = PriorSpec({"a": d}).as_log_prior()
    assert np.isfinite(float(p({"a": jnp.asarray(0.5)})))


def test_checkpoint_roundtrip_mv_gaussian(tmp_path, conjugate):
    from lisp_mcmc_tpu.checkpoint import walker_load, walker_save

    x, y, _, _ = conjugate
    mv = MVGaussian({"m": 0.0, "b": 0.0},
                    np.array([[4.0, 1.5], [1.5, 2.25]]))
    w = mfit.walker_create(function=_line, data=(x, y),
                           params={"m": 0.5, "b": 0.1}, data_error=SIGMA,
                           n_walkers=16, seed=8, walker_jitter=0.2,
                           log_prior=mv)
    w.adaptive_steps(400, temperature=2.0, auto=None)
    path = str(tmp_path / "mv_fit.npz")
    walker_save(w, path)
    w2 = walker_load(path, function=_line)
    assert getattr(w2.terms[0].prior, "_prior_spec", None) == mv
    lp1 = np.asarray(w._eval_batch(w.state.position))
    lp2 = np.asarray(w2._eval_batch(w.state.position))
    assert np.allclose(lp1, lp2, rtol=1e-12)


def test_observability_hooks_smc_and_nested(conjugate):
    """on_stage / on_round fire with the documented payloads."""
    x, y, spec, _ = conjugate
    w = _make_fit(x, y, spec, seed=12, n_walkers=64)
    stages = []
    w.smc_sample(prior=spec, n_move=100,
                 on_stage=lambda info: stages.append(info) and False)
    assert stages and stages[-1]["beta"] == pytest.approx(1.0)
    assert {"stage", "dbeta", "acceptance", "moved", "chunks",
            "log_z_partial"} <= set(stages[0])

    rounds = []
    w.nested_sample(prior=spec, n_live=200, stop_frac=1e-3, seed=1,
                    on_round=lambda info: rounds.append(info) and False)
    assert rounds and rounds[0]["round"] == 1
    # early close: a truncated run still returns a finite estimate
    ns = w.nested_sample(prior=spec, n_live=200, seed=1,
                         on_round=lambda info: info["round"] >= 5)
    assert ns.n_iter == 5 and np.isfinite(ns.log_z)

    with pytest.raises(RuntimeError, match="on_stage requested stop"):
        w.smc_sample(prior=spec, n_move=100, on_stage=lambda info: True)


# ------------------------------------------------- review-fix regressions
def test_lognormal_f32_smooth_pdf_finite_at_nonpositive():
    """The x<=0 log clamp must survive float32 (the production
    dtype): a literal 1e-300 underflows to 0.0 there, turning the
    'NaN-free' clamp into log(0) = NaN for every proposal at x <= 0."""
    ln = LogNormal(0.0, 1.0)
    x32 = jnp.asarray([-0.5, 0.0, 1.0], jnp.float32)
    smooth = np.asarray(ln.installed_log_pdf(x32))
    assert np.all(np.isfinite(smooth))
    assert smooth[0] < -1e3 and smooth[1] < -1e3  # collapsed, not NaN
    assert smooth[2] == pytest.approx(
        float(ln.installed_log_pdf(1.0)), rel=1e-5)
    # The hard-support pdf is -inf (not NaN) outside x > 0.
    lp = np.asarray(ln.log_pdf(x32))
    assert lp[0] == -np.inf and lp[1] == -np.inf and np.isfinite(lp[2])


def test_uniform_rejects_infinite_bounds():
    """An infinite box is unnormalizable AND produced is_uniform=True
    with bounds=None, which the box-path dispatch dereferenced."""
    with pytest.raises(ValueError, match="finite"):
        Uniform(0.0, np.inf)
    with pytest.raises(ValueError, match="finite"):
        Uniform(-np.inf, 0.0)
    with pytest.raises(ValueError, match="finite"):
        as_prior_spec({"a": (0.0, np.inf)})


def test_mvgaussian_mapping_contains_uses_keyerror():
    """`k not in spec` must work: Mapping.__contains__ swallows KeyError
    only — list.index's ValueError leaked and crashed the
    missing-parameter checks in unit_cube_view/nested/prior_predictive."""
    from lisp_mcmc_tpu.priors import MVGaussian

    spec = MVGaussian({"a": 0.0, "b": 1.0}, np.eye(2))
    assert "a" in spec
    assert "c" not in spec
    with pytest.raises(KeyError):
        spec["c"]
    missing = [k for k in ("a", "b", "c") if k not in spec]
    assert missing == ["c"]
