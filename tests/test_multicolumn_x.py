"""Multi-column independent variables (reference x tuples,
mcmc-fitting.lisp:1136-1137): datasets of (x1, x2, ..., y) columns feed
models as a (P, C) x array."""

import numpy as np
import pytest

import lisp_mcmc_tpu as mfit
from lisp_mcmc_tpu.data import clean_data
from lisp_mcmc_tpu.ops.chunk_pallas import fused_terms_posterior


def plane(x, p):
    """y = a*x1 + b*x2 + c with x of shape (P, 2)."""
    return p["a"] * x[..., 0] + p["b"] * x[..., 1] + p["c"]


def test_clean_data_stacks_extra_columns():
    x1 = np.arange(5.0)
    x2 = np.arange(5.0) ** 2
    y = np.ones(5)
    cleaned = clean_data([(x1, x2, y)], 1)
    x, yy = cleaned[0]
    assert x.shape == (5, 2)
    np.testing.assert_allclose(x[:, 1], x2)
    np.testing.assert_allclose(yy, y)


def test_fit_recovers_plane_coefficients(rng):
    n = 120
    x1 = rng.uniform(-2, 2, n)
    x2 = rng.uniform(-2, 2, n)
    y = 1.5 * x1 - 0.7 * x2 + 0.3 + 0.02 * rng.standard_normal(n)
    w = mfit.walker_create(
        function=plane,
        data=(x1, x2, y),              # 3 columns -> (P, 2) x
        params={"a": 1.0, "b": -1.0, "c": 0.1},
        data_error=0.02,
        n_walkers=64, seed=0, walker_jitter=0.2,
    )
    assert w.terms[0].dataset.x.shape[1] == 2
    w.adaptive_steps(8000, auto=None)
    best = w.most_likely_params()
    assert best["a"] == pytest.approx(1.5, abs=0.05)
    assert best["b"] == pytest.approx(-0.7, abs=0.05)
    assert best["c"] == pytest.approx(0.3, abs=0.05)
    # the chunk kernel's term algebra correctly declines multi-column x
    assert fused_terms_posterior(w.terms, w.spec, w.dtype) is None


def test_refit_cv_multicolumn_anchor(rng):
    """Refit-CV on multi-column x (VERDICT r4 #5): the masked leave-out
    posterior equals a fresh fit on SLICED data to 1e-9 — holdouts are
    masks over points, so x's column count never enters."""
    from lisp_mcmc_tpu.diagnostics import _global_batched_refit, loo, reloo

    n = 40
    x1 = rng.uniform(-2, 2, n)
    x2 = rng.uniform(-2, 2, n)
    y = 1.5 * x1 - 0.7 * x2 + 0.3 + 0.05 * rng.standard_normal(n)
    w = mfit.walker_create(function=plane, data=(x1, x2, y),
                           params={"a": 1.0, "b": -1.0, "c": 0.1},
                           data_error=0.05, n_walkers=32, seed=0,
                           walker_jitter=0.1)
    w.adaptive_steps(500, auto=None)
    held = 7
    fit, score_block = _global_batched_refit(
        w, "test", [np.arange(n) != held], n_steps=150, temperature=2.0,
        walkers_per_dataset=8, burn_fraction=0.3, max_samples=16, seed=0)
    probe = {"a": 1.2, "b": -0.5, "c": 0.2}
    theta = fit.spec.flatten(probe, dtype=fit.dtype)
    keep = np.arange(n) != held
    ref = mfit.walker_create(function=plane,
                             data=(x1[keep], x2[keep], y[keep]),
                             params={"a": 1.0, "b": -1.0, "c": 0.1},
                             data_error=0.05, n_walkers=2, seed=0)
    lp_ref = ref.diagnose_params(probe)
    lp_blk = float(fit._custom_log_post(theta, 0, fit._posterior_data()))
    assert lp_blk == pytest.approx(lp_ref, abs=1e-9)
    # scoring axis: (draws, n) over the ORIGINAL points
    assert score_block(0).shape[1] == n
    # end to end: reloo on the worst-k point runs (no refusal) and
    # returns a finite elpd over the same axis
    w.burn_steps(len(w) // 2)
    base = loo(w, max_samples=64)
    thresh = min(0.7, float(base.pareto_k.max()) - 1e-6)
    r = reloo(w, base, k_threshold=thresh, n_steps=800, max_refits=n,
              walkers_per_dataset=16, max_samples=64)
    assert np.isfinite(r.elpd)
    assert r.n_points == n
