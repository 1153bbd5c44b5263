"""The chunk kernel's term algebra vs the XLA vmap ground truth.

The XLA likelihood reductions in lisp_mcmc_tpu/likelihoods.py are the
reference implementation; the kernel's term algebra (priors evaluated
with ``dataset=None``, walker-independent constants hoisted), written in
plain ``jnp`` as ``fused_terms_posterior``, must agree point-for-point
for every fusable likelihood kind and decline (return None) outside its
coverage.  The kernel itself is tested in tests/test_chunk_pallas.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import lisp_mcmc_tpu as mfit
from lisp_mcmc_tpu.likelihoods import (
    log_likelihood_normal_cutoff,
    log_likelihood_poisson,
)
from lisp_mcmc_tpu.models import gaussian_peak, line
from lisp_mcmc_tpu.ops.chunk_pallas import fused_terms_posterior, pick_block
from lisp_mcmc_tpu.priors import make_bounds_prior


def test_pick_block():
    assert pick_block(131072) == 128
    assert pick_block(131072, 256) == 256
    assert pick_block(96) == 32
    assert pick_block(384, 200) == 128
    assert pick_block(100) is None


def _normal(rng):
    x = np.linspace(0.0, 10.0, 50)
    y = 2.0 * x + 1.0 + 0.1 * rng.standard_normal(50)
    return dict(function=line, data=(x, y), params={"m": 2.0, "b": 1.0},
                data_error=0.1, n_walkers=256, seed=1, walker_jitter=0.1), 0.02


def _bounds_multi(rng):
    x = np.linspace(-5.0, 5.0, 40)
    y1 = np.exp(-0.5 * x**2) + 0.01 * rng.standard_normal(40)
    y2 = 3.0 * x - 0.5 + 0.05 * rng.standard_normal(40)
    prior = make_bounds_prior({"scale": (0.1, 10.0), "sigma": (0.1, 5.0)})
    return dict(
        function=[gaussian_peak, line], data=[(x, y1), (x, y2)],
        params={"scale": 1.0, "x0": 0.0, "sigma": 1.0, "m": 3.0, "b": -0.5},
        data_error=[0.01, 0.05], log_prior=[prior, None],
        n_walkers=128, seed=2, walker_jitter=0.3,
    ), 0.5  # pushes some walkers out of bounds


def _cutoff(rng):
    x = np.linspace(0.0, 4.0, 30)
    y = np.exp(-0.5 * (x - 2.0) ** 2) + 0.02 * rng.standard_normal(30)
    return dict(
        function=gaussian_peak, data=(x, y),
        params={"scale": 1.0, "x0": 2.0, "sigma": 1.0},
        data_error=1e-4,  # tiny error so the -5000 clamp actually bites
        log_likelihood=log_likelihood_normal_cutoff,
        n_walkers=128, seed=3, walker_jitter=0.4,
    ), 0.5


def _poisson(rng):
    x = np.linspace(0.0, 4.0, 30)
    counts = rng.poisson(lam=5.0 + 2.0 * x).astype(float)
    return dict(
        function=line, data=(x, counts), params={"m": 2.0, "b": 5.0},
        log_likelihood=log_likelihood_poisson,
        n_walkers=128, seed=4, walker_jitter=0.05,
    ), 0.05


def _custom(rng):
    x = np.linspace(0.0, 1.0, 16)

    def custom(fn, params, dataset):
        mu = fn(dataset.x, params)
        return -jnp.sum(jnp.abs(dataset.y - mu) * dataset.mask)

    return dict(function=line, data=(x, x.copy()), params={"m": 1.0, "b": 0.0},
                log_likelihood=custom, n_walkers=128, seed=5), None


@pytest.mark.parametrize("case", [_normal, _bounds_multi, _cutoff, _poisson,
                                  _custom],
                         ids=["normal", "bounds_prior_multi_dataset",
                              "cutoff", "poisson", "declines_custom"])
def test_fused_terms_match_xla(rng, case):
    kwargs, spread = case(rng)
    w = mfit.walker_create(**kwargs)
    fused = fused_terms_posterior(w.terms, w.spec, w.dtype)
    if spread is None:
        assert fused is None
        return
    assert fused is not None
    base = np.asarray(w.state.position)
    pos = jnp.asarray(base * (1.0 + spread * rng.standard_normal(base.shape)))
    lp_ref = jax.vmap(w._log_post_one, in_axes=(0, None))(pos, w._posterior_data())
    np.testing.assert_allclose(np.asarray(fused(pos)), np.asarray(lp_ref),
                               rtol=1e-9)
