"""Measure HierarchicalFit throughput vs grid size on real hardware.

What scaling to expect (hierarchical.py design): each walker carries the
WHOLE grid, so the per-step work is W * S model evaluations — S times a
BatchedFit walker's — while d grows as 2P + S*d_local.  The DENSE
proposal adds O(W d^2) matmul + (rwm) O(W d^2) moment accumulation per
step, which starts to dominate around d ~ 100; the BLOCK proposal
(config.block_*, round 4) replaces both with O(W (4P^2 + S dl^2)) —
linear in S, like the likelihood — so blocked throughput should track
~1/S all the way up the grid.

Protocol: double-Lorentzian scan pixels (d_local=6, N=160), pooled
(sigma, bg0) => d = 4 + 6S.  For S in {2, 4, 8, 16, 32, 64}: wall-time
2000 steps at W=256 for BOTH proposals (rwm isolates the
posterior+proposal cost from chees' gradient budget), report steps/sec
and the dense:block ratio.  A quality gate runs at S=16: both
proposals' populations after an identical budget must land on the same
hyper posterior (medians within tolerance) — speed that loses the
posterior doesn't count.

Run: python benchmarks/hierarchical_scaling.py   (on the GPU;
JAX_PLATFORMS=cpu works for a functional check).  LISP_MCMC_BLOCK_APPLY=0
or 1 forces the dense or the per-block apply of the block proposal.
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

import lisp_mcmc_tpu as mfit
from lisp_mcmc_tpu.models import double_lorentzian_bg
from lisp_mcmc_tpu.priors import Gaussian, LogNormal

W = int(os.environ.get("HS_WALKERS", 256))
STEPS = int(os.environ.get("HS_STEPS", 2000))
N = 160
SIZES = tuple(int(s) for s in
              os.environ.get("HS_SIZES", "2,4,8,16,32,64").split(","))


def make_scan(S, seed=0):
    rng = np.random.default_rng(seed)
    x = np.linspace(2800.0, 2940.0, N)
    out = []
    for i in range(S):
        split = 10.0 + 10.0 * i / max(S - 1, 1)
        truth = {"scale1": 9e-5, "scale2": 8.5e-5,
                 "mu1": 2870.0 - split / 2, "mu2": 2870.0 + split / 2,
                 "sigma": 8.0, "bg0": 1e-4}
        y = np.asarray(double_lorentzian_bg(x, truth))
        out.append((x, y + 4e-6 * rng.standard_normal(x.shape)))
    return out


def make_fit(S, proposal):
    guess = {"scale1": 8e-5, "scale2": 8e-5, "mu1": 2862.0, "mu2": 2878.0,
             "sigma": 9.0, "bg0": 1e-4}
    return mfit.HierarchicalFit(
        double_lorentzian_bg, make_scan(S), guess, data_error=4e-6,
        pooled=["sigma", "bg0"],
        hyper={"sigma": (Gaussian(9.0, 4.0, low=0.5),
                         LogNormal(np.log(0.8), 0.7)),
               "bg0": (Gaussian(1e-4, 5e-5), LogNormal(np.log(3e-6), 1.0))},
        local_priors={"scale1": (0.0, 1e-3), "scale2": (0.0, 1e-3),
                      "mu1": (2800.0, 2870.0), "mu2": (2870.0, 2940.0)},
        n_walkers=W, seed=0, proposal=proposal)


def timed_steps(fit):
    """Warm no-history chunk stepping (the bench.py protocol).

    The proposal's cost shows in the device-side chunk rate; history
    transfers would add host time that has nothing to do with it.
    """
    import jax

    from lisp_mcmc_tpu.kernel import build_chunk_runner

    run, _ = build_chunk_runner(fit._log_post_one, fit.ndim, fit.config,
                                takes_data=True)
    step = jax.jit(run)
    data = fit._posterior_data()
    state = fit.state
    import jax.numpy as jnp

    state, _ = step(state, True, True, False, data)   # compile + settle
    float(jnp.sum(state.logprob))      # host fetch = the reliable barrier
    n_chunks = max(1, STEPS // fit.config.chunk_size)
    t0 = time.perf_counter()
    for _ in range(n_chunks):
        state, _ = step(state, True, True, False, data)
    float(jnp.sum(state.logprob))      # host fetch drains the pipeline
    dt = time.perf_counter() - t0
    return dt * STEPS / (n_chunks * fit.config.chunk_size)


def quality_gate(S=16, budget=6000):
    """Same budget, both proposals: hyper medians must agree."""
    print(f"quality gate (S={S}, {budget} anneal + {budget} chees steps):")
    meds = {}
    for prop in ("dense", "block"):
        fit = make_fit(S, prop)
        fit.adaptive_steps(budget, auto=None)
        fit.reset()
        fit.sampling_steps(budget, kernel="chees")
        fit.burn_steps(len(fit) // 2)
        hp = fit.hyper_params("median")
        meds[prop] = hp
        print(f"  {prop:5s}: sigma mu={hp['mu']['sigma']:.3f} "
              f"tau={hp['tau']['sigma']:.3f}  bg0 mu={hp['mu']['bg0']:.3g}")
    dm = abs(meds["dense"]["mu"]["sigma"] - meds["block"]["mu"]["sigma"])
    print(f"  |d sigma_mu| = {dm:.4f} ({'OK' if dm < 0.5 else 'DIVERGED'})")


def main():
    mfit.enable_compilation_cache()
    print(f"W={W} steps={STEPS} N={N} (rwm)  sizes={SIZES}")
    print("   S    d   dense(s)  block(s)  dense-steps/s  block-steps/s  speedup")
    for S in SIZES:
        row = {}
        for prop in ("dense", "block"):
            fit = make_fit(S, prop)
            row[prop] = timed_steps(fit)
            del fit
        d = 4 + 6 * S
        sd, sb = STEPS * W / row["dense"], STEPS * W / row["block"]
        print(f"  {S:3d}  {d:3d}  {row['dense']:8.2f}  {row['block']:8.2f}"
              f"  {sd:12.3g}  {sb:12.3g}  {sd and sb / sd:6.2f}x",
              flush=True)
    if os.environ.get("HS_GATE", "1") != "0":
        quality_gate()


if __name__ == "__main__":
    main()
