"""Run the five BASELINE.json configurations end to end.

Each config is a named fit scenario from BASELINE.json; this script runs
a scaled-down version of each and prints a JSON summary line per config.
On a GPU the walker counts scale up automatically.

Run: ``python examples/baseline_configs.py``
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from _common import phase, setup_platform  # noqa: E402

setup_platform()

import numpy as np


def report(name, walker, t0, expect=None):
    lp, best = walker.most_likely_step()
    out = {
        "config": name,
        "best_logprob": round(float(lp), 3),
        "acceptance": round(walker.acceptance(), 3),
        "seconds": round(time.perf_counter() - t0, 2),
        "chain_steps_per_sec": round(walker.age * walker.n_walkers /
                                     (time.perf_counter() - t0), 1),
    }
    if expect:
        out["params_ok"] = all(abs(best[k] - v) < tol for k, (v, tol) in expect.items())
    print(json.dumps(out))
    return out


def main():
    import jax

    import lisp_mcmc_tpu as mfit
    from lisp_mcmc_tpu import nv
    from lisp_mcmc_tpu.flagship import flagship_data
    from lisp_mcmc_tpu.models import gaussian_peak, line, lorder_mixed_bg

    mfit.enable_compilation_cache()
    W = 16384 if jax.default_backend() == "gpu" else 256
    rng = np.random.default_rng(0)

    # 1. test.lisp single-dataset fit (weighted normal + flat prior).
    t0 = time.perf_counter()
    x, y = flagship_data(0)
    w1 = mfit.walker_create(
        function=lorder_mixed_bg, data=(x, y),
        params={"scale": 1e-5, "linewidth": 7, "x0": 2200, "mix": 0.9,
                "bg0": 1e-7, "bg1": 1e-9},
        data_error=1e-7, n_walkers=W, seed=0, walker_jitter=0.05,
        log_likelihood=mfit.log_likelihood_normal_weighted,
    )
    # summary-only run: no history capture
    w1.adaptive_steps(30000, collect_history=False)
    report("1-test.lisp-single-fit", w1, t0)

    # 2. Gaussian peak fit with bounded priors + adaptive covariance.
    t0 = time.perf_counter()
    xg = np.linspace(-5, 5, 200)
    yg = 3.0 * np.exp(-0.5 * ((xg - 0.7) / 1.3) ** 2) + 0.05 * rng.standard_normal(200)
    prior = mfit.make_bounds_prior({"scale": (0.1, 10), "x0": (-3, 3), "sigma": (0.3, 5)})
    w2 = mfit.walker_create(
        function=gaussian_peak, data=(xg, yg),
        params={"scale": 1.0, "x0": 0.0, "sigma": 1.0},
        data_error=0.05, log_prior=prior, n_walkers=W, seed=1, walker_jitter=0.1,
    )
    w2.adaptive_steps(10000, collect_history=False)
    report("2-bounded-gaussian-peak", w2, t0,
           expect={"x0": (0.7, 0.1), "sigma": (1.3, 0.15)})

    # 3. Poisson counting-data fit.
    t0 = time.perf_counter()
    xp = np.linspace(0, 10, 150)
    counts = rng.poisson(4.0 + 2.5 * xp).astype(float)
    w3 = mfit.walker_create(
        function=line, data=(xp, counts), params={"m": 1.0, "b": 1.0},
        log_likelihood=mfit.log_likelihood_poisson,
        n_walkers=W, seed=2, walker_jitter=0.1,
    )
    w3.adaptive_steps(10000, collect_history=False)
    report("3-poisson-counts", w3, t0, expect={"m": (2.5, 0.4), "b": (4.0, 1.2)})

    # 4. Global multi-dataset fit with shared parameters.
    t0 = time.perf_counter()
    xa = np.linspace(0, 8, 120)
    shared_m = 1.8
    ya = shared_m * xa + 0.5 + 0.1 * rng.standard_normal(120)
    yb = shared_m * xa - 2.0 + 0.2 * rng.standard_normal(120)

    def line_a(x, p):
        return p["m"] * x + p["ba"]

    def line_b(x, p):
        return p["m"] * x + p["bb"]

    w4 = mfit.walker_create(
        function=[line_a, line_b], data=[(xa, ya), (xa, yb)],
        params={"m": 1.0, "ba": 0.0, "bb": 0.0},
        data_error=[0.1, 0.2], n_walkers=W, seed=3, walker_jitter=0.1,
    )
    w4.adaptive_steps(10000, collect_history=False)
    report("4-global-shared-params", w4, t0, expect={"m": (shared_m, 0.1)})

    # 5. NV spectra batch: many walkers, sharded when devices allow.
    t0 = time.perf_counter()
    freqs = np.linspace(2840, 2900, 256)

    def spectrum(mu1, mu2):
        from lisp_mcmc_tpu.models import double_lorentzian_bg
        clean = double_lorentzian_bg(freqs, {
            "scale1": 1e-5, "scale2": 1e-5, "mu1": mu1, "mu2": mu2,
            "sigma": 10.0, "bg0": 1e-4})
        return freqs, np.asarray(clean) + 2e-7 * rng.standard_normal(len(freqs))

    spectra = [spectrum(2858 + i, 2876 + i) for i in range(4)]
    wps = 32768 if W > 256 else 64  # 4 spectra x wps walkers >= 1e5 on a GPU
    fit = nv.BatchedNVFit(spectra, walkers_per_spectrum=wps, seed=4)
    n_dev = len(jax.devices())
    if n_dev > 1 and fit.n_walkers % n_dev == 0:
        fit.shard()
    fit.adaptive_steps(8000, collect_history=False)
    report("5-nv-batched-sharded", fit, t0)
    print(json.dumps({"config": "5-details",
                      "n_walkers": fit.n_walkers,
                      "devices": n_dev,
                      "field_offsets": [round(o, 3) for o in fit.field_offsets()]}))


if __name__ == "__main__":
    main()
