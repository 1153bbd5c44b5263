"""BatchedFit scaling: S datasets for the price of ~one.

The reference's only many-fits notion is a sequential Lisp list
(dir->nv-walkers, nv-specific.lisp:58-66): S datasets cost S fits of
wall time.  BatchedFit stacks them into one ensemble with per-dataset
adaptation groups, so on an accelerator its idle lanes absorb the batch:
wall time should stay near-flat in S until the chip saturates, i.e.
throughput (dataset-fits/sec) grows ~linearly.

Run: python benchmarks/batched_scaling.py [steps] — prints one row per
S with wall time, speedup vs S sequential fits, and per-fit quality
(all fits must converge; a fast wrong batch is no batch).
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    import jax

    import lisp_mcmc_tpu as mfit
    from lisp_mcmc_tpu.models import double_lorentzian_bg

    steps = int(sys.argv[1]) if len(sys.argv) > 1 else 10000
    B = 256                                   # walkers per dataset
    rng = np.random.default_rng(0)
    x = np.linspace(2800.0, 2940.0, 256)

    bounds = {"scale1": (0.0, 1e-3), "scale2": (0.0, 1e-3),
              "mu1": (2800.0, 2940.0), "mu2": (2800.0, 2940.0),
              "sigma": (1.0, 40.0), "bg0": (0.0, 1e-3)}

    def make_datasets(s):
        out, truths, guesses = [], [], []
        for i in range(s):
            truth = {"scale1": rng.uniform(5e-5, 1.2e-4),
                     "scale2": rng.uniform(5e-5, 1.2e-4),
                     "mu1": rng.uniform(2840.0, 2865.0),
                     "mu2": rng.uniform(2870.0, 2900.0),
                     "sigma": rng.uniform(6.0, 12.0), "bg0": 1e-4}
            y = np.asarray(double_lorentzian_bg(x, truth))
            out.append((x, y + 2e-6 * rng.standard_normal(x.shape)))
            truths.append(truth)
            # Per-dataset rough guess (what nv.guess-style heuristics
            # supply in the real pipeline): truth blurred hard.
            guesses.append({k: float(v) * rng.uniform(0.7, 1.3)
                            if "mu" not in k else
                            float(v) + rng.uniform(-8.0, 8.0)
                            for k, v in truth.items()})
        return out, truths, guesses

    t_seq = None
    print(f"# B={B} walkers/dataset, {steps} steps, "
          f"backend={jax.default_backend()}")
    for s in (1, 4, 16, 64, 256):
        datasets, truths, guesses = make_datasets(s)
        fit = mfit.BatchedFit(double_lorentzian_bg, datasets, guesses,
                              data_error=2e-6, walkers_per_dataset=B,
                              log_prior=mfit.make_bounds_prior(bounds),
                              seed=0, walker_jitter=0.05)
        # Warm the compile out of the timed window (shapes differ per
        # S): run one throwaway chunk, then reset the anneal clock by
        # rebuilding the fit state from scratch below via a fresh fit.
        warm = mfit.BatchedFit(double_lorentzian_bg, datasets, guesses,
                               data_error=2e-6, walkers_per_dataset=B,
                               log_prior=mfit.make_bounds_prior(bounds),
                               seed=0, walker_jitter=0.05)
        warm.adaptive_steps(fit.config.chunk_size, temperature=10.0,
                            auto=None, collect_history=False)
        t0 = time.perf_counter()
        fit.adaptive_steps(steps, temperature=10.0, auto=None,
                           collect_history=False)
        jax.block_until_ready(fit.state.position)
        dt = time.perf_counter() - t0
        if s == 1:
            t_seq = dt
        # Quality gate, label-invariant (mu1/mu2 are exchangeable).
        best = fit.best_params_per_dataset()
        mu_err = max(
            max(abs(bb - tt) for bb, tt in zip(
                sorted((b["mu1"], b["mu2"])),
                sorted((t["mu1"], t["mu2"]))))
            for b, t in zip(best, truths))
        ok = mu_err < 1.0
        speedup = s * t_seq / dt
        print(f"S={s:>4d}  wall={dt:6.2f}s  vs-sequential={speedup:6.1f}x  "
              f"fits/sec={s/dt:7.2f}  max-mu-err={mu_err:.3f}  "
              f"{'ok' if ok else 'FAILED QUALITY GATE'}")


if __name__ == "__main__":
    main()
