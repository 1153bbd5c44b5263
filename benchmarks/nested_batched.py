"""Measure nested_per_dataset's batching advantage on real hardware.

The claim under test (nested.py docstring): S nested-sampling runs as
one vmapped program cost ~the slowest run's wall time, not the sum of
S runs — because every round's delete/refill for ALL datasets is one
device program and one host round-trip (sequential runs pay S times the
per-round host sync AND S times the compute dispatch).

Protocol: S spectra from the two-peak scan generator (d=6), identical
budgets (n_live, k_batch, n_repeat, stop_frac), wall-clock of
  (a) fit.nested_per_dataset(...)            -- one vmapped program
  (b) sum of nested_sample(w_s, ...) loops   -- the reference's
      walker-list pattern (nv-specific.lisp:58-66), one fit at a time
plus element-wise log_z agreement (same algorithm, independent RNG).

Run: python benchmarks/nested_batched.py [S]   (default 8; on the GPU.
JAX_PLATFORMS=cpu works for a functional check.)
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

if os.environ.get("JAX_PLATFORMS", "") == "cpu":
    import jax

    jax.config.update("jax_platforms", "cpu")

import numpy as np

import lisp_mcmc_tpu as mfit
from lisp_mcmc_tpu.models import double_lorentzian_bg
from lisp_mcmc_tpu.nested import nested_per_dataset, nested_sample

BOUNDS = {"scale1": (0.0, 1e-3), "scale2": (0.0, 1e-3),
          "mu1": (2800.0, 2940.0), "mu2": (2800.0, 2940.0),
          "sigma": (1.0, 40.0), "bg0": (0.0, 1e-3)}
GUESS = {"scale1": 8e-5, "scale2": 8e-5, "mu1": 2860.0, "mu2": 2880.0,
         "sigma": 9.0, "bg0": 1e-4}


# Noise picked for HEALTHY constrained refills: at 2e-6 (the scan
# example's SNR) the overlapping-peak geometry compresses ~38 nats and
# the insertion-rank diagnostic flags directional refill bias
# (ins_p ~ 1e-4), with realized seed scatter of 1-3 nats against the
# quoted 0.4 — measured on ds3, 6 seeds, both paths.  At 2e-5 the
# diagnostic reads healthy (0.03-0.4) and seed scatter drops to ~0.9,
# so the agreement column below actually means something.
NOISE = 2e-5


def make_scan(S, seed=0):
    rng = np.random.default_rng(seed)
    x = np.linspace(2800.0, 2940.0, 192)
    out = []
    for i in range(S):
        split = 8.0 + 16.0 * i / max(S - 1, 1)
        truth = {"scale1": 9e-5, "scale2": 8e-5,
                 "mu1": 2870.0 - split / 2, "mu2": 2870.0 + split / 2,
                 "sigma": 8.0, "bg0": 1e-4}
        y = np.asarray(double_lorentzian_bg(x, truth))
        out.append((x, y + NOISE * rng.standard_normal(x.shape)))
    return out


def main():
    S = int(sys.argv[1]) if len(sys.argv) > 1 else 8
    kw = dict(n_live=256, seed=0, stop_frac=1e-3)
    spectra = make_scan(S)

    fit = mfit.BatchedFit(double_lorentzian_bg, spectra, GUESS,
                          data_error=NOISE,
                          log_prior=mfit.make_bounds_prior(BOUNDS),
                          walkers_per_dataset=64, seed=0)
    # Warm the compile caches out of the measurement (one tiny-budget
    # batched round + one single round).
    nested_per_dataset(fit, max_iter=1, **kw)
    singles = [
        mfit.walker_create(
            function=double_lorentzian_bg, data=spectra[s], params=GUESS,
            data_error=NOISE, log_prior=mfit.make_bounds_prior(BOUNDS),
            n_walkers=16, seed=0, walker_jitter=0.05)
        for s in range(S)]
    nested_sample(singles[0], max_iter=1, **kw)

    t0 = time.perf_counter()
    batched = nested_per_dataset(fit, **kw)
    t_batched = time.perf_counter() - t0

    t0 = time.perf_counter()
    seq = [nested_sample(w, **kw) for w in singles]
    t_seq = time.perf_counter() - t0

    print(f"S={S} d=6 n_live={kw['n_live']}")
    print(f"batched (one vmapped program): {t_batched:7.2f} s "
          f"rounds={max(r.n_iter for r in batched)}")
    print(f"sequential (S single runs):    {t_seq:7.2f} s "
          f"rounds_total={sum(r.n_iter for r in seq)}")
    print(f"speedup: {t_seq / t_batched:.2f}x")
    for s in range(S):
        dz = batched[s].log_z - seq[s].log_z
        err = float(np.hypot(batched[s].log_z_err, seq[s].log_z_err))
        # Realized NS scatter runs ~2-3x the information-theoretic quote
        # even when refills are healthy (measured above) — gate on the
        # scatter-aware margin, and let a low insertion_p explain any
        # outlier (it means "this log_z is suspect", by construction).
        flag = "" if abs(dz) < max(6 * err, 2.5) else "  <-- DISAGREES"
        print(f"  ds{s}: batched {batched[s].log_z:9.2f}+-"
              f"{batched[s].log_z_err:4.2f} (ins_p {batched[s].insertion_p:7.2g})"
              f"  single {seq[s].log_z:9.2f}+-{seq[s].log_z_err:4.2f}"
              f" (ins_p {seq[s].insertion_p:7.2g})  d={dz:+.2f}{flag}")


if __name__ == "__main__":
    main()
