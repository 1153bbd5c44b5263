"""Kernel-family head-to-head (DESIGN.md "Kernel family, measured").

Protocol (identical for every kernel, so rows are comparable):
  1. converge a shared rwm state (anneal at T=10, then settle at T=1);
  2. switch kernel; 30 chunks (6000 steps) of kernel-specific cold
     adaptation, no history;
  3. 2000 measured steps with thinned history (thin=10), timed;
  4. report acceptance, chain-steps/sec, min-ESS over the measured
     window (frozen-chain-honest estimator), ESS/sec.

Scenarios:
  flagship  — the reference fit (lorder_mixed_bg on example-data.xls),
              W=65536: cheap 6-param posterior with a near-degenerate
              ridge; rwm's home turf.
  d48       — correlated 48-d Gaussian (condition ~1.7e3), W=8192: the
              high-dimension regime the gradient kernels were built for.

Run: python benchmarks/kernel_family.py [flagship|d48] [kernel ...]
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def make_flagship(n_walkers=65536):
    from lisp_mcmc_tpu.flagship import flagship_walker

    w = flagship_walker(n_walkers)
    w.adaptive_steps(30000, temperature=10.0, auto=None)
    return w


def make_d48(n_walkers=8192, d=48, seed=3):
    import jax.numpy as jnp

    import lisp_mcmc_tpu as mfit

    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((d, d)))
    scales = np.geomspace(1.0, 1.7e3, d) ** 0.5
    cov = (q * scales**2) @ q.T
    prec = jnp.asarray(np.linalg.inv(cov))

    def model(x, p):
        return jnp.zeros_like(x)

    keys = [f"p{i}" for i in range(d)]

    def loglik(fn, params, dataset):
        v = jnp.stack([params[k] for k in keys])
        return -0.5 * v @ prec @ v

    w = mfit.walker_create(
        function=model, data=([0.0, 1.0], [0.0, 0.0]),
        params={k: 0.1 for k in keys}, log_likelihood=loglik,
        n_walkers=n_walkers, seed=0, walker_jitter=1.0)
    w.adaptive_steps(10000, temperature=2.0, auto=None)
    return w


def run_kernel(w, kernel, measure_chunks=10, adapt_chunks=30):
    """One kernel's table row, measured DEVICE-side.

    Everything timed stays on the chip: history chunks accumulate as
    device arrays and ESS reduces there (ess_from_history transfers d
    scalars).  A host-side history path would measure host transfers,
    not the kernel.
    """
    import dataclasses

    import jax
    import jax.numpy as jnp

    from lisp_mcmc_tpu.diagnostics import ess_from_history

    snap = jax.tree_util.tree_map(lambda a: a, w.state)  # restore point
    prev_cfg = w.config
    chunk = w.config.chunk_size
    try:
        w.config = dataclasses.replace(w.config, kernel=kernel, n_steps=0)
        run = w._runner(with_history=False)
        hist_runner = w._runner(with_history=True)
        data = w._posterior_data()
        # Kernel-specific cold adaptation (force_cold pins T=1).
        for _ in range(adapt_chunks):
            w.state, _ = run(w.state, True, True, True, data)
        w.state, _ = hist_runner(w.state, True, True, True, data)  # warm compile
        jax.block_until_ready(w.state.position)

        t0 = time.perf_counter()
        device_hist, accs = [], []
        for _ in range(measure_chunks):
            w.state, out = hist_runner(w.state, True, True, True, data)
            device_hist.append(out["positions"])       # stays on device
            accs.append(out["accept_rate"])            # device scalar
        positions = jnp.concatenate(device_hist, axis=0)
        jax.block_until_ready(positions)
        dt = time.perf_counter() - t0

        ess = ess_from_history(positions, w.spec.keys)
        min_ess = min(ess.values())
        steps = measure_chunks * chunk
        acc = float(jnp.mean(jnp.stack(accs)))
        return {"kernel": kernel, "acceptance": acc,
                "steps_per_sec": steps * w.n_walkers / dt,
                "min_ess": min_ess, "ess_per_sec": min_ess / dt,
                "seconds": dt}
    finally:
        w.config = prev_cfg
        w.state = snap                     # restores age with it


def main():
    args = sys.argv[1:]
    scenario = args[0] if args else "flagship"
    kernels = args[1:] or ["rwm", "stretch", "demc", "slice", "mala", "hmc",
                           "chees"]
    w = make_flagship() if scenario == "flagship" else make_d48()
    print(f"# scenario={scenario} W={w.n_walkers} d={w.ndim}")
    for k in kernels:
        r = run_kernel(w, k)
        print(f"{r['kernel']:>8s}  acc={r['acceptance']:.3f}  "
              f"steps/s={r['steps_per_sec']/1e6:.1f}M  "
              f"minESS={r['min_ess']/1e3:.0f}k  "
              f"ESS/s={r['ess_per_sec']/1e3:.0f}k  ({r['seconds']:.1f}s)")


if __name__ == "__main__":
    main()
