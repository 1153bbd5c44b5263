"""Headline benchmark: aggregate adaptive-MH chain-steps/sec on the
reference fit (BASELINE.md).

Reference baseline: SBCL runs the test.lisp fit — 6-param lorder-mixed-bg
on the 334-point example-data.xls — at 1e5 steps in 6.34 s, i.e. ~15.8k
chain-steps/sec on one CPU chain (test.lisp:23-24).  This benchmark runs
the same fit, on data generated from ``--seed`` in the same shape
(``lisp_mcmc_tpu.flagship``), as a vmapped walker ensemble on one GPU and
reports aggregate chain-steps/sec (walkers x steps / wall time), with the
full adaptation path (annealing, acceptance-band L updates, pooled
covariance) enabled.  A run that finds no GPU fails.

BASELINE.md's metric is the PAIR (chain-steps/sec, ESS/sec), so the JSON
line carries both: a short thinned-history phase runs at the converged
state, the autocorrelation reduction happens ON DEVICE, and only d
scalars cross the host boundary.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": "chain-steps/sec",
   "vs_baseline": N/15800, "ess_per_sec": N, ..., "card": "<name, limit>",
   "device": {"platform", "kind", "count"}}
"""

import argparse
import json
import os
import subprocess
import sys
import time

BASELINE_STEPS_PER_SEC = 1.0e5 / 6.34  # test.lisp:23-24


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--walkers", type=int, default=131072)
    parser.add_argument("--chunks", type=int, default=20)
    parser.add_argument("--warmup-chunks", type=int, default=3)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--verbose", action="store_true")
    args = parser.parse_args()

    import jax
    import jax.numpy as jnp

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench.py: needs a GPU; JAX's default device is "
                         f"{dev.platform!r}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"# device: platform={dev.platform} kind={dev.device_kind} "
          f"count={len(jax.devices())} | card: {card}", file=sys.stderr)

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import lisp_mcmc_tpu as mfit
    from lisp_mcmc_tpu.flagship import flagship_walker
    from lisp_mcmc_tpu.kernel import build_chunk_runner

    mfit.enable_compilation_cache()
    walker = flagship_walker(args.walkers, seed=args.seed, data_seed=args.seed)

    run, _ = build_chunk_runner(walker._log_post_one, walker.ndim, walker.config,
                                takes_data=True)
    data = walker._posterior_data()
    step = jax.jit(run, donate_argnums=(0,))

    # Own buffers for the donated state (the initial best position
    # aliases the position).
    state = jax.tree_util.tree_map(jnp.copy, walker.state)
    for _ in range(args.warmup_chunks):
        state, out = step(state, True, True, False, data)
    jax.block_until_ready(state.position)

    t0 = time.perf_counter()
    for _ in range(args.chunks):
        state, out = step(state, True, True, False, data)
    jax.block_until_ready(state.position)
    elapsed = time.perf_counter() - t0

    chunk = walker.config.chunk_size
    total_steps = args.chunks * chunk * args.walkers
    steps_per_sec = total_steps / elapsed

    if args.verbose:
        print(
            f"# walkers={args.walkers} "
            f"chunks={args.chunks}x{chunk} elapsed={elapsed:.3f}s "
            f"acc={float(out['accept_rate']):.3f} "
            f"best={float(jnp.max(state.best_logprob)):.2f} dtype={walker.dtype}",
            file=sys.stderr,
        )

    # ESS/sec (the second metric of BASELINE.md's pair): collect a short
    # thinned history at the converged state, reduce ON DEVICE, and
    # extrapolate — only d scalars cross the host boundary.
    from lisp_mcmc_tpu.diagnostics import ess_from_history

    walker.state = state
    hist_runner = walker._runner(with_history=True)
    walker.state, _ = hist_runner(walker.state, True, True, False, data)  # compile warmup
    jax.block_until_ready(walker.state.position)
    t1 = time.perf_counter()
    hist_chunks = 10
    device_hist = []
    for _ in range(hist_chunks):
        walker.state, h = hist_runner(walker.state, True, True, False, data)
        device_hist.append(h["positions"])          # stays on device
    positions = jnp.concatenate(device_hist, axis=0)
    jax.block_until_ready(positions)
    hist_elapsed = time.perf_counter() - t1
    ess = ess_from_history(positions, walker.spec.keys)
    min_ess = min(ess.values())
    ess_per_sec = min_ess / hist_elapsed
    if args.verbose:
        print(
            f"# min-ESS={min_ess:.0f} over {hist_chunks * chunk} steps "
            f"-> {ess_per_sec:.0f} ESS/sec",
            file=sys.stderr,
        )

    # Kernel-family ESS/sec (VERDICT r3 #6): track the gradient kernels
    # too, so a silent mala/chees regression surfaces here.  Same recipe
    # as the rwm phase: short sampling-phase (cold, T=1) chunks at the
    # converged state, history reduced on device, only d scalars to host.
    # On THIS d=6 ridge posterior chees adapts to long trajectories, so
    # its ESS/sec reads low against mala; chees is built for higher d.
    import dataclasses as _dc

    def _kernel_ess(kernel: str, n_hist_chunks: int) -> float:
        prev_cfg = walker.config
        walker.config = _dc.replace(walker.config, kernel=kernel)
        walker._runner_cache.clear()
        try:
            runner = walker._runner(with_history=True)
            walker.state, _ = runner(walker.state, True, True, True, data)
            jax.block_until_ready(walker.state.position)     # compile warmup
            tk = time.perf_counter()
            hist = []
            for _ in range(n_hist_chunks):
                walker.state, h = runner(walker.state, True, True, True, data)
                hist.append(h["positions"])                  # stays on device
            pos_k = jnp.concatenate(hist, axis=0)
            jax.block_until_ready(pos_k)
            k_elapsed = time.perf_counter() - tk
            k_ess = min(ess_from_history(pos_k, walker.spec.keys).values())
            if args.verbose:
                print(f"# {kernel}: min-ESS={k_ess:.0f} over "
                      f"{n_hist_chunks * chunk} steps in {k_elapsed:.2f}s "
                      f"-> {k_ess / k_elapsed:.0f} ESS/sec", file=sys.stderr)
            return k_ess / k_elapsed
        finally:
            walker.config = prev_cfg
            walker._runner_cache.clear()

    ess_per_sec_mala = _kernel_ess("mala", 4)
    ess_per_sec_chees = _kernel_ess("chees", 2)

    # chees where it is meant to win (PARITY.md "known headroom"): the
    # flagship d=6 ridge is structurally rwm's turf, so the correlated
    # d=24 Gaussian below is the high-dimension regime the kernel exists
    # for.  Small shapes (W=2048) keep the phase to a few seconds warm.
    def _chees_highd(d=24, W=2048):
        import numpy as np

        rng = np.random.default_rng(3)
        q, _ = np.linalg.qr(rng.standard_normal((d, d)))
        scales = np.geomspace(1.0, 300.0, d) ** 0.5
        prec = jnp.asarray(np.linalg.inv((q * scales**2) @ q.T))
        keys = [f"p{i}" for i in range(d)]

        def loglik(fn, params, dataset, _keys=tuple(keys), _prec=prec):
            v = jnp.stack([params[k] for k in _keys])
            return -0.5 * v @ _prec @ v

        w2 = mfit.walker_create(
            function=lambda x, p: jnp.zeros_like(x),
            data=([0.0, 1.0], [0.0, 0.0]),
            params={k: 0.1 for k in keys}, log_likelihood=loglik,
            n_walkers=W, seed=0, walker_jitter=1.0)
        data2 = w2._posterior_data()
        run2 = w2._runner(with_history=False)
        for _ in range(20):                      # rwm covariance warm-in
            w2.state, _ = run2(w2.state, True, True, True, data2)
        w2.config = _dc.replace(w2.config, kernel="chees")
        w2._runner_cache.clear()
        runc = w2._runner(with_history=False)
        for _ in range(10):                      # trajectory adaptation
            w2.state, _ = runc(w2.state, True, True, True, data2)
        hrun = w2._runner(with_history=True)
        w2.state, _ = hrun(w2.state, True, True, True, data2)  # compile
        jax.block_until_ready(w2.state.position)
        tk = time.perf_counter()
        hist = []
        for _ in range(2):
            w2.state, h = hrun(w2.state, True, True, True, data2)
            hist.append(h["positions"])          # stays on device
        pos2 = jnp.concatenate(hist, axis=0)
        jax.block_until_ready(pos2)
        dt = time.perf_counter() - tk
        k_ess = min(ess_from_history(pos2, w2.spec.keys).values())
        if args.verbose:
            print(f"# chees d={d} W={W}: min-ESS={k_ess:.0f} in "
                  f"{dt:.2f}s -> {k_ess / dt:.0f} ESS/sec",
                  file=sys.stderr)
        return k_ess / dt

    ess_per_sec_chees_d24 = _chees_highd()

    result = {
        "metric": "adaptive-MH chain-steps/sec, 6-param lorder-mixed-bg fit, 334-pt dataset",
        "value": steps_per_sec,
        "unit": "chain-steps/sec",
        "vs_baseline": steps_per_sec / BASELINE_STEPS_PER_SEC,
        "ess_per_sec": ess_per_sec,
        "min_ess": min_ess,
        # Kernel-family tracking (sampling phase, same fit): rwm is the
        # headline ess_per_sec above; the gradient kernels are the
        # production samplers and must not silently regress.
        "ess_per_sec_rwm": ess_per_sec,
        "ess_per_sec_mala": ess_per_sec_mala,
        "ess_per_sec_chees": ess_per_sec_chees,
        # chees in its own regime (correlated d=24 Gaussian; see above).
        "ess_per_sec_chees_d24": ess_per_sec_chees_d24,
        "card": card,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }
    print(json.dumps(result))


if __name__ == "__main__":
    main()
