"""Whole-chunk Pallas kernel vs the XLA ``lax.scan`` chunk, on the GPU.

At the flagship no-history chunk (W = 131072, d = 6, N = 334,
chunk = 200, f32), for each kernel configuration in ``--configs``
(block walkers, tile points, warps, stages):

  * compile time, and a check of the kernel against the plain reference
    (every walker's carried logprob against ``_eval_batch``, and
    ``m_count == sum(accept_counts)``);
  * warm time per chunk, against the XLA scan's from the same state.

Then end to end through the driver, from the cold start:
``adaptive_steps(30000, collect_history=False)`` with the XLA scan and
with the kernel (its default configuration), in the order xla, kernel,
kernel, xla, xla, kernel; the first run of each path includes its
compile.

Prints one JSON line per measurement and writes all of them to
``chiprun_out/chunk_pallas_bench.json``.  Needs a GPU.

Run: python benchmarks/chunk_pallas_bench.py [--configs 128,16,4,1 ...]
"""

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

DEFAULT_CONFIGS = ["128,16,4,1", "128,8,4,1", "128,32,4,1", "256,16,4,1",
                   "256,16,8,1", "64,16,2,1", "128,16,2,1", "128,16,4,2"]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--walkers", type=int, default=131072)
    ap.add_argument("--steps", type=int, default=30000)
    ap.add_argument("--configs", nargs="*", default=DEFAULT_CONFIGS)
    ap.add_argument("--chunks", type=int, default=10)
    ap.add_argument("--check-only", action="store_true",
                    help="compile and check the configurations, then stop")
    args = ap.parse_args()

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"needs a GPU; JAX's default device is {dev.platform!r}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()

    import lisp_mcmc_tpu as mfit
    from lisp_mcmc_tpu.flagship import flagship_walker
    from lisp_mcmc_tpu.ops import chunk_pallas

    mfit.enable_compilation_cache()
    records = []

    def emit(rec):
        rec = {"card": card, "device_kind": dev.device_kind, **rec}
        records.append(rec)
        print(json.dumps(rec), flush=True)

    # A realistic mid-anneal state and L: a few thousand adaptive steps.
    w = flagship_walker(args.walkers, dtype=jnp.float32)
    w.adaptive_steps(4000, collect_history=False, auto=None)
    print("memory_analysis of the XLA chunk:", w._runner(with_history=False)
          .lower(w.state, False, False, False, w._posterior_data()).compile()
          .memory_analysis(), flush=True)
    st, data = w.state, w._posterior_data()
    l_mat = st.l_matrix[0]
    chunk = w.config.chunk_size

    def per_chunk(fn):
        jax.block_until_ready(fn())
        t0 = time.perf_counter()
        for _ in range(args.chunks):
            r = fn()
        jax.block_until_ready(r)
        return (time.perf_counter() - t0) / args.chunks

    xla = w._runner(with_history=False)
    t_xla = per_chunk(lambda: xla(st, False, False, False, data)[0].position)
    emit({"path": "xla_scan", "chunk_ms": t_xla * 1e3,
          "steps_per_s": args.walkers * chunk / t_xla})

    passed = 0
    for spec in args.configs:
        wb, tn, nw, ns = (int(v) for v in spec.split(","))
        cfg = dataclasses.replace(w.config, posterior_impl="pallas_chunk")
        t0 = time.perf_counter()
        kern = jax.jit(chunk_pallas.build_chunk_pallas(
            w.terms, w.spec, cfg, args.walkers, w.dtype, block_walkers=wb,
            tile_points=tn, num_warps=nw, num_stages=ns))
        out = kern(st.position, st.logprob, st.best_position, st.best_logprob,
                   l_mat, st.anneal_step, 0.0, 3)
        jax.block_until_ready(out["position"])
        compile_s = time.perf_counter() - t0
        lp_re = np.asarray(w._eval_batch(out["position"]), np.float64)
        lp_k = np.asarray(out["logprob"], np.float64)
        err = float(np.max(np.abs(lp_re - lp_k) / np.maximum(np.abs(lp_re), 1.0)))
        counts_ok = float(out["m_count"]) == float(np.sum(np.asarray(
            out["accept_counts"], np.float64)))
        t_k = per_chunk(lambda: kern(st.position, st.logprob, st.best_position,
                                     st.best_logprob, l_mat, st.anneal_step,
                                     0.0, 3)["position"])
        emit({"path": "chunk_kernel", "block_walkers": wb, "tile_points": tn,
              "num_warps": nw, "num_stages": ns, "compile_s": compile_s,
              "max_rel_lp_err": err, "m_count_ok": counts_ok,
              "chunk_ms": t_k * 1e3, "steps_per_s": args.walkers * chunk / t_k,
              "xla_over_kernel": t_xla / t_k})
        passed += err <= 1e-4 and counts_ok
    if passed < len(args.configs):
        raise SystemExit("a kernel configuration failed its check")
    if args.check_only:
        return

    # End to end through the driver: cold start, no history, auto-stop.
    walkers = {}

    def e2e(impl):
        # One walker per path, so the second run of a path reuses its
        # compiled chunk; each run restarts from the same cold ensemble.
        cfg = mfit.FitConfig(posterior_impl=impl)
        fresh = flagship_walker(args.walkers, dtype=jnp.float32, config=cfg)
        f = walkers.setdefault(impl, fresh)
        warm = f is not fresh
        f.state = fresh.state
        f.reset()
        t0 = time.perf_counter()
        f.adaptive_steps(args.steps, temperature=10.0, collect_history=False)
        jax.block_until_ready(f.state.position)
        wall = time.perf_counter() - t0
        steps = int(f.state.anneal_step)
        lp, p = f.most_likely_step()
        emit({"path": f"e2e_{impl}", "includes_compile": not warm,
              "wall_s": wall, "steps": steps,
              "chain_steps_per_s": args.walkers * steps / wall,
              "best_lp": lp, "x0": p["x0"], "acceptance": f.acceptance()})

    for impl in ("auto", "pallas_chunk", "pallas_chunk", "auto", "auto",
                 "pallas_chunk"):
        e2e(impl)

    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chunk_pallas_bench.json"), "w") as f:
        json.dump(records, f, indent=1)


if __name__ == "__main__":
    main()
