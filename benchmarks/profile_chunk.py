"""Where a flagship chunk's device time goes, from a profiler trace.

Traces ``--chunks`` warm no-history chunks of the XLA scan at the flagship
shape (W = 131072, d = 6, N = 334, f32; the first chunk compiles outside
the trace) and reduces the trace of the first GPU plane to:

  * the busy share of the window (union of kernel intervals over the
    window from the first kernel start to the last kernel end);
  * per kernel name: launches, total device time, share of busy time;
  * for the largest kernel (the posterior fusion at this shape), its
    time per step against the flops and bytes the posterior needs per
    step, as shares of the H100 SXM's published 67 TFLOP/s f32 (outside
    the tensor cores) and 3.35 TB/s.

The flops are counted from the model, not taken from XLA's cost
analysis (which counts a scan body once): ``lorder_mixed_bg`` plus the
Gaussian reduction take 16 operations per point (12 in the model, the
division counted as one; 4 in the residual, scale, square and sum), over
the dataset's padded length, for every walker.  The bytes are the
positions read and the log-posterior written.

Prints one JSON object; the trace stays under ``chiprun_out/trace``.
Run: python benchmarks/profile_chunk.py
"""

import argparse
import glob
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

F32_PEAK = 67e12     # H100 SXM f32 FLOP/s outside the tensor cores (data sheet)
HBM_PEAK = 3.35e12   # H100 SXM HBM3 bytes/s (data sheet)
FLOPS_PER_POINT = 16  # lorder_mixed_bg + Gaussian reduction (see above)


def reduce_trace(path):
    """Per-kernel device time of the first GPU plane of an xplane file."""
    from jax.profiler import ProfileData

    pd = ProfileData.from_file(path)
    planes = [p for p in pd.planes if p.name.startswith("/device:GPU")]
    if not planes:
        raise SystemExit(f"no GPU plane in {path}: "
                         f"{[p.name for p in pd.planes]}")
    kernels = {}
    spans = []
    lines = [ln for ln in planes[0].lines if "Stream" in ln.name] \
        or list(planes[0].lines)
    for line in lines:
        for ev in line.events:
            k = kernels.setdefault(ev.name, [0, 0.0])
            k[0] += 1
            k[1] += ev.duration_ns
            spans.append((ev.start_ns, ev.start_ns + ev.duration_ns))
    spans.sort()
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    window = (spans[-1][1] - spans[0][0]) if spans else 0.0
    return planes[0], kernels, busy, window


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--walkers", type=int, default=131072)
    ap.add_argument("--chunks", type=int, default=3)
    args = ap.parse_args()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"needs a GPU; JAX's default device is {dev.platform!r}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()

    import lisp_mcmc_tpu as mfit
    from lisp_mcmc_tpu.flagship import flagship_walker

    mfit.enable_compilation_cache()
    w = flagship_walker(args.walkers, dtype=jnp.float32)
    run = w._runner(with_history=False)
    data = w._posterior_data()
    st, _ = run(w.state, True, True, False, data)
    jax.block_until_ready(st.position)
    chunk = w.config.chunk_size
    n_pad = int(w.terms[0].dataset.x.shape[0])
    flops_step = FLOPS_PER_POINT * args.walkers * n_pad

    out_dir = os.path.join(ROOT, "chiprun_out", "trace")
    t0 = time.perf_counter()
    with jax.profiler.trace(out_dir):
        for _ in range(args.chunks):
            st, _ = run(st, True, True, False, data)
        jax.block_until_ready(st.position)
    wall = time.perf_counter() - t0
    path = sorted(glob.glob(os.path.join(out_dir, "**", "*.xplane.pb"),
                            recursive=True))[-1]
    plane, kernels, busy, window = reduce_trace(path)
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:15]
    steps = args.chunks * chunk
    name, (count, total) = top[0]
    t_step = total / steps * 1e-9
    d = w.ndim
    bytes_step = args.walkers * (d + 1) * 4       # positions in, logprob out
    print(json.dumps({
        "card": card, "device_kind": dev.device_kind, "plane": plane.name,
        "walkers": args.walkers, "steps": steps, "traced_wall_s": wall,
        "window_ms": window * 1e-6, "busy_ms": busy * 1e-6,
        "idle_share": 1.0 - busy / window if window else None,
        "launches_per_step": sum(c for c, _ in kernels.values()) / steps,
        "padded_points": n_pad, "posterior_flops_per_step": flops_step,
        "top_kernels": [{"name": n, "launches": c, "ms": t * 1e-6,
                         "share_of_busy": t / busy} for n, (c, t) in top],
        "largest": {"name": name, "us_per_step": t_step * 1e6,
                    "f32_roofline_share": flops_step / F32_PEAK / t_step,
                    "hbm_roofline_share": bytes_step / HBM_PEAK / t_step},
    }, indent=1))


if __name__ == "__main__":
    main()
