#!/usr/bin/env python3
"""Smoke test of the adaptive-MH main path on a GPU, at full size.

    python chip_smoke.py              # one card: phases 1-7
    python chip_smoke.py --chips 4    # four cards: the sharded ensemble only

Phases (one card):
  1. device: the default JAX device is a GPU, or exit 1
  2. flagship journey: ``walker_create`` at W = 131072 (f32),
     ``adaptive_steps(30000, temperature=10)`` with history, a cold
     segment and ``diagnostics.convergence``
  3. the f32 posterior on the card against the f64 one on the CPU
  4. the gradient kernel: ``sampling_steps(kernel="mala")``
  5. the grouped scan grid: ``nv.BatchedNVFit``, 4 spectra x 32768 walkers
  6. the whole-chunk kernel against the XLA scan and the plain reference
  7. the tests marked ``gpu`` (run first, in a child process, before this
     process opens the card)

With ``--chips 4`` the flagship ensemble is sharded over the visible
cards and compared with the same program on one card; nothing else runs.

Every phase prints what it measured beside the card's name and power
limit; the last line is one JSON object with the device.  Any failure
exits non-zero.  The data is generated from ``--seed``
(``lisp_mcmc_tpu.flagship``).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# f32 against f64 at the same inputs: 334 terms of z^2/2 accumulated in
# f32 (relative rounding ~ sqrt(334) * 6e-8 of the sum), plus one rounded
# reciprocal per point in the model.  The sum is as large as the
# walker-independent constant it is added to, so the scale is
# |lp| + |constant| + 1; 1e-4 of it bounds both with a wide margin and is
# still far below any modelling error.
LP_RTOL = 1e-4
# Best log-posterior against its value at the planted truth: the MAP is
# above the truth's value, and an ensemble of 131072 walkers samples near
# it; 1.0 covers f32 evaluation and the distance of the best draw from
# the MAP.
LP_MARGIN = 1.0
X0_TOL = 5.0           # recovered x0 within 5 field units of the planted one
NV_MU_TOL = 1.5        # recovered resonances within 1.5 MHz (12 MHz linewidth)


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def _report(card: str, phase: str, **numbers) -> None:
    body = ", ".join(f"{k}={v}" for k, v in numbers.items())
    print(f"[{phase}] {body} | card: {card}", flush=True)


def _gpu_tests(card: str) -> None:
    """Phase 7, in a child process, before this process opens the card."""
    env = dict(os.environ, LISP_MCMC_GPU_TESTS="1")
    t0 = time.perf_counter()
    # Only the module of the marked tests is collected: other modules
    # import optional packages (matplotlib) that a card's host may lack.
    r = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-m", "gpu", "-p",
         "no:cacheprovider", os.path.join(HERE, "tests", "test_gpu.py")],
        cwd=HERE, env=env, capture_output=True, text=True, timeout=900)
    tail = r.stdout.strip().splitlines()[-1] if r.stdout.strip() else ""
    if r.returncode != 0 or " passed" not in tail or "skipped" in tail:
        print(r.stdout[-6000:], r.stderr[-3000:], sep="\n", file=sys.stderr)
        raise SystemExit(f"phase 7: tests marked gpu did not all pass: {tail}")
    _report(card, "gpu-tests", result=repr(tail),
            seconds=round(time.perf_counter() - t0, 3))


def last_line(device, count: int) -> str:
    """The closing JSON line: the device as JAX reports it."""
    return json.dumps({"ok": True, "device": {
        "platform": device.platform, "kind": device.device_kind,
        "count": count}})


def _rows_match(got, want, rtol):
    """Fraction of walker rows whose entries all agree within ``rtol``."""
    import numpy as np

    got = np.asarray(got, np.float64).reshape(len(got), -1)
    want = np.asarray(want, np.float64).reshape(len(want), -1)
    ok = np.all(np.isclose(got, want, rtol=rtol, atol=1e-12), axis=1)
    return float(np.mean(ok))


def _flagship_journey(card, args, mfit, jax, jnp, np):
    from lisp_mcmc_tpu import diagnostics
    from lisp_mcmc_tpu.flagship import SIGMA, TRUTH, flagship_data, flagship_walker
    from lisp_mcmc_tpu.models import lorder_mixed_bg

    w = flagship_walker(args.walkers, seed=args.seed, data_seed=args.seed,
                        dtype=jnp.float32)
    dev = jax.devices()[0]

    t0 = time.perf_counter()
    runner = w._runner(with_history=True)
    runner.lower(w.state, jnp.asarray(True), jnp.asarray(True),
                 jnp.asarray(False), w._posterior_data()).compile()
    compile_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    w.adaptive_steps(args.steps, temperature=10.0)
    jax.block_until_ready(w.state.position)
    wall = time.perf_counter() - t0
    steps = w.age
    lp, best = w.most_likely_step()
    acc = w.acceptance()

    truth = mfit.walker_create(
        function=lorder_mixed_bg, data=flagship_data(args.seed), params=TRUTH,
        data_error=SIGMA, n_walkers=1, dtype=jnp.float32)
    lp_truth = float(truth.state.logprob[0])
    _report(card, "flagship", walkers=args.walkers, steps=steps,
            compile_s=round(compile_s, 3), wall_s=round(wall, 3),
            chain_steps_per_s=round(args.walkers * steps / wall),
            best_lp=round(lp, 3), truth_lp=round(lp_truth, 3),
            x0=round(best["x0"], 3), acceptance=round(acc, 4))
    assert abs(best["x0"] - TRUTH["x0"]) < X0_TOL, best
    assert 0.1 < acc < 0.6, acc
    assert lp >= lp_truth - LP_MARGIN, (lp, lp_truth)

    # Cold segment: T = 1 on the adapted ensemble, then the verdict.
    w.reset()
    t0 = time.perf_counter()
    w.sampling_steps(2000, kernel="rwm")
    jax.block_until_ready(w.state.position)
    cold = time.perf_counter() - t0
    conv = diagnostics.convergence(w)
    ess = diagnostics.ess_per_param(w)
    min_ess = min(ess.values())
    peak = (dev.memory_stats() or {}).get("peak_bytes_in_use")
    _report(card, "flagship-cold", steps=2000, wall_s=round(cold, 3),
            min_ess=round(min_ess, 1), ess_per_s=round(min_ess / cold, 1),
            converged=conv["ok"], failures=len(conv["failures"]),
            peak_bytes_in_use=peak)
    assert np.isfinite(min_ess) and min_ess > 0, ess
    assert all(np.all(np.isfinite(v)) for v in conv["rank_rhat"].values()), conv
    return w


def _posterior_vs_cpu(card, w, seed, mfit, jax, jnp, np):
    from lisp_mcmc_tpu.flagship import START, SIGMA, flagship_data
    from lisp_mcmc_tpu.models import lorder_mixed_bg

    pos = w.state.position
    lp_gpu = np.asarray(w._eval_batch(pos), np.float64)
    # The reference sees the card's inputs exactly: the f32 positions and
    # the f32-rounded data, widened to f64.  What remains is arithmetic.
    x, y = (np.asarray(a, np.float32).astype(np.float64)
            for a in flagship_data(seed))
    cpu = jax.devices("cpu")[0]
    with jax.enable_x64(True), jax.default_device(cpu):
        ref = mfit.walker_create(
            function=lorder_mixed_bg, data=(x, y),
            params=START, data_error=SIGMA, n_walkers=1, dtype=jnp.float64)
        pos64 = jax.device_put(np.asarray(pos, np.float64), cpu)
        lp_cpu = np.asarray(ref._eval_batch(pos64), np.float64)
    live = np.abs(lp_cpu) < 1e30
    const = abs(float(ref.terms[0].dataset.log_norm_const))
    err = np.abs(lp_gpu[live] - lp_cpu[live]) / (np.abs(lp_cpu[live]) + const + 1.0)
    _report(card, "posterior-vs-cpu-f64", walkers=len(lp_cpu),
            compared=int(live.sum()), max_rel_err=float(err.max()),
            tolerance=LP_RTOL)
    assert live.mean() > 0.99, live.mean()
    assert err.max() <= LP_RTOL, err.max()


def _mala(card, w, jax, np):
    t0 = time.perf_counter()
    w.sampling_steps(1000, kernel="mala")
    jax.block_until_ready(w.state.position)
    wall = time.perf_counter() - t0
    acc = w.acceptance()
    finite = bool(np.all(np.isfinite(np.asarray(w.state.position)))
                  and np.all(np.isfinite(np.asarray(w.state.logprob))))
    _report(card, "mala", steps=1000, wall_s=round(wall, 3),
            acceptance=round(acc, 4), finite=finite)
    assert finite
    assert 0.2 < acc < 0.95, acc


def _scan_grid(card, args, jax, jnp, np):
    from lisp_mcmc_tpu import nv
    from lisp_mcmc_tpu.models import double_lorentzian_bg

    rng = np.random.default_rng(args.seed)
    x = np.linspace(2800.0, 2940.0, 256)
    spectra, truths = [], []
    for s in range(4):
        p = {"scale1": 4e-5, "scale2": 4e-5, "mu1": 2858.0 + s,
             "mu2": 2880.0 + s, "sigma": 12.0, "bg0": 8e-6}
        mu = np.asarray(double_lorentzian_bg(x, p), np.float64)
        spectra.append((x, mu + rng.normal(0.0, 4e-7, x.size)))
        truths.append((p["mu1"], p["mu2"]))
    fit = nv.BatchedNVFit(spectra, walkers_per_spectrum=32768, seed=args.seed,
                          dtype=jnp.float32)
    t0 = time.perf_counter()
    fit.adaptive_steps(4000, auto=None)
    jax.block_until_ready(fit.state.position)
    wall = time.perf_counter() - t0
    errs = []
    for s, best in enumerate(fit.best_params_per_spectrum()):
        mus = sorted([best["mu1"], best["mu2"]])
        errs.append(max(abs(mus[0] - truths[s][0]), abs(mus[1] - truths[s][1])))
    _report(card, "scan-grid", spectra=4, walkers_per_spectrum=32768,
            steps=4000, wall_s=round(wall, 3),
            chain_steps_per_s=round(4 * 32768 * 4000 / wall),
            max_mu_err=round(max(errs), 4), acceptance=round(fit.acceptance(), 4))
    assert max(errs) < NV_MU_TOL, errs


def _chunk_kernel(card, w, args, mfit, jax, jnp, np):
    """The whole-chunk kernel on the card against the XLA scan."""
    import dataclasses

    from lisp_mcmc_tpu.ops.chunk_pallas import build_chunk_pallas

    cfg = dataclasses.replace(w.config, posterior_impl="pallas_chunk")
    kern = build_chunk_pallas(w.terms, w.spec, cfg, w.n_walkers, w.dtype)
    assert kern is not None
    st = w.state
    l_mat = st.l_matrix[0]
    run = jax.jit(kern)
    out = run(st.position, st.logprob, st.best_position, st.best_logprob,
              l_mat, 0, 1.0, 11)
    lp_re = np.asarray(w._eval_batch(out["position"]), np.float64)
    lp_k = np.asarray(out["logprob"], np.float64)
    err = np.abs(lp_re - lp_k) / np.maximum(np.abs(lp_re), 1.0)
    m_count = float(out["m_count"])
    acc_sum = float(np.sum(np.asarray(out["accept_counts"], np.float64)))
    assert err.max() <= LP_RTOL, err.max()
    assert m_count == acc_sum, (m_count, acc_sum)

    # Statistical agreement: the same ensemble and L, ten chunks at T = 1
    # without adaptation, through the kernel and through the XLA scan.
    xla = jax.jit(w._runner(with_history=False))
    data = w._posterior_data()
    sx = st
    pos, lp, best, blp = st.position, st.logprob, st.best_position, st.best_logprob
    for c in range(10):
        sx, ox = xla(sx, False, False, True, data)
        o = run(pos, lp, best, blp, l_mat, 0, 1.0, 100 + c)
        pos, lp, best, blp = (o["position"], o["logprob"], o["best_position"],
                              o["best_logprob"])
    px = np.asarray(sx.position, np.float64)
    pk = np.asarray(pos, np.float64)
    sd = px.std(axis=0)
    mean_dev = float(np.max(np.abs(pk.mean(0) - px.mean(0)) / sd))
    sd_ratio = pk.std(axis=0) / sd
    acc_k = float(np.mean(np.asarray(o["accept_counts"]))) / w.config.chunk_size
    acc_x = float(ox["accept_rate"])

    # Per-chunk device time, warm, both paths from the same state.
    def clock(fn, n=20):
        jax.block_until_ready(fn())
        t0 = time.perf_counter()
        for _ in range(n):
            r = fn()
        jax.block_until_ready(r)
        return (time.perf_counter() - t0) / n

    t_k = clock(lambda: run(st.position, st.logprob, st.best_position,
                            st.best_logprob, l_mat, 0, 1.0, 5)["position"])
    t_x = clock(lambda: xla(st, False, False, True, data)[0].position)
    _report(card, "chunk-kernel", walkers=w.n_walkers,
            max_rel_lp_err=float(err.max()), m_count=m_count,
            mean_dev_in_sd=round(mean_dev, 4),
            sd_ratio_min=round(float(sd_ratio.min()), 4),
            sd_ratio_max=round(float(sd_ratio.max()), 4),
            acceptance_kernel=round(acc_k, 4), acceptance_xla=round(acc_x, 4),
            kernel_chunk_ms=round(t_k * 1e3, 4), xla_chunk_ms=round(t_x * 1e3, 4))
    assert mean_dev < 0.1, mean_dev
    assert np.all((sd_ratio > 0.8) & (sd_ratio < 1.25)), sd_ratio
    assert abs(acc_k - acc_x) < 0.05, (acc_k, acc_x)


def _sharded(card, args, jax, jnp, np):
    """Flagship ensemble sharded over the visible cards vs one card."""
    from lisp_mcmc_tpu.flagship import flagship_walker
    from lisp_mcmc_tpu.parallel import make_mesh

    n_dev = len(jax.devices())
    if n_dev != args.chips:
        raise SystemExit(f"--chips {args.chips}: JAX sees {n_dev} devices")
    one = flagship_walker(args.walkers, seed=args.seed, data_seed=args.seed,
                          dtype=jnp.float32)
    many = flagship_walker(args.walkers, seed=args.seed, data_seed=args.seed,
                           dtype=jnp.float32).shard(make_mesh())
    st = many.state
    devs = lambda a: len(a.sharding.device_set)
    data_devs = min(devs(a) for a in jax.tree_util.tree_leaves(
        many._posterior_data()))
    placement = {"position": devs(st.position), "l_matrix": devs(st.l_matrix),
                 "m_outer": devs(st.m_outer), "datasets": data_devs}
    assert all(v == n_dev for v in placement.values()), placement
    shard_devs = {s.device for s in st.position.addressable_shards}
    assert len(shard_devs) == n_dev, shard_devs

    def chunks(w, n):
        run = w._runner(with_history=False)
        data = w._posterior_data()
        s = w.state
        s, _ = run(s, True, True, False, data)      # compile + warm
        jax.block_until_ready(s.position)
        t0 = time.perf_counter()
        for _ in range(n):
            s, out = run(s, True, True, False, data)
        jax.block_until_ready(s.position)
        return s, out, (time.perf_counter() - t0) / n

    n = 3
    s1, o1, t1 = chunks(one, n)
    s4, o4, t4 = chunks(many, n)
    rows_pos = _rows_match(s4.position, s1.position, 1e-4)
    rows_lp = _rows_match(s4.logprob, s1.logprob, 1e-4)

    def rel(a, b):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))

    p1, p4 = np.asarray(s1.position, np.float64), np.asarray(s4.position, np.float64)
    mean_err = float(np.max(np.abs(p4.mean(0) - p1.mean(0)) / p1.std(0)))
    cov_err = rel(np.cov(p4.T), np.cov(p1.T))
    l_err = rel(s4.l_matrix, s1.l_matrix)
    acc_err = abs(float(o4["accept_rate"]) - float(o1["accept_rate"]))
    _report(card, "sharded", chips=n_dev, walkers=args.walkers, chunks=n + 1,
            placement=placement, rows_match_position=round(rows_pos, 5),
            rows_match_logprob=round(rows_lp, 5), mean_err_in_sd=mean_err,
            cov_rel_err=cov_err, l_rel_err=l_err, accept_diff=acc_err,
            one_card_chunk_ms=round(t1 * 1e3, 3),
            sharded_chunk_ms=round(t4 * 1e3, 3))
    # Rows: an f32 reduction-order difference can flip a borderline
    # accept, after which that walker's row differs; a broken sharded
    # kernel differs on nearly every row.  Pooled statistics over 131072
    # walkers move by far less than 1e-2 from a few flipped walkers.
    assert rows_pos >= 0.9 and rows_lp >= 0.9, (rows_pos, rows_lp)
    assert mean_err < 1e-2 and cov_err < 1e-2 and l_err < 1e-2, \
        (mean_err, cov_err, l_err)
    assert acc_err < 1e-2, acc_err


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chips", type=int, default=1, choices=(1, 4))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--walkers", type=int, default=131072)
    ap.add_argument("--steps", type=int, default=30000)
    args = ap.parse_args(argv)

    sys.path.insert(0, HERE)
    try:
        import lisp_mcmc_tpu as mfit  # noqa: F401  (the program must be here)
    except ImportError as e:
        print(f"chip_smoke: the lisp_mcmc_tpu package is not beside this "
              f"script ({e})", file=sys.stderr)
        return 2

    try:
        card = _card()
    except (OSError, subprocess.SubprocessError) as e:
        print(f"chip_smoke: no GPU: nvidia-smi failed ({e})", file=sys.stderr)
        return 1
    print(f"card: {card}", flush=True)
    if args.chips == 1:
        _gpu_tests(card)

    import jax
    import jax.numpy as jnp
    import numpy as np

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: no GPU: JAX's default device is "
              f"{devices[0].platform!r}", file=sys.stderr)
        return 1
    mfit.enable_compilation_cache()
    _report(card, "device", platform=devices[0].platform,
            kind=repr(devices[0].device_kind), count=len(devices))

    if args.chips == 4:
        _sharded(card, args, jax, jnp, np)
    else:
        w = _flagship_journey(card, args, mfit, jax, jnp, np)
        _posterior_vs_cpu(card, w, args.seed, mfit, jax, jnp, np)
        _chunk_kernel(card, w, args, mfit, jax, jnp, np)
        _mala(card, w, jax, np)
        _scan_grid(card, args, jax, jnp, np)

    print(last_line(devices[0], args.chips))
    return 0


if __name__ == "__main__":
    sys.exit(main())
