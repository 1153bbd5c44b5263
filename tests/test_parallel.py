"""Multi-chip sharding on an 8-virtual-device CPU mesh (SURVEY §4 strategy)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import lisp_mcmc_tpu as mfit
from lisp_mcmc_tpu.kernel import build_chunk_runner
from lisp_mcmc_tpu.models import line
from lisp_mcmc_tpu.parallel import CHAIN_AXIS, make_mesh, shard_state, state_shardings


@pytest.fixture(scope="module")
def mesh():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return make_mesh(8)


def _make_walker(n_walkers):
    x = np.linspace(0.0, 10.0, 50)
    y = 2.0 * x + 1.0
    return mfit.walker_create(
        function=line,
        data=(x, y),
        params={"m": 1.5, "b": 0.5},
        data_error=0.1,
        n_walkers=n_walkers,
        seed=0,
        walker_jitter=0.05,
    )


def test_mesh_creation(mesh):
    assert mesh.devices.size == 8
    assert mesh.axis_names == (CHAIN_AXIS,)


def test_shard_state_placement(mesh):
    w = _make_walker(64)
    state = shard_state(w.state, mesh)
    # Walker-axis arrays are split across 8 devices; L is replicated.
    assert len(state.position.sharding.device_set) == 8
    shard_shape = state.position.sharding.shard_shape(state.position.shape)
    assert shard_shape == (8, 2)
    assert state.l_matrix.sharding.is_fully_replicated


def test_shard_replicates_datasets(mesh):
    """Walker.shard leaves nothing on the first device alone: the datasets
    are replicated on every device of the mesh, once."""
    w = _make_walker(64).shard(mesh)
    for leaf in jax.tree_util.tree_leaves(w._posterior_data()):
        assert len(leaf.sharding.device_set) == 8
        assert leaf.sharding.is_fully_replicated
    assert len(w.state.l_matrix.sharding.device_set) == 8


def test_shard_requires_divisible_walkers(mesh):
    w = _make_walker(62)
    with pytest.raises(ValueError, match="divisible"):
        shard_state(w.state, mesh)


def test_sharded_chunk_matches_single_device(mesh):
    """The pooled-covariance chunk must be numerically identical sharded
    vs unsharded (threefry partitionable randoms + allreduced moments)."""
    w = _make_walker(64)
    run, _ = build_chunk_runner(w._log_post_one, w.ndim, w.config, takes_data=True)
    step = jax.jit(run)
    data = w._posterior_data()

    state_single, out_single = step(w.state, True, True, False, data)
    state_sharded, out_sharded = step(shard_state(w.state, mesh), True, True, False, data)

    np.testing.assert_allclose(
        np.asarray(state_single.position), np.asarray(state_sharded.position), rtol=1e-10
    )
    np.testing.assert_allclose(
        np.asarray(state_single.l_matrix), np.asarray(state_sharded.l_matrix), rtol=1e-10
    )
    np.testing.assert_allclose(
        float(out_single["accept_rate"]), float(out_sharded["accept_rate"]), rtol=1e-10
    )


def test_sharded_mala_rescue_matches_single_device(mesh):
    """The gradient kernel's chunk (autodiff drift, trimmed-covariance
    shape refresh, independence-rescue round: full-ensemble sort,
    typical-set covariance, triangular solve) must stay
    GSPMD-partitionable and numerically identical sharded vs unsharded."""
    import dataclasses

    w = _make_walker(64)
    config = dataclasses.replace(w.config, kernel="mala")
    run, _ = build_chunk_runner(w._log_post_one, w.ndim, config, takes_data=True)
    step = jax.jit(run)
    data = w._posterior_data()

    state_single, out_single = step(w.state, True, True, True, data)
    state_sharded, out_sharded = step(shard_state(w.state, mesh), True, True, True, data)

    np.testing.assert_allclose(
        np.asarray(state_single.position), np.asarray(state_sharded.position), rtol=1e-10
    )
    np.testing.assert_allclose(
        np.asarray(state_single.logprob), np.asarray(state_sharded.logprob), rtol=1e-10
    )
    np.testing.assert_allclose(
        float(out_single["accept_rate"]), float(out_sharded["accept_rate"]), rtol=1e-10
    )


def test_sharded_stretch_matches_single_device(mesh):
    """The stretch kernel (half-ensemble reshape + donor gathers) stays
    GSPMD-partitionable AND bitwise identical sharded vs unsharded."""
    import dataclasses

    w = _make_walker(64)
    config = dataclasses.replace(w.config, kernel="stretch")
    run, _ = build_chunk_runner(w._log_post_one, w.ndim, config,
                                takes_data=True)
    step = jax.jit(run)
    data = w._posterior_data()

    state_single, out_single = step(w.state, True, True, False, data)
    state_sharded, out_sharded = step(
        shard_state(w.state, mesh), True, True, False, data)

    np.testing.assert_allclose(
        np.asarray(state_single.position),
        np.asarray(state_sharded.position), rtol=1e-10)
    np.testing.assert_allclose(
        float(out_single["accept_rate"]),
        float(out_sharded["accept_rate"]), rtol=1e-10)


def test_sharded_demc_statistically_matches_single_device(mesh):
    """demc shards correctly but is only STATISTICALLY sharding-
    invariant: XLA fusion rounding differs between partitionings by
    1 ULP (measured, input-dependent) and chaos-amplifies over the
    chunk — see one_step_demc's sharding note.  Assert the statistical
    contract: same acceptance to ~per-walker-count resolution, same
    ensemble location/scale, finite everywhere."""
    import dataclasses

    w = _make_walker(64)
    config = dataclasses.replace(w.config, kernel="demc")
    run, _ = build_chunk_runner(w._log_post_one, w.ndim, config,
                                takes_data=True)
    step = jax.jit(run)
    data = w._posterior_data()

    s1, o1 = step(w.state, True, True, False, data)
    s2, o2 = step(shard_state(w.state, mesh), True, True, False, data)

    assert np.isfinite(np.asarray(s2.position)).all()
    assert float(o2["accept_rate"]) == pytest.approx(
        float(o1["accept_rate"]), abs=0.05)
    p1, p2 = np.asarray(s1.position), np.asarray(s2.position)
    np.testing.assert_allclose(p1.mean(axis=0), p2.mean(axis=0), atol=0.05)
    np.testing.assert_allclose(p1.std(axis=0), p2.std(axis=0), rtol=0.5)


def test_sharded_slice_statistically_matches_single_device(mesh):
    """The slice kernel's in-step while_loops (jnp.any/jnp.all over the
    walker axis become cross-shard reductions under GSPMD) must compile
    and step correctly sharded.  Like demc it is statistically but not
    bitwise sharding-invariant; assert the statistical contract plus
    the rejection-free property surviving the partitioning."""
    import dataclasses

    w = _make_walker(64)
    config = dataclasses.replace(w.config, kernel="slice")
    run, _ = build_chunk_runner(w._log_post_one, w.ndim, config,
                                takes_data=True)
    step = jax.jit(run)
    data = w._posterior_data()

    s1, o1 = step(w.state, True, True, False, data)
    s2, o2 = step(shard_state(w.state, mesh), True, True, False, data)

    assert np.isfinite(np.asarray(s2.position)).all()
    assert float(o2["accept_rate"]) > 0.9     # rejection-free, sharded
    assert float(o2["accept_rate"]) == pytest.approx(
        float(o1["accept_rate"]), abs=0.05)
    p1, p2 = np.asarray(s1.position), np.asarray(s2.position)
    np.testing.assert_allclose(p1.mean(axis=0), p2.mean(axis=0), atol=0.05)
    np.testing.assert_allclose(p1.std(axis=0), p2.std(axis=0), rtol=0.5)


def test_sharded_adaptive_fit(mesh):
    """A full sharded fit converges like the single-device one."""
    w = _make_walker(64).shard(mesh)
    w.adaptive_steps(3000, auto=None)
    best = w.most_likely_params()
    assert best["m"] == pytest.approx(2.0, abs=0.05)
    assert best["b"] == pytest.approx(1.0, abs=0.2)
    # State stays sharded across chunks.
    assert len(w.state.position.sharding.device_set) == 8


def test_collectives_in_compiled_module(mesh):
    """The pooled moments must actually lower to cross-device collectives."""
    w = _make_walker(64)
    run, _ = build_chunk_runner(w._log_post_one, w.ndim, w.config, takes_data=True)
    sharded = shard_state(w.state, mesh)
    shardings = state_shardings(mesh)
    lowered = jax.jit(run, in_shardings=(shardings, None, None, None, None)).lower(
        sharded, True, True, False, w._posterior_data()
    )
    hlo = lowered.compile().as_text()
    assert "all-reduce" in hlo or "all-gather" in hlo or "reduce-scatter" in hlo


def test_grouped_batched_fit_shards(mesh):
    """Per-spectrum adaptation groups compose with chain-axis sharding:
    the (G, B) reshape fast path must stay GSPMD-partitionable."""
    from lisp_mcmc_tpu import nv
    from lisp_mcmc_tpu.models import double_lorentzian_bg

    rng = np.random.default_rng(0)
    freqs = np.linspace(2840.0, 2900.0, 128)

    def spec(d1, d2):
        c = double_lorentzian_bg(freqs, {"scale1": 1e-5, "scale2": 1e-5,
                                         "mu1": d1, "mu2": d2,
                                         "sigma": 10.0, "bg0": 1e-4})
        return freqs, np.asarray(c) + 2e-7 * rng.standard_normal(128)

    fit = nv.BatchedNVFit([spec(2858, 2876), spec(2862, 2874)],
                          walkers_per_spectrum=32, seed=0)  # W=64
    fit.shard(mesh)
    fit.adaptive_steps(1200, auto=None)
    assert len(fit.state.position.sharding.device_set) == 8
    offs = fit.field_offsets()
    assert np.isfinite(offs).all()
    # spectra with 18 vs 12 MHz splittings stay distinguishable
    assert offs[0] > offs[1]


def test_dryrun_multichip_entrypoint():
    import sys

    sys.path.insert(0, "/root/repo")
    try:
        import __graft_entry__ as ge

        ge.dryrun_multichip(8)
        fn, args = ge.entry()
        pos, lpmax = jax.jit(fn)(*args)
        assert np.isfinite(np.asarray(lpmax)).all()
    finally:
        sys.path.remove("/root/repo")


def test_sharded_chees_matches_single_device(mesh):
    """ChEES chunk sharded == unsharded: the trajectory-length machinery
    adds per-step GROUP reductions (alpha-weighted proposal means, the
    criterion gradient) that must lower to allreduces, a replicated
    while_loop trip count (max over groups), and replicated Adam state
    in WalkerState.chees — all numerically identical across shardings."""
    import dataclasses

    w = _make_walker(64)
    config = dataclasses.replace(w.config, kernel="chees")
    run, _ = build_chunk_runner(w._log_post_one, w.ndim, config, takes_data=True)
    step = jax.jit(run)
    data = w._posterior_data()

    state_single, out_single = step(w.state, True, True, True, data)
    state_sharded, out_sharded = step(shard_state(w.state, mesh), True, True, True, data)

    np.testing.assert_allclose(
        np.asarray(state_single.position), np.asarray(state_sharded.position), rtol=1e-10
    )
    np.testing.assert_allclose(
        np.asarray(state_single.chees), np.asarray(state_sharded.chees), rtol=1e-8
    )
    np.testing.assert_allclose(
        float(out_single["accept_rate"]), float(out_sharded["accept_rate"]), rtol=1e-10
    )


def test_two_process_distributed_matches_single_process():
    """initialize_distributed for REAL (VERDICT r3 #4): two OS processes
    form one 2-device global mesh over a localhost coordinator, run the
    same sharded chunk, and the replicated scalars match a single-
    process run of the identical program to 1e-12 — the kernel's
    sharded==unsharded guarantee extended across process boundaries."""
    import json
    import os
    import socket
    import subprocess
    import sys

    # A free localhost port for the coordinator.
    try:
        s = socket.socket()
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
        s.close()
    except OSError:
        pytest.skip("no localhost port available")

    worker = os.path.join(os.path.dirname(__file__), "dist_worker.py")
    env = dict(os.environ, PYTHONPATH="/root/repo")
    procs = [subprocess.Popen(
        [sys.executable, worker, str(i), "2", str(port)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env)
        for i in range(2)]
    try:
        outs = [p.communicate(timeout=240) for p in procs]
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.skip("distributed workers timed out (loaded machine)")
    for i, (out, err) in enumerate(outs):
        assert procs[i].returncode == 0, \
            f"worker {i} failed:\n{err.decode()[-2000:]}"
    line = [ln for ln in outs[0][0].decode().splitlines()
            if ln.startswith("{")][-1]
    dist = json.loads(line)
    assert dist["n_global_devices"] == 2
    assert dist["process_count"] == 2

    # Single-process ground truth: the identical program, unsharded
    # (sharded==unsharded is bitwise for the rwm chunk, pinned above).
    w = _make_walker(16)
    run, _ = build_chunk_runner(w._log_post_one, w.ndim, w.config,
                                takes_data=True)
    state, out = jax.jit(run)(w.state, True, True, False,
                              w._posterior_data())
    assert dist["accept_rate"] == pytest.approx(
        float(out["accept_rate"]), abs=1e-12)
    assert dist["lp_mean"] == pytest.approx(
        float(jnp.mean(state.logprob)), rel=1e-12)
    assert dist["best"] == pytest.approx(
        float(jnp.max(state.best_logprob)), rel=1e-12)
    assert dist["l_sum"] == pytest.approx(
        float(jnp.sum(state.l_matrix)), rel=1e-12)
