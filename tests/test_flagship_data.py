"""The generated flagship data, the compile cache and ``chip_smoke.py``."""

import json
import os
import shutil
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest

import lisp_mcmc_tpu as mfit
from lisp_mcmc_tpu.flagship import (N_POINTS, SIGMA, TRUTH, flagship_data,
                                    flagship_walker)
from lisp_mcmc_tpu.models import lorder_mixed_bg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_flagship_data_shape_and_determinism():
    x, y = flagship_data(0)
    assert x.shape == y.shape == (N_POINTS,)
    assert x[0] == 2000.0 and x[-1] == 3000.0
    np.testing.assert_array_equal(y, flagship_data(0)[1])
    assert not np.array_equal(y, flagship_data(1)[1])
    # The noise is sigma-sized, and the planted line stands well above it.
    resid = y - np.asarray(lorder_mixed_bg(x, TRUTH))
    assert 0.8 * SIGMA < resid.std() < 1.2 * SIGMA
    line = np.asarray(lorder_mixed_bg(x, dict(TRUTH, bg0=0.0, bg1=0.0)))
    assert np.max(np.abs(line)) > 8 * SIGMA


def test_flagship_fit_recovers_planted_line():
    """The flagship journey (test.lisp's cold start, f32) finds the
    planted resonance and a log-posterior at least the truth's."""
    w = flagship_walker(256, dtype=jnp.float32)
    w.adaptive_steps(30000, temperature=10.0)
    lp, best = w.most_likely_step()
    truth = mfit.walker_create(function=lorder_mixed_bg, data=flagship_data(0),
                               params=TRUTH, data_error=SIGMA, n_walkers=1,
                               dtype=jnp.float32)
    assert abs(best["x0"] - TRUTH["x0"]) < 5.0, best
    assert lp >= float(truth.state.logprob[0]) - 1.0
    assert 0.1 < w.acceptance() < 0.6


_CACHE_PROBE = (
    "import jax, lisp_mcmc_tpu as m\n"
    "path = m.enable_compilation_cache()\n"
    "jax.config.update('jax_persistent_cache_min_compile_time_secs', 0)\n"
    "jax.jit(lambda a: a * 3 + 1)(jax.numpy.arange(7.0)).block_until_ready()\n"
    "print(path)\n"
    "print(jax.config.jax_compilation_cache_dir)\n"
    "print(jax.config.jax_persistent_cache_enable_xla_caches)\n")


@pytest.mark.parametrize("env_dir", [True, False], ids=["env_set", "env_unset"])
def test_compilation_cache_placement(tmp_path, env_dir):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=ROOT)
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    want = str(tmp_path / "cache") if env_dir else os.path.join(ROOT, ".jax_cache")
    if env_dir:
        env["JAX_COMPILATION_CACHE_DIR"] = want
    out = subprocess.run([sys.executable, "-c", _CACHE_PROBE], env=env,
                         capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-2000:]
    path, config_dir, xla_caches = out.stdout.split()[-3:]
    assert path == config_dir == want
    assert xla_caches == "none"        # the CPU-only workaround
    assert os.listdir(want)            # the compile landed there


def test_chip_smoke_last_line_format():
    sys.path.insert(0, ROOT)
    import chip_smoke

    class Dev:
        platform, device_kind = "gpu", "NVIDIA H100 80GB HBM3"

    line = json.loads(chip_smoke.last_line(Dev(), 1))
    assert line == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}}


def _run_smoke(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_fails_without_gpu():
    out = _run_smoke(ROOT, os.path.join(ROOT, "chip_smoke.py"))
    assert out.returncode != 0
    assert "no GPU" in out.stderr
    assert '"ok"' not in out.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    out = _run_smoke(tmp_path, str(tmp_path / "chip_smoke.py"))
    assert out.returncode != 0
    assert "lisp_mcmc_tpu" in out.stderr
    assert '"ok"' not in out.stdout
