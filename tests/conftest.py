"""Test configuration: 8 virtual CPU devices + x64 for SBCL-parity math.

The multi-device tests simulate a mesh with
``--xla_force_host_platform_device_count=8`` on the CPU; x64 is enabled
because the parity target is 1e-8 in log-likelihood against the
double-float reference.

Tests marked ``gpu`` need a card.  They take the ``gpu`` fixture, which
skips them when JAX's default backend is not a GPU.  ``chip_smoke.py``
runs them on the card with ``LISP_MCMC_GPU_TESTS=1``, which leaves JAX's
platform choice alone.
"""

import os

if os.environ.get("LISP_MCMC_GPU_TESTS") != "1":
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402

# ----------------------------------------------------------------- tiers
# ``pytest -m quick`` runs the fast, high-coverage edit-loop tier
# (target <= 3 min on this CPU config); the unmarked remainder is the
# slow tier (long anneals, SBC studies, multi-process spawns) and the
# FULL suite stays the round gate.  Modules are tiered here, in one
# place, instead of per-file pytestmark lines: the set is derived from
# measured module wall times (round-4 full-suite --durations run) and
# is cheap to re-derive when a module's cost changes.  No test is
# deleted or weakened by tiering — `pytest tests/` still runs all.
QUICK_MODULES = {
    "test_expressions_extended", "test_fit", "test_global_predictive",
    "test_io_models", "test_linalg", "test_loo", "test_migration_surface",
    "test_model_weights", "test_multicolumn_x", "test_optimize",
    "test_pallas", "test_substrate",
    "test_utils", "test_waic", "test_examples_smoke", "test_flagship_data",
}

# Fast representatives of the newest tiers (VERDICT r4 #4: the edit loop
# must catch a regression in hierarchical decode/refit, blocked
# proposals, sharding, and chees without waiting on the 35-min suite).
# Per-test because their modules also hold multi-minute anneals; each
# entry measured <= ~16 s on this CPU config (round-5 timing run).
QUICK_TESTS = {
    ("test_hierarchical", "test_decode_exact"),
    ("test_hierarchical", "test_validation"),
    ("test_hier_refit", "test_hier_masked_holdout_matches_sliced"),
    ("test_hier_refit", "test_hier_view_still_refuses_refit"),
    ("test_hier_refit", "test_holdout_axis_is_real_point_axis"),
    ("test_block_proposal", "test_blocked_prerefresh_bitwise_identical"),
    ("test_block_proposal", "test_blocked_l_stays_blockdiagonal_after_refresh"),
    ("test_block_proposal", "test_bad_block_layout_refuses"),
    ("test_parallel", "test_sharded_chunk_matches_single_device"),
    ("test_chees", "test_chees_samples_known_gaussian"),
    ("test_chees", "test_chees_config_validation"),
    ("test_hier_correlation", "test_corr_decode_exact"),
    ("test_hier_correlation", "test_corr_validation"),
    ("test_refit_gate", "test_health_gate_flags_unmixed"),
    ("test_refit_gate", "test_reloo_keeps_psis_for_failed_blocks"),
}


def pytest_collection_modifyitems(config, items):
    for item in items:
        mod = item.module.__name__
        base = getattr(item, "originalname", None) or item.name
        if mod in QUICK_MODULES or (mod, base) in QUICK_TESTS:
            item.add_marker(pytest.mark.quick)


@pytest.fixture
def rng():
    return np.random.default_rng(42)


@pytest.fixture
def gpu():
    """The card, or a skip: tests marked ``gpu`` run only on a GPU."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU (chip_smoke.py runs these on the card)")
    return jax.devices()[0]


@pytest.fixture(scope="session")
def example_table_path(tmp_path_factory):
    """The generated flagship table, in the reference file format."""
    from lisp_mcmc_tpu.flagship import write_flagship_table

    return write_flagship_table(
        str(tmp_path_factory.mktemp("flagship") / "example-data.xls"))

