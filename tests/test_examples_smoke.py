"""Examples are runnable in this environment (VERDICT r4 #7).

The flagship journey (examples/reference_journey.py) must import and
drive its first phase on CPU with a tiny budget, on the generated
flagship table.  Every example honors ``LISP_MCMC_PLATFORM=cpu`` via
examples/_common.setup_platform() and prints timestamped phase markers.
"""

import glob
import os
import sys

import numpy as np
import pytest

EXAMPLES = os.path.join(os.path.dirname(__file__), "..", "examples")
sys.path.insert(0, EXAMPLES)


def test_every_example_uses_the_platform_knob():
    for f in glob.glob(os.path.join(EXAMPLES, "*.py")):
        if f.endswith("_common.py"):
            continue
        src = open(f).read()
        assert "setup_platform()" in src, \
            f"{os.path.basename(f)} missing the LISP_MCMC_PLATFORM knob"


def test_reference_journey_first_phase_runs(example_table_path):
    import reference_journey as rj

    _, x, y, walker = rj.ingest_and_fit(
        n_steps=800, n_walkers=64, path=example_table_path)
    assert len(x) == 334
    lp, best = walker.most_likely_step()
    assert np.isfinite(lp)
    assert float(walker.acceptance()) > 0.05
