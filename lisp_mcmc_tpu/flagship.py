"""The flagship fit's data, generated from a seed.

The reference's test.lisp fits ``lorder_mixed_bg`` to its
``example-data.xls``: 334 points of a 2000-3000 field sweep, columns 1
(x) and 4 (y), sigma = 1e-7.  That file is not distributed with this
repository, so every consumer (tests, examples, benchmarks,
``chip_smoke.py``) uses this generator instead: the same shape, the same
model and noise level, with parameters planted in the reference's basin
(x0 ~ 2785, mix ~ pi).

The reference's printed optimum has a line amplitude of only
~0.65 |scale| / linewidth ~ 3e-8, a third of sigma; the planted scale is
larger, so the resonance stands ~10 sigma above the noise at its peak and
a fit recovers it.

:func:`write_flagship_table` writes the same data in the reference file
format (tab-separated, one header line, 9 columns), so the ingestion path
``read_file_data`` -> ``create_walker_data(table, 1, 4)`` runs on it too.
"""

from __future__ import annotations

import numpy as np

__all__ = ["N_POINTS", "SIGMA", "START", "TRUTH", "flagship_data",
           "flagship_walker", "write_flagship_table"]

N_POINTS = 334
SIGMA = 1e-7
X_RANGE = (2000.0, 3000.0)

# test.lisp's starting guess (the cold start every flagship journey uses).
START = {"scale": 1e-5, "linewidth": 7.0, "x0": 2200.0, "mix": 0.9,
         "bg0": 1e-7, "bg1": 1e-9}

# Planted parameters: the reference optimum's basin (x0, mix, background),
# with a scale large enough for the line to be recovered.
TRUTH = {"scale": -1.0e-4, "linewidth": 60.0, "x0": 2785.0,
         "mix": 3.1, "bg0": -1.06e-6, "bg1": 2.82e-10}

_HEADER = ("field_set\tfield\tx_lockin\ty_lockin\tsignal\tphase"
           "\ttemperature\tfrequency\ttime")


def flagship_data(seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """``(x, y)`` float64 arrays of the flagship fit, noise drawn from ``seed``."""
    from .models import lorder_mixed_bg

    x = np.linspace(*X_RANGE, N_POINTS)
    mu = np.asarray(lorder_mixed_bg(x, TRUTH), np.float64)
    rng = np.random.default_rng(seed)
    return x, mu + SIGMA * rng.standard_normal(N_POINTS)


def write_flagship_table(path: str, seed: int = 0) -> str:
    """Write the flagship data as a 9-column tab-separated table.

    Column 1 (0-based) is the field and column 4 the signal, as in the
    reference file; the other columns are filler channels of the same
    length.  Values are written with 17 significant digits, so the table
    reads back to the exact arrays of :func:`flagship_data`.
    """
    x, y = flagship_data(seed)
    rng = np.random.default_rng(seed + 1)
    cols = [
        x,                                        # field setpoint
        x,                                        # field readback (x)
        SIGMA * rng.standard_normal(N_POINTS),    # lock-in X
        SIGMA * rng.standard_normal(N_POINTS),    # lock-in Y
        y,                                        # signal (y)
        rng.uniform(-np.pi, np.pi, N_POINTS),     # phase
        np.full(N_POINTS, 295.0),                 # temperature
        np.full(N_POINTS, 9.4e9),                 # frequency
        np.arange(N_POINTS, dtype=np.float64),    # time
    ]
    rows = np.stack(cols, axis=1)
    with open(path, "w") as f:
        f.write(_HEADER + "\n")
        for row in rows:
            f.write("\t".join(f"{v:.16E}" for v in row) + "\n")
    return path


def flagship_walker(n_walkers: int, *, seed: int = 0, data_seed: int = 0,
                    dtype=None, config=None):
    """The test.lisp walker on the generated data, from its cold start."""
    from .fit import walker_create
    from .models import lorder_mixed_bg

    return walker_create(
        function=lorder_mixed_bg, data=flagship_data(data_seed),
        params=START, data_error=SIGMA, n_walkers=n_walkers, seed=seed,
        walker_jitter=0.05, dtype=dtype, config=config)
