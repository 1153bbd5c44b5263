"""The reference's demo script (test.lisp), end to end.

Every step of the reference's test.lisp has a working equivalent here:
file discovery (test.lisp:10), ingestion (12), single-dataset fit + plots
+ derived quantity (14-31), save/load round trip (38-49, which the
reference only documents in comments), and the two-dataset global fit
with shared parameters (52-78).

Run: ``python examples/reference_journey.py [data-file]``
(without a file, the flagship data is generated in the reference file
format by ``lisp_mcmc_tpu.flagship``).
"""

import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from _common import phase, setup_platform  # noqa: E402

setup_platform()

import numpy as np

import lisp_mcmc_tpu as mfit
from lisp_mcmc_tpu import diagnostics, plotting
from lisp_mcmc_tpu.checkpoint import walker_load, walker_save
from lisp_mcmc_tpu.models import lorder_mixed_bg


def find_data() -> str:
    # argv only counts when it points at a real file (under pytest the
    # first argument is the test path, not a dataset).
    if len(sys.argv) > 1 and os.path.isfile(sys.argv[1]):
        return sys.argv[1]
    from lisp_mcmc_tpu.flagship import write_flagship_table

    return write_flagship_table(
        os.path.join(tempfile.mkdtemp(prefix="mfit_"), "example-data.xls"))


def ingest_and_fit(n_steps: int = 30000, n_walkers: int = 1024,
                   path: str | None = None):
    """Phase 1 (test.lisp:10-25): ingestion + the single-dataset fit.

    Exposed as a function so the smoke test (tests/test_examples_smoke
    .py) can drive it with a tiny budget; returns (table, x, y, walker).
    """
    with phase("ingest example data (test.lisp:10-12)"):
        path = path or find_data()
        table = mfit.read_file_data(path)
        x, y = mfit.create_walker_data(table, 1, 4)
        print(f"loaded {path}: {len(table)} columns x {len(x)} rows")

    with phase(f"single-dataset fit, {n_steps} steps (test.lisp:14-25)"):
        walker = mfit.walker_create(
            function=lorder_mixed_bg,
            data=(x, y),
            params={"scale": 1e-5, "linewidth": 7, "x0": 2200, "mix": 0.9,
                    "bg0": 1e-7, "bg1": 1e-9},
            data_error=1e-7,
            n_walkers=n_walkers,
            walker_jitter=0.05,
        )
        walker.adaptive_steps(n_steps, temperature=10.0)
        print(diagnostics.summary(walker))
        # expected most-likely log-posterior ~4646.756+ (test.lisp:26-30)
    return table, x, y, walker


def main(n_steps: int = 30000, n_walkers: int = 1024):
    mfit.enable_compilation_cache()
    table, x, y, walker = ingest_and_fit(n_steps, n_walkers)

    # -- plots + derived quantity (test.lisp:25-31) ----------------------
    out = tempfile.mkdtemp(prefix="mfit_")
    with phase("plots + derived quantity (test.lisp:25-31)"):
        plotting.plot_data_and_fit(walker, filename=os.path.join(out, "fit.png"))
        plotting.plot_residuals(walker, filename=os.path.join(out, "residuals.png"))
        plotting.caterpillar_plots(walker, filename=os.path.join(out, "traces.png"))
        plotting.likelihood_plot(walker, filename=os.path.join(out, "trace_lp.png"))
        plotting.all_corner_plots(walker, filename=os.path.join(out, "corner.png"))
        q_factor = mfit.walker_with_expression(walker, "(/ :linewidth :x0)")
        print(f"linewidth/x0 = {q_factor:.6g}  (walker-with-exp, test.lisp:31)")

    with phase("save/load round trip (test.lisp:38-49)"):
        ckpt = os.path.join(out, "walker.npz")
        walker_save(walker, ckpt)
        reloaded = walker_load(ckpt)
        reloaded.adaptive_steps(min(2000, n_steps), auto=None)  # resumable mid-run
        print(f"reloaded fit best lp: {reloaded.most_likely_step()[0]:.3f}")

    # -- global two-dataset fit with shared params (test.lisp:52-78) -----
    # The reference shares linewidth/x0/mix between the two columns and
    # gives the second dataset its OWN amplitude/background (scale2,
    # bg02, bg12 via the lorder-mixed-bg2 wrapper, test.lisp:54-55).
    def lorder_mixed_bg2(x_, p):
        return lorder_mixed_bg(x_, {
            "scale": p["scale2"], "linewidth": p["linewidth"],
            "x0": p["x0"], "mix": p["mix"],
            "bg0": p["bg02"], "bg1": p["bg12"],
        })

    with phase("global two-dataset fit (test.lisp:52-78)"):
        x2, y2 = mfit.create_walker_data(table, 1, 5)
        global_fit = mfit.mcmc_fit(
            function=[lorder_mixed_bg, lorder_mixed_bg2],
            data=[(x, y), (x2, y2)],
            params={"scale": 1e-6, "linewidth": 100, "x0": 2700, "mix": 0.1,
                    "bg0": 1e-7, "bg1": 1e-10,                   # dataset 1 own
                    "scale2": 1e-8, "bg02": 1e-7, "bg12": 1e-10},  # dataset 2 own
            data_error=[1e-7, 1e-7],
            n_steps=n_steps,
            n_walkers=n_walkers,
        )
        print(f"global fit after anneal: lp = {global_fit.most_likely_step()[0]:.1f}")

    with phase("multi-start Adam polish"):
        # The 9-parameter joint posterior anneals into the right basin but
        # needs gradient polish to reach the optimum (the reference ran
        # 100k steps here; multi-start Adam gets there in a fraction).
        global_fit.optimize(400, rounds=4)
        best = global_fit.most_likely_params()
        print("global fit shared params:",
              {k: round(float(best[k]), 4) for k in ("linewidth", "x0", "mix")})
        # (The lorder lineshape is sign-symmetric in linewidth with a
        # compensating mix flip, so mirror labelings are equivalent fits.)
        print(f"global fit after polish: lp = {global_fit.most_likely_step()[0]:.1f}")
    print(f"figures in {out}")


if __name__ == "__main__":
    main()
