"""Shared example plumbing: platform knob + phase progress markers.

Every example calls :func:`setup_platform` before touching jax and
wraps its major steps in :class:`phase` so a long run is visibly alive
(VERDICT r4 #7: the flagship journey printed nothing for minutes).

Platform knob: ``LISP_MCMC_PLATFORM=cpu python examples/<name>.py``
forces the CPU backend (as ``JAX_PLATFORMS=cpu`` does).
"""

import os
import time


def setup_platform():
    plat = os.environ.get("LISP_MCMC_PLATFORM")
    if plat:
        import jax

        jax.config.update("jax_platforms", plat)


_T0 = time.time()


class phase:
    """``with phase("anneal"): ...`` prints timestamped start/done
    lines so long-running examples are visibly alive."""

    def __init__(self, label: str):
        self.label = label

    def __enter__(self):
        print(f"[{time.time() - _T0:7.1f}s] >> {self.label}", flush=True)
        self._t = time.time()
        return self

    def __exit__(self, exc_type, exc, tb):
        status = "done" if exc_type is None else "FAILED"
        print(f"[{time.time() - _T0:7.1f}s] << {self.label} {status} "
              f"({time.time() - self._t:.1f}s)", flush=True)
        return False
