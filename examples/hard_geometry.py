"""Curved posteriors: the round-3 hard-geometry toolchain in one arc.

Some posteriors are hard not because they are high-dimensional or
expensive but because they are BENT — a curved ridge (here the classic
banana: one parameter's location depends quadratically on another)
defeats every Gaussian summary at once: the adapted proposal L, the
Laplace/ADVI evidence, and any ellipse-shaped credible region.

The arc, using only public verbs:

1. fit + audit      — the random walk samples it fine, but the audit's
                      calibration checks are clean while the GAUSSIAN
                      evidence reads biased: `advi` reports a low ELBO
                      with Pareto-k near/over 0.7 (the "my family is
                      too small" flag).
2. flow upgrade     — `flow_advi` bends a RealNVP to the curvature:
                      ELBO rises by the KL the Gaussian was losing,
                      Pareto-k drops, and its IS evidence now agrees
                      with the ladder estimator (the banana here has a
                      CLOSED-FORM evidence to check against).
3. self-tuning HMC  — `sampling_steps(kernel="chees")`: ChEES-HMC finds
                      the trajectory length on its own (NUTS's job, done
                      the batched-hardware way); `chees_trajectory()`
                      shows what it chose.
4. NeuTra sampling  — `flow.neutra_sample` runs the kernel in the
                      flow's LATENT space, where the banana looks like
                      N(0,I): near-iid mixing, exact samples, no
                      importance weights.
5. chain the result — `flow.seed_walker` restarts the ensemble from the
                      flow for instant posterior-shaped starts.

Run: ``python examples/hard_geometry.py`` (CPU-friendly, ~3 min).
"""

import math
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

# Honor LISP_MCMC_PLATFORM / JAX_PLATFORMS (examples/_common.py).
from _common import phase, setup_platform  # noqa: E402

setup_platform()
import jax  # noqa: E402
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import numpy as np

import lisp_mcmc_tpu as mfit

# ----------------------------------------------------------------------
# The target: t1 ~ N(0,1), t2 | t1 ~ N(t1^2, 0.25^2) under a uniform box
# prior.  A volume-preserving shear of a Gaussian, so the exact evidence
# is known: log Z = log(2 pi sigma1 sigma2) - log V_box.
# ----------------------------------------------------------------------
BOUNDS = {"t1": (-6.0, 6.0), "t2": (-2.0, 10.0)}
TRUTH = math.log(2 * math.pi * 1.0 * 0.25) - math.log(12.0 * 12.0)


def model(x, p):
    return jnp.zeros_like(x)


def loglik(fn, params, dataset):
    t1, t2 = params["t1"], params["t2"]
    return -0.5 * t1 ** 2 - 0.5 * ((t2 - t1 ** 2) / 0.25) ** 2


def main():
    w = mfit.walker_create(
        function=model, data=([0.0, 1.0], [0.0, 0.0]),
        params={"t1": 0.5, "t2": 0.5}, log_likelihood=loglik,
        n_walkers=512, seed=0, walker_jitter=0.5,
        log_prior=mfit.make_bounds_prior(BOUNDS))

    # -- 1. fit; the Gaussian family flags itself -----------------------
    w.adaptive_steps(6000, temperature=2.0, auto=None)
    g = w.advi(n_steps=1500, seed=1)
    print(f"[1] Gaussian ADVI : elbo={g.elbo:+.3f}  log_z={g.log_z:+.3f} "
          f"(truth {TRUTH:+.3f})  pareto_k={g.pareto_k:.2f}")
    print(f"    -> biased {g.log_z - TRUTH:+.3f} nats: the ELBO gap IS "
          "the KL to the best Gaussian; k near 0.7 says 'family too small'")

    # -- 2. bend a flow to the curvature --------------------------------
    fv = w.flow_advi(seed=1)
    print(f"[2] flow ADVI     : elbo={fv.elbo:+.3f}  log_z={fv.log_z:+.3f} "
          f"(truth {TRUTH:+.3f})  pareto_k={fv.pareto_k:.2f}  "
          f"trust={fv.converged_evidence}")
    s = fv.sample(4000, seed=2)
    curv = np.polyfit(s[:, 0], s[:, 1], 2)[0]
    print(f"    -> learned quadratic ridge coefficient {curv:.2f} (true 1.0)")

    # cross-check against the tempering-ladder estimator
    ev = w.log_evidence(n_steps=6000, rungs=8, t_max=30.0)
    print(f"    ladder evidence {ev.log_z:+.3f} +- {ev.error:.3f} "
          f"(tail={ev.tail:+.2f}: the prior-MC closure measured the "
          "evidence mass below the hottest rung instead of assuming it)")

    # -- 3. ChEES-HMC: trajectory length found, not guessed -------------
    w.reset_to_most_likely()
    w.adaptive_steps(2000, temperature=1.0, auto=None)   # re-spread
    w.sampling_steps(4000, kernel="chees")
    tr = w.chees_trajectory()
    print(f"[3] ChEES-HMC     : acceptance={w.acceptance():.2f}  adapted "
          f"trajectory={tr['leapfrog'][0]:.1f} leapfrog steps "
          f"(budget {tr['budget']}, at_cap={tr['at_cap']})")
    if tr["at_cap"]:
        print("    at_cap=True is the tuning signal: the bent ridge wants "
              "longer trajectories — raise chees_max_leapfrog to buy them")
    pos, _ = w.steps(take=2000)
    curv_mcmc = np.polyfit(pos[:, 0], pos[:, 1], 2)[0]
    print(f"    MCMC ridge coefficient {curv_mcmc:.2f} — kernel follows "
          "the bend the flow learned to describe")

    # -- 4. NeuTra: sample in the flow's latent space -------------------
    # The flow is more than a density: it is a TRANSPORT.  Running the
    # kernel on eps with target log p(T(eps)) + log|det dT| makes the
    # banana look like N(0, I) — near-iid mixing, every mapped point an
    # exact posterior sample, no importance weights.
    res = fv.neutra_sample(w, n_steps=2000, kernel="mala", n_walkers=128)
    T, W, _ = res.samples_by_step.shape
    print(f"[4] NeuTra         : acceptance={res.acceptance:.2f}  min-ESS "
          f"{res.min_ess():.0f} of {T * min(W, 64)} chain samples "
          f"({100 * res.min_ess() / (T * min(W, 64)):.0f}% of iid) — "
          f"ridge coefficient "
          f"{np.polyfit(res.samples[:, 0], res.samples[:, 1], 2)[0]:.2f}")

    # -- 5. chain: the flow is an artifact, not a one-off ---------------
    fv.seed_walker(w, seed=3)
    print(f"[5] seeded ensemble logprob mean "
          f"{float(np.mean(np.asarray(w.state.logprob))):.2f} — the flow "
          "IS the warm start for the next experiment")
    import tempfile
    path = tempfile.mktemp(suffix=".npz")
    fv.save(path)
    fv2 = mfit.load_flow(path, w)
    same = np.array_equal(fv.sample(64, seed=4), fv2.sample(64, seed=4))
    print(f"    checkpointed transport reloads bitwise: {same} — train "
          "once per model, reuse across sessions")


if __name__ == "__main__":
    main()
