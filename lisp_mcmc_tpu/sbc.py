"""Simulation-based calibration: validate the whole fitting pipeline.

SBC (Talts, Betancourt, Simpson, Vehtari & Gelman 2018) is the
end-to-end correctness check for a Bayesian fitting pipeline: draw
parameters from the prior, simulate datasets from them, fit each
dataset, and rank the true parameter among the posterior draws.  If the
sampler targets the right posterior, the ranks are exactly uniform —
*any* defect (a biased kernel, an unburnt anneal phase, a mis-scaled
noise model, a prior/simulator mismatch) shows up as non-uniform ranks
with a characteristic shape (∪ = posterior too narrow, ∩ = too wide,
a slope = biased).

This is a flagship batched-fit workload: the reference could only fit
datasets one at a time (dir->nv-walkers, nv-specific.lisp:58-66), so a
256-simulation calibration study would cost 256 sequential fits; here
all simulated datasets fit as ONE :class:`~lisp_mcmc_tpu.BatchedFit`
ensemble — one chunked kernel, per-dataset adaptation groups — so the
whole study is a single device run.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Mapping

import jax.numpy as jnp
import numpy as np

__all__ = ["SBCResult", "sbc_check", "sbc_check_hierarchical"]


@dataclasses.dataclass(frozen=True)
class SBCResult:
    """Rank statistics from one SBC run.

    ``ranks[i, j]``: rank of simulation i's true parameter j among its
    ``n_draws`` posterior draws (0..n_draws inclusive — uniform over
    ``n_draws + 1`` values when the pipeline is calibrated).
    ``p_values``: per-parameter chi-square uniformity p-value over
    ``n_bins`` rank bins.  ``ok`` applies the usual alpha=0.01 bar
    jointly (Bonferroni across parameters).
    """

    ranks: np.ndarray
    n_draws: int
    n_bins: int
    keys: tuple
    p_values: dict[str, float]
    true_params: np.ndarray   # (n_sims, d) the simulated truths
    # Per-simulation convergence gate (diagnostics.grouped_refit_health):
    # a False entry means that simulation's posterior failed to mix and
    # its rank row is unreliable (kept, loudly warned, marked here —
    # an unmixed sim reads as miscalibration it did not measure).
    sim_ok: np.ndarray | None = None

    @property
    def n_sims(self) -> int:
        return self.ranks.shape[0]

    def ok(self, alpha: float = 0.01) -> bool:
        return all(p > alpha / len(self.keys) for p in self.p_values.values())

    def __repr__(self):
        worst = min(self.p_values, key=self.p_values.get)
        return (f"SBCResult(n_sims={self.n_sims}, n_draws={self.n_draws}, "
                f"ok={self.ok()}, worst p: {worst}="
                f"{self.p_values[worst]:.3g})")


def _bin_masses(n_draws: int, n_bins: int) -> tuple[np.ndarray, np.ndarray]:
    """(edges, per-bin probability mass) over the n_draws+1 integer ranks.

    Equal-width bins over a DISCRETE support do not hold equal mass
    unless ``n_bins`` divides ``n_draws + 1`` (with 64 rank values and
    12 bins, bins hold 5 or 6 ranks — up to 20% off the naive 1/n_bins,
    which measured an 87% false-failure rate at n_sims=2048 on
    perfectly uniform ranks).  The chi-square below therefore always
    uses each bin's exact mass.
    """
    edges = np.linspace(0.0, n_draws + 1.0, n_bins + 1)
    per_rank, _ = np.histogram(np.arange(n_draws + 1) + 0.5, bins=edges)
    return edges, per_rank / float(n_draws + 1)


def _uniformity_pvalue(ranks_j: np.ndarray, n_draws: int, n_bins: int) -> float:
    """Exact-mass chi-square test of rank uniformity."""
    from scipy.stats import chi2

    edges, mass = _bin_masses(n_draws, n_bins)
    counts, _ = np.histogram(ranks_j + 0.5, bins=edges)
    expected = ranks_j.size * mass
    stat = float(np.sum((counts - expected) ** 2 / expected))
    return float(chi2.sf(stat, n_bins - 1))


def _observation_model(simulate, log_likelihood, data_error, x,
                       caller: str = "sbc_check"):
    """Resolve the generative twin of the fit's likelihood.

    Returns ``draw(rng, mu, p_true) -> y`` (host-side, one dataset per
    call).  An explicit ``simulate`` always wins; otherwise the twin is
    derived from ``log_likelihood`` — never guessed, because a
    simulator/likelihood mismatch is precisely the defect SBC exists to
    detect.

    One documented stretch of that contract:
    ``log_likelihood_normal_cutoff`` maps to the PLAIN Gaussian
    simulator.  The cutoff reduction is the Gaussian density with its
    per-point terms clamped at -5000 (mcmc-fitting.lisp:372-380
    semantics) — not a normalized density of its own — and the clamp
    only fires for residuals ~100 sigma out, which simulated-from-truth
    data never produce.  Within SBC's reach the two likelihoods are the
    same observation model; pass ``simulate=`` explicitly to study the
    clamp itself.
    """
    from .likelihoods import (log_likelihood_normal,
                              log_likelihood_normal_cutoff,
                              log_likelihood_poisson)

    if callable(simulate):
        return lambda rng, mu, p: simulate(rng, mu)

    def _sigma():
        if data_error is None:
            raise ValueError(
                f"{caller}: this observation model needs data_error "
                "(the per-point noise scale)")
        return np.broadcast_to(np.asarray(data_error, np.float64),
                               x.shape[:1]).astype(np.float64)

    if log_likelihood is None or log_likelihood in (
            log_likelihood_normal, log_likelihood_normal_cutoff):
        sigma = _sigma()
        return lambda rng, mu, p: mu + sigma * rng.standard_normal(mu.shape)
    if log_likelihood is log_likelihood_poisson:
        # Counts; the NaN floor handles mu <= 0 in the FIT, but the
        # simulator must clip (np.random.poisson rejects negative lam).
        return lambda rng, mu, p: rng.poisson(
            np.clip(mu, 0.0, None)).astype(np.float64)
    sim = getattr(log_likelihood, "_sbc_simulator", None)
    if sim is not None:
        sigma = _sigma()
        return lambda rng, mu, p: sim(rng, mu, sigma, p)
    raise ValueError(
        f"{caller}: no generative twin for likelihood "
        f"{getattr(log_likelihood, '__name__', log_likelihood)!r} — pass "
        "simulate=(rng, mu) -> y matching it (SBC cannot guess the "
        "observation model; a mismatch is what it detects)")


def _rank_study(fit, n_sims: int, B: int, truths, keys, n_draws: int,
                n_bins: int, caller: str) -> SBCResult:
    """Shared run-then-rank epilogue of :func:`sbc_check` and
    :func:`sbc_check_hierarchical`.

    Walker columns map via ``fit.history_block_columns`` (the group-
    aware history invariant) — never raw contiguous slices: today the
    builders zero ``history_walkers`` when retention would subsample,
    but the mapping must not depend on that side condition.  The draw
    index is a plain linspace, deliberately NOT unique-ified: ranks
    live on the 0..n_draws integer support, so exactly ``n_draws``
    draws are required (duplicated indices at short histories keep the
    count right; the shortage guard below keeps them rare).
    """
    from .fit import history_block_columns

    pos, _ = fit._history(None)                       # (T, W, d)
    pos = np.asarray(pos)
    cols = history_block_columns(fit, pos.shape[1])
    t_rows = pos.shape[0]
    if t_rows * B < n_draws:
        raise ValueError(
            f"{caller}: only {t_rows * B} retained draws per "
            f"simulation (need n_draws={n_draws}) — raise n_steps or "
            "lower burn_fraction")
    truths = np.asarray(truths, np.float64)
    d = len(keys)
    ranks = np.empty((n_sims, d), np.int64)
    for i in range(n_sims):
        block = pos[:, cols[i], :].reshape(-1, d)
        idx = np.linspace(0, block.shape[0] - 1, n_draws).astype(int)
        ranks[i] = np.sum(block[idx] < truths[i][None, :], axis=0)
    p_values = {k: _uniformity_pvalue(ranks[:, j], n_draws, n_bins)
                for j, k in enumerate(keys)}
    from .diagnostics import grouped_refit_health

    sim_ok = grouped_refit_health(fit, caller)
    return SBCResult(ranks=ranks, n_draws=n_draws, n_bins=n_bins,
                     keys=keys, p_values=p_values, true_params=truths,
                     sim_ok=sim_ok)


def sbc_check(
    function: Callable,
    bounds: Mapping[str, tuple],
    x,
    data_error=None,
    *,
    n_sims: int = 64,
    walkers_per_dataset: int = 64,
    n_steps: int = 4000,
    temperature: float = 2.0,
    burn_fraction: float = 0.5,
    n_draws: int = 63,
    n_bins: int | None = None,
    seed: int = 0,
    config=None,
    dtype=None,
    simulate: Callable | None = None,
    log_likelihood: Callable | None = None,
    fit=None,
    sampling_steps: int = 0,
    sampling_kernel: str = "mala",
) -> SBCResult:
    """Run an SBC study of the fitting pipeline for one model.

    Draws ``n_sims`` parameter vectors uniformly from ``bounds`` (the
    same bounds become the fit's prior via
    :func:`~lisp_mcmc_tpu.make_bounds_prior` — prior/simulator agreement
    is what SBC checks *given*, so they must match), simulates Gaussian
    datasets ``y = f(x, theta) + data_error * N(0, 1)`` on the shared
    grid ``x``, fits all of them as one :class:`BatchedFit`, and ranks
    each truth among ``n_draws`` thinned posterior draws from its
    walker block.

    ``log_likelihood`` calibrates a NON-Gaussian pipeline end to end:
    the same reduction drives the batched fit (BatchedFit's
    custom-likelihood path) AND selects the matching observation
    simulator — Poisson counts for ``log_likelihood_poisson``, the
    factory's generative twin (``_sbc_simulator``) for student-t /
    noise-scale (whose fitted ``noise_scale`` truth scales the
    simulated noise).  A custom reduction without a generative twin
    must pass ``simulate`` explicitly (a likelihood/simulator MISMATCH
    is exactly what SBC detects, so the pairing is never guessed).

    ``simulate(rng, mu) -> y`` overrides the observation model
    (it must match the likelihood the fit uses).  ``fit`` (a
    constructed-but-unstepped BatchedFit over the simulated datasets)
    overrides the default construction entirely; ``sbc_check`` then
    only drives the stepping and ranking.

    Interpretation: ∪-shaped rank histograms = posterior too narrow
    (e.g. understated ``data_error``), ∩-shaped = too wide, sloped =
    biased.  ``result.p_values`` quantifies per parameter.

    SBC audits the NUMERICS too, not just the algorithm: at extreme
    SNR the f32 default fails the audit where f64 passes
    (measured: the stiff 5-param Lorentzian at data_error=2e-6 on
    y ~ 1e-4 gives worst-p 4.4e-4 under f32, 0.01 under f64 —
    identical settings).  Pass ``dtype=jnp.float64`` (with x64
    enabled) to isolate precision from provisioning.

    ``sampling_steps > 0`` appends a cold gradient-kernel phase after
    the anneal and ranks from THAT history only (anneal rows dropped,
    ``burn_fraction`` applied to the cold phase).  This is the
    production recipe for posteriors with degenerate ridges: on the
    wide-box Lorentzian (scale-bg0 degeneracy at large linewidth) the
    rwm-only audit needs seed luck — measured on one identical truth
    stream at an 18k total budget, rwm-only leaves 20/24 scale ranks
    pinned at the extremes (p = 4e-4: the ensembles never traverse the
    ridge) while anneal 12k + ``sampling_steps=6000`` (mala) spreads
    them to p = 0.04; rwm-only "fixes" it only at 2x the budget and
    still marginally (32k -> p = 0.0046).
    """
    from .batched import BatchedFit
    from .priors import as_prior_spec

    if n_bins is None:
        # >= 5 expected counts per bin keeps the chi-square approximation
        # honest; at tiny n_sims that means FEWER bins, never a floor
        # that undercuts it (n_sims=10 -> 2 bins of 5, not 4 of 2.5).
        n_bins = int(max(2, min(20, n_sims // 5)))
    # ``bounds`` may be a box table or any PriorSpec (named Gaussian /
    # log-normal priors calibrate the same way: truths and guesses draw
    # from the spec, and the fit's prior term is its as_log_prior()).
    spec = as_prior_spec(bounds)
    keys = tuple(spec.keys())
    rng = np.random.default_rng(seed)
    truths = spec.sample(rng, n_sims, keys)

    x = np.asarray(x, np.float64)
    draw_y = _observation_model(simulate, log_likelihood, data_error, x)

    datasets, guesses = [], []
    for i in range(n_sims):
        p_true = dict(zip(keys, truths[i]))
        mu = np.asarray(function(jnp.asarray(x),
                                 {k: jnp.asarray(v) for k, v in p_true.items()}))
        datasets.append((x, draw_y(rng, mu, p_true)))
        # Independent prior draw as the guess: starting AT the truth
        # would mask burn-in defects, which are part of what SBC audits.
        guesses.append(dict(zip(keys, spec.sample(rng, 1, keys)[0])))

    if fit is None:
        fit = BatchedFit(
            function, datasets, guesses, data_error=data_error,
            log_prior=spec.as_log_prior(),
            log_likelihood=log_likelihood,
            walkers_per_dataset=walkers_per_dataset, seed=seed,
            walker_jitter=0.0, config=config, dtype=dtype,
        )
        W = fit.n_walkers
        if fit.config.history_walkers and fit.config.history_walkers < W:
            # Ranks need every dataset block retained in host history;
            # the evenly-spaced walker subsample would cross blocks.
            fit.config = dataclasses.replace(fit.config, history_walkers=0)
    B = fit.walkers_per_dataset

    fit.adaptive_steps(n_steps, temperature=temperature, auto=None)
    if sampling_steps > 0:
        # Rank from a cold gradient-kernel phase: the anneal's job was
        # mode-finding; ridge traversal is the gradient kernel's.
        fit.reset()
        fit.sampling_steps(sampling_steps, kernel=sampling_kernel)
        fit.burn_steps(int(len(fit) * burn_fraction))
    else:
        fit.burn_steps(int(len(fit) * burn_fraction))

    return _rank_study(fit, n_sims, B, truths, keys, n_draws, n_bins,
                       "sbc_check")


def sbc_check_hierarchical(
    function: Callable,
    x,
    params: Mapping,
    n_datasets: int,
    data_error=None,
    *,
    hyper: Mapping,
    pooled=None,
    local_priors: Mapping | None = None,
    n_sims: int = 40,
    walkers_per_sim: int = 32,
    n_steps: int = 4000,
    temperature: float = 2.0,
    burn_fraction: float = 0.5,
    n_draws: int = 63,
    n_bins: int | None = None,
    seed: int = 0,
    config=None,
    dtype=None,
    simulate: Callable | None = None,
    log_likelihood: Callable | None = None,
    sampling_steps: int = 0,
    sampling_kernel: str = "mala",
    correlation: str = "diag",
    corr_prior=None,
) -> SBCResult:
    """SBC for the PARTIAL-POOLING pipeline: calibrate HierarchicalFit
    end to end.

    The procedure is exact SBC over the hierarchical model's WALK-space
    prior — which, by the non-centered construction
    (:class:`~lisp_mcmc_tpu.HierarchicalFit`: coordinates are hypers,
    standardized offsets z, non-pooled locals), is a product of
    independent 1-D distributions.  Per simulation:

    1. draw a walk-space truth from the declared prior — ``mu_p, tau_p``
       from ``hyper``, ``z[s, p] ~ N(0, 1)``, non-pooled locals from
       ``local_priors`` (required for every non-pooled name: SBC needs
       the COMPLETE prior measure);
    2. decode to natural per-dataset parameters
       ``theta[s] = mu + tau * z[s]`` and simulate ``n_datasets``
       datasets on the shared grid ``x`` via the likelihood's generative
       twin (same resolution rules as :func:`sbc_check` — Gaussian /
       Poisson / factory ``_sbc_simulator`` / explicit ``simulate``,
       never guessed);
    3. refit the full joint posterior; rank every walk coordinate among
       its ``n_draws`` posterior draws.

    All ``n_sims`` hierarchical posteriors run as adaptation groups of
    ONE grouped ensemble (``HierarchicalFit._grouped_joint_walker`` —
    the same machinery reloo/kfold refits ride), so the whole study is
    a single chunked program.  Walker starts are INDEPENDENT prior
    draws (starting at the truth would mask burn-in defects).

    Ranking in walk space checks everything that matters for partial
    pooling: non-uniform ``{p}__tau`` ranks expose exactly the
    funnel-region miscalibration where hierarchical samplers fail
    (tau posteriors collapsing toward 0 read as ∩/sloped histograms),
    and ``{p}__z{s}`` ranks catch per-dataset shrinkage bias that
    natural-space theta ranks would smear across mu and tau.

    ``hyper`` must name every pooled parameter explicitly (the
    HierarchicalFit defaults are guess-derived — calibration *given*
    the prior only means something for a declared prior).
    ``sampling_steps > 0`` appends a cold gradient-kernel phase and
    ranks from it only, like :func:`sbc_check` — the production recipe
    here too (tau ridges are gradient-kernel territory; use
    ``sampling_kernel="chees"`` for large grids).

    Returns an :class:`SBCResult` whose keys are the walk-space names
    (``{p}__mu``, ``{p}__tau``, ``{p}__z{s}``, ``{k}__{s}``) and whose
    ``true_params`` are the walk-space truths; decode per-dataset
    natural truths with ``HierarchicalFit.decode_params`` semantics
    (``theta = mu + tau * z``) if needed.
    """
    import jax

    from .batched import BatchedFit
    from .data import Dataset
    from .hierarchical import HierarchicalFit

    S = int(n_datasets)
    x = np.asarray(x, np.float64)
    if n_bins is None:
        n_bins = int(max(2, min(20, n_sims // 5)))

    # Template fit on placeholder data: defines the walk space, decode,
    # prior, padding, and likelihood resolution exactly as the user's
    # production fit would.
    placeholder = [(x, np.zeros_like(x)) for _ in range(S)]
    template = HierarchicalFit(
        function, placeholder, dict(params), data_error=data_error,
        pooled=pooled, hyper=dict(hyper), local_priors=local_priors,
        log_likelihood=log_likelihood, n_walkers=2, seed=seed,
        dtype=dtype, config=config, correlation=correlation,
        corr_prior=corr_prior)
    if template.prior_spec is None:
        raise ValueError(
            "sbc_check_hierarchical: the prior is incomplete — declare "
            "local_priors for every non-pooled parameter (SBC draws "
            "truths from the full declared prior)")
    keys = template.spec.keys
    rng = np.random.default_rng(seed)
    truths = template.prior_spec.sample(rng, n_sims, keys)   # walk space
    nat = template._decode_np(np.asarray(truths, np.float64))  # (n, S, dl)

    local_keys = template.local_spec.keys
    n_max = len(x)
    # Per-DATASET error lists are first-class for the fit (the template
    # normalizes them), so the simulator must see the same per-dataset
    # sigmas — one observation model per dataset, never the raw list
    # (whose shape _observation_model would misread as per-point).
    if data_error is None:
        errors = [None] * S
        draw_ys = [_observation_model(simulate, log_likelihood, None, x,
                                      caller="sbc_check_hierarchical")] * S
    else:
        errors = BatchedFit._normalize_errors(
            data_error, [(x, np.zeros_like(x))] * S)
        draw_ys = [_observation_model(simulate, log_likelihood, errors[s],
                                      x, caller="sbc_check_hierarchical")
                   for s in range(S)]

    blocks = []
    for i in range(n_sims):
        dsets = []
        for s in range(S):
            p_true = dict(zip(local_keys, nat[i, s]))
            mu = np.asarray(function(
                jnp.asarray(x), {k: jnp.asarray(v) for k, v in p_true.items()}))
            y = draw_ys[s](rng, mu, p_true)
            dsets.append(Dataset.create(x, y, errors[s],
                                        dtype=template.dtype,
                                        min_len=n_max))
        blocks.append(jax.tree_util.tree_map(
            lambda *a: jnp.stack(a), *dsets))
    stacked = jax.tree_util.tree_map(lambda *a: jnp.stack(a), *blocks)
    refit_data = {"ds": stacked}                             # (n_sims, S, N)

    B = walkers_per_sim
    pos0 = template.prior_spec.sample(rng, n_sims * B, keys)
    fit = template._grouped_joint_walker(
        refit_data, n_sims, B, seed, np.asarray(pos0), config=config)

    fit.adaptive_steps(n_steps, temperature=temperature, auto=None)
    if sampling_steps > 0:
        fit.reset()
        fit.sampling_steps(sampling_steps, kernel=sampling_kernel)
        fit.burn_steps(int(len(fit) * burn_fraction))
    else:
        fit.burn_steps(int(len(fit) * burn_fraction))

    return _rank_study(fit, n_sims, B, truths, keys, n_draws, n_bins,
                       "sbc_check_hierarchical")
