"""NV-center magnetometry pipeline (reference C22, nv-specific.lisp).

Rebuilds the domain layer end to end:
  - data loaders: per-column spectrum separation (``nv-data->separated``,
    nv-specific.lisp:5-6) and directory ingestion with ';' delimiters
    (``nv-dir->data``, 8-10)
  - NV likelihood (12-19).  NOTE the reference passes ``(log-normal model
    error y)`` — argument order swaps sigma and y so the *y value* is used
    as the standard deviation (SURVEY §2.2); this rebuild implements the
    intended behavior (y ~ Normal(model, error)).
  - physics prior (21-34): box bounds on scales/mus/sigma/bg plus hard
    constraints mu1 < mu2, mu2 - mu1 >= 6 MHz, 0.9 < scale1/scale2 < 1.1,
    each at -1e9.
  - noise estimate from the quieter of the first/last deciles (36-41)
  - parameter auto-guess (43-48)
  - per-spectrum walker factory + batch drivers (50-66)
  - field-offset derived quantity (68-69): (mu2 - mu1) / 2 / 2.8 Oe
  - scan-grid export + heatmap (76-105)

Scaling redesign (SURVEY §3.4): the reference fits k spectra
*sequentially* (k x wall time); here same-length spectra stack into a
``(S, P)`` batch fitted as ONE ensemble of S x W walkers with per-spectrum
adaptation groups — the "1e5+ parallel walkers sharded across chips"
configuration of BASELINE.json.
"""

from __future__ import annotations

import numpy as np

import jax

from .batched import BatchedFit
from .hierarchical import HierarchicalFit
from .fit import Walker, walker_create
from .io import get_filename, read_file_data
from .likelihoods import log_likelihood_normal
from .priors import constraint_penalty, make_bounds_prior
from .expressions import walker_with_expression
from .models import double_lorentzian_bg
from .walker_set import WalkerSet

__all__ = [
    "nv_data_separated",
    "nv_dir_data",
    "log_prior_nv",
    "make_nv_prior",
    "nv_data_std_dev",
    "guess_nv_params",
    "nv_walker",
    "fit_nv_file",
    "fit_nv_dir",
    "BatchedNVFit",
    "HierarchicalNVFit",
    "fit_nv_spectra_batched",
    "walker_field_offset",
    "export_scan_grid",
]

FIELD_OFFSET_EXPRESSION = "(/ (- :mu2 :mu1) 2 2.8)"  # nv-specific.lisp:68-69


def nv_data_separated(table):
    """Split a multi-column table into (x, y_i) spectra
    (``nv-data->separated``, nv-specific.lisp:5-6)."""
    x = np.asarray(table[0], dtype=np.float64)
    return [(x, np.asarray(y, dtype=np.float64)) for y in table[1:]]


def nv_dir_data(directory: str):
    """All spectra from every file in a directory, ';'-delimited
    (``nv-dir->data``, nv-specific.lisp:8-10)."""
    spectra = []
    for path in get_filename(directory):
        spectra.extend(nv_data_separated(read_file_data(path, delim=";")))
    return spectra


def _nv_constraints(p, pens, ds):
    """Hard physics constraints (nv-specific.lisp:31-34)."""
    return (
        constraint_penalty(p["mu1"] <= p["mu2"])
        + constraint_penalty(p["mu2"] - p["mu1"] >= 6.0)
        + constraint_penalty(
            (0.9 < p["scale1"] / p["scale2"]) & (p["scale1"] / p["scale2"] < 1.1)
        )
    )


# Physics prior (nv-specific.lisp:21-34): the reference's exact boxes and
# constraints.  NOTE these amplitude boxes assume the reference lab's y
# units (backgrounds below 1e-5); the pipeline factories below default to
# make_nv_prior(y), which rescales them to the actual spectrum.
log_prior_nv = make_bounds_prior(
    {
        "scale1": (1e-5, 1e1),
        "scale2": (1e-5, 1e1),
        "mu1": (2850, 2870),
        "mu2": (2870, 2890),
        "sigma": (9, 20),
        "bg0": (0, 1e-5),
    },
    extra=_nv_constraints,
)
log_prior_nv.__name__ = "log_prior_nv"  # stable name for checkpoints


def _nv_boxes(y) -> dict:
    """The reference physics boxes (nv-specific.lisp:21-34), amplitude
    entries rescaled to the spectrum's y units — the ONE definition
    every NV prior path shares (make_nv_prior, HierarchicalNVFit)."""
    y = np.asarray(y, dtype=np.float64)
    contrast = max(float(y.max() - y.min()), 1e-300)
    spread = 5.0 * contrast
    return {
        "scale1": (1e-3 * contrast, 1e3 * contrast),
        "scale2": (1e-3 * contrast, 1e3 * contrast),
        "mu1": (2850.0, 2870.0),
        "mu2": (2870.0, 2890.0),
        "sigma": (9.0, 20.0),
        "bg0": (float(y.min()) - spread, float(y.max()) + spread),
    }


def _require_shared_grid(spectra, who: str):
    x0 = np.asarray(spectra[0][0], dtype=np.float64)
    for x, _ in spectra:
        if len(x) != len(x0) or not np.allclose(x, x0):
            raise ValueError(
                f"{who} requires a shared frequency grid (its scan-grid "
                "exports/heatmaps assume one); for ragged spectra use "
                "fit_nv_file per file, or a plain BatchedFit (which "
                "pads ragged batches)")


def make_nv_prior(y=None):
    """NV prior with amplitude boxes scaled to the spectrum's units.

    The mu/sigma boxes are physical (MHz) and stay fixed; scale1/scale2/
    bg0 are in y units, so the reference's literal boxes (tuned to its
    lab files, backgrounds < 1e-5) would reject any normalized spectrum
    — its own auto-guess included.  With ``y`` the boxes span generous
    multiples of the observed contrast/background; without ``y`` this is
    exactly :data:`log_prior_nv`.
    """
    if y is None:
        return log_prior_nv
    return make_bounds_prior(_nv_boxes(y), extra=_nv_constraints)


def nv_data_std_dev(y) -> float:
    """Noise estimate: the quieter of the first/last deciles of the trace
    (``nv-data-std-dev``, nv-specific.lisp:36-41)."""
    y = np.asarray(y, dtype=np.float64)
    k = max(1, len(y) // 10)
    sd = float(min(np.std(y[:k]), np.std(y[-k:])))
    if sd > 0.0:
        return sd
    # A constant decile (clipped/quantized baseline, noiseless synthetic
    # data) would give sigma = 0 -> inf inv_sigma -> non-finite posterior
    # and a silently frozen fit; floor at a tiny fraction of the signal.
    contrast = float(y.max() - y.min())
    return 1e-6 * contrast if contrast > 0.0 else 1e-12


def guess_nv_params(y) -> dict:
    """Initial parameter guess (``guess-nv-params``, nv-specific.lisp:43-48).

    The reference divides the y-contrast by 4.4d-5 because its (unpublished)
    model normalizes dip depth differently; this rebuild's
    ``double_lorentzian_bg`` expresses scale directly in y units, so the
    guess is the contrast itself.
    """
    y = np.asarray(y, dtype=np.float64)
    contrast = float(y.max() - y.min())
    return {
        "scale1": contrast,
        "scale2": contrast,
        "mu1": 2863.0,
        "mu2": 2873.0,
        "sigma": 10.0,
        "bg0": float(y.max()),
    }


def nv_walker(data, n_walkers: int = 256, seed: int = 0, **kwargs) -> Walker:
    """Single-spectrum walker factory (``nv-walker``, nv-specific.lisp:50-56).

    The prior defaults to :func:`make_nv_prior` scaled to this spectrum's
    y units; pass ``log_prior=...`` to override.
    """
    x, y = data
    return walker_create(
        function=double_lorentzian_bg,
        data=(x, y),
        params=guess_nv_params(y),
        data_error=nv_data_std_dev(y),
        log_likelihood=log_likelihood_normal,
        log_prior=kwargs.pop("log_prior", None) or make_nv_prior(y),
        n_walkers=n_walkers,
        seed=seed,
        walker_jitter=kwargs.pop("walker_jitter", 0.02),
        **kwargs,
    )


def fit_nv_file(filename: str, n_steps: int | None = None, **kwargs) -> WalkerSet:
    """Sequential per-spectrum fits of one file (``file->nv-walkers``,
    nv-specific.lisp:63-66).  Prefer :func:`fit_nv_spectra_batched` for
    throughput."""
    walkers = WalkerSet(nv_walker(d, **kwargs) for d in
                        nv_data_separated(read_file_data(filename, delim=";")))
    walkers.adaptive_steps(n_steps)
    return walkers


def fit_nv_dir(directory: str, n_steps: int | None = None, **kwargs) -> WalkerSet:
    """Sequential fits of every spectrum in a directory
    (``dir->nv-walkers``, nv-specific.lisp:58-61)."""
    walkers = WalkerSet(nv_walker(d, **kwargs) for d in nv_dir_data(directory))
    walkers.adaptive_steps(n_steps)
    return walkers


class BatchedNVFit(BatchedFit):
    """S spectra fitted as one ensemble: the batched walker-set.

    :class:`lisp_mcmc_tpu.batched.BatchedFit` with the NV pipeline's
    defaults: shared-frequency-grid check, per-spectrum noise estimates
    (``nv-data-std-dev``), auto-guessed initial params, and the pooled
    unit-scaled physics prior.  One fit replaces the reference's k
    sequential fits (nv-specific.lisp:60).
    """

    def __init__(self, spectra, walkers_per_spectrum: int = 128, seed: int = 0,
                 model=double_lorentzian_bg, prior=None, dtype=None,
                 config=None, walker_jitter: float = 0.02,
                 log_likelihood=None):
        if len(spectra) == 0:
            raise ValueError("no spectra provided")
        _require_shared_grid(spectra, "BatchedNVFit")
        if prior is None:
            # Amplitude boxes scaled to the pooled y range of all spectra.
            prior = make_nv_prior(np.concatenate(
                [np.asarray(y, np.float64) for _, y in spectra]
            ))
        guesses = [guess_nv_params(y) for _, y in spectra]
        errors = [np.full(len(y), nv_data_std_dev(y)) for _, y in spectra]
        super().__init__(
            model, spectra, guesses, errors,
            log_prior=prior,
            log_likelihood=log_likelihood,
            walkers_per_dataset=walkers_per_spectrum,
            seed=seed, walker_jitter=walker_jitter,
            dtype=dtype, config=config,
        )

    @property
    def n_spectra(self) -> int:
        return self.n_datasets

    @property
    def walkers_per_spectrum(self) -> int:
        return self.walkers_per_dataset

    def best_params_per_spectrum(self):
        """Per-spectrum most-likely params: argmax within each group."""
        return self.best_params_per_dataset()

    def field_offsets(self):
        """Per-spectrum field offset in Oe (``walker-field-offset``,
        nv-specific.lisp:68-69): (mu2 - mu1) / 2 / 2.8."""
        return self.expressions_per_dataset(FIELD_OFFSET_EXPRESSION)


class HierarchicalNVFit(HierarchicalFit):
    """Scan-grid NV fit with partial pooling: the domain entry for the
    middle ground the reference never had.

    ``dir->nv-walkers`` (nv-specific.lisp:58-66) fits every spectrum
    independently; on a real field map the resonance positions (mu1,
    mu2) vary pixel to pixel but the linewidth and background are
    properties of the SAME device — so this fit pools ``("sigma",
    "bg0")`` through a population by default and keeps resonances (and
    dip amplitudes) per pixel.  Sparse/noisy pixels borrow linewidth
    strength from the rest of the grid instead of fending for
    themselves.

    Defaults derive from the NV physics boxes (``make_nv_prior``) and
    the pooled y range: pooled hypers get ``mu ~ Uniform(box)``,
    ``tau ~ LogNormal(log(span/8), 1)``; non-pooled locals get their
    reference box as a Uniform — so the prior is COMPLETE and the whole
    evidence/calibration layer (``nested_sample``, ``reloo``/``kfold``,
    ``sbc_check_hierarchical``) rides with zero extra declarations.
    Override maps MERGE onto the box defaults per key (passing one
    tightened prior never strips the others).  Two documented
    differences vs :func:`make_nv_prior`'s hard boxes: (a) the
    CROSS-parameter constraints (mu2 - mu1 >= 6 MHz, the 0.9-1.1
    scale-ratio band, nv-specific.lisp:31-34) are not a product of 1-D
    distributions and do not enter the pooled prior — the disjoint mu
    boxes still enforce mu1 < mu2, and pooling itself regularizes the
    amplitudes; (b) a POOLED parameter's box bounds its population MEAN
    only — per-pixel values (mu + tau * z) are regularized toward the
    population, not hard-clipped, which is exactly the partial-pooling
    contract.

    ``proposal="auto"`` switches to block-diagonal proposals at walk
    dim >= 96 (~15+ pixels with the default pooling) — the scan-grid
    scaling path (DESIGN.md: 4.17x dense at 256 pixels).
    """

    def __init__(self, spectra, n_walkers: int = 256, seed: int = 0,
                 model=double_lorentzian_bg, pooled=("sigma", "bg0"),
                 hyper=None, local_priors=None, dtype=None, config=None,
                 log_likelihood=None, proposal: str = "auto",
                 correlation: str = "diag", corr_prior=None):
        from .priors import LogNormal, Uniform

        if len(spectra) < 2:
            raise ValueError("HierarchicalNVFit: need >= 2 spectra to "
                             "pool (one spectrum has no population)")
        _require_shared_grid(spectra, "HierarchicalNVFit")
        y_all = np.concatenate([np.asarray(y, np.float64)
                                for _, y in spectra])
        boxes = _nv_boxes(y_all)
        # pooled=None keeps the base class's pool-everything semantics.
        pooled = list(boxes) if pooled is None else list(pooled)
        # Both override maps MERGE onto the physics-box defaults (a
        # wholesale replace would silently strip the remaining boxes
        # and, with them, the complete-prior guarantee — review r4s2).
        hyper = dict(hyper or {})
        for p in pooled:
            if p not in hyper and p in boxes:
                lo, hi = boxes[p]
                span = hi - lo
                hyper[p] = (Uniform(lo, hi),
                            LogNormal(float(np.log(span / 8.0)), 1.0))
        local_priors = dict(local_priors or {})
        for k in boxes:
            if k not in pooled and k not in local_priors:
                local_priors[k] = Uniform(*boxes[k])
        guesses = [guess_nv_params(y) for _, y in spectra]
        errors = [np.full(len(y), nv_data_std_dev(y)) for _, y in spectra]
        super().__init__(
            model, spectra, guesses, data_error=errors,
            pooled=pooled, hyper=hyper, local_priors=local_priors,
            log_likelihood=log_likelihood,
            n_walkers=n_walkers, seed=seed, dtype=dtype, config=config,
            proposal=proposal, correlation=correlation,
            corr_prior=corr_prior,
        )

    @property
    def n_spectra(self) -> int:
        return self.n_datasets

    def best_params_per_spectrum(self):
        return self.params_per_dataset("best")

    def field_offsets(self):
        """Per-pixel field offset in Oe (``walker-field-offset``,
        nv-specific.lisp:68-69): (mu2 - mu1) / 2 / 2.8 at the decoded
        per-pixel best params — feed :func:`export_scan_grid` or
        ``plotting.heatmap`` for the field map."""
        return self.expressions_per_dataset(FIELD_OFFSET_EXPRESSION)


def fit_nv_spectra_batched(spectra, n_steps: int | None = None,
                           walkers_per_spectrum: int = 128, **kwargs) -> BatchedNVFit:
    """Fit S spectra as one vectorized ensemble and return the batch."""
    fit = BatchedNVFit(spectra, walkers_per_spectrum=walkers_per_spectrum, **kwargs)
    fit.adaptive_steps(n_steps)
    return fit


def walker_field_offset(walker, take: int | None = 1000) -> float:
    """``walker-field-offset`` (nv-specific.lisp:68-69) for a single fit."""
    return walker_with_expression(walker, FIELD_OFFSET_EXPRESSION, take)


def export_scan_grid(values, row_length: int, filename: str = "./3d-temp-file.txt"):
    """Write (x, y, value) triples in gnuplot scan-grid format
    (``walker-set-make-file-3d-plot-exp``, nv-specific.lisp:76-95):
    row-major positions with a blank line at the end of each row."""
    values = list(values)
    with open(filename, "w") as out:
        for i, v in enumerate(values):
            x = i % row_length
            y = i // row_length
            out.write(f"{float(x)} {float(y)} {float(v)}\n")
            if x == row_length - 1:
                out.write("\n")
    return filename
