"""Vectorized walker sets: fit S same-shape datasets as ONE ensemble.

The reference's only many-fits notion is a Lisp list of walkers advanced
sequentially (``dir->nv-walkers``, nv-specific.lisp:58-66): k datasets
cost k full fits of wall time.  This module is the batched walker-set —
the generalization of that pattern to a single ensemble:

  - S datasets stack into ``(S, P)`` arrays (shared static shape);
  - the ensemble has ``S * walkers_per_dataset`` walkers, ordered so each
    dataset owns one contiguous block;
  - each dataset is its own *adaptation group* (per-group proposal
    covariance, acceptance window, and annealing state share the kernel's
    reshape fast path — see kernel.py);
  - the posterior evaluates the whole batch with zero per-walker data
    gathers (positions reshape to ``(S, B, d)`` against ``(S, P)`` data).

``BatchedFit`` is model-agnostic and likelihood-agnostic: the default
Gaussian reduction runs a specialized z-sum hot path against the cached
per-dataset constants (no per-step divides/logs), and any other library
or factory likelihood (student-t, noise-scale, Poisson, x-error,
``create_log_likelihood_function``) runs through a stacked-``Dataset``
vmap path that evaluates the SAME ``likelihood(fn, params, dataset)``
contract the single-fit :class:`~lisp_mcmc_tpu.fit.Walker` uses.  The NV
pipeline's :class:`lisp_mcmc_tpu.nv.BatchedNVFit` is this class plus
domain defaults.
"""

from __future__ import annotations

from typing import Callable, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from .data import Dataset
from .fit import Walker, _Term
from .likelihoods import log_likelihood_normal
from .params import ParamSpec
from .priors import log_prior_flat

__all__ = ["BatchedFit"]


class _DatasetView:
    """Read-only single-dataset facade over one BatchedFit walker block.

    Exposes exactly the surface the predictive toolchain dispatches on
    (``steps``/``spec``/``dtype``/``terms``, no group_ids, no custom
    posterior), with history columns mapped through the retained
    walker-subsample when one is active — so ``diagnostics.waic/loo``
    and ``predictive.posterior_predictive`` run unmodified per dataset.
    """

    group_ids = None
    _custom_log_post = None
    _custom_batched = None

    def __init__(self, fit: "BatchedFit", s: int):
        import dataclasses

        self.spec = fit.spec
        self.dtype = fit.dtype
        self.terms = [dataclasses.replace(fit.terms[0],
                                          dataset=fit._datasets[s])]
        self._fit = fit
        self._s = s

    def _history(self, take=None):
        """Block-sliced (T, B_s, d) history — the view is one population,
        so walker-level diagnostics (convergence/_history_blocks, hence
        ``audit``) run on it unmodified."""
        from .fit import history_block_columns

        pos, lp = self._fit._history(take)
        # Width-aware mapping: the history may hold the full ensemble,
        # the retained subsample, or (no rows collected) the live-state
        # fallback — history_block_columns resolves which.
        cols = np.asarray(
            history_block_columns(self._fit, pos.shape[1])[self._s])
        return np.asarray(pos)[:, cols, :], np.asarray(lp)[:, cols]

    def steps(self, take=None):
        pos, lp = self._history(take)
        return pos.reshape(-1, pos.shape[-1]), lp.reshape(-1)

    def most_likely_params(self) -> dict:
        """The BLOCK's own best params (refit seeds: reloo/kfold on a
        view) — the batch-global argmax could be another dataset's
        optimum (same trap reset_to_most_likely guards against)."""
        return self._fit.best_params_per_dataset()[self._s]


class BatchedFit(Walker):
    """S independent fits as one ``(S*B, d)`` walker ensemble.

    ``function``: one model ``f(x, params) -> y`` shared by all datasets.
    ``datasets``: list of ``(x, y)`` pairs — lengths and x grids may
    differ (ragged batches pad to the longest dataset's lane-aligned
    shape; each dataset's mask keeps its reduction exact, and the
    per-dataset toolchain reports true lengths).  ``params``: one guess
    dict (shared) or a list of per-dataset guess dicts.  ``data_error``:
    scalar, per-dataset scalars, or per-point arrays.  ``log_prior``:
    one prior callable or :class:`~lisp_mcmc_tpu.PriorSpec`, applied per
    walker (with ``dataset=None``).  ``log_likelihood``: any library or
    factory dataset reduction (default: the Gaussian
    ``log_likelihood_normal``, which keeps the specialized z-sum hot
    path); a data-dependent likelihood factory (``log-liklihood-fixer``
    semantics, mcmc-fitting.lisp:842-845) resolves ONCE against dataset
    0 — batched fits share one compiled posterior, so per-dataset
    specialization is not supported.
    """

    def __init__(
        self,
        function: Callable,
        datasets: Sequence,
        params,
        data_error=None,
        *,
        log_prior: Callable | None = None,
        log_likelihood: Callable | None = None,
        walkers_per_dataset: int = 128,
        seed: int = 0,
        walker_jitter: float = 0.02,
        dtype=None,
        config=None,
    ):
        from .fit import default_dtype

        dtype = dtype or default_dtype()
        S = len(datasets)
        if S == 0:
            raise ValueError("no datasets provided")
        if hasattr(log_prior, "as_log_prior"):   # PriorSpec / MVGaussian
            log_prior = log_prior.as_log_prior()
        prior = log_prior or log_prior_flat

        guesses = params if isinstance(params, (list, tuple)) else [params] * S
        if len(guesses) != S:
            raise ValueError(f"{len(guesses)} parameter guesses for {S} datasets")
        errors = self._normalize_errors(data_error, datasets)

        # One Dataset per input — padding, masking, and the cached
        # likelihood constants all come from the single source of truth
        # (Dataset.create / __post_init__); the batch is just their stack.
        # Ragged inputs are fine: every dataset pads to the batch maximum
        # (min_len) so the stack is one static shape, and the per-dataset
        # masks keep each reduction exact (padded lanes carry
        # inv_sigma = 0 and masked constants — they contribute nothing).
        n_max = max(len(np.asarray(d[0])) for d in datasets)
        dsets = [Dataset.create(x, y, err, dtype=dtype, min_len=n_max)
                 for (x, y), err in zip(datasets, errors)]

        spec = ParamSpec.from_params(guesses[0])
        self.n_datasets = S
        self.walkers_per_dataset = walkers_per_dataset

        if log_likelihood is not None \
                and log_likelihood is not log_likelihood_normal:
            # Data-dependent factory resolution (reference 842-845): once,
            # against dataset 0 (one compiled posterior for the batch).
            from .likelihoods import resolve_likelihood

            likelihood = resolve_likelihood(
                log_likelihood, function, guesses[0], dsets[0])
        else:
            likelihood = log_likelihood_normal

        if likelihood is log_likelihood_normal:
            batch_data = {
                "x": jnp.stack([ds.x for ds in dsets]),              # (S, P)
                "y": jnp.stack([ds.y for ds in dsets]),              # (S, P)
                "inv_sigma": jnp.stack([ds.inv_sigma for ds in dsets]),
                "const": jnp.stack([ds.log_norm_const for ds in dsets]),  # (S,)
            }

            def log_post(theta, dataset_idx, data):
                """Per-walker posterior (diagnostics path)."""
                p = spec.unflatten(theta)
                mu = function(data["x"][dataset_idx], p)
                z = (data["y"][dataset_idx] - mu) * data["inv_sigma"][dataset_idx]
                return data["const"][dataset_idx] - 0.5 * jnp.sum(z * z) + prior(p, None)

            def batched_log_post(positions, data):
                """Hot path: reshape to (S, B, d); no per-walker gathers."""
                pos_s = positions.reshape(S, walkers_per_dataset, -1)

                def per_dataset(theta_block, x, y, inv_sig, const):
                    def one(theta):
                        p = spec.unflatten(theta)
                        z = (y - function(x, p)) * inv_sig
                        return const - 0.5 * jnp.sum(z * z) + prior(p, None)

                    return jax.vmap(one)(theta_block)

                lps = jax.vmap(per_dataset)(
                    pos_s, data["x"], data["y"], data["inv_sigma"], data["const"]
                )
                return lps.reshape(positions.shape[0])
        else:
            # Custom-likelihood path: stack the per-dataset Dataset pytrees
            # into ONE Dataset whose every data field carries a leading S
            # axis, then vmap the single-fit likelihood contract over it.
            # The stack keeps the (G, B, ...) reshape fast path (CLAUDE.md
            # invariant — no per-walker dataset gathers in the hot block)
            # and rides through jit as an ARGUMENT like every dataset here.
            # The static meta `n` is per-dataset host metadata the compute
            # path never reads (reductions are mask-exact); the stacked
            # pytree records the padded length, and the per-dataset
            # toolchain reads true lengths from `self._datasets`.
            batch_data = {"ds": Dataset(
                x=jnp.stack([ds.x for ds in dsets]),
                y=jnp.stack([ds.y for ds in dsets]),
                sigma=jnp.stack([ds.sigma for ds in dsets]),
                mask=jnp.stack([ds.mask for ds in dsets]),
                n=int(dsets[0].x.shape[0]),
                inv_sigma=jnp.stack([ds.inv_sigma for ds in dsets]),
                log_norm_const=jnp.stack([ds.log_norm_const for ds in dsets]),
                log_norm_const_point=jnp.stack(
                    [ds.log_norm_const_point for ds in dsets]),
                log_fact_y=jnp.stack([ds.log_fact_y for ds in dsets]),
            )}

            def log_post(theta, dataset_idx, data):
                """Per-walker posterior (diagnostics path): gather slice s."""
                p = spec.unflatten(theta)
                ds_s = jax.tree_util.tree_map(
                    lambda a: a[dataset_idx], data["ds"])
                return likelihood(function, p, ds_s) + prior(p, None)

            def batched_log_post(positions, data):
                """Hot path: (S, B, d) blocks against the stacked Dataset."""
                pos_s = positions.reshape(S, walkers_per_dataset, -1)

                def per_dataset(theta_block, ds_s):
                    def one(theta):
                        p = spec.unflatten(theta)
                        return likelihood(function, p, ds_s) + prior(p, None)

                    return jax.vmap(one)(theta_block)

                lps = jax.vmap(per_dataset)(pos_s, data["ds"])
                return lps.reshape(positions.shape[0])

        group_ids = np.repeat(np.arange(S, dtype=np.int32), walkers_per_dataset)
        init = np.stack([
            np.asarray([float(g[k]) for k in spec.keys], np.float64) for g in guesses
        ])
        positions = np.repeat(init, walkers_per_dataset, axis=0)  # (W, d)

        # Representative dataset (index 0) for plotting/term APIs; the
        # full list backs the per-dataset predictive views.
        ds0 = dsets[0]
        self._datasets = dsets

        super().__init__(
            terms=[_Term(fn=function, dataset=ds0,
                         likelihood=likelihood, prior=prior)],
            spec=spec,
            initial_vector=jnp.asarray(positions, dtype),
            n_walkers=S * walkers_per_dataset,
            seed=seed,
            walker_jitter=walker_jitter,
            config=config,
            dtype=dtype,
            aux=jnp.asarray(group_ids),
            group_ids=group_ids,
            n_groups=S,
            log_posterior=log_post,
            posterior_data=batch_data,
            batched_log_posterior=batched_log_post,
        )

    @staticmethod
    def _normalize_errors(data_error, datasets):
        lens = [len(np.asarray(d[0])) for d in datasets]
        S = len(datasets)
        if data_error is None:
            return [np.ones(n) for n in lens]
        if np.isscalar(data_error):
            return [np.full(n, float(data_error)) for n in lens]
        try:
            arr = np.asarray(data_error, np.float64)
        except (ValueError, TypeError):
            arr = None  # ragged per-dataset list (mixed scalars/arrays)
        same_len = all(n == lens[0] for n in lens)
        if arr is not None and arr.ndim == 1 and same_len \
                and arr.shape[0] == lens[0]:
            # One shared per-POINT error array (the single-fit API's
            # natural shape).  Without this branch its elements would be
            # misread as per-DATASET scalars.  When n == S the two
            # readings collide — demand an explicit list of S entries.
            if lens[0] == S:
                raise ValueError(
                    f"data_error of length {lens[0]} is ambiguous with "
                    f"{S} datasets of {lens[0]} points; pass a list of "
                    f"per-dataset entries")
            return [arr.copy() for _ in range(S)]
        out = []
        for i, e in enumerate(data_error):
            e = np.asarray(e, np.float64)
            if e.ndim == 0:
                out.append(np.full(lens[min(i, S - 1)], float(e)))
            else:
                out.append(e)
        if len(out) != S:
            raise ValueError(f"{len(out)} errors for {S} datasets")
        for i, (e, n) in enumerate(zip(out, lens)):
            if e.shape[0] != n:
                raise ValueError(
                    f"dataset {i}: error array length {e.shape[0]} != "
                    f"{n} points")
        return out

    # ------------------------------------------------------------- queries

    def _best_walker_per_dataset(self) -> np.ndarray:
        """(S,) flat walker index of each dataset block's best step."""
        best_lp = np.asarray(self.state.best_logprob)
        B = self.walkers_per_dataset
        local = best_lp.reshape(self.n_datasets, B).argmax(axis=1)
        return np.arange(self.n_datasets) * B + local

    def best_params_per_dataset(self) -> list[dict]:
        """Per-dataset most-likely params: argmax within each walker block."""
        best_pos = np.asarray(self.state.best_position)
        return [self.spec.make(best_pos[w].tolist())
                for w in self._best_walker_per_dataset()]

    def best_logprob_per_dataset(self) -> list[float]:
        best_lp = np.asarray(self.state.best_logprob)
        return [float(best_lp[w]) for w in self._best_walker_per_dataset()]

    def expressions_per_dataset(self, expr: str) -> list[float]:
        """Evaluate a derived-quantity expression at each dataset's best fit
        (the vectorized ``walker-set-get-f``, nv-specific.lisp:87)."""
        from .expressions import eval_expression

        return [eval_expression(expr, p) for p in self.best_params_per_dataset()]

    def reset_to_most_likely(self):
        """Restart each dataset's walkers at THAT dataset's best step.

        Overrides the base verb, whose single global argmax would
        teleport every dataset's walkers to one dataset's optimum —
        walkers evaluating a different posterior than the position they
        were reset to (and a zero-spread ensemble per block for the
        ensemble kernels).
        """
        import dataclasses

        best_lp = np.asarray(self.state.best_logprob)
        best_pos = np.asarray(self.state.best_position)
        B = self.walkers_per_dataset
        bests = self._best_walker_per_dataset()
        pos = np.repeat(best_pos[bests], B, axis=0)
        lp = np.repeat(best_lp[bests], B)
        self.state = dataclasses.replace(
            self.state,
            position=jnp.asarray(pos, self.dtype),
            logprob=jnp.asarray(lp, self.dtype),
        )
        self.reset()

    def dataset_view(self, s: int) -> "_DatasetView":
        """Single-dataset read-only view: dataset ``s``'s walker block
        behind the plain-Walker surface the predictive toolchain needs
        (``diagnostics.waic/loo``, ``posterior_predictive`` ...)."""
        if not 0 <= s < self.n_datasets:
            raise IndexError(f"dataset {s} of {self.n_datasets}")
        return _DatasetView(self, s)

    def waic_per_dataset(self, **kwargs) -> list:
        """Per-dataset WAIC (``diagnostics.waic`` on each block view)."""
        from .diagnostics import waic

        return [waic(self.dataset_view(s), **kwargs)
                for s in range(self.n_datasets)]

    def loo_per_dataset(self, **kwargs) -> list:
        """Per-dataset PSIS-LOO with Pareto-k diagnostics."""
        from .diagnostics import loo

        return [loo(self.dataset_view(s), **kwargs)
                for s in range(self.n_datasets)]

    def posterior_predictive_per_dataset(self, **kwargs) -> list:
        """Per-dataset replicated observations (one PredictiveDraws each)."""
        from .predictive import posterior_predictive

        return [posterior_predictive(self.dataset_view(s), **kwargs)[0]
                for s in range(self.n_datasets)]

    def loo_pit_per_dataset(self, **kwargs) -> list:
        """Per-dataset LOO-PIT calibration verdicts."""
        from .diagnostics import loo_pit

        return [loo_pit(self.dataset_view(s), **kwargs)
                for s in range(self.n_datasets)]

    def prior_sensitivity_per_dataset(self, prior=None, **kwargs) -> list:
        """Per-dataset power-scaling prior/likelihood sensitivity."""
        from .diagnostics import prior_sensitivity

        return [prior_sensitivity(self.dataset_view(s), prior=prior, **kwargs)
                for s in range(self.n_datasets)]

    def audit_per_dataset(self, **kwargs) -> list:
        """Per-dataset calibration report cards (``diagnostics.audit``)."""
        from .diagnostics import audit

        return [audit(self.dataset_view(s), **kwargs)
                for s in range(self.n_datasets)]

    def convergence(self, take: int | None = None, **kwargs) -> dict:
        """Per-dataset convergence verdict for the whole batch, one call.

        The batched-scaling quality gate: returns the worst-case
        :func:`~lisp_mcmc_tpu.diagnostics.convergence` report (``ok`` is
        True only when EVERY dataset block passes) plus
        ``"per_dataset"`` — one verdict dict per dataset, failures
        prefixed with their dataset index so a failing spectrum in a
        scan grid is identifiable (and re-runnable) without restarting
        the grid.  Accepts the same ``rhat_tol`` / ``min_tail_ess``
        knobs as the base verdict.
        """
        from .diagnostics import convergence_per_dataset, merge_worst_verdict

        per = convergence_per_dataset(self, take, **kwargs)
        keys = self.spec.keys
        out = {"rank_rhat": {}, "tail_ess": {}, "mcse": {}}
        failures = []
        for s, v in enumerate(per):
            merge_worst_verdict(out, v, keys)
            failures.extend(f"dataset {s}: {msg}" for msg in v["failures"])
        out["ok"] = not failures
        out["failures"] = failures
        out["per_dataset"] = per
        return out

    def advi_per_dataset(self, *args, **kwargs) -> list:
        """S per-dataset ADVI fits as ONE vmapped scan (``variational``).

        The variational sibling of :meth:`laplace_per_dataset`: every
        dataset block fits its own Gaussian q (initialized from its own
        walkers) in a single device program; each returned
        :class:`~lisp_mcmc_tpu.VIResult` carries its own
        Pareto-k-guarded ``log_z``.
        """
        from .variational import advi_per_dataset

        return advi_per_dataset(self, *args, **kwargs)

    def flow_advi_per_dataset(self, *args, **kwargs) -> list:
        """S per-dataset RealNVP flow fits as ONE vmapped program — the
        curved-posterior upgrade of :meth:`advi_per_dataset` (each
        returned :class:`~lisp_mcmc_tpu.FlowVIResult` carries its own
        Pareto-k-guarded ``log_z`` and NeuTra surface)."""
        from .variational import flow_advi_per_dataset

        return flow_advi_per_dataset(self, *args, **kwargs)

    def nested_per_dataset(self, bounds=None, **kwargs) -> list:
        """S per-dataset nested-sampling runs as ONE vmapped program
        (``nested.nested_per_dataset``): each dataset gets its own live
        set, evidence ``log_z +- log_z_err``, posterior draws, and
        insertion-rank diagnostic — the information-theoretic evidence
        column of a scan-grid model comparison (difference two batched
        fits' ``log_z`` lists for per-spectrum Bayes factors)."""
        from .nested import nested_per_dataset

        return nested_per_dataset(self, bounds, **kwargs)

    def laplace_per_dataset(self, bounds=None, prior=None,
                            eig_floor: float = 1e-12):
        """Per-dataset Laplace approximations from ONE vmapped Hessian.

        The batched counterpart of :func:`~lisp_mcmc_tpu.laplace_approx`:
        every dataset's curvature covariance, per-parameter sds, and
        closed-form evidence come from a single
        ``vmap(hessian)`` over the stacked best-fit vectors — S
        evidences for a scan grid in one device program (compare
        model families spectrum-by-spectrum by differencing two batched
        fits' ``log_z`` lists).  ``bounds`` resolves from a
        ``make_bounds_prior`` log_prior when omitted; without any
        bounds, ``log_z`` is None and only curvature is returned.
        Returns a list of :class:`~lisp_mcmc_tpu.LaplaceResult`.
        """
        from .evidence import _laplace_from_hessian
        from .priors import resolve_prior_spec

        data = self._posterior_data()
        best = self.best_params_per_dataset()
        thetas = jnp.asarray(
            np.stack([np.asarray([float(p[k]) for k in self.spec.keys])
                      for p in best]), self.dtype)
        idx = jnp.arange(self.n_datasets)

        def lp_fn(theta, s):
            return self._custom_log_post(theta, s, data)

        neg_hess = -jax.vmap(jax.hessian(lp_fn), in_axes=(0, 0))(thetas, idx)
        lps = jax.vmap(lp_fn)(thetas, idx)
        spec = resolve_prior_spec(self, prior, bounds)
        return [
            _laplace_from_hessian(
                float(lps[s]), best[s], np.asarray(neg_hess[s]),
                self.spec.keys, spec, eig_floor, "laplace_per_dataset")
            for s in range(self.n_datasets)
        ]
