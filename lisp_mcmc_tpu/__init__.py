"""lisp_mcmc_tpu — an accelerator-native adaptive-MCMC curve-fitting framework.

A ground-up JAX/XLA rebuild of the capabilities of afranson/Lisp-MCMC
(Metropolis-Hastings "walker" fitting with adaptive proposal covariance,
annealing, auto-convergence, global multi-dataset fits, priors, plotting,
and lab-data ingestion), redesigned for an accelerator: walker ensembles
are ``(W, d)`` batches advanced by jitted ``lax.scan`` chunks, likelihood
reductions are fused masked sums, and chains shard across device meshes
with a single pooled-covariance allreduce.

Quick start (the test.lisp journey):

    import lisp_mcmc_tpu as mfit
    from lisp_mcmc_tpu.models import lorder_mixed_bg

    table = mfit.read_file_data("example-data.xls")
    x, y = mfit.create_walker_data(table, 1, 4)
    w = mfit.walker_create(
        function=lorder_mixed_bg,
        data=(x, y),
        params={"scale": 1e-5, "linewidth": 7, "x0": 2200,
                "mix": 0.9, "bg0": 1e-7, "bg1": 1e-9},
        data_error=1e-7,
        n_walkers=1024,
    )
    w.adaptive_steps(100_000)
    print(w.most_likely_params())
"""

from .batched import BatchedFit
from .checkpoint import (
    batched_load,
    batched_save,
    hierarchical_load,
    hierarchical_save,
    walker_load,
    walker_save,
    walker_set_load,
    walker_set_save,
)
from .control import clear_stop, estop, request_stop, stop_requested
from .data import Dataset, clean_data, clean_data_error, create_walker_data
from .evidence import (EvidenceResult, LaplaceResult, laplace_approx,
                       log_bayes_factor, log_evidence)
from .hierarchical import HierarchicalFit
from .pooling import PoolingComparison, compare_pooling
from .nested import NestedResult, nested_per_dataset, nested_sample
from .profile import ProfileResult, profile_likelihood
from .variational import (VIResult, FlowVIResult, NeutraResult, advi,
                          flow_advi, advi_per_dataset,
                          flow_advi_per_dataset, load_flow)
from .smc import SMCResult, smc_sample
from .expressions import (
    expression_credible_interval,
    expression_hdi,
    expression_samples,
    walker_with_expression,
)
from .fit import Walker, default_dtype, mcmc_fit, unit_cube_view, walker_create
from .io import get_filename, read_file_data
from .kernel import FitConfig, WalkerState, temperature_schedule
from .likelihoods import (
    create_log_likelihood_function,
    make_noise_scale_likelihood,
    make_student_t_likelihood,
    make_x_error_likelihood,
    log_likelihood_normal,
    log_likelihood_normal_cutoff,
    log_likelihood_normal_weighted,
    log_likelihood_poisson,
    log_normal,
    log_poisson,
)
from .predictive import (PredictiveDraws, Prediction, posterior_predictive,
                         ppc_pvalue, predict, prior_predictive)
from .sbc import SBCResult, sbc_check, sbc_check_hierarchical
from .priors import (
    Gaussian,
    MVGaussian,
    LogNormal,
    PriorSpec,
    Uniform,
    as_prior_spec,
    bound_penalty,
    combine_priors,
    constraint_penalty,
    log_prior_flat,
    make_bounds_prior,
    prior_bounds,
)
from .utils import linspace, make_plist, map_tree, partition
from .walker_set import WalkerSet

__version__ = "0.1.0"


def enable_compilation_cache() -> str:
    """Turn on JAX's persistent compilation cache for this process.

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already keeps its
    cache there and no other directory is set.  Otherwise the cache goes
    to ``.jax_cache`` at the root of the checkout: a fixed path, since the
    path is part of the cache key.  Safe to call repeatedly.  Returns the
    cache directory used.
    """
    import os

    import jax

    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = os.path.join(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            ".jax_cache")
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    if jax.default_backend() == "cpu":
        # XLA:CPU's cached AOT results warn of SIGILL when the loader's
        # host-feature probe disagrees with the compiler's; keep only the
        # executable cache there.  Other backends keep XLA's own caches
        # (on the GPU: the per-fusion autotune results).
        jax.config.update("jax_persistent_cache_enable_xla_caches", "none")
    return path

__all__ = [
    "BatchedFit",
    "Dataset",
    "HierarchicalFit",
    "PoolingComparison",
    "compare_pooling",
    "FitConfig",
    "Walker",
    "WalkerSet",
    "WalkerState",
    "EvidenceResult",
    "LaplaceResult",
    "laplace_approx",
    "NestedResult",
    "nested_per_dataset",
    "nested_sample",
    "ProfileResult",
    "profile_likelihood",
    "VIResult",
    "advi",
    "advi_per_dataset",
    "flow_advi",
    "FlowVIResult",
    "NeutraResult",
    "flow_advi_per_dataset",
    "load_flow",
    "SMCResult",
    "PriorSpec",
    "Uniform",
    "Gaussian",
    "MVGaussian",
    "LogNormal",
    "as_prior_spec",
    "unit_cube_view",
    "bound_penalty",
    "clean_data",
    "clean_data_error",
    "clear_stop",
    "combine_priors",
    "constraint_penalty",
    "create_log_likelihood_function",
    "create_walker_data",
    "default_dtype",
    "enable_compilation_cache",
    "estop",
    "expression_credible_interval",
    "expression_hdi",
    "expression_samples",
    "get_filename",
    "linspace",
    "log_bayes_factor",
    "smc_sample",
    "log_evidence",
    "log_likelihood_normal",
    "log_likelihood_normal_cutoff",
    "log_likelihood_normal_weighted",
    "log_likelihood_poisson",
    "log_normal",
    "log_poisson",
    "log_prior_flat",
    "make_bounds_prior",
    "make_noise_scale_likelihood",
    "make_student_t_likelihood",
    "make_x_error_likelihood",
    "make_plist",
    "map_tree",
    "mcmc_fit",
    "partition",
    "prior_bounds",
    "PredictiveDraws",
    "Prediction",
    "predict",
    "posterior_predictive",
    "ppc_pvalue",
    "prior_predictive",
    "SBCResult",
    "sbc_check",
    "sbc_check_hierarchical",
    "read_file_data",
    "request_stop",
    "stop_requested",
    "temperature_schedule",
    "batched_load",
    "batched_save",
    "hierarchical_load",
    "hierarchical_save",
    "walker_load",
    "walker_save",
    "walker_set_load",
    "walker_set_save",
    "walker_create",
    "walker_with_expression",
]
