"""gaussian_processes_tpu — a Gaussian-process inference engine in JAX.

A brand-new framework (not a port) with the capability set of the reference
library ``jhamrick/gaussian_processes`` (see SURVEY.md; the reference mount
was empty, so citations are to the reconstructed layout tagged [R]):

* Squared-exponential ("Gaussian") and periodic covariance kernels with
  closed-form first and second hyperparameter derivatives
  (reference: gp/kernels/{gaussian,periodic}.py + *_c.pyx [R]).
* Exact GP regression via Cholesky factorization: posterior predictive
  mean/covariance, log marginal likelihood, analytic gradient and Hessian
  with respect to hyperparameters (reference: gp/gp.py [R]).
* A memoizing ``GP`` object mirroring the reference API, built on top of a
  functional, ``jit``-able core (``fit`` / ``predict`` / ``GPPosterior``).
* What the reference leaves to external tools, built in:
  type-II MLE (optax), fully Bayesian hyperparameter inference via
  from-scratch vectorized NUTS/HMC, fused Pallas kernel-matrix
  products for the GPU, and chain sharding over a ``jax.sharding.Mesh``.

Layer map (analogue of SURVEY.md §2):

    L2  models/   GP inference (functional core + reference-parity object)
    L1  models/   kernels (pure functions + pytree params, analytic derivs)
    L0  ops/      fused Pallas GPU kernels (kernel matvec / jacvec),
                  blocked/distributed Cholesky  — the native layer
        parallel/ mesh + shard_map chain sharding, collectives
        inference/ NUTS/HMC, adaptation, type-II MLE
        utils/    config, metrics, checkpoint, profiling, test oracles
"""

from gaussian_processes_tpu.models.base import Kernel, pairwise_diff
from gaussian_processes_tpu.models.gaussian import GaussianKernel
from gaussian_processes_tpu.models.periodic import PeriodicKernel
from gaussian_processes_tpu.models.matern import Matern32Kernel, Matern52Kernel
from gaussian_processes_tpu.models.rq import RationalQuadraticKernel
from gaussian_processes_tpu.models.composite import ProductKernel, SumKernel
from gaussian_processes_tpu.models.ard import ARDGaussianKernel
from gaussian_processes_tpu.models.iterative_gp import (
    IterativePosterior,
    fit_iterative,
    fit_mle_iterative,
    log_marginal_value_and_grad_iterative,
    predict_diag_iterative,
    predict_mean_iterative,
)
from gaussian_processes_tpu.models.gp import (
    GPPosterior,
    build_kxx,
    fit,
    predict,
    predict_diag,
    sample_posterior,
    loo_predictive,
    extend_posterior,
    log_predictive_density,
    log_marginal_likelihood,
    log_marginal_value_and_grad,
    log_marginal_hessian,
    log_marginal_all,
    likelihood_value_grad_hessian,
)
from gaussian_processes_tpu.models.pathwise import (
    FourierFeatures,
    periodic_harmonic_features,
    prior_features,
    sample_posterior_pathwise,
    sample_posterior_pathwise_iterative,
)
from gaussian_processes_tpu.models.rff import (
    RFFPosterior,
    fit_rff,
    predict_rff,
    sample_rff_posterior,
)
from gaussian_processes_tpu.models.classify import (
    LaplacePosterior,
    LogisticLikelihood,
    PoissonLikelihood,
    fit_laplace,
    fit_laplace_mle,
    log_marginal_laplace,
    predict_laplace,
)
from gaussian_processes_tpu.models.sgpr import (
    SGPRPosterior,
    elbo_sgpr,
    fit_sgpr,
    fit_sgpr_mle,
    kmeans_inducing,
    make_log_posterior_sgpr,
    predict_sgpr,
    predict_sgpr_cov,
    sample_sgpr_posterior,
    select_inducing,
)
from gaussian_processes_tpu.models.gp_object import GP
from gaussian_processes_tpu.inference import (
    fit_mle,
    fit_mle_restarts,
    make_log_likelihood,
    make_log_posterior,
    sample_nuts,
)

__all__ = [
    "Kernel",
    "pairwise_diff",
    "GaussianKernel",
    "PeriodicKernel",
    "Matern32Kernel",
    "Matern52Kernel",
    "RationalQuadraticKernel",
    "SumKernel",
    "ProductKernel",
    "ARDGaussianKernel",
    "IterativePosterior",
    "fit_iterative",
    "fit_mle_iterative",
    "log_marginal_value_and_grad_iterative",
    "predict_diag_iterative",
    "predict_mean_iterative",
    "GPPosterior",
    "build_kxx",
    "fit",
    "predict",
    "predict_diag",
    "sample_posterior",
    "loo_predictive",
    "extend_posterior",
    "log_predictive_density",
    "log_marginal_likelihood",
    "log_marginal_value_and_grad",
    "log_marginal_hessian",
    "log_marginal_all",
    "likelihood_value_grad_hessian",
    "FourierFeatures",
    "periodic_harmonic_features",
    "prior_features",
    "RFFPosterior",
    "fit_rff",
    "predict_rff",
    "sample_rff_posterior",
    "sample_posterior_pathwise",
    "sample_posterior_pathwise_iterative",
    "LaplacePosterior",
    "LogisticLikelihood",
    "PoissonLikelihood",
    "fit_laplace",
    "fit_laplace_mle",
    "log_marginal_laplace",
    "predict_laplace",
    "SGPRPosterior",
    "elbo_sgpr",
    "fit_sgpr",
    "fit_sgpr_mle",
    "kmeans_inducing",
    "make_log_posterior_sgpr",
    "predict_sgpr",
    "predict_sgpr_cov",
    "sample_sgpr_posterior",
    "select_inducing",
    "GP",
    "fit_mle",
    "fit_mle_restarts",
    "make_log_likelihood",
    "make_log_posterior",
    "sample_nuts",
]

__version__ = "0.1.0"
