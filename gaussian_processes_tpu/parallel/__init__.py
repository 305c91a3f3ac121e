"""Parallel layer: device meshes, chain sharding, distributed linalg.

The communication backend (SURVEY.md §6.8): XLA collectives via
``jax.sharding.Mesh`` + ``shard_map``/``jit``, which XLA hands to NCCL
on GPUs — no hand-written NCCL/MPI layer.
"""

from gaussian_processes_tpu.parallel.sharded import (
    ShardedCheesResult,
    ShardedNUTSResult,
    ShardedNUTSState,
    collect_chees_sharded,
    collect_nuts_sharded,
    init_chees_sharded,
    init_nuts_sharded,
    make_chain_mesh,
    sample_chees_sharded,
    sample_nuts_sharded,
    shard_put_chees,
    shard_put_nuts,
    warmup_chees_sharded,
    warmup_nuts_sharded,
)
from gaussian_processes_tpu.parallel.distributed_gp import (
    fit_sharded,
    make_grid_mesh,
    predict_diag_sharded,
)
from gaussian_processes_tpu.parallel.block_cholesky import (
    BlockCyclicPosterior,
    fit_blockcyclic,
    predict_diag_blockcyclic,
)
from gaussian_processes_tpu.parallel.multihost import (
    host_checkpoint_path,
    initialize_cluster,
    is_primary,
)
from gaussian_processes_tpu.parallel.sgpr_sharded import (
    elbo_sgpr_sharded,
    fit_sgpr_mle_sharded,
    fit_sgpr_sharded,
)
from gaussian_processes_tpu.parallel.iterative_sharded import (
    fit_iterative_sharded,
    fit_mle_iterative_sharded,
    log_marginal_value_and_grad_iterative_sharded,
    make_row_mesh,
    predict_mean_iterative_sharded,
)
from gaussian_processes_tpu.parallel.bayes_sharded import (
    make_bayes_mesh,
    make_log_posterior_iterative_datasharded,
    sample_chees_iterative_sharded,
)

__all__ = [
    "BlockCyclicPosterior",
    "fit_blockcyclic",
    "predict_diag_blockcyclic",
    "host_checkpoint_path",
    "initialize_cluster",
    "is_primary",
    "ShardedCheesResult",
    "ShardedNUTSResult",
    "ShardedNUTSState",
    "collect_chees_sharded",
    "collect_nuts_sharded",
    "init_chees_sharded",
    "init_nuts_sharded",
    "sample_chees_sharded",
    "make_chain_mesh",
    "sample_nuts_sharded",
    "shard_put_chees",
    "shard_put_nuts",
    "warmup_chees_sharded",
    "warmup_nuts_sharded",
    "elbo_sgpr_sharded",
    "fit_sgpr_mle_sharded",
    "fit_sgpr_sharded",
    "fit_iterative_sharded",
    "fit_mle_iterative_sharded",
    "log_marginal_value_and_grad_iterative_sharded",
    "make_bayes_mesh",
    "make_log_posterior_iterative_datasharded",
    "make_row_mesh",
    "predict_mean_iterative_sharded",
    "sample_chees_iterative_sharded",
    "fit_sharded",
    "make_grid_mesh",
    "predict_diag_sharded",
]
