"""Scaling out: chain sharding and block-sharded linear algebra
(BASELINE configs #4/#5).

Runs on any device count — try
    env JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        PYTHONPATH=. python docs/examples/scaling.py
for an 8-device virtual mesh, or unmodified on a GPU host (all of its
cards).  Across hosts call ``initialize_cluster()`` first (it reads
JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID) and launch
the same script on every host (docs/multihost.md).
"""

import jax
import jax.numpy as jnp
import numpy as np

import gaussian_processes_tpu as gpt
from gaussian_processes_tpu.inference import init_positions, make_log_posterior
from gaussian_processes_tpu.parallel import (
    fit_sharded,
    initialize_cluster,
    make_chain_mesh,
    make_grid_mesh,
    predict_diag_sharded,
    sample_nuts_sharded,
)


def main(seed=0):
    info = initialize_cluster()  # no-op single-process; pod-aware otherwise
    print("cluster:", info)

    rng = np.random.default_rng(seed)
    n = 96  # kept small so the example is quick on a CPU mesh; scale up on GPUs
    x = np.sort(rng.uniform(-np.pi, np.pi, n))
    y = np.sin(2 * x) + 0.1 * rng.standard_normal(n)
    kernel = gpt.GaussianKernel(h=jnp.asarray(1.0), w=jnp.asarray(1.0))

    n_dev = len(jax.devices())

    # --- chain parallelism: one population, adaptation pooled by collectives ---
    mesh = make_chain_mesh()
    n_chains = 4 * n_dev
    log_post = make_log_posterior(kernel, x, y, jitter=1e-6)
    k1, k2 = jax.random.split(jax.random.key(seed))
    init = init_positions(kernel, 0.2, k1, n_chains=n_chains, spread=0.2)
    res = sample_nuts_sharded(log_post, init, k2, mesh=mesh,
                              num_warmup=60, num_samples=60, max_depth=6)
    print(f"{n_chains} chains on {n_dev} devices; "
          f"step={float(res.step_size):.4f} "
          f"div={float(np.asarray(res.diverging).mean()):.4f}")

    # --- tensor parallelism: K block-sharded over a 2-D grid ---
    grid = make_grid_mesh()
    post = fit_sharded(kernel, x, y, 0.1, grid, jitter=1e-6)
    mean, var = predict_diag_sharded(post, np.linspace(-3, 3, 64), grid)
    print(f"sharded fit lml={float(post.log_marginal):.2f} "
          f"grid={dict(zip(grid.axis_names, grid.devices.shape))}")
    return res


if __name__ == "__main__":
    main()
