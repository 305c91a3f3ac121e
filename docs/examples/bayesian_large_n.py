"""Fully Bayesian hyperparameters past the dense wall (round 2).

Demonstrates the matrix-free log posterior: the samplers never see an
N x N matrix — every leapfrog step evaluates the log marginal by
preconditioned CG and its gradient by the Hutchinson trace identity over
the same solves (inference/gp_model.py::make_log_posterior_iterative).
With fixed probes, the sampler targets a deterministic surrogate whose
moments match the dense posterior within Monte-Carlo error
(tests/test_iterative_posterior.py).

Runs small (N=400) on CPU so it is executable anywhere:

    env JAX_PLATFORMS=cpu PYTHONPATH=. python docs/examples/bayesian_large_n.py

On a GPU the same code runs at N=65536 — scale ``n``, raise
``precond_rank`` to ~3 * range /
lengthscale, and keep ``block_size`` at 2048.
"""

import jax
import jax.numpy as jnp
import numpy as np

from gaussian_processes_tpu import GaussianKernel
from gaussian_processes_tpu.inference import (
    init_positions,
    make_log_posterior_iterative,
)
from gaussian_processes_tpu.inference.chees import sample_chees
from gaussian_processes_tpu.inference.diagnostics import summarize


def main(n=250, n_chains=4):
    rng = np.random.default_rng(0)
    x = np.sort(rng.uniform(-np.pi, np.pi, n))
    y = np.sin(2 * x) + 0.1 * rng.standard_normal(n)

    k0 = GaussianKernel(h=jnp.asarray(1.0), w=jnp.asarray(1.0))
    log_post = make_log_posterior_iterative(
        k0, x, y,
        prior_std=1.5, jitter=1e-8,
        num_probes=12,      # SLQ probes: fixed at build time
        num_iters=60,       # CG budget per leapfrog step
        tol=1e-8,
        block_size=1024,    # kernel strip width (memory knob)
        precond_rank=50,    # pivoted-Cholesky PCG (scale ~3*range/w at large N)
    )

    k1, k2 = jax.random.split(jax.random.key(0))
    init = init_positions(k0, 0.15, k1, n_chains=n_chains, spread=0.2)
    res = sample_chees(
        log_post, init, k2, num_warmup=150, num_samples=150, max_leapfrog=48
    )

    draws = np.exp(np.asarray(res.positions)).reshape(-1, 3)
    diag = summarize(np.asarray(res.positions))
    print(f"posterior mean (h, w, s) = {draws.mean(0).round(3)}")
    print(f"posterior sd   (h, w, s) = {draws.std(0).round(3)}")
    print(f"max split-Rhat = {diag['max_rhat']:.4f}  min ESS = {diag['min_ess']:.0f}")


if __name__ == "__main__":
    main()
