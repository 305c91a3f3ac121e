"""Sparse GP regression with inducing points (SGPR, models/sgpr.py).

The Titsias collapsed bound: m data-placed inducing points summarize n
training points through one blocked O(n m^2) matmul sweep — scattered
inputs at n ~ 1e6 on one device, calibrated variances, no CG.  This
example (CPU-runnable, f64):

1. fits SGPR with kmeans-selected inducing points and compares against
   the dense exact GP;
2. type-II MLE on the bound (including learning the inducing
   locations);
3. Bayesian hyperparameters over the SGPR surrogate with ChEES.
"""

import jax
import jax.numpy as jnp
import numpy as np

import gaussian_processes_tpu as gpt
from gaussian_processes_tpu.models.sgpr import (
    fit_sgpr,
    fit_sgpr_mle,
    kmeans_inducing,
    make_log_posterior_sgpr,
    predict_sgpr,
    sample_sgpr_posterior,
)

# ---- data: 5k scattered points (sized for a CPU-runnable example;
# the same code runs n ~ 1e6 on a GPU — see bench.py's sgpr section)
rng = np.random.default_rng(0)
n = 5_000
x = jnp.asarray(np.sort(rng.uniform(-2.0, 2.0, n)))
f_true = np.sin(3.0 * np.asarray(x)) + 0.5 * np.asarray(x)
y = jnp.asarray(f_true + 0.1 * rng.standard_normal(n))

kernel = gpt.GaussianKernel(h=1.0, w=0.5)

# ---- 1. fit: m=64 kmeans centers stand in for all 5k points
z = kmeans_inducing(jax.random.PRNGKey(0), x, 64)
post = fit_sgpr(kernel, x, y, 0.1, z)
print(f"SGPR bound: {float(post.log_marginal):.1f}  "
      f"trace gap (coverage): {float(post.trace_gap):.3f}")

xo = jnp.linspace(-1.9, 1.9, 200)
mean, var = predict_sgpr(post, xo)
err = float(jnp.max(jnp.abs(mean - (jnp.sin(3 * xo) + 0.5 * xo))))
print(f"predictive max err vs truth: {err:.4f} (noise level 0.1)")

draws = sample_sgpr_posterior(post, xo[:50], jax.random.PRNGKey(1), 16)
print(f"16 joint posterior draws: {draws.shape}")

# ---- 2. type-II MLE on the bound, learning z too
post_mle, losses = fit_sgpr_mle(
    gpt.GaussianKernel(h=0.5, w=1.5), x, y, 0.3,
    kmeans_inducing(jax.random.PRNGKey(2), x, 32),
    learn_inducing=True, num_steps=100, learning_rate=0.05,
)
print(f"MLE: h={float(post_mle.kernel.params[0]):.3f} "
      f"w={float(post_mle.kernel.params[1]):.3f} "
      f"noise={float(post_mle.noise):.3f} (true data noise 0.1)")

# ---- 3. Bayesian hyperparameters on the SGPR surrogate (a 1.5k
# subset and short chains keep this CPU example quick; the full-n
# surrogate scales O(n m^2) per leapfrog)
from gaussian_processes_tpu.inference import chees, gp_model

xs, ys = x[::4], y[::4]
log_post = make_log_posterior_sgpr(
    gpt.GaussianKernel(h=1.0, w=1.0), xs, ys,
    kmeans_inducing(jax.random.PRNGKey(5), xs, 32), prior_std=1.5,
)
u0 = gp_model.init_positions(
    gpt.GaussianKernel(h=1.0, w=0.5), 0.1, jax.random.PRNGKey(3), 4,
)
result = chees.sample_chees(
    log_post, u0, jax.random.PRNGKey(4),
    num_warmup=100, num_samples=100,
)
theta = jnp.exp(result.positions.reshape(-1, 3))
print("posterior medians (h, w, s):",
      [round(float(v), 3) for v in jnp.median(theta, axis=0)])
