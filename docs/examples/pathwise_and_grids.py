"""Pathwise posterior function draws + the Toeplitz grid fast path.

Two round-2 capabilities on one toy problem:

1. **Pathwise sampling** (models/pathwise.py): draw posterior *functions*
   via Matheron's rule — a spectral-feature prior draw plus a data-fit
   correction solve.  Works with the dense posterior (small N) and the
   matrix-free one (any N CG reaches); never factorizes the m x m
   predictive covariance.

2. **Toeplitz structure** (ops/toeplitz.py): on an evenly spaced grid
   every stationary kernel matrix is symmetric Toeplitz, so
   ``structure="toeplitz"`` turns each matvec into an O(n log n) FFT
   product with a free circulant preconditioner.

3. **SKI / KISS-GP** (ops/ski.py): scattered inputs interpolated onto an
   inducing grid (K ~= W K_g W^T, 4-tap cubic rows in W) keep the FFT
   fast path off the grid — pass ``structure=ski.interpolation_weights(...)``
   anywhere ``structure="toeplitz"`` is accepted.

Run: env JAX_PLATFORMS=cpu PYTHONPATH=. python docs/examples/pathwise_and_grids.py
"""

import jax
import jax.numpy as jnp
import numpy as np

import gaussian_processes_tpu as gpt

jax.config.update("jax_enable_x64", True)

# --- data on a uniform grid (the Toeplitz regime) --------------------------
n = 4096
x = jnp.linspace(-np.pi, np.pi, n)
rng = np.random.default_rng(0)
y = jnp.asarray(np.sin(8 * np.asarray(x)) + 0.2 * rng.standard_normal(n))
kernel = gpt.GaussianKernel(h=1.0, w=0.1)

assert gpt.ops.toeplitz.is_uniform_grid(x)

# --- matrix-free fit with FFT matvecs ---------------------------------------
post = gpt.fit_iterative(
    kernel, x, y, 0.2, jax.random.key(0),
    num_probes=16, num_iters=150, tol=1e-10, jitter=1e-8,
    structure="toeplitz",
)
print(f"toeplitz fit: lml~{float(post.log_marginal):.1f} "
      f"residual={float(post.solve_residual):.2e}")

# --- posterior function draws (pathwise, matrix-free) -----------------------
xo = jnp.linspace(-1.0, 1.0, 200)
draws = gpt.sample_posterior_pathwise_iterative(
    post, xo, jax.random.key(1), n_samples=8, num_features=2048,
    num_iters=150, tol=1e-10, jitter=1e-8, structure="toeplitz",
)
mean, var = gpt.predict_diag_iterative(
    post, xo, num_iters=150, tol=1e-10, jitter=1e-8, structure="toeplitz"
)
band = 2.0 * jnp.sqrt(jnp.maximum(var, 0.0))
inside = jnp.mean((jnp.abs(draws - mean[None, :]) < 3.0 * band[None, :] + 0.05)
                  .astype(jnp.float64))
print(f"8 pathwise draws over 200 points; {float(inside)*100:.1f}% of draw "
      f"mass within 3 predictive sd (expect ~100%)")

# --- dense pathwise on a subset (cross-check) --------------------------------
sub = slice(0, n, 16)
post_d = gpt.fit(kernel, x[sub], y[sub], 0.2, jitter=1e-8)
d = gpt.sample_posterior_pathwise(
    post_d, xo, jax.random.key(2), n_samples=512, num_features=4096
)
m_d, _ = gpt.predict_diag(post_d, xo)
err = float(jnp.max(jnp.abs(jnp.mean(d, axis=0) - m_d)))
print(f"dense pathwise: |MC mean - closed form| = {err:.3f} over 512 draws")

# --- scattered inputs: same fast path through SKI ----------------------------
from gaussian_processes_tpu.ops import ski  # noqa: E402

xs = jnp.asarray(np.sort(rng.uniform(-np.pi, np.pi, 2000)))
ys = jnp.asarray(np.sin(8 * np.asarray(xs)) + 0.2 * rng.standard_normal(2000))
op = ski.interpolation_weights(xs, ski.make_grid(xs, 4096))
post_s = gpt.fit_iterative(
    kernel, xs, ys, 0.2, jax.random.key(3),
    num_probes=16, num_iters=200, tol=1e-10, jitter=1e-8, structure=op,
)
mean_s, _ = gpt.predict_diag_iterative(
    post_s, xo, num_iters=200, tol=1e-10, jitter=1e-8, structure=op
)
post_sd = gpt.fit(kernel, xs, ys, 0.2, jitter=1e-8)
mean_sd, _ = gpt.predict_diag(post_sd, xo)
print(f"SKI on 2000 scattered points (4096-pt grid): "
      f"max |mean - dense exact| = {float(jnp.max(jnp.abs(mean_s - mean_sd))):.2e}")
print("done")
