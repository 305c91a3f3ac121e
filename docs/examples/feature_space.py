"""Random-feature GP regression: the O(n F^2) feature-space path.

Exact Bayesian linear regression in F spectral features
(models/rff.py): no kernel matrix, no CG — one blocked matmul sweep builds
the F x F normal equations, so n can be 10^6+ on one device for scattered
inputs in any dimension.  Accuracy is the O(1/sqrt F) feature
approximation of the kernel; this example measures it against the dense
exact GP.

Run: env JAX_PLATFORMS=cpu PYTHONPATH=. python docs/examples/feature_space.py
"""

import jax
import jax.numpy as jnp
import numpy as np

import gaussian_processes_tpu as gpt

jax.config.update("jax_enable_x64", True)

rng = np.random.default_rng(0)
n = 1 << 14
x = jnp.asarray(np.sort(rng.uniform(-2.0, 2.0, n)))
y = jnp.asarray(np.sin(4 * np.asarray(x)) + 0.2 * rng.standard_normal(n))
kernel = gpt.GaussianKernel(h=1.0, w=0.3)

post = gpt.fit_rff(kernel, x, y, 0.2, jax.random.key(0),
                   num_features=2048, block_size=4096, jitter=1e-10)
xo = jnp.linspace(-1.8, 1.8, 100)
mean, var = gpt.predict_rff(post, xo)
print(f"rff fit n={n} F=2048: lml~{float(post.log_marginal):.1f}")

# dense oracle on a subsample (the full dense fit would be 2 GB of K)
sub = slice(0, n, 8)
dense = gpt.fit(kernel, x[sub], y[sub], 0.2, jitter=1e-10)
mean_d, _ = gpt.predict_diag(dense, xo)
print(f"max |rff mean - dense-subsample mean| = "
      f"{float(jnp.max(jnp.abs(mean - mean_d))):.3f} "
      f"(both estimate sin(4x); noise 0.2)")

draws = gpt.sample_rff_posterior(post, xo, jax.random.key(1), n_samples=256)
err = float(jnp.max(jnp.abs(draws.mean(0) - mean)))
print(f"256 posterior draws: |MC mean - closed form| = {err:.4f}")
print("done")
