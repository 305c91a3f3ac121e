"""Large-N exact GP: three regimes, three mechanisms (BASELINE config #4).

1. dense single-device — N up to the device's memory (K is n^2 floats)
   (`fit`, XLA's Cholesky: cuSOLVER on the GPU).
2. distributed dense   — N beyond one device's memory: block-cyclic Cholesky
   over the mesh (`parallel.fit_blockcyclic`), no device ever holds K.
3. matrix-free         — N beyond dense storage anywhere: CG + SLQ
   (`fit_iterative`), O(N * block) memory, kernel strips generated on
   the fly (fused on the GPU); a single device handles N=65k+.

This example runs small shapes so it works on any backend; scale N up on
real hardware.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np

import gaussian_processes_tpu as gpt
from gaussian_processes_tpu.parallel import fit_blockcyclic, make_chain_mesh


def main(n=2048, seed=0):
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(-np.pi, np.pi, n))
    y = np.sin(2 * x) + 0.1 * rng.standard_normal(n)
    kernel = gpt.GaussianKernel(h=jnp.asarray(1.0), w=jnp.asarray(1.0))

    # 1. dense
    t0 = time.perf_counter()
    post_d = gpt.fit(kernel, x, y, 0.1, jitter=1e-6)
    jax.block_until_ready(post_d.L)
    print(f"dense:       lml={float(post_d.log_marginal):10.2f}  "
          f"({time.perf_counter() - t0:.2f}s incl compile)")

    # 2. distributed dense (1-D mesh over however many devices exist)
    mesh = make_chain_mesh(axis="shard")
    post_b = fit_blockcyclic(kernel, x, y, 0.1, mesh, block_size=64,
                             jitter=1e-6)
    print(f"block-cyclic lml={float(post_b.log_marginal):10.2f}  "
          f"(devices={len(jax.devices())})")

    # 3. matrix-free
    post_i = gpt.fit_iterative(kernel, x, y, 0.1, jax.random.key(0),
                               num_probes=16, num_iters=150,
                               jitter=1e-6, block_size=256)
    print(f"matrix-free: lml={float(post_i.log_marginal):10.2f}  "
          f"(SLQ estimate; CG residual {float(post_i.solve_residual):.1e})")

    xo = np.linspace(-3, 3, 50)
    m_d, _ = gpt.predict_diag(post_d, xo)
    m_i = gpt.predict_mean_iterative(post_i, xo)
    print(f"max |dense - matrix-free| predictive mean: "
          f"{float(jnp.max(jnp.abs(m_d - m_i))):.2e}")
    return post_d, post_b, post_i


if __name__ == "__main__":
    main()
