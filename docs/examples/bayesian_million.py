"""Fully Bayesian hyperparameters on a MILLION-point grid (rounds 2-5).

The flagship gridded workload: on a uniform grid the exact GP's kernel
matrix is Toeplitz, and its circulant (Whittle) surrogate has a
closed-form log-density in the Fourier basis — three FFT/elementwise
ops per posterior evaluation, deterministic, differentiated by plain
autodiff (ops/toeplitz.py::whittle_log_marginal).  That is the honest
objective at N ~ 10^6: the stochastic PCG+SLQ surrogate was measured to
acquire an f32 systematic bias at this scale (round 2), while
the Whittle density is exact for its (asymptotically equivalent) model.

Two design points matter at scale (both measured failures, both fixed):

* **Analytic spectrum** (``spectrum="auto"``): an f32 FFT of the sampled
  kernel column cannot resolve spectral tails below ~eps * lam_max,
  which at N=2^20 is the same order as a realistic noise variance — the
  old clamped-FFT spectrum erased the noise parameter from the
  high-frequency bins and manufactured a spurious posterior mode
  (round-4 forensics).  SE/Matern kernels use the aliased
  Bochner density, the periodic kernel its exact folded line spectrum,
  and SE x periodic products the line/density convolution (round 5) —
  the noise stays strictly additive in every bin.
* **Centered density** (``center=True``, default): |lml| ~ 1e6 nats at
  N=2^20 where f32 resolution is ~0.06 nats — the HMC acceptance ratio
  becomes rounding noise unless the density is accumulated as per-bin
  differences against a reference spectrum.

Runs small (n=4096) on CPU so it is executable anywhere:

    env JAX_PLATFORMS=cpu PYTHONPATH=. python docs/examples/bayesian_million.py

The full N=2^20, 16-chain acceptance run is benchmarks/demo_bayes1m.py;
its converged record (split-Rhat, ESS, posterior moments vs the
generative noise) is for the benchmark to take on the GPU (ROADMAP S6).
"""

import jax
import jax.numpy as jnp
import numpy as np

from gaussian_processes_tpu import GaussianKernel
from gaussian_processes_tpu.inference import (
    init_positions,
    make_log_posterior_whittle,
)
from gaussian_processes_tpu.inference.chees import sample_chees
from gaussian_processes_tpu.inference.diagnostics import summarize


def main(n=4096, n_chains=8):
    rng = np.random.default_rng(0)
    # endpoint-EXCLUSIVE grid: the circulant model closes into a circle
    # at exactly 2 pi, and sin(50 x) has 50 exact cycles on it —
    # boundary-compatible data (whittle_log_marginal docstring)
    x = (np.arange(n) * (2 * np.pi / n) - np.pi).astype(np.float32)
    y = (np.sin(50 * x) + 0.1 * rng.standard_normal(n)).astype(np.float32)

    h0, w0, s0 = 0.7, 0.04, 0.1
    k0 = GaussianKernel(h=jnp.asarray(h0, jnp.float32),
                        w=jnp.asarray(w0, jnp.float32))
    u0 = np.log(np.array([h0, w0, s0], dtype=np.float32))
    log_post = make_log_posterior_whittle(
        k0, x, y,
        prior_mean=jnp.asarray(u0), prior_std=1.0, jitter=1e-6,
    )

    k1, k2 = jax.random.split(jax.random.key(0))
    init = init_positions(k0, s0, k1, n_chains=n_chains, spread=0.05,
                          dtype=jnp.float32)
    res = sample_chees(
        log_post, init, k2, num_warmup=300, num_samples=300,
        init_step_size=0.01, max_leapfrog=64, chunk_size=10,
    )

    draws = np.exp(np.asarray(res.positions)).reshape(-1, 3)
    diag = summarize(np.asarray(res.positions))
    print(f"posterior mean (h, w, s) = {draws.mean(0).round(4)}")
    print(f"posterior sd   (h, w, s) = {draws.std(0).round(5)}")
    print(f"generative noise s = 0.1")
    print(f"max split-Rhat = {diag['max_rhat']:.4f}  min ESS = {diag['min_ess']:.0f}")
    assert np.isfinite(draws).all()


if __name__ == "__main__":
    main()
