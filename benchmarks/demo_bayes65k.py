"""Fully Bayesian hyperparameter sampling at N=65536 on ONE device.

The round-2 headline demo (VERDICT r1 item 2): ChEES-HMC over (h, w, s)
where every leapfrog step evaluates the log marginal likelihood
matrix-free — pivoted-Cholesky-preconditioned CG for the solves, SLQ for
the logdet, Hutchinson for the gradient (fixed probes; see
inference/gp_model.py::make_log_posterior_iterative).  Dense inference
per leapfrog at this N means a 17 GB K and an n^3 factorization at
every step.

This is a short demonstration chain — enough draws to measure s/draw and
verify finiteness/acceptance, not a production posterior.  Env knobs:
D65_N, D65_CHAINS, D65_WARMUP, D65_SAMPLES, D65_ITERS, D65_RANK.
"""

# allow running as `python benchmarks/<script>.py` from anywhere
import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))


import json
import os
import sys
import time

import numpy as np


def main():
    import jax
    import jax.numpy as jnp

    from gaussian_processes_tpu import GaussianKernel
    from gaussian_processes_tpu.inference import (
        init_positions,
        make_log_posterior_iterative,
    )
    from gaussian_processes_tpu.inference.chees import sample_chees

    n = int(os.environ.get("D65_N", 65536))
    n_chains = int(os.environ.get("D65_CHAINS", 2))
    num_warmup = int(os.environ.get("D65_WARMUP", 8))
    num_samples = int(os.environ.get("D65_SAMPLES", 8))
    num_iters = int(os.environ.get("D65_ITERS", 60))
    rank = int(os.environ.get("D65_RANK", 2048))

    rng = np.random.default_rng(0)
    x = np.sort(rng.uniform(-np.pi, np.pi, n)).astype(np.float32)
    w_true = max(100.0 * 2 * np.pi / n, 1e-3)
    y = (np.sin(2 * x) + 0.1 * rng.standard_normal(n)).astype(np.float32)

    k0 = GaussianKernel(h=jnp.asarray(1.0, jnp.float32),
                        w=jnp.asarray(w_true, jnp.float32))
    log_post = make_log_posterior_iterative(
        k0, x, y,
        prior_std=0.5,       # informative: the demo explores near the MLE
        jitter=1e-4,
        num_probes=4,
        num_iters=num_iters,
        tol=1e-5,
        block_size=2048,
        precond_rank=rank,
    )

    k1, k2 = jax.random.split(jax.random.key(0))
    init = init_positions(k0, 0.1, k1, n_chains=n_chains, spread=0.05,
                          dtype=jnp.float32)

    t0 = time.perf_counter()
    res = sample_chees(
        log_post, init, k2,
        num_warmup=num_warmup, num_samples=num_samples,
        init_step_size=0.02, init_traj_length=0.06,
        max_leapfrog=4, chunk_size=2,
    )
    jax.block_until_ready(res.positions)
    wall = time.perf_counter() - t0

    draws = np.exp(np.asarray(res.positions)).reshape(-1, 3)
    total_draws = num_samples * n_chains
    out = {
        "metric": f"bayes65k_chees_n{n}_c{n_chains}",
        "value": round(wall / max(num_samples, 1), 2),
        "unit": "s/draw (all chains, incl. compile-free collection+warmup amortized)",
        "wall_s": round(wall, 1),
        "draws": total_draws,
        "accept_mean": float(np.asarray(res.accept_prob).mean()),
        "diverging_frac": float(np.asarray(res.diverging).mean()),
        "posterior_mean_hws": draws.mean(0).round(4).tolist(),
        "finite": bool(np.all(np.isfinite(draws))),
    }
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    last = None
    for attempt in range(2):
        try:
            main()
            break
        except Exception as e:  # noqa: BLE001
            last = e
            print(f"attempt {attempt+1} failed: {e!r}", file=sys.stderr)
            time.sleep(5)
    else:
        raise last
