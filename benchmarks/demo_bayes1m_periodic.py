"""ChEES sampling on the PERIODIC Whittle posterior at N=2^20 (round 5).

Companion to demo_bayes1m.py: same grid and staging discipline, but the
kernel is the reference's flagship periodic family, exercising the
round-5 analytic LINE spectrum (ops/toeplitz.py::periodic_line_bins)
end-to-end under MCMC — the path that previously fell back silently to
the FFT spectrum whose f32 tail biased the noise posterior.  Short by
default (this is a sampling-works demonstration, not the acceptance
run).

Env knobs: P1M_N, P1M_CHAINS, P1M_WARMUP, P1M_SAMPLES, P1M_SAVE.
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

    from gaussian_processes_tpu import PeriodicKernel
    from gaussian_processes_tpu.inference import (
        init_positions,
        make_log_posterior_whittle,
    )
    from gaussian_processes_tpu.inference.chees import sample_chees

    n = int(os.environ.get("P1M_N", 1 << 20))
    n_chains = int(os.environ.get("P1M_CHAINS", 16))
    num_warmup = int(os.environ.get("P1M_WARMUP", 150))
    num_samples = int(os.environ.get("P1M_SAMPLES", 250))

    rng = np.random.default_rng(0)
    x = (np.arange(n) * (2 * np.pi / n) - np.pi).astype(np.float32)
    y = (np.sin(50 * x) + 0.1 * rng.standard_normal(n)).astype(np.float32)

    # data period 2 pi / 50 = kernel period 2 pi p  =>  p = 0.02
    h0, w0, p0, s0 = 0.7, 1.0, 0.02, 0.1
    k0 = PeriodicKernel(h=jnp.asarray(h0, jnp.float32),
                        w=jnp.asarray(w0, jnp.float32),
                        p=jnp.asarray(p0, jnp.float32))
    u0 = np.log(np.array([h0, w0, p0, s0], dtype=np.float32))
    log_post = make_log_posterior_whittle(
        k0, x, y, prior_mean=jnp.asarray(u0),
        # tight prior on log-p: period inference is comb-structured
        # (tests/test_toeplitz.py::test_whittle_mle_recovers_periodic_...)
        # — the supported workflow is periodogram-peak init + local
        # refinement, which a 0.005 log-sd prior encodes
        prior_std=jnp.asarray([1.0, 1.0, 0.005, 1.0], jnp.float32),
        jitter=1e-6,
    )

    k1, k2 = jax.random.split(jax.random.key(0))
    init = init_positions(k0, s0, k1, n_chains=n_chains, spread=0.005,
                          dtype=jnp.float32)
    t0 = time.perf_counter()
    res = sample_chees(
        log_post, init, k2, num_warmup=num_warmup,
        num_samples=num_samples, init_step_size=0.002,
        init_traj_length=0.05, max_leapfrog=128, chunk_size=2,
    )
    float(jnp.sum(res.positions))  # fetch-sync
    wall = time.perf_counter() - t0

    draws = np.exp(np.asarray(res.positions)).reshape(-1, 4)
    from gaussian_processes_tpu.inference.diagnostics import summarize
    diag = summarize(np.asarray(res.positions))
    std_pc = np.asarray(res.positions).std(0).max(-1)
    dump = os.environ.get("P1M_SAVE")
    if dump:
        np.savez(dump, positions=np.asarray(res.positions),
                 accept=np.asarray(res.accept_prob))
    out = {
        "metric": f"bayes1m_periodic_chees_whittle_n{n}_c{n_chains}",
        "wall_s": round(wall, 1),
        "draws": num_samples * n_chains,
        "accept_mean": float(np.asarray(res.accept_prob).mean()),
        "posterior_mean_hwps": draws.mean(0).round(5).tolist(),
        "posterior_sd_hwps": draws.std(0).round(6).tolist(),
        "true_s": 0.1,
        "true_p": 0.02,
        "max_rhat": diag["max_rhat"],
        "min_ess": diag["min_ess"],
        "n_frozen_chains": int(np.sum(std_pc < 1e-6)),
        "finite": bool(np.all(np.isfinite(draws))),
    }
    print("DONE " + json.dumps(out), flush=True)


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
