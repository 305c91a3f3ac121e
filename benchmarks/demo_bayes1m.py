"""Fully Bayesian hyperparameters at N=2^20 on ONE device (grid data).

The Toeplitz capstone, round-2 final form: ChEES-HMC over (h, w, s) on
the WHITTLE log posterior (inference/gp_model.py::
make_log_posterior_whittle) — the exact log-density of the circulant
surrogate model, three FFT/elementwise ops per leapfrog step, fully
deterministic.  Dense inference at this N would need a 4.4 TB kernel
matrix; the stochastic PCG+SLQ surrogate was measured to acquire an f32
systematic bias at this scale that mis-ranks long lengthscales
(round 2), while the Whittle density is exact for
its (asymptotically equivalent) model and ~1000x cheaper per step.

Env knobs: D1M_N, D1M_CHAINS, D1M_WARMUP, D1M_SAMPLES.
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
        make_log_posterior_whittle,
    )
    from gaussian_processes_tpu.inference.chees import sample_chees

    n = int(os.environ.get("D1M_N", 1 << 20))
    n_chains = int(os.environ.get("D1M_CHAINS", 16))
    num_warmup = int(os.environ.get("D1M_WARMUP", 400))
    num_samples = int(os.environ.get("D1M_SAMPLES", 400))

    rng = np.random.default_rng(0)
    # endpoint-EXCLUSIVE grid: the circulant model's circle closes at
    # exactly 2 pi, and sin(50 x) has 50 exact cycles on it — boundary-
    # compatible data (whittle_log_marginal docstring)
    x = (np.arange(n) * (2 * np.pi / n) - np.pi).astype(np.float32)
    y = (np.sin(50 * x) + 0.1 * rng.standard_normal(n)).astype(np.float32)

    # init/prior at the data's generative scale: a unit sine has RMS
    # ~0.71 and wiggle scale ~ 1/50; a first 2310 s run started at
    # w=6e-4 (an arbitrary 100*dx) and measured the posterior mode at
    # w ~ 0.0365 with R-hat 4.2 — chains had to climb 4 prior sd
    h0, w0, s0 = 0.7, 0.04, 0.1
    k0 = GaussianKernel(h=jnp.asarray(h0, jnp.float32),
                        w=jnp.asarray(w0, jnp.float32))
    u0 = np.log(np.array([h0, w0, s0], dtype=np.float32))
    log_post = make_log_posterior_whittle(
        k0, x, y,
        prior_mean=jnp.asarray(u0),  # weakly informative around the init
        prior_std=1.0,
        jitter=1e-6,
    )

    k1, k2 = jax.random.split(jax.random.key(0))
    # tight spread: at n=1e6 the posterior is razor-thin (log-noise sd
    # ~1e-3); chains initialized 0.1 log-units out can freeze under the
    # population-shared ChEES step size (measured round 2: R-hat=inf
    # from one stuck chain at spread=0.1; round 3: same at spread=0.02
    # with init_step_size=0.02 — the frozen chain never accepts while
    # population acceptance stays 0.81, so the shared step never
    # shrinks for it).  Defaults below are the measured-converged combo.
    spread = float(os.environ.get("D1M_SPREAD", 0.01))
    step0 = float(os.environ.get("D1M_STEP", 0.005))
    init = init_positions(k0, s0, k1, n_chains=n_chains, spread=spread,
                          dtype=jnp.float32)

    t0 = time.perf_counter()
    # chunk: draws per device dispatch (semantics are unchanged)
    # max_leapfrog must admit trajectories ~ the posterior scale: the
    # round-3 diagnosis run (32 x step 0.005 = 0.16 log-units vs log-h
    # posterior sd ~0.19) had every chain moving and accepting (min
    # chain accept 0.83, 0 frozen) yet ESS ~ 1/chain — pure random-walk
    # behavior from capped trajectories, presenting as R-hat = inf
    max_lf = int(os.environ.get("D1M_MAX_LEAPFROG", 128))
    chunk = int(os.environ.get("D1M_CHUNK", 2))
    res = sample_chees(
        log_post, init, k2,
        num_warmup=num_warmup, num_samples=num_samples,
        init_step_size=step0, init_traj_length=0.1,
        max_leapfrog=max_lf, chunk_size=chunk,
    )
    jax.block_until_ready(res.positions)
    wall = time.perf_counter() - t0

    draws = np.exp(np.asarray(res.positions)).reshape(-1, 3)
    total_draws = num_samples * n_chains
    from gaussian_processes_tpu.inference.diagnostics import summarize
    diag = summarize(np.asarray(res.positions))
    # per-chain forensics: a frozen chain shows as accept ~0 and draw
    # std ~0 — surfaced here so a bad run is attributable at a glance
    acc_pc = np.asarray(res.accept_prob).reshape(-1, n_chains).mean(0)
    std_pc = np.asarray(res.positions).std(0).max(-1)  # (C,) max over dims
    dump = os.environ.get("D1M_SAVE")
    if dump:
        np.savez(dump, positions=np.asarray(res.positions),
                 accept=np.asarray(res.accept_prob))
    out = {
        "metric": f"bayes1m_chees_whittle_n{n}_c{n_chains}",
        "value": round(total_draws / wall, 1),
        "unit": "samples/s (incl. warmup+compile)",
        "wall_s": round(wall, 1),
        "draws": total_draws,
        "accept_mean": float(np.asarray(res.accept_prob).mean()),
        "diverging_frac": float(np.asarray(res.diverging).mean()),
        "posterior_mean_hws": draws.mean(0).round(5).tolist(),
        "posterior_sd_hws": draws.std(0).round(6).tolist(),
        "true_hws": [None, None, 0.1],  # only the noise is a true model param
        "max_rhat": diag["max_rhat"],
        "min_ess": diag["min_ess"],
        "spread": spread,
        "init_step_size": step0,
        "min_chain_accept": float(acc_pc.min()),
        "n_frozen_chains": int(np.sum(std_pc < 1e-6)),
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
