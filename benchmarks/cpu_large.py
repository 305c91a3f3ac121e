"""CPU denominators for the large-N bench regimes (VERDICT r2 item 3c).

Two kinds of denominator, one per metric key in
``benchmarks/cpu_baseline_large.json``:

* **Dense-equivalent** (keys ``iterative``, ``ski``, ``toeplitz_65536``):
  at n=65536 the reference's own method (dense f64 build+Cholesky+solve,
  SURVEY.md §4.1) is feasible on this host (125 GB RAM) and is measured
  directly by ``cpu_baseline.py 65536``; those keys copy that number —
  same workload (a GP fit at n=65536), the strongest CPU method from the
  reference's world.

* **Same-algorithm** (keys ``toeplitz_1048576``, ``rff``, ``sgpr``,
  ``whittle``, ``whittle2d``): no dense equivalent exists at N=2^20
  (K would be 8.8 TB), so the denominator is the SAME structured
  algorithm executed by this framework on the host CPU backend in f64
  (the reference's precision), exact bench.py configs.

Run once per machine (CPU-only):
    JAX_PLATFORMS=cpu \
        python benchmarks/cpu_large.py
"""

import json
import os
import sys
import time

import numpy as np

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from gaussian_processes_tpu import (  # noqa: E402
    GaussianKernel,
    fit_iterative,
    fit_rff,
    fit_sgpr,
)
from gaussian_processes_tpu.models.sgpr import kmeans_inducing  # noqa: E402
from gaussian_processes_tpu.inference import (  # noqa: E402
    make_log_posterior_whittle,
    make_log_posterior_whittle_kron,
)
from gaussian_processes_tpu.models.ard import ARDGaussianKernel  # noqa: E402
from gaussian_processes_tpu.ops.kronecker import KronOperator  # noqa: E402

DT = jnp.float64


def _timed(f, *args, reps=2):
    out = f(*args)
    jax.block_until_ready(out)  # real sync on the CPU backend
    best = np.inf
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(f(*args))
        best = min(best, time.perf_counter() - t0)
    return best


def sine(n, seed=0):
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(-np.pi, np.pi, n))
    y = np.sin(2 * x) + 0.1 * rng.standard_normal(n)
    return jnp.asarray(x, DT), jnp.asarray(y, DT)


def run_toeplitz_1m():
    n, iters = 1048576, 200
    w = max(100.0 * 2 * np.pi / n, 1e-4)
    kern = GaussianKernel(h=jnp.asarray(1.0, DT), w=jnp.asarray(w, DT))
    x = jnp.linspace(-np.pi, np.pi, n, dtype=DT)
    rng = np.random.default_rng(0)
    y = jnp.asarray(
        np.sin(50 * np.asarray(x)) + 0.1 * rng.standard_normal(n), DT
    )
    f = jax.jit(lambda x_, y_: fit_iterative(
        kern, x_, y_, 0.1, jax.random.key(0), num_probes=8,
        num_iters=iters, tol=1e-6, jitter=1e-4, structure="toeplitz",
    ).log_marginal)
    return _timed(f, x, y, reps=1)


def run_rff():
    n, F = 1 << 20, 2048
    x, y = sine(n, seed=5)
    w = max(100.0 * 2 * np.pi / n, 1e-3)
    kern = GaussianKernel(h=jnp.asarray(1.0, DT), w=jnp.asarray(w, DT))
    f = jax.jit(lambda x_, y_: fit_rff(
        kern, x_, y_, 0.1, jax.random.key(0), num_features=F,
        block_size=16384, jitter=1e-6,
    ).log_marginal)
    return _timed(f, x, y, reps=1)


def run_sgpr():
    n, m = 1 << 20, 1024
    x, y = sine(n, seed=7)
    w = max(100.0 * 2 * np.pi / n, 1e-3)
    kern = GaussianKernel(h=jnp.asarray(1.0, DT), w=jnp.asarray(w, DT))
    z = kmeans_inducing(jax.random.PRNGKey(0), x, m, iters=5)
    f = jax.jit(lambda x_, y_: fit_sgpr(
        kern, x_, y_, 0.1, z, block_size=8192,
    ).log_marginal)
    return _timed(f, x, y, reps=1)


def run_whittle():
    n = 1 << 20
    rng = np.random.default_rng(0)
    x = jnp.asarray(np.arange(n) * (2 * np.pi / n) - np.pi, DT)
    y = jnp.asarray(
        np.sin(50 * np.asarray(x)) + 0.1 * rng.standard_normal(n), DT
    )
    k = GaussianKernel(h=jnp.asarray(1.0, DT), w=jnp.asarray(0.006, DT))
    lp = make_log_posterior_whittle(k, x, y, prior_std=1.0, jitter=1e-6)
    vg = jax.jit(jax.value_and_grad(lp))
    u0 = jnp.log(jnp.asarray([1.0, 0.006, 0.1], DT))
    return _timed(vg, u0, reps=3)


def run_whittle2d():
    npd = 1024
    rng = np.random.default_rng(0)
    g1 = jnp.linspace(0.0, 1.0, npd, endpoint=False, dtype=DT)
    op = KronOperator(axes=(g1, g1))
    G1, G2 = np.meshgrid(np.arange(npd) / npd, np.arange(npd) / npd,
                         indexing="ij")
    y2 = jnp.asarray(
        (np.sin(2 * np.pi * 20 * G1) * np.cos(2 * np.pi * 13 * G2)
         + 0.1 * rng.standard_normal((npd, npd))).reshape(-1), DT)
    k2 = ARDGaussianKernel(jnp.asarray(1.0, DT),
                           jnp.asarray([0.01, 0.01], DT))
    lp2 = make_log_posterior_whittle_kron(k2, op, y2, prior_std=1.0,
                                          jitter=1e-6)
    vg2 = jax.jit(jax.value_and_grad(lp2))
    u2 = jnp.log(jnp.asarray([1.0, 0.01, 0.01, 0.1], DT))
    return _timed(vg2, u2, reps=3)


def main():
    here = os.path.dirname(os.path.abspath(__file__))
    out_path = os.path.join(here, "cpu_baseline_large.json")
    out = {}
    if os.path.exists(out_path):
        with open(out_path) as f:
            out = json.load(f)

    # dense-equivalent keys from cpu_baseline.json (measured separately)
    dense_path = os.path.join(here, "cpu_baseline.json")
    if os.path.exists(dense_path):
        with open(dense_path) as f:
            dense = json.load(f).get("65536")
        if dense:
            for key in ("iterative", "ski", "toeplitz_65536"):
                out[key] = {
                    "total_s": dense["total_s"],
                    "method": "dense f64 build+cholesky+solve at n=65536 "
                              "(cpu_baseline.py) — the reference's own "
                              "method for the same fit",
                }
                print(json.dumps({key: out[key]}), flush=True)

    only = set(sys.argv[1:])
    for key, fn in (
        ("toeplitz_1048576", run_toeplitz_1m),
        ("rff", run_rff),
        ("sgpr", run_sgpr),
        ("whittle", run_whittle),
        ("whittle2d", run_whittle2d),
        ("chees", run_chees_cpu),
        ("nuts", run_nuts_cpu),
    ):
        if only and key not in only:
            continue
        try:
            t = fn()
            method = ("same algorithm+protocol, XLA-CPU f32, seconds "
                      "per sample" if key in ("chees", "nuts") else
                      "same algorithm, XLA-CPU f64, exact bench.py config")
            out[key] = {"total_s": t, "method": method}
            print(json.dumps({key: out[key]}), flush=True)
        except Exception as e:  # noqa: BLE001 - record and continue
            print(f"# {key} failed: {e!r}", flush=True)

    with open(out_path, "w") as f:
        json.dump(out, f, indent=1)
    print("wrote", out_path)




def run_chees_cpu():
    """Same-protocol ChEES collection throughput on CPU (f32, matching
    bench.py's device protocol: 200 warmup, 200 timed draws, 64 chains)."""
    import time as _t

    import jax as _jax
    import jax.numpy as _jnp

    from gaussian_processes_tpu import GaussianKernel
    from gaussian_processes_tpu.inference import (
        init_positions, make_log_posterior,
    )
    import gaussian_processes_tpu.inference.chees as chees_mod
    from gaussian_processes_tpu.inference.chees import sample_chees

    n, n_chains, n_samp = 500, 64, 200
    rng = np.random.default_rng(0)
    x = np.sort(rng.uniform(-np.pi, np.pi, n)).astype(np.float32)
    y = (np.sin(2 * x) + 0.1 * rng.standard_normal(n)).astype(np.float32)
    k0 = GaussianKernel(h=_jnp.asarray(1.0, _jnp.float32),
                        w=_jnp.asarray(1.0, _jnp.float32))
    log_post = make_log_posterior(k0, x, y, prior_std=1.5, jitter=1e-5)
    k1, k2 = _jax.random.split(_jax.random.key(0))
    init = init_positions(k0, 0.2, k1, n_chains=n_chains, spread=0.2,
                          dtype=_jnp.float32)
    r = sample_chees(log_post, init, k2, num_warmup=200, num_samples=10,
                     init_step_size=0.05, chunk_size=25)
    _jax.block_until_ready(r.positions)
    state = r.final

    def cstep(s, _):
        s, info = chees_mod.chees_step(log_post, s, adapt_traj=False,
                                       max_leapfrog=1000)
        return s, info.num_leapfrog

    run = _jax.jit(lambda s, n_: _jax.lax.scan(cstep, s, None, length=n_),
                   static_argnums=1)
    state, _ = run(state, 25)
    _jax.block_until_ready(state.chains.z)
    t0 = _t.perf_counter()
    done = 0
    while done < n_samp:
        state, _ = run(state, 25)
        done += 25
    _jax.block_until_ready(state.chains.z)
    wall = _t.perf_counter() - t0
    return wall / (n_samp * n_chains)  # seconds per sample


def run_nuts_cpu():
    import time as _t

    import jax as _jax
    import jax.numpy as _jnp

    from gaussian_processes_tpu import GaussianKernel
    from gaussian_processes_tpu.inference import (
        collect, init_positions, make_log_posterior, warmup,
    )

    n, n_chains, n_samp = 500, 64, 200
    rng = np.random.default_rng(0)
    x = np.sort(rng.uniform(-np.pi, np.pi, n)).astype(np.float32)
    y = (np.sin(2 * x) + 0.1 * rng.standard_normal(n)).astype(np.float32)
    k0 = GaussianKernel(h=_jnp.asarray(1.0, _jnp.float32),
                        w=_jnp.asarray(1.0, _jnp.float32))
    log_post = make_log_posterior(k0, x, y, prior_std=1.5, jitter=1e-5)
    k1, k2 = _jax.random.split(_jax.random.key(0))
    init = init_positions(k0, 0.2, k1, n_chains=n_chains, spread=0.2,
                          dtype=_jnp.float32)
    state = warmup(log_post, init, k2, num_warmup=200, max_depth=8,
                   init_step_size=0.05, chunk_size=10)
    _jax.block_until_ready(state.chains.z)
    r = collect(log_post, state, 10, max_depth=8, chunk_size=10)
    _jax.block_until_ready(r.positions)
    t0 = _t.perf_counter()
    r = collect(log_post, r.final, n_samp, max_depth=8, chunk_size=10)
    _jax.block_until_ready(r.positions)
    wall = _t.perf_counter() - t0
    return wall / (n_samp * n_chains)

if __name__ == "__main__":
    main()
