"""Driver benchmark: the full headline metric set, one JSON line each.

The default invocation emits every headline metric as successive JSON
lines and a final combined line:

  1. exact_gp_fit_n16384  — dense fit (build+chol+solve) wall-clock on
     one device, vs the measured CPU reference (BASELINE.json:2)
  2. cholesky_blocked_speedup_n16384 — the GEMM-blocked factorization vs
     XLA's, device-time differenced
  3. iterative_gp_fit_n65536 — matrix-free PCG+SLQ fit (config #4's N on
     one device) + its solve residual
  4. chees_gp_hyper / nuts_gp_hyper — hyperparameter samples/s, 64
     chains (config #3; ChEES is the throughput sampler, NUTS the
     correctness reference)
  5. combined — one line with the lot

Timing protocol (to be replaced by trace-based timing, ROADMAP S0):

1. Every timed call gets fresh input VALUES.
2. Synchronize by fetching a scalar derived from the output
   (``float(out)``); timed functions therefore reduce to (tuples of)
   scalars.
3. Subtract the measured dispatch+fetch floor, but archive the raw
   median and the floor as separate fields and never clip to zero —
   a sub-floor measurement must stay visible.

Sections are independent; a failure prints an "error" line and the rest
still run.  BENCH_MODE selects a single section (fit | chol | iterative |
toeplitz | ski | whittle | rff | sgpr | chees | nuts) for quick runs.
"""

import json
import os
import sys
import time

import numpy as np

DTYPE = os.environ.get("BENCH_DTYPE", "float32")
MODE = os.environ.get("BENCH_MODE", "all")

_RESULTS = {}


def _emit(obj):
    print(json.dumps(obj), flush=True)
    if "metric" in obj and "value" in obj:
        _RESULTS[obj["metric"]] = obj["value"]


def _cpu_vs(key, wall):
    """Speedup vs the same-algorithm CPU run (benchmarks/cpu_large.py).

    The large-N regimes have no dense-CPU equivalent at their sizes (K
    at N=2^20 would be 8.8 TB); the honest denominator is the SAME
    algorithm executed on this host's CPU (f64, XLA-CPU / numpy) —
    measured once per machine into benchmarks/cpu_baseline_large.json.
    """
    if wall is None or wall <= 0:
        return None
    path = os.path.join(os.path.dirname(__file__), "benchmarks",
                        "cpu_baseline_large.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        ref = json.load(f).get(key)
    return round(ref["total_s"] / wall, 2) if ref else None


def _sine_problem(n, seed=0):
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(-np.pi, np.pi, n)).astype(DTYPE)
    y = (np.sin(2 * x) + 0.1 * rng.standard_normal(n)).astype(DTYPE)
    return x, y


def _fetch(jax, out):
    """Synchronize by pulling the output to the host (see header item 2).

    ``out`` must be a scalar or (nested) tuple of scalars/small arrays —
    the device->host transfer cannot complete before the computation
    does.
    """
    return jax.device_get(out)


def _dispatch_floor(jax, jnp):
    """Median wall of a trivial dispatch+fetch round trip (fresh values).

    The per-call cost any fetch-synchronized probe pays; subtracted
    from probe walls to estimate device time (raw wall and floor are
    both archived).
    """
    import uuid

    nonce = float(int(uuid.uuid4()) % 1000003) * 1e-30
    f = jax.jit(lambda a: jnp.sum(a) + nonce)
    rng = np.random.default_rng()
    walls = []
    for i in range(8):
        a = jnp.asarray(rng.standard_normal((8, 128)).astype(np.float32))
        _fetch(jax, jnp.sum(a))  # ensure the upload completed
        t0 = time.perf_counter()
        _fetch(jax, f(a))
        if i > 0:
            walls.append(time.perf_counter() - t0)
    return float(np.median(walls))


def _probe_walls(jax, fn, inputs):
    """Median fetch-synchronized wall over fresh-valued calls.

    Call 0 is the compile.  ``fn`` must return a scalar or a tuple of
    scalars (fetch sync — header item 2).
    """
    import jax.numpy as jnp

    walls = []
    for i, a in enumerate(inputs):
        args = a if isinstance(a, tuple) else (a,)
        _fetch(jax, jnp.sum(jnp.asarray(
            [jnp.sum(x) for x in args], dtype=jnp.float32
        )))  # uploads done
        t0 = time.perf_counter()
        out = fn(*args)
        _fetch(jax, out)
        if i > 0:
            walls.append(time.perf_counter() - t0)
    return float(np.median(walls)), out


def bench_fit():
    """Dense exact-GP fit at N=16384 (kernel build + Cholesky + solves).

    Probe protocol: per-call walls on fresh input values minus the
    measured dispatch floor.
    """
    import uuid

    import jax
    import jax.numpy as jnp

    from gaussian_processes_tpu import GaussianKernel, fit

    N = int(os.environ.get("BENCH_N", 16384))
    x, y = _sine_problem(N)
    kernel = GaussianKernel(h=jnp.asarray(1.0, DTYPE), w=jnp.asarray(1.0, DTYPE))
    nonce = float(int(uuid.uuid4()) % 1000003) * 1e-30

    @jax.jit
    def f(x, y):
        post = fit(kernel, x, y, 0.1, jitter=1e-4)
        return post.log_marginal + nonce

    rng = np.random.default_rng()
    inputs = [
        (jnp.asarray(x * np.float32(1.0 + rng.random() * 1e-3)),
         jnp.asarray(y))
        for _ in range(4)
    ]
    floor = _dispatch_floor(jax, jnp)
    med, out = _probe_walls(jax, f, inputs)
    assert bool(jnp.isfinite(out)), "non-finite log marginal"
    wall = med - floor  # un-clipped; raw + floor archived alongside

    vs = None
    base_path = os.path.join(os.path.dirname(__file__), "benchmarks",
                             "cpu_baseline.json")
    if os.path.exists(base_path):
        with open(base_path) as f2:
            base = json.load(f2)
        ref = base.get(str(N))
        if ref and wall > 0:
            vs = ref["total_s"] / wall
    _emit({"metric": f"exact_gp_fit_n{N}_{DTYPE}_wall",
           "value": round(wall, 6), "unit": "s",
           "wall_raw": round(med, 6), "floor": round(floor, 6),
           "vs_baseline": round(vs, 2) if vs else None})


def bench_chol():
    """Blocked-vs-XLA Cholesky at N=16384, probe protocol (see bench_fit)."""
    import uuid

    import jax
    import jax.numpy as jnp

    from gaussian_processes_tpu.ops.blocked_cholesky import cholesky_blocked

    n = int(os.environ.get("BENCH_CHOL_N", 16384))
    base = int(os.environ.get("BENCH_CHOL_BASE", 512))
    algo = os.environ.get("BENCH_CHOL_ALGO", "leftlook")
    x, _ = _sine_problem(n)
    d = x[:, None] - x[None, :]
    A0 = np.exp(-0.5 * d * d) + 0.01 * np.eye(n, dtype=np.float32)
    del d
    nonce = float(int(uuid.uuid4()) % 1000003) * 1e-30
    rng = np.random.default_rng()
    floor = _dispatch_floor(jax, jnp)

    def probe(fn):
        jfn = jax.jit(lambda A: jnp.sum(fn(A)) + nonce)
        inputs = [
            jnp.asarray(A0 * np.float32(1.0 + rng.random() * 1e-3))
            for _ in range(4)
        ]
        med, _ = _probe_walls(jax, jfn, inputs)
        return med - floor, med

    t_xla, raw_xla = probe(jnp.linalg.cholesky)
    t_blk, raw_blk = probe(lambda A: cholesky_blocked(A, base=base, algo=algo))
    flops = n**3 / 3
    # sub-floor walls (med <= dispatch floor) make the derived ratios
    # meaningless — emit None for them, keeping raw wall + floor archived
    # (same guard as _cpu_vs / bench_fit)
    _emit({"metric": f"cholesky_xla_n{n}_dev", "value": round(t_xla, 5),
           "unit": "s",
           "tflops": round(flops / t_xla / 1e12, 1) if t_xla > 0 else None,
           "wall_raw": round(raw_xla, 5), "floor": round(floor, 5),
           "vs_baseline": None})
    _emit({"metric": f"cholesky_blocked{base}_{algo}_n{n}_dev",
           "value": round(t_blk, 5), "unit": "s",
           "tflops": round(flops / t_blk / 1e12, 1) if t_blk > 0 else None,
           "wall_raw": round(raw_blk, 5), "floor": round(floor, 5),
           "vs_baseline": round(t_xla / t_blk, 2)
           if t_blk > 0 and t_xla > 0 else None})


def bench_iterative():
    """Matrix-free fit at N=65536 — config #4's N on one device."""
    import jax
    import jax.numpy as jnp

    from gaussian_processes_tpu import GaussianKernel, fit_iterative

    n = int(os.environ.get("BENCH_ITER_N", 65536))
    x, y = _sine_problem(n)
    # lengthscale scaled so ~100 points fall within one w: a realistic
    # large-N regression (w=1 at n=65k is numerically and statistically
    # degenerate — condition ~ n h^2 / s^2 exceeds f32 CG's reach)
    w = max(100.0 * 2 * np.pi / n, 1e-3)
    kernel = GaussianKernel(h=jnp.asarray(1.0, DTYPE), w=jnp.asarray(w, DTYPE))

    iters = int(os.environ.get("BENCH_ITERS", 150))
    rank = int(os.environ.get("BENCH_PRECOND_RANK", 2048))

    @jax.jit
    def f(x_, y_):
        p = fit_iterative(
            kernel, x_, y_, 0.1, jax.random.key(0),
            num_probes=8, num_iters=iters, tol=1e-6, jitter=1e-4,
            block_size=2048, precond_rank=rank,
        )
        return p.log_marginal, p.solve_residual

    rng = np.random.default_rng()
    floor = _dispatch_floor(jax, jnp)
    inputs = [
        (jnp.asarray(x), jnp.asarray(y * np.float32(1 + rng.random() * 1e-3)))
        for _ in range(3)
    ]
    med, (lml, res) = _probe_walls(jax, f, inputs)
    assert bool(jnp.isfinite(lml)), "non-finite lml estimate"
    _emit({"metric": f"iterative_gp_fit_n{n}_{DTYPE}_wall",
           "value": round(med - floor, 4), "unit": "s",
           "wall_raw": round(med, 4), "floor": round(floor, 4),
           "residual": float(res),
           "vs_baseline": _cpu_vs("iterative", med - floor)})


def bench_toeplitz():
    """Gridded-input structured path: FFT matvecs + circulant preconditioner.

    Two metrics: the N=65536 gridded fit (same workload class as the
    iterative section but on a uniform grid, where the Toeplitz path
    applies — measured 24x over the strip+pivoted-Cholesky fit) and an
    N=2^20 fit, a size with no dense equivalent anywhere (K would be
    4.4 TB).
    """
    import uuid

    import jax
    import jax.numpy as jnp

    from gaussian_processes_tpu import GaussianKernel, fit_iterative

    rng = np.random.default_rng()
    nonce = float(int(uuid.uuid4()) % 1000003) * 1e-30
    floor = _dispatch_floor(jax, jnp)

    for n, iters in ((65536, 150), (1048576, 200)):
        w = max(100.0 * 2 * np.pi / n, 1e-4)
        kern = GaussianKernel(h=jnp.asarray(1.0, DTYPE), w=jnp.asarray(w, DTYPE))
        x = np.linspace(-np.pi, np.pi, n).astype(DTYPE)
        y = (np.sin(50 * x) + 0.1 * rng.standard_normal(n)).astype(DTYPE)

        @jax.jit
        def f(x_, y_, kern=kern, iters=iters):
            p = fit_iterative(kern, x_, y_, 0.1, jax.random.key(0),
                              num_probes=8, num_iters=iters, tol=1e-6,
                              jitter=1e-4, structure="toeplitz")
            return p.log_marginal + nonce, p.solve_residual

        inputs = [
            (jnp.asarray(x), jnp.asarray(y * np.float32(1 + rng.random() * 1e-3)))
            for _ in range(4 if n < 1e6 else 3)
        ]
        med, out = _probe_walls(jax, lambda a, b: f(a, b), inputs)
        lml, res = out
        assert bool(jnp.isfinite(lml)), "non-finite lml"
        _emit({"metric": f"toeplitz_gp_fit_n{n}_grid_{DTYPE}_wall",
               "value": round(med - floor, 4), "unit": "s",
               "wall_raw": round(med, 4), "floor": round(floor, 4),
               "residual": float(res),
               "vs_baseline": _cpu_vs(f"toeplitz_{n}", med - floor)})


def _scan_diff_step(jax, jnp, lp, u0, k_short=16, k_long=128, reps=3):
    """Per-step device wall of a chained value+grad by scan differencing.

    Sub-floor protocol (VERDICT r4 item 3): run k_short vs k_long
    chained value-and-grad steps inside ONE jit — the carry is perturbed
    by a bounded function of the gradient, so every step depends on the
    last — and difference the two walls.  Dispatch overhead cancels
    exactly; the result stays meaningful below the dispatch floor where
    per-call probing mints noise.
    """
    from jax import lax

    vg = jax.value_and_grad(lp)

    def make_chain(iters):
        @jax.jit
        def chain(u, eps):
            def step(u, _):
                v, g = vg(u)
                # bounded, value-dependent carry update: keeps u in a
                # tiny neighborhood while making every step's input
                # depend on the previous step's gradient
                return u + eps * jnp.tanh(g), v
            return lax.scan(step, u, None, length=iters)
        return chain

    c_s, c_l = make_chain(k_short), make_chain(k_long)
    eps = jnp.asarray(1e-6, u0.dtype)
    rng = np.random.default_rng()

    def run(c):
        u = u0 + np.asarray(rng.random() * 1e-4, u0.dtype)  # fresh value
        uf, vs = c(u, eps)
        _fetch(jax, (jnp.sum(uf), jnp.sum(vs)))
        return vs

    run(c_s)
    vs = run(c_l)  # compile both
    assert bool(jnp.all(jnp.isfinite(vs))), "non-finite chained log-post"
    ts, tl = [], []
    for _ in range(reps):
        t0 = time.perf_counter(); run(c_s); ts.append(time.perf_counter() - t0)
        t0 = time.perf_counter(); run(c_l); tl.append(time.perf_counter() - t0)
    delta = min(tl) - min(ts)
    step_s = delta / (k_long - k_short)
    # resolution guard: the difference must clear the wall-timing noise
    # or the per-step value is noise.  k defaults are sized so a
    # resolvable op gives delta >> noise; `resolved` tells the caller
    # whether to archive a ratio or only a lower bound.
    resolved = delta > 0.1 * min(ts)
    return step_s, min(ts), min(tl), resolved


def bench_whittle():
    """Whittle (circulant-model) posterior value+grad latency at N=2^20.

    The per-leapfrog cost of fully Bayesian hyperparameters on 1M-point
    grids (benchmarks/demo_bayes1m.py): three FFT/elementwise ops,
    deterministic, plain autodiff.  Device time here can dip below the
    dispatch floor, so both variants use the scan-differenced in-jit
    protocol (_scan_diff_step) instead of per-call probing.
    """
    import jax
    import jax.numpy as jnp

    from gaussian_processes_tpu import GaussianKernel
    from gaussian_processes_tpu.inference import make_log_posterior_whittle

    n = int(os.environ.get("BENCH_WHITTLE_N", 1 << 20))
    rng = np.random.default_rng()
    x = (np.arange(n) * (2 * np.pi / n) - np.pi).astype(DTYPE)
    y = (np.sin(50 * x) + 0.1 * rng.standard_normal(n)).astype(DTYPE)
    k = GaussianKernel(h=jnp.asarray(1.0, DTYPE), w=jnp.asarray(0.006, DTYPE))
    lp = make_log_posterior_whittle(k, x, y, prior_std=1.0, jitter=1e-6)
    u0 = jnp.log(jnp.asarray([1.0, 0.006, 0.1], DTYPE))
    step_s, s_wall, l_wall, ok = _scan_diff_step(jax, jnp, lp, u0)
    _emit({"metric": f"whittle_logpost_vg_n{n}_{DTYPE}_wall",
           "value": round(step_s, 6), "unit": "s",
           "protocol": "scan-diff k=16 vs k=128, perturbed carry",
           "short_wall": round(s_wall, 5), "long_wall": round(l_wall, 5),
           "vs_baseline": _cpu_vs("whittle", step_s) if ok else None,
           **({} if ok else
              {"vs_baseline_lower_bound": _cpu_vs("whittle", l_wall / 128)})})

    # 2-D torus variant: the per-leapfrog cost of fully Bayesian
    # hyperparameters on a 1024x1024 grid (D-dim Whittle, one fftn)
    from gaussian_processes_tpu.inference import (
        make_log_posterior_whittle_kron,
    )
    from gaussian_processes_tpu.models.ard import ARDGaussianKernel
    from gaussian_processes_tpu.ops.kronecker import KronOperator

    npd = int(os.environ.get("BENCH_WHITTLE2D_N", 1024))
    g1 = jnp.linspace(0.0, 1.0, npd, endpoint=False, dtype=DTYPE)
    op = KronOperator(axes=(g1, g1))
    G1, G2 = np.meshgrid(np.arange(npd) / npd, np.arange(npd) / npd,
                         indexing="ij")
    y2 = (np.sin(2 * np.pi * 20 * G1) * np.cos(2 * np.pi * 13 * G2)
          + 0.1 * rng.standard_normal((npd, npd))).reshape(-1).astype(DTYPE)
    k2 = ARDGaussianKernel(jnp.asarray(1.0, DTYPE),
                           jnp.asarray([0.01, 0.01], DTYPE))
    lp2 = make_log_posterior_whittle_kron(
        k2, op, jnp.asarray(y2), prior_std=1.0, jitter=1e-6
    )
    u2 = jnp.log(jnp.asarray([1.0, 0.01, 0.01, 0.1], DTYPE))
    step2, s2, l2, ok2 = _scan_diff_step(jax, jnp, lp2, u2)
    _emit({"metric": f"whittle2d_logpost_vg_n{npd * npd}_{DTYPE}_wall",
           "value": round(step2, 6), "unit": "s",
           "protocol": "scan-diff k=16 vs k=128, perturbed carry",
           "short_wall": round(s2, 5), "long_wall": round(l2, 5),
           "vs_baseline": _cpu_vs("whittle2d", step2) if ok2 else None,
           **({} if ok2 else
              {"vs_baseline_lower_bound": _cpu_vs("whittle2d", l2 / 128)})})


def bench_ski():
    """SKI/KISS-GP fit on SCATTERED inputs (no grid) at config-#4 N and 4x.

    Same workload class as the iterative section (scattered sine data)
    but the matvecs run through an inducing grid: O(n) gather/scatter +
    O(m log m) FFT instead of the O(n^2) strip — the structured path off
    the grid.  Preconditioner: pivoted Cholesky on the exact kernel
    (K_ski ~ K, so it preconditions the surrogate equally well).
    """
    import uuid

    import jax
    import jax.numpy as jnp

    from gaussian_processes_tpu import GaussianKernel, fit_iterative
    from gaussian_processes_tpu.ops import ski

    rng = np.random.default_rng()
    nonce = float(int(uuid.uuid4()) % 1000003) * 1e-30

    # one size: at n ~ 6e4+ with a smooth rhs, f32 CG through the SKI
    # operator runs near its round-off floor (ops/ski.py docstring) —
    # the emitted residual is the honest record of where it lands
    for n, m, iters, rank in ((65536, 16384, 300, 2048),):
        w = max(100.0 * 2 * np.pi / n, 1e-4)
        kern = GaussianKernel(h=jnp.asarray(1.0, DTYPE), w=jnp.asarray(w, DTYPE))
        x, y = _sine_problem(n, seed=3)
        op = ski.interpolation_weights(
            jnp.asarray(x), ski.make_grid(jnp.asarray(x), m)
        )

        @jax.jit
        def f(x_, y_, kern=kern, op=op, iters=iters, rank=rank):
            p = fit_iterative(kern, x_, y_, 0.1, jax.random.key(0),
                              num_probes=8, num_iters=iters, tol=1e-6,
                              jitter=1e-4, precond_rank=rank, structure=op)
            return p.log_marginal + nonce, p.solve_residual

        inputs = [
            (jnp.asarray(x), jnp.asarray(y * np.float32(1 + rng.random() * 1e-3)))
            for _ in range(3)
        ]
        floor = _dispatch_floor(jax, jnp)
        med, out = _probe_walls(jax, lambda a, b: f(a, b), inputs)
        lml, res = out
        assert bool(jnp.isfinite(lml)), "non-finite lml"
        _emit({"metric": f"ski_gp_fit_n{n}_scattered_m{m}_{DTYPE}_wall",
               "value": round(med - floor, 4), "unit": "s",
               "wall_raw": round(med, 4), "floor": round(floor, 4),
               "residual": float(res),
               "vs_baseline": _cpu_vs("ski", med - floor)})


def bench_ski_refine():
    """ND-SKI fit + double-f32 refinement, scattered 2-D — the round-3
    flagship numerics result as a recurring metric (VERDICT r3 item 4).

    Round-5 revision (VERDICT r4 items 2c/5): the default shape is a
    ~30 s n=16384 workload, and each phase runs TWICE with
    fresh input values — the first call is compile-inclusive, the second
    measures the steady executable — so the recurring line separates
    XLA compile state from the numerics it exists to guard.  Emits
    compile_s (first minus steady) and steady walls per phase; `value`
    is the steady refine wall.

    Workload: scattered points in [-1,1]^2, m1 x m1 inducing grid,
    ARD-SE kernel, f32.  Fit: preconditioned CG with residual
    replacement (plain FFT matvec).  Refine: ski_kron_refine — two-float
    correction solves with the compensated in-loop matvec, reusing the
    fit's pivoted-Cholesky preconditioner.  The compensated pair
    residual is the gated numerics record (f64 oracle in
    tests/test_twofloat.py).
    """
    import jax
    import jax.numpy as jnp

    from gaussian_processes_tpu import fit_iterative
    from gaussian_processes_tpu.models.ard import ARDGaussianKernel
    from gaussian_processes_tpu.ops import krylov, ski

    n = int(os.environ.get("BENCH_SKIREF_N", 16384))
    m1 = int(os.environ.get("BENCH_SKIREF_M1", 64))
    iters = int(os.environ.get("BENCH_SKIREF_ITERS", 150))
    rank = int(os.environ.get("BENCH_SKIREF_RANK", 256))
    rounds = int(os.environ.get("BENCH_SKIREF_ROUNDS", 1))
    rng = np.random.default_rng(7)
    x = rng.uniform(-1, 1, (n, 2)).astype(np.float32)
    y = (np.sin(3 * x[:, 0]) * np.cos(2 * x[:, 1])
         + 0.1 * rng.standard_normal(n)).astype(np.float32)
    kern = ARDGaussianKernel(jnp.asarray(1.0, jnp.float32),
                             jnp.asarray([0.15, 0.15], jnp.float32))
    xj = jnp.asarray(x)
    g = ski.make_grid(xj[:, 0], m1), ski.make_grid(xj[:, 1], m1)
    op = ski.interpolation_weights_nd(xj, g)

    L = krylov.pivoted_cholesky(kern, xj, rank)  # shared fit+refine
    _fetch(jax, jnp.sum(L))

    def one_pass(y_host):
        yj = jnp.asarray(y_host)
        t0 = time.perf_counter()
        p = fit_iterative(kern, xj, yj, 0.1, jax.random.key(0),
                          num_probes=8, num_iters=iters, tol=1e-7,
                          jitter=1e-4, precond_rank=rank, structure=op,
                          replace_every=10, precond_L=L)
        _fetch(jax, p.log_marginal + jnp.sum(p.alpha))
        fit_wall = time.perf_counter() - t0
        assert bool(jnp.isfinite(p.log_marginal)), "non-finite ND-SKI lml"
        t0 = time.perf_counter()
        (ah, al), rel = ski.ski_kron_refine(
            kern, op, x, p.alpha, yj, 0.1, jitter=1e-4,
            rounds=rounds, num_iters=iters, precond_L=L,
        )
        _fetch(jax, jnp.sum(ah) + jnp.sum(al))
        ref_wall = time.perf_counter() - t0
        return fit_wall, ref_wall, float(p.solve_residual), float(rel)

    fit_first, ref_first, _, _ = one_pass(y)  # compile-inclusive
    fit_steady, ref_steady, fit_res, rel = one_pass(
        y * np.float32(1.0 + np.random.default_rng().random() * 1e-3)
    )  # fresh values, warm executables
    total_steady = fit_steady + ref_steady

    # dense-equivalent CPU denominator at the same n, when measured
    # (benchmarks/cpu_baseline.json: the reference's own dense f64
    # build+cholesky+solve for the same fit)
    vs = None
    base_path = os.path.join(os.path.dirname(__file__), "benchmarks",
                             "cpu_baseline.json")
    if os.path.exists(base_path):
        with open(base_path) as f2:
            ref_rec = json.load(f2).get(str(n))
        if ref_rec and total_steady > 0:
            vs = round(ref_rec["total_s"] / total_steady, 2)
    _emit({"metric": f"ski_kron_refine_n{n}_2d_m{m1 * m1}_{DTYPE}",
           "value": round(ref_steady, 3), "unit": "s",
           "fit_steady_s": round(fit_steady, 3),
           "compile_s": round((fit_first - fit_steady)
                              + (ref_first - ref_steady), 3),
           "fit_first_s": round(fit_first, 3),
           "refine_first_s": round(ref_first, 3),
           "total_steady_s": round(total_steady, 3),
           "residual_fit": fit_res,
           "residual_pair": rel,
           "vs_baseline": vs})


def bench_rff():
    """Feature-space GP fit at N=2^20 SCATTERED points (models/rff.py).

    One blocked O(n F^2) matmul sweep + an F x F Cholesky — the third
    large-N regime (no structure required, no CG).  Residual-free by
    construction; accuracy is the O(1/sqrt F) feature approximation.
    """
    import uuid

    import jax
    import jax.numpy as jnp

    from gaussian_processes_tpu import GaussianKernel, fit_rff

    n = int(os.environ.get("BENCH_RFF_N", 1 << 20))
    F = int(os.environ.get("BENCH_RFF_F", 2048))
    x, y = _sine_problem(n, seed=5)
    w = max(100.0 * 2 * np.pi / n, 1e-3)
    kern = GaussianKernel(h=jnp.asarray(1.0, DTYPE), w=jnp.asarray(w, DTYPE))
    nonce = float(int(uuid.uuid4()) % 1000003) * 1e-30
    rng = np.random.default_rng()

    @jax.jit
    def f(x_, y_):
        p = fit_rff(kern, x_, y_, 0.1, jax.random.key(0),
                    num_features=F, block_size=16384, jitter=1e-6)
        return p.log_marginal + nonce

    floor = _dispatch_floor(jax, jnp)
    inputs = [
        (jnp.asarray(x), jnp.asarray(y * np.float32(1 + rng.random() * 1e-3)))
        for _ in range(3)
    ]
    med, out = _probe_walls(jax, lambda a, b: f(a, b), inputs)
    assert bool(jnp.isfinite(out)), "non-finite rff lml"
    _emit({"metric": f"rff_gp_fit_n{n}_F{F}_{DTYPE}_wall",
           "value": round(med - floor, 4), "unit": "s",
           "wall_raw": round(med, 4), "floor": round(floor, 4),
           "vs_baseline": _cpu_vs("rff", med - floor)})


def bench_sgpr():
    """Sparse (Titsias) GP fit at N=2^20 SCATTERED points (models/sgpr.py).

    One blocked O(n m^2) matmul sweep + (m, m) eig algebra — the fourth
    large-N regime: data-placed inducing points, calibrated variances,
    no CG.  The emitted value is the fit wall; the bound and a
    prediction check gate sanity.
    """
    import uuid

    import jax
    import jax.numpy as jnp

    from gaussian_processes_tpu import GaussianKernel, fit_sgpr
    from gaussian_processes_tpu.models.sgpr import (
        kmeans_inducing, predict_sgpr,
    )

    n = int(os.environ.get("BENCH_SGPR_N", 1 << 20))
    m = int(os.environ.get("BENCH_SGPR_M", 1024))
    x, y = _sine_problem(n, seed=7)
    w = max(100.0 * 2 * np.pi / n, 1e-3)
    kern = GaussianKernel(h=jnp.asarray(1.0, DTYPE), w=jnp.asarray(w, DTYPE))
    z = kmeans_inducing(jax.random.PRNGKey(0), jnp.asarray(x), m, iters=5)
    z = jax.block_until_ready(z)
    nonce = float(int(uuid.uuid4()) % 1000003) * 1e-30
    rng = np.random.default_rng()

    @jax.jit
    def f(x_, y_):
        p = fit_sgpr(kern, x_, y_, 0.1, z, block_size=8192)
        return p.log_marginal + nonce

    floor = _dispatch_floor(jax, jnp)
    inputs = [
        (jnp.asarray(x), jnp.asarray(y * np.float32(1 + rng.random() * 1e-3)))
        for _ in range(3)
    ]
    med, out = _probe_walls(jax, lambda a, b: f(a, b), inputs)
    assert bool(jnp.isfinite(out)), "non-finite sgpr bound"
    post = fit_sgpr(kern, jnp.asarray(x), jnp.asarray(y), 0.1, z,
                    block_size=8192)
    xo = jnp.linspace(float(np.min(x)), float(np.max(x)), 64).astype(DTYPE)
    mean, var = predict_sgpr(post, xo)
    assert bool(jnp.all(jnp.isfinite(mean)) and jnp.all(var > -1e-3)), \
        "sgpr predictions unhealthy"
    _emit({"metric": f"sgpr_gp_fit_n{n}_m{m}_{DTYPE}_wall",
           "value": round(med - floor, 4), "unit": "s",
           "wall_raw": round(med, 4), "floor": round(floor, 4),
           "vs_baseline": _cpu_vs("sgpr", med - floor)})


def _sampler_problem(n=500, n_chains=64):
    import jax
    import jax.numpy as jnp

    from gaussian_processes_tpu import GaussianKernel
    from gaussian_processes_tpu.inference import (
        init_positions,
        make_log_posterior,
    )

    x, y = _sine_problem(n)
    k0 = GaussianKernel(h=jnp.asarray(1.0, DTYPE), w=jnp.asarray(1.0, DTYPE))
    log_post = make_log_posterior(k0, x, y, prior_std=1.5, jitter=1e-5)
    k1, k2 = jax.random.split(jax.random.key(0))
    init = init_positions(k0, 0.2, k1, n_chains=n_chains, spread=0.2,
                          dtype=jnp.dtype(DTYPE))
    return log_post, init, k2


def bench_chees():
    """ChEES-HMC samples/s, 64 chains — PINNED protocol (VERDICT r2 weak #3).

    Protocol: 200 warmup (step-size + trajectory adaptation), then time
    200 collection transitions in chunks of 25 with adapt_traj=False,
    fetch-synchronized.  The adapted trajectory length varies run-to-run
    (harmonic pooling across chains) and samples/s is proportional to
    1/leapfrog-per-sample, so the emitted record carries mean_leapfrog
    and the adapted step size — a throughput drift WITHOUT a matching
    mean_leapfrog drift is a perf regression; one WITH it is the
    adaptation landing elsewhere (the round-2 418-vs-1017 discrepancy
    was exactly this, unrecorded).
    """
    import jax
    import jax.numpy as jnp

    import gaussian_processes_tpu.inference.chees as chees_mod
    from gaussian_processes_tpu.inference.chees import sample_chees

    n, n_chains, n_samp = 500, 64, 200
    log_post, init, k2 = _sampler_problem(n, n_chains)
    # warmup once (compiles both phases), then time pure collection by
    # continuing from the warm state with the same chunked scan
    r = sample_chees(log_post, init, k2, num_warmup=200, num_samples=10,
                     init_step_size=0.05, chunk_size=25)
    _fetch(jax, jnp.sum(r.positions))
    state = r.final

    def cstep(s, _):
        s, info = chees_mod.chees_step(
            log_post, s, adapt_traj=False, max_leapfrog=1000
        )
        return s, (info.num_leapfrog, s.chains.z)

    run = jax.jit(lambda s, n_: jax.lax.scan(cstep, s, None, length=n_),
                  static_argnums=1)
    state, _ = run(state, 25)  # compile the collection chunk
    _fetch(jax, jnp.sum(state.chains.z))
    t0 = time.perf_counter()
    done, nl_chunks, z_chunks = 0, [], []
    while done < n_samp:
        state, (nls, zs) = run(state, min(25, n_samp - done))
        nl_chunks.append(nls)
        z_chunks.append(zs)
        done += 25
    _fetch(jax, jnp.sum(state.chains.z))
    wall = time.perf_counter() - t0
    nl_sum = float(sum(float(jnp.sum(c)) for c in nl_chunks))
    rate = n_samp * n_chains / wall
    # ESS of the TIMED draws (the policy's claim is an ESS/s ratio —
    # VERDICT r3 weak #1 — so the recurring record must carry it)
    from gaussian_processes_tpu.inference.diagnostics import summarize
    draws = np.concatenate([np.asarray(c) for c in z_chunks])  # (S, C, D)
    diag = summarize(draws, wall_s=wall)
    _emit({"metric": f"chees_gp_hyper_n{n}_c{n_chains}_{DTYPE}",
           "value": round(rate, 2),
           "unit": "samples/s", "wall_raw": round(wall, 3),
           "mean_leapfrog": round(nl_sum / n_samp, 1),
           "step_size": round(float(jnp.mean(state.step_size)), 5),
           "min_ess": round(diag["min_ess"], 1),
           "ess_per_s": round(diag["ess_per_s"], 2),
           "max_rhat": round(diag["max_rhat"], 4),
           "protocol": "warmup200+collect200/chunk25/adapt_traj=False",
           "vs_baseline": _cpu_vs("chees", 1.0 / rate)})


def bench_nuts():
    import jax
    import jax.numpy as jnp

    from gaussian_processes_tpu.inference import collect, warmup

    n, n_chains, n_samp = 500, 64, 200
    log_post, init, k2 = _sampler_problem(n, n_chains)
    # chunked dispatches (semantics are unchanged)
    state = warmup(log_post, init, k2, num_warmup=200, max_depth=8,
                   init_step_size=0.05, chunk_size=10)
    _fetch(jax, jnp.sum(state.chains.z))
    r = collect(log_post, state, 10, max_depth=8, chunk_size=10)  # compile
    _fetch(jax, jnp.sum(r.positions))
    t0 = time.perf_counter()
    r = collect(log_post, r.final, n_samp, max_depth=8, chunk_size=10)
    _fetch(jax, jnp.sum(r.positions))
    wall = time.perf_counter() - t0
    # lane utilization: vectorized chains run trees in lockstep, so each
    # transition costs ~the max leapfrog count over chains; the NUTS-vs-
    # ChEES policy rests on this number staying low
    # (VERDICT r2 weak #6 — keep the premise measured)
    nl = jnp.asarray(r.num_leapfrog, jnp.float32)  # (num_samples, C)
    util_lane = float(jnp.mean(nl) / jnp.mean(jnp.max(nl, axis=1)))
    rate = n_samp * n_chains / wall
    from gaussian_processes_tpu.inference.diagnostics import summarize
    diag = summarize(np.asarray(r.positions), wall_s=wall)
    _emit({"metric": f"nuts_gp_hyper_n{n}_c{n_chains}_{DTYPE}",
           "value": round(rate, 2),
           "unit": "samples/s", "wall_raw": round(wall, 3),
           "mean_leapfrog": round(float(jnp.mean(nl)), 1),
           "lane_utilization": round(util_lane, 3),
           "min_ess": round(diag["min_ess"], 1),
           "ess_per_s": round(diag["ess_per_s"], 2),
           "max_rhat": round(diag["max_rhat"], 4),
           "vs_baseline": _cpu_vs("nuts", 1.0 / rate)})


# cheap-first (VERDICT r4 item 2a): headline fit/Cholesky, the sub-floor
# latency probes, the blocked-sweep large-N fits, and BOTH samplers run
# before the multi-minute structured sections, so a budget/timeout cut
# never costs the round its sampler record again (BENCH_r04 rc=124).
_SECTIONS = {
    "fit": bench_fit,
    "chees": bench_chees,
    "nuts": bench_nuts,
    "whittle": bench_whittle,
    "rff": bench_rff,
    "sgpr": bench_sgpr,
    "chol": bench_chol,
    "toeplitz": bench_toeplitz,
    "ski": bench_ski,
    "ski_refine": bench_ski_refine,
    "iterative": bench_iterative,
}


def main():
    if MODE != "all":
        from gaussian_processes_tpu.utils import enable_compile_cache

        enable_compile_cache()
        _SECTIONS[MODE]()
        return
    # wall-clock budget (VERDICT r4 item 2b): once elapsed time crosses
    # BENCH_BUDGET_S, remaining sections emit an explicit skipped line
    # instead of running — the suite always finishes and always emits
    # headline_suite.  Each section runs in a SUBPROCESS
    # (BENCH_MODE=<name>) with a hard timeout = min(BENCH_SECTION_
    # TIMEOUT_S, remaining budget); this parent never touches JAX, so
    # one process at a time holds the device.
    import subprocess

    budget = float(os.environ.get("BENCH_BUDGET_S", 600))
    cap = float(os.environ.get("BENCH_SECTION_TIMEOUT_S", 240))
    t_suite = time.perf_counter()

    def run_section(name, timeout_s):
        """Run one section subprocess; True on success, else the reason."""
        env = dict(os.environ, BENCH_MODE=name)
        try:
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__)],
                env=env, timeout=timeout_s,
                capture_output=True, text=True,
            )
        except subprocess.TimeoutExpired:
            return "timeout"
        except Exception as e:  # noqa: BLE001 - sections are independent
            print(f"# section {name} failed: {e!r}", file=sys.stderr)
            return repr(e)[:300]
        for line in proc.stdout.splitlines():
            line = line.strip()
            if line.startswith("{"):
                try:
                    _emit(json.loads(line))
                except json.JSONDecodeError:
                    pass
        if proc.returncode != 0:
            return f"rc={proc.returncode}: {(proc.stderr or '')[-300:]}"
        return True

    # one pass over all sections: a failure is reported, not retried
    pending = []
    reasons = {}
    for name in _SECTIONS:
        remaining = budget - (time.perf_counter() - t_suite)
        if remaining < 30:
            pending.append(name)
            continue
        res = run_section(name, min(cap, remaining))
        if res is not True:
            reasons[name] = res
            pending.append(name)
    elapsed = round(time.perf_counter() - t_suite, 1)
    for name in pending:
        reason = reasons.get(name, "budget")
        rec = {"metric": f"{name}_skipped", "value": None,
               "elapsed_s": elapsed, "budget_s": budget}
        if reason in ("timeout", "budget"):
            rec["skipped"] = reason
        else:
            rec["skipped"] = "error"
            rec["error"] = reason
        _emit(rec)
    # final combined line: headline first, everything else alongside
    fit_key = f"exact_gp_fit_n{int(os.environ.get('BENCH_N', 16384))}_{DTYPE}_wall"
    vs = None
    base_path = os.path.join(os.path.dirname(__file__), "benchmarks",
                             "cpu_baseline.json")
    if os.path.exists(base_path) and _RESULTS.get(fit_key):
        with open(base_path) as f:
            base = json.load(f)
        ref = base.get(str(int(os.environ.get("BENCH_N", 16384))))
        if ref and _RESULTS[fit_key] > 0:
            vs = round(ref["total_s"] / _RESULTS[fit_key], 2)
    print(json.dumps({
        "metric": "headline_suite",
        "value": _RESULTS.get(fit_key),
        "unit": "s",
        "vs_baseline": vs,
        "all": _RESULTS,
    }), flush=True)


if __name__ == "__main__":
    main()
