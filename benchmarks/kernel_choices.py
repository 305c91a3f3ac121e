"""Measure the choices the GPU dispatch rules rest on.

    python benchmarks/kernel_choices.py [section ...]

Sections (all by default): ``matvec`` (fused Pallas matvec against the
strip scan, n = 65,536, r = 9, several tile shapes), ``jacvec`` (P = 2
and 3), ``iterative`` (``fit_iterative`` end to end with either matvec),
``build`` (the jitted XLA K build at n = 16,384 against its write bound),
``chol`` (cuSOLVER against the blocked left-looking factorization, with
a float64 reconstruction gate per precision), ``solve`` (1-RHS, 2048-RHS
and n-RHS triangular solves), ``precision`` (whether a DEFAULT f32
matmul runs in TF32), ``grad`` (the dense gradient's error per component
against float64, and a TF32 control) and ``step_spread`` (the pooled
sampler step size over sampler keys, which sets chip_smoke.py's
four-card limit).

Needs a GPU.  Each result is one JSON line on stdout, also appended to
``chiprun_out/kernel_choices.jsonl``.  Times are medians of host-clock
walls around ``block_until_ready`` after a compile call.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax import lax  # noqa: E402

from gaussian_processes_tpu import GaussianKernel, PeriodicKernel  # noqa: E402
from gaussian_processes_tpu.ops import krylov, pairwise  # noqa: E402
from gaussian_processes_tpu.utils.compile_cache import (  # noqa: E402
    enable_compile_cache,
)

_OUT = os.path.join("chiprun_out", "kernel_choices.jsonl")


def emit(**rec):
    line = json.dumps(rec)
    print(line, flush=True)
    os.makedirs(os.path.dirname(_OUT), exist_ok=True)
    with open(_OUT, "a") as f:
        f.write(line + "\n")


def wall(fn, *args, reps=7):
    jax.block_until_ready(fn(*args))  # compile
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def sine_problem(n, seed=0):
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(-np.pi, np.pi, n)).astype(np.float32)
    y = (np.sin(2 * x) + 0.1 * rng.standard_normal(n)).astype(np.float32)
    return x, y


def iterative_kernel(n):
    return GaussianKernel(h=jnp.float32(1.0),
                          w=jnp.float32(100.0 * 2 * np.pi / n))


def strip_jacvec(kernel, x, u, block):
    n = x.shape[0]
    nb = n // block
    xb = x.reshape(nb, block)
    ub = u.reshape(nb, block, u.shape[1])

    def step(acc, xu):
        xj, uj = xu
        J = kernel.jacobian(x, xj)
        return acc + jnp.einsum("pnb,br->pnr", J, uj,
                                precision=lax.Precision.HIGHEST), None

    P = len(type(kernel).param_names)
    acc0 = jnp.zeros((P, n, u.shape[1]), u.dtype)
    return lax.scan(step, acc0, (xb, ub))[0]


def section_matvec():
    n, r = 65536, 9
    x, _ = sine_problem(n)
    x = jnp.asarray(x)
    v = jnp.asarray(np.random.default_rng(1).standard_normal((n, r)),
                    jnp.float32)
    k = iterative_kernel(n)
    strip = jax.jit(lambda x, v: krylov.kernel_matvec(
        k, x, v, 0.1, 1e-4, block_size=2048, impl="strip"))
    ref = strip(x, v)
    # float64 reference on 64 rows
    xs = np.asarray(x, np.float64)
    rows = np.arange(0, n, n // 64)
    d = xs[rows, None] - xs[None, :]
    Kr = np.exp(-0.5 * d * d / float(k.w) ** 2)
    want = Kr @ np.asarray(v, np.float64) + (0.01 + 1e-4) * np.asarray(
        v, np.float64)[rows]
    scale = np.max(np.abs(want))
    t_strip = wall(strip, x, v)
    emit(section="matvec", impl="strip", block=2048, n=n, r=r,
         seconds=t_strip,
         rel_err_f64=float(np.max(np.abs(np.asarray(ref)[rows] - want)) / scale))
    for block in [(32, 128), (64, 64), (64, 128), (128, 64), (128, 128),
                  (64, 256)]:
        for warps in (4, 8):
            f = jax.jit(lambda x, v, block=block, warps=warps:
                        pairwise.kernel_matvec_fused(
                            k, x, v, 0.1, 1e-4, block=block,
                            num_warps=warps))
            try:
                got = f(x, v)
                t = wall(f, x, v)
                err = float(np.max(np.abs(np.asarray(got)[rows] - want)) / scale)
                emit(section="matvec", impl="fused", block=list(block),
                     num_warps=warps, n=n, r=r, seconds=t, rel_err_f64=err,
                     speedup_vs_strip=t_strip / t)
            except Exception as e:  # noqa: BLE001 - record and go on
                emit(section="matvec", impl="fused", block=list(block),
                     num_warps=warps, error=repr(e)[:400])


def section_jacvec():
    n, r = 65536, 9
    x, _ = sine_problem(n)
    x = jnp.asarray(x)
    u = jnp.asarray(np.random.default_rng(2).standard_normal((n, r)),
                    jnp.float32)
    w = 100.0 * 2 * np.pi / n
    for k in [GaussianKernel(h=jnp.float32(1.0), w=jnp.float32(w)),
              PeriodicKernel(h=jnp.float32(1.0), w=jnp.float32(1.0),
                             p=jnp.float32(200 * w))]:
        P = len(type(k).param_names)
        strip = jax.jit(lambda x, u, k=k: strip_jacvec(k, x, u, 2048))
        ref = strip(x, u)
        t_strip = wall(strip, x, u)
        emit(section="jacvec", impl="strip", P=P, n=n, r=r, seconds=t_strip)
        for block in [(64, 64), (64, 128), (32, 64)]:
            f = jax.jit(lambda x, u, k=k, block=block:
                        pairwise.kernel_jacvec_fused(k, x, u, block=block))
            try:
                got = f(x, u)
                t = wall(f, x, u)
                err = float(jnp.max(jnp.abs(got - ref)) / jnp.max(jnp.abs(ref)))
                emit(section="jacvec", impl="fused", P=P, block=list(block),
                     n=n, r=r, seconds=t, rel_err_vs_strip=err,
                     speedup_vs_strip=t_strip / t)
            except Exception as e:  # noqa: BLE001
                emit(section="jacvec", impl="fused", P=P, block=list(block),
                     error=repr(e)[:400])


def section_iterative():
    from gaussian_processes_tpu import fit_iterative
    from gaussian_processes_tpu.models.iterative_gp import (
        log_marginal_value_and_grad_iterative,
    )

    n = 65536
    x, y = sine_problem(n)
    x, y = jnp.asarray(x), jnp.asarray(y)
    k = iterative_kernel(n)

    def fit(x, y):
        p = fit_iterative(k, x, y, 0.1, jax.random.key(0), num_probes=8,
                          num_iters=150, tol=1e-6, jitter=1e-4,
                          block_size=2048, precond_rank=2048)
        return p.log_marginal, p.solve_residual

    def grad(x, y):
        return log_marginal_value_and_grad_iterative(
            k, x, y, 0.1, jax.random.key(0), num_probes=8, num_iters=150,
            tol=1e-6, jitter=1e-4, block_size=2048, precond_rank=2048)

    keep_mv, keep_jv = pairwise.fused_matvec_default, pairwise.fused_jacvec_default
    try:
        for fused in (False, True, True, False):
            pairwise.fused_matvec_default = lambda *a, f=fused: f
            pairwise.fused_jacvec_default = lambda *a, f=fused: f
            f = jax.jit(lambda x, y: fit(x, y))  # a new trace per rule
            t = wall(f, x, y, reps=3)
            lml, res = f(x, y)
            g = jax.jit(lambda x, y: grad(x, y))
            tg = wall(g, x, y, reps=3)
            val, gr = g(x, y)
            emit(section="iterative", fused=fused, n=n, fit_seconds=t,
                 lml=float(lml), residual=float(res), grad_seconds=tg,
                 grad=np.asarray(gr).tolist())
    finally:
        pairwise.fused_matvec_default = keep_mv
        pairwise.fused_jacvec_default = keep_jv


def section_build():
    from gaussian_processes_tpu import build_kxx

    n = 16384
    x, _ = sine_problem(n)
    x = jnp.asarray(x)
    k = GaussianKernel(h=jnp.float32(1.0), w=jnp.float32(1.0))
    f = jax.jit(lambda x: build_kxx(k, x, 0.1, 1e-4))
    t = wall(f, x, reps=10)
    bound = n * n * 4 / 3.35e12
    emit(section="build", n=n, seconds=t, write_bound_seconds=bound,
         fraction_of_write_bound=bound / t)


def spd(n, seed=0):
    from gaussian_processes_tpu import build_kxx

    x, _ = sine_problem(n, seed)
    k = GaussianKernel(h=jnp.float32(1.0), w=jnp.float32(1.0))
    return jax.jit(lambda x: build_kxx(k, x, 0.1, 1e-4))(jnp.asarray(x))


def recon_err(A, L):
    with jax.enable_x64(True):
        A64 = A.astype(jnp.float64)
        L64 = L.astype(jnp.float64)
        R = jnp.matmul(L64, L64.T, precision=lax.Precision.HIGHEST) - A64
        return float(jnp.linalg.norm(R) / jnp.linalg.norm(A64))


def solve_resid(L, X, B, two_sided):
    """||L L^T X - B|| / ||B|| (or ||L X - B||) in float64."""
    hi = lax.Precision.HIGHEST
    with jax.enable_x64(True):
        L64 = L.astype(jnp.float64)
        Y = X.astype(jnp.float64)
        if two_sided:
            Y = jnp.matmul(L64.T, Y, precision=hi)
        R = jnp.matmul(L64, Y, precision=hi) - B.astype(jnp.float64)
        return float(jnp.linalg.norm(R) / jnp.linalg.norm(B.astype(jnp.float64)))


def section_chol():
    from gaussian_processes_tpu.ops.blocked_cholesky import cholesky_blocked

    for n in (4096, 16384):
        A = spd(n)
        flops = n ** 3 / 3
        cands = {"xla": jax.jit(jnp.linalg.cholesky)}
        for prec in ("high", "highest"):
            cands[f"blocked_{prec}"] = jax.jit(
                lambda A, prec=prec: cholesky_blocked(A, precision=prec))
        for name, f in cands.items():
            t = wall(f, A, reps=5)
            emit(section="chol", impl=name, n=n, seconds=t,
                 tflops=flops / t / 1e12, recon_rel_err_f64=recon_err(A, f(A)))


def section_solve():
    from jax.scipy.linalg import solve_triangular

    from gaussian_processes_tpu.ops.blocked_cholesky import (
        solve_triangular_blocked,
    )

    for n in (4096, 16384):
        A = spd(n)
        L = jax.jit(jnp.linalg.cholesky)(A)
        for nrhs in (1, 2048, n):
            if nrhs == n:
                B = jnp.eye(n, dtype=jnp.float32)
            else:
                B = jnp.asarray(np.random.default_rng(3).standard_normal(
                    (n, nrhs)), jnp.float32)
            impls = {
                "xla": jax.jit(lambda L, B: solve_triangular(
                    L, solve_triangular(L, B, lower=True), lower=True,
                    trans=1)),
                "blocked": jax.jit(lambda L, B: solve_triangular_blocked(
                    L, solve_triangular_blocked(L, B), trans=True)),
            }
            if nrhs == n:  # the L^-1 I solve of loo_predictive: forward only
                impls = {
                    "xla": jax.jit(lambda L, B: solve_triangular(
                        L, B, lower=True)),
                    "blocked": jax.jit(solve_triangular_blocked),
                }
            for name, f in impls.items():
                try:
                    X = f(L, B)
                    t = wall(f, L, B, reps=5)
                    err = solve_resid(L, X, B, nrhs != n)
                    emit(section="solve", impl=name, n=n, nrhs=nrhs,
                         two_sided=nrhs != n, seconds=t, resid_rel_f64=err)
                except Exception as e:  # noqa: BLE001 - e.g. compile failure
                    emit(section="solve", impl=name, n=n, nrhs=nrhs,
                         error=repr(e)[:400])


def section_precision():
    rng = np.random.default_rng(4)
    a = rng.standard_normal((1024, 1024)).astype(np.float32)
    b = rng.standard_normal((1024, 1024)).astype(np.float32)
    want = a.astype(np.float64) @ b.astype(np.float64)
    for prec in ("default", "high", "highest"):
        got = jax.jit(lambda a, b, p=prec: jnp.matmul(a, b, precision=p))(
            jnp.asarray(a), jnp.asarray(b))
        err = float(np.max(np.abs(np.asarray(got, np.float64) - want))
                    / np.max(np.abs(want)))
        emit(section="precision", matmul_precision=prec, rel_err_f64=err)


def section_grad(n=16384):
    """Dense SE gradient at n = 16,384 against float64, per component.

    chip_smoke.py's dense problem (noise 0.1) and two better-conditioned
    noise levels.  Variants: ``highest`` is the package's
    ``log_marginal_value_and_grad``; ``tf32`` the control, the same code
    with ``models/gp.py``'s explicit HIGHEST set back to DEFAULT;
    ``f64_sums`` the package's f32 pieces (alpha, K^-1, dK/dtheta) with
    the quadratic forms and traces summed in float64, which separates
    the pieces' error from the sums'.  The float64 reference runs on the
    card with x64 on.
    """
    from jax.scipy.linalg import cho_solve

    from gaussian_processes_tpu import log_marginal_value_and_grad
    from gaussian_processes_tpu.models import gp as gp_mod

    h, w, jitter = 1.0, 0.5, 1e-4
    x, y = (jnp.asarray(a) for a in sine_problem(n))
    k = GaussianKernel(h=jnp.float32(h), w=jnp.float32(w))

    def reference(s):
        with jax.enable_x64(True):
            @jax.jit
            def ref(x, y):
                d2 = jnp.square(x[:, None] - x[None, :])
                E = jnp.exp(-0.5 * d2 / w ** 2)
                K = h * h * E + (s * s + jitter) * jnp.eye(n)
                L = jnp.linalg.cholesky(K)
                a = cho_solve((L, True), y)
                Ki = cho_solve((L, True), jnp.eye(n))
                return jnp.stack([
                    0.5 * a @ (J @ a) - 0.5 * jnp.sum(Ki * J)
                    for J in (2 * h * E, h * h * E * d2 / w ** 3,
                              2 * s * jnp.eye(n))])

            return np.asarray(ref(x.astype(jnp.float64),
                                  y.astype(jnp.float64)))

    def f64_sums(s):
        _, a, _, iK, J = jax.jit(lambda x, y: gp_mod._grad_pieces(
            k, x, y, jnp.float32(s), jitter))(x, y)
        with jax.enable_x64(True):
            a, iK, J = (t.astype(jnp.float64) for t in (a, iK, J))
            return jax.jit(lambda a, iK, J: 0.5 * (
                jnp.einsum("i,pij,j->p", a, J, a)
                - jnp.sum(iK[None] * jnp.swapaxes(J, 1, 2), axis=(1, 2))))(
                    a, iK, J)

    keep = gp_mod._HI
    try:
        for s in (0.1, 0.3, 0.5):
            ref = reference(s)
            emit(section="grad", variant="f64_reference", noise=s, n=n,
                 grad=ref.tolist())
            for variant, prec in (("highest", keep), ("f64_sums", keep),
                                  ("tf32", lax.Precision.DEFAULT)):
                gp_mod._HI = prec  # read at trace time
                if variant == "f64_sums":
                    g = f64_sums(s)
                else:
                    g = jax.jit(lambda x, y: log_marginal_value_and_grad(
                        k, x, y, jnp.float32(s), jitter=jitter)[1])(x, y)
                g = np.asarray(g, np.float64)
                emit(section="grad", variant=variant, noise=s, n=n,
                     grad=g.tolist(),
                     rel_err=(np.abs(g - ref) / np.abs(ref)).tolist())
    finally:
        gp_mod._HI = keep


def section_step_spread(sz=None):
    """Pooled step size after chip_smoke.py's sharded-sampler warmup
    (1,024 chains, n = 500, 20 steps) on a one-card mesh, over sampler
    keys.  The four-card run folds each device's index into its momentum
    keys, so against one card it is a run with other momenta: the spread
    over keys here is the spread of that comparison."""
    import chip_smoke
    from gaussian_processes_tpu.parallel import (
        make_chain_mesh,
        sample_chees_sharded,
        sample_nuts_sharded,
    )

    sz = sz or chip_smoke.FULL
    log_post, init, key = chip_smoke.sharded_sampler_problem(sz)
    for name, sampler, n_keys in (("chees", sample_chees_sharded, 5),
                                  ("nuts", sample_nuts_sharded, 3)):
        extra = {"max_depth": 6} if name == "nuts" else {}
        for i in range(n_keys):
            k = key if i == 0 else jax.random.fold_in(key, i)
            t0 = time.perf_counter()
            r = sampler(log_post, init, k, mesh=make_chain_mesh(1),
                        num_warmup=sz.warmup, num_samples=1,
                        init_step_size=0.05, **extra)
            emit(section="step_spread", sampler=name, key_index=i,
                 chains=sz.sharded_chains, warmup=sz.warmup,
                 step_size=float(r.step_size),
                 wall_seconds=time.perf_counter() - t0)


SECTIONS = {
    "precision": section_precision,
    "matvec": section_matvec,
    "jacvec": section_jacvec,
    "iterative": section_iterative,
    "build": section_build,
    "chol": section_chol,
    "solve": section_solve,
    "grad": section_grad,
    "step_spread": section_step_spread,
}


def main(argv):
    if jax.devices()[0].platform != "gpu":
        sys.exit("kernel_choices.py measures the GPU; no GPU found")
    enable_compile_cache()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip()
    emit(section="device", card=card, kind=jax.devices()[0].device_kind)
    for name in argv or list(SECTIONS):
        SECTIONS[name]()


if __name__ == "__main__":
    main(sys.argv[1:])
