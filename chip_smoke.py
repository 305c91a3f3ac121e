"""Drive the GP engine's main path once on the GPU, checked against float64.

    python chip_smoke.py             # one GPU: every one-card phase
    python chip_smoke.py --chips 4   # four GPUs: the sharded paths only
    python chip_smoke.py --phase dense --phase kernels   # a subset

Every phase goes through the entry points a user calls (``gpt.fit``,
``gpt.predict_diag``, ``gpt.log_marginal_value_and_grad``,
``gpt.fit_iterative``, ``cli.run_config``, the sharded samplers and
``fit_blockcyclic``) at the published widths, and compares what comes out
with a plain reference: float64 numpy/scipy on the host, or the strip
matvec for the fused kernels.  Each phase prints one line with its
comparison and wall time; a failed check or an exception fails the run
(exit 1).  The last line of a passing run is one JSON object,
``{"ok": true, "device": {...}}``.

The script refuses to run without a GPU (exit 2): JAX falls back to the
CPU with only a warning when CUDA fails to start.  ``tests/
test_chip_smoke.py`` rehearses every phase on the CPU at toy sizes.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
import traceback

import numpy as np


@dataclasses.dataclass(frozen=True)
class Sizes:
    dense_n: int = 16384       # dense exact GP: K is 1.07 GB in f32
    dense_test: int = 1024
    mle_steps: int = 10        # config #2 L-BFGS steps per restart
    chains: int = 64           # config #3
    sampler_n: int = 500
    warmup: int = 20
    samples: int = 10
    iter_n: int = 65536        # matrix-free fit (bench.py's iterative cell)
    iter_sub: int = 8          # SLQ reference on every 8th point
    precond_rank: int = 2048
    cg_block: int = 2048
    kernel_n: int = 65536      # fused kernels against the strip scan
    twofloat_n: int = 1 << 20
    bc_n: int = 65536          # block-cyclic fit over four cards
    bc_block: int = 256
    sharded_chains: int = 1024  # config #5
    # pooled step size after 20 warmup steps, 4 cards against 1: 3.5
    # standard deviations of the gap between two runs with other momenta
    # (PERF.md: ChEES 7.9%, NUTS 1.4% spread over sampler keys)
    chees_step_rtol: float = 0.40
    nuts_step_rtol: float = 0.10
    interpret: bool = False     # Pallas interpreter (CPU rehearsal only)


FULL = Sizes()

#: dense gradient components (w, s) against their own float64 values, at
#: noise 0.1.  Measured on the card (PERF.md): full fp32 misses them by
#: 1.9e-3 and 2.1e-4, a TF32 product on the gradient path by 0.43 and
#: 1.8e-2.  dlml/dh is not gated: it is a difference of terms ~2e5 times
#: its size, which no f32 factorization resolves here.
GRAD_RTOL = {"w": 2e-2, "s": 2e-3}


def _f32(a):
    import jax.numpy as jnp

    return jnp.asarray(a, jnp.float32)


def _sine(n, seed=0):
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(-np.pi, np.pi, n))
    return x, np.sin(2 * x) + 0.1 * rng.standard_normal(n)


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


class CheckFailed(AssertionError):
    pass


def _check(name, value, limit):
    if not (np.isfinite(value) and value <= limit):
        raise CheckFailed(f"{name} = {value!r} exceeds its limit {limit!r}")


def _limits(out, **limits):
    """Record each quantity's limit; ``run_phases`` checks them after
    printing the phase's line, so a failing run still shows every value."""
    out.setdefault("limits", {}).update(limits)
    return out


def _check_limits(out):
    for name, limit in out.get("limits", {}).items():
        _check(name, out[name], limit)


# ---------------------------------------------------------------------------
# one-card phases
# ---------------------------------------------------------------------------


def phase_dense(sz: Sizes) -> dict:
    """Dense SE fit + predict_diag + analytic gradient vs scipy float64.

    The reference takes the same f32-rounded inputs.  Tolerances: the
    lml (log det and y^T alpha), mean and variance are well conditioned:
    1e-4 relative, 5e-3 of the mean's scale, 1e-4 absolute.  The
    gradient's w and s components are held to ``GRAD_RTOL`` of their own
    float64 values, limits that full fp32 meets with room and a TF32
    product on the gradient path misses (PERF.md); the h component is
    reported only.
    """
    import jax
    import scipy.linalg as sla

    import gaussian_processes_tpu as gpt
    from gaussian_processes_tpu.ops.blocked_cholesky import choose_solve
    from gaussian_processes_tpu.utils.testing import oracle_se_k

    n, m = sz.dense_n, sz.dense_test
    h, w, s, jitter = 1.0, 0.5, 0.1, 1e-4
    x, y = (a.astype(np.float32).astype(np.float64) for a in _sine(n))
    xo = np.linspace(-np.pi, np.pi, m).astype(np.float32).astype(np.float64)
    kern = gpt.GaussianKernel(h=_f32(h), w=_f32(w))

    t0 = time.perf_counter()
    fit = jax.jit(lambda k, x, y: gpt.fit(k, x, y, _f32(s), jitter=jitter))
    compiled = fit.lower(kern, _f32(x), _f32(y)).compile()
    mem = compiled.memory_analysis()
    post = compiled(kern, _f32(x), _f32(y))
    mean, var = jax.jit(gpt.predict_diag)(post, _f32(xo))
    lml_g, grad = jax.jit(
        lambda k, x, y: gpt.log_marginal_value_and_grad(
            k, x, y, _f32(s), jitter=jitter)
    )(kern, _f32(x), _f32(y))
    jax.block_until_ready((post.log_marginal, mean, var, grad))
    t_dev = time.perf_counter()

    # float64 reference on the host
    K = oracle_se_k(x, x, h, w)
    K[np.diag_indices(n)] += s * s + jitter
    L = sla.cholesky(K, lower=True)
    alpha = sla.cho_solve((L, True), y)
    lml = -0.5 * y @ alpha - np.log(np.diag(L)).sum() - 0.5 * n * np.log(2 * np.pi)
    Kxo = oracle_se_k(xo, x, h, w)
    v = sla.solve_triangular(L, Kxo.T, lower=True)
    mean_ref, var_ref = Kxo @ alpha, h * h - np.sum(v * v, axis=0)
    del v
    # d lml/d theta = 1/2 a^T K_p a - 1/2 tr(K^-1 K_p), theta = (h, w, s)
    Kinv, _ = sla.lapack.dpotri(L, lower=1)
    Kinv = np.tril(Kinv) + np.tril(Kinv, -1).T
    E = oracle_se_k(x, x, 1.0, w)
    d2 = np.subtract.outer(x, x) ** 2
    grad_ref = []
    for Kp in (2 * h * E, h * h * E * d2 / w ** 3, 2 * s * np.eye(n)):
        grad_ref.append(0.5 * alpha @ Kp @ alpha - 0.5 * np.sum(Kinv * Kp))
        del Kp
    grad_ref = np.asarray(grad_ref)
    grad_err = np.abs(np.asarray(grad, np.float64) - grad_ref) / np.abs(grad_ref)

    out = {
        "n": n,
        "noise": s,
        "cholesky": "jnp.linalg.cholesky",
        "solve": choose_solve(n).__name__,
        "lml": float(post.log_marginal),
        "lml_ref": float(lml),
        "lml_rel_err": abs(float(post.log_marginal) - lml) / abs(lml),
        "grad_lml_rel_err": abs(float(lml_g) - lml) / abs(lml),
        "mean_err": _rel(mean, mean_ref),
        "var_abs_err": float(np.max(np.abs(np.asarray(var) - var_ref))),
        **{f"grad_{p}_rel_err": float(e) for p, e in zip("hws", grad_err)},
        "grad": np.asarray(grad).tolist(),
        "grad_ref": grad_ref.tolist(),
        "fit_temp_bytes": int(mem.temp_size_in_bytes),
        "fit_argument_bytes": int(mem.argument_size_in_bytes),
        "fit_output_bytes": int(mem.output_size_in_bytes),
        "device_s": t_dev - t0,
        "reference_s": time.perf_counter() - t_dev,
    }
    return _limits(out, lml_rel_err=1e-4, grad_lml_rel_err=1e-4,
                   mean_err=5e-3, var_abs_err=1e-4,
                   **{f"grad_{p}_rel_err": t for p, t in GRAD_RTOL.items()})


def phase_mle(sz: Sizes) -> dict:
    """Config #2 through cli.run_config: a few L-BFGS steps per restart."""
    import gaussian_processes_tpu as gpt
    from gaussian_processes_tpu.cli import run_config
    from gaussian_processes_tpu.utils import CONFIGS, make_data, make_kernel

    cfg = CONFIGS["config2_mle_periodic"]
    cfg = dataclasses.replace(
        cfg, mle=dataclasses.replace(cfg.mle, num_steps=sz.mle_steps))
    x, y, _ = make_data(cfg.data, dtype="float32")
    k0 = make_kernel(cfg.kernel)
    lml0 = float(gpt.log_marginal_likelihood(
        k0.with_params(_f32(k0.params)), _f32(x), _f32(y),
        _f32(cfg.fit.noise), jitter=cfg.fit.jitter))
    summary = run_config(cfg)
    out = {"lml_start": lml0, "lml": summary["log_marginal"],
           "theta": summary["theta"]}
    if not (np.isfinite(out["lml"]) and out["lml"] > lml0):
        raise CheckFailed(f"MLE lml {out['lml']!r} did not rise from {lml0!r}")
    return out


def _sampler_phase(sz: Sizes, name: str) -> dict:
    from gaussian_processes_tpu.cli import run_config
    from gaussian_processes_tpu.utils import CONFIGS

    cfg = CONFIGS[name]
    cfg = dataclasses.replace(
        cfg,
        data=dataclasses.replace(cfg.data, n=sz.sampler_n),
        nuts=dataclasses.replace(cfg.nuts, n_chains=sz.chains,
                                 num_warmup=sz.warmup,
                                 num_samples=sz.samples,
                                 chunk_size=None),
    )
    summary = run_config(cfg)
    out = {k: summary[k] for k in ("n_chains", "n_samples", "accept_rate",
                                   "step_size", "posterior_mean",
                                   "samples_per_s")}
    if not np.all(np.isfinite(summary["posterior_mean"] + summary["posterior_sd"])):
        raise CheckFailed("non-finite draws")
    if not 0.0 < summary["accept_rate"] < 1.0:
        raise CheckFailed(f"acceptance {summary['accept_rate']!r} not in (0, 1)")
    return out


def phase_chees(sz: Sizes) -> dict:
    """Config #3 with ChEES: 64 chains, n = 500, a few steps."""
    return _sampler_phase(sz, "config3_chees_64")


def phase_nuts(sz: Sizes) -> dict:
    """Config #3 with NUTS: 64 chains, n = 500, a few steps."""
    return _sampler_phase(sz, "config3_nuts_64")


def phase_kernels(sz: Sizes) -> dict:
    """Fused Pallas matvec/jacvec as compiled for the card vs the strip scan.

    r = 9 (8 probes + y).  The matvec is also checked against a float64
    host product on 64 rows.  Limit 1e-4 of the output's scale: both
    sides are fp32 sums of n terms in different orders (~sqrt(n) eps =
    1.5e-5 at n = 65,536), with exp/sin from different libraries.
    """
    import jax
    import jax.numpy as jnp
    from jax import lax

    import gaussian_processes_tpu as gpt
    from gaussian_processes_tpu.ops import krylov, pairwise

    n, r = sz.kernel_n, 9
    x, _ = _sine(n)
    rng = np.random.default_rng(1)
    v = rng.standard_normal((n, r))
    w = 100.0 * 2 * np.pi / n
    se = gpt.GaussianKernel(h=_f32(1.0), w=_f32(w))
    per = gpt.PeriodicKernel(h=_f32(1.0), w=_f32(1.0), p=_f32(200 * w))
    out = {"n": n, "r": r}

    fused = jax.jit(lambda x, v: pairwise.kernel_matvec_fused(
        se, x, v, 0.1, 1e-4, interpret=sz.interpret))
    strip = jax.jit(lambda x, v: krylov.kernel_matvec(
        se, x, v, 0.1, 1e-4, block_size=min(2048, n), impl="strip"))
    got, ref = fused(_f32(x), _f32(v)), strip(_f32(x), _f32(v))
    rows = np.arange(0, n, max(1, n // 64))
    d = np.subtract.outer(x[rows], x)
    want = np.exp(-0.5 * d * d / w ** 2) @ v + (0.01 + 1e-4) * v[rows]
    out["matvec_vs_strip"] = _rel(got, ref)
    out["matvec_vs_f64"] = _rel(np.asarray(got)[rows], want)

    # ARD SE over (n, 3) inputs, the (n, D) form of the same kernel
    xd = np.random.default_rng(2).uniform(-np.pi, np.pi, (n, 3))
    ard = gpt.ARDGaussianKernel(h=_f32(1.0), w=_f32([0.05, 0.1, 0.2]))
    got = jax.jit(lambda x, v: pairwise.kernel_matvec_fused(
        ard, x, v, 0.1, 1e-4, interpret=sz.interpret))(_f32(xd), _f32(v))
    ref = jax.jit(lambda x, v: krylov.kernel_matvec(
        ard, x, v, 0.1, 1e-4, block_size=min(2048, n), impl="strip"))(
            _f32(xd), _f32(v))
    out["ard_matvec_vs_strip"] = _rel(got, ref)

    def strip_jacvec(k, x, u, b):
        nb = -(-x.shape[0] // b)
        xp = jnp.pad(x, (0, nb * b - x.shape[0]))
        up = jnp.pad(u, [(0, nb * b - x.shape[0]), (0, 0)])

        def step(acc, xu):
            J = k.jacobian(x, xu[0])
            return acc + jnp.einsum("pnb,br->pnr", J, xu[1],
                                    precision=lax.Precision.HIGHEST), None

        acc0 = jnp.zeros((k.n_params, x.shape[0], u.shape[1]), u.dtype)
        return lax.scan(step, acc0, (xp.reshape(nb, b),
                                     up.reshape(nb, b, -1)))[0]

    for k in (se, per):
        P = k.n_params
        got = jax.jit(lambda x, u, k=k: pairwise.kernel_jacvec_fused(
            k, x, u, interpret=sz.interpret))(_f32(x), _f32(v))
        ref = jax.jit(lambda x, u, k=k: strip_jacvec(
            k, x, u, min(2048, n)))(_f32(x), _f32(v))
        out[f"jacvec_P{P}_vs_strip"] = _rel(got, ref)
    return _limits(out, **{k: 1e-4 for k in (
        "matvec_vs_strip", "matvec_vs_f64", "ard_matvec_vs_strip",
        "jacvec_P2_vs_strip", "jacvec_P3_vs_strip")})


def phase_iterative(sz: Sizes) -> dict:
    """fit_iterative at n = 65,536 with bench.py's iterative settings.

    The CG residual must meet the tolerance the fit asks for (1e-6).
    The SLQ log-determinant is checked on every 8th point (n = 8,192,
    same settings) against scipy's float64 Cholesky: 1e-2 relative, the
    statistical error of 8 Rademacher probes on the preconditioned
    remainder.
    """
    import jax
    import scipy.linalg as sla

    import gaussian_processes_tpu as gpt
    from gaussian_processes_tpu.utils.testing import oracle_se_k

    n = sz.iter_n
    w = 100.0 * 2 * np.pi / n
    s, jitter, tol = 0.1, 1e-4, 1e-6
    kern = gpt.GaussianKernel(h=_f32(1.0), w=_f32(w))

    def fit(x, y):
        m = x.shape[0]
        return gpt.fit_iterative(
            kern, x, y, _f32(s), jax.random.key(0), num_probes=8,
            num_iters=150, tol=tol, jitter=jitter,
            block_size=min(sz.cg_block, m),
            precond_rank=min(sz.precond_rank, m // 2))

    x, y = _sine(n)
    post = jax.jit(fit)(_f32(x), _f32(y))
    xs, ys = x[:: sz.iter_sub], y[:: sz.iter_sub]
    sub = jax.jit(fit)(_f32(xs), _f32(ys))
    m = xs.shape[0]
    logdet_slq = -2.0 * (float(sub.log_marginal)
                         + 0.5 * float(np.asarray(sub.alpha, np.float64) @ ys)
                         + 0.5 * m * np.log(2 * np.pi))
    K = oracle_se_k(xs, xs, 1.0, w)
    K[np.diag_indices(m)] += s * s + jitter
    logdet_ref = 2.0 * np.log(np.diag(sla.cholesky(K, lower=True))).sum()
    out = {
        "n": n,
        "cg_residual": float(post.solve_residual),
        "cg_tol": tol,
        "lml": float(post.log_marginal),
        "sub_n": m,
        "sub_cg_residual": float(sub.solve_residual),
        "logdet_slq": logdet_slq,
        "logdet_f64": float(logdet_ref),
        "logdet_rel_err": abs(logdet_slq - logdet_ref) / abs(logdet_ref),
    }
    return _limits(out, cg_residual=tol, logdet_rel_err=1e-2)


def phase_twofloat(sz: Sizes) -> dict:
    """two_sum/two_prod stay error-free as compiled for the card.

    The SKI-Kron refinement (ops/ski.py) relies on them silently: a
    contracted FMA would make s + e differ from a + b.  Exact check in
    float64 on the host (both sums and products of two f32 are exact
    there at these exponent ranges).
    """
    import jax

    from gaussian_processes_tpu.ops import twofloat as tf

    rng = np.random.default_rng(5)
    n = sz.twofloat_n
    a = (rng.standard_normal(n) * 2.0 ** rng.integers(-10, 10, n)).astype(np.float32)
    b = (rng.standard_normal(n) * 2.0 ** rng.integers(-10, 10, n)).astype(np.float32)
    s, e = jax.jit(tf.two_sum)(a, b)
    p, f = jax.jit(tf.two_prod)(a, b)
    a64, b64 = a.astype(np.float64), b.astype(np.float64)
    sum_bad = int(np.sum(np.asarray(s, np.float64) + np.asarray(e, np.float64)
                         != a64 + b64))
    prod_bad = int(np.sum(np.asarray(p, np.float64) + np.asarray(f, np.float64)
                          != a64 * b64))
    out = {"n": n, "two_sum_inexact": sum_bad, "two_prod_inexact": prod_bad}
    if sum_bad or prod_bad:
        raise CheckFailed(f"two-float transforms inexact: {out}")
    return out


ONE_CARD = {
    "dense": phase_dense,
    "mle": phase_mle,
    "chees": phase_chees,
    "nuts": phase_nuts,
    "kernels": phase_kernels,
    "iterative": phase_iterative,
    "twofloat": phase_twofloat,
}


# ---------------------------------------------------------------------------
# four-card phases
# ---------------------------------------------------------------------------


def phase_blockcyclic(sz: Sizes) -> dict:
    """fit_blockcyclic on a 1-D mesh of 4 against one-card gpt.fit.

    Same n, f32 both.  The one-card fit runs at the largest power-of-two
    n <= bc_n whose compiled fit fits device 0's memory (at 65,536 it
    does: 34.4 GB).  Two f32 factorizations with different blockings
    agree where the problem is well conditioned: lml 1e-4 relative,
    predictive means 5e-3 of their scale.  alpha itself (K^-1 y, cond(K)
    ~ 1.3e6 at n = 65,536) is reported, not gated.
    """
    import jax

    import gaussian_processes_tpu as gpt
    from gaussian_processes_tpu.parallel import fit_blockcyclic, make_chain_mesh

    devs = jax.devices()
    mesh = make_chain_mesh(4, axis="shard")
    h, w, s, jitter = 1.0, 0.5, 0.1, 1e-4
    kern = gpt.GaussianKernel(h=_f32(h), w=_f32(w))
    fit = jax.jit(lambda k, x, y: gpt.fit(k, x, y, _f32(s), jitter=jitter))
    limit = devs[0].memory_stats()["bytes_limit"] if devs[0].platform == "gpu" else None
    n = sz.bc_n
    while True:
        x, y = _sine(n)
        compiled = fit.lower(kern, _f32(x), _f32(y)).compile()
        ma = compiled.memory_analysis()
        need = (ma.temp_size_in_bytes + ma.argument_size_in_bytes
                + ma.output_size_in_bytes)
        if limit is None or need < 0.95 * limit or n <= 4096:
            break
        n //= 2
    bc = fit_blockcyclic(kern, _f32(x), _f32(y), _f32(s), mesh,
                         block_size=sz.bc_block, jitter=jitter)
    lml_bc = float(bc.log_marginal)
    alpha_bc = np.asarray(bc.alpha, np.float64)
    shards = sorted({d.id for d in bc.L_blocks.sharding.device_set})
    del bc
    post = compiled(kern, _f32(x), _f32(y))
    alpha_1 = np.asarray(post.alpha, np.float64)
    # predictive means at 256 test points, in float64 on the host
    from gaussian_processes_tpu.utils.testing import oracle_se_k

    Ks = oracle_se_k(np.linspace(-np.pi, np.pi, 256), x, h, w)
    out = {
        "n": n,
        "mesh_devices": shards,
        "lml_blockcyclic": lml_bc,
        "lml_one_card": float(post.log_marginal),
        "lml_rel_err": abs(lml_bc - float(post.log_marginal))
        / abs(float(post.log_marginal)),
        "alpha_err": _rel(alpha_bc, alpha_1),
        "mean_err": _rel(Ks @ alpha_bc, Ks @ alpha_1),
        "one_card_fit_bytes": int(need),
    }
    if len(shards) != 4:
        raise CheckFailed(f"factor not spread over 4 devices: {shards}")
    return _limits(out, lml_rel_err=1e-4, mean_err=5e-3)


def _mean_z(a, b):
    """Largest |mean_a - mean_b| over coordinates, in standard errors.

    Draws (S, C, D); the standard error of each run's mean comes from
    the spread of its per-chain means (chains are independent).
    """
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    ca, cb = a.mean(0), b.mean(0)  # (C, D)
    se2 = ca.var(0, ddof=1) / ca.shape[0] + cb.var(0, ddof=1) / cb.shape[0]
    return float(np.max(np.abs(ca.mean(0) - cb.mean(0)) / np.sqrt(se2)))


def sharded_sampler_problem(sz: Sizes):
    """Config #5's log posterior at n = ``sampler_n``, its inits for
    ``sharded_chains`` chains, and the sampler key."""
    import jax
    import jax.numpy as jnp

    from gaussian_processes_tpu.inference import init_positions, make_log_posterior
    from gaussian_processes_tpu.utils import CONFIGS, make_data, make_kernel

    cfg = CONFIGS["config5_nuts_sharded"]
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, n=sz.sampler_n))
    x, y, _ = make_data(cfg.data, dtype="float32")
    kern = make_kernel(cfg.kernel)
    kern = kern.with_params(_f32(kern.params))
    log_post = make_log_posterior(kern, x, y, prior_std=cfg.nuts.prior_std,
                                  jitter=cfg.fit.jitter)
    k1, k2 = jax.random.split(jax.random.key(cfg.nuts.seed))
    init = init_positions(kern, cfg.fit.noise, k1, n_chains=sz.sharded_chains,
                          spread=0.2, dtype=jnp.float32)
    return log_post, init, k2


#: pooled copies differ at most by the all-reduce's summation order
REPLICA_RTOL = 1e-4


def replica_spread(arr) -> float:
    """Largest relative difference between the copies of a replicated
    array held by its devices: 0 when every device holds the same value."""
    copies = [np.asarray(s.data, np.float64) for s in arr.addressable_shards]
    ref = copies[0]
    return float(max(np.max(np.abs(c - ref)) for c in copies)
                 / max(np.max(np.abs(ref)), 1e-300))


def phase_sharded_samplers(sz: Sizes) -> dict:
    """1024 chains x n = 500: sharded ChEES and NUTS on 4 cards vs 1.

    Pooling: every adaptation statistic is reduced over all devices, so
    the adapted step size and mass matrix are the same on every card, up
    to the order in which an all-reduce sums (``REPLICA_RTOL``).  Adapting per device instead gives each card its own step
    size, percents apart (PERF.md).

    Against one card: each device folds its index into its chains'
    momentum key, so the two runs draw different momenta and agree in
    distribution, not bit for bit.  After 20 warmup steps the pooled
    step size still moves with the momenta; its limits (``Sizes``) come
    from its spread over sampler keys on one card (PERF.md).  Every
    coordinate's mean must agree within 5 standard errors.
    """
    from gaussian_processes_tpu.parallel import (
        make_chain_mesh,
        sample_chees_sharded,
        sample_nuts_sharded,
    )

    log_post, init, key = sharded_sampler_problem(sz)
    out = {"chains": sz.sharded_chains}
    for name, sampler in (("chees", sample_chees_sharded),
                          ("nuts", sample_nuts_sharded)):
        extra = {"max_depth": 6} if name == "nuts" else {}
        res = {}
        for cards in (4, 1):
            t0 = time.perf_counter()
            r = sampler(log_post, init, key, mesh=make_chain_mesh(cards),
                        num_warmup=sz.warmup, num_samples=sz.samples,
                        init_step_size=0.05, **extra)
            draws = np.asarray(r.positions)
            res[cards] = (float(r.step_size), draws,
                          sorted({d.id for d in r.positions.sharding.device_set}),
                          time.perf_counter() - t0)
            if cards == 4:
                out[f"{name}_replica_spread"] = max(
                    replica_spread(a) for a in (r.step_size, r.inv_mass))
            if not np.all(np.isfinite(draws)):
                raise CheckFailed(f"{name} on {cards} card(s): non-finite draws")
        out[f"{name}_devices"] = res[4][2]
        out[f"{name}_step_size"] = [res[4][0], res[1][0]]
        out[f"{name}_wall_s"] = [res[4][3], res[1][3]]
        out[f"{name}_step_rel_err"] = abs(res[4][0] - res[1][0]) / res[1][0]
        out[f"{name}_mean_z"] = _mean_z(res[4][1], res[1][1])
        if len(res[4][2]) != 4:
            raise CheckFailed(f"{name}: draws not spread over 4 devices")
        _limits(out, **{f"{name}_replica_spread": REPLICA_RTOL,
                        f"{name}_step_rel_err": getattr(sz, f"{name}_step_rtol"),
                        f"{name}_mean_z": 5.0})
    return out


FOUR_CARDS = {
    "blockcyclic": phase_blockcyclic,
    "sharded_samplers": phase_sharded_samplers,
}


# ---------------------------------------------------------------------------


def card_line(cards: int) -> str:
    """``nvidia-smi`` name and power limit, read by a child off JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return "; ".join(out[:cards])


def run_phases(phases: dict, sz: Sizes) -> list:
    """Run every phase, print one line each; return the names that failed."""
    failed = []
    for name, fn in phases.items():
        t0 = time.perf_counter()
        try:
            res = fn(sz)
        except Exception:  # noqa: BLE001 - reported, and the run exits 1
            traceback.print_exc()
            print(f"phase {name}: FAILED after {time.perf_counter() - t0:.1f} s",
                  flush=True)
            failed.append(name)
            continue
        res["wall_s"] = round(time.perf_counter() - t0, 3)
        try:
            _check_limits(res)
        except CheckFailed as e:
            print(f"phase {name}: FAILED {e} {json.dumps(res)}", flush=True)
            failed.append(name)
            continue
        print(f"phase {name}: ok {json.dumps(res)}", flush=True)
    return failed


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chips", type=int, choices=(1, 4), default=1)
    ap.add_argument("--phase", action="append", default=None,
                    help="run only this phase (repeatable)")
    args = ap.parse_args(argv)
    phases = FOUR_CARDS if args.chips == 4 else ONE_CARD
    unknown = sorted(set(args.phase or ()) - set(phases))
    if unknown:
        ap.error(f"unknown phase(s) {unknown} for --chips {args.chips}; "
                 f"choose from {sorted(phases)}")
    if args.phase:
        phases = {k: v for k, v in phases.items() if k in args.phase}

    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX's device 0 is {devs[0].platform!r})",
              file=sys.stderr)
        return 2
    if len(devs) < args.chips:
        print(f"chip_smoke: --chips {args.chips} but JAX sees {len(devs)}",
              file=sys.stderr)
        return 2

    from gaussian_processes_tpu.utils import enable_compile_cache

    print(f"compile cache: {enable_compile_cache()}", flush=True)
    print(f"card: {card_line(args.chips)}", flush=True)
    failed = run_phases(phases, FULL)
    if failed:
        print(f"chip_smoke: failed phases {failed}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform,
        "kind": devs[0].device_kind,
        "count": len(devs),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
