"""Matrix-free Krylov ops: blocked kernel matvec, batched CG, SLQ logdet.

The O(N^2)-storage-free large-N path (pattern source: the public BBMM /
GPyTorch line of work — blackbox matrix-matrix inference — re-designed
here rather than copied):

* ``kernel_matvec``: K v without materializing K — a ``lax.scan`` over
  column blocks builds each (n, b) kernel strip on the fly from x (pure
  elementwise work) and contracts it with a matmul — or, on the GPU,
  the fused Pallas kernel never writes the strip at all.  Peak memory
  is O(n b), so N goes far beyond the dense wall (K is 17 GB in f32 at
  65k; SURVEY.md §6.7, config #4).
* ``mbcg``: batched conjugate gradients over multiple right-hand sides,
  run a FIXED number of iterations (static shapes; converged systems are
  masked, not exited) — every iteration is one fused matvec over all
  RHS.  The CG recurrence coefficients double as the Lanczos tridiagonal
  of each probe vector (the BBMM identity), so solves and logdet probes
  come out of a single sweep.
* ``slq_logdet``: stochastic Lanczos quadrature — for Rademacher probes
  z, E[z^T log(K) z] = logdet(K); each probe's quadrature is
  ||z||^2 e_1^T log(T_m) e_1 with T_m assembled from its CG
  coefficients and eigendecomposed as a tiny (m, m) batch.

Accuracy is statistical (probes) + Krylov (iterations); the exact-parity
tests gate the estimates against the dense Cholesky at moderate N, and
``models/iterative_gp.py`` documents the tolerance model.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from gaussian_processes_tpu.models.base import Kernel


def _pad_to(x, size, axis=0):
    pad = size - x.shape[axis]
    if pad <= 0:
        return x
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, pad)
    return jnp.pad(x, widths)


def kernel_matvec(
    kernel: Kernel,
    x: jax.Array,
    v: jax.Array,
    noise,
    jitter: float = 0.0,
    block_size: int = 1024,
    impl: str = "auto",
    x_rows: jax.Array | None = None,
) -> jax.Array:
    """(K_f(x, x) + (noise^2 + jitter) I) @ v without materializing K.

    ``v`` may be (n,) or (n, r).  Two implementations:

    * ``"strip"`` — ``lax.scan`` over column blocks: each step builds an
      (n, b) strip of K and contracts it (portable, differentiable).
    * ``"fused"`` — the Pallas kernel (ops/pairwise.py::
      kernel_matvec_fused) builds each K tile and contracts it on the
      spot, which removes the ~8 n^2 bytes of strip traffic per matvec.
      GPU only, not differentiable.

    ``"auto"`` follows ``pairwise.fused_matvec_default`` for the square
    product and takes the strip for ``x_rows``, where the fused kernel
    was not timed.

    ``x_rows`` selects a *rectangular* strip product K_f(x_rows, x) @ v —
    the row-sharded building block of the distributed matvec
    (parallel/iterative_sharded.py), where each device owns a row block
    and ``v`` is the all-gathered global vector.  In that mode the
    noise/jitter diagonal is NOT added (rows and columns are misaligned
    on a shard); the caller adds ``(noise^2 + jitter) * v_local`` itself.
    """
    from gaussian_processes_tpu.ops import pairwise

    x = jnp.asarray(x)
    rect = x_rows is not None
    if impl == "auto":
        width = 1 if v.ndim == 1 else v.shape[1]
        fused = not rect and pairwise.fused_matvec_default(kernel, x, width)
        impl = "fused" if fused else "strip"
    if impl == "fused":
        return pairwise.kernel_matvec_fused(
            kernel, x, v, noise, jitter, x_rows=x_rows
        )
    rows = x if not rect else jnp.asarray(x_rows)
    squeeze = v.ndim == 1
    v2 = v[:, None] if squeeze else v
    n = x.shape[0]
    b = min(block_size, n)
    nb = -(-n // b)
    n_pad = nb * b
    x_pad = _pad_to(x, n_pad)
    # padded x entries produce kernel values against real rows, but the
    # corresponding v rows are zero-padded so they contribute nothing
    v_pad = _pad_to(v2, n_pad)
    xb = x_pad.reshape(nb, b, *x.shape[1:])  # (n,) or (n, D) inputs
    vb = v_pad.reshape(nb, b, v2.shape[1])

    def step(acc, xv):
        xj, vj = xv
        Kj = kernel(rows, xj)  # (n_rows, b) strip
        # HIGHEST: a TF32 (or bf16) contraction has a ~1e-3 noise floor
        # that caps CG convergence regardless of iterations
        return acc + jnp.dot(Kj, vj, precision=lax.Precision.HIGHEST), None

    acc0 = jnp.zeros((rows.shape[0], v2.shape[1]), v2.dtype)
    out, _ = lax.scan(step, acc0, (xb, vb))
    if not rect:
        diag = (jnp.square(jnp.asarray(noise, out.dtype)) + jitter)
        out = out + diag * v2
    return out[:, 0] if squeeze else out


class MBCGResult(NamedTuple):
    solution: jax.Array  # (n, r)
    alphas: jax.Array  # (m, r) CG step sizes
    betas: jax.Array  # (m, r) CG direction updates
    residual_norm: jax.Array  # (r,) final relative residuals


def mbcg(
    matvec,
    rhs: jax.Array,
    num_iters: int,
    tol: float = 1e-10,
    allreduce=None,
) -> MBCGResult:
    """Batched CG on (n, r) right-hand sides, fixed ``num_iters``.

    Converged columns freeze (masked updates) so their Lanczos
    coefficients stop changing; alphas/betas feed ``slq_logdet``.

    ``allreduce`` (default identity) wraps every column-sum over the n
    axis — pass ``lambda a: lax.psum(a, axis)`` to run the identical
    recurrence on row-sharded operands inside ``shard_map``
    (parallel/iterative_sharded.py); every scalar the iteration branches
    on is then replicated across devices by construction.
    """
    red = allreduce if allreduce is not None else (lambda a: a)

    def colsum(a):
        return red(jnp.sum(a, axis=0))

    n, r = rhs.shape
    dtype = rhs.dtype
    x0 = jnp.zeros_like(rhs)
    r0 = rhs
    p0 = rhs
    rs0 = colsum(r0 * r0)  # (r,)
    b_norm = jnp.sqrt(jnp.maximum(colsum(rhs * rhs), 1e-30))

    def body(carry, _):
        x, res, p, rs, x_best, rs_best = carry
        Ap = matvec(p)
        pAp = colsum(p * Ap)
        # freeze converged columns AND numerical breakdowns: pAp <= 0 from
        # f32 rounding near the conditioning limit, or a residual that has
        # blown far past its best (low-precision CG can diverge after
        # stalling; stepping on would poison everything downstream)
        active = (
            (jnp.sqrt(rs) / b_norm > tol)
            & (pAp > 0)
            & jnp.isfinite(pAp)
            & jnp.isfinite(rs)
            & (rs < 1e4 * rs_best)
        )  # (r,)
        alpha = jnp.where(active, rs / jnp.where(active, pAp, 1.0), 0.0)
        x = x + alpha[None, :] * p
        res = res - alpha[None, :] * Ap
        rs_new = colsum(res * res)
        rs_new = jnp.where(active, rs_new, rs)
        beta = jnp.where(active, rs_new / jnp.maximum(rs, 1e-30), 0.0)
        p = jnp.where(active[None, :], res + beta[None, :] * p, p)
        better = rs_new < rs_best
        x_best = jnp.where(better[None, :], x, x_best)
        rs_best = jnp.where(better, rs_new, rs_best)
        return (x, res, p, rs_new, x_best, rs_best), (alpha, beta)

    (x, res, _, rs, x_best, rs_best), (alphas, betas) = lax.scan(
        body, (x0, r0, p0, rs0, x0, rs0), None, length=num_iters
    )
    # return the best iterate seen, not the last (identical when CG is
    # healthy; strictly better when low precision stalls then drifts)
    return MBCGResult(
        solution=x_best,
        alphas=alphas,
        betas=betas,
        residual_norm=jnp.sqrt(rs_best) / b_norm,
    )


def pivoted_cholesky(
    kernel: Kernel, x: jax.Array, rank: int, jitter: float = 1e-6
) -> jax.Array:
    """Rank-k pivoted Cholesky of K_f(x, x), built matrix-free.

    Greedy diagonal pivoting; each step touches one on-the-fly kernel
    column (O(n) work), total O(n k^2).  Returns L with K ~ L L^T
    capturing the top of the spectrum — the standard CG preconditioner
    for kernel systems (pattern from the public pivoted-Cholesky /
    preconditioned-BBMM literature; implementation is this module's).
    """
    x = jnp.asarray(x)
    n = x.shape[0]
    dtype = x.dtype if jnp.issubdtype(x.dtype, jnp.floating) else jnp.float32

    d0 = kernel.kdiag(x).astype(dtype)  # (n,)
    L0 = jnp.zeros((n, rank), dtype)
    # over-rank guard: once the residual diagonal falls below the
    # accumulated round-off of the updates (~rank * eps * max diag),
    # further "columns" are noise divided by a clamped pivot — they
    # pollute the Woodbury apply instead of helping.  Freeze to zero
    # columns past that point (the shape stays static; the factor just
    # stops growing).  The 1e3 factor is calibrated to f32 at n ~ 1e5:
    # a 10*eps floor let f32 runs on an accelerator admit ~100 junk
    # columns that CPU
    # f32 froze (measured: identical 65k ND-SKI solve, 300 vs 202
    # columns, preconditioned CG 0.65 vs 6e-4), because the guard sat
    # inside cross-backend round-off scatter.  Directions with residual
    # eigenvalue below ~1e-4 * max(d0) belong to the sigma^2 term of
    # the Woodbury preconditioner anyway.
    floor = jnp.max(d0) * jnp.asarray(1e3 * jnp.finfo(dtype).eps, dtype)

    def body(j, carry):
        L, d = carry
        piv = jnp.argmax(d)
        xp = jax.lax.dynamic_index_in_dim(x, piv, 0, keepdims=True)
        c = kernel(x, xp)[:, 0].astype(dtype)  # K[:, piv]
        lp = L[piv]  # (rank,) — columns >= j are still zero
        l = (c - jnp.dot(L, lp, precision=lax.Precision.HIGHEST)) / jnp.sqrt(
            jnp.maximum(d[piv], jitter)
        )
        l = jnp.where(d[piv] > floor, l, jnp.zeros_like(l))
        L = L.at[:, j].set(l)
        d = jnp.maximum(d - l * l, 0.0)
        return (L, d)

    L, _ = lax.fori_loop(0, rank, body, (L0, d0))
    return L


def effective_precond_shift(L: jax.Array, sigma2, allreduce=None,
                            floor_factor: float = 1.5e3):
    """Damped Woodbury shift: max(sigma2, floor_factor * eps * lam_max).

    Why (round-3 finding): the Woodbury apply's final
    ``(v - L M^-1 L^T v) / sigma2`` amplifies its own f32 rounding by
    ~||K||/sigma2 in the directions the system operator then re-amplifies.
    At n=65536 (lam_max ~ 1.5e3, sigma2 ~ 1e-2) that noise is O(1) in the
    A-norm and CG stalls outright at ~1e-1 (a 0.28% difference in
    the preconditioned vector moved the one-step residual 7x).  Flooring
    the shift at ~1e3 * eps * lam_max caps the amplification at ~1e-3:
    measured, the same solve went from flat 1.3e-1 to 5e-14 in 50
    iterations.  The floor only weakens the preconditioner when
    sigma2 < eps * cond-scale — exactly where the undamped version is
    numerically fictional anyway.  lam_max is estimated by the first
    pivot column's squared norm (the pivoted factor's largest column).
    """
    lam = jnp.sum(jnp.square(L[:, 0]))
    if allreduce is not None:
        lam = allreduce(lam)
    eps = jnp.finfo(L.dtype).eps
    return jnp.maximum(
        jnp.asarray(sigma2, L.dtype),
        jnp.asarray(floor_factor, L.dtype) * eps * lam,
    )


def woodbury_inverse_apply(L: jax.Array, sigma2, allreduce=None) -> "callable":
    """Return v -> (L L^T + shift I)^-1 v via the Woodbury identity,
    with shift = effective_precond_shift(L, sigma2) (damped — see there).

    Precomputes the (k, k) capacitance Cholesky once; each apply is
    2 n k flops — cheap relative to a kernel matvec.

    With ``allreduce`` (psum over the shard axis), ``L`` and ``v`` may be
    row shards of the global operands: the two L^T-contractions are the
    only cross-row reductions, so the sharded apply is exact.

    The SLQ companion functions (``precond_logdet``,
    ``sample_precond_probes``) apply the SAME shift, so the
    preconditioned-SLQ identity stays exact under damping.
    """
    red = allreduce if allreduce is not None else (lambda a: a)
    k = L.shape[1]
    sigma2 = effective_precond_shift(L, sigma2, allreduce=allreduce)
    hi = lax.Precision.HIGHEST
    M = sigma2 * jnp.eye(k, dtype=L.dtype) + red(
        jnp.dot(L.T, L, precision=hi)
    )
    # Capacitance inverse via a ONE-TIME triangular inverse, applied as
    # controlled-precision matmuls.  Why not cho_solve per apply
    # (round-3 finding): a TriangularSolve expansion can run its
    # internal matmuls at DEFAULT precision (bf16 or TF32) with no
    # JAX-level override, so each preconditioner apply carried
    # noise that VARIED with the right-hand side — an INCONSISTENT
    # preconditioner, which breaks CG outright (the 65k ND-SKI solve
    # sat at 1e-1 while the same program on CPU reached 4e-6).
    # M^-1 = (Lm^-1)^T (Lm^-1) built from a fixed triangular inverse is
    # the same SPD matrix every iteration — whatever the one-time
    # inversion error, that is all CG requires of a preconditioner.
    Lm = jnp.linalg.cholesky(M)
    Lm_inv = jax.scipy.linalg.solve_triangular(
        Lm, jnp.eye(k, dtype=L.dtype), lower=True
    )

    def apply(v):
        Ltv = red(jnp.dot(L.T, v, precision=hi))
        t = jnp.dot(Lm_inv, Ltv, precision=hi)
        MLtv = jnp.dot(Lm_inv.T, t, precision=hi)
        return (v - jnp.dot(L, MLtv, precision=hi)) / sigma2

    return apply


def pcg(
    matvec,
    precond,
    rhs: jax.Array,
    num_iters: int,
    tol: float = 1e-10,
    return_tridiag: bool = False,
    early_exit: bool = False,
    allreduce=None,
    replace_every: int = 0,
):
    """Preconditioned CG on (n, r) right-hand sides, fixed iterations.

    Same robustness policy as ``mbcg`` (breakdown freeze, best-iterate
    return).  With ``return_tridiag`` the PCG recurrence coefficients are
    also returned: they form the Lanczos tridiagonal of the
    preconditioned operator P^-1 A in the P inner product, which is what
    preconditioned SLQ quadrature needs.

    ``early_exit=True`` runs the same masked body under a while_loop that
    stops once every column has converged (or broken down).  The result
    is bit-identical to the fixed-length scan — converged columns are
    frozen either way — but a sampler paying a CG solve per leapfrog
    step stops at convergence instead of burning the full budget.  Not
    differentiable (use the fixed scan or a custom_vjp around it) and
    incompatible with ``return_tridiag``.

    ``replace_every=k`` (k > 0) enables **residual replacement**: every k
    iterations the recurrence residual is recomputed as the TRUE residual
    ``rhs - matvec(x)`` and the search direction restarts from the
    preconditioned residual.  Rationale (VERDICT r2 item 5): in f32 the
    recurrence residual drifts from the true one over hundreds of
    iterations — the round-2 "f32 CG stall at ~1e-2" on the n>=65536 SKI
    operator is exactly this drift, not an operator noise floor (the f32
    FFT matvec error is ~4e-7).  Costs
    one extra matvec per k iterations; van der Vorst/Sleijpen-style
    infrequent replacement (k ~ 25-50) preserves CG convergence.
    Replacement is masked to still-active columns, so frozen columns
    (converged or broken down) are never revived and the early_exit
    bit-identity guarantee above is preserved.  Incompatible with
    ``return_tridiag`` (replacement invalidates the Lanczos
    coefficients).
    """
    if early_exit and return_tridiag:
        raise ValueError("early_exit does not collect tridiagonals")
    if replace_every and return_tridiag:
        raise ValueError(
            "residual replacement invalidates the Lanczos tridiagonal"
        )
    red = allreduce if allreduce is not None else (lambda a: a)

    def colsum(a):
        return red(jnp.sum(a, axis=0))

    x0 = jnp.zeros_like(rhs)
    r0 = rhs
    z0 = precond(r0)
    p0 = z0
    rz0 = colsum(r0 * z0)
    b_norm = jnp.sqrt(jnp.maximum(colsum(rhs * rhs), 1e-30))

    def body(carry, i):
        x, res, p, rz, x_best, rn_best, act_prev = carry
        if replace_every:
            def _replace(args):
                x, res, p, rz = args
                res_t = rhs - matvec(x)
                z_t = precond(res_t)
                # replacement only where the column is still active: a
                # column frozen by convergence or breakdown keeps its
                # state, preserving the monotone-freeze invariant that
                # early_exit's loop condition relies on (ADVICE r3)
                res_n = jnp.where(act_prev[None, :], res_t, res)
                p_n = jnp.where(act_prev[None, :], z_t, p)
                rz_n = jnp.where(act_prev, colsum(res_t * z_t), rz)
                return res_n, p_n, rz_n

            def _keep(args):
                x, res, p, rz = args
                return res, p, rz

            res, p, rz = lax.cond(
                (i > 0) & (i % replace_every == 0),
                _replace, _keep, (x, res, p, rz),
            )
        Ap = matvec(p)
        pAp = colsum(p * Ap)
        rn = jnp.sqrt(colsum(res * res))
        # & act_prev makes freezing explicitly monotone (a no-op without
        # replacement: a frozen column's state is unchanged, so the
        # recomputed conditions reproduce the frozen verdict)
        active = (
            (rn / b_norm > tol)
            & (pAp > 0)
            & jnp.isfinite(pAp)
            & jnp.isfinite(rz)
            & (rn < 1e2 * rn_best + 1e-30)
            & act_prev
        )
        alpha = jnp.where(active, rz / jnp.where(active, pAp, 1.0), 0.0)
        x = x + alpha[None, :] * p
        res = res - alpha[None, :] * Ap
        z = precond(res)
        rz_new = colsum(res * z)
        rz_new = jnp.where(active, rz_new, rz)
        beta = jnp.where(active, rz_new / jnp.where(rz == 0, 1.0, rz), 0.0)
        p = jnp.where(active[None, :], z + beta[None, :] * p, p)
        rn_new = jnp.sqrt(colsum(res * res))
        better = rn_new < rn_best
        x_best = jnp.where(better[None, :], x, x_best)
        rn_best = jnp.where(better, rn_new, rn_best)
        return ((x, res, p, rz_new, x_best, rn_best, active),
                (alpha, beta, active))

    r = rhs.shape[1]
    init = (x0, r0, p0, rz0, x0, jnp.sqrt(colsum(r0 * r0)),
            jnp.ones((r,), bool))
    if early_exit:
        # the loop condition consumes the PREVIOUS iteration's active
        # mask (freezing is monotone — a frozen column's state stops
        # changing — so last-iteration active is exact).  Recomputing
        # activity from rn alone here used to miss the pAp<=0 /
        # non-finite BREAKDOWN freezes: broken-down columns kept
        # rn > tol forever and the "early exit" burned the full
        # num_iters budget of frozen no-op matvecs (round-2 review).
        def cond(state):
            i, carry = state
            return (i < num_iters) & jnp.any(carry[-1])

        def wbody(state):
            i, carry = state
            carry, _ = body(carry, i)
            return i + 1, carry

        _, (x, res, _, _, x_best, rn_best, _) = lax.while_loop(
            cond, wbody, (jnp.zeros((), jnp.int32), init),
        )
        return x_best, rn_best / b_norm
    (x, res, _, _, x_best, rn_best, _), (alphas, betas, _) = lax.scan(
        body, init, jnp.arange(num_iters)
    )
    if return_tridiag:
        return x_best, rn_best / b_norm, alphas, betas
    return x_best, rn_best / b_norm


def precond_logdet(L: jax.Array, sigma2, n: int, allreduce=None) -> jax.Array:
    """Exact logdet(L L^T + shift I) via the matrix determinant lemma:
    logdet = logdet(shift I_k + L^T L) + (n - k) log(shift), with the
    same damped shift as ``woodbury_inverse_apply``.

    ``n`` is always the GLOBAL row count; with ``allreduce``, ``L`` may be
    a row shard (L^T L is psum-reduced)."""
    red = allreduce if allreduce is not None else (lambda a: a)
    k = L.shape[1]
    sigma2 = effective_precond_shift(L, sigma2, allreduce=allreduce)
    hi = lax.Precision.HIGHEST
    M = sigma2 * jnp.eye(k, dtype=L.dtype) + red(
        jnp.dot(L.T, L, precision=hi)
    )
    Lm = jnp.linalg.cholesky(M)
    return 2.0 * jnp.sum(jnp.log(jnp.diagonal(Lm))) + (n - k) * jnp.log(sigma2)


def sample_precond_probes(key, L: jax.Array, sigma2, num_probes: int,
                          allreduce=None):
    """Draw z ~ N(0, P), P = L L^T + shift I (same damped shift as the
    apply):  z = L xi1 + sqrt(shift) xi2.

    In sharded contexts pass ``allreduce`` so the damped shift is
    computed from the GLOBAL ||L[:, 0]||^2 — otherwise each shard would
    draw probes from a different P than the apply/logdet use (ADVICE
    r3).  ``key`` must then be identical across shards and ``L`` the
    local row shard; xi2 is drawn per-shard from the shared key, so
    callers that need independent per-row noise across shards should
    fold the shard index into ``key`` for xi2 themselves (the in-repo
    sharded path builds probes manually — iterative_sharded.py:300)."""
    n, k = L.shape
    k1, k2 = jax.random.split(key)
    xi1 = jax.random.normal(k1, (k, num_probes), L.dtype)
    xi2 = jax.random.normal(k2, (n, num_probes), L.dtype)
    sigma = jnp.sqrt(effective_precond_shift(L, sigma2, allreduce=allreduce))
    return jnp.dot(L, xi1, precision=lax.Precision.HIGHEST) + sigma * xi2


def slq_logdet_preconditioned(
    matvec, L: jax.Array, sigma2, key, num_probes: int, num_iters: int, n: int,
    probes: jax.Array | None = None, allreduce=None,
):
    """SLQ estimate of logdet(A) with pivoted-Cholesky preconditioning.

    logdet(A) = logdet(P) + E_{z ~ N(0, P)}[ (z^T P^-1 z) e1^T log(T) e1 ]
    with T the PCG Lanczos tridiagonal of P^-1 A for start vector z
    (the GPyTorch preconditioned-SLQ identity).  logdet(P) is exact.

    Pass ``probes`` (n_local, r) explicitly in sharded contexts (``key``
    is then unused); ``n`` is always global.
    """
    red = allreduce if allreduce is not None else (lambda a: a)
    pre = woodbury_inverse_apply(L, sigma2, allreduce=allreduce)
    if probes is None:
        probes = sample_precond_probes(key, L, sigma2, num_probes)
    _, _, alphas, betas = pcg(
        matvec, pre, probes, num_iters=num_iters, tol=1e-12,
        return_tridiag=True, allreduce=allreduce,
    )
    pz = pre(probes)
    probe_norms = red(jnp.sum(probes * pz, axis=0))  # z^T P^-1 z, (r,)
    T = lanczos_tridiag_from_cg(alphas, betas)
    evals, evecs = jnp.linalg.eigh(T)
    w = jnp.square(evecs[:, 0, :])
    quad = jnp.sum(w * jnp.log(jnp.maximum(evals, 1e-30)), axis=-1)
    est = jnp.mean(probe_norms * quad)
    return precond_logdet(L, sigma2, n, allreduce=allreduce) + est


def lanczos_tridiag_from_cg(alphas: jax.Array, betas: jax.Array):
    """Lanczos T (m, m) per RHS from CG coefficients; batched over r.

    diag_k   = 1/alpha_k + beta_{k-1}/alpha_{k-1}   (beta_{-1} = 0)
    offdiag_k = sqrt(beta_k) / alpha_k
    Frozen (alpha = 0) iterations yield zero rows/cols that are inert in
    the quadrature (they contribute log-eigenvalues weighted ~0).
    """
    m, r = alphas.shape
    safe_a = jnp.where(alphas > 0, alphas, 1.0)
    inv_a = jnp.where(alphas > 0, 1.0 / safe_a, 0.0)  # (m, r)
    prev_beta_over_a = jnp.concatenate(
        [jnp.zeros((1, r), alphas.dtype), (betas * inv_a)[:-1]], axis=0
    )
    diag = inv_a + prev_beta_over_a  # (m, r)
    off = jnp.sqrt(jnp.maximum(betas, 0.0)) * inv_a  # (m, r); last unused
    T = (
        jnp.zeros((r, m, m), alphas.dtype)
        + jnp.moveaxis(diag, 0, 1)[:, :, None] * jnp.eye(m)[None]
    )
    offd = jnp.moveaxis(off[:-1], 0, 1)  # (r, m-1)
    idx = jnp.arange(m - 1)
    T = T.at[:, idx, idx + 1].set(offd)
    T = T.at[:, idx + 1, idx].set(offd)
    return T


def slq_logdet_from_cg(alphas, betas, probe_sq_norms, n):
    """SLQ logdet estimate from the CG coefficients of Rademacher probes.

    logdet(K) ~ mean_probes[ ||z||^2 * e1^T log(T) e1 ]  (||z||^2 = n for
    Rademacher probes, passed explicitly to support normalized probes).
    """
    T = lanczos_tridiag_from_cg(alphas, betas)  # (r, m, m)
    evals, evecs = jnp.linalg.eigh(T)
    w = jnp.square(evecs[:, 0, :])  # (r, m) first-component weights
    safe = jnp.maximum(evals, 1e-30)
    quad = jnp.sum(w * jnp.log(safe), axis=-1)  # (r,)
    return jnp.mean(probe_sq_norms * quad)
