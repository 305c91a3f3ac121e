"""Blocked Cholesky factorization and triangular solves built from GEMMs.

The arithmetic of a Cholesky is almost all SYRK/GEMM for large N, so
this module expresses *all* O(N^3) work as large dense matmuls and runs
a sequential factorization only on the O(N·base^2) base-case panels:

    chol([[A11,   ·  ],     L11 = chol(A11)
          [A21,  A22 ]]) :  L21 = A21 · L11^-T          (TRSM -> matmul)
                            L22 = chol(A22 - L21·L21^T)  (SYRK -> matmul)

applied recursively or left-looking (trace-time unrolled, all shapes
static — XLA sees a straight-line program of matmuls).  The TRSM is
likewise recursive; its base case inverts the (small, well-conditioned)
diagonal block of L once and turns the solve into a GEMM — the classic
ScaLAPACK `trtri+gemm` panel trick.

The fit path factors with XLA's own ``jnp.linalg.cholesky`` (cuSOLVER
``potrf`` on the GPU), which beat ``cholesky_blocked`` at every measured
size; ``choose_solve`` below picks between XLA's solve and the blocked
TRSM from measurements.

Numerics: the SYRK/TRSM bulk runs at an explicit matmul precision —
never ``DEFAULT``, which on the GPU is TF32 (~1e-3 relative) and whose
errors feed back into later panels.  The base-case diagonal-block
inversion adds a cond(L_kk)-proportional error only *within* each base
panel; the twin tests gate the whole factorization at 1e-8 relative in
f64 (tests/test_blocked_cholesky.py).

Capability parity: the reference factors K with LAPACK dpotrf via
numpy/scipy (SURVEY.md §4.1 hot loop #2 — ``gp/gp.py`` [R] ``Lxx``).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.scipy.linalg import solve_triangular

_HIGHEST = lax.Precision.HIGHEST

# Matmul precision for the SYRK/TRSM bulk.  For f32 on the GPU: DEFAULT
# and HIGH may run in TF32 (~1e-3 relative), HIGHEST is full fp32.
_PRECISIONS = {
    "high": lax.Precision.HIGH,
    "highest": lax.Precision.HIGHEST,
    "default": lax.Precision.DEFAULT,
}


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _split_point(n: int, base: int) -> int:
    """Split n into (n1, n - n1) with n1 a multiple of ``base``, n1 >= n/2.

    Rounding the midpoint *up* to a base multiple keeps every recursive
    sub-problem base-aligned when n itself is (callers pad to ensure it).
    """
    return _round_up(n // 2, base)


def _base_cholesky(A: jax.Array) -> jax.Array:
    """Factor one base panel (XLA's cholesky)."""
    return jnp.linalg.cholesky(A)


def _base_inv_lower(L: jax.Array) -> jax.Array:
    """L^-1 for a small lower-triangular block (trtri)."""
    eye = jnp.eye(L.shape[0], dtype=L.dtype)
    return solve_triangular(L, eye, lower=True)


def _assemble_cols(B, X1, X2, n1, assembly):
    if assembly == "update":
        # preallocate-and-write: XLA can lower .at[].set into in-place
        # dynamic-update-slices, avoiding the concat's extra copies
        return jnp.zeros_like(B).at[:, :n1].set(X1).at[:, n1:].set(X2)
    return jnp.concatenate([X1, X2], axis=1)


def _trsm_right_lt(B: jax.Array, L: jax.Array, base: int, prec=_HIGHEST,
                   assembly: str = "concat") -> jax.Array:
    """X such that X @ L.T = B, with L lower triangular (n, n), B (m, n).

    Recursive: block-forward substitution where every step is a GEMM.
    """
    n = L.shape[0]
    if n <= base:
        inv_L = _base_inv_lower(L)
        return jnp.matmul(B, inv_L.T, precision=prec)
    n1 = _split_point(n, base)
    L11 = L[:n1, :n1]
    L21 = L[n1:, :n1]
    L22 = L[n1:, n1:]
    X1 = _trsm_right_lt(B[:, :n1], L11, base, prec, assembly)
    B2 = B[:, n1:] - jnp.matmul(X1, L21.T, precision=prec)
    X2 = _trsm_right_lt(B2, L22, base, prec, assembly)
    return _assemble_cols(B, X1, X2, n1, assembly)


def _chol_recursive(A: jax.Array, base: int, prec=_HIGHEST,
                    assembly: str = "concat") -> jax.Array:
    n = A.shape[0]
    if n <= base:
        return _base_cholesky(A)
    n1 = _split_point(n, base)
    A11 = A[:n1, :n1]
    A21 = A[n1:, :n1]
    A22 = A[n1:, n1:]
    L11 = _chol_recursive(A11, base, prec, assembly)
    L21 = _trsm_right_lt(A21, L11, base, prec, assembly)
    S = A22 - jnp.matmul(L21, L21.T, precision=prec)
    L22 = _chol_recursive(S, base, prec, assembly)
    if assembly == "update":
        out = jnp.zeros_like(A)
        out = out.at[:n1, :n1].set(L11)
        out = out.at[n1:, :n1].set(L21)
        return out.at[n1:, n1:].set(L22)
    top = jnp.concatenate(
        [L11, jnp.zeros((n1, n - n1), dtype=A.dtype)], axis=1
    )
    bot = jnp.concatenate([L21, L22], axis=1)
    return jnp.concatenate([top, bot], axis=0)


@functools.partial(
    jax.jit,
    static_argnames=("base", "precision", "assembly", "algo", "super_base"),
)
def cholesky_blocked(
    A: jax.Array, *, base: int = 512,
    precision: str = "highest", assembly: str = "concat",
    algo: str = "leftlook", super_base: int = 2048,
) -> jax.Array:
    """Lower Cholesky factor of SPD ``A``, GEMM-structured blocked algorithm.

    Drop-in for ``jnp.linalg.cholesky`` (returns the lower factor; the
    strict upper triangle is exactly zero).  ``base`` is the panel size at
    which recursion stops.  ``precision`` is the SYRK/TRSM matmul
    precision ("highest" = full fp32 on the GPU).

    Inputs of size not a multiple of ``base`` are padded with an identity
    corner — chol(diag(A, I)) = diag(chol(A), I) — and sliced back, so
    shapes stay block-aligned throughout.

    ``algo`` selects the skeleton: ``"recursive"`` (divide-and-conquer,
    per-level re-assembly controlled by ``assembly``) or ``"leftlook"``
    (single-buffer left-looking panels, minimal copy traffic — see
    ``_chol_leftlook``).
    """
    n = A.shape[0]
    pad_unit = super_base if algo == "leftlook2" else base
    n_pad = _round_up(max(n, pad_unit), pad_unit)
    if n_pad != n:
        pad = n_pad - n
        A = jnp.block(
            [
                [A, jnp.zeros((n, pad), A.dtype)],
                [jnp.zeros((pad, n), A.dtype), jnp.eye(pad, dtype=A.dtype)],
            ]
        )
    if algo == "leftlook":
        L = _chol_leftlook(A, base, _PRECISIONS[precision])
    elif algo == "leftlook2":
        L = _chol_leftlook2(A, base, super_base, _PRECISIONS[precision])
    else:
        L = _chol_recursive(A, base, _PRECISIONS[precision], assembly)
    return L[:n, :n]


def solve_triangular_blocked(
    L: jax.Array,
    B: jax.Array,
    *,
    lower: bool = True,
    trans: bool = False,
    base: int = 512,
    precision: str = "highest",
) -> jax.Array:
    """Triangular solve with the same GEMM-heavy structure.

    Solves L X = B (``trans=False``) or L^T X = B (``trans=True``) for a
    lower-triangular L.  For matrix B this is the predict-path companion
    to ``cholesky_blocked``; every base step is a matmul.
    """
    if not lower:
        raise NotImplementedError("upper-triangular solves: pass L lower")
    vec = B.ndim == 1
    if vec:
        B = B[:, None]
    # L X = B  <=>  X^T L^T = B^T ; L^T X = B  <=>  X^T L = B^T
    prec = _PRECISIONS[precision]
    if trans:
        X = _trsm_right_lo(B.T, L, base, prec).T
    else:
        X = _trsm_right_lt(B.T, L, base, prec).T
    return X[:, 0] if vec else X


def _trsm_right_lo(B: jax.Array, L: jax.Array, base: int, prec=_HIGHEST) -> jax.Array:
    """X such that X @ L = B, with L lower triangular (back substitution)."""
    n = L.shape[0]
    if n <= base:
        inv_L = _base_inv_lower(L)
        return jnp.matmul(B, inv_L, precision=prec)
    n1 = _split_point(n, base)
    L11 = L[:n1, :n1]
    L21 = L[n1:, :n1]
    L22 = L[n1:, n1:]
    X2 = _trsm_right_lo(B[:, n1:], L22, base, prec)
    B1 = B[:, :n1] - jnp.matmul(X2, L21, precision=prec)
    X1 = _trsm_right_lo(B1, L11, base, prec)
    return jnp.concatenate([X1, X2], axis=1)


def cholesky_solve_blocked(
    L: jax.Array, B: jax.Array, *, base: int = 512
) -> jax.Array:
    """(L L^T)^-1 B via two blocked triangular solves."""
    Z = solve_triangular_blocked(L, B, trans=False, base=base)
    return solve_triangular_blocked(L, Z, trans=True, base=base)


def _chol_leftlook(A: jax.Array, base: int, prec) -> jax.Array:
    """Left-looking blocked Cholesky with a single preallocated output.

    The recursive skeleton above re-assembles its result at every
    recursion level (concat or whole-matrix ``.at`` writes), costing
    O(N^2 * levels) of copy traffic on top of the matmuls.  This variant eliminates the re-assembly: the factor lives in ONE
    buffer and each (N, base) column strip is written exactly once at its
    final offset (an in-place dynamic-update-slice for XLA), so total
    non-matmul write traffic is ~N^2 elements.

    Per panel k (row offset r = k*base), the left-looking update folds
    every prior panel's contribution into one large GEMM:

        strip = A[r:, r:r+b] - L[r:, :r] @ L[r:r+b, :r]^T   (GEMM)
        L_kk  = chol(strip[:b])                              (base panel)
        L[r+b:, k-strip] = strip[b:] @ L_kk^-T               (trtri+GEMM)

    All shapes are static (the loop unrolls at trace time: N/base
    iterations).  FLOPs are identical to the recursive form (N^3/3, all
    in GEMMs); what changes is the copy traffic and the absence of the
    materialized trailing Schur complements.
    """
    n = A.shape[0]
    nb = n // base
    out = jnp.zeros_like(A)
    for k in range(nb):
        r = k * base
        a_strip = A[r:, r : r + base]
        if k > 0:
            done = out[r:, :r]          # (n-r, r) factor columns so far
            top = out[r : r + base, :r]  # (base, r)
            a_strip = a_strip - jnp.matmul(done, top.T, precision=prec)
        Lkk = _base_cholesky(a_strip[:base])
        if k + 1 < nb:
            inv_Lkk = _base_inv_lower(Lkk)
            rest = jnp.matmul(a_strip[base:], inv_Lkk.T, precision=prec)
            strip = jnp.concatenate([Lkk, rest], axis=0)
        else:
            strip = Lkk
        out = lax.dynamic_update_slice(out, strip, (r, r))
    return out


def _chol_leftlook2(
    A: jax.Array, base: int, super_: int, prec
) -> jax.Array:
    """Two-level left-looking Cholesky: superpanel GEMMs + inner panels.

    ``_chol_leftlook`` launches one left-looking GEMM per ``base``-wide
    panel — at N=16k, base=512 that is 32 sequential (N-r, r)@(r, 512)
    GEMMs, each of which drains before the (serial) base factorization
    can start.  Here the left-looking update is
    hoisted to ``super_``-wide superpanels: ONE (N-R, R)@(R, super_)
    GEMM folds all prior columns into the strip (fewer launches, wider
    stationary operand), and only the intra-strip updates — small
    (N-r, <super_)@(<super_, base) GEMMs — remain at panel granularity.
    FLOPs are unchanged (N^3/3); what changes is launch count and GEMM
    aspect ratio.

    Kept as a tested variant; ``leftlook`` is the default.
    """
    n = A.shape[0]
    assert n % super_ == 0 and super_ % base == 0
    out = jnp.zeros_like(A)
    for K in range(n // super_):
        R = K * super_
        s_here = min(super_, n - R)
        strip = A[R:, R : R + s_here]
        if K > 0:
            strip = strip - jnp.matmul(
                out[R:, :R], out[R : R + s_here, :R].T, precision=prec
            )
        # factor the (n-R, s_here) strip in place, base panels at a time
        for k in range(s_here // base):
            r = k * base
            sub = strip[r:, r : r + base]
            if k > 0:
                sub = sub - jnp.matmul(
                    strip[r:, :r], strip[r : r + base, :r].T, precision=prec
                )
            Lkk = _base_cholesky(sub[:base])
            if r + base < n - R:
                inv_Lkk = _base_inv_lower(Lkk)
                rest = jnp.matmul(sub[base:], inv_Lkk.T, precision=prec)
                col = jnp.concatenate([Lkk, rest], axis=0)
            else:
                col = Lkk
            strip = lax.dynamic_update_slice(strip, col, (r, r))
        # zero the strict upper triangle of the strip's top block
        tri = jnp.tril(jnp.ones((s_here, s_here), A.dtype))
        strip = strip.at[:s_here].multiply(tri)
        out = lax.dynamic_update_slice(out, strip, (R, R))
    return out


# ---------------------------------------------------------------------------
# Selection: which triangular solve do the hot paths use?
# ---------------------------------------------------------------------------

# Measured on an H100 SXM (700 W), f32, median of 5-7 timed calls
# (benchmarks/kernel_choices.py; numbers in PERF.md):
#
# * Cholesky: cuSOLVER 1.94 ms vs blocked-highest 4.27 ms at n = 4,096
#   and 43.0 vs 50.9 ms at 16,384.  Blocked at "high" is TF32 and its
#   factor is NaN at 16,384.  So XLA's factorization everywhere.
# * Triangular solves (forward + back): one RHS, cuBLAS 3.3 ms vs
#   blocked 6.8 ms at n = 16,384; 2,048 RHS, 33.4 vs 30.7 ms; n RHS
#   (forward, the L^-1 I of loo_predictive), 112 vs 100 ms — both
#   compile.  So cuBLAS below _WIDE_RHS right-hand sides, blocked above.
_WIDE_RHS = 2048


def _xla_solve(L, B, *, trans=False):
    return solve_triangular(L, B, lower=True, trans=1 if trans else 0)


def _blocked_solve(L, B, *, trans=False):
    return solve_triangular_blocked(L, B, trans=trans)


def _measured_solve(L, B, *, trans=False):
    """cuBLAS for narrow right-hand sides, the GEMM-blocked TRSM for wide."""
    if B.ndim == 2 and B.shape[1] >= _WIDE_RHS:
        return _blocked_solve(L, B, trans=trans)
    return _xla_solve(L, B, trans=trans)


def choose_solve(n: int):
    """The lower-triangular solve the hot paths use at size ``n``.

    Returns ``solve(L, B, *, trans=False)`` solving L X = B (or
    L^T X = B with ``trans=True``) for lower-triangular L.  The choice
    between XLA's solve and the blocked TRSM is made per call from the
    (static) right-hand-side count, as measured above; below 4,096 rows
    XLA's solve is used throughout.
    """
    return _measured_solve if n >= 4096 else _xla_solve
