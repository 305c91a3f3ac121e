"""Double-f32 ("two-float") compensated arithmetic.

Some numerics in the f32 paths need more than f32's 24-bit mantissa.  A *two-float*
represents a value as an unevaluated pair ``hi + lo`` with
``|lo| <= ulp(hi)/2``, giving ~48 effective mantissa bits (~1e-14
relative) out of pure f32 elementwise ops — the classic Dekker (1971) / Knuth
error-free transformations.  Everything here is elementwise jnp, so it
jits, vmaps, and runs at f32 speed.  (On the GPU, f64 residuals are the
alternative; ROADMAP D4.)

Why it exists (VERDICT r2 item 5): the ND-SKI conjugate-gradient solve
at n >= 65536 is bounded by f32 operator-application error — a single
``W K_g W^T x`` evaluation at the solution carries ~1.1e-4 relative
error (measured stage-by-stage in round 3: the f32 FFT product
contributes ~4e-5, f32 rounding of the grid vector ~1e-5, and a plain
f32 HIGHEST dense matmul is no better at ~1.1e-4, because all of them
round intermediates of magnitude ||T||*||u|| >> ||T u||).  Iterative
refinement can only reach the fidelity of its residual evaluation, so
the residual is computed here in two-float end to end (ops/ski.py
``ski_kron_refine``), pushing the reachable true residual to the f32
*representation* floor of the solution itself (~1e-5 at that scale).

The algorithms assume IEEE round-to-nearest and NO reassociation; XLA
preserves FP semantics for elementwise ops, and the twin tests
(tests/test_twofloat.py) gate that the compensation terms survive
compilation on every backend.
"""

from __future__ import annotations

from jax import lax
import jax.numpy as jnp

# Dekker splitting constant for f32: 2^ceil(24/2) + 1
_SPLIT = jnp.float32(4097.0)

# Compiler-hardening, measured in round 3 (the identical algorithm gave
# 8e-15 relative in numpy but 1e-8 through jit before hardening):
#
# * XLA CPU CONTRACTS mul+add across optimization_barrier: a two_sum
#   whose operand is a product result gets compiled as fma(a, b, h),
#   which rounds differently from fl(h + fl(a*b)) and silently breaks
#   the error-free-transform invariant (verified bit-for-bit against
#   the fma value).  ``_defuse`` routes a value through an integer
#   bitcast + barrier — contraction cannot cross a type bitcast — and
#   is applied to every two_sum/fast_two_sum operand.
# * The simplifier can also rewrite exact-in-reals patterns like
#   (s - (s - a)) -> a; every pivot subtraction sits behind a barrier.
#
# tests/test_twofloat.py pins primitive exactness AND composed-in-jit
# accuracy, so a backend change that re-breaks either shows up red.


def _defuse(x):
    """Block FP contraction into ``x``'s consumers (bitcast + barrier)."""
    i = lax.optimization_barrier(lax.bitcast_convert_type(x, jnp.int32))
    return lax.bitcast_convert_type(i, jnp.float32)


def two_sum(a, b):
    """Error-free sum: returns (s, e) with s = fl(a+b), s + e = a + b."""
    a = _defuse(a)
    b = _defuse(b)
    s = lax.optimization_barrier(a + b)
    bb = lax.optimization_barrier(s - a)
    sb = lax.optimization_barrier(s - bb)
    e = (a - sb) + (b - bb)
    return s, e


def fast_two_sum(a, b):
    """Error-free sum assuming |a| >= |b| (3 flops; Dekker)."""
    a = _defuse(a)
    b = _defuse(b)
    s = lax.optimization_barrier(a + b)
    d = lax.optimization_barrier(s - a)
    e = b - d
    return s, e


def split(a):
    """Dekker split of f32 ``a`` into hi (12 mantissa bits) + lo."""
    a = _defuse(a)
    c = lax.optimization_barrier(_SPLIT * a)
    d = lax.optimization_barrier(c - a)
    hi = lax.optimization_barrier(c - d)
    return hi, a - hi


def two_prod(a, b):
    """Error-free product: (p, e) with p = fl(a*b), p + e = a*b exactly
    (barring over/underflow)."""
    p = lax.optimization_barrier(a * b)
    ah, al = split(a)
    bh, bl = split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


def tf_add(xh, xl, yh, yl):
    """Two-float + two-float -> two-float (Knuth add22, ~11 flops)."""
    s, e = two_sum(xh, yh)
    e = e + (xl + yl)
    return fast_two_sum(s, e)


def tf_add_f32(xh, xl, y):
    """Two-float + f32 -> two-float."""
    s, e = two_sum(xh, y)
    e = e + xl
    return fast_two_sum(s, e)


def tf_mul_f32(xh, xl, y):
    """Two-float * f32 -> two-float."""
    p, e = two_prod(xh, y)
    e = e + xl * y
    return fast_two_sum(p, e)


def tf_neg(xh, xl):
    return -xh, -xl


def tf_round(xh, xl):
    """Collapse a two-float to the nearest f32."""
    return xh + xl


def tf_from_f64(x64):
    """Represent a HOST f64 numpy array as an f32 pair (hi = round(x),
    lo = round(x - hi)); |combined error| ~ 2^-48 relative.

    The split arithmetic runs in host numpy — f64 never touches the
    device.
    """
    import numpy as np

    x64 = np.asarray(x64, np.float64)
    hi = x64.astype(np.float32)
    lo = (x64 - hi.astype(np.float64)).astype(np.float32)
    return jnp.asarray(hi), jnp.asarray(lo)


def tf_dot_accumulate(carry, a, b):
    """carry (h, l) += a * b with error-free product + compensated add.

    ``a * b`` enters via two_prod so neither the product rounding nor
    the accumulation rounding is lost; use inside lax.scan/fori over
    the contraction axis.
    """
    h, l = carry
    p, e = two_prod(a, b)
    h, l2 = tf_add(h, l, p, e)
    return h, l2


def tf_tree_sum(h, l, axis: int):
    """Pairwise (tree) two-float reduction along ``axis``; returns the
    (h, l) pair with that axis summed out.

    Reassociates the compensated sum into a binary tree: identical
    error class to the sequential tf_add accumulation (pairwise
    summation's constant is in fact smaller), but log2(N) sequential
    depth instead of N.  Motivation (round 4): the ND-SKI compensated
    apply was built from lax.scan chains over the cell (~C≈100s) and
    Toeplitz (m_d) axes — tiny per-step work, so the apply was pure
    sequential latency.  The
    tree form runs the same flops in a handful of fused vector ops.
    """
    h = jnp.moveaxis(h, axis, 0)
    l = jnp.moveaxis(l, axis, 0)
    n = h.shape[0]
    # pad to a power of two with exact zeros (identity for tf_add)
    p = 1 << max(0, (n - 1).bit_length())
    if p != n:
        pad = [(0, p - n)] + [(0, 0)] * (h.ndim - 1)
        h = jnp.pad(h, pad)
        l = jnp.pad(l, pad)
    while h.shape[0] > 1:
        h, l = tf_add(h[0::2], l[0::2], h[1::2], l[1::2])
    return h[0], l[0]
