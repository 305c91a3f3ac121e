"""Fused kernel-matvec and Jacobian-matvec: Pallas kernels for the GPU.

The matrix-free paths (``ops/krylov.py``, ``models/iterative_gp.py``)
need ``(K + s^2 I) V`` and ``dK/dtheta_p @ U`` for skinny ``V``/``U``
(n x r, r ~ 9).  The plain-XLA strip scan writes every (n, b) strip of K
to device memory and reads it back for the contraction: about 8 n^2
bytes per matvec.  These kernels build each (bm, bn) tile of K from the
coordinates and contract it on the spot, so device memory sees only x,
V and the (n, r) output.

Design (Pallas through Triton, ``backend="triton"``):

* the grid runs over row blocks only; a ``fori_loop`` inside each
  program walks the column blocks and carries the (bm, r) accumulator —
  GPU programs run in no order, so nothing may carry across grid steps;
* block sizes are powers of two, and r is padded to a power of two of
  at least 16, the narrowest operand Triton's dot takes;
* the contraction runs in full fp32 (``Precision.HIGHEST``): TF32 keeps
  about three digits, which caps the CG residual far above the
  tolerances the fits ask for.

The elementwise cores are the same ``Kernel.k_fn``/``jac_fn`` static
methods the jnp path uses (Sum/Product trees compose them), so the two
paths cannot drift.

``interpret=True`` runs a kernel in the Pallas interpreter, which is how
the CPU tests reach it.  Without it, a call on any backend but the GPU
raises.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

from gaussian_processes_tpu.models.base import Kernel

#: (rows, cols) of one K tile: rows per program, columns per loop step.
MATVEC_BLOCK = (64, 128)
JACVEC_BLOCK = (32, 64)
#: Triton's dot needs every operand dimension >= 16.
_MIN_WIDTH = 16


def tile_program(kernel: Kernel):
    """(static elementwise fn, params array) for the tile body.

    Leaf kernels return their class ``k_fn``; Sum/Product composites get
    a *composed* static function built recursively from their (static)
    structure, so a quasi-periodic ``SE * periodic`` evaluates its
    covariance in one pass over each tile.  The composed function is
    cached per structure, so jit sees a stable callable.
    """
    struct = _tile_structure(kernel)
    fn, _ = _fn_from_structure(struct)
    return fn, kernel.params


def _tile_structure(kernel: Kernel):
    from gaussian_processes_tpu.models.composite import (
        ProductKernel,
        SumKernel,
    )

    if isinstance(kernel, SumKernel):
        return ("sum", _tile_structure(kernel.k1), _tile_structure(kernel.k2))
    if isinstance(kernel, ProductKernel):
        return ("prod", _tile_structure(kernel.k1), _tile_structure(kernel.k2))
    if type(kernel).supports_tiled:
        return ("leaf", type(kernel))
    raise TypeError(
        f"{type(kernel).__name__} has no tile form (needs a static k_fn "
        "over 1-D differences, or a Sum/Product tree of such kernels)"
    )


@functools.lru_cache(maxsize=None)
def _fn_from_structure(struct):
    kind = struct[0]
    if kind == "leaf":
        cls = struct[1]
        return cls.k_fn, len(cls.param_names)
    f1, p1 = _fn_from_structure(struct[1])
    f2, p2 = _fn_from_structure(struct[2])
    if kind == "sum":
        def fn(d, *params):
            return f1(d, *params[:p1]) + f2(d, *params[p1:])
    else:
        def fn(d, *params):
            return f1(d, *params[:p1]) * f2(d, *params[p1:])
    return fn, p1 + p2


def _require_gpu(interpret: bool) -> None:
    if not interpret and jax.default_backend() != "gpu":
        raise RuntimeError(
            "the fused Pallas kernels are compiled for the GPU (Triton); "
            f"the default backend is {jax.default_backend()!r}.  Pass "
            "interpret=True to run them in the Pallas interpreter."
        )


def _ceil_mult(n: int, m: int) -> int:
    return -(-n // m) * m


def _padded_width(r: int) -> int:
    """Smallest power of two >= max(r, 16)."""
    return max(_MIN_WIDTH, 1 << (r - 1).bit_length())


def _contract(tile, v):
    # full fp32 (no TF32) on the card; ``pl.dot`` would also force an
    # f32 result, which the f64 interpreter tests must not get
    return jnp.dot(tile, v, precision=lax.Precision.HIGHEST,
                   preferred_element_type=v.dtype)


def _matvec_body(k_fn, n_params, n_col_blocks, bn,
                 params_ref, xr_ref, xc_ref, v_ref, out_ref):
    """out[rows] = sum_j K(x_rows, x_cols[j]) @ v[j], one row block."""
    params = [params_ref[k] for k in range(n_params)]
    xr = xr_ref[...]

    def step(j, acc):
        cols = pl.ds(pl.multiple_of(j * bn, bn), bn)
        tile = k_fn(xr[:, None] - xc_ref[cols][None, :], *params)
        return acc + _contract(tile, v_ref[cols, :])

    acc = jnp.zeros(out_ref.shape, out_ref.dtype)
    out_ref[...] = lax.fori_loop(0, n_col_blocks, step, acc)


def _jacvec_body(jac_fn, n_params, n_col_blocks, bn,
                 params_ref, xr_ref, xc_ref, u_ref, *out_refs):
    """out_p[rows] = sum_j dK/dtheta_p(x_rows, x_cols[j]) @ u[j]."""
    params = [params_ref[k] for k in range(n_params)]
    xr = xr_ref[...]

    def step(j, accs):
        cols = pl.ds(pl.multiple_of(j * bn, bn), bn)
        u = u_ref[cols, :]
        jac = jac_fn(xr[:, None] - xc_ref[cols][None, :], *params)
        return tuple(a + _contract(t, u) for a, t in zip(accs, jac))

    accs = tuple(jnp.zeros(o.shape, o.dtype) for o in out_refs)
    accs = lax.fori_loop(0, n_col_blocks, step, accs)
    for o, a in zip(out_refs, accs):
        o[...] = a


def _ard_matvec_body(D, n_params, n_col_blocks, bn,
                     params_ref, xr_ref, xc_ref, v_ref, out_ref):
    """ARD SE over (D, n) transposed inputs: the squared distance builds
    up one dimension at a time, so no (bm, bn, D) difference exists."""
    del n_params
    h = params_ref[0]
    inv_w = [1.0 / params_ref[1 + d] for d in range(D)]
    xr = [xr_ref[d, :] * inv_w[d] for d in range(D)]

    def step(j, acc):
        cols = pl.ds(pl.multiple_of(j * bn, bn), bn)
        q = None
        for d in range(D):
            diff = xr[d][:, None] - (xc_ref[d, cols] * inv_w[d])[None, :]
            q = diff * diff if q is None else q + diff * diff
        tile = (h * h) * jnp.exp(-0.5 * q)
        return acc + _contract(tile, v_ref[cols, :])

    acc = jnp.zeros(out_ref.shape, out_ref.dtype)
    out_ref[...] = lax.fori_loop(0, n_col_blocks, step, acc)


_BODIES = {
    "matvec": _matvec_body,
    "jacvec": _jacvec_body,
    "ard_matvec": _ard_matvec_body,
}


@functools.partial(
    jax.jit,
    static_argnames=("kind", "elem", "n_out", "block", "num_warps",
                     "interpret"),
)
def _fused_call(kind, elem, n_out, params, xr, xc, v, *, block,
                num_warps, interpret):
    """Row-block grid over padded, block-aligned operands.

    ``xr`` (n_r,) and ``xc`` (n_c,) — or (D, n_r)/(D, n_c) for ARD — are
    multiples of ``bm``/``bn`` long; ``v`` is (n_c, r) with r a power of
    two >= 16 and zero rows past the real columns, so padded columns
    contribute nothing.
    """
    bm, bn = block
    n_r, n_c, r = xr.shape[-1], xc.shape[-1], v.shape[1]
    lead = xr.shape[:-1]  # () or (D,)
    body = functools.partial(
        _BODIES[kind], elem, params.shape[0], n_c // bn, bn
    )
    out = jax.ShapeDtypeStruct((n_r, r), v.dtype)
    out_spec = pl.BlockSpec((bm, r), lambda i: (i, 0))
    return pl.pallas_call(
        body,
        out_shape=[out] * n_out,
        grid=(n_r // bm,),
        in_specs=[
            pl.BlockSpec(params.shape, lambda i: (0,)),
            pl.BlockSpec((*lead, bm), lambda i: (*(0 for _ in lead), i)),
            pl.BlockSpec(xc.shape, lambda i: (0,) * xc.ndim),
            pl.BlockSpec((n_c, r), lambda i: (0, 0)),
        ],
        out_specs=[out_spec] * n_out,
        backend="triton",
        compiler_params=pl_triton.CompilerParams(num_warps=num_warps),
        interpret=interpret,
        name=f"fused_{kind}",
    )(params, xr, xc, v)


def _pad_operands(x_rows, x_cols, v, block):
    """Pad the point axis (last) of x to block multiples, v's to match."""
    bm, bn = block
    n_r, n_c, r = x_rows.shape[-1], x_cols.shape[-1], v.shape[1]
    lead = [(0, 0)] * (x_rows.ndim - 1)
    xr = jnp.pad(x_rows, lead + [(0, _ceil_mult(n_r, bm) - n_r)])
    xc = jnp.pad(x_cols, lead + [(0, _ceil_mult(n_c, bn) - n_c)])
    vp = jnp.pad(v, [(0, xc.shape[-1] - n_c), (0, _padded_width(r) - r)])
    return xr, xc, vp


def kernel_matvec_fused(
    kernel: Kernel,
    x,
    v,
    noise,
    jitter: float = 0.0,
    *,
    x_rows=None,
    block=MATVEC_BLOCK,
    num_warps: int = 4,
    interpret: bool = False,
) -> jax.Array:
    """(K(x, x) + (noise^2 + jitter) I) @ v with K never in device memory.

    Fused twin of ``ops.krylov.kernel_matvec`` (same contract, including
    ``x_rows``: the rectangular K(x_rows, x) @ v with no diagonal term)
    for tile-capable kernels (leaves, Sum/Product trees) over 1-D inputs
    and ``ARDGaussianKernel`` over (n, D) inputs.  Not differentiable;
    the matrix-free gradients use explicit Jacobian products, never AD
    through the matvec.
    """
    _require_gpu(interpret)
    x = jnp.asarray(x)
    if not supports_fused_matvec(kernel, x):
        raise TypeError(
            f"no fused matvec for {type(kernel).__name__} over "
            f"{x.ndim}-D inputs"
        )
    v = jnp.asarray(v)
    squeeze = v.ndim == 1
    v2 = v[:, None] if squeeze else v
    rows = x if x_rows is None else jnp.asarray(x_rows)
    if x.ndim == 2:
        kind, elem, params = "ard_matvec", x.shape[1], kernel.params
        rows, cols = rows.T, x.T
    else:
        kind, cols = "matvec", x
        elem, params = tile_program(kernel)
    xr, xc, vp = _pad_operands(rows, cols, v2, block)
    (out,) = _fused_call(kind, elem, 1, params.astype(x.dtype), xr, xc, vp,
                         block=block, num_warps=num_warps,
                         interpret=interpret)
    out = out[: rows.shape[-1], : v2.shape[1]]
    if x_rows is None:
        diag = jnp.square(jnp.asarray(noise, out.dtype)) + jnp.asarray(
            jitter, out.dtype
        )
        out = out + diag * v2
    return out[:, 0] if squeeze else out


def kernel_jacvec_fused(
    kernel: Kernel,
    x,
    u,
    *,
    block=JACVEC_BLOCK,
    num_warps: int = 4,
    interpret: bool = False,
) -> jax.Array:
    """(P, n, r) = stack_p(dK/dtheta_p @ u) without materializing dK/dtheta.

    Leaf tile-capable kernels only (the closed-form ``jac_fn`` runs per
    tile); callers use the strip scan otherwise.
    """
    _require_gpu(interpret)
    x = jnp.asarray(x)
    u = jnp.asarray(u)
    if not supports_fused_jacvec(kernel, x):
        raise TypeError(
            f"{type(kernel).__name__} over {x.ndim}-D inputs has no static "
            "tiled jac_fn form"
        )
    cls = type(kernel)
    xr, xc, up = _pad_operands(x, x, u, block)
    outs = _fused_call("jacvec", cls.jac_fn, len(cls.param_names),
                       kernel.params.astype(x.dtype), xr, xc, up,
                       block=block, num_warps=num_warps,
                       interpret=interpret)
    n, r = x.shape[0], u.shape[1]
    return jnp.stack([o[:n, :r] for o in outs])


def supports_fused_jacvec(kernel: Kernel, x) -> bool:
    # class-level literal True only: composites expose supports_tiled as
    # a property (truthy as a class attribute even when instances say
    # False) but have no static jac_fn/param_names
    return (
        jnp.ndim(x) == 1
        and getattr(type(kernel), "supports_tiled", False) is True
    )


def supports_fused_matvec(kernel: Kernel, x) -> bool:
    """True when ``kernel_matvec_fused`` can run for this (kernel, x)."""
    from gaussian_processes_tpu.models.ard import ARDGaussianKernel

    if jnp.ndim(x) == 2:
        return isinstance(kernel, ARDGaussianKernel)
    if jnp.ndim(x) != 1:
        return False
    try:
        _tile_structure(kernel)
        return True
    except TypeError:
        return False


# The defaults take a fused kernel only where it was timed against the
# strip scan on the card and won (PERF.md, bring-up findings): the SE
# matvec and the SE and periodic Jacobian-matvecs, over 1-D inputs, with
# at most 16 right-hand sides (timed at r = 9, which pads to 16).
# Composite and ARD kernels and wider right-hand sides run correctly
# through the fused kernels but were not timed, so they stay on the strip.
_TIMED_MAX_WIDTH = _MIN_WIDTH


def fused_matvec_default(kernel: Kernel, x, width: int) -> bool:
    """Whether ``kernel_matvec(impl="auto")`` takes the fused kernel for
    ``width`` right-hand sides."""
    from gaussian_processes_tpu.models.gaussian import GaussianKernel

    return (
        jax.default_backend() == "gpu"
        and jnp.ndim(x) == 1
        and width <= _TIMED_MAX_WIDTH
        and type(kernel) is GaussianKernel
    )


def fused_jacvec_default(kernel: Kernel, x, width: int) -> bool:
    """Whether the matrix-free gradient takes ``kernel_jacvec_fused`` for
    ``width`` right-hand sides."""
    from gaussian_processes_tpu.models.gaussian import GaussianKernel
    from gaussian_processes_tpu.models.periodic import PeriodicKernel

    return (
        jax.default_backend() == "gpu"
        and jnp.ndim(x) == 1
        and width <= _TIMED_MAX_WIDTH
        and type(kernel) in (GaussianKernel, PeriodicKernel)
    )
