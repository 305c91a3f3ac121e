"""Distributed blocked Cholesky: row-block-cyclic over a 1-D device mesh.

Why this exists (SURVEY.md §6.7c, BASELINE.json:10): at N=65k the kernel
matrix is 17 GB in f32, and it grows as N^2 past any one device's
memory.  XLA's ``jnp.linalg.cholesky`` on a sharded operand gathers it
to every device, so the way to factor past one device is a hand-blocked
SPMD algorithm where each device only ever holds its N^2/D share plus
one N x b panel.  This module is that algorithm, riding collectives
(``psum``/``all_gather``) inside ``shard_map``.

Layout: pad N to m*b with m divisible by D; device d owns row-blocks
``g = d + l*D`` (block-cyclic, so late panels still spread over all
devices), stored as ``A[l, j]`` = (b, b) block at global (g, j).  The
kernel matrix is built *directly into this layout* — each device
evaluates the covariance only for its own rows, so no global N x N array
ever exists.

Right-looking factorization, for k = 0..m-1:
  1. replicate the diagonal block via masked ``psum``; all devices
     compute the same b x b Cholesky L_kk (cheap, b^3);
  2. owned rows below k solve L_gk = A_gk L_kk^{-T} (vmapped b x b
     triangular solves);
  3. ``all_gather`` the column-k panel (N x b) — the one collective that
     moves O(N b) data per step;
  4. rank-b SYRK trailing update of owned blocks (batched matmuls).
     Rows at or above k contribute zero panel entries, so no masking is
     needed; upper-triangle blocks accumulate garbage that is never read.

Blocked forward/backward substitution reuse the same layout (row k lives
wholly on its owner; transposed solves reduce over owned rows with
``psum``), giving alpha = K^-1 y and predictive-variance solves without
ever gathering L.

Numerics match ``jnp.linalg.cholesky`` + ``solve_triangular`` to
round-off; tests compare against the dense path on an 8-device CPU mesh.
"""

from __future__ import annotations

import dataclasses
import functools
from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.scipy.linalg import solve_triangular
from jax.sharding import Mesh, PartitionSpec as P

from gaussian_processes_tpu.models.base import Kernel

from gaussian_processes_tpu.models.gp import _LOG_2PI


def _with_highest(fn, *args):
    with jax.default_matmul_precision("highest"):
        return fn(*args)


def _padded_dims(n: int, n_dev: int, block_size: int) -> Tuple[int, int]:
    """(m, n_pad): number of row/col blocks and padded size."""
    chunk = n_dev * block_size
    n_pad = ((n + chunk - 1) // chunk) * chunk
    return n_pad // block_size, n_pad


def _build_local_blocks(kernel, x_pad, own_g, n, b, m, noise, jitter):
    """Device-local row-block strip of K + (s^2+jitter) I, (m_loc, m, b, b).

    Padded rows/cols are identity so the factorization and solves pass
    through them untouched.
    """
    xr = x_pad.reshape(m, b)
    x_own = xr[own_g].reshape(-1)  # (m_loc * b,)
    # XLA fuses the pairwise difference into the kernel's elementwise
    # form, so no difference matrix is materialized
    Kl = kernel(x_own, x_pad)  # (m_loc*b, n_pad)
    m_loc = own_g.shape[0]
    A = Kl.reshape(m_loc, b, m, b).transpose(0, 2, 1, 3)  # (m_loc, m, b, b)

    row_idx = (own_g[:, None] * b + jnp.arange(b)[None, :])  # (m_loc, b)
    col_idx = (jnp.arange(m)[:, None] * b + jnp.arange(b)[None, :])  # (m, b)
    rv = (row_idx < n)[:, None, :, None]  # (m_loc, 1, b, 1)
    cv = (col_idx < n)[None, :, None, :]  # (1, m, 1, b)
    A = jnp.where(rv & cv, A, 0.0)
    # diagonal: +s^2+jitter on valid entries, +1 on padded entries
    eq = row_idx[:, None, :, None] == col_idx[None, :, None, :]
    diag_term = jnp.where(rv, jnp.square(noise) + jitter, 1.0)
    A = A + jnp.where(eq, diag_term, 0.0).astype(A.dtype)
    return A


def _factor_body(axis, d, own_g, m, D, k, A):
    l_k = k // D
    own = (k % D) == d

    # 1. replicated diagonal block
    rowk = lax.dynamic_index_in_dim(A, l_k, 0, keepdims=False)  # (m, b, b)
    Akk = lax.psum(
        jnp.where(own, lax.dynamic_index_in_dim(rowk, k, 0, keepdims=False), 0.0),
        axis,
    )
    Lkk = jnp.linalg.cholesky(Akk)

    # 2. panel solve on owned rows strictly below k
    col = lax.dynamic_index_in_dim(A, k, 1, keepdims=False)  # (m_loc, b, b)
    Lcol = jax.vmap(
        lambda Aik: solve_triangular(Lkk, Aik.T, lower=True).T
    )(col)
    below = (own_g > k)[:, None, None]
    at_k = (own_g == k)[:, None, None]
    newcol = jnp.where(below, Lcol, col)
    newcol = jnp.where(at_k, Lkk[None], newcol)
    A = lax.dynamic_update_index_in_dim(A, newcol, k, 1)

    # 3. panel broadcast: P[g] = L_gk for g > k else 0
    gathered = lax.all_gather(jnp.where(below, newcol, 0.0), axis)
    m_loc = own_g.shape[0]
    Ppanel = gathered.transpose(1, 0, 2, 3).reshape(m, *gathered.shape[2:])

    # 4. trailing SYRK: A_gj -= L_gk L_jk^T (zero panels rows mask themselves)
    P_own = Ppanel[own_g]  # (m_loc, b, b)
    upd = jnp.einsum(
        "lab,jcb->ljac", P_own, Ppanel, preferred_element_type=A.dtype
    )
    return A - upd


def _forward_solve_body(axis, d, A, m, D, b, k, ybar):
    """One step of L ybar = rhs; ybar (m, b, r), rows < k already solved."""
    l_k = k // D
    own = (k % D) == d
    rowk = lax.dynamic_index_in_dim(A, l_k, 0, keepdims=False)  # (m, b, b)
    maskj = (jnp.arange(m) < k)[:, None, None]
    partial = jnp.einsum(
        "jab,jbr->ar", jnp.where(maskj, rowk, 0.0), ybar,
        preferred_element_type=ybar.dtype,
    )
    Lkk = lax.dynamic_index_in_dim(rowk, k, 0, keepdims=False)
    contrib = jnp.where(own, partial, 0.0)
    Lkk_r = lax.psum(jnp.where(own, Lkk, 0.0), axis)
    partial_r = lax.psum(contrib, axis)
    rhs_k = lax.dynamic_index_in_dim(ybar, k, 0, keepdims=False) - partial_r
    # note: ybar[k] still holds the raw rhs block before this step
    yk = solve_triangular(Lkk_r, rhs_k, lower=True)
    return lax.dynamic_update_index_in_dim(ybar, yk, k, 0)


def _backward_solve_body(axis, d, A, own_g, m, D, i, z):
    """One step of L^T z = ybar, from the bottom; z (m, b, r)."""
    k = m - 1 - i
    l_k = k // D
    own = (k % D) == d
    colk = lax.dynamic_index_in_dim(A, k, 1, keepdims=False)  # (m_loc, b, b)
    below = (own_g > k)[:, None, None]
    z_own = z[own_g]  # (m_loc, b, r)
    partial = jnp.einsum(
        "lab,lar->br", jnp.where(below, colk, 0.0), z_own,
        preferred_element_type=z.dtype,
    )
    partial_r = lax.psum(partial, axis)
    rowk = lax.dynamic_index_in_dim(A, l_k, 0, keepdims=False)
    Lkk_r = lax.psum(
        jnp.where(own, lax.dynamic_index_in_dim(rowk, k, 0, keepdims=False), 0.0),
        axis,
    )
    rhs_k = lax.dynamic_index_in_dim(z, k, 0, keepdims=False) - partial_r
    zk = solve_triangular(Lkk_r.T, rhs_k, lower=False)
    return lax.dynamic_update_index_in_dim(z, zk, k, 0)


@functools.lru_cache(maxsize=64)
def _fit_program(mesh, axis, n, b, m, m_loc, D, jitter):
    """Compiled factor+solve program, cached per (mesh, geometry, jitter).

    The kernel rides in as a traced pytree argument, so repeated fits
    with different hyperparameters reuse one compilation.
    """
    n_pad = m * b

    def local_fn(kernel, x_pad, y_pad, noise):
        # full-f32 matmuls: the trailing SYRK updates accumulate across
        # m panels; bf16 multiplies would poison the factorization
        d = lax.axis_index(axis)
        own_g = d + jnp.arange(m_loc) * D

        A = _build_local_blocks(kernel, x_pad, own_g, n, b, m, noise, jitter)
        A = lax.fori_loop(
            0, m, partial(_factor_body, axis, d, own_g, m, D), A
        )

        # log|K|^(1/2) = sum log diag(L): owned diagonal blocks only
        diag_blocks = jax.vmap(
            lambda l: lax.dynamic_index_in_dim(A[l], own_g[l], 0, keepdims=False)
        )(jnp.arange(m_loc))
        logdiag = lax.psum(
            jnp.sum(jnp.log(jax.vmap(jnp.diagonal)(diag_blocks))), axis
        )

        # alpha = K^-1 y via two blocked substitutions (padded rows pass
        # through the identity blocks untouched)
        rhs = y_pad.reshape(m, b, 1)
        ybar = lax.fori_loop(
            0, m, partial(_forward_solve_body, axis, d, A, m, D, b), rhs
        )
        z = lax.fori_loop(
            0, m, partial(_backward_solve_body, axis, d, A, own_g, m, D), ybar
        )
        alpha = z.reshape(n_pad)[:n]

        lml = (
            -0.5 * jnp.dot(y_pad.reshape(-1)[:n], alpha)
            - logdiag
            - 0.5 * n * _LOG_2PI
        )
        return A, alpha, lml

    local_fn_hi = lambda *a: _with_highest(local_fn, *a)
    return jax.jit(
        jax.shard_map(
            local_fn_hi,
            mesh=mesh,
            in_specs=(P(), P(), P(), P()),
            out_specs=(P(axis), P(), P()),
            check_vma=False,
        )
    )


@functools.lru_cache(maxsize=64)
def _predict_program(mesh, axis, mm, b, D, n, r):
    """Compiled forward-substitution program for predictive variance."""
    n_pad = mm * b

    def local_fn(A, rhs):
        d = lax.axis_index(axis)
        v = lax.fori_loop(
            0,
            mm,
            partial(_forward_solve_body, axis, d, A, mm, D, b),
            rhs.reshape(mm, b, r),
        )
        return v.reshape(n_pad, r)

    local_fn_hi = lambda *a: _with_highest(local_fn, *a)
    return jax.jit(
        jax.shard_map(
            local_fn_hi,
            mesh=mesh,
            in_specs=(P(axis), P()),
            out_specs=P(),
            check_vma=False,
        )
    )


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class BlockCyclicPosterior:
    """Exact-GP posterior with the Cholesky factor left distributed.

    ``L_blocks`` is the global (m, m, b, b) block array sharded over the
    mesh axis on its leading dimension grouped by owner; use
    ``solve_lower``/``solve_upper`` rather than touching it directly.
    """

    kernel: Kernel
    x: jax.Array
    y: jax.Array
    noise: jax.Array
    L_blocks: jax.Array  # (m, m, b, b), rows grouped by owning device
    alpha: jax.Array  # (n,) replicated
    log_marginal: jax.Array


def fit_blockcyclic(
    kernel: Kernel,
    x,
    y,
    noise,
    mesh: Mesh,
    axis: str = "shard",
    block_size: int = 256,
    jitter: float = 1e-5,
) -> BlockCyclicPosterior:
    """Exact GP fit at large N without materializing K on any device.

    Matches ``models.gp.fit`` numerically (tests gate at 1e-8 rel in
    f64); memory per device is N^2/D + one N x b panel.
    """
    x = jnp.asarray(x)
    y = jnp.asarray(y)
    noise = jnp.asarray(noise, x.dtype)
    n = x.shape[0]
    D = mesh.shape[axis]
    b = block_size
    m, n_pad = _padded_dims(n, D, b)
    m_loc = m // D

    x_pad = jnp.zeros(n_pad, x.dtype).at[:n].set(x)
    y_pad = jnp.zeros(n_pad, x.dtype).at[:n].set(y)

    fn = _fit_program(mesh, axis, n, b, m, m_loc, D, float(jitter))
    A, alpha, lml = fn(kernel, x_pad, y_pad, noise)
    return BlockCyclicPosterior(
        kernel=kernel,
        x=x,
        y=y,
        noise=noise,
        L_blocks=A,
        alpha=alpha,
        log_marginal=lml,
    )


def predict_diag_blockcyclic(
    post: BlockCyclicPosterior,
    xo,
    mesh: Mesh,
    axis: str = "shard",
):
    """Predictive mean/variance using the distributed factor.

    mean needs only alpha (one (m_t, n) matvec); variance runs the
    blocked forward substitution with the m_t cross-covariance columns
    as the right-hand-side block.
    """
    xo = jnp.asarray(xo)
    n = post.x.shape[0]
    D = mesh.shape[axis]
    mm = post.L_blocks.shape[0]
    b = post.L_blocks.shape[2]
    n_pad = mm * b
    r = xo.shape[0]

    Kxox = post.kernel(xo, post.x)  # (r, n)
    mean = Kxox @ post.alpha

    rhs = jnp.zeros((n_pad, r), Kxox.dtype).at[:n].set(Kxox.T)
    fn = _predict_program(mesh, axis, mm, b, D, n, r)
    v = fn(post.L_blocks, rhs)[:n]
    var = post.kernel.kdiag(xo) - jnp.sum(v * v, axis=0)
    return mean, var
