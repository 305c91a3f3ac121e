"""Data-sharded SGPR over a device mesh.

The multi-device extension of models/sgpr.py: the n training rows are
sharded over a 1-D mesh and each device runs the blocked O(n m^2 / D)
moment sweep on its own rows; ONE ``psum`` of the four accumulators
(C (m, m), b (m,), ||y||^2, tr K_ff) is the only communication —
O(m^2) bytes total, independent of n.  The (m, m) tail (pinv
whitening, eigh / LU bound) then runs replicated on every device via
the exact same ``models.sgpr._fit_from_moments`` /
``_elbo_from_moments`` code, so the sharded results equal the
single-device ones up to the psum's reduction order (gated at 1e-12
rel in f64, tests/test_sgpr_sharded.py).

This is the cheapest-communicating distributed regime in the framework:
where the row-sharded CG path (parallel/iterative_sharded.py) pays an
all_gather of (n, r) Krylov vectors per iteration, SGPR pays one
m^2-sized reduction per fit/objective evaluation.

The MLE builder threads (theta, noise[, z]) through the shard_map as
replicated traced arguments (same pattern as
parallel/iterative_sharded._build_vg_sharded) so one compiled
executable serves the whole Adam scan, and gradients flow through the
psum (d psum = broadcast) and the custom psd_pinv VJP.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from gaussian_processes_tpu.models.base import Kernel
from gaussian_processes_tpu.models import sgpr as sgpr_mod
from gaussian_processes_tpu.models.sgpr import SGPRPosterior
from gaussian_processes_tpu.parallel.iterative_sharded import make_row_mesh


def _moments_sharded(
    kernel_template: Kernel, mesh: Mesh, axis: str, block_size: int,
    jitter: float,
):
    """shard_map'ed sweep: (x, y, z, theta, noise) -> global moments.

    x/y are row-sharded; z/theta/noise replicated.  Returns the tuple
    ``models.sgpr._moments`` returns, replicated on every device."""

    def local(x_loc, y_loc, z, theta, noise):
        kernel = kernel_template.with_params(theta)
        m = z.shape[0]
        dtype = y_loc.dtype
        with jax.default_matmul_precision("highest"):
            Kuu = kernel(z, z) + jitter * jnp.eye(m, dtype=dtype)
            C, bv, yty, trk = sgpr_mod._sweep(
                kernel, x_loc, y_loc, z, block_size
            )
        C = lax.psum(C, axis)
        bv = lax.psum(bv, axis)
        yty = lax.psum(yty, axis)
        trk = lax.psum(trk, axis)
        return Kuu, C, bv, yty, trk

    return jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(axis), P(axis), P(), P(), P()),
        out_specs=(P(), P(), P(), P(), P()),
        check_vma=False,
    )


def _prep(x, y, z, mesh, axis):
    x = jnp.asarray(x)
    y = jnp.asarray(y)
    z = jnp.asarray(z)
    if mesh is None:
        mesh = make_row_mesh(axis=axis)
    n_dev = mesh.shape[axis]
    if y.shape[0] % n_dev != 0:
        raise ValueError(
            f"mesh size ({n_dev}) must evenly divide n ({y.shape[0]})"
        )
    return x, y, z, mesh


def fit_sgpr_sharded(
    kernel: Kernel,
    x,
    y,
    noise,
    z,
    *,
    mesh: Mesh | None = None,
    axis: str = "i",
    block_size: int = 8192,
    jitter: float = 0.0,
    rank_tol: float | None = None,
) -> SGPRPosterior:
    """``models.sgpr.fit_sgpr`` with the moment sweep sharded over
    ``mesh``; the returned posterior is replicated (it is (m, m))."""
    x, y, z, mesh = _prep(x, y, z, mesh, axis)
    noise = jnp.asarray(noise)
    if rank_tol is None:
        rank_tol = sgpr_mod._default_rank_tol(y.dtype)
    sweep = _moments_sharded(kernel, mesh, axis, block_size, jitter)
    Kuu, C, bv, yty, trk = sweep(x, y, z, kernel.params, noise)
    return sgpr_mod._fit_from_moments(
        kernel, z, noise, y.shape[0], Kuu, C, bv, yty, trk,
        jnp.square(noise), rank_tol,
    )


def elbo_sgpr_sharded(
    kernel: Kernel,
    x,
    y,
    noise,
    z,
    *,
    mesh: Mesh | None = None,
    axis: str = "i",
    block_size: int = 8192,
    jitter: float = 0.0,
    rank_tol: float | None = None,
) -> jax.Array:
    """The collapsed bound with a sharded sweep — differentiable in
    (kernel params, noise, z) exactly like ``models.sgpr.elbo_sgpr``."""
    x, y, z, mesh = _prep(x, y, z, mesh, axis)
    noise = jnp.asarray(noise)
    if rank_tol is None:
        rank_tol = sgpr_mod._default_rank_tol(y.dtype)
    sweep = _moments_sharded(kernel, mesh, axis, block_size, jitter)
    Kuu, C, bv, yty, trk = sweep(x, y, z, kernel.params, noise)
    return sgpr_mod._elbo_from_moments(
        y.shape[0], Kuu, C, bv, yty, trk, jnp.square(noise), rank_tol
    )


def fit_sgpr_mle_sharded(
    kernel_template: Kernel,
    x,
    y,
    noise_init,
    z0,
    *,
    mesh: Mesh | None = None,
    axis: str = "i",
    learn_inducing: bool = False,
    num_steps: int = 200,
    learning_rate: float = 0.05,
    block_size: int = 8192,
    jitter: float = 0.0,
    rank_tol: float | None = None,
):
    """``models.sgpr.fit_sgpr_mle`` with every objective evaluation's
    sweep sharded over the mesh.  One compiled Adam scan; returns
    (SGPRPosterior at the optimum, losses)."""
    import optax
    from gaussian_processes_tpu.inference import gp_model

    x, y, z0, mesh = _prep(x, y, z0, mesh, axis)
    n = y.shape[0]
    if rank_tol is None:
        rank_tol = sgpr_mod._default_rank_tol(y.dtype)
    sweep = _moments_sharded(kernel_template, mesh, axis, block_size, jitter)

    Pn = kernel_template.n_params
    u_theta0 = gp_model.pack(kernel_template, noise_init)
    u0 = (
        jnp.concatenate([u_theta0, z0.ravel().astype(u_theta0.dtype)])
        if learn_inducing
        else u_theta0
    )

    def loss_fn(u):
        theta = jnp.exp(u[:Pn])
        noise = jnp.exp(u[Pn])
        z = u[Pn + 1:].reshape(z0.shape) if learn_inducing else z0
        Kuu, C, bv, yty, trk = sweep(x, y, z, theta, noise)
        return -sgpr_mod._elbo_from_moments(
            n, Kuu, C, bv, yty, trk, jnp.square(noise), rank_tol
        )

    opt = optax.adam(learning_rate)

    def step(carry, _):
        u, st, best_u, best_loss = carry
        value, grad = jax.value_and_grad(loss_fn)(u)
        updates, st = opt.update(grad, st, u)
        u2 = optax.apply_updates(u, updates)
        better = value < best_loss
        best_u = jnp.where(better, u, best_u)
        best_loss = jnp.where(better, value, best_loss)
        return (u2, st, best_u, best_loss), value

    init = (u0, opt.init(u0), u0, jnp.asarray(jnp.inf, u0.dtype))
    (u, _, best_u, best_loss), losses = lax.scan(
        step, init, None, length=num_steps
    )
    final = loss_fn(u)
    best_u = jnp.where(final < best_loss, u, best_u)

    kernel, noise = gp_model.unpack(kernel_template, best_u[: Pn + 1])
    z = best_u[Pn + 1:].reshape(z0.shape) if learn_inducing else z0
    post = fit_sgpr_sharded(
        kernel, x, y, noise, z, mesh=mesh, axis=axis,
        block_size=block_size, jitter=jitter, rank_tol=rank_tol,
    )
    return post, losses
