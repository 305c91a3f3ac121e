"""Large-N exact GP with the kernel matrix sharded over a 2-D device mesh.

The reference is single-process (SURVEY.md §3); scaling N is this
framework's analogue of "long context" (SURVEY.md §6.7): the N x N kernel
matrix at N=65k is 16.9 GB in f32, so for multi-device runs K is 2-D
block-sharded over a ``Mesh(('i','j'))`` and the Cholesky/solves run as
XLA's distributed factorization with collectives (SURVEY.md
§6.7c).  The tensor-parallel axis of this framework.

Design: pure ``jit`` + ``NamedSharding`` constraints — we annotate where K
and its factor live and let XLA insert the panel broadcasts
(``all_gather``/``ppermute``) rather than hand-writing ScaLAPACK.  The
x/y vectors are replicated (tiny); only the O(N^2) objects are sharded.
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
from jax.scipy.linalg import solve_triangular
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from gaussian_processes_tpu.models.base import Kernel
from gaussian_processes_tpu.models.gp import _LOG_2PI, GPPosterior, build_kxx


def make_grid_mesh(n_devices: int | None = None, axes=("i", "j")) -> Mesh:
    """2-D mesh as square as possible over (the first n) devices."""
    import numpy as np

    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    n = len(devs)
    a = int(np.floor(np.sqrt(n)))
    while n % a:
        a -= 1
    return Mesh(np.asarray(devs[: n]).reshape(a, n // a), axes)


def fit_sharded(
    kernel: Kernel,
    x,
    y,
    noise,
    mesh: Mesh,
    jitter: float = 1e-6,
    axes: Tuple[str, str] = ("i", "j"),
) -> GPPosterior:
    """Exact GP fit with K and L block-sharded over ``mesh``.

    Matches ``models.gp.fit`` numerically; the only difference is layout:
    K is constrained to P(i, j) so the kernel build runs fully parallel
    (each device computes its own block from the replicated x) and the
    factorization proceeds with XLA collectives instead of a gather to
    one device.
    """
    repl = NamedSharding(mesh, P())
    x = jax.device_put(jnp.asarray(x), repl)
    y = jax.device_put(jnp.asarray(y), repl)
    noise = jnp.asarray(noise)
    L, alpha, lml = _fit_jit(kernel, x, y, noise, jitter, mesh, tuple(axes))
    return GPPosterior(
        kernel=kernel, x=x, y=y, noise=noise, L=L, alpha=alpha, log_marginal=lml
    )


@partial(jax.jit, static_argnames=("jitter", "mesh", "axes"))
def _fit_jit(kernel, x, y, noise, jitter, mesh, axes):
    # module-level jit keyed on (mesh, axes, jitter): repeated fits reuse
    # the compiled distributed program instead of retracing per call
    grid = NamedSharding(mesh, P(*axes))
    K = build_kxx(kernel, x, noise, jitter)
    K = jax.lax.with_sharding_constraint(K, grid)
    L = jnp.linalg.cholesky(K)
    L = jax.lax.with_sharding_constraint(L, grid)
    alpha = solve_triangular(
        L.T, solve_triangular(L, y, lower=True), lower=False
    )
    n = x.shape[0]
    lml = (
        -0.5 * jnp.dot(y, alpha)
        - jnp.sum(jnp.log(jnp.diagonal(L)))
        - 0.5 * n * _LOG_2PI
    )
    return L, alpha, lml


@partial(jax.jit, static_argnames=("mesh", "axes"))
def _predict_jit(post, xo, mesh, axes):
    rows = NamedSharding(mesh, P(axes[0], None))
    Kxox = post.kernel(xo, post.x)
    Kxox = jax.lax.with_sharding_constraint(Kxox, rows)
    mean = Kxox @ post.alpha
    v = solve_triangular(post.L, Kxox.T, lower=True)
    var = post.kernel.kdiag(xo) - jnp.sum(v * v, axis=0)
    return mean, var


def predict_diag_sharded(post: GPPosterior, xo, mesh: Mesh, axes=("i", "j")):
    """Predictive mean/variance with the (m, n) cross-covariance sharded.

    Row-shards K_xo,x over the first mesh axis so the two triangular
    solves and the reductions stay distributed; output is replicated.
    """
    return _predict_jit(post, jnp.asarray(xo), mesh, tuple(axes))
