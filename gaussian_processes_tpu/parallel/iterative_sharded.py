"""Row-sharded matrix-free GP inference over a device mesh.

The multi-device extension of ``models/iterative_gp.py`` (SURVEY.md §6.7c
taken past the dense block-cyclic path): the n training rows are sharded
over a 1-D mesh, every device builds only its (n/D, block) kernel strips
on the fly, and the whole preconditioned-CG + SLQ machinery runs INSIDE
one ``shard_map`` with three collective touchpoints:

* ``all_gather`` of the (n, r) Krylov vectors before each rectangular
  strip matvec K(x_local, x) @ v  — the only O(n·r) communication;
* ``psum`` of every column-sum in the CG recurrence, the Woodbury
  capacitance contractions L^T L / L^T v, and the SLQ probe norms
  (wired through the ``allreduce`` hooks in ``ops/krylov.py``);
* a pmax/psum pivot broadcast per step of the distributed pivoted
  Cholesky preconditioner build.

Because the hooks reduce EXACTLY the quantities the single-device code
sums locally, the sharded recurrence is the same algorithm — device
count only changes floating-point reduction order.  The parity test
(tests/test_iterative_sharded.py) checks alpha/lml against
``fit_iterative`` with identical probes on the 8-device CPU mesh.

Memory per device is O(n·block/D + n·rank/D): with D devices, config
#4's N=65536 preconditioned fit shards both the matvec FLOPs and the
preconditioner storage D ways.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from gaussian_processes_tpu.models.base import Kernel
from gaussian_processes_tpu.models.gp import _LOG_2PI
from gaussian_processes_tpu.models.iterative_gp import IterativePosterior
from gaussian_processes_tpu.ops import krylov


def make_row_mesh(n_devices: int | None = None, axis: str = "i") -> Mesh:
    """1-D mesh over (the first n) local devices for row sharding."""
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), (axis,))


def _sharded_matvec(kernel, x_full, x_loc, noise, jitter, block_size, axis):
    """v_local (n/D, r) -> (K + (s^2+jitter) I) v, row shard, one all_gather."""
    diag = jnp.square(noise) + jitter

    def mv(v_loc):
        v_full = lax.all_gather(v_loc, axis, tiled=True)  # (n, r)
        out = krylov.kernel_matvec(
            kernel, x_full, v_full, noise, jitter,
            block_size=block_size, x_rows=x_loc,
        )
        return out + diag * v_loc

    return mv


def _pivoted_cholesky_sharded(
    kernel: Kernel, x_loc, rank: int, axis: str, jitter: float = 1e-6
):
    """Row-sharded greedy pivoted Cholesky: L_local (n/D, rank).

    Same recurrence as ``ops.krylov.pivoted_cholesky`` — each step picks
    the global residual-diagonal argmax (pmax + lowest-device tiebreak),
    broadcasts the pivot input point and the pivot row of L (psum of a
    one-hot-owned slice), and updates only local rows.  The over-rank
    freeze floor is computed from the GLOBAL leading diagonal.
    """
    n_loc = x_loc.shape[0]
    dtype = x_loc.dtype if jnp.issubdtype(x_loc.dtype, jnp.floating) else jnp.float32
    idx_dev = lax.axis_index(axis)

    d0 = kernel.kdiag(x_loc).astype(dtype)  # (n/D,)
    L0 = jnp.zeros((n_loc, rank), dtype)
    # 1e3*eps, matching ops/krylov.py::pivoted_cholesky: the 10*eps
    # floor was measured to admit ~100 junk clamped-pivot columns on
    # accelerator f32 at n~1e5 (poisoned Woodbury preconditioner, CG 0.65 vs
    # 6e-4) — the sharded copy must freeze at the same rank or sharded
    # and unsharded results diverge
    floor = lax.pmax(jnp.max(d0), axis) * jnp.asarray(
        1e3 * jnp.finfo(dtype).eps, dtype
    )

    def body(j, carry):
        L, d = carry
        am = jnp.argmax(d)
        m = d[am]
        d_piv = lax.pmax(m, axis)
        # lowest device index among maxima owns the pivot (ties are rare
        # but must resolve identically everywhere)
        big = jnp.asarray(1 << 30, jnp.int32)
        owner = lax.pmin(jnp.where(m >= d_piv, idx_dev, big), axis)
        is_owner = (idx_dev == owner).astype(dtype)
        xp = lax.psum(
            is_owner * lax.dynamic_index_in_dim(x_loc, am, 0, keepdims=True),
            axis,
        )  # (1,) or (1, D_in)
        lp = lax.psum(is_owner * L[am], axis)  # (rank,)
        c = kernel(x_loc, xp)[:, 0].astype(dtype)  # local rows of K[:, piv]
        l = (c - jnp.dot(L, lp, precision=lax.Precision.HIGHEST)) / jnp.sqrt(
            jnp.maximum(d_piv, jitter)
        )
        l = jnp.where(d_piv > floor, l, jnp.zeros_like(l))
        L = L.at[:, j].set(l)
        d = jnp.maximum(d - l * l, 0.0)
        return (L, d)

    L, _ = lax.fori_loop(0, rank, body, (L0, d0))
    return L


def fit_iterative_sharded(
    kernel: Kernel,
    x,
    y,
    noise,
    key: jax.Array | None = None,
    *,
    mesh: Mesh | None = None,
    axis: str = "i",
    num_probes: int = 16,
    num_iters: int = 100,
    tol: float = 1e-8,
    jitter: float = 0.0,
    block_size: int = 1024,
    precond_rank: int = 0,
) -> IterativePosterior:
    """Matrix-free exact-GP fit with rows sharded over ``mesh``.

    Same estimator as ``models.iterative_gp.fit_iterative`` (identical
    probes given the same key); n must divide evenly by the mesh size.
    Returns an ``IterativePosterior`` whose ``alpha`` is the global
    (n,) solution, row-sharded over the mesh.
    """
    if mesh is None:
        mesh = make_row_mesh(axis=axis)
    n_dev = mesh.shape[axis]
    x = jnp.asarray(x)
    y = jnp.asarray(y)
    noise = jnp.asarray(noise)
    if key is None:
        key = jax.random.key(0)
    n = x.shape[0]
    if n % n_dev != 0:
        raise ValueError(f"mesh size ({n_dev}) must evenly divide n ({n})")
    dtype = y.dtype

    red = lambda a: lax.psum(a, axis)  # noqa: E731

    if precond_rank > 0:
        # mirror fit_iterative's key plumbing so probes match bit-for-bit:
        # probe_key -> (k1, k2), z = L xi1 + sigma xi2
        probe_key, _ = jax.random.split(key)
        k1, k2 = jax.random.split(probe_key)
        xi1 = jax.random.normal(k1, (precond_rank, num_probes), dtype)
        xi2 = jax.random.normal(k2, (n, num_probes), dtype)

        def local(x_full, x_loc, y_loc, xi1, xi2_loc):
            mv = _sharded_matvec(
                kernel, x_full, x_loc, noise, jitter, block_size, axis
            )
            sigma2 = jnp.square(noise) + jitter
            L = _pivoted_cholesky_sharded(kernel, x_loc, precond_rank, axis)
            pre = krylov.woodbury_inverse_apply(L, sigma2, allreduce=red)
            sol, rn = krylov.pcg(
                mv, pre, y_loc[:, None], num_iters=num_iters, tol=tol,
                allreduce=red,
            )
            # damped shift, consistent with apply/logdet (see krylov.
            # effective_precond_shift)
            shift_eff = krylov.effective_precond_shift(
                L, sigma2, allreduce=red
            )
            probes_loc = (
                jnp.dot(L, xi1, precision=lax.Precision.HIGHEST)
                + jnp.sqrt(shift_eff) * xi2_loc
            )
            logdet = krylov.slq_logdet_preconditioned(
                mv, L, sigma2, None, num_probes, num_iters, n,
                probes=probes_loc, allreduce=red,
            )
            alpha = sol[:, 0]
            lml = (
                -0.5 * red(jnp.dot(y_loc, alpha))
                - 0.5 * logdet
                - 0.5 * n * _LOG_2PI
            )
            return alpha, lml, rn[0]

        fn = jax.jit(
            jax.shard_map(
                local,
                mesh=mesh,
                in_specs=(P(), P(axis), P(axis), P(), P(axis)),
                out_specs=(P(axis), P(), P()),
                check_vma=False,
            )
        )
        alpha, lml, residual = fn(x, x, y, xi1, xi2)
    else:
        probes = jax.random.rademacher(key, (n, num_probes), dtype=dtype)

        def local(x_full, x_loc, y_loc, probes_loc):
            mv = _sharded_matvec(
                kernel, x_full, x_loc, noise, jitter, block_size, axis
            )
            rhs = jnp.concatenate([y_loc[:, None], probes_loc], axis=1)
            res = krylov.mbcg(mv, rhs, num_iters=num_iters, tol=tol,
                              allreduce=red)
            alpha = res.solution[:, 0]
            probe_norms = jnp.full((num_probes,), float(n), dtype)
            logdet = krylov.slq_logdet_from_cg(
                res.alphas[:, 1:], res.betas[:, 1:], probe_norms, n
            )
            lml = (
                -0.5 * red(jnp.dot(y_loc, alpha))
                - 0.5 * logdet
                - 0.5 * n * _LOG_2PI
            )
            return alpha, lml, res.residual_norm[0]

        fn = jax.jit(
            jax.shard_map(
                local,
                mesh=mesh,
                in_specs=(P(), P(axis), P(axis), P(axis)),
                out_specs=(P(axis), P(), P()),
                check_vma=False,
            )
        )
        alpha, lml, residual = fn(x, x, y, probes)

    return IterativePosterior(
        kernel=kernel,
        x=x,
        y=y,
        noise=noise,
        alpha=alpha,
        log_marginal=lml,
        solve_residual=residual,
        num_probes=jnp.asarray(num_probes),
        num_iters=jnp.asarray(num_iters),
    )


def log_marginal_value_and_grad_iterative_sharded(
    kernel: Kernel,
    x,
    y,
    noise,
    key: jax.Array | None = None,
    *,
    mesh: Mesh | None = None,
    axis: str = "i",
    num_probes: int = 16,
    num_iters: int = 100,
    tol: float = 1e-8,
    jitter: float = 0.0,
    block_size: int = 1024,
    precond_rank: int = 0,
):
    """Row-sharded (lml, d lml/d theta), theta = (kernel params..., s).

    Same stochastic estimator as
    ``models.iterative_gp.log_marginal_value_and_grad_iterative`` with
    identical probes for a given key; the Hutchinson trace contraction
    runs on each device's (P, n/D, block) Jacobian strips and is psum'd.
    Outputs are replicated scalars/(P+1,) — ready for a host optimizer.
    """
    if mesh is None:
        mesh = make_row_mesh(axis=axis)
    x = jnp.asarray(x)
    y = jnp.asarray(y)
    noise = jnp.asarray(noise)
    if key is None:
        key = jax.random.key(0)
    n = x.shape[0]
    dtype = y.dtype
    fn = _build_vg_sharded(
        kernel, mesh, axis,
        num_probes=num_probes, num_iters=num_iters, tol=tol, jitter=jitter,
        block_size=block_size, precond_rank=precond_rank, n=n, dtype=dtype,
    )
    probes, xi1, xi2 = _draw_vg_probes(key, n, num_probes, precond_rank, dtype)
    return fn(x, x, y, probes, xi1, xi2, kernel.params, noise)


def _draw_vg_probes(key, n, num_probes, precond_rank, dtype):
    """Host-side probe draws, bit-matching the unsharded key plumbing."""
    probes = jax.random.rademacher(key, (n, num_probes), dtype=dtype)
    if precond_rank > 0:
        # mirror the unsharded path: probe_key -> sample_precond_probes
        probe_key, _ = jax.random.split(key)
        k1, k2 = jax.random.split(probe_key)
        xi1 = jax.random.normal(k1, (precond_rank, num_probes), dtype)
        xi2 = jax.random.normal(k2, (n, num_probes), dtype)
    else:
        xi1 = jnp.zeros((0, num_probes), dtype)
        xi2 = jnp.zeros((n, num_probes), dtype)
    return probes, xi1, xi2


def _vg_local(
    kernel, x_full, x_loc, y_loc, probes_loc, xi1, xi2_loc, noise, axis, *,
    num_probes, num_iters, tol, jitter, block_size, precond_rank,
):
    """Per-device body of the sharded (lml, d lml/d theta) estimator.

    Runs INSIDE a ``shard_map`` over ``axis`` with the data rows, probe
    rows, and ``xi2`` rows sharded; returns the replicated (lml, grad)
    with grad = (d/d kernel params..., d/d s).  Shared by the jit-once MLE
    builder below and the data-sharded Bayesian log posterior
    (parallel/bayes_sharded.py).
    """
    n = x_full.shape[0]
    dtype = y_loc.dtype
    P_k = kernel.n_params
    red = lambda a: lax.psum(a, axis)  # noqa: E731
    mv = _sharded_matvec(
        kernel, x_full, x_loc, noise, jitter, block_size, axis
    )
    rhs = jnp.concatenate([y_loc[:, None], probes_loc], axis=1)
    if precond_rank > 0:
        sigma2 = jnp.square(noise) + jitter
        L = _pivoted_cholesky_sharded(kernel, x_loc, precond_rank, axis)
        pre = krylov.woodbury_inverse_apply(L, sigma2, allreduce=red)
        sol, _ = krylov.pcg(
            mv, pre, rhs, num_iters=num_iters, tol=tol, allreduce=red
        )
        alpha_loc = sol[:, 0]
        Kinv_z_loc = sol[:, 1:]
        # same DAMPED shift as the apply/logdet (krylov.
        # effective_precond_shift) — P must be one consistent matrix
        # across probes, apply, and correction for the SLQ identity
        shift_eff = krylov.effective_precond_shift(L, sigma2, allreduce=red)
        slq_probes = (
            jnp.dot(L, xi1, precision=lax.Precision.HIGHEST)
            + jnp.sqrt(shift_eff) * xi2_loc
        )
        logdet = krylov.slq_logdet_preconditioned(
            mv, L, sigma2, None, num_probes, num_iters, n,
            probes=slq_probes, allreduce=red,
        )
    else:
        res = krylov.mbcg(mv, rhs, num_iters=num_iters, tol=tol,
                          allreduce=red)
        alpha_loc = res.solution[:, 0]
        Kinv_z_loc = res.solution[:, 1:]
        probe_norms = jnp.full((num_probes,), float(n), dtype)
        logdet = krylov.slq_logdet_from_cg(
            res.alphas[:, 1:], res.betas[:, 1:], probe_norms, n
        )
    lml = (
        -0.5 * red(jnp.dot(y_loc, alpha_loc))
        - 0.5 * logdet
        - 0.5 * n * _LOG_2PI
    )

    # Hutchinson gradient: scan column blocks of the FULL x against
    # this device's Jacobian row strips J_p(x_loc, block)
    alpha_full = lax.all_gather(alpha_loc, axis, tiled=True)
    probes_full = lax.all_gather(probes_loc, axis, tiled=True)
    b = min(block_size, n)
    nb = -(-n // b)
    n_pad = nb * b
    x_pad = krylov._pad_to(x_full, n_pad).reshape(nb, b, *x_full.shape[1:])
    a_pad = krylov._pad_to(alpha_full[:, None], n_pad).reshape(nb, b, 1)
    z_pad = krylov._pad_to(probes_full, n_pad).reshape(nb, b, num_probes)

    def step(acc, xv):
        xj, aj, zj = xv
        Jj = kernel.jacobian(x_loc, xj)  # (P, n/D, b)
        with jax.default_matmul_precision("highest"):
            Ja = acc[0] + jnp.einsum("pnb,b->pn", Jj, aj[:, 0])
            Jz = acc[1] + jnp.einsum("pnb,br->pnr", Jj, zj)
        return (Ja, Jz), None

    n_loc = x_loc.shape[0]
    Ja0 = jnp.zeros((P_k, n_loc), dtype)
    Jz0 = jnp.zeros((P_k, n_loc, num_probes), dtype)
    (J_alpha, J_z), _ = lax.scan(step, (Ja0, Jz0), (x_pad, a_pad, z_pad))

    quad = red(jnp.einsum("n,pn->p", alpha_loc, J_alpha))
    trace_est = jnp.mean(
        red(jnp.einsum("nr,pnr->pr", Kinv_z_loc, J_z)), axis=-1
    )
    grad_kernel = 0.5 * (quad - trace_est)
    two_s = 2.0 * noise
    quad_s = two_s * red(jnp.dot(alpha_loc, alpha_loc))
    trace_s = two_s * jnp.mean(red(jnp.sum(Kinv_z_loc * probes_loc, axis=0)))
    grad_s = 0.5 * (quad_s - trace_s)
    return lml, jnp.concatenate([grad_kernel, grad_s[None]])


def _build_vg_sharded(
    kernel_template, mesh, axis, *,
    num_probes, num_iters, tol, jitter, block_size, precond_rank, n, dtype,
):
    """Jit-once builder for the sharded (value, grad): kernel params and
    noise are traced ARGUMENTS (not closure constants), so an optimizer
    loop reuses one executable across steps."""
    n_dev = mesh.shape[axis]
    if n % n_dev != 0:
        raise ValueError(f"mesh size ({n_dev}) must evenly divide n ({n})")

    def local(x_full, x_loc, y_loc, probes_loc, xi1, xi2_loc, theta, noise):
        kernel = kernel_template.with_params(theta)
        return _vg_local(
            kernel, x_full, x_loc, y_loc, probes_loc, xi1, xi2_loc, noise,
            axis, num_probes=num_probes, num_iters=num_iters, tol=tol,
            jitter=jitter, block_size=block_size, precond_rank=precond_rank,
        )

    return jax.jit(
        jax.shard_map(
            local,
            mesh=mesh,
            in_specs=(P(), P(axis), P(axis), P(axis), P(), P(axis), P(), P()),
            out_specs=(P(), P()),
            check_vma=False,
        )
    )


def fit_mle_iterative_sharded(
    kernel: Kernel,
    x,
    y,
    noise_init,
    key: jax.Array | None = None,
    *,
    mesh: Mesh | None = None,
    axis: str = "i",
    num_steps: int = 50,
    learning_rate: float = 0.05,
    num_probes: int = 16,
    num_iters: int = 100,
    tol: float = 1e-6,
    jitter: float = 0.0,
    block_size: int = 1024,
    precond_rank: int = 0,
):
    """Matrix-free type-II MLE with every (value, grad) evaluation
    row-sharded over the mesh — Adam in log-space on the host, exactly
    like ``models.iterative_gp.fit_mle_iterative``.

    Returns (kernel, noise, last_lml_estimate, lml_trace).
    """
    import optax

    if mesh is None:
        mesh = make_row_mesh(axis=axis)
    if key is None:
        key = jax.random.key(0)
    x = jnp.asarray(x)
    y = jnp.asarray(y)
    u = jnp.log(
        jnp.concatenate([kernel.params, jnp.asarray(noise_init)[None]])
    )
    n = x.shape[0]
    dtype = y.dtype
    P_k = kernel.n_params
    vg = _build_vg_sharded(  # one executable for all steps
        kernel, mesh, axis,
        num_probes=num_probes, num_iters=num_iters, tol=tol, jitter=jitter,
        block_size=block_size, precond_rank=precond_rank, n=n, dtype=dtype,
    )
    opt = optax.adam(learning_rate)
    opt_state = opt.init(u)

    lmls = []
    for _ in range(num_steps):
        key, sub = jax.random.split(key)
        theta = jnp.exp(u)
        probes, xi1, xi2 = _draw_vg_probes(
            sub, n, num_probes, precond_rank, dtype
        )
        lml, g_theta = vg(x, x, y, probes, xi1, xi2, theta[:P_k], theta[P_k])
        g_u = -g_theta * theta
        updates, opt_state = opt.update(g_u, opt_state, u)
        u = optax.apply_updates(u, updates)
        lmls.append(float(lml))
    theta = jnp.exp(u)
    return kernel.with_params(theta[:P_k]), theta[P_k], lmls[-1], lmls


def predict_mean_iterative_sharded(
    post: IterativePosterior,
    xo,
    *,
    mesh: Mesh | None = None,
    axis: str = "i",
    block_size: int = 1024,
) -> jax.Array:
    """Predictive mean with test rows sharded: K(xo_loc, x) @ alpha.

    ``xo`` is padded up to a mesh-size multiple on the host (padded rows
    compute against real training data and are dropped), so any m works.
    """
    if mesh is None:
        mesh = make_row_mesh(axis=axis)
    n_dev = mesh.shape[axis]
    xo = jnp.asarray(xo)
    m = xo.shape[0]
    m_pad = -(-m // n_dev) * n_dev
    xo_pad = krylov._pad_to(xo, m_pad)

    def local(x_full, alpha_loc, xo_loc):
        alpha = lax.all_gather(alpha_loc, axis, tiled=True)
        out = krylov.kernel_matvec(
            post.kernel, x_full, alpha, post.noise, 0.0,
            block_size=block_size, x_rows=xo_loc,
        )
        return out

    fn = jax.jit(
        jax.shard_map(
            local,
            mesh=mesh,
            in_specs=(P(), P(axis), P(axis)),
            out_specs=P(axis),
            check_vma=False,
        )
    )
    return fn(post.x, post.alpha, xo_pad)[:m]
