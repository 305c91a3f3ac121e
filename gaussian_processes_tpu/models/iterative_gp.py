"""Matrix-free exact-GP inference: CG solves + SLQ log marginal.

The beyond-dense large-N path (SURVEY.md §6.7 carried past the dense
wall): nothing here ever stores an N x N array, so one device's memory
ceiling moves from the dense K + factor to N limited only by O(N * block)
workspace.  All compute is elementwise kernel-strip generation +
matmuls, or on the GPU the fused Pallas matvec (ops/pairwise.py).

    fit_iterative(kernel, x, y, noise) -> IterativePosterior
        alpha = K^-1 y          by batched CG (kernel_matvec)
        log_marginal            = -1/2 y^T alpha - 1/2 SLQ-logdet - n/2 log 2pi
    predict_mean / predict_diag  by more matvecs and CG solves

Accuracy model (tested in tests/test_iterative.py against the dense
Cholesky): alpha/mean converge to CG tolerance (tight); the SLQ logdet
is a stochastic estimate with O(1/sqrt(num_probes)) Monte-Carlo error —
fine for MLE/NUTS (gradients see the same probes) and reported alongside
its probe count.  Derivatives of the log marginal likelihood use the
stochastic trace identity  tr(K^-1 dK) ~ mean_z[(K^-1 z)^T dK z]  with
the same probes, so hyperparameter optimization at matrix-free scale
needs only matvecs too.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp

from gaussian_processes_tpu.models.base import Kernel
from gaussian_processes_tpu.models.gp import _LOG_2PI
from gaussian_processes_tpu.ops import krylov


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class IterativePosterior:
    kernel: Kernel
    x: jax.Array
    y: jax.Array
    noise: jax.Array
    alpha: jax.Array  # K^-1 y by CG
    log_marginal: jax.Array  # SLQ estimate
    solve_residual: jax.Array  # final relative CG residual of the y solve
    num_probes: jax.Array
    num_iters: jax.Array


def _is_ski(structure) -> bool:
    from gaussian_processes_tpu.ops import ski as ski_ops

    return isinstance(structure, ski_ops.SKIOperator)


def _is_kron(structure) -> bool:
    from gaussian_processes_tpu.ops import kronecker

    return isinstance(structure, kronecker.KronOperator)


def _is_ski_kron(structure) -> bool:
    from gaussian_processes_tpu.ops import ski as ski_ops

    return isinstance(structure, ski_ops.SKIKronOperator)


def _matvec(kernel, x, noise, jitter, block_size, structure="none",
            impl="auto"):
    if _is_ski_kron(structure):
        # scattered (n, D) inputs through a Kronecker inducing grid
        # (D-dim KISS-GP): W ((x)_d T_d) W^T + s^2 I per matvec
        from gaussian_processes_tpu.ops import kronecker
        from gaussian_processes_tpu.ops import ski as ski_ops

        cols = kronecker.kron_columns(kernel, structure.kron)
        shift = jnp.square(jnp.asarray(noise)) + jitter

        def mv(v):
            return ski_ops.ski_kron_matvec(structure, cols, v, shift)

        return mv
    if _is_kron(structure):
        # D-dim Cartesian grid, separable kernel: K = (x)_d T_d — D
        # batched FFT sweeps per matvec (ops/kronecker.py)
        from gaussian_processes_tpu.ops import kronecker

        cols = kronecker.kron_columns(kernel, structure)
        shift = jnp.square(jnp.asarray(noise)) + jitter

        def mv(v):
            return kronecker.kron_matvec(cols, v, shift)

        return mv
    if _is_ski(structure):
        # scattered inputs through an inducing grid (SKI / KISS-GP):
        # (W T W^T + s^2 I) v = O(n) gather/scatter + O(m log m) FFT
        # (ops/ski.py; build the operator with ski.interpolation_weights)
        from gaussian_processes_tpu.ops import ski as ski_ops
        from gaussian_processes_tpu.ops import toeplitz

        col = toeplitz.toeplitz_column(kernel, structure.grid)
        shift = jnp.square(jnp.asarray(noise)) + jitter

        def mv(v):
            return ski_ops.ski_matvec(structure, col, v, shift)

        return mv
    if structure == "toeplitz":
        # uniform-grid inputs: K is symmetric Toeplitz — O(n log n) FFT
        # matvec instead of the O(n^2) strip (ops/toeplitz.py; caller
        # asserts the grid with toeplitz.is_uniform_grid)
        from gaussian_processes_tpu.ops import toeplitz

        col = toeplitz.toeplitz_column(kernel, x)
        shift = jnp.square(jnp.asarray(noise)) + jitter

        def mv(v):
            return toeplitz.toeplitz_matvec(col, v, shift)

        return mv
    if structure != "none":
        raise ValueError(f"unknown structure: {structure!r}")

    def mv(v):
        return krylov.kernel_matvec(
            kernel, x, v, noise, jitter, block_size=block_size, impl=impl
        )

    return mv


def fit_iterative(
    kernel: Kernel,
    x,
    y,
    noise,
    key: jax.Array | None = None,
    *,
    num_probes: int = 16,
    num_iters: int = 100,
    tol: float = 1e-8,
    jitter: float = 0.0,
    block_size: int = 1024,
    precond_rank: int = 0,
    structure: str = "none",
    replace_every: int = 25,
    precond_L: jax.Array | None = None,
) -> IterativePosterior:
    """Matrix-free exact-GP fit; memory O(n * max(block_size, precond_rank)).

    ``precond_rank > 0`` solves alpha with pivoted-Cholesky-preconditioned
    CG (breaks the f32 conditioning stall at large N; the SLQ logdet
    keeps the plain-CG probes so its quadrature identity holds).

    ``structure="toeplitz"`` (uniform-grid x only — assert with
    ``ops.toeplitz.is_uniform_grid``): every matvec becomes an
    O(n log n) FFT product.  With ``precond_rank == 0`` the alpha solve
    additionally uses the (free) Strang circulant preconditioner; pass
    ``precond_rank > 0`` to keep the pivoted-Cholesky preconditioner and
    its preconditioned SLQ log-marginal at hard conditioning.

    ``structure=ops.ski.SKIOperator`` (from ``ski.interpolation_weights``):
    SKI/KISS-GP for *scattered* inputs — matvecs are O(n + m log m)
    products through the inducing grid; the target is the SKI surrogate
    K_ski = W K_g W^T (converges to K as the grid refines).

    ``structure=ops.kronecker.KronOperator`` (D-dim Cartesian grid,
    separable kernel e.g. ARDGaussianKernel): K = (x)_d T_d, matvecs are
    D batched FFT sweeps, with the Kronecker-circulant preconditioner and
    exact-logdet(P) SLQ — exact GP inference (not a surrogate) at
    N = prod(n_d) ~ 1e6 on one device.

    ``replace_every``: residual-replacement cadence for the alpha PCG
    solve (ops/krylov.py pcg).  In f32 the CG recurrence residual drifts
    from the true one over long solves — at n >= 65536 the round-2 code
    stalled at ~1e-2 where f64 reached 4e-11 (VERDICT r2 item 5);
    periodic true-residual restarts remove the stall for one extra
    matvec per ``replace_every`` iterations.  0 disables.
    """
    x = jnp.asarray(x)
    y = jnp.asarray(y)
    noise = jnp.asarray(noise)
    if key is None:
        key = jax.random.key(0)
    n = x.shape[0]
    dtype = y.dtype

    mv = _matvec(kernel, x, noise, jitter, block_size, structure)
    if precond_rank > 0:
        # preconditioned path: PCG for alpha, preconditioned SLQ for the
        # logdet (probes ~ N(0, P), exact logdet(P) correction) — both
        # stay accurate at conditioning where plain f32 CG stalls
        probe_key, solve_key = jax.random.split(key)
        # precond_L: caller-supplied pivoted-Cholesky factor (e.g. to
        # share one factor between fit and ski_kron_refine — round 4)
        L = (precond_L if precond_L is not None
             else krylov.pivoted_cholesky(kernel, x, precond_rank))
        sigma2 = jnp.square(noise) + jitter
        pre = krylov.woodbury_inverse_apply(L, sigma2)
        alpha2, rn = krylov.pcg(mv, pre, y[:, None], num_iters=num_iters,
                                tol=tol, replace_every=replace_every)
        alpha = alpha2[:, 0]
        solve_residual = rn[0]
        logdet = krylov.slq_logdet_preconditioned(
            mv, L, sigma2, probe_key, num_probes, num_iters, n
        )
    elif structure == "toeplitz":
        # circulant-preconditioned path (free Strang preconditioner):
        # PCG for alpha, circulant-preconditioned SLQ for the logdet —
        # the grid analogue of the pivoted-Cholesky branch above
        from gaussian_processes_tpu.ops import toeplitz

        probe_key, _ = jax.random.split(key)
        col = toeplitz.toeplitz_column(kernel, x)
        shift = jnp.square(noise) + jitter
        pre = toeplitz.strang_circulant_precond(col, shift)
        sol, rn = krylov.pcg(
            mv, pre, y[:, None], num_iters=num_iters, tol=tol,
            replace_every=replace_every,
        )
        alpha = sol[:, 0]
        solve_residual = rn[0]
        logdet = toeplitz.slq_logdet_circulant(
            mv, col, shift, probe_key, num_probes, num_iters
        )
    elif _is_kron(structure):
        # D-dim grid analogue of the branch above: Kronecker-Strang
        # circulant preconditioner (free) + exact-logdet(P) SLQ
        from gaussian_processes_tpu.ops import kronecker

        probe_key, _ = jax.random.split(key)
        cols = kronecker.kron_columns(kernel, structure)
        shift = jnp.square(noise) + jitter
        pre = kronecker.kron_circulant_precond(cols, shift)
        sol, rn = krylov.pcg(
            mv, pre, y[:, None], num_iters=num_iters, tol=tol,
            replace_every=replace_every,
        )
        alpha = sol[:, 0]
        solve_residual = rn[0]
        logdet = kronecker.slq_logdet_kron_circulant(
            mv, cols, shift, probe_key, num_probes, num_iters
        )
    else:
        probes = jax.random.rademacher(key, (n, num_probes), dtype=dtype)
        rhs = jnp.concatenate([y[:, None], probes], axis=1)
        res = krylov.mbcg(mv, rhs, num_iters=num_iters, tol=tol)
        alpha = res.solution[:, 0]
        solve_residual = res.residual_norm[0]
        probe_norms = jnp.full((num_probes,), float(n), dtype)
        logdet = krylov.slq_logdet_from_cg(
            res.alphas[:, 1:], res.betas[:, 1:], probe_norms, n
        )
    lml = -0.5 * jnp.dot(y, alpha) - 0.5 * logdet - 0.5 * n * _LOG_2PI
    return IterativePosterior(
        kernel=kernel,
        x=x,
        y=y,
        noise=noise,
        alpha=alpha,
        log_marginal=lml,
        solve_residual=solve_residual,
        num_probes=jnp.asarray(num_probes),
        num_iters=jnp.asarray(num_iters),
    )


def predict_mean_iterative(
    post: IterativePosterior, xo, block_size: int = 1024, structure="none"
):
    """Predictive mean: K(xo, x) @ alpha.

    Default: strip matvecs, O(n*m) flops / O(m*b) memory.  With a SKI
    ``structure`` (1-D or D-dim operator): the KISS-GP fast prediction —
    K(xo, x) ~= W_o K_g W^T, so the mean is one grid projection
    T_g (W^T alpha) (computed once per call) interpolated to the test
    points: O(n + m + g log g) total, constant per test point.
    """
    xo = jnp.asarray(xo)
    if _is_ski(structure):
        from gaussian_processes_tpu.ops import ski as ski_ops
        from gaussian_processes_tpu.ops import toeplitz

        col = toeplitz.toeplitz_column(post.kernel, structure.grid)
        grid_mean = toeplitz.toeplitz_matvec(
            col, ski_ops.interp_rmatvec(structure, post.alpha)
        )
        op_o = ski_ops.interpolation_weights(xo, structure.grid)
        return ski_ops.interp_matvec(op_o, grid_mean)
    if _is_ski_kron(structure):
        from gaussian_processes_tpu.ops import kronecker
        from gaussian_processes_tpu.ops import ski as ski_ops

        cols = kronecker.kron_columns(post.kernel, structure.kron)
        grid_mean = kronecker.kron_matvec(
            cols, ski_ops.interp_rmatvec_nd(structure, post.alpha)
        )
        op_o = ski_ops.interpolation_weights_nd(xo, structure.kron.axes)
        return ski_ops.interp_matvec_nd(op_o, grid_mean)
    m = xo.shape[0]
    b = min(block_size, m)
    nb = -(-m // b)
    xo_pad = krylov._pad_to(xo, nb * b).reshape(nb, b, *xo.shape[1:])

    def step(_, xj):
        with jax.default_matmul_precision("highest"):
            return None, post.kernel(xj, post.x) @ post.alpha

    _, chunks = jax.lax.scan(step, None, xo_pad)
    return chunks.reshape(-1)[:m]


def predict_diag_iterative(
    post: IterativePosterior,
    xo,
    *,
    num_iters: int = 100,
    tol: float = 1e-8,
    jitter: float = 0.0,
    block_size: int = 1024,
    precond_rank: int = 0,
    structure: str = "none",
) -> Tuple[jax.Array, jax.Array]:
    """Mean and per-point variance; one CG solve per test batch.

    var_i = k(xo_i, xo_i) - k_i^T K^-1 k_i with the m cross-covariance
    columns solved together by (optionally preconditioned) batched CG
    (memory O(n * m)).  ``structure="toeplitz"`` (uniform-grid training x)
    runs the solves with FFT matvecs.
    """
    xo = jnp.asarray(xo)
    with jax.default_matmul_precision("highest"):
        Kxxo = post.kernel(post.x, xo)  # (n, m)
        mv = _matvec(
            post.kernel, post.x, post.noise, jitter, block_size, structure
        )
        if precond_rank > 0:
            L = krylov.pivoted_cholesky(post.kernel, post.x, precond_rank)
            pre = krylov.woodbury_inverse_apply(
                L, jnp.square(post.noise) + jitter
            )
            sol, _ = krylov.pcg(mv, pre, Kxxo, num_iters=num_iters, tol=tol)
        elif structure == "toeplitz":
            from gaussian_processes_tpu.ops import toeplitz

            pre = toeplitz.strang_circulant_precond(
                toeplitz.toeplitz_column(post.kernel, post.x),
                jnp.square(post.noise) + jitter,
            )
            sol, _ = krylov.pcg(mv, pre, Kxxo, num_iters=num_iters, tol=tol)
        elif _is_kron(structure):
            from gaussian_processes_tpu.ops import kronecker

            pre = kronecker.kron_circulant_precond(
                kronecker.kron_columns(post.kernel, structure),
                jnp.square(post.noise) + jitter,
            )
            sol, _ = krylov.pcg(mv, pre, Kxxo, num_iters=num_iters, tol=tol)
        else:
            sol = krylov.mbcg(mv, Kxxo, num_iters=num_iters, tol=tol).solution
        mean = Kxxo.T @ post.alpha
        var = post.kernel.kdiag(xo) - jnp.sum(Kxxo * sol, axis=0)
    return mean, var


def fit_mle_iterative(
    kernel: Kernel,
    x,
    y,
    noise_init,
    key: jax.Array | None = None,
    *,
    num_steps: int = 50,
    learning_rate: float = 0.05,
    num_probes: int = 16,
    num_iters: int = 100,
    tol: float = 1e-6,
    jitter: float = 0.0,
    block_size: int = 1024,
    structure: str = "none",
):
    """Type-II MLE at matrix-free scale: Adam on the stochastic
    (value, grad) pairs from ``log_marginal_value_and_grad_iterative``.

    Fresh probes each step act as minibatch noise; Adam averages through
    it.  Returns (kernel, noise, last_lml_estimate, lml_trace).
    ``structure="toeplitz"`` makes every step O(n log n) on grids.
    """
    import optax

    if key is None:
        key = jax.random.key(0)
    x = jnp.asarray(x)
    y = jnp.asarray(y)
    u0 = jnp.log(
        jnp.concatenate([kernel.params, jnp.asarray(noise_init)[None]])
    )
    opt = optax.adam(learning_rate)
    P = kernel.n_params

    @jax.jit
    def step(u, opt_state, k):
        theta = jnp.exp(u)
        kern = kernel.with_params(theta[:P])
        lml, g_theta = log_marginal_value_and_grad_iterative(
            kern, x, y, theta[P], k,
            num_probes=num_probes, num_iters=num_iters, tol=tol,
            jitter=jitter, block_size=block_size, structure=structure,
        )
        g_u = -g_theta * theta  # d(-lml)/du via chain rule through exp
        updates, opt_state = opt.update(g_u, opt_state, u)
        return optax.apply_updates(u, updates), opt_state, lml

    opt_state = opt.init(u0)
    u = u0
    lmls = []
    for i in range(num_steps):
        key, sub = jax.random.split(key)
        u, opt_state, lml = step(u, opt_state, sub)
        lmls.append(float(lml))
    theta = jnp.exp(u)
    return kernel.with_params(theta[:P]), theta[P], lmls[-1], lmls


def log_marginal_value_and_grad_iterative(
    kernel: Kernel,
    x,
    y,
    noise,
    key: jax.Array | None = None,
    *,
    num_probes: int = 16,
    num_iters: int = 100,
    tol: float = 1e-8,
    jitter: float = 0.0,
    block_size: int = 1024,
    precond_rank: int = 0,
    early_exit: bool = False,
    structure: str = "none",
    impl: str = "auto",
):
    """(lml_estimate, d lml / d theta) matrix-free, theta = (kernel..., s).

    grad_p = 1/2 alpha^T K_p alpha - 1/2 E_z[(K^-1 z)^T K_p z], with the
    Hutchinson expectation over the same Rademacher probes used for the
    logdet, and K_p v computed by strip matvecs of the kernel Jacobian.
    With ``precond_rank > 0``, all solves run preconditioned CG and the
    logdet uses the preconditioned-SLQ estimator (large-N f32 regime).

    ``structure="toeplitz"`` (uniform-grid x): the solve matvecs AND the
    Jacobian contractions K_p v become O(n log n) FFT products — dK/dtheta
    of a stationary kernel is stationary, so each J_p is Toeplitz too.

    ``impl`` (unstructured path): ``"auto"`` takes the fused Pallas
    matvec and Jacobian-matvec where ``ops/pairwise.py``'s defaults say
    they win, ``"strip"`` keeps both on the XLA strip scan.
    """
    if impl not in ("auto", "strip"):
        raise ValueError(f"impl must be 'auto' or 'strip', not {impl!r}")
    x = jnp.asarray(x)
    y = jnp.asarray(y)
    noise = jnp.asarray(noise)
    if key is None:
        key = jax.random.key(0)
    n = x.shape[0]
    dtype = y.dtype
    P = kernel.n_params

    probes = jax.random.rademacher(key, (n, num_probes), dtype=dtype)
    rhs = jnp.concatenate([y[:, None], probes], axis=1)
    mv = _matvec(kernel, x, noise, jitter, block_size, structure, impl)
    if precond_rank > 0:
        probe_key, _ = jax.random.split(key)
        L = krylov.pivoted_cholesky(kernel, x, precond_rank)
        sigma2 = jnp.square(noise) + jitter
        pre = krylov.woodbury_inverse_apply(L, sigma2)
        sol, _ = krylov.pcg(mv, pre, rhs, num_iters=num_iters, tol=tol,
                            early_exit=early_exit)
        alpha = sol[:, 0]
        Kinv_z = sol[:, 1:]
        logdet = krylov.slq_logdet_preconditioned(
            mv, L, sigma2, probe_key, num_probes, num_iters, n
        )
    elif structure == "toeplitz":
        # circulant-preconditioned solves + SLQ (free preconditioner);
        # Hutchinson probes stay Rademacher — the trace identity only
        # needs E[z z^T] = I, independent of the preconditioner
        from gaussian_processes_tpu.ops import toeplitz

        probe_key, _ = jax.random.split(key)
        col = toeplitz.toeplitz_column(kernel, x)
        shift = jnp.square(noise) + jitter
        pre = toeplitz.strang_circulant_precond(col, shift)
        sol, _ = krylov.pcg(mv, pre, rhs, num_iters=num_iters, tol=tol,
                            early_exit=early_exit)
        alpha = sol[:, 0]
        Kinv_z = sol[:, 1:]
        logdet = toeplitz.slq_logdet_circulant(
            mv, col, shift, probe_key, num_probes, num_iters
        )
    elif _is_kron(structure):
        from gaussian_processes_tpu.ops import kronecker

        probe_key, _ = jax.random.split(key)
        cols = kronecker.kron_columns(kernel, structure)
        shift = jnp.square(noise) + jitter
        pre = kronecker.kron_circulant_precond(cols, shift)
        sol, _ = krylov.pcg(mv, pre, rhs, num_iters=num_iters, tol=tol,
                            early_exit=early_exit)
        alpha = sol[:, 0]
        Kinv_z = sol[:, 1:]
        logdet = kronecker.slq_logdet_kron_circulant(
            mv, cols, shift, probe_key, num_probes, num_iters
        )
    else:
        res = krylov.mbcg(mv, rhs, num_iters=num_iters, tol=tol)
        alpha = res.solution[:, 0]
        Kinv_z = res.solution[:, 1:]  # (n, r)
        probe_norms = jnp.full((num_probes,), float(n), dtype)
        logdet = krylov.slq_logdet_from_cg(
            res.alphas[:, 1:], res.betas[:, 1:], probe_norms, n
        )
    lml = -0.5 * jnp.dot(y, alpha) - 0.5 * logdet - 0.5 * n * _LOG_2PI

    from gaussian_processes_tpu.ops import pairwise

    if _is_ski_kron(structure):
        # D-dim SKI: dK_ski/dtheta_p = W ((x)_d T_{J_p,d}) W^T — the
        # sandwich with the Kronecker Jacobian factors
        from gaussian_processes_tpu.ops import kronecker
        from gaussian_processes_tpu.ops import ski as ski_ops

        jcols = kronecker.kron_jacobian_columns(kernel, structure.kron)
        U = jnp.concatenate([alpha[:, None], probes], axis=1)  # (n, r+1)
        WtU = ski_ops.interp_rmatvec_nd(structure, U)  # (m, r+1)
        JU = jnp.stack([
            ski_ops.interp_matvec_nd(structure, kronecker.kron_matvec(c, WtU))
            for c in jcols
        ])  # (P, n, r+1)
        J_alpha = JU[:, :, 0]
        J_z = JU[:, :, 1:]
    elif _is_ski(structure):
        # differentiate the SKI surrogate itself: dK_ski/dtheta_p =
        # W T_{J_p} W^T (the geometry W is theta-independent), each J_p
        # column Toeplitz on the grid
        from gaussian_processes_tpu.ops import ski as ski_ops
        from gaussian_processes_tpu.ops import toeplitz

        jcols = toeplitz.jacobian_columns(kernel, structure.grid)  # (P, m)
        U = jnp.concatenate([alpha[:, None], probes], axis=1)  # (n, r+1)
        WtU = ski_ops.interp_rmatvec(structure, U)  # (m, r+1)
        JU = jax.vmap(
            lambda c: ski_ops.interp_matvec(
                structure, toeplitz.toeplitz_matvec(c, WtU)
            )
        )(jcols)  # (P, n, r+1)
        J_alpha = JU[:, :, 0]
        J_z = JU[:, :, 1:]
    elif _is_kron(structure):
        # each dK/dtheta_p is Kronecker too (one factor swapped for its
        # derivative) — P sets of D FFT sweeps
        from gaussian_processes_tpu.ops import kronecker

        jcols = kronecker.kron_jacobian_columns(kernel, structure)
        U = jnp.concatenate([alpha[:, None], probes], axis=1)  # (n, r+1)
        JU = jnp.stack([kronecker.kron_matvec(c, U) for c in jcols])
        J_alpha = JU[:, :, 0]
        J_z = JU[:, :, 1:]
    elif structure == "toeplitz":
        from gaussian_processes_tpu.ops import toeplitz

        jcols = toeplitz.jacobian_columns(kernel, x)  # (P, n)
        U = jnp.concatenate([alpha[:, None], probes], axis=1)  # (n, r+1)
        JU = jax.vmap(lambda c: toeplitz.toeplitz_matvec(c, U))(jcols)
        J_alpha = JU[:, :, 0]
        J_z = JU[:, :, 1:]
    elif impl == "auto" and pairwise.fused_jacvec_default(
        kernel, x, num_probes + 1
    ):
        # fused Pallas path: each J_p tile is built and contracted with
        # [alpha, probes] on the spot — the (P, n, b) Jacobian strips
        # below never reach device memory
        U = jnp.concatenate([alpha[:, None], probes], axis=1)
        JU = pairwise.kernel_jacvec_fused(kernel, x, U)  # (P, n, r+1)
        J_alpha = JU[:, :, 0]
        J_z = JU[:, :, 1:]
    else:
        # strip accumulation of J_p-matvecs: J (P, n, b) per column block
        b = min(block_size, n)
        nb = -(-n // b)
        n_pad = nb * b
        x_pad = krylov._pad_to(x, n_pad).reshape(nb, b)
        av_pad = krylov._pad_to(alpha[:, None], n_pad).reshape(nb, b, 1)
        z_pad = krylov._pad_to(probes, n_pad).reshape(nb, b, num_probes)

        def step(acc, xv):
            xj, aj, zj = xv
            Jj = kernel.jacobian(x, xj)  # (P, n, b)
            # (einsums below inherit the highest-precision context)
            Ja = acc[0] + jnp.einsum("pnb,b->pn", Jj, aj[:, 0])
            Jz = acc[1] + jnp.einsum("pnb,br->pnr", Jj, zj)
            return (Ja, Jz), None

        Ja0 = jnp.zeros((P, n), dtype)
        Jz0 = jnp.zeros((P, n, num_probes), dtype)
        (J_alpha, J_z), _ = jax.lax.scan(
            step, (Ja0, Jz0), (x_pad, av_pad, z_pad)
        )

    quad = jnp.einsum("n,pn->p", alpha, J_alpha)
    trace_est = jnp.mean(
        jnp.einsum("nr,pnr->pr", Kinv_z, J_z), axis=-1
    )
    grad_kernel = 0.5 * (quad - trace_est)

    # noise component: dK/ds = 2 s I
    two_s = 2.0 * noise
    quad_s = two_s * jnp.dot(alpha, alpha)
    trace_s = two_s * jnp.mean(jnp.sum(Kinv_z * probes, axis=0))
    grad_s = 0.5 * (quad_s - trace_s)
    return lml, jnp.concatenate([grad_kernel, grad_s[None]])
