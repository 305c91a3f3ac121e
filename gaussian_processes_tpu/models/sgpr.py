"""Sparse GP regression (SGPR): the Titsias collapsed variational bound.

The fourth large-N regime, closing the one measured gap in the round-2
menu (dense exact | matrix-free CG | grid/SKI structure | RFF features):
SCATTERED inputs at N ~ 1e6 with m data-placed inducing points, no CG
iterations, and calibrated variances.  Everything n-sized is one blocked
O(n m^2 / 2) matmul sweep; everything else is (m, m).

Model (Titsias 2009, "Variational learning of inducing variables in
sparse Gaussian processes" — the collapsed evidence lower bound):

    ELBO = log N(y | 0, Q_ff + s^2 I) - 1/(2 s^2) tr(K_ff - Q_ff)
    Q_ff = K_fu Kuu^+ K_uf

The bound is EXACT (equals the dense log marginal) when the inducing set
spans the training set — the tests gate z = x against models/gp.py — and
is a true lower bound otherwise (for ANY psd surrogate Q_ff ⪯ K_ff, so
also under the pseudo-inverse truncation below), which makes it a
conservative drop-in objective for type-II MLE and for Bayesian
hyperparameter sampling.

NUMERICS (all measured, round 2).  The textbook whitened form
(A = L^-1 K_uf / s, B = I + A A^T, chol(B)) is exact in f64 but breaks
down in f32: triangular solves against chol(Kuu + jitter) amplify the
f32 round-off of the swept moment matrix C = K_uf K_fu by
~eps * kappa(L) * ||AAT||, planting O(1)-O(10) junk eigenvalues on B's
unit trailing spectrum — measured +55 nats ABOVE the exact lml at
n=2000, m=64 in f32 (a "lower bound" that isn't), and NaN chol(B)
because kappa(B) ~ n h^2/s^2 exceeds f32 range at n >= 2e3.  Jitter
cannot fix this: the bound loosens faster than the error shrinks
(measured: 205 nats of slack at jitter=1e-2 vs 37 nats of error).

This module therefore whitens with a TRUNCATED PSEUDO-INVERSE of Kuu
(``psd_pinv``): directions of Kuu below rank_tol * lam_max — exactly the
ones the working precision cannot resolve and the ones that amplify
noise — are dropped, which only loosens the bound (any psd truncation
of Q_ff keeps it a valid lower bound).  rank_tol defaults to
sqrt(eps(dtype)) — the measured stability boundary (see
``_default_rank_tol``).  Accuracy, measured at m=64 kmeans centers,
s=0.1 (f32 vs an f64 oracle at the same cutoff):

    n:          2e3      2e4      2e5
    f32 bound error   -0.3     +2.7     +274 nats   (1.8e-4 .. 1.6e-3 rel)
    pred mean error   7e-3     1e-2     1e-2
    pred var error    2e-4     2e-4     3e-4
    cutoff loosening  5.9      89       936 nats    (~0.5% of |lml|, a
                                  modeling choice, identical in f64)

Use f64 (CPU/mesh) when sub-nat absolute lml values at n >= 1e5 matter;
f32 is fine for predictions, MLE, and HMC at any n the sweep reaches.

Differentiability: ``elbo_sgpr`` must be autodiff-safe for MLE and HMC,
but eigh's gradient rule divides by eigenvalue gaps and NaNs on the
tied/clamped trailing spectrum this operator routinely has.  The fix is
structural: ``psd_pinv`` carries a custom VJP (dA = -P dP P — exact on
the retained subspace; the rank-boundary crossing is measure-zero and
ignored, as standard for truncated pinv), and the bound is then written
in P via push-through identities so no eigendecomposition is ever
differentiated:

    logdet(I + AAT)        = logdet(I + C P / s^2)        (Sylvester)
    T^T (I + AAT)^-1 T     = (I + P C / s^2)^-1 P         (push-through)
    tr(AAT)                = tr(P C) / s^2

(P = Kuu^+, T = pinv-sqrt so P = T^T T, AAT = T C T^T / s^2); the
identities are gated numerically in tests/test_sgpr.py.

The reference has no sparse/approximate path at all (SURVEY.md §1); this
module is capability beyond it, required by the north star's "scaled"
(BASELINE.json:5).  Pattern source: the public Titsias/GPflow SGPR
formulation; the numerics above are this module's own, built around the
blocked-scan accumulation idiom shared with models/rff.py.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
from jax import lax

from gaussian_processes_tpu.models.base import Kernel
from gaussian_processes_tpu.models.gp import _LOG_2PI
from gaussian_processes_tpu.ops import krylov

_HI = lax.Precision.HIGHEST


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class SGPRPosterior:
    """Collapsed SGPR posterior: everything predict/sample needs is
    (m, m) or (m,) — independent of n once fitted.

    ``T_uu`` is the truncated whitening map (pinv-sqrt rows of Kuu;
    see module docstring), playing chol(Kuu)^-1's role everywhere.
    ``V_B``/``lam_B`` eigendecompose the whitened AAT (clamped >= 0 and
    floored at m * eps * lam_max — round-off-scale eigenvalues carry no
    information and would otherwise pollute logdet/variances in f32);
    D^-1/2 V^T plays chol(I + AAT)^-1's role (B^-1 = V D^-1 V^T,
    D = 1 + lam)."""

    kernel: Kernel
    z: jax.Array  # (m,) or (m, D) inducing inputs
    T_uu: jax.Array  # (m, m) truncated whitening map of Kuu
    V_B: jax.Array  # (m, m) eigenvectors of AAT = T C T^T / s^2
    lam_B: jax.Array  # (m,) eigenvalues of AAT, clamped/floored
    c: jax.Array  # (m,) D^-1/2 V^T T b / s^2
    noise: jax.Array
    log_marginal: jax.Array  # the ELBO (lower-bounds the exact lml)
    trace_gap: jax.Array  # tr(K_ff - Q_ff) >= 0: inducing-coverage gauge


# ---------------------------------------------------------------------------
# Truncated PSD pseudo-inverse with a tie-safe gradient


@partial(jax.custom_vjp, nondiff_argnums=(2,))
def psd_pinv(A: jax.Array, abs_tol: jax.Array, rank_tol: float) -> jax.Array:
    """P = pseudo-inverse of symmetric PSD A, truncating eigenvalues
    below ``max(rank_tol * lam_max, abs_tol)`` (``abs_tol`` is a traced
    scalar — the data-dependent noise floor; it gets a zero cotangent).

    Forward: one eigh.  Backward: the full Moore-Penrose derivative for
    symmetric A at locally-constant rank,

        dA_bar = -P dP_bar P
                 + (I - A P) dP_bar P^2 + P^2 dP_bar (I - P A)

    (the last two terms are the range-rotation contribution; dropping
    them was measured to bias hyperparameter gradients by ~3%).  The
    rank-boundary crossing itself is measure-zero and ignored."""
    P, _ = _psd_pinv_fwd_pieces(A, abs_tol, rank_tol)
    return P


def _psd_pinv_fwd_pieces(A, abs_tol, rank_tol):
    with jax.default_matmul_precision("highest"):
        lam, U = jnp.linalg.eigh(A)
    cut = jnp.maximum(
        rank_tol * jnp.maximum(lam[-1], 0.0), jnp.asarray(abs_tol, lam.dtype)
    )
    keep = lam > cut
    inv = jnp.where(keep, 1.0 / jnp.where(keep, lam, 1.0), 0.0)
    P = jnp.matmul(U * inv[None, :], U.T, precision=_HI)
    P = 0.5 * (P + P.T)
    return P, (lam, U, keep)


def _psd_pinv_fwd(A, abs_tol, rank_tol):
    P, _ = _psd_pinv_fwd_pieces(A, abs_tol, rank_tol)
    return P, (P, A)


def _psd_pinv_bwd(rank_tol, res, dP):
    P, A = res
    mm = partial(jnp.matmul, precision=_HI)
    P2 = mm(P, P)
    eye = jnp.eye(P.shape[0], dtype=P.dtype)
    proj_c = eye - mm(A, P)  # I - A P = I - P A (symmetric A): range complement
    dA = (
        -mm(P, mm(dP, P))
        + mm(proj_c, mm(dP, P2))
        + mm(P2, mm(dP, proj_c.T))
    )
    # dP may be asymmetric (cotangents of P's uses); A is symmetric, so
    # project the cotangent onto symmetric matrices
    return 0.5 * (dA + dA.T), jnp.zeros((), P.dtype)


psd_pinv.defvjp(_psd_pinv_fwd, _psd_pinv_bwd)


def pinv_whitening(A: jax.Array, abs_tol, rank_tol: float):
    """T with T^T T = A^+ (truncated): rows are eigvecs scaled by
    1/sqrt(lam), zeroed below the cutoff.  NOT differentiable (used by
    ``fit_sgpr``, whose outputs are consumed, not differentiated)."""
    with jax.default_matmul_precision("highest"):
        lam, U = jnp.linalg.eigh(A)
    cut = jnp.maximum(
        rank_tol * jnp.maximum(lam[-1], 0.0), jnp.asarray(abs_tol, lam.dtype)
    )
    keep = lam > cut
    inv_sqrt = jnp.where(
        keep, 1.0 / jnp.sqrt(jnp.where(keep, lam, 1.0)), 0.0
    )
    return inv_sqrt[:, None] * U.T


def _default_rank_tol(dtype) -> float:
    """sqrt(eps): whitening by a direction at relative eigenvalue
    lam_rel amplifies the moment matrix's relative round-off by
    ~1/lam_rel, so retaining lam_rel >= sqrt(eps) caps the amplified
    noise at ~sqrt(eps) relative — measured to be the stability
    boundary (round 2): at rank_tol = m*eps the f64 "bound" EXCEEDED
    the exact lml by up to +7 nats for near-duplicate inducing subsets
    (and the nonsymmetric LU form of elbo_sgpr swung by hundreds),
    while at sqrt(eps) every draw is a true, tight bound and the eig
    and LU forms agree to ~1e-4."""
    import math

    return math.sqrt(float(jnp.finfo(dtype).eps))


# ---------------------------------------------------------------------------
# The blocked O(n m^2) sweep


def _sweep(kernel: Kernel, x, y, z, block_size: int):
    """One blocked scan over row blocks of x accumulating the four
    n-sized reductions: C = K_uf K_fu (m, m), b = K_uf y (m,),
    yty = ||y||^2, tr_kff = tr(K_ff).  Peak memory O(m * block)."""
    n = y.shape[0]
    dtype = y.dtype
    m = z.shape[0]
    b = min(block_size, n)
    nb = -(-n // b)
    x_pad = krylov._pad_to(x, nb * b).reshape(nb, b, *x.shape[1:])
    mask = (jnp.arange(nb * b) < n).astype(dtype).reshape(nb, b)
    y_pad = krylov._pad_to(y, nb * b).reshape(nb, b)

    def step(carry, xv):
        C, bv, yty, trk = carry
        xj, yj, mj = xv
        Kj = kernel(z, xj) * mj[None, :]  # (m, b); padded cols zeroed
        C = C + jnp.matmul(Kj, Kj.T, precision=_HI)
        bv = bv + jnp.matmul(Kj, yj, precision=_HI)
        yty = yty + jnp.dot(yj, yj, precision=_HI)
        # astype: kdiag evaluates k_fn at a strong-f64 zero under x64,
        # which would promote the f32 carry
        trk = trk + jnp.dot(kernel.kdiag(xj).astype(dtype), mj,
                            precision=_HI)
        return (C, bv, yty, trk), None

    init = (
        jnp.zeros((m, m), dtype),
        jnp.zeros((m,), dtype),
        jnp.zeros((), dtype),
        jnp.zeros((), dtype),
    )
    (C, bv, yty, trk), _ = lax.scan(step, init, (x_pad, y_pad, mask))
    return C, bv, yty, trk


def _moments(kernel, x, y, noise, z, block_size, jitter):
    x = jnp.asarray(x)
    y = jnp.asarray(y)
    z = jnp.asarray(z)
    noise = jnp.asarray(noise)
    m = z.shape[0]
    dtype = y.dtype
    with jax.default_matmul_precision("highest"):
        Kuu = kernel(z, z) + jitter * jnp.eye(m, dtype=dtype)
        C, bv, yty, trk = _sweep(kernel, x, y, z, block_size)
    return Kuu, C, bv, yty, trk, jnp.square(noise)


# ---------------------------------------------------------------------------
# Fit / bound


def fit_sgpr(
    kernel: Kernel,
    x,
    y,
    noise,
    z,
    *,
    block_size: int = 8192,
    jitter: float = 0.0,
    rank_tol: float | None = None,
) -> SGPRPosterior:
    """Fit the collapsed SGPR posterior.  O(n m^2) flops (one matmul
    sweep), O(m^2 + block * m) memory; n can be 1e6+ on one device at
    m ~ 2048.

    ``jitter`` defaults to 0: the pseudo-inverse truncation (``rank_tol``,
    default sqrt(eps(dtype)) — see ``_default_rank_tol``) replaces the
    jitter's regularization role."""
    y = jnp.asarray(y)
    z = jnp.asarray(z)
    n = y.shape[0]
    Kuu, C, bv, yty, trk, s2 = _moments(
        kernel, x, y, noise, z, block_size, jitter
    )
    if rank_tol is None:
        rank_tol = _default_rank_tol(y.dtype)
    return _fit_from_moments(
        kernel, z, noise, n, Kuu, C, bv, yty, trk, s2, rank_tol
    )


def _fit_from_moments(
    kernel, z, noise, n, Kuu, C, bv, yty, trk, s2, rank_tol
) -> SGPRPosterior:
    """Posterior tail shared with parallel/sgpr_sharded.py (the sweep is
    the only n-sized piece; everything from the moments on is (m, m))."""
    m = z.shape[0]
    dtype = C.dtype
    T = pinv_whitening(Kuu, 0.0, rank_tol)
    with jax.default_matmul_precision("highest"):
        AAT = jnp.matmul(
            T, jnp.matmul(C, T.T, precision=_HI), precision=_HI
        ) / s2
        AAT = 0.5 * (AAT + AAT.T)
        lam, V = jnp.linalg.eigh(AAT)
    # clamp + floor: eigenvalues at the round-off scale of forming AAT
    # are noise, not signal (see module docstring)
    floor = m * jnp.finfo(dtype).eps * jnp.maximum(lam[-1], 0.0)
    lam = jnp.where(lam > floor, lam, 0.0)
    w = jnp.matmul(T, bv, precision=_HI)
    c = (jnp.matmul(V.T, w, precision=_HI) / jnp.sqrt(1.0 + lam)) / s2

    trace_gap = jnp.maximum(trk - s2 * jnp.sum(lam), 0.0)
    elbo = (
        -0.5 * n * _LOG_2PI
        - 0.5 * jnp.sum(jnp.log1p(lam))
        - 0.5 * n * jnp.log(s2)
        - 0.5 * yty / s2
        + 0.5 * jnp.dot(c, c, precision=_HI)
        - 0.5 * trace_gap / s2
    )
    return SGPRPosterior(
        kernel=kernel, z=z, T_uu=T, V_B=V, lam_B=lam, c=c,
        noise=jnp.asarray(noise), log_marginal=elbo, trace_gap=trace_gap,
    )


def elbo_sgpr(
    kernel: Kernel, x, y, noise, z,
    *, block_size: int = 8192, jitter: float = 0.0,
    rank_tol: float | None = None,
) -> jax.Array:
    """The collapsed bound alone — the differentiable objective for
    type-II MLE (inference/mle.py objective="sgpr") and for Bayesian
    hyperparameter sampling (make_log_posterior_sgpr).  Differentiable
    in kernel params, noise, AND z (inducing-point learning).

    Tie-safe: the only eigendecomposition is inside ``psd_pinv``'s
    custom VJP; the bound itself is LU-based slogdet/solve over the
    push-through forms (module docstring).  Values agree with
    ``fit_sgpr(...).log_marginal`` to round-off (gated in tests)."""
    y = jnp.asarray(y)
    z = jnp.asarray(z)
    n = y.shape[0]
    Kuu, C, bv, yty, trk, s2 = _moments(
        kernel, x, y, noise, z, block_size, jitter
    )
    if rank_tol is None:
        rank_tol = _default_rank_tol(y.dtype)
    return _elbo_from_moments(n, Kuu, C, bv, yty, trk, s2, rank_tol)


def _elbo_from_moments(n, Kuu, C, bv, yty, trk, s2, rank_tol) -> jax.Array:
    """Differentiable bound tail shared with parallel/sgpr_sharded.py."""
    m = Kuu.shape[0]
    P = psd_pinv(Kuu, 0.0, rank_tol)
    with jax.default_matmul_precision("highest"):
        PC = jnp.matmul(P, C, precision=_HI) / s2  # (m, m)
        eye = jnp.eye(m, dtype=C.dtype)
        _, logdetB = jnp.linalg.slogdet(eye + PC)
        Pb = jnp.matmul(P, bv, precision=_HI)
        quad = jnp.dot(bv, jnp.linalg.solve(eye + PC, Pb)) \
            / jnp.square(s2)
        trace_gap = jnp.maximum(trk - s2 * jnp.trace(PC), 0.0)
    return (
        -0.5 * n * _LOG_2PI
        - 0.5 * logdetB
        - 0.5 * n * jnp.log(s2)
        - 0.5 * yty / s2
        + 0.5 * quad
        - 0.5 * trace_gap / s2
    )


# ---------------------------------------------------------------------------
# Prediction / sampling


def _tmp12(post: SGPRPosterior, xo):
    with jax.default_matmul_precision("highest"):
        Kus = post.kernel(post.z, jnp.asarray(xo))  # (m, q)
        t1 = jnp.matmul(post.T_uu, Kus, precision=_HI)
        # D^-1/2 V^T is the whitening square root of B^-1
        # (see SGPRPosterior)
        t2 = jnp.matmul(post.V_B.T, t1, precision=_HI) \
            / jnp.sqrt(1.0 + post.lam_B)[:, None]
    return t1, t2


def predict_sgpr(post: SGPRPosterior, xo):
    """Predictive mean (q,) and LATENT per-point variance (q,) —
    same convention as models/gp.predict_diag (add s^2 for y-space).

    mean = t2^T c;  var = kdiag - sum t1^2 + sum t2^2
    with t1 = T Kus, t2 = D^-1/2 V^T t1.
    """
    t1, t2 = _tmp12(post, xo)
    mean = jnp.matmul(t2.T, post.c, precision=_HI)
    var = (
        post.kernel.kdiag(jnp.asarray(xo)).astype(mean.dtype)
        - jnp.sum(jnp.square(t1), axis=0)
        + jnp.sum(jnp.square(t2), axis=0)
    )
    return mean, var


def predict_sgpr_cov(post: SGPRPosterior, xo):
    """Predictive mean and FULL latent covariance (q, q):
    cov = Kss - t1^T t1 + t2^T t2."""
    xo = jnp.asarray(xo)
    t1, t2 = _tmp12(post, xo)
    mean = jnp.matmul(t2.T, post.c, precision=_HI)
    with jax.default_matmul_precision("highest"):
        cov = (
            post.kernel(xo, xo)
            - jnp.matmul(t1.T, t1, precision=_HI)
            + jnp.matmul(t2.T, t2, precision=_HI)
        )
    return mean, cov


def sample_sgpr_posterior(
    post: SGPRPosterior, xo, key: jax.Array, n_samples: int = 1,
    jitter: float = 1e-8,
):
    """Joint posterior function draws at xo via the full (q, q) predictive
    covariance (use pathwise sampling for very large query sets)."""
    mean, cov = predict_sgpr_cov(post, xo)
    q = mean.shape[0]
    with jax.default_matmul_precision("highest"):
        Lc = jnp.linalg.cholesky(
            cov + jitter * jnp.eye(q, dtype=cov.dtype)
        )
        zn = jax.random.normal(key, (q, n_samples), mean.dtype)
        draws = mean[:, None] + jnp.matmul(Lc, zn, precision=_HI)
    return draws.T  # (S, q)


# ---------------------------------------------------------------------------
# Inducing-point selection


def inducing_subset(key: jax.Array, x, m: int) -> jax.Array:
    """m training inputs drawn without replacement — the cheap default."""
    x = jnp.asarray(x)
    idx = jax.random.choice(key, x.shape[0], shape=(m,), replace=False)
    return x[idx]


def inducing_grid(x, m: int) -> jax.Array:
    """1-D only: m evenly spaced points spanning the data range."""
    x = jnp.asarray(x)
    if x.ndim != 1:
        raise ValueError("inducing_grid is 1-D; use kmeans_inducing for D>1")
    return jnp.linspace(jnp.min(x), jnp.max(x), m)


def kmeans_inducing(
    key: jax.Array, x, m: int, *, iters: int = 10, block_size: int = 8192
) -> jax.Array:
    """Lloyd k-means centers as inducing points — fixed iteration count
    (jittable), blocked O(n m) assignment sweeps (no (n, m) distance
    matrix in memory beyond one block).  Empty clusters keep their
    previous center (masked update)."""
    x = jnp.asarray(x)
    x2 = x[:, None] if x.ndim == 1 else x  # (n, D)
    n, D = x2.shape
    dtype = x2.dtype
    z0 = inducing_subset(key, x2, m)  # (m, D)

    b = min(block_size, n)
    nb = -(-n // b)
    x_pad = krylov._pad_to(x2, nb * b).reshape(nb, b, D)
    mask = (jnp.arange(nb * b) < n).reshape(nb, b)

    def lloyd(_, z):
        def step(carry, xv):
            sums, counts = carry
            xj, mj = xv
            # argmin_k ||x - z_k||^2 over the block, a matmul for the cross term
            d = (
                jnp.sum(jnp.square(xj), axis=1)[:, None]
                - 2.0 * jnp.matmul(xj, z.T, precision=_HI)
                + jnp.sum(jnp.square(z), axis=1)[None, :]
            )  # (b, m)
            a = jnp.argmin(d, axis=1)  # (b,)
            onehot = (
                (a[:, None] == jnp.arange(m)[None, :]) & mj[:, None]
            ).astype(dtype)  # (b, m)
            sums = sums + jnp.matmul(onehot.T, xj, precision=_HI)
            counts = counts + jnp.sum(onehot, axis=0)
            return (sums, counts), None

        init = (jnp.zeros((m, D), dtype), jnp.zeros((m,), dtype))
        (sums, counts), _ = lax.scan(step, init, (x_pad, mask))
        nonempty = counts > 0
        z_new = sums / jnp.maximum(counts, 1.0)[:, None]
        return jnp.where(nonempty[:, None], z_new, z)

    z = lax.fori_loop(0, iters, lloyd, z0)
    return z[:, 0] if x.ndim == 1 else z


def select_inducing(key: jax.Array, x, m: int, method: str = "kmeans"):
    """Dispatch: 'subset' | 'grid' (1-D) | 'kmeans'."""
    if method == "subset":
        return inducing_subset(key, x, m)
    if method == "grid":
        return inducing_grid(x, m)
    if method == "kmeans":
        return kmeans_inducing(key, x, m)
    raise ValueError(f"unknown inducing method: {method!r}")


# ---------------------------------------------------------------------------
# Hyperparameter learning on the bound


def fit_sgpr_mle(
    kernel_template: Kernel,
    x,
    y,
    noise_init,
    z0,
    *,
    learn_inducing: bool = False,
    num_steps: int = 200,
    learning_rate: float = 0.05,
    block_size: int = 8192,
    jitter: float = 0.0,
    rank_tol: float | None = None,
):
    """Type-II MLE on the collapsed bound with Adam over
    u = (log kernel params, log noise[, z flattened]).

    With ``learn_inducing=True`` the inducing locations are free
    variational parameters (more of them only tightens the bound — they
    are not model parameters, so this never overfits the evidence).
    Returns (SGPRPosterior at the optimum, losses).
    """
    import optax
    from gaussian_processes_tpu.inference import gp_model

    x = jnp.asarray(x)
    y = jnp.asarray(y)
    z0 = jnp.asarray(z0)
    P = kernel_template.n_params
    u_theta0 = gp_model.pack(kernel_template, noise_init)
    u0 = (
        jnp.concatenate([u_theta0, z0.ravel().astype(u_theta0.dtype)])
        if learn_inducing
        else u_theta0
    )

    def loss_fn(u):
        kernel, noise = gp_model.unpack(kernel_template, u[: P + 1])
        z = u[P + 1:].reshape(z0.shape) if learn_inducing else z0
        return -elbo_sgpr(
            kernel, x, y, noise, z, block_size=block_size,
            jitter=jitter, rank_tol=rank_tol,
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

    kernel, noise = gp_model.unpack(kernel_template, best_u[: P + 1])
    z = best_u[P + 1:].reshape(z0.shape) if learn_inducing else z0
    post = fit_sgpr(
        kernel, x, y, noise, z, block_size=block_size,
        jitter=jitter, rank_tol=rank_tol,
    )
    return post, losses


def make_log_posterior_sgpr(
    kernel_template: Kernel,
    x,
    y,
    z,
    *,
    prior_mean=0.0,
    prior_std=2.0,
    block_size: int = 8192,
    jitter: float = 0.0,
    rank_tol: float | None = None,
):
    """Unnormalized log posterior over u = log(theta, noise) with the
    SGPR bound as the likelihood surrogate — Bayesian hyperparameter
    sampling (NUTS/ChEES) at scattered-large-n scale where the dense
    marginal cannot be formed.  The bound is deterministic and exactly
    differentiable (the psd_pinv custom VJP — no probes, no eigh
    autodiff), so HMC energy errors are honest.  Bias model: the
    surrogate posterior is the variational one; it approaches the true
    hyperposterior as the trace gap -> 0 (gate in tests/test_sgpr.py)."""
    from gaussian_processes_tpu.inference import gp_model

    x = jnp.asarray(x)
    y = jnp.asarray(y)
    z = jnp.asarray(z)
    mu = jnp.asarray(prior_mean)
    sd = jnp.asarray(prior_std)

    def log_post(u):
        kernel, noise = gp_model.unpack(kernel_template, u)
        lp = -0.5 * jnp.sum(jnp.square((u - mu) / sd))
        return elbo_sgpr(
            kernel, x, y, noise, z, block_size=block_size,
            jitter=jitter, rank_tol=rank_tol,
        ) + lp

    return log_post
