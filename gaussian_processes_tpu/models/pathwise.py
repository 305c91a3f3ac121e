"""Pathwise posterior sampling: Matheron's rule + spectral prior features.

Why this exists: the dense ``sample_posterior`` (models/gp.py) draws
f(xo) from the m-dimensional predictive MVN — it needs the dense Cholesky
factor of the training kernel AND an O(m^3) factorization of the
predictive covariance, so it stops where the dense fit stops (N ~ 2e4 on
one device) and scales badly in the number of query points.  Pathwise
conditioning (the "efficiently sampling functions from GPs" pattern of
Wilson et al. 2020, implemented fresh here) instead samples *functions*:

    f_post(.) = f_prior(.) + K(., x) (K + s^2 I)^-1 (y - f_prior(x) - eps)

with f_prior a draw from the GP prior and eps ~ N(0, s^2 I).  Conditioned
on nothing else, f_post is exactly a posterior draw.  The three pieces
map perfectly onto this framework's paths:

* f_prior via **spectral (random Fourier) features** — Bochner's theorem
  turns every stationary kernel here into a frequency distribution; a
  prior draw is one (m, F) cosine-feature matmul;
* the solve reuses the dense Cholesky factor (small N) or the
  matrix-free preconditioned CG stack (large N — ops/krylov.py), so
  posterior *function draws now exist at N=65k+*, where no dense factor
  can;
* the update term is a strip kernel matvec (O(m * block) memory).

Frequency laws (all validated against the kernel matrix in
tests/test_pathwise.py):

  GaussianKernel(h, w)          omega ~ N(0, 1/w^2)
  Matern32/52(h, w)             omega ~ t_{2 nu} / w   (t via z / sqrt(g/df))
  RationalQuadratic(h, w, a)    omega ~ N(0, lam/w^2), lam ~ Gamma(a, rate=a)
                                (the RQ *is* this Gamma mixture of SEs)
  PeriodicKernel(h, w, p)       discrete spectrum at q/p, q = 0, 1, 2, ...
                                with weights e^{-c} I_q(c), c = 1/w^2
                                (Jacobi–Anger); standalone periodic
                                kernels get the *exact* truncated
                                harmonic feature map instead of sampling
  SumKernel                     mixture of the children's laws, weighted
                                by their k(0)
  ProductKernel                 omega = omega_1 + omega_2 (spectral
                                measures convolve; both laws here are
                                sign-symmetric, which this relies on)
  ARDGaussianKernel(h, w_d)     omega ~ N(0, diag(1/w_d^2)) in R^D

Capability note vs the reference: the reference has no sampler and no
prior-draw facility at all (SURVEY.md §1); this module is part of the
"fully Bayesian ... at scale" mandate (BASELINE.json:5) — posterior
predictive *functions*, not just moments, at matrix-free N.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import jax
import jax.numpy as jnp
from jax import lax
from jax.scipy.linalg import solve_triangular
from jax.scipy.special import gammaln, logsumexp

from gaussian_processes_tpu.models.ard import ARDGaussianKernel
from gaussian_processes_tpu.models.base import Kernel
from gaussian_processes_tpu.models.composite import ProductKernel, SumKernel
from gaussian_processes_tpu.models.gaussian import GaussianKernel
from gaussian_processes_tpu.models.gp import GPPosterior
from gaussian_processes_tpu.models.iterative_gp import IterativePosterior
from gaussian_processes_tpu.models.matern import Matern32Kernel, Matern52Kernel
from gaussian_processes_tpu.models.periodic import PeriodicKernel
from gaussian_processes_tpu.models.rq import RationalQuadraticKernel
from gaussian_processes_tpu.ops import krylov

_HI = lax.Precision.HIGHEST


# ---------------------------------------------------------------------------
# Fourier feature map
# ---------------------------------------------------------------------------


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class FourierFeatures:
    """phi_f(t) = scale_f * cos(<t, omega_f> + phase_f), f = 1..F.

    ``omega``: (F,) for scalar inputs or (F, D) for D-dimensional inputs.
    Satisfies E[phi(t) phi(t')^T] ~= k(t, t') (exactly, for the harmonic
    periodic map, up to truncation).  A GP-prior function draw is
    f(t) = phi(t) @ u with u ~ N(0, I_F).
    """

    omega: jax.Array
    phase: jax.Array
    scale: jax.Array

    @property
    def num_features(self) -> int:
        return self.omega.shape[0]

    def __call__(self, t: jax.Array) -> jax.Array:
        """Feature matrix, shape (m, F), for inputs t of shape (m,) or (m, D)."""
        t = jnp.asarray(t)
        if self.omega.ndim == 1:
            proj = t[:, None] * self.omega[None, :]  # (m, F)
        else:
            proj = jnp.matmul(t, self.omega.T, precision=_HI)
        return self.scale[None, :] * jnp.cos(proj + self.phase[None, :])


def _log_bessel_i(q: jax.Array, c: jax.Array, num_terms: int = 80) -> jax.Array:
    """log I_q(c) by the ascending series, vectorized over integer orders q.

    log sum_m exp((2m + q) log(c/2) - lgamma(m+1) - lgamma(m+q+1)).
    Accurate for the moderate c = 1/w^2 regime periodic kernels live in
    (the series needs ~c/2 + a few dozen terms; num_terms=80 covers
    c <= ~60, i.e. lengthscales w >= ~0.13).
    """
    m = jnp.arange(num_terms, dtype=jnp.asarray(c).dtype)
    q = q[:, None]
    logc2 = jnp.log(c / 2.0)
    terms = (2.0 * m[None, :] + q) * logc2 - gammaln(m[None, :] + 1.0) - gammaln(
        m[None, :] + q + 1.0
    )
    return logsumexp(terms, axis=1)


def periodic_harmonic_features(
    kernel: PeriodicKernel, num_harmonics: int = 64
) -> FourierFeatures:
    """Exact (truncated) feature map for the periodic kernel.

    Jacobi–Anger: with c = 1/w^2,

        k(d) = h^2 e^{-c} [I_0(c) + 2 sum_{q>=1} I_q(c) cos(q d / p)]

    so the features are the constant plus cos/sin harmonic pairs at
    frequencies q/p with variances h^2 e^{-c} I_q(c) (x2 for q >= 1).
    Deterministic — no Monte-Carlo error; truncation error falls like
    the Bessel tail (super-exponentially for q >> c).
    """
    h = jnp.asarray(kernel.h)
    w = jnp.asarray(kernel.w)
    p = jnp.asarray(kernel.p)
    c = 1.0 / (w * w)
    q = jnp.arange(num_harmonics + 1, dtype=c.dtype)
    logI = _log_bessel_i(q, c)
    wq = jnp.exp(2.0 * jnp.log(h) - c + logI)  # h^2 e^{-c} I_q(c)
    # constant (q=0), then cos & sin pairs for q >= 1
    omega = jnp.concatenate([q[:1] * 0.0, q[1:] / p, q[1:] / p])
    zeros = jnp.zeros_like(q[1:])
    phase = jnp.concatenate([q[:1] * 0.0, zeros, zeros - jnp.pi / 2.0])
    scale = jnp.concatenate(
        [jnp.sqrt(wq[:1]), jnp.sqrt(2.0 * wq[1:]), jnp.sqrt(2.0 * wq[1:])]
    )
    return FourierFeatures(omega=omega, phase=phase, scale=scale)


# ---------------------------------------------------------------------------
# Spectral sampling (Bochner) per kernel family
# ---------------------------------------------------------------------------

_PERIODIC_ATOMS = 128  # truncation for periodic atoms inside composites


def _spectral_sample(kernel: Kernel, key: jax.Array, num: int) -> jax.Array:
    """Draw ``num`` frequencies from the kernel's normalized spectral law.

    Returns (num,) for scalar-input kernels, (num, D) for ARD.  Every law
    returned here is symmetric about 0 (required by the ProductKernel
    convolution rule).
    """
    if isinstance(kernel, GaussianKernel):
        return jax.random.normal(key, (num,)) / kernel.w
    if isinstance(kernel, (Matern32Kernel, Matern52Kernel)):
        df = 3.0 if isinstance(kernel, Matern32Kernel) else 5.0
        kz, kg = jax.random.split(key)
        z = jax.random.normal(kz, (num,))
        g = jax.random.chisquare(kg, df, (num,))
        return (z / jnp.sqrt(g / df)) / kernel.w
    if isinstance(kernel, RationalQuadraticKernel):
        kz, kg = jax.random.split(key)
        lam = jax.random.gamma(kg, kernel.a, (num,)) / kernel.a
        z = jax.random.normal(kz, (num,))
        return z * jnp.sqrt(lam) / kernel.w
    if isinstance(kernel, PeriodicKernel):
        c = 1.0 / jnp.square(jnp.asarray(kernel.w))
        q = jnp.arange(_PERIODIC_ATOMS + 1, dtype=c.dtype)
        logw = _log_bessel_i(q, c)  # -c and h^2 cancel in normalization
        logw = logw + jnp.where(q > 0, jnp.log(2.0), 0.0)  # +/-q folded
        kq, ks = jax.random.split(key)
        qs = jax.random.categorical(kq, logw, shape=(num,))
        sign = jax.random.rademacher(ks, (num,), dtype=q.dtype)
        return sign * qs.astype(q.dtype) / kernel.p
    if isinstance(kernel, SumKernel):
        k1, k2, kb = jax.random.split(key, 3)
        w1 = _k0(kernel.k1)
        w2 = _k0(kernel.k2)
        pick1 = jax.random.bernoulli(kb, w1 / (w1 + w2), (num,))
        o1 = _spectral_sample(kernel.k1, k1, num)
        o2 = _spectral_sample(kernel.k2, k2, num)
        if o1.ndim != o2.ndim:
            raise ValueError("SumKernel children must share input dimension")
        return jnp.where(pick1 if o1.ndim == 1 else pick1[:, None], o1, o2)
    if isinstance(kernel, ProductKernel):
        k1, k2 = jax.random.split(key)
        o1 = _spectral_sample(kernel.k1, k1, num)
        o2 = _spectral_sample(kernel.k2, k2, num)
        if o1.ndim != o2.ndim:
            raise ValueError(
                "ProductKernel children must share input dimension"
            )
        return o1 + o2
    if isinstance(kernel, ARDGaussianKernel):
        D = kernel.w.shape[0]
        return jax.random.normal(key, (num, D)) / kernel.w[None, :]
    raise NotImplementedError(
        f"no spectral law registered for {type(kernel).__name__}"
    )


def _k0(kernel: Kernel) -> jax.Array:
    """k(0) — the prior variance of a stationary kernel."""
    if isinstance(kernel, ARDGaussianKernel):
        probe = jnp.zeros((1, kernel.w.shape[0]))
    else:
        probe = jnp.zeros((1,))
    return kernel.kdiag(probe)[0]


def prior_features(
    kernel: Kernel, key: jax.Array, num_features: int = 2048
) -> FourierFeatures:
    """A Fourier feature map phi with E[phi phi^T] ~= K.

    Standalone periodic kernels get the exact harmonic map (zero MC
    error); everything else gets RFF draws from the kernel's spectral
    law with random phases.
    """
    if isinstance(kernel, PeriodicKernel):
        return periodic_harmonic_features(
            kernel, num_harmonics=max(1, (num_features - 1) // 2)
        )
    ko, kb = jax.random.split(key)
    omega = _spectral_sample(kernel, ko, num_features)
    phase = jax.random.uniform(kb, (num_features,), maxval=2.0 * jnp.pi)
    amp = _k0(kernel)
    scale = jnp.broadcast_to(
        jnp.sqrt(2.0 * amp / num_features), (num_features,)
    ).astype(jnp.result_type(amp))
    return FourierFeatures(omega=omega, phase=phase, scale=scale)


# ---------------------------------------------------------------------------
# Matheron pathwise conditioning
# ---------------------------------------------------------------------------


def _pathwise_terms(kernel, x, y, noise, key, n_samples, num_features):
    """Shared prior-draw plumbing: returns (features, u, residual).

    residual[:, s] = y - f_prior_s(x) - eps_s  is what the solve inverts;
    identical key plumbing in the dense and iterative samplers makes them
    comparable draw-for-draw (tested).
    """
    kf, ku, ke = jax.random.split(key, 3)
    feats = prior_features(kernel, kf, num_features)
    F = feats.num_features
    dtype = jnp.result_type(y)
    u = jax.random.normal(ku, (F, n_samples), dtype)
    eps = jnp.asarray(noise, dtype) * jax.random.normal(
        ke, (y.shape[0], n_samples), dtype
    )
    f_x = jnp.matmul(feats(x), u, precision=_HI)  # (n, S)
    resid = y[:, None] - f_x - eps
    return feats, u, resid


def _cross_matvec(kernel, xo, x, V, block_size):
    """K(xo, x) @ V by strips over x — O(m * block) memory, matmul contractions."""
    n = x.shape[0]
    b = min(block_size, n)
    nb = -(-n // b)
    x_pad = krylov._pad_to(x, nb * b).reshape(nb, b, *x.shape[1:])
    V_pad = krylov._pad_to(V, nb * b).reshape(nb, b, V.shape[1])

    def step(acc, xv):
        xj, vj = xv
        return acc + jnp.matmul(kernel(xo, xj), vj, precision=_HI), None

    out0 = jnp.zeros((xo.shape[0], V.shape[1]), V.dtype)
    out, _ = lax.scan(step, out0, (x_pad, V_pad))
    return out


def sample_posterior_pathwise(
    post: GPPosterior,
    xo,
    key: jax.Array,
    n_samples: int = 1,
    num_features: int = 2048,
) -> jax.Array:
    """Posterior function draws f(xo), shape (n_samples, m) — dense solve.

    Matheron update through the already-computed Cholesky factor of
    ``post``.  Unlike ``sample_posterior`` this never factorizes the m x m
    predictive covariance, so m can be large; draws from the *same*
    posterior up to the O(1/sqrt(F)) feature approximation of the prior.
    """
    xo = jnp.asarray(xo)
    from gaussian_processes_tpu.ops.blocked_cholesky import choose_solve

    feats, u, resid = _pathwise_terms(
        post.kernel, post.x, post.y, post.noise, key, n_samples, num_features
    )
    solve = choose_solve(post.x.shape[0])
    z = solve(post.L, resid)
    v = solve(post.L, z, trans=True)  # (n, S)
    with jax.default_matmul_precision("highest"):
        f_o = jnp.matmul(feats(xo), u, precision=_HI) + jnp.matmul(
            post.kernel(xo, post.x), v, precision=_HI
        )
    return f_o.T


def sample_posterior_pathwise_iterative(
    post: IterativePosterior,
    xo,
    key: jax.Array,
    n_samples: int = 1,
    num_features: int = 2048,
    *,
    num_iters: int = 150,
    tol: float = 1e-8,
    jitter: float = 0.0,
    block_size: int = 2048,
    precond_rank: int = 0,
    structure: str = "none",
) -> jax.Array:
    """Posterior function draws at matrix-free scale — no N x N array.

    The Matheron solve runs (optionally preconditioned) batched CG on the
    (n, n_samples) residual block; the cross-covariance update is a strip
    matvec.  This is the path that makes posterior *functions* available
    at N = 65k+ on one device (the dense sampler needs a dense factor).
    Memory: O(n * max(n_samples, block_size, precond_rank)).
    ``structure="toeplitz"`` (uniform-grid training x) runs the Matheron
    solve with O(n log n) FFT matvecs; ``structure=ops.ski.SKIOperator``
    (scattered x) with O(n + m log m) SKI products.
    """
    from gaussian_processes_tpu.models.iterative_gp import _matvec

    xo = jnp.asarray(xo)
    kernel, x, y, noise = post.kernel, post.x, post.y, post.noise
    feats, u, resid = _pathwise_terms(
        kernel, x, y, noise, key, n_samples, num_features
    )
    matvec = _matvec(kernel, x, noise, jitter, block_size, structure)
    if precond_rank > 0:
        L = krylov.pivoted_cholesky(kernel, x, precond_rank)
        pre = krylov.woodbury_inverse_apply(
            L, jnp.square(noise) + jitter
        )
        v, _ = krylov.pcg(matvec, pre, resid, num_iters=num_iters, tol=tol)
    elif structure == "toeplitz":
        from gaussian_processes_tpu.ops import toeplitz

        pre = toeplitz.strang_circulant_precond(
            toeplitz.toeplitz_column(kernel, x), jnp.square(noise) + jitter
        )
        v, _ = krylov.pcg(matvec, pre, resid, num_iters=num_iters, tol=tol)
    else:
        v = krylov.mbcg(matvec, resid, num_iters=num_iters, tol=tol).solution
    with jax.default_matmul_precision("highest"):
        f_o = jnp.matmul(feats(xo), u, precision=_HI) + _cross_matvec(
            kernel, xo, x, v, block_size
        )
    return f_o.T
