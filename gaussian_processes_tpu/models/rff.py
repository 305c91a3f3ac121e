"""Random-feature (RFF) GP regression: the feature-space path.

The third large-N regime, complementing the matrix-free CG stack
(models/iterative_gp.py — exact, iterative) and the grid/SKI structure
exploits (ops/toeplitz.py, ops/ski.py — require structure): approximate
the kernel with F spectral features (models/pathwise.py::prior_features,
E[phi phi^T] ~= K) and do EXACT Bayesian linear regression in feature
space:

    y = Phi w + eps,  w ~ N(0, I_F),  eps ~ N(0, s^2 I)
    A = Phi^T Phi + s^2 I_F            (F x F)
    w_mean = A^-1 Phi^T y
    mean(xo) = phi(xo)^T w_mean
    var(xo)  = s^2 phi(xo)^T A^-1 phi(xo)
    lml      = -1/2 [ (y^T y - (Phi^T y)^T A^-1 Phi^T y)/s^2
                      + logdet(A) + (n - F) log s^2 + n log 2pi ]

(the matrix-determinant lemma / Woodbury identities — everything needs
only the F x F Cholesky).  Cost: one blocked O(n F^2 / 2) matmul sweep to
accumulate A (never materializing the (n, F) feature matrix), then
O(F^3) once — n can be 10^6+ at F = 2048 on one device, scattered inputs,
any dimension, no CG iterations and no f32 conditioning cliffs (A is
regularized by s^2 with condition ~ ||K|| / s^2 spread over F modes).

Accuracy model: the implied prior covariance is the F-feature estimate
of K, so predictions/lml converge to the exact GP at the usual
O(1/sqrt(F)) RFF rate (periodic kernels: exact truncated harmonics).
Gated against the dense exact GP in tests/test_rff.py.

The reference has no approximate-inference path at all (SURVEY.md §1);
this rounds out the framework's large-N menu with the classic
feature-space method, reusing the spectral laws already validated for
pathwise sampling.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
from jax import lax
from jax.scipy.linalg import cho_factor, cho_solve, solve_triangular

from gaussian_processes_tpu.models.base import Kernel
from gaussian_processes_tpu.models.gp import _LOG_2PI
from gaussian_processes_tpu.models.pathwise import FourierFeatures, prior_features
from gaussian_processes_tpu.ops import krylov

_HI = lax.Precision.HIGHEST


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class RFFPosterior:
    feats: FourierFeatures
    L_A: jax.Array  # (F, F) lower Cholesky of A = Phi^T Phi + s^2 I
    w_mean: jax.Array  # (F,)
    noise: jax.Array
    log_marginal: jax.Array


def fit_rff(
    kernel: Kernel,
    x,
    y,
    noise,
    key: jax.Array,
    *,
    num_features: int = 2048,
    block_size: int = 8192,
    jitter: float = 0.0,
) -> RFFPosterior:
    """Feature-space GP fit; memory O(F^2 + block * F), flops O(n F^2).

    The (n, F) feature matrix never exists: A and Phi^T y accumulate
    over row blocks of x in one scan (each block is two matmuls).
    """
    x = jnp.asarray(x)
    y = jnp.asarray(y)
    noise = jnp.asarray(noise)
    n = y.shape[0]
    dtype = y.dtype
    feats = prior_features(kernel, key, num_features)
    F = feats.num_features

    b = min(block_size, n)
    nb = -(-n // b)
    x_pad = krylov._pad_to(x, nb * b).reshape(nb, b, *x.shape[1:])
    # padded rows must contribute nothing: mask their feature rows
    mask = (jnp.arange(nb * b) < n).astype(dtype).reshape(nb, b)
    y_pad = krylov._pad_to(y, nb * b).reshape(nb, b)

    def step(carry, xv):
        A, py = carry
        xj, yj, mj = xv
        Pj = feats(xj) * mj[:, None]  # (b, F)
        A = A + jnp.matmul(Pj.T, Pj, precision=_HI)
        py = py + jnp.matmul(Pj.T, yj, precision=_HI)
        return (A, py), None

    A0 = jnp.zeros((F, F), dtype)
    p0 = jnp.zeros((F,), dtype)
    (A, py), _ = lax.scan(step, (A0, p0), (x_pad, y_pad, mask))
    s2 = jnp.square(noise) + jitter
    A = A + s2 * jnp.eye(F, dtype=dtype)
    L_A = jnp.linalg.cholesky(A)
    w_mean = cho_solve((L_A, True), py)

    # lml via the matrix determinant lemma (all F x F quantities)
    quad = (jnp.dot(y, y) - jnp.dot(py, w_mean)) / s2
    logdet = 2.0 * jnp.sum(jnp.log(jnp.diagonal(L_A))) \
        + (n - F) * jnp.log(s2)
    lml = -0.5 * (quad + logdet + n * _LOG_2PI)
    return RFFPosterior(
        feats=feats, L_A=L_A, w_mean=w_mean, noise=noise, log_marginal=lml
    )


def predict_rff(post: RFFPosterior, xo):
    """(mean, latent variance) at query points — O(m F + m F^2) total."""
    xo = jnp.asarray(xo)
    P = post.feats(xo)  # (m, F)
    mean = jnp.matmul(P, post.w_mean, precision=_HI)
    # var_i = s^2 * p_i^T A^-1 p_i  via one triangular solve
    Z = solve_triangular(post.L_A, P.T, lower=True)  # (F, m)
    var = jnp.square(post.noise) * jnp.sum(jnp.square(Z), axis=0)
    return mean, var


def sample_rff_posterior(
    post: RFFPosterior, xo, key: jax.Array, n_samples: int = 1
):
    """Posterior function draws: w ~ N(w_mean, s^2 A^-1), f = phi(xo)^T w.

    Exact in feature space (one F x F triangular solve per draw batch) —
    the feature-path analogue of pathwise Matheron sampling.
    """
    xo = jnp.asarray(xo)
    F = post.w_mean.shape[0]
    z = jax.random.normal(key, (F, n_samples), post.w_mean.dtype)
    # w = w_mean + s * L_A^-T z  has covariance s^2 A^-1
    dw = post.noise * solve_triangular(post.L_A.T, z, lower=False)
    W = post.w_mean[:, None] + dw  # (F, S)
    return jnp.matmul(post.feats(xo), W, precision=_HI).T  # (S, m)
