"""Non-Gaussian observation models via the Laplace approximation.

The classic companion to exact regression (Rasmussen & Williams ch. 3,
algorithms 3.1/3.2 — the public textbook formulation, implemented fresh
here in jittable fixed-iteration form): the latent-GP posterior is
approximated by a Gaussian at its Newton mode.  Two log-concave
likelihoods ship:

* ``LogisticLikelihood`` — binary classification, labels in {-1, +1},
  p(y|f) = sigmoid(y f); predictive class probabilities by MacKay's
  probit approximation.
* ``PoissonLikelihood(binsize)`` — count regression / log-Gaussian Cox
  process with log link, y | f ~ Poisson(binsize * e^f); predictive
  rate E[b e^f] = b exp(mu + var/2) exactly under the Gaussian
  approximation.

Any likelihood exposing ``terms(f, y) -> (sum log p, d/df, W=-d2/df2)``
with W >= 0 (log-concave) plugs in unchanged.

Design decisions:

* the Newton iteration uses the B = I + W^1/2 K W^1/2 parameterization
  (numerically safe for any W >= 0) with a FIXED iteration count under
  ``lax.scan`` — static shapes, one compiled program, vmappable over
  hyperparameter candidates; convergence is monitored, not branched on
  (the objective change per iteration is returned for inspection);
* every factorization is one (n, n) XLA Cholesky, with the same
  ``choose_solve`` dispatch the regression path uses;
* the approximate log marginal likelihood is exactly R&W eq. 3.32,
  differentiable by plain autodiff through the whole Newton scan (the
  iteration converges to a fixed point, and at the mode the implicit
  dependence of f_hat on theta is second-order — we differentiate
  through the unrolled scan, which is exact for the computed quantity),
  so ``fit_mle(objective=...)``-style type-II MLE works unchanged.

The reference has no classification at all (SURVEY.md §1) — this is
beyond-parity capability using the same kernel/Cholesky substrate.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
from jax import lax
from jax.scipy.linalg import solve_triangular

from gaussian_processes_tpu.models.base import Kernel
from gaussian_processes_tpu.models.gp import _LOG_2PI  # noqa: F401 (parity)

_HI = lax.Precision.HIGHEST


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class LaplacePosterior:
    """Laplace-approximate latent posterior at the mode."""

    kernel: Kernel
    likelihood: object  # LogisticLikelihood / PoissonLikelihood / custom
    x: jax.Array  # (n,) or (n, D)
    y: jax.Array  # (n,) labels {-1,+1} (logistic) or counts (poisson)
    f_hat: jax.Array  # (n,) latent mode
    sqrt_w: jax.Array  # (n,) W^1/2 at the mode (logistic: pi(1-pi))
    L_B: jax.Array  # (n, n) chol(I + W^1/2 K W^1/2)
    #: K^-1 f_hat as carried by the Newton recurrence — the STABLE
    #: representer weights for prediction.  Mathematically equal to
    #: grad_lik at the exact mode, but numerically far better: the raw
    #: likelihood gradient's entries are O(residual)-sized and their
    #: smoothing to the O(1) predictive mean relies on a cancellation
    #: that f32 mode error destroys (measured in f32: predictions
    #: +-100 via grad_lik vs correct via a_hat at n=4096 Poisson).
    a_hat: jax.Array
    grad_lik: jax.Array  # (n,) d log p(y|f) / df at the mode
    log_marginal: jax.Array  # Laplace approx of log p(y | x, theta)
    newton_deltas: jax.Array  # (iters,) objective change per Newton step


def _log_sigmoid(z):
    # stable log sigma(z) = -softplus(-z)
    return -jnp.logaddexp(0.0, -z)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class LogisticLikelihood:
    """Binary labels in {-1, +1}, p(y|f) = sigmoid(y f)."""

    def log_prob(self, f, y):
        """Elementwise log p(y|f) — the quadrature hook for SVGP."""
        return _log_sigmoid(y * f)

    def terms(self, f, y):
        """(sum log p(y|f), grad (n,), W (n,)) at latent f."""
        ll = jnp.sum(self.log_prob(f, y))  # single source of truth
        pi = jax.nn.sigmoid(f)
        t = 0.5 * (y + 1.0)  # labels mapped to {0, 1}
        grad = t - pi
        w = pi * (1.0 - pi)  # 0 <= W <= 1/4
        return ll, grad, w

    def predict(self, mean, var):
        """p(y=+1) averaged over the latent Gaussian (MacKay's probit
        approximation of the logistic integral, exact to ~1e-3)."""
        kappa = 1.0 / jnp.sqrt(1.0 + jnp.pi * var / 8.0)
        return jax.nn.sigmoid(kappa * mean)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class PoissonLikelihood:
    """Counts y >= 0 with log link: y | f ~ Poisson(binsize * e^f).

    The discretized log-Gaussian Cox process: ``binsize`` is the bin
    measure (exposure).  Log-concave in f (W = binsize * e^f > 0), so
    the same Newton iteration applies.
    """

    binsize: jax.Array = 1.0

    def log_prob(self, f, y):
        """Elementwise log p(y|f) — the quadrature hook for SVGP."""
        b = jnp.asarray(self.binsize, f.dtype)
        return y * (f + jnp.log(b)) - b * jnp.exp(f) \
            - jax.lax.lgamma(y + 1.0)

    def terms(self, f, y):
        b = jnp.asarray(self.binsize, f.dtype)
        rate = b * jnp.exp(f)
        # the log y! term in log_prob is f-independent but kept so the
        # evidence is a real log-probability (comparable across
        # hyperparameters AND models)
        ll = jnp.sum(self.log_prob(f, y))  # single source of truth
        grad = y - rate
        return ll, grad, rate

    def predict(self, mean, var):
        """Posterior-expected rate E[b e^f] = b exp(mean + var/2)."""
        b = jnp.asarray(self.binsize, mean.dtype)
        return b * jnp.exp(mean + 0.5 * var)


def _lik_terms(f, y, likelihood=LogisticLikelihood()):
    return likelihood.terms(f, y)


def fit_laplace(
    kernel: Kernel,
    x,
    y,
    *,
    likelihood=None,
    num_iters: int = 20,
    jitter: float = 1e-6,
) -> LaplacePosterior:
    """Find the latent mode by ``num_iters`` Newton steps (R&W alg. 3.1).

    Each step solves (K^-1 + W)^-1 through the well-conditioned
    B = I + W^1/2 K W^1/2 (eigenvalues in [1, 1 + n max(K)/4]); no
    K^-1 is ever formed.  All shapes static; jit/vmap-safe.
    """
    x = jnp.asarray(x)
    y = jnp.asarray(y)
    n = y.shape[0]
    dtype = y.dtype if jnp.issubdtype(y.dtype, jnp.floating) else jnp.float64
    y = y.astype(dtype)
    lik = LogisticLikelihood() if likelihood is None else likelihood

    from gaussian_processes_tpu.ops.blocked_cholesky import choose_solve

    solve = choose_solve(n)
    with jax.default_matmul_precision("highest"):
        K = kernel(x, x) + jitter * jnp.eye(n, dtype=dtype)

    def obj(f, a):
        # psi(f) = log p(y|f) - 1/2 a^T f  with a = K^-1 f
        ll, _, _ = lik.terms(f, y)
        return ll - 0.5 * jnp.dot(a, f)

    def newton_step(carry, _):
        f, a, psi_prev = carry
        _, grad, w = lik.terms(f, y)
        sw = jnp.sqrt(jnp.maximum(w, 0.0))
        with jax.default_matmul_precision("highest"):
            B = jnp.eye(n, dtype=dtype) + sw[:, None] * K * sw[None, :]
            L = jnp.linalg.cholesky(B)
            b = w * f + grad
            Kb = jnp.matmul(K, b, precision=_HI)
            v = solve(L, sw * Kb)
            v = solve(L, v, trans=True)
            a_new = b - sw * v  # = (K^-1 + W)^-1 ... = K^-1 f_new
            f_new = jnp.matmul(K, a_new, precision=_HI)
        # damped step: a fixed backtracking ladder picks the best-psi
        # candidate (including staying put), making the iteration
        # MONOTONE in psi.  Why (measured): undamped Newton with the
        # Poisson link diverged at n=4096 in f32 on an accelerator — the
        # blocked Cholesky's f32 round-off injects O(1e-1) noise into f that
        # e^f amplifies each step (latent wandered to |f| ~ 70), while
        # the same code on CPU f32 converged.  The interpolation
        # a_t = (1-t) a + t a_new stays consistent with f_t because
        # a = K^-1 f is linear in f.
        psi_floor = jnp.where(jnp.isfinite(psi_prev), psi_prev,
                              jnp.asarray(-jnp.inf, dtype))
        best_f, best_a, best_psi = f, a, psi_floor
        for t in (1.0, 0.5, 0.25):
            f_t = f + t * (f_new - f)
            a_t = a + t * (a_new - a)
            psi_t = obj(f_t, a_t)
            take = psi_t > best_psi
            best_f = jnp.where(take, f_t, best_f)
            best_a = jnp.where(take, a_t, best_a)
            best_psi = jnp.where(take, psi_t, best_psi)
        return (best_f, best_a, best_psi), best_psi - psi_prev

    f0 = jnp.zeros(n, dtype)
    a0 = jnp.zeros(n, dtype)
    (f_hat, a_hat, _), deltas = lax.scan(
        newton_step, (f0, a0, jnp.asarray(-jnp.inf, dtype)), None,
        length=num_iters,
    )

    ll, grad, w = lik.terms(f_hat, y)
    sw = jnp.sqrt(jnp.maximum(w, 0.0))
    with jax.default_matmul_precision("highest"):
        B = jnp.eye(n, dtype=dtype) + sw[:, None] * K * sw[None, :]
        L_B = jnp.linalg.cholesky(B)
    # R&W eq. 3.32: log q(y|X,theta) =
    #   -1/2 a^T f_hat + log p(y|f_hat) - sum log diag chol(B)
    lml = (
        -0.5 * jnp.dot(a_hat, f_hat)
        + ll
        - jnp.sum(jnp.log(jnp.diagonal(L_B)))
    )
    return LaplacePosterior(
        kernel=kernel, likelihood=lik, x=x, y=y, f_hat=f_hat, sqrt_w=sw,
        L_B=L_B, a_hat=a_hat, grad_lik=grad, log_marginal=lml,
        newton_deltas=deltas,
    )


def predict_laplace(post: LaplacePosterior, xo):
    """Latent predictive mean/var plus the likelihood's predictive
    transform (R&W alg. 3.2): class-+1 probability for logistic,
    expected rate for Poisson.

    mean = k(xo)^T a_hat;  var = k(xo,xo) - ||L^-1 W^1/2 k(xo)||^2
    (a_hat, not the raw likelihood gradient — see LaplacePosterior).
    """
    xo = jnp.asarray(xo)
    from gaussian_processes_tpu.ops.blocked_cholesky import choose_solve

    with jax.default_matmul_precision("highest"):
        Ks = post.kernel(post.x, xo)  # (n, q)
        mean = jnp.matmul(Ks.T, post.a_hat, precision=_HI)
        v = choose_solve(post.x.shape[0])(
            post.L_B, post.sqrt_w[:, None] * Ks
        )
        var = post.kernel.kdiag(xo).astype(mean.dtype) \
            - jnp.sum(jnp.square(v), axis=0)
    var = jnp.maximum(var, 0.0)
    return mean, var, post.likelihood.predict(mean, var)


def log_marginal_laplace(
    kernel: Kernel, x, y, *, likelihood=None, num_iters: int = 20,
    jitter: float = 1e-6
) -> jax.Array:
    """The Laplace-approximate evidence alone — the differentiable
    objective for type-II MLE over the latent GP's hyperparameters."""
    return fit_laplace(
        kernel, x, y, likelihood=likelihood, num_iters=num_iters,
        jitter=jitter,
    ).log_marginal


def fit_laplace_mle(
    kernel_template: Kernel,
    x,
    y,
    *,
    likelihood=None,
    num_steps: int = 100,
    learning_rate: float = 0.05,
    newton_iters: int = 20,
    jitter: float = 1e-6,
):
    """Type-II MLE over log kernel params by Adam on the Laplace
    evidence (no noise parameter — the logistic link has none).
    Returns (LaplacePosterior at the optimum, losses)."""
    import optax

    x = jnp.asarray(x)
    y = jnp.asarray(y)
    u0 = jnp.log(kernel_template.params)

    def loss_fn(u):
        kern = kernel_template.with_params(jnp.exp(u))
        return -log_marginal_laplace(
            kern, x, y, likelihood=likelihood, num_iters=newton_iters,
            jitter=jitter,
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
    kern = kernel_template.with_params(jnp.exp(best_u))
    post = fit_laplace(
        kern, x, y, likelihood=likelihood, num_iters=newton_iters,
        jitter=jitter,
    )
    return post, losses
