"""ARD kernel tests: derivative contract vs autodiff/finite differences,
D=1 equivalence with the isotropic kernel, and end-to-end fit/MLE/NUTS on
multi-dimensional inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gaussian_processes_tpu import GaussianKernel, fit, predict_diag
from gaussian_processes_tpu.models.ard import ARDGaussianKernel
from gaussian_processes_tpu.utils.testing import approx_deriv


def _kernel(D=3, seed=0):
    rng = np.random.default_rng(seed)
    return ARDGaussianKernel(
        h=jnp.float64(1.3), w=jnp.asarray(rng.uniform(0.5, 2.0, D))
    )


def _xs(n=9, m=7, D=3, seed=1):
    rng = np.random.default_rng(seed)
    return rng.uniform(-2, 2, (n, D)), rng.uniform(-2, 2, (m, D))


def test_ard_d1_matches_isotropic():
    x1, x2 = _xs(D=1)
    k_ard = ARDGaussianKernel(h=jnp.float64(1.2), w=jnp.asarray([0.7]))
    k_iso = GaussianKernel(h=jnp.float64(1.2), w=jnp.float64(0.7))
    np.testing.assert_allclose(
        np.asarray(k_ard(x1, x2)), np.asarray(k_iso(x1[:, 0], x2[:, 0])),
        rtol=1e-14,
    )
    J_ard = k_ard.jacobian(x1, x2)
    J_iso = k_iso.jacobian(x1[:, 0], x2[:, 0])
    np.testing.assert_allclose(np.asarray(J_ard), np.asarray(J_iso), rtol=1e-13)
    H_ard = k_ard.hessian(x1, x2)
    H_iso = k_iso.hessian(x1[:, 0], x2[:, 0])
    np.testing.assert_allclose(np.asarray(H_ard), np.asarray(H_iso), rtol=1e-12)


def test_ard_jacobian_hessian_match_autodiff():
    k = _kernel()
    x1, x2 = _xs()
    t0 = k.params

    def k_of_theta(t):
        return k.with_params(t)(x1, x2)

    J = k.jacobian(x1, x2)
    autoJ = jnp.moveaxis(jax.jacobian(k_of_theta)(t0), -1, 0)
    np.testing.assert_allclose(np.asarray(J), np.asarray(autoJ), rtol=1e-9, atol=1e-12)

    H = k.hessian(x1, x2)
    autoH = jnp.moveaxis(jax.hessian(k_of_theta)(t0), (-2, -1), (0, 1))
    np.testing.assert_allclose(np.asarray(H), np.asarray(autoH), rtol=1e-8, atol=1e-11)

    numJ = approx_deriv(lambda t: k.with_params(t)(x1, x2), np.asarray(t0))
    np.testing.assert_allclose(np.asarray(J), numJ, rtol=1e-3, atol=1e-6)


def test_ard_fit_predict_and_lml_gradients():
    rng = np.random.default_rng(3)
    n, D = 50, 2
    x = rng.uniform(-2, 2, (n, D))
    f = np.sin(2 * x[:, 0]) + 0.5 * x[:, 1]
    y = f + 0.1 * rng.standard_normal(n)
    k = ARDGaussianKernel(h=jnp.float64(1.0), w=jnp.asarray([1.0, 1.0]))
    post = fit(k, x, y, 0.2)
    assert np.isfinite(float(post.log_marginal))
    xo = rng.uniform(-2, 2, (20, D))
    mean, var = predict_diag(post, xo)
    assert mean.shape == (20,) and np.all(np.asarray(var) > 0)

    from gaussian_processes_tpu import (
        log_marginal_likelihood,
        log_marginal_value_and_grad,
    )

    lml, g = log_marginal_value_and_grad(k, x, y, 0.2)

    def f_of(t):
        return log_marginal_likelihood(k.with_params(t[:-1]), x, y, t[-1])

    auto = jax.grad(f_of)(jnp.concatenate([k.params, jnp.asarray([0.2])]))
    np.testing.assert_allclose(np.asarray(g), np.asarray(auto), rtol=1e-8, atol=1e-10)


def test_ard_mle_learns_relevance():
    # dim 0 matters, dim 1 is noise: MLE should drive w_1 >> w_0
    from gaussian_processes_tpu.inference import fit_mle

    rng = np.random.default_rng(4)
    n = 120
    x = rng.uniform(-2, 2, (n, 2))
    y = np.sin(2 * x[:, 0]) + 0.05 * rng.standard_normal(n)
    k = ARDGaussianKernel(h=jnp.float64(1.0), w=jnp.asarray([1.0, 1.0]))
    res = fit_mle(k, x, y, 0.2, num_steps=80)
    w = np.asarray(res.kernel.w)
    assert w[1] / w[0] > 3.0  # irrelevant dimension gets a long lengthscale


def test_ard_nuts_smoke():
    from gaussian_processes_tpu.inference import make_log_posterior, sample_nuts

    rng = np.random.default_rng(5)
    n = 30
    x = rng.uniform(-2, 2, (n, 2))
    y = np.sin(2 * x[:, 0]) + 0.1 * rng.standard_normal(n)
    k = ARDGaussianKernel(h=jnp.float64(1.0), w=jnp.asarray([1.0, 1.0]))
    log_post = make_log_posterior(k, x, y, prior_std=1.5)
    u0 = jnp.log(jnp.concatenate([k.params, jnp.asarray([0.2])]))
    init = u0[None, :] + 0.1 * jax.random.normal(jax.random.key(0), (4, 4))
    res = sample_nuts(log_post, init, jax.random.key(1),
                      num_warmup=100, num_samples=100, max_depth=6)
    draws = np.asarray(res.positions)
    assert np.all(np.isfinite(draws))
    assert float(np.asarray(res.diverging).mean()) < 0.1
