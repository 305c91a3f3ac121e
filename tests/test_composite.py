"""Sum/product kernel combinators: derivative contract vs autodiff and
finite differences (no sympy oracle for composites by design), plus
end-to-end fit/MLE with the quasi-periodic kernel.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gaussian_processes_tpu import GaussianKernel, PeriodicKernel, fit, predict_diag
from gaussian_processes_tpu.models.composite import ProductKernel, SumKernel
from gaussian_processes_tpu.utils.testing import approx_deriv, make_xo, make_xy


def _se(h=1.2, w=0.8):
    return GaussianKernel(h=jnp.float64(h), w=jnp.float64(w))


def _per(h=0.9, w=1.1, p=1.7):
    return PeriodicKernel(h=jnp.float64(h), w=jnp.float64(w), p=jnp.float64(p))


COMPOSITES = [
    SumKernel(_se(), _per()),
    ProductKernel(_se(), _per()),
    SumKernel(ProductKernel(_se(), _per()), _se(0.5, 2.0)),  # nested
]


@pytest.mark.parametrize("k", COMPOSITES, ids=["sum", "product", "nested"])
def test_composite_value_and_params_roundtrip(k):
    rng = np.random.default_rng(0)
    x1, x2 = rng.uniform(-3, 3, 7), rng.uniform(-3, 3, 5)
    K = k(x1, x2)
    # value equals manual combination
    if isinstance(k, SumKernel):
        np.testing.assert_allclose(K, k.k1(x1, x2) + k.k2(x1, x2), rtol=1e-14)
    elif isinstance(k, ProductKernel):
        np.testing.assert_allclose(K, k.k1(x1, x2) * k.k2(x1, x2), rtol=1e-14)
    # params roundtrip
    theta = np.asarray(k.params)
    k2 = k.with_params(theta * 1.1)
    np.testing.assert_allclose(np.asarray(k2.params), theta * 1.1, rtol=1e-12)
    np.testing.assert_allclose(np.asarray(k.params), theta, rtol=1e-15)
    assert k.n_params == theta.size
    # pytree: jit with composite as argument
    out = jax.jit(lambda kk: kk(x1, x2))(k)
    np.testing.assert_allclose(out, K, rtol=1e-14)


@pytest.mark.parametrize("k", COMPOSITES, ids=["sum", "product", "nested"])
def test_composite_jacobian_hessian_match_autodiff(k):
    rng = np.random.default_rng(1)
    x1, x2 = rng.uniform(-3, 3, 6), rng.uniform(-3, 3, 4)
    P = k.n_params
    t0 = k.params

    def k_of_theta(t):
        return k.with_params(t)(x1, x2)

    J = k.jacobian(x1, x2)
    autoJ = jnp.moveaxis(jax.jacobian(k_of_theta)(t0), -1, 0)
    np.testing.assert_allclose(np.asarray(J), np.asarray(autoJ), rtol=1e-9, atol=1e-11)

    H = k.hessian(x1, x2)
    autoH = jnp.moveaxis(jax.hessian(k_of_theta)(t0), (-2, -1), (0, 1))
    np.testing.assert_allclose(np.asarray(H), np.asarray(autoH), rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(np.asarray(H), np.asarray(jnp.swapaxes(H, 0, 1)),
                               rtol=1e-12, atol=1e-14)

    numJ = approx_deriv(lambda t: k.with_params(t)(x1, x2), np.asarray(t0))
    np.testing.assert_allclose(np.asarray(J), numJ, rtol=1e-3, atol=1e-5)


def test_quasiperiodic_fit_and_gradients_end_to_end():
    rng = np.random.default_rng(2)
    x, y = make_xy(rng, n=40, periodic=True)
    qp = ProductKernel(_se(1.0, 2.0), _per(1.0, 1.0, 1.6))
    post = fit(qp, x, y, 0.2)
    assert np.isfinite(float(post.log_marginal))
    mean, var = predict_diag(post, make_xo(20))
    assert np.all(np.isfinite(np.asarray(mean)))
    assert np.all(np.asarray(var) > 0)

    # analytic log-marginal gradient (stacked-Jacobian path) vs autodiff
    from gaussian_processes_tpu import (
        log_marginal_likelihood,
        log_marginal_value_and_grad,
    )

    lml, g = log_marginal_value_and_grad(qp, x, y, 0.2)

    def lml_of_theta(t):
        return log_marginal_likelihood(qp.with_params(t[:-1]), x, y, t[-1])

    auto = jax.grad(lml_of_theta)(
        jnp.concatenate([qp.params, jnp.asarray([0.2])])
    )
    np.testing.assert_allclose(np.asarray(g), np.asarray(auto), rtol=1e-8, atol=1e-10)
