"""f32-vs-f64 numerical parity (SURVEY.md §7 hard part 4).

The accelerator speed path runs f32 with diagonal jitter; these gates quantify
the agreement with the f64 oracle at moderate N so the "matches the
reference within explicit tolerances" claim is backed by a number, not a
hope.  Tolerances are deliberately loose bounds on observed error
(~1e-3 relative on lml at N=2048 f32 with 1e-4 jitter).
"""

import jax
import jax.numpy as jnp
import numpy as np

from gaussian_processes_tpu import GaussianKernel, fit, predict_diag


def _data(n, dtype):
    rng = np.random.default_rng(0)
    x = np.sort(rng.uniform(-np.pi, np.pi, n)).astype(dtype)
    y = (np.sin(2 * x.astype(np.float64)) + 0.1 * rng.standard_normal(n)).astype(dtype)
    return x, y


def test_f32_fit_tracks_f64_oracle():
    n = 2048
    x64, y64 = _data(n, np.float64)
    k64 = GaussianKernel(h=jnp.float64(1.0), w=jnp.float64(1.0))
    post64 = fit(k64, x64, y64, 0.1, jitter=1e-4)

    x32, y32 = x64.astype(np.float32), y64.astype(np.float32)
    k32 = GaussianKernel(h=jnp.float32(1.0), w=jnp.float32(1.0))
    post32 = fit(k32, x32, y32, jnp.float32(0.1), jitter=1e-4)

    lml64 = float(post64.log_marginal)
    lml32 = float(post32.log_marginal)
    assert abs(lml32 - lml64) / abs(lml64) < 5e-3

    xo = np.linspace(-3, 3, 200)
    m64, v64 = predict_diag(post64, xo)
    m32, v32 = predict_diag(post32, xo.astype(np.float32))
    # predictive mean agrees to ~1e-3 absolute on unit-scale data
    assert float(jnp.max(jnp.abs(m32 - m64.astype(jnp.float32)))) < 5e-3
    # variances positive and within a loose band
    assert np.all(np.asarray(v32) > -1e-5)
    np.testing.assert_allclose(
        np.asarray(v32), np.asarray(v64), atol=5e-3, rtol=0.5
    )


def test_f32_gradients_usable_for_optimization():
    # analytic vs autodiff gradients agree in f32 well enough for MLE/NUTS
    from gaussian_processes_tpu import log_marginal_likelihood, log_marginal_value_and_grad

    n = 512
    x, y = _data(n, np.float32)
    k = GaussianKernel(h=jnp.float32(1.2), w=jnp.float32(0.8))
    _, g = log_marginal_value_and_grad(k, x, y, jnp.float32(0.15), jitter=1e-5)

    def f(t):
        return log_marginal_likelihood(k.with_params(t[:2]), x, y, t[2], jitter=1e-5)

    auto = jax.grad(f)(jnp.asarray([1.2, 0.8, 0.15], jnp.float32))
    denom = np.maximum(np.abs(np.asarray(auto)), 1.0)
    assert np.all(np.abs(np.asarray(g) - np.asarray(auto)) / denom < 2e-2)
