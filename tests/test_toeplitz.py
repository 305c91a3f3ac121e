"""Toeplitz/FFT structured path tests (uniform-grid inputs).

Gates: FFT matvec vs the dense kernel matrix product (exact to FFT
round-off in f64); circulant preconditioner applies (C_s + sI)^-1
correctly and accelerates CG; fit/grad/predict through
``structure="toeplitz"`` match the dense and strip paths.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gaussian_processes_tpu import (
    GaussianKernel,
    Matern32Kernel,
    PeriodicKernel,
    fit,
    fit_iterative,
    log_marginal_value_and_grad,
    log_marginal_value_and_grad_iterative,
    predict_diag,
    predict_diag_iterative,
)
from gaussian_processes_tpu.ops import krylov, toeplitz

# slow tier (VERDICT r2 item 8): minutes-long on 4 host cores; run via
# `make test-all` / CI. The default `make test` gate stays < 10 min.
pytestmark = pytest.mark.slow


def _grid(n, lo=-2.0, hi=2.0):
    return jnp.linspace(lo, hi, n, dtype=jnp.float64)


KERNELS = [
    GaussianKernel(h=1.2, w=0.4),
    Matern32Kernel(h=0.9, w=0.6),
    PeriodicKernel(h=1.0, w=0.8, p=0.9),
]


def test_is_uniform_grid():
    assert toeplitz.is_uniform_grid(np.linspace(0, 1, 64))
    assert not toeplitz.is_uniform_grid(np.sort(np.random.default_rng(0).uniform(0, 1, 64)))
    assert not toeplitz.is_uniform_grid(np.zeros((4, 2)))


@pytest.mark.parametrize("kernel", KERNELS, ids=lambda k: type(k).__name__)
def test_toeplitz_matvec_matches_dense(kernel):
    n = 129  # odd size exercises the irfft length handling
    x = _grid(n)
    rng = np.random.default_rng(1)
    v = jnp.asarray(rng.standard_normal((n, 3)))
    K = kernel(x, x)
    want = K @ v + 0.3 * v
    got = toeplitz.kernel_matvec_toeplitz(
        kernel, x, v, noise=jnp.sqrt(0.3 - 1e-4), jitter=1e-4
    )
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=1e-9)
    # 1-D rhs path
    got1 = toeplitz.toeplitz_matvec(
        toeplitz.toeplitz_column(kernel, x), v[:, 0], 0.3
    )
    np.testing.assert_allclose(np.asarray(got1), np.asarray(want[:, 0]), atol=1e-9)


def test_jacobian_columns_are_toeplitz_columns():
    kernel = GaussianKernel(h=1.1, w=0.5)
    x = _grid(64)
    J = kernel.jacobian(x, x)  # (P, n, n)
    jcols = toeplitz.jacobian_columns(kernel, x)
    rng = np.random.default_rng(2)
    v = jnp.asarray(rng.standard_normal(64))
    for p in range(2):
        want = J[p] @ v
        got = toeplitz.toeplitz_matvec(jcols[p], v)
        np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=1e-9)


def test_strang_precond_is_inverse_of_circulant():
    kernel = GaussianKernel(h=1.0, w=0.3)
    x = _grid(128)
    col = toeplitz.toeplitz_column(kernel, x)
    n = col.shape[0]
    idx = np.arange(n)
    wrap = np.where(idx <= n // 2, idx, n - idx)
    cs = np.asarray(col)[wrap]
    C = np.empty((n, n))
    for i in range(n):
        C[i] = np.roll(cs, i)
    s = 0.25
    apply = toeplitz.strang_circulant_precond(col, s)
    rng = np.random.default_rng(3)
    v = jnp.asarray(rng.standard_normal((n, 2)))
    got = apply(v)
    want = np.linalg.solve(C + s * np.eye(n), np.asarray(v))
    np.testing.assert_allclose(np.asarray(got), want, atol=1e-8)


def test_circulant_precond_accelerates_cg():
    kernel = GaussianKernel(h=1.0, w=0.5)
    x = _grid(256)
    col = toeplitz.toeplitz_column(kernel, x)
    shift = 1e-2
    mv = lambda v: toeplitz.toeplitz_matvec(col, v, shift)  # noqa: E731
    rng = np.random.default_rng(4)
    b = jnp.asarray(rng.standard_normal((256, 1)))
    _, rn_plain = krylov.pcg(mv, lambda v: v, b, num_iters=25, tol=1e-14)
    pre = toeplitz.strang_circulant_precond(col, shift)
    _, rn_pre = krylov.pcg(mv, pre, b, num_iters=25, tol=1e-14)
    assert float(rn_pre[0]) < 0.1 * float(rn_plain[0]), (
        float(rn_pre[0]),
        float(rn_plain[0]),
    )


def test_circulant_half_power_squares_to_apply():
    kernel = GaussianKernel(h=1.0, w=0.4)
    x = _grid(96)
    col = toeplitz.toeplitz_column(kernel, x)
    s = 0.2
    lam = toeplitz.circulant_eigenvalues(col, s)
    half = toeplitz._circulant_apply(lam, 96, 0.5)
    one = toeplitz._circulant_apply(lam, 96, 1.0)
    rng = np.random.default_rng(8)
    v = jnp.asarray(rng.standard_normal((96, 2)))
    np.testing.assert_allclose(
        np.asarray(half(half(v))), np.asarray(one(v)), atol=1e-10
    )
    # and logdet from the rfft spectrum matches a dense materialization
    # of the SAME operator (kernel spectrum rectified at 0, noise added
    # after — the round-4 additive definition), reconstructed from the
    # rectified full-fft spectrum
    n = 96
    idx = np.arange(n)
    wrap = np.where(idx <= n // 2, idx, n - idx)
    cs = np.asarray(col)[wrap]
    lam_full = np.maximum(np.fft.fft(cs).real, 0.0) + s
    cs_rect = np.fft.ifft(lam_full).real
    C = np.empty((n, n))
    for i in range(n):
        C[i] = np.roll(cs_rect, i)
    want = np.linalg.slogdet(C)[1]
    got = float(toeplitz.circulant_logdet(lam, n))
    np.testing.assert_allclose(got, want, rtol=1e-10)


def test_slq_logdet_circulant_accuracy():
    kernel = GaussianKernel(h=1.0, w=0.4)
    n = 256
    x = _grid(n)
    col = toeplitz.toeplitz_column(kernel, x)
    s = 0.09  # noise^2 + jitter
    mv = lambda v: toeplitz.toeplitz_matvec(col, v, s)  # noqa: E731
    K = np.asarray(kernel(x, x)) + s * np.eye(n)
    want = np.linalg.slogdet(K)[1]
    got = float(toeplitz.slq_logdet_circulant(
        mv, col, s, jax.random.key(0), num_probes=32, num_iters=80
    ))
    assert abs(got - want) < 0.01 * abs(want) + 0.5, (got, want)


def _circle_grid(n, circumference=4.0, lo=-2.0):
    """Endpoint-exclusive uniform grid: the circulant model's circle
    closes exactly at x[0] + circumference."""
    return jnp.asarray(np.arange(n) * (circumference / n) + lo)


def _periodic_data(n, noise=0.2, seed=7):
    """3 exact cycles on the circle — boundary-compatible with the
    circulant model."""
    x = _circle_grid(n)
    rng = np.random.default_rng(seed)
    sig = np.sin(2 * np.pi * 3 * np.asarray(x) / 4.0)
    return x, jnp.asarray(sig + noise * rng.standard_normal(n))


def test_whittle_lml_tracks_dense_on_periodic_data():
    """Circle-compatible data: the Whittle gap must be O(1) nats total
    (NOT growing with n) — measured |gap| was 0.85 / 2.4 at n=1024/4096
    vs 26 / 111 for seam-mismatched data."""
    kernel = GaussianKernel(h=1.2, w=0.1)
    from gaussian_processes_tpu.models.gp import log_marginal_likelihood

    for n in (1024, 4096):
        x, y = _periodic_data(n)
        lml_w = float(toeplitz.whittle_log_marginal(kernel, x, y, 0.2, 1e-8))
        lml_d = float(log_marginal_likelihood(kernel, x, y, 0.2, 1e-8))
        assert abs(lml_w - lml_d) < 10.0, (n, lml_w, lml_d)


def test_whittle_gradient_tracks_analytic_on_periodic_data():
    n = 4096
    x, y = _periodic_data(n, seed=8)

    def f(theta):
        k = GaussianKernel(h=theta[0], w=theta[1])
        return toeplitz.whittle_log_marginal(k, x, y, theta[2], 1e-8)

    kernel = GaussianKernel(h=1.0, w=0.12)
    g_w = jax.grad(f)(jnp.asarray([1.0, 0.12, 0.2]))
    _, g_a = log_marginal_value_and_grad(kernel, x, y, 0.2, jitter=1e-8)
    np.testing.assert_allclose(np.asarray(g_w), np.asarray(g_a),
                               rtol=0.05, atol=40.0)


def test_whittle_seam_bias_is_detected():
    """Non-periodic data on the same grid: the gap must be much larger —
    this is the measured boundary caveat documented in
    whittle_log_marginal's docstring."""
    kernel = GaussianKernel(h=1.0, w=0.12)
    from gaussian_processes_tpu.models.gp import log_marginal_likelihood

    n = 1024
    x = _circle_grid(n)
    rng = np.random.default_rng(9)
    y_per = jnp.asarray(np.sin(2 * np.pi * 3 * np.asarray(x) / 4.0)
                        + 0.2 * rng.standard_normal(n))
    y_seam = jnp.asarray(np.sin(6 * np.asarray(x))
                         + 0.2 * rng.standard_normal(n))
    gaps = {}
    for tag, y in (("periodic", y_per), ("seam", y_seam)):
        lml_w = float(toeplitz.whittle_log_marginal(kernel, x, y, 0.2, 1e-8))
        lml_d = float(log_marginal_likelihood(kernel, x, y, 0.2, 1e-8))
        gaps[tag] = abs(lml_w - lml_d)
    assert gaps["seam"] > 5.0 * gaps["periodic"], gaps


def test_whittle_posterior_matches_dense_log_posterior():
    from gaussian_processes_tpu.inference import (
        make_log_posterior,
        make_log_posterior_whittle,
    )

    n = 2048
    x, y = _periodic_data(n, seed=9)
    kernel = GaussianKernel(h=1.0, w=0.12)
    lp_w = make_log_posterior_whittle(kernel, x, y, prior_std=1.0,
                                      jitter=1e-8, center=False)
    lp_c = make_log_posterior_whittle(kernel, x, y, prior_std=1.0,
                                      jitter=1e-8, center=True)
    lp_d = make_log_posterior(kernel, x, y, prior_std=1.0, jitter=1e-8)
    u0 = jnp.log(jnp.asarray([1.0, 0.12, 0.2]))
    shifts = []
    for du in (jnp.zeros(3), jnp.asarray([0.2, -0.1, 0.1]),
               jnp.asarray([-0.3, 0.2, -0.2])):
        u = u0 + du
        vw, gw = jax.value_and_grad(lp_w)(u)
        vc, gc = jax.value_and_grad(lp_c)(u)
        vd, gd = jax.value_and_grad(lp_d)(u)
        # uncentered Whittle matches the dense posterior in VALUE
        assert abs(float(vw) - float(vd)) < 0.01 * abs(float(vd)) + 20.0
        # both variants match the dense posterior in GRADIENT
        np.testing.assert_allclose(np.asarray(gw), np.asarray(gd),
                                   rtol=0.1, atol=20.0)
        np.testing.assert_allclose(np.asarray(gc), np.asarray(gd),
                                   rtol=0.1, atol=20.0)
        # the centered variant differs from the uncentered by a constant
        shifts.append(float(vc) - float(vw))
    assert max(shifts) - min(shifts) < 1e-6 * (1.0 + abs(shifts[0]))


def test_fit_iterative_toeplitz_matches_dense():
    kernel = GaussianKernel(h=1.0, w=0.35)
    n = 200
    x = _grid(n)
    rng = np.random.default_rng(5)
    y = jnp.asarray(
        np.sin(3 * np.asarray(x)) + 0.2 * rng.standard_normal(n)
    )
    dense = fit(kernel, x, y, 0.2, jitter=1e-8)
    it = fit_iterative(
        kernel, x, y, 0.2, jax.random.key(0),
        num_probes=32, num_iters=200, tol=1e-12, jitter=1e-8,
        structure="toeplitz",
    )
    np.testing.assert_allclose(
        np.asarray(it.alpha), np.asarray(dense.alpha), atol=1e-7
    )
    # SLQ logdet is stochastic: sub-percent of the exact value
    assert abs(float(it.log_marginal) - float(dense.log_marginal)) < 0.01 * abs(
        float(dense.log_marginal)
    )
    xo = _grid(33, -1.5, 1.5)
    m_d, v_d = predict_diag(dense, xo)
    m_i, v_i = predict_diag_iterative(
        it, xo, num_iters=200, tol=1e-12, jitter=1e-8, structure="toeplitz"
    )
    np.testing.assert_allclose(np.asarray(m_i), np.asarray(m_d), atol=1e-7)
    np.testing.assert_allclose(np.asarray(v_i), np.asarray(v_d), atol=1e-6)


def test_value_and_grad_toeplitz_matches_strip_and_dense():
    kernel = Matern32Kernel(h=0.9, w=0.5)
    n = 160
    x = _grid(n)
    rng = np.random.default_rng(6)
    y = jnp.asarray(
        np.sin(2 * np.asarray(x)) + 0.3 * rng.standard_normal(n)
    )
    key = jax.random.key(9)
    lml_t, g_t = log_marginal_value_and_grad_iterative(
        kernel, x, y, 0.3, key,
        num_probes=16, num_iters=200, tol=1e-12, jitter=1e-8,
        structure="toeplitz",
    )
    lml_s, g_s = log_marginal_value_and_grad_iterative(
        kernel, x, y, 0.3, key,
        num_probes=16, num_iters=200, tol=1e-12, jitter=1e-8,
    )
    # same Rademacher probes, converged solves => identical Hutchinson
    # gradients (the logdet estimators differ: circulant-preconditioned
    # SLQ vs plain-CG SLQ, both unbiased)
    np.testing.assert_allclose(np.asarray(g_t), np.asarray(g_s), rtol=1e-6, atol=1e-8)
    # both lml estimates and the gradient sit near the analytic values
    lml_a, g_a = log_marginal_value_and_grad(kernel, x, y, 0.3, jitter=1e-8)
    assert abs(float(lml_t) - float(lml_a)) < 0.02 * abs(float(lml_a)) + 2.0
    assert abs(float(lml_s) - float(lml_a)) < 0.02 * abs(float(lml_a)) + 2.0
    np.testing.assert_allclose(np.asarray(g_t), np.asarray(g_a), rtol=0.3, atol=0.5)


def test_pathwise_iterative_toeplitz_matches_plain():
    from gaussian_processes_tpu import (
        sample_posterior_pathwise_iterative,
    )

    kernel = GaussianKernel(h=1.0, w=0.5)
    n = 120
    x = _grid(n)
    rng = np.random.default_rng(7)
    y = jnp.asarray(
        np.sin(2 * np.asarray(x)) + 0.2 * rng.standard_normal(n)
    )
    post = fit_iterative(
        kernel, x, y, 0.2, jax.random.key(0),
        num_probes=4, num_iters=150, tol=1e-12, jitter=1e-8,
    )
    xo = _grid(9, -1.0, 1.0)
    key = jax.random.key(3)
    d_plain = sample_posterior_pathwise_iterative(
        post, xo, key, n_samples=4, num_features=256,
        num_iters=200, tol=1e-13, jitter=1e-8, block_size=32,
    )
    d_toep = sample_posterior_pathwise_iterative(
        post, xo, key, n_samples=4, num_features=256,
        num_iters=200, tol=1e-13, jitter=1e-8, structure="toeplitz",
    )
    np.testing.assert_allclose(
        np.asarray(d_plain), np.asarray(d_toep), atol=1e-7
    )


def test_whittle_mle_recovers_hyperparameters():
    """Type-II MLE on the Whittle objective (fit_mle(objective="whittle"))
    recovers the dense-MLE optimum within the measured Whittle gap on
    periodic-compatible grid data."""
    from gaussian_processes_tpu.inference.mle import fit_mle

    n = 2048
    x, y = _periodic_data(n, noise=0.2, seed=12)
    k0 = GaussianKernel(h=0.5, w=0.3)
    res_w = fit_mle(k0, x, y, 0.5, num_steps=60, method="adam",
                    learning_rate=0.05, jitter=1e-8, objective="whittle")
    res_d = fit_mle(k0, x, y, 0.5, num_steps=60, method="adam",
                    learning_rate=0.05, jitter=1e-8)
    # noise is the sharpest-identified parameter at n=2048
    np.testing.assert_allclose(float(res_w.noise), float(res_d.noise),
                               rtol=0.05)
    # (h, w) sit on a soft ridge — gate the QUALITY of the whittle
    # optimum under the exact dense lml instead of parameter equality
    from gaussian_processes_tpu.models.gp import log_marginal_likelihood

    lml_at_w = float(log_marginal_likelihood(
        res_w.kernel, x, y, res_w.noise, 1e-8))
    lml_at_d = float(log_marginal_likelihood(
        res_d.kernel, x, y, res_d.noise, 1e-8))
    assert lml_at_w > lml_at_d - 5.0, (lml_at_w, lml_at_d)


def test_whittle_centered_objective_is_constant_shift():
    """center=True must change the posterior by exactly a constant:
    differences across points and gradients identical (f64 gate; the
    centering exists to restore f32 resolution at |lml| ~ 1e6)."""
    from gaussian_processes_tpu.inference import make_log_posterior_whittle

    n = 2048
    x, y = _periodic_data(n, seed=14)
    kernel = GaussianKernel(h=1.0, w=0.12)
    mu = jnp.log(jnp.asarray([0.9, 0.15, 0.25]))
    lp_c = make_log_posterior_whittle(kernel, x, y, prior_mean=mu,
                                      prior_std=1.0, jitter=1e-8, center=True)
    lp_u = make_log_posterior_whittle(kernel, x, y, prior_mean=mu,
                                      prior_std=1.0, jitter=1e-8, center=False)
    u1 = mu + jnp.asarray([0.1, -0.05, 0.08])
    u2 = mu + jnp.asarray([-0.2, 0.1, -0.1])
    d_c = float(lp_c(u1)) - float(lp_c(u2))
    d_u = float(lp_u(u1)) - float(lp_u(u2))
    np.testing.assert_allclose(d_c, d_u, rtol=1e-9)
    g_c = jax.grad(lp_c)(u1)
    g_u = jax.grad(lp_u)(u1)
    np.testing.assert_allclose(np.asarray(g_c), np.asarray(g_u), rtol=1e-9)
    # and at the center the shifted density equals just the prior term (0)
    np.testing.assert_allclose(float(lp_c(mu)), 0.0, atol=1e-8)


def test_spectral_density_closed_forms_match_fft_oracle():
    # the analytic Poisson-sum spectrum must match the f64 FFT of the
    # wrapped sampled column wherever the kernel decays well inside
    # n/2 cells (there wrap == periodization): validates the SE and
    # Matern closed-form constants in ops/toeplitz.py::spectral_density
    from gaussian_processes_tpu.models.composite import SumKernel
    from gaussian_processes_tpu.models.matern import (
        Matern32Kernel,
        Matern52Kernel,
    )

    n = 512
    x = jnp.asarray(np.arange(n) * (4.0 / n) - 2.0)  # dx small vs w
    # lengthscales small vs the domain half-width (2.0): the Matern
    # families decay only exponentially (polynomial spectra), so the
    # Strang wrap equals the periodization only when k(L/2) is
    # negligible — w <= 0.12 puts the wrap error below the 1e-4 gate
    kernels = [
        GaussianKernel(h=1.3, w=0.25),
        Matern32Kernel(h=0.9, w=0.1),
        Matern52Kernel(h=1.1, w=0.12),
        SumKernel(GaussianKernel(h=1.0, w=0.3),
                  Matern32Kernel(h=0.5, w=0.1)),
    ]
    for kern in kernels:
        s2 = 0.09
        lam_fft = np.asarray(toeplitz.circulant_eigenvalues(
            toeplitz.toeplitz_column(kern, x), s2))
        # DEFAULT alias count: this is the configuration whittle_spectrum
        # "auto" ships (ADVICE r4: the old aliases=2 default was ~1.5e-3
        # off in Matern-3/2 tail bins while only aliases=8 was gated)
        lam_an = toeplitz.circulant_eigenvalues_analytic(kern, x, s2)
        assert lam_an is not None
        lam_an = np.asarray(lam_an)
        # compare where the spectrum is resolvable by the FFT (Matern
        # tails decay polynomially, SE super-exponentially; everything
        # above 1e-8 of the peak must agree to ~1e-5 relative)
        mask = lam_fft > 1e-8 * lam_fft.max()
        rel = np.abs(lam_an - lam_fft)[mask] / lam_fft[mask]
        assert rel.max() < 1e-4, (type(kern).__name__, rel.max())
    # unsupported families fall back (None), and whittle_spectrum routes
    assert toeplitz.spectral_density(
        PeriodicKernel(h=1.0, w=1.0, p=0.9), 0.0) is None


def test_whittle_analytic_noise_identifiable_at_scale_f32():
    # ROUND-4 REGRESSION GATE: at large n the f32 FFT spectrum of an SE
    # column has round-off garbage ~eps * lam_max in its tail, and the
    # old relative clamp floored the model spectrum at ~1e-2 — erasing
    # the noise parameter from the high-frequency bins entirely (the
    # measured 1M-point failure: lp INCREASED as s -> 0, chains slid to
    # s ~ 0.01 at lp +18k; round-4 forensics).  The analytic
    # spectrum keeps s^2 exact in every bin: the Whittle lml profile
    # over s must peak at the generative noise.
    from gaussian_processes_tpu.inference import make_log_posterior_whittle

    n = 1 << 16
    rng = np.random.default_rng(0)
    x = (np.arange(n) * (2 * np.pi / n) - np.pi).astype(np.float32)
    y = (np.sin(50 * x) + 0.1 * rng.standard_normal(n)).astype(np.float32)
    k0 = GaussianKernel(h=jnp.asarray(0.7, jnp.float32),
                        w=jnp.asarray(0.04, jnp.float32))
    u0 = np.log(np.array([0.7, 0.04, 0.1], dtype=np.float32))
    lp = make_log_posterior_whittle(k0, x, y, prior_mean=jnp.asarray(u0),
                                    prior_std=1.0, jitter=1e-6)
    svals = np.array([0.4, 0.2, 0.1, 0.05, 0.025, 0.0125])
    lps = []
    for s in svals:
        u = np.log(np.array([0.7, 0.04, s], dtype=np.float32))
        lps.append(float(lp(jnp.asarray(u))))
    best = svals[int(np.argmax(lps))]
    assert best == 0.1, list(zip(svals.tolist(), lps))
    # and s below truth must be heavily punished (the old clamp made
    # this direction nearly flat or IMPROVING)
    assert lps[2] - lps[-1] > 1e4, lps


def test_periodic_line_spectrum_matches_fft_at_commensurate_period():
    # ROUND-5 (VERDICT r4 item 4): the periodic kernel is a line
    # spectrum; when the period is grid-commensurate every harmonic
    # falls on an exact rfft bin, the kernel is L-periodic (wrap ==
    # identity), and the analytic folded spectrum must equal the f64
    # FFT of the column — the same oracle discipline as the SE/Matern
    # closed forms above.
    n = 512
    L = 4.0
    x = jnp.asarray(np.arange(n) * (L / n) - 2.0)
    # first harmonic on bin 10: t_1 = L / (2 pi p) = 10
    p = L / (2.0 * np.pi * 10.0)
    for w in (0.5, 0.25):
        kern = PeriodicKernel(h=1.1, w=w, p=p)
        s2 = 0.09
        lam_fft = np.asarray(toeplitz.circulant_eigenvalues(
            toeplitz.toeplitz_column(kern, x), s2))
        lam_an = toeplitz.circulant_eigenvalues_analytic(kern, x, s2)
        assert lam_an is not None
        lam_an = np.asarray(lam_an)
        mask = lam_fft > 1e-10 * lam_fft.max()
        rel = np.abs(lam_an - lam_fft)[mask] / lam_fft[mask]
        assert rel.max() < 1e-6, (w, rel.max())
    # quasi-periodic sum (SE + periodic) stays analytic and exact too
    from gaussian_processes_tpu.models.composite import SumKernel
    kern = SumKernel(GaussianKernel(h=0.8, w=0.3),
                     PeriodicKernel(h=1.0, w=0.5, p=p))
    lam_fft = np.asarray(toeplitz.circulant_eigenvalues(
        toeplitz.toeplitz_column(kern, x), 0.04))
    lam_an = toeplitz.circulant_eigenvalues_analytic(kern, x, 0.04)
    assert lam_an is not None
    lam_an = np.asarray(lam_an)
    mask = lam_fft > 1e-8 * lam_fft.max()
    rel = np.abs(lam_an - lam_fft)[mask] / lam_fft[mask]
    assert rel.max() < 1e-4, rel.max()


def test_periodic_line_spectrum_mass_and_gradient():
    # incommensurate period: lines split linearly between neighboring
    # bins.  Two invariants: (a) total model variance is exactly k(0)
    # (the mass bookkeeping across multiplicities), (b) the Whittle lml
    # is differentiable in the PERIOD with a finite, nonzero gradient
    # that matches finite differences away from bin crossings — the
    # property the FFT spectrum path delivered and the line model must
    # keep for p-inference.
    n = 256
    x = jnp.asarray(np.arange(n) * (4.0 / n) - 2.0)
    kern = PeriodicKernel(h=1.3, w=0.6, p=0.173)  # incommensurate
    lam_k = toeplitz.periodic_line_bins(kern, n, float(x[1] - x[0]))
    lam_k = np.asarray(lam_k)
    assert (lam_k >= 0).all()
    mult = np.full(n // 2 + 1, 2.0)
    mult[0] = 1.0
    mult[-1] = 1.0
    var = float((mult * lam_k).sum() / n)
    k0 = float(kern(x[:1], x[:1])[0, 0])
    np.testing.assert_allclose(var, k0, rtol=1e-10)

    rng = np.random.default_rng(0)
    y = jnp.asarray(rng.standard_normal(n))

    def lml_of_p(p):
        kp = PeriodicKernel(h=kern.h, w=kern.w, p=p)
        return toeplitz.whittle_log_marginal(kp, x, y, 0.3)

    p0 = jnp.asarray(0.173, jnp.float64)
    g = float(jax.grad(lml_of_p)(p0))
    assert np.isfinite(g) and g != 0.0
    eps = 1e-7
    fd = (float(lml_of_p(p0 + eps)) - float(lml_of_p(p0 - eps))) / (2 * eps)
    np.testing.assert_allclose(g, fd, rtol=1e-3)


def test_whittle_periodic_noise_identifiable_at_scale_f32():
    # ROUND-5 GATE (VERDICT r4 item 4): the round-4 fix made SE noise
    # identifiable at scale; the reference's flagship PERIODIC kernel
    # went through the silent FFT fallback — the exact path whose f32
    # round-off tail manufactured the spurious noise mode.  With the
    # folded line spectrum the profile over s must peak at the
    # generative noise, mirroring
    # test_whittle_analytic_noise_identifiable_at_scale_f32.
    from gaussian_processes_tpu.inference import make_log_posterior_whittle

    n = 1 << 16
    rng = np.random.default_rng(0)
    x = (np.arange(n) * (2 * np.pi / n) - np.pi).astype(np.float32)
    y = (np.sin(50 * x) + 0.1 * rng.standard_normal(n)).astype(np.float32)
    # data period 2 pi / 50 = kernel period 2 pi p  =>  p = 1/50
    k0 = PeriodicKernel(h=jnp.asarray(0.7, jnp.float32),
                        w=jnp.asarray(1.0, jnp.float32),
                        p=jnp.asarray(0.02, jnp.float32))
    u0 = np.log(np.array([0.7, 1.0, 0.02, 0.1], dtype=np.float32))
    lp = make_log_posterior_whittle(k0, x, y, prior_mean=jnp.asarray(u0),
                                    prior_std=1.0, jitter=1e-6)
    svals = np.array([0.4, 0.2, 0.1, 0.05, 0.025, 0.0125])
    lps = []
    for s in svals:
        u = np.log(np.array([0.7, 1.0, 0.02, s], dtype=np.float32))
        lps.append(float(lp(jnp.asarray(u))))
    best = svals[int(np.argmax(lps))]
    assert best == 0.1, list(zip(svals.tolist(), lps))
    assert lps[2] - lps[-1] > 1e4, lps


def test_circulant_spectrum_shift_zero_is_finite():
    # ADVICE r4: noise=0, jitter=0 is user-reachable; rectified bins
    # are exactly 0 there and the preconditioner/logdet previously
    # went inf/nan.  The absolute tiny floor keeps everything finite.
    kern = GaussianKernel(h=1.0, w=0.4)
    x = _grid(128)
    col = toeplitz.toeplitz_column(kern, x)
    lam = toeplitz.circulant_eigenvalues(col, 0.0)
    assert bool(jnp.all(lam > 0))
    P = toeplitz.strang_circulant_precond(col, 0.0)
    v = jnp.ones(128, jnp.float64)
    assert bool(jnp.all(jnp.isfinite(P(v))))
    lam_an = toeplitz.circulant_eigenvalues_analytic(kern, x, 0.0)
    assert bool(jnp.all(lam_an > 0))
    assert bool(jnp.isfinite(toeplitz.circulant_logdet(lam, 128)))


def test_quasi_periodic_product_spectrum_matches_fft_oracle():
    # ROUND-5: the quasi-periodic PRODUCT kernel (SE x periodic — the
    # classic decaying-periodicity time-series model) has the
    # closed-form spectrum sum_q (a_q/2)[S_se(o - nu_q) + S_se(o + nu_q)]
    # (line spectrum convolved with the SE density).  Gate it against
    # the f64 FFT of the sampled wrapped column, same discipline as the
    # other closed forms; the period is deliberately incommensurate
    # (the product spectrum is continuous — no bin splitting involved).
    from gaussian_processes_tpu.models.composite import ProductKernel

    n = 512
    x = jnp.asarray(np.arange(n) * (4.0 / n) - 2.0)
    for w_se, w_p, p in ((0.15, 0.6, 0.173), (0.3, 0.4, 0.291)):
        kern = ProductKernel(GaussianKernel(h=1.2, w=w_se),
                             PeriodicKernel(h=0.9, w=w_p, p=p))
        s2 = 0.04
        lam_fft = np.asarray(toeplitz.circulant_eigenvalues(
            toeplitz.toeplitz_column(kern, x), s2))
        lam_an = toeplitz.circulant_eigenvalues_analytic(kern, x, s2)
        assert lam_an is not None
        lam_an = np.asarray(lam_an)
        mask = lam_fft > 1e-8 * lam_fft.max()
        rel = np.abs(lam_an - lam_fft)[mask] / lam_fft[mask]
        assert rel.max() < 1e-4, (w_se, w_p, p, rel.max())
    # factor order must not matter, and continuous x continuous stays None
    k_rev = ProductKernel(PeriodicKernel(h=0.9, w=0.6, p=0.173),
                          GaussianKernel(h=1.2, w=0.15))
    lam_rev = toeplitz.circulant_eigenvalues_analytic(k_rev, x, 0.04)
    assert lam_rev is not None
    k_cc = ProductKernel(GaussianKernel(h=1.0, w=0.3),
                         Matern32Kernel(h=1.0, w=0.4))
    assert toeplitz.circulant_eigenvalues_analytic(k_cc, x, 0.04) is None


def test_whittle_mle_recovers_periodic_hyperparameters():
    # ROUND-5: type-II MLE through the analytic LINE spectrum.  Period
    # likelihoods are combs: the basin around the true period is ~a few
    # spectral bins wide and cliffs by ~1e5 nats outside it (measured
    # here: p=0.0205 vs truth 0.02 is -135k nats at n=8192 — a property
    # of ANY GP period likelihood, dense included, not of the line
    # spectrum).  The supported workflow is periodogram-peak
    # initialization (bin-level accuracy ~1/n relative); this gate
    # starts p 0.1% off — ~8 bins of slack at this n — plus h/w/s
    # 10-20% off, and requires noise + period recovery.
    from gaussian_processes_tpu.inference.mle import fit_mle

    n = 8192
    rng = np.random.default_rng(3)
    x = (np.arange(n) * (2 * np.pi / n) - np.pi)
    y = np.sin(50 * x) + 0.1 * rng.standard_normal(n)
    # generative: period 2 pi p = 2 pi / 50  =>  p = 0.02
    k0 = PeriodicKernel(h=jnp.asarray(0.8), w=jnp.asarray(1.1),
                        p=jnp.asarray(0.02002))
    res = fit_mle(k0, jnp.asarray(x), jnp.asarray(y), 0.12,
                  objective="whittle", jitter=1e-8, num_steps=300,
                  method="adam", learning_rate=0.01)
    s_hat = float(res.noise)
    p_hat = float(res.kernel.p)
    assert abs(s_hat - 0.1) < 0.01, s_hat
    assert abs(p_hat - 0.02) < 2e-4, p_hat
    assert np.isfinite(float(res.log_marginal))
