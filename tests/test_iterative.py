"""Matrix-free iterative inference vs the dense Cholesky oracle.

Gates: the CG solve and predictive mean/variance must match the dense
path to solver tolerance; the SLQ log marginal within its Monte-Carlo
error; the stochastic gradient within Hutchinson error of the analytic
gradient.  All f64 on CPU so the only error sources are the estimators
themselves.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gaussian_processes_tpu import (
    GaussianKernel,
    fit,
    log_marginal_value_and_grad,
    predict_diag,
)
from gaussian_processes_tpu.models.iterative_gp import (
    fit_iterative,
    log_marginal_value_and_grad_iterative,
    predict_diag_iterative,
    predict_mean_iterative,
)
from gaussian_processes_tpu.ops import krylov
from gaussian_processes_tpu.utils.testing import make_xo, make_xy


def _problem(n=300, seed=0, noise=0.3):
    rng = np.random.default_rng(seed)
    x, y = make_xy(rng, n=n)
    kernel = GaussianKernel(h=jnp.float64(1.2), w=jnp.float64(0.6))
    return kernel, jnp.asarray(x), jnp.asarray(y), noise


def test_kernel_matvec_matches_dense():
    kernel, x, y, s = _problem(n=137)  # non-divisible by block
    from gaussian_processes_tpu import build_kxx

    K = build_kxx(kernel, x, s, jitter=1e-8)
    v = jnp.asarray(np.random.default_rng(1).standard_normal((137, 3)))
    got = krylov.kernel_matvec(kernel, x, v, s, jitter=1e-8, block_size=32)
    np.testing.assert_allclose(np.asarray(got), np.asarray(K @ v), rtol=1e-10, atol=1e-12)
    got1 = krylov.kernel_matvec(kernel, x, v[:, 0], s, jitter=1e-8, block_size=32)
    np.testing.assert_allclose(np.asarray(got1), np.asarray(K @ v[:, 0]), rtol=1e-10, atol=1e-12)


def test_kernel_matvec_fused_matches_dense():
    # interpreted Pallas twin of the strip matvec: leaf, composite,
    # and ARD kernels; (n,) and (n, r) right-hand sides; n not a
    # multiple of the tile (zero-padded edge tiles must not leak)
    from gaussian_processes_tpu import build_kxx
    from gaussian_processes_tpu.models.ard import ARDGaussianKernel
    from gaussian_processes_tpu.models.composite import ProductKernel
    from gaussian_processes_tpu.models.periodic import PeriodicKernel
    from gaussian_processes_tpu.ops.pairwise import (
        kernel_matvec_fused,
        supports_fused_matvec,
    )

    kernel, x, y, s = _problem(n=300)
    rng = np.random.default_rng(2)
    v = jnp.asarray(rng.standard_normal((300, 3)))
    for k in [
        kernel,
        ProductKernel(kernel, PeriodicKernel(h=1.0, w=1.3, p=2.0)),
    ]:
        assert supports_fused_matvec(k, x)
        K = build_kxx(k, x, s, jitter=1e-8)
        got = kernel_matvec_fused(k, x, v, s, 1e-8, block=(128, 128),
                                  interpret=True)
        np.testing.assert_allclose(
            np.asarray(got), np.asarray(K @ v), rtol=1e-9, atol=1e-11
        )
        got1 = kernel_matvec_fused(k, x, v[:, 0], s, 1e-8, block=(128, 128),
                                   interpret=True)
        np.testing.assert_allclose(
            np.asarray(got1), np.asarray(K @ v[:, 0]), rtol=1e-9, atol=1e-11
        )

    xd = jnp.asarray(rng.standard_normal((300, 2)))
    ard = ARDGaussianKernel(h=jnp.float64(1.1), w=jnp.asarray([0.8, 1.7]))
    assert supports_fused_matvec(ard, xd)
    K = ard(xd, xd) + (s**2 + 1e-8) * jnp.eye(300)
    got = kernel_matvec_fused(ard, xd, v, s, 1e-8, block=(128, 128),
                              interpret=True)
    np.testing.assert_allclose(
        np.asarray(got), np.asarray(K @ v), rtol=1e-9, atol=1e-11
    )


def test_kernel_jacvec_fused_matches_strips():
    # interpreted Pallas twin of the Jacobian strip contraction used
    # by the matrix-free gradient: J_p @ U for each hyperparameter
    from gaussian_processes_tpu.models.periodic import PeriodicKernel
    from gaussian_processes_tpu.ops.pairwise import (
        kernel_jacvec_fused,
        supports_fused_jacvec,
    )

    kernel, x, y, s = _problem(n=300)
    rng = np.random.default_rng(3)
    U = jnp.asarray(rng.standard_normal((300, 4)))
    for k in [kernel, PeriodicKernel(h=1.1, w=0.9, p=2.3)]:
        assert supports_fused_jacvec(k, x)
        J = k.jacobian(x, x)  # (P, n, n)
        want = jnp.einsum("pnm,mr->pnr", J, U)
        got = kernel_jacvec_fused(k, x, U, block=(128, 128), interpret=True)
        np.testing.assert_allclose(
            np.asarray(got), np.asarray(want), rtol=1e-9, atol=1e-11
        )


def test_mbcg_solves_match_direct():
    kernel, x, y, s = _problem()
    from gaussian_processes_tpu import build_kxx

    K = build_kxx(kernel, x, s)
    rhs = jnp.stack([y, jnp.ones_like(y)], axis=1)
    mv = lambda v: K @ v
    res = krylov.mbcg(mv, rhs, num_iters=200, tol=1e-12)
    direct = jnp.linalg.solve(K, rhs)
    np.testing.assert_allclose(np.asarray(res.solution), np.asarray(direct),
                               rtol=1e-6, atol=1e-8)
    assert np.all(np.asarray(res.residual_norm) < 1e-10)


def test_fit_iterative_matches_dense():
    kernel, x, y, s = _problem()
    post_d = fit(kernel, x, y, s)
    post_i = fit_iterative(kernel, x, y, s, jax.random.key(0),
                           num_probes=64, num_iters=200, block_size=64)
    np.testing.assert_allclose(np.asarray(post_i.alpha), np.asarray(post_d.alpha),
                               rtol=1e-6, atol=1e-8)
    # SLQ logdet: Monte-Carlo error ~ |logdet| / sqrt(probes); generous gate
    lml_d = float(post_d.log_marginal)
    lml_i = float(post_i.log_marginal)
    assert abs(lml_i - lml_d) < 0.05 * abs(lml_d) + 5.0
    assert float(post_i.solve_residual) < 1e-7


def test_iterative_predictions_match_dense():
    kernel, x, y, s = _problem()
    post_d = fit(kernel, x, y, s)
    post_i = fit_iterative(kernel, x, y, s, jax.random.key(0),
                           num_iters=200, block_size=64)
    xo = jnp.asarray(make_xo(40))
    m_d, v_d = predict_diag(post_d, xo)
    m_i = predict_mean_iterative(post_i, xo, block_size=16)
    np.testing.assert_allclose(np.asarray(m_i), np.asarray(m_d), rtol=1e-6,
                               atol=1e-8)
    m_i2, v_i = predict_diag_iterative(post_i, xo, num_iters=200)
    np.testing.assert_allclose(np.asarray(m_i2), np.asarray(m_d), rtol=1e-6,
                               atol=1e-8)
    np.testing.assert_allclose(np.asarray(v_i), np.asarray(v_d), rtol=1e-4,
                               atol=1e-7)


def test_iterative_gradient_matches_analytic():
    kernel, x, y, s = _problem(n=200)
    lml_a, g_a = log_marginal_value_and_grad(kernel, x, y, s)
    lml_i, g_i = log_marginal_value_and_grad_iterative(
        kernel, x, y, s, jax.random.key(1),
        num_probes=256, num_iters=200, block_size=64,
    )
    # Hutchinson trace error ~ 1/sqrt(256) = 6% of trace scale
    denom = np.maximum(np.abs(np.asarray(g_a)), 1.0)
    rel = np.abs(np.asarray(g_i) - np.asarray(g_a)) / denom
    assert np.all(rel < 0.2), (g_i, g_a)
    assert abs(float(lml_i) - float(lml_a)) < 0.05 * abs(float(lml_a)) + 5.0


def test_iterative_with_ard_inputs():
    from gaussian_processes_tpu import ARDGaussianKernel

    rng = np.random.default_rng(9)
    n, D = 150, 2
    x = jnp.asarray(rng.uniform(-2, 2, (n, D)))
    y = jnp.asarray(np.sin(2 * np.asarray(x)[:, 0]) + 0.1 * rng.standard_normal(n))
    k = ARDGaussianKernel(h=jnp.float64(1.0), w=jnp.asarray([0.8, 1.4]))
    post_i = fit_iterative(k, x, y, 0.2, jax.random.key(0),
                           num_iters=200, block_size=32)
    post_d = fit(k, x, y, 0.2)
    np.testing.assert_allclose(np.asarray(post_i.alpha), np.asarray(post_d.alpha),
                               rtol=1e-6, atol=1e-8)
    xo = jnp.asarray(rng.uniform(-2, 2, (20, D)))
    m_i = predict_mean_iterative(post_i, xo, block_size=8)
    m_d, _ = predict_diag(post_d, xo)
    np.testing.assert_allclose(np.asarray(m_i), np.asarray(m_d), rtol=1e-6, atol=1e-8)


def test_fit_mle_iterative_improves_lml():
    from gaussian_processes_tpu.models.iterative_gp import fit_mle_iterative
    from gaussian_processes_tpu import log_marginal_likelihood

    kernel, x, y, s = _problem(n=200)
    k_bad = GaussianKernel(h=jnp.float64(0.5), w=jnp.float64(2.0))
    k_fit, noise_fit, lml_last, trace = fit_mle_iterative(
        k_bad, x, y, 0.5, jax.random.key(0),
        num_steps=40, num_probes=32, num_iters=150, block_size=64,
    )
    lml0 = float(log_marginal_likelihood(k_bad, x, y, 0.5))
    lml_exact = float(log_marginal_likelihood(k_fit, x, y, noise_fit))
    assert lml_exact > lml0 + 5.0  # genuinely improved (exact check)
    assert np.isfinite(lml_last)


def test_pivoted_cholesky_overrank_stays_sane():
    # f32, rank far beyond the kernel's effective rank: once the
    # residual diagonal hits f32 round-off, further pivots must freeze
    # to zero columns, not emit noise/clamped-pivot junk that poisons
    # the Woodbury preconditioner (observed on an accelerator: a rank-2048 factor
    # of an effective-rank-~70 kernel broke CG convergence)
    kernel, x, y, s = _problem(n=200)
    wide = kernel.with_params(jnp.asarray([1.3, 2.5], jnp.float32))
    x32 = x.astype(jnp.float32)
    L = krylov.pivoted_cholesky(wide, x32, rank=150)
    assert L.dtype == jnp.float32
    K = wide(x32, x32)
    rel = float(jnp.linalg.norm(K - L @ L.T) / jnp.linalg.norm(K))
    # the freeze floor is 1e3*eps of the max diagonal (raised from
    # 10*eps after cross-backend f32 round-off scatter let ~100 junk
    # columns through — see pivoted_cholesky), so the best
    # achievable reconstruction is ~1e-4 relative, not 1e-5
    assert rel < 5e-4
    # the tail columns must be exactly zero (frozen), and the Woodbury
    # apply built from L must still be a sane preconditioner
    tail_norm = float(jnp.abs(L[:, -20:]).max())
    assert tail_norm == 0.0
    pre = krylov.woodbury_inverse_apply(L, jnp.float32(s) ** 2)
    v = jnp.asarray(
        np.random.default_rng(5).standard_normal(200).astype(np.float32)
    )
    Kn = K + (jnp.float32(s) ** 2) * jnp.eye(200, dtype=jnp.float32)
    rel2 = float(jnp.linalg.norm(Kn @ pre(v) - v) / jnp.linalg.norm(v))
    assert rel2 < 1e-2


def test_pivoted_cholesky_approximates_kernel():
    kernel, x, y, s = _problem(n=120)
    L = krylov.pivoted_cholesky(kernel, x, rank=40)
    K = kernel(x, x)
    err = float(jnp.max(jnp.abs(L @ L.T - K)))
    # the SE spectrum decays fast; rank 40 of 120 should be very tight
    assert err < 1e-6, err
    # low rank is a genuine approximation, monotone in rank
    L2 = krylov.pivoted_cholesky(kernel, x, rank=10)
    err2 = float(jnp.max(jnp.abs(L2 @ L2.T - K)))
    assert err2 > err


def test_pcg_with_preconditioner_converges_faster():
    kernel, x, y, s = _problem(n=400, noise=0.05)
    from gaussian_processes_tpu import build_kxx

    K = build_kxx(kernel, x, s)
    mv = lambda v: K @ v
    rhs = y[:, None]
    # plain CG, few iterations
    plain = krylov.mbcg(mv, rhs, num_iters=25, tol=1e-14)
    # preconditioned CG, same iterations
    L = krylov.pivoted_cholesky(kernel, x, rank=60)
    pre = krylov.woodbury_inverse_apply(L, s ** 2)
    x_p, rn_p = krylov.pcg(mv, pre, rhs, num_iters=25, tol=1e-14)
    assert float(rn_p[0]) < 0.01 * float(plain.residual_norm[0])
    direct = jnp.linalg.solve(K, y)
    np.testing.assert_allclose(np.asarray(x_p[:, 0]), np.asarray(direct),
                               rtol=1e-5, atol=1e-7)


def test_fit_iterative_with_preconditioner():
    kernel, x, y, s = _problem()
    post_d = fit(kernel, x, y, s)
    post_p = fit_iterative(kernel, x, y, s, jax.random.key(0),
                           num_iters=60, block_size=64, precond_rank=60)
    np.testing.assert_allclose(np.asarray(post_p.alpha), np.asarray(post_d.alpha),
                               rtol=1e-5, atol=1e-7)
    assert float(post_p.solve_residual) < 1e-8


def test_predict_diag_iterative_preconditioned():
    kernel, x, y, s = _problem()
    post_d = fit(kernel, x, y, s)
    post_i = fit_iterative(kernel, x, y, s, jax.random.key(0),
                           num_iters=60, block_size=64, precond_rank=60)
    xo = jnp.asarray(make_xo(25))
    m_d, v_d = predict_diag(post_d, xo)
    m_i, v_i = predict_diag_iterative(post_i, xo, num_iters=60, precond_rank=60)
    np.testing.assert_allclose(np.asarray(m_i), np.asarray(m_d), rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(np.asarray(v_i), np.asarray(v_d), rtol=1e-4, atol=1e-7)


def test_preconditioned_slq_logdet_accuracy():
    # preconditioned SLQ should estimate the log marginal at least as well
    # as plain SLQ, and close to the exact value (f64, exactly solvable)
    kernel, x, y, s = _problem(n=250, noise=0.15)
    post_d = fit(kernel, x, y, s)
    lml_exact = float(post_d.log_marginal)
    post_p = fit_iterative(kernel, x, y, s, jax.random.key(3),
                           num_probes=32, num_iters=150, block_size=64,
                           precond_rank=80)
    lml_p = float(post_p.log_marginal)
    # the preconditioner captures most of the spectrum exactly, so the
    # stochastic remainder is small: expect sub-percent agreement
    assert abs(lml_p - lml_exact) < 0.01 * abs(lml_exact) + 1.0, (
        lml_p, lml_exact)


def test_iterative_gradient_preconditioned_matches_analytic():
    kernel, x, y, s = _problem(n=200)
    _, g_a = log_marginal_value_and_grad(kernel, x, y, s)
    _, g_p = log_marginal_value_and_grad_iterative(
        kernel, x, y, s, jax.random.key(1),
        num_probes=256, num_iters=150, block_size=64, precond_rank=60,
    )
    denom = np.maximum(np.abs(np.asarray(g_a)), 1.0)
    rel = np.abs(np.asarray(g_p) - np.asarray(g_a)) / denom
    assert np.all(rel < 0.2), (g_p, g_a)


# ---------------------------------------------------------------------------
# round-2 review regressions


def test_fused_jacvec_gate_rejects_composites():
    # composites define supports_tiled as a PROPERTY; reading it off the
    # class is truthy, which used to route them into the fused jacvec
    # and crash on non-static param_names (review finding, confirmed)
    from gaussian_processes_tpu.models.composite import SumKernel
    from gaussian_processes_tpu.models.gaussian import GaussianKernel
    from gaussian_processes_tpu.models.periodic import PeriodicKernel
    from gaussian_processes_tpu.ops import pairwise

    x = jnp.linspace(-1.0, 1.0, 32)
    u = jnp.ones((32, 2))
    ksum = SumKernel(GaussianKernel(1.0, 0.5), PeriodicKernel(1.0, 0.5, 1.0))
    assert pairwise.supports_fused_jacvec(GaussianKernel(1.0, 0.5), x)
    assert not pairwise.supports_fused_jacvec(ksum, x)
    with pytest.raises(TypeError):
        pairwise.kernel_jacvec_fused(ksum, x, u, interpret=True)
    # and the dispatching caller runs the composite via the strip path
    from gaussian_processes_tpu.models.iterative_gp import (
        log_marginal_value_and_grad_iterative,
    )
    rng = np.random.default_rng(0)
    y = jnp.asarray(np.sin(2 * np.asarray(x)) + 0.1 * rng.standard_normal(32))
    val, g = log_marginal_value_and_grad_iterative(
        ksum, x, y, 0.2, jax.random.key(0), num_probes=4, num_iters=24,
    )
    assert np.isfinite(float(val)) and np.all(np.isfinite(np.asarray(g)))


def test_pcg_early_exit_terminates_on_breakdown():
    # an indefinite operator breaks CG down (pAp < 0) on every column;
    # the early-exit loop must terminate on the breakdown freeze rather
    # than burning the full budget, and must match the fixed-length scan
    from gaussian_processes_tpu.ops import krylov

    rng = np.random.default_rng(1)
    A = jnp.asarray(np.diag(np.concatenate([np.ones(10), -np.ones(10)])))
    rhs = jnp.asarray(rng.standard_normal((20, 3)))
    pre = lambda v: v
    mv = lambda v: A @ v
    x_scan, rn_scan = krylov.pcg(mv, pre, rhs, num_iters=50, tol=1e-10)
    x_ee, rn_ee = krylov.pcg(
        mv, pre, rhs, num_iters=50, tol=1e-10, early_exit=True
    )
    np.testing.assert_allclose(np.asarray(x_ee), np.asarray(x_scan),
                               atol=1e-12)
    np.testing.assert_allclose(np.asarray(rn_ee), np.asarray(rn_scan),
                               atol=1e-12)
    # healthy SPD case still solves identically with early exit
    Q = rng.standard_normal((20, 20))
    A2 = jnp.asarray(Q @ Q.T / 20 + np.eye(20))
    mv2 = lambda v: A2 @ v
    x2s, _ = krylov.pcg(mv2, pre, rhs, num_iters=60, tol=1e-12)
    x2e, _ = krylov.pcg(mv2, pre, rhs, num_iters=60, tol=1e-12,
                        early_exit=True)
    np.testing.assert_allclose(np.asarray(x2e), np.asarray(x2s), atol=1e-12)
