"""Twin tests for the GEMM-blocked Cholesky (ops/blocked_cholesky.py).

The analogue of the reference's "native code matches math" gate
(SURVEY.md §5 item 2): the blocked factorization must match
``jnp.linalg.cholesky`` in f64 at 1e-8 relative (VERDICT r1 item 1's
acceptance bar), across sizes that are and are not multiples of the base
panel, and its solves must match scipy.  Runs on the CPU backend in f64
(conftest.py).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import scipy.linalg

from gaussian_processes_tpu.ops.blocked_cholesky import (
    cholesky_blocked,
    cholesky_solve_blocked,
    solve_triangular_blocked,
)


def _spd(n, rng, kind="kernel"):
    if kind == "kernel":
        x = np.sort(rng.uniform(-np.pi, np.pi, n))
        d = x[:, None] - x[None, :]
        return np.exp(-0.5 * d * d / 0.5**2) + 0.01 * np.eye(n)
    X = rng.standard_normal((n, n))
    return X @ X.T + n * np.eye(n)


@pytest.mark.parametrize("n", [64, 256, 300, 700, 1024, 1500])
@pytest.mark.parametrize("kind", ["kernel", "random"])
def test_matches_xla_cholesky_f64(n, kind):
    rng = np.random.default_rng(n)
    A = jnp.asarray(_spd(n, rng, kind))
    L_ref = jnp.linalg.cholesky(A)
    L = cholesky_blocked(A, base=256)
    rel = jnp.linalg.norm(L - L_ref) / jnp.linalg.norm(L_ref)
    assert float(rel) < 1e-8
    # strict upper triangle exactly zero
    assert float(jnp.abs(jnp.triu(L, 1)).max()) == 0.0


@pytest.mark.parametrize("n", [256, 700, 1024, 1500])
@pytest.mark.parametrize("kind", ["kernel", "random"])
def test_leftlook_matches_xla_cholesky_f64(n, kind):
    # single-buffer left-looking skeleton: same 1e-8 f64 gate as the
    # recursive form, plus exact-zero strict upper triangle
    rng = np.random.default_rng(n + 1)
    A = jnp.asarray(_spd(n, rng, kind))
    L_ref = jnp.linalg.cholesky(A)
    L = cholesky_blocked(A, base=256, algo="leftlook")
    rel = jnp.linalg.norm(L - L_ref) / jnp.linalg.norm(L_ref)
    assert float(rel) < 1e-8
    assert float(jnp.abs(jnp.triu(L, 1)).max()) == 0.0


@pytest.mark.parametrize("n", [512, 1100, 2048])
@pytest.mark.parametrize("super_base", [512, 1024])
def test_leftlook2_matches_xla_cholesky_f64(n, super_base):
    # two-level superpanel skeleton (kept as a tested, documented
    # variant; ROADMAP D3 decides its fate)
    rng = np.random.default_rng(n + 2)
    A = jnp.asarray(_spd(n, rng, "kernel"))
    L_ref = jnp.linalg.cholesky(A)
    L = cholesky_blocked(
        A, base=256, algo="leftlook2", super_base=super_base
    )
    rel = jnp.linalg.norm(L - L_ref) / jnp.linalg.norm(L_ref)
    assert float(rel) < 1e-8
    assert float(jnp.abs(jnp.triu(L, 1)).max()) == 0.0


@pytest.mark.parametrize("base", [128, 256, 512])
def test_base_size_invariance(base):
    rng = np.random.default_rng(7)
    A = jnp.asarray(_spd(777, rng))
    L_ref = jnp.linalg.cholesky(A)
    L = cholesky_blocked(A, base=base)
    rel = jnp.linalg.norm(L - L_ref) / jnp.linalg.norm(L_ref)
    assert float(rel) < 1e-8


def test_small_matrix_padding_path():
    # n < base exercises the identity-padding corner
    rng = np.random.default_rng(3)
    A = jnp.asarray(_spd(37, rng, "random"))
    L = cholesky_blocked(A, base=256)
    np.testing.assert_allclose(
        np.asarray(L), np.linalg.cholesky(np.asarray(A)), rtol=1e-10, atol=1e-10
    )


@pytest.mark.parametrize("trans", [False, True])
@pytest.mark.parametrize("nrhs", [0, 1, 5])
def test_blocked_triangular_solve(trans, nrhs):
    rng = np.random.default_rng(11)
    n = 700
    A = _spd(n, rng)
    L = np.linalg.cholesky(A)
    B = rng.standard_normal((n, nrhs)) if nrhs else rng.standard_normal(n)
    X = solve_triangular_blocked(
        jnp.asarray(L), jnp.asarray(B), trans=trans, base=256
    )
    X_ref = scipy.linalg.solve_triangular(L, B, lower=True, trans=1 if trans else 0)
    np.testing.assert_allclose(np.asarray(X), X_ref, rtol=1e-9, atol=1e-11)


def test_cholesky_solve_blocked():
    rng = np.random.default_rng(13)
    n = 900
    A = _spd(n, rng)
    L = np.linalg.cholesky(A)
    b = rng.standard_normal(n)
    z = cholesky_solve_blocked(jnp.asarray(L), jnp.asarray(b), base=256)
    np.testing.assert_allclose(np.asarray(z), np.linalg.solve(A, b), rtol=1e-8)


def test_autodiff_through_blocked_cholesky():
    """jax.grad flows through the blocked factorization and agrees with
    grad through XLA's cholesky — the MLE/NUTS layers depend on this."""
    rng = np.random.default_rng(5)
    x = np.sort(rng.uniform(-1, 1, 300))
    y = np.sin(3 * x) + 0.1 * rng.standard_normal(300)
    x, y = jnp.asarray(x), jnp.asarray(y)

    def lml(w, chol):
        d = x[:, None] - x[None, :]
        K = jnp.exp(-0.5 * d * d / (w * w)) + 0.01 * jnp.eye(300)
        L = chol(K)
        alpha = cholesky_solve_blocked(L, y, base=256) if chol is not jnp.linalg.cholesky \
            else jax.scipy.linalg.cho_solve((L, True), y)
        return -0.5 * y @ alpha - jnp.sum(jnp.log(jnp.diagonal(L)))

    g_blocked = jax.grad(lambda w: lml(w, lambda A: cholesky_blocked(A, base=256)))(0.7)
    g_xla = jax.grad(lambda w: lml(w, jnp.linalg.cholesky))(0.7)
    np.testing.assert_allclose(float(g_blocked), float(g_xla), rtol=1e-7)


def test_choose_solve_dispatch_and_parity():
    """choose_solve routes by n and right-hand-side count, and both
    branches solve the same system to f64 tightness."""
    import jax

    from gaussian_processes_tpu.ops import blocked_cholesky as bc

    assert bc.choose_solve(500) is bc._xla_solve
    assert bc.choose_solve(16384) is bc._measured_solve

    # the per-call choice follows the static RHS count
    traced = []
    real = {"xla": bc._xla_solve, "blocked": bc._blocked_solve}
    try:
        bc._xla_solve = lambda L, B, trans=False: traced.append("xla") or B
        bc._blocked_solve = lambda L, B, trans=False: traced.append("blocked") or B
        eye = jnp.eye(4)
        for B in (jnp.ones(4), jnp.ones((4, 5)), jnp.ones((4, bc._WIDE_RHS))):
            jax.eval_shape(lambda B: bc._measured_solve(eye, B), B)
    finally:
        bc._xla_solve, bc._blocked_solve = real["xla"], real["blocked"]
    assert traced == ["xla", "xla", "blocked"]
    _blocked_solve, _xla_solve = bc._blocked_solve, bc._xla_solve

    rng = np.random.default_rng(3)
    n = 700  # not a multiple of the base: exercises the recursion splits
    A = rng.standard_normal((n, 64))
    K = A @ A.T / 64 + np.eye(n)
    L = np.linalg.cholesky(K)
    for shape in ((n,), (n, 5)):
        b = rng.standard_normal(shape)
        for trans in (False, True):
            xb = _blocked_solve(jnp.asarray(L), jnp.asarray(b), trans=trans)
            xx = _xla_solve(jnp.asarray(L), jnp.asarray(b), trans=trans)
            np.testing.assert_allclose(xb, xx, rtol=1e-9, atol=1e-11)
