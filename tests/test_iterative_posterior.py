"""Matrix-free Bayesian inference gates (VERDICT r1 item 2).

The surrogate log posterior built by ``make_log_posterior_iterative``
(PCG value + SLQ logdet + Hutchinson gradient, fixed probes) must:

1. agree with the dense log posterior in value and gradient to the SLQ
   Monte-Carlo tolerance at a size where the dense answer is exact;
2. be a valid ``jax.grad``/vmap citizen (the samplers call
   ``value_and_grad`` through ``vmap``);
3. yield the same hyperparameter posterior as dense-NUTS within
   Monte-Carlo error when sampled with ChEES.

Runs on the CPU backend in f64 (conftest.py).
"""

import jax
import jax.numpy as jnp
import numpy as np

from gaussian_processes_tpu import GaussianKernel
from gaussian_processes_tpu.inference import (
    init_positions,
    make_log_posterior,
    make_log_posterior_iterative,
    sample_nuts,
)
from gaussian_processes_tpu.inference.chees import sample_chees
from gaussian_processes_tpu.inference.diagnostics import summarize
import pytest

# slow tier (VERDICT r2 item 8): minutes-long on 4 host cores; run via
# `make test-all` / CI. The default `make test` gate stays < 10 min.
pytestmark = pytest.mark.slow


def _problem(n=300, seed=0):
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(-np.pi, np.pi, n))
    y = np.sin(2 * x) + 0.1 * rng.standard_normal(n)
    k0 = GaussianKernel(h=jnp.asarray(1.0), w=jnp.asarray(1.0))
    return k0, jnp.asarray(x), jnp.asarray(y)


def test_iterative_log_posterior_matches_dense():
    k0, x, y = _problem()
    dense = make_log_posterior(k0, x, y, prior_std=1.5, jitter=1e-8)
    iter_ = make_log_posterior_iterative(
        k0, x, y, prior_std=1.5, jitter=1e-8,
        num_probes=64, num_iters=250, tol=1e-10,
    )
    u = jnp.log(jnp.asarray([0.9, 0.8, 0.12]))
    v_d = float(dense(u))
    v_i = float(iter_(u))
    # CG part is exact to tol; the SLQ logdet carries O(n/sqrt(probes))
    # MC error — bound it at a few percent of the logdet magnitude
    assert abs(v_d - v_i) < 0.05 * abs(v_d) + 2.0

    g_d = np.asarray(jax.grad(dense)(u))
    g_i = np.asarray(jax.grad(iter_)(u))
    # the Hutchinson trace estimator's MC error is O(1/sqrt(probes)) per
    # component and scales with the off-diagonal energy of K^-1 K_p —
    # observed ~12% on the lengthscale component at 64 probes; gate at
    # the estimator's statistical level, not exactness (the sampler-level
    # test below is the behavioral gate)
    np.testing.assert_allclose(g_i, g_d, rtol=0.25, atol=2.0)
    # direction matters most for samplers: the estimated gradient must
    # point the same way
    assert np.dot(g_i, g_d) / (
        np.linalg.norm(g_i) * np.linalg.norm(g_d)
    ) > 0.99


def test_iterative_log_posterior_deterministic_and_vmappable():
    k0, x, y = _problem(n=200)
    lp = make_log_posterior_iterative(
        k0, x, y, num_probes=8, num_iters=100, tol=1e-10, jitter=1e-8
    )
    u = jnp.log(jnp.asarray([1.1, 0.7, 0.15]))
    # fixed probes: bit-identical on repeated evaluation (the surrogate is
    # a deterministic function — required for a well-defined MCMC target)
    assert float(lp(u)) == float(lp(u))

    us = jnp.stack([u, u + 0.1, u - 0.1])
    vals = jax.vmap(lp)(us)
    grads = jax.vmap(jax.grad(lp))(us)
    assert vals.shape == (3,) and grads.shape == (3, 3)
    np.testing.assert_allclose(float(vals[0]), float(lp(u)), rtol=1e-12)
    assert np.all(np.isfinite(np.asarray(grads)))


def test_chees_on_iterative_posterior_matches_dense_nuts():
    """Sampling the matrix-free surrogate reproduces the dense posterior
    moments within Monte-Carlo error (the round-2 acceptance gate)."""
    k0, x, y = _problem(n=120, seed=1)
    dense = make_log_posterior(k0, x, y, prior_std=1.5, jitter=1e-8)
    # PRECONDITIONED surrogate: chains explore the small-noise corner of
    # the posterior where K's conditioning explodes; unpreconditioned CG
    # with a tight iteration budget under-solves there and fabricates a
    # likelihood optimum at tiny noise (observed: surrogate noise mean
    # drifted to u_s = -6.9 vs dense -2.3).  The pivoted-Cholesky PCG +
    # preconditioned SLQ path — the same machinery the N=65k fit uses —
    # keeps the surrogate faithful across the whole explored region.
    iter_ = make_log_posterior_iterative(
        k0, x, y, prior_std=1.5, jitter=1e-8,
        num_probes=12, num_iters=60, tol=1e-10, block_size=128,
        precond_rank=40,
    )
    key = jax.random.key(3)
    k1, k2, k3 = jax.random.split(key, 3)
    init = init_positions(k0, 0.15, k1, n_chains=4, spread=0.2)

    ref = sample_nuts(
        dense, init, k2, num_warmup=150, num_samples=150, max_depth=7
    )
    res = sample_chees(
        iter_, init, k3, num_warmup=150, num_samples=150, max_leapfrog=48
    )

    d_ref = np.asarray(ref.positions).reshape(-1, 3)
    d_it = np.asarray(res.positions).reshape(-1, 3)
    assert np.all(np.isfinite(d_it))
    s_ref = summarize(np.asarray(ref.positions))
    s_it = summarize(np.asarray(res.positions))
    ess_min = max(min(s_ref["min_ess"], s_it["min_ess"]), 10.0)
    # MC tolerance: 5 joint standard errors + the SLQ surrogate bias
    tol = 5.0 * d_ref.std(0) / np.sqrt(ess_min) + 0.05
    assert np.all(np.abs(d_ref.mean(0) - d_it.mean(0)) < tol), (
        d_ref.mean(0), d_it.mean(0), tol
    )
    np.testing.assert_allclose(
        d_it.std(0), d_ref.std(0), rtol=0.35, atol=0.05
    )
