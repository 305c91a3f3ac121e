"""Distributed block-cyclic Cholesky vs the dense single-device path
(SURVEY.md §6.7c).  Runs on the 8-device virtual CPU mesh in f64, so
agreement is at round-off level — the factorization, log-det, solves and
predictive variance must all match ``models.gp.fit`` exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gaussian_processes_tpu import GaussianKernel, PeriodicKernel, fit, predict_diag
from gaussian_processes_tpu.parallel import (
    fit_blockcyclic,
    make_chain_mesh,
    predict_diag_blockcyclic,
)
from gaussian_processes_tpu.utils import testing as tu

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices"
)


def _mesh():
    return make_chain_mesh(8, axis="shard")


def _data(n, seed=0):
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(-np.pi, np.pi, n))
    y = np.sin(2 * x) + 0.1 * rng.standard_normal(n)
    return x, y


@pytest.mark.parametrize("n,b", [(128, 8), (200, 8), (256, 16)])
def test_blockcyclic_matches_dense(n, b):
    x, y = _data(n)
    kernel = GaussianKernel(h=jnp.asarray(1.2), w=jnp.asarray(0.7))
    mesh = _mesh()
    post_d = fit_blockcyclic(kernel, x, y, 0.2, mesh, block_size=b, jitter=0.0)
    post = fit(kernel, x, y, 0.2)
    np.testing.assert_allclose(
        float(post_d.log_marginal), float(post.log_marginal), rtol=1e-10
    )
    np.testing.assert_allclose(
        np.asarray(post_d.alpha), np.asarray(post.alpha), rtol=1e-7, atol=1e-9
    )


def test_blockcyclic_periodic_and_padding():
    # n deliberately not divisible by D*b: exercises identity padding
    x, y = _data(150, seed=3)
    kernel = PeriodicKernel(
        h=jnp.asarray(1.0), w=jnp.asarray(1.0), p=jnp.asarray(0.5)
    )
    mesh = _mesh()
    post_d = fit_blockcyclic(kernel, x, y, 0.15, mesh, block_size=8, jitter=0.0)
    post = fit(kernel, x, y, 0.15)
    np.testing.assert_allclose(
        float(post_d.log_marginal), float(post.log_marginal), rtol=1e-10
    )


def test_blockcyclic_predict_matches_dense():
    x, y = _data(192, seed=1)
    kernel = GaussianKernel(h=jnp.asarray(1.0), w=jnp.asarray(0.6))
    mesh = _mesh()
    post_d = fit_blockcyclic(kernel, x, y, 0.2, mesh, block_size=8, jitter=0.0)
    post = fit(kernel, x, y, 0.2)
    xo = tu.make_xo(40)
    m_d, v_d = predict_diag_blockcyclic(post_d, xo, mesh)
    m, v = predict_diag(post, xo)
    np.testing.assert_allclose(np.asarray(m_d), np.asarray(m), rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(np.asarray(v_d), np.asarray(v), rtol=1e-6, atol=1e-10)


@pytest.mark.parametrize("n,b", [(128, 8), (150, 8)])
@pytest.mark.parametrize("family", ["se", "se*periodic"])
def test_build_local_blocks_matches_dense(n, b, family):
    """Each device's row-block strip of K + (s^2 + jitter) I, built with
    plain jnp, reassembles into the dense matrix; padded rows/cols are
    identity (n = 150 is not a multiple of D*b)."""
    from jax.sharding import PartitionSpec as P

    from gaussian_processes_tpu.models.composite import ProductKernel
    from gaussian_processes_tpu.parallel.block_cholesky import (
        _build_local_blocks,
        _padded_dims,
    )

    se = GaussianKernel(h=jnp.asarray(1.2), w=jnp.asarray(0.7))
    kernel = se if family == "se" else ProductKernel(
        se, PeriodicKernel(h=jnp.asarray(1.0), w=jnp.asarray(1.0),
                           p=jnp.asarray(0.5)))
    mesh = _mesh()
    D = 8
    m, n_pad = _padded_dims(n, D, b)
    m_loc = m // D
    x, _ = _data(n)
    x_pad = jnp.zeros(n_pad).at[:n].set(x)
    noise, jitter = 0.2, 1e-6

    def local(x_pad):
        own_g = jax.lax.axis_index("shard") + jnp.arange(m_loc) * D
        return _build_local_blocks(kernel, x_pad, own_g, n, b, m,
                                   jnp.asarray(noise), jitter)

    blocks = jax.jit(jax.shard_map(local, mesh=mesh, in_specs=P(),
                                   out_specs=P("shard"), check_vma=False))(x_pad)
    assert blocks.shape == (m, m, b, b)
    dense = np.zeros((n_pad, n_pad))
    for d in range(D):
        for l in range(m_loc):
            g = d + l * D
            row = np.asarray(blocks[d * m_loc + l])  # (m, b, b)
            dense[g * b:(g + 1) * b] = row.transpose(1, 0, 2).reshape(b, n_pad)
    want = np.eye(n_pad)
    want[:n, :n] = np.asarray(kernel(jnp.asarray(x), jnp.asarray(x))) + (
        noise**2 + jitter) * np.eye(n)
    np.testing.assert_allclose(dense, want, rtol=1e-13, atol=1e-14)
