"""The fused Pallas (Triton) kernels in the interpreter, and the rules
that choose them.

On the CPU the kernels run only with an explicit ``interpret=True``;
the arithmetic must match the dense jnp path to f64 round-off for every
kernel family, right-hand-side width (padded to 16 inside) and a point
count that is not a block multiple (zero-padded edge tiles must not
leak).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gaussian_processes_tpu import (
    ARDGaussianKernel,
    GaussianKernel,
    Matern32Kernel,
    Matern52Kernel,
    PeriodicKernel,
    RationalQuadraticKernel,
)
from gaussian_processes_tpu.models.composite import ProductKernel, SumKernel
from gaussian_processes_tpu.ops import krylov, pairwise

N = 203  # not a multiple of any block
BLOCK = (32, 64)


def _leaves():
    return {
        "se": GaussianKernel(h=jnp.float64(1.2), w=jnp.float64(0.6)),
        "matern32": Matern32Kernel(h=jnp.float64(0.9), w=jnp.float64(0.8)),
        "matern52": Matern52Kernel(h=jnp.float64(1.1), w=jnp.float64(0.7)),
        "periodic": PeriodicKernel(h=jnp.float64(1.0), w=jnp.float64(1.3),
                                   p=jnp.float64(2.0)),
        "rq": RationalQuadraticKernel(h=jnp.float64(1.0), w=jnp.float64(0.5),
                                      a=jnp.float64(1.5)),
    }


def _kernels():
    k = _leaves()
    k["se+periodic"] = SumKernel(k["se"], k["periodic"])
    k["se*periodic"] = ProductKernel(k["se"], k["periodic"])
    k["(se+periodic)*rq"] = ProductKernel(SumKernel(k["se"], k["periodic"]),
                                          k["rq"])
    return k


def _data(r, seed=0):
    rng = np.random.default_rng(seed)
    x = jnp.asarray(np.sort(rng.uniform(-3, 3, N)))
    v = jnp.asarray(rng.standard_normal((N, r)))
    return x, v


@pytest.mark.parametrize("r", [1, 9, 16])
@pytest.mark.parametrize("name", sorted(_kernels()))
def test_fused_matvec_interpret_matches_dense(name, r):
    k = _kernels()[name]
    x, v = _data(r)
    assert pairwise.supports_fused_matvec(k, x)
    got = pairwise.kernel_matvec_fused(k, x, v, 0.3, 1e-8, block=BLOCK,
                                       interpret=True)
    want = k(x, x) @ v + (0.09 + 1e-8) * v
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-10, atol=1e-11)


@pytest.mark.parametrize("vec", [False, True])
def test_fused_matvec_rectangular_rows(vec):
    """``x_rows`` gives K(x_rows, x) @ v with no diagonal (row shards)."""
    k = _kernels()["se*periodic"]
    x, v = _data(3)
    v = v[:, 0] if vec else v
    rows = x[17:90]
    got = pairwise.kernel_matvec_fused(k, x, v, 0.3, x_rows=rows,
                                       block=BLOCK, interpret=True)
    np.testing.assert_allclose(np.asarray(got), np.asarray(k(rows, x) @ v),
                               rtol=1e-10, atol=1e-11)


@pytest.mark.parametrize("D", [1, 3])
def test_fused_matvec_ard_interpret_matches_dense(D):
    rng = np.random.default_rng(D)
    x = jnp.asarray(rng.uniform(-2, 2, (N, D)))
    v = jnp.asarray(rng.standard_normal((N, 5)))
    k = ARDGaussianKernel(h=jnp.float64(1.1),
                          w=jnp.asarray(np.linspace(0.5, 1.5, D)))
    got = pairwise.kernel_matvec_fused(k, x, v, 0.2, block=BLOCK,
                                       interpret=True)
    want = k(x, x) @ v + 0.04 * v
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-10, atol=1e-11)


@pytest.mark.parametrize("r", [1, 9])
@pytest.mark.parametrize("name", sorted(_leaves()))
def test_fused_jacvec_interpret_matches_dense(name, r):
    k = _leaves()[name]
    x, u = _data(r, seed=1)
    got = pairwise.kernel_jacvec_fused(k, x, u, block=BLOCK, interpret=True)
    want = jnp.einsum("pnm,mr->pnr", k.jacobian(x, x), u)
    assert got.shape == (k.n_params, N, r)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-10, atol=1e-11)


@pytest.mark.parametrize("r,width", [(1, 16), (9, 16), (16, 16), (17, 32),
                                     (40, 64)])
def test_padded_width(r, width):
    assert pairwise._padded_width(r) == width


def test_pad_operands_zero_fills_columns():
    x, v = _data(9)
    xr, xc, vp = pairwise._pad_operands(x, x, v, BLOCK)
    assert xr.shape == (224,) and xc.shape == (256,) and vp.shape == (256, 16)
    assert float(jnp.abs(vp[N:]).max()) == 0.0
    assert float(jnp.abs(vp[:, 9:]).max()) == 0.0


@pytest.mark.parametrize("which", ["matvec", "jacvec"])
def test_kernels_refuse_cpu_without_interpret(which):
    k = _leaves()["se"]
    x, v = _data(2)
    with pytest.raises(RuntimeError, match="interpret=True"):
        if which == "matvec":
            pairwise.kernel_matvec_fused(k, x, v, 0.1)
        else:
            pairwise.kernel_jacvec_fused(k, x, v)


def test_support_gates():
    x, _ = _data(1)
    xd = jnp.ones((N, 2))
    se = _leaves()["se"]
    ard = ARDGaussianKernel(h=jnp.float64(1.0), w=jnp.asarray([1.0, 2.0]))
    composite = _kernels()["se+periodic"]
    assert pairwise.supports_fused_matvec(composite, x)
    assert pairwise.supports_fused_matvec(ard, xd)
    assert not pairwise.supports_fused_matvec(se, xd)
    assert not pairwise.supports_fused_jacvec(composite, x)
    assert not pairwise.supports_fused_jacvec(se, xd)
    with pytest.raises(TypeError):
        pairwise.kernel_matvec_fused(se, xd, jnp.ones((N, 1)), 0.1,
                                     interpret=True)


@pytest.mark.parametrize("backend,expect", [("cpu", False), ("gpu", True)])
def test_default_rules_follow_backend(monkeypatch, backend, expect):
    """The fused kernels are the default on the GPU only, and there only
    for what was timed against the strip scan (PERF.md): the SE matvec,
    the SE and periodic jacvecs, 1-D inputs, at most 16 right-hand sides."""
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    x, _ = _data(1)
    k = _kernels()
    assert pairwise.fused_matvec_default(k["se"], x, 9) is expect
    assert pairwise.fused_jacvec_default(k["se"], x, 9) is expect
    assert pairwise.fused_jacvec_default(k["periodic"], x, 16) is expect
    assert pairwise.fused_matvec_default(k["periodic"], x, 9) is False
    assert pairwise.fused_matvec_default(k["se+periodic"], x, 9) is False
    assert pairwise.fused_jacvec_default(k["se+periodic"], x, 9) is False


@pytest.mark.parametrize("case", ["ard", "composite", "matern52", "wide"])
def test_default_rules_skip_untimed_cases_on_gpu(monkeypatch, case):
    """Cases the fused kernels run but that were never timed on the card
    stay on the strip scan there."""
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    x, _ = _data(1)
    k, width = _kernels()["se"], 9
    if case == "ard":
        k = ARDGaussianKernel(h=jnp.float64(1.0), w=jnp.asarray([1.0, 2.0]))
        x = jnp.ones((N, 2))
    elif case == "composite":
        k = _kernels()["se*periodic"]
    elif case == "matern52":
        k = _kernels()["matern52"]
    else:
        width = 17
    assert pairwise.fused_matvec_default(k, x, width) is False
    assert pairwise.fused_jacvec_default(k, x, width) is False


def test_auto_matvec_is_strip_on_cpu():
    k = _leaves()["se"]
    x, v = _data(3)
    auto = krylov.kernel_matvec(k, x, v, 0.3, block_size=64)
    strip = krylov.kernel_matvec(k, x, v, 0.3, block_size=64, impl="strip")
    np.testing.assert_array_equal(np.asarray(auto), np.asarray(strip))


@pytest.mark.parametrize("rect", [False, True])
def test_auto_matvec_takes_fused_when_the_rule_says(monkeypatch, rect):
    """impl="auto" hands (kernel, x, v, noise, jitter) to the fused kernel
    when the rule picks it (here it runs interpreted); a rectangular
    ``x_rows`` product, never timed fused, stays on the strip scan."""
    widths = []
    monkeypatch.setattr(pairwise, "fused_matvec_default",
                        lambda k, x, width: widths.append(width) or True)
    real = pairwise.kernel_matvec_fused
    calls = []

    def spy(*a, **kw):
        calls.append(kw.get("x_rows") is not None)
        return real(*a, **kw, block=BLOCK, interpret=True)

    monkeypatch.setattr(pairwise, "kernel_matvec_fused", spy)
    k = _leaves()["rq"]
    x, v = _data(4)
    rows = x[:50] if rect else None
    got = krylov.kernel_matvec(k, x, v, 0.3, x_rows=rows)
    want = krylov.kernel_matvec(k, x, v, 0.3, x_rows=rows, impl="strip")
    assert calls == ([] if rect else [False])
    assert widths == ([] if rect else [4])
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-10, atol=1e-11)


def test_iterative_gradient_takes_fused_jacvec_when_the_rule_says(monkeypatch):
    """The matrix-free gradient through the fused jacvec (interpreted)
    equals the strip-scan gradient."""
    from gaussian_processes_tpu.models.iterative_gp import (
        log_marginal_value_and_grad_iterative,
    )

    k = _leaves()["periodic"]
    x, _ = _data(1)
    y = jnp.sin(2 * x)
    args = (k, x, y, 0.3, jax.random.key(0))
    kw = dict(num_probes=4, num_iters=60, tol=1e-12)
    val_s, g_s = log_marginal_value_and_grad_iterative(*args, **kw)
    real = pairwise.kernel_jacvec_fused
    calls = []
    monkeypatch.setattr(pairwise, "fused_jacvec_default",
                        lambda k, x, width: width == 5)
    monkeypatch.setattr(
        pairwise, "kernel_jacvec_fused",
        lambda *a, **kw2: calls.append(1) or real(*a, block=BLOCK,
                                                  interpret=True),
    )
    val_f, g_f = log_marginal_value_and_grad_iterative(*args, **kw)
    assert calls
    np.testing.assert_allclose(float(val_f), float(val_s), rtol=1e-12)
    np.testing.assert_allclose(np.asarray(g_f), np.asarray(g_s),
                               rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("impl", ["auto", "strip"])
def test_iterative_gradient_impl_strip_keeps_off_the_fused_kernels(
    monkeypatch, impl
):
    """``impl="strip"`` (what the vmapped sampler surrogate passes) keeps
    both the matvec and the jacvec on the strip scan even where the
    rules would pick the fused kernels; both give the same gradient."""
    from gaussian_processes_tpu.models.iterative_gp import (
        log_marginal_value_and_grad_iterative,
    )

    calls = []
    monkeypatch.setattr(pairwise, "fused_matvec_default", lambda *a: True)
    monkeypatch.setattr(pairwise, "fused_jacvec_default", lambda *a: True)
    for name in ("kernel_matvec_fused", "kernel_jacvec_fused"):
        real = getattr(pairwise, name)
        monkeypatch.setattr(
            pairwise, name,
            lambda *a, real=real, name=name, **kw: calls.append(name)
            or real(*a, **kw, block=BLOCK, interpret=True),
        )
    k = _leaves()["se"]
    x, _ = _data(1)
    y = jnp.sin(2 * x)
    val, g = log_marginal_value_and_grad_iterative(
        k, x, y, 0.3, jax.random.key(0), num_probes=4, num_iters=60,
        tol=1e-12, impl=impl)
    if impl == "strip":
        assert calls == []
    else:
        assert "kernel_jacvec_fused" in calls and "kernel_matvec_fused" in calls
    monkeypatch.undo()
    val_s, g_s = log_marginal_value_and_grad_iterative(
        k, x, y, 0.3, jax.random.key(0), num_probes=4, num_iters=60,
        tol=1e-12, impl="strip")
    np.testing.assert_allclose(float(val), float(val_s), rtol=1e-12)
    np.testing.assert_allclose(np.asarray(g), np.asarray(g_s),
                               rtol=1e-9, atol=1e-9)


def test_iterative_gradient_rejects_unknown_impl():
    from gaussian_processes_tpu.models.iterative_gp import (
        log_marginal_value_and_grad_iterative,
    )

    x, _ = _data(1)
    with pytest.raises(ValueError, match="impl"):
        log_marginal_value_and_grad_iterative(
            _leaves()["se"], x, jnp.sin(x), 0.3, impl="fused")


def test_sampler_surrogate_stays_on_the_strip(monkeypatch):
    """make_log_posterior_iterative is vmapped over chains by the
    samplers; the fused kernels were timed only unbatched."""
    from gaussian_processes_tpu.inference import make_log_posterior_iterative

    monkeypatch.setattr(pairwise, "fused_matvec_default", lambda *a: True)
    monkeypatch.setattr(pairwise, "fused_jacvec_default", lambda *a: True)

    def refuse(*a, **kw):
        raise AssertionError("fused kernel called from the surrogate")

    monkeypatch.setattr(pairwise, "kernel_matvec_fused", refuse)
    monkeypatch.setattr(pairwise, "kernel_jacvec_fused", refuse)
    k = _leaves()["se"]
    x, _ = _data(1)
    lp = make_log_posterior_iterative(k, x, jnp.sin(2 * x), num_probes=4,
                                      num_iters=40)
    u = jnp.log(jnp.asarray([[1.2, 0.6, 0.3], [1.0, 0.5, 0.2]]))
    vals, grads = jax.vmap(jax.value_and_grad(lp))(u)
    assert np.all(np.isfinite(np.asarray(vals)))
    assert np.all(np.isfinite(np.asarray(grads)))


@pytest.mark.gpu
@pytest.mark.parametrize("which", ["matvec", "jacvec"])
def test_compiled_kernels_match_strip_on_gpu(gpu_device, which):
    """The Triton-compiled kernels (no interpreter) against the strip scan
    on the card, in f32 at a non-block-multiple n."""
    n = 3001
    rng = np.random.default_rng(0)
    x = jnp.asarray(np.sort(rng.uniform(-3, 3, n)), jnp.float32)
    v = jnp.asarray(rng.standard_normal((n, 9)), jnp.float32)
    k = PeriodicKernel(h=jnp.float32(1.0), w=jnp.float32(1.3),
                       p=jnp.float32(2.0))
    if which == "matvec":
        got = pairwise.kernel_matvec_fused(k, x, v, 0.3)
        want = krylov.kernel_matvec(k, x, v, 0.3, impl="strip")
    else:
        got = pairwise.kernel_jacvec_fused(k, x, v)
        want = jnp.einsum("pnm,mr->pnr", k.jacobian(x, x), v,
                          precision=jax.lax.Precision.HIGHEST)
    scale = float(jnp.max(jnp.abs(want)))
    assert float(jnp.max(jnp.abs(got - want))) / scale < 1e-5
