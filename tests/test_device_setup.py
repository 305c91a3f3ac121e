"""Compile-cache placement and the device peak table."""

import os

import jax
import pytest

from gaussian_processes_tpu.utils import compile_cache, profiling

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def restore_cache_config():
    keep = (jax.config.jax_compilation_cache_dir,
            jax.config.jax_persistent_cache_min_compile_time_secs)
    yield
    jax.config.update("jax_compilation_cache_dir", keep[0])
    jax.config.update("jax_persistent_cache_min_compile_time_secs", keep[1])


def test_cache_env_set_is_used_and_nothing_else_set(
        monkeypatch, tmp_path, restore_cache_config):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = (jax.config.jax_compilation_cache_dir,
              jax.config.jax_persistent_cache_min_compile_time_secs)
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert (jax.config.jax_compilation_cache_dir,
            jax.config.jax_persistent_cache_min_compile_time_secs) == before


def test_cache_env_unset_goes_to_the_checkout(monkeypatch, restore_cache_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = compile_cache.enable_compile_cache()
    assert path == os.path.join(_REPO, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path
    assert jax.config.jax_persistent_cache_min_compile_time_secs == 0.0


def test_cache_path_never_moves(monkeypatch, restore_cache_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    paths = {compile_cache.enable_compile_cache() for _ in range(3)}
    assert paths == {compile_cache.DEFAULT_CACHE_DIR}
    assert str(os.getpid()) not in compile_cache.DEFAULT_CACHE_DIR
    with open(os.path.join(_REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


@pytest.mark.parametrize("kind", ["cpu", "TPU v5 lite", "NVIDIA A100-SXM4-80GB"])
def test_peaks_raise_on_unknown_device(kind):
    with pytest.raises(ValueError, match="no published peaks"):
        profiling.device_peaks(kind)


def test_peaks_default_to_device_zero():
    # the test backend is the CPU, which has no entry
    with pytest.raises(ValueError):
        profiling.device_peaks()


def test_h100_peaks_and_roofline():
    kind = "NVIDIA H100 80GB HBM3"
    peaks = profiling.device_peaks(kind)
    assert peaks["flops"]["bfloat16"] == 989e12
    assert peaks["flops"]["float32"] == 67e12
    assert peaks["hbm_bytes_per_s"] == 3.35e12
    r = profiling.roofline(1000, 1.0, "float32", device_kind=kind)
    assert r["peak_flops"] == 67e12
    assert r["fraction_of_peak"] == pytest.approx(profiling.fit_flops(1000) / 67e12)
    with pytest.raises(KeyError):
        profiling.roofline(1000, 1.0, "int4", device_kind=kind)
