"""Tracing / profiling hooks (SURVEY.md §6.1).

``jax.profiler`` traces around the hot phases (kernel build / Cholesky /
sampler step) plus a roofline accounting helper: achieved FLOP/s of the
fit path against the device's published peak.
"""

from __future__ import annotations

import contextlib
import time

import jax


@contextlib.contextmanager
def trace(profile_dir: str | None):
    """TensorBoard-readable trace of the enclosed block (no-op if None)."""
    if profile_dir:
        with jax.profiler.trace(profile_dir):
            yield
    else:
        yield


named_scope = jax.named_scope  # re-export for phase annotations


#: Published dense peaks (no sparsity) keyed by ``device_kind``.  Source:
#: NVIDIA H100 Tensor Core GPU data sheet, SXM5 part, at its 700 W power
#: limit — a card set below 700 W cannot hold these clocks under load.
#: FLOP/s per dtype; "float32" is the CUDA-core (non-tensor) rate,
#: "tf32" the tensor-core rate an f32 matmul gets at DEFAULT precision.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "flops": {
            "bfloat16": 989e12,
            "float16": 989e12,
            "tf32": 495e12,
            "float32": 67e12,
            "float64": 67e12,
        },
        "hbm_bytes_per_s": 3.35e12,
    },
}


def device_peaks(device_kind: str | None = None) -> dict:
    """The peak table entry of ``device_kind`` (default: device 0's).

    An unknown device is an error, never a default.
    """
    kind = device_kind or jax.devices()[0].device_kind
    try:
        return PEAKS[kind]
    except KeyError:
        raise ValueError(
            f"no published peaks for device_kind {kind!r}; add them to "
            "utils/profiling.py PEAKS with their source"
        ) from None


def fit_flops(n: int) -> float:
    """FLOPs of one exact-GP fit: n^2 kernel build (~10 flops/elem) +
    n^3/3 Cholesky + 2n^2 solves."""
    return 10.0 * n * n + n ** 3 / 3.0 + 2.0 * n * n


def roofline(n: int, wall_s: float, dtype: str = "float32",
             device_kind: str | None = None) -> dict:
    """Achieved vs peak FLOP/s for an N-point fit that took wall_s."""
    achieved = fit_flops(n) / wall_s
    peak = device_peaks(device_kind)["flops"][dtype]
    return {
        "n": n,
        "wall_s": wall_s,
        "achieved_flops": achieved,
        "peak_flops": peak,
        "fraction_of_peak": achieved / peak,
    }


def timed(fn, *args, warmup: int = 1, iters: int = 3):
    """Best-of wall-clock of a jitted callable (blocks on outputs)."""

    def run():
        t0 = time.perf_counter()
        out = fn(*args)
        jax.block_until_ready(out)
        return time.perf_counter() - t0

    for _ in range(warmup):
        run()
    return min(run() for _ in range(iters))
