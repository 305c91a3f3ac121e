"""Utility layer: test oracles, config, metrics, checkpointing, profiling
(SURVEY.md §6 auxiliary subsystems)."""

from gaussian_processes_tpu.utils.checkpoint import load_pytree, save_pytree
from gaussian_processes_tpu.utils.config import (
    CONFIGS,
    DataConfig,
    FitConfig,
    KernelConfig,
    MeshConfig,
    MLEConfig,
    NUTSConfig,
    RunConfig,
    make_data,
    make_kernel,
)
from gaussian_processes_tpu.utils.metrics import MetricsLogger, summarize_nuts
from gaussian_processes_tpu.utils.compile_cache import enable_compile_cache
from gaussian_processes_tpu.utils.profiling import (
    device_peaks,
    fit_flops,
    roofline,
    timed,
    trace,
)

__all__ = [
    "load_pytree",
    "save_pytree",
    "CONFIGS",
    "DataConfig",
    "FitConfig",
    "KernelConfig",
    "MeshConfig",
    "MLEConfig",
    "NUTSConfig",
    "RunConfig",
    "make_data",
    "make_kernel",
    "MetricsLogger",
    "summarize_nuts",
    "device_peaks",
    "enable_compile_cache",
    "fit_flops",
    "roofline",
    "timed",
    "trace",
]
