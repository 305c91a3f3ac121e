"""Native ops layer: structured operators and the fused GPU kernels.

The reference's only native code is its Cython kernel-evaluation
extensions.  Here plain jnp builds K and XLA fuses it; the Pallas
kernels in ``pairwise`` fuse the kernel build into the matrix-free
matvec (SURVEY.md §3 native callout).
"""

from gaussian_processes_tpu.ops.pairwise import (
    kernel_jacvec_fused,
    kernel_matvec_fused,
    tile_program,
)
from gaussian_processes_tpu.ops import host
from gaussian_processes_tpu.ops import kronecker
from gaussian_processes_tpu.ops import ski
from gaussian_processes_tpu.ops import toeplitz

__all__ = [
    "kronecker",
    "ski",
    "toeplitz",
    "kernel_jacvec_fused",
    "kernel_matvec_fused",
    "tile_program",
    "host",
]
