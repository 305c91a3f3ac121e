"""Multi-host runtime bring-up and host-local checkpoint naming.

SURVEY.md §6.8: multi-process runs are brought up with
``jax.distributed.initialize`` (XLA then hands collectives to NCCL on
GPU hosts).  This wrapper is idempotent, no-ops in single-process
settings, and degrades cleanly on CPU test rigs, so the same launch
script works on a laptop, one GPU host, or several (docs/multihost.md).
"""

from __future__ import annotations

import os

import jax

_initialized = False


def initialize_cluster(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> dict:
    """Bring up jax.distributed if a multi-process env is configured.

    Resolution order: explicit args > JAX_COORDINATOR_ADDRESS /
    JAX_NUM_PROCESSES / JAX_PROCESS_ID env vars > single-process no-op.

    Returns a summary dict (process_index, process_count, device counts).
    """
    global _initialized
    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS"
    )
    env_np = os.environ.get("JAX_NUM_PROCESSES")
    num_processes = num_processes if num_processes is not None else (
        int(env_np) if env_np else None
    )
    env_pid = os.environ.get("JAX_PROCESS_ID")
    process_id = process_id if process_id is not None else (
        int(env_pid) if env_pid else None
    )

    if (not _initialized and coordinator_address and num_processes
            and num_processes > 1):
        if process_id is None:
            # defaulting to 0 on every host would register duplicate
            # process ids and hang the coordinator
            raise ValueError(
                "multi-process bring-up needs an explicit per-host "
                "process_id (or JAX_PROCESS_ID in the environment)"
            )
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
        _initialized = True

    return {
        "process_index": jax.process_index(),
        "process_count": jax.process_count(),
        "local_devices": len(jax.local_devices()),
        "global_devices": len(jax.devices()),
        "initialized": _initialized,
    }


def host_checkpoint_path(base: str) -> str:
    """Per-host checkpoint filename (sampler state is host-sharded)."""
    root, ext = os.path.splitext(base)
    return f"{root}.host{jax.process_index()}{ext or '.npz'}"


def is_primary() -> bool:
    """True on the process that should write logs/summaries."""
    return jax.process_index() == 0
