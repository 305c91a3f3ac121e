"""Fake-two-process ``jax.distributed`` exercise (SURVEY.md §5 Tier 2).

Spawns two local CPU processes with JAX_COORDINATOR_ADDRESS /
JAX_NUM_PROCESSES / JAX_PROCESS_ID pointing at a local coordinator, so
``parallel/multihost.py``'s real bring-up branch executes, a sharded-NUTS
mini run spans the 4-device global mesh, and each host writes/reads its
own checkpoint shard.  Skipped only if the platform refuses distributed
bring-up (connection/unimplemented errors), per VERDICT r1 item 4.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

_REPO = Path(__file__).resolve().parent.parent
_WORKER = Path(__file__).resolve().parent / "multihost_worker.py"

_REFUSAL_MARKERS = (
    "UNIMPLEMENTED",
    "failed to connect",
    "Connection refused",
    "DEADLINE_EXCEEDED",
    "coordination service",
)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.slow
def test_two_process_distributed_nuts(tmp_path):
    port = _free_port()
    out_base = tmp_path / "mh_ckpt.npz"

    procs = []
    for pid in range(2):
        env = dict(os.environ)
        env.update(
            JAX_PLATFORMS="cpu",
            XLA_FLAGS="--xla_force_host_platform_device_count=2",
            JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
            JAX_NUM_PROCESSES="2",
            JAX_PROCESS_ID=str(pid),
            PYTHONPATH=str(_REPO),
        )
        procs.append(
            subprocess.Popen(
                [sys.executable, str(_WORKER), str(out_base)],
                env=env,
                stdout=subprocess.PIPE,
                stderr=subprocess.PIPE,
                text=True,
                cwd=str(_REPO),
            )
        )

    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=300)
            outs.append((p.returncode, out, err))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("two-process distributed run timed out")

    for rc, out, err in outs:
        if rc != 0 and any(m in err for m in _REFUSAL_MARKERS):
            pytest.skip(f"platform refused distributed bring-up: {err[-300:]}")
    for rc, out, err in outs:
        assert rc == 0, f"worker failed:\nstdout={out}\nstderr={err[-2000:]}"
        assert "WORKER_OK" in out

    # exactly one primary
    assert sum("PRIMARY_OK" in out for _, out, _ in outs) == 1

    # host-sharded checkpoints: one per process, disjoint chain blocks,
    # identical replicated step size (pooled adaptation)
    ck0 = np.load(tmp_path / "mh_ckpt.host0.npz")
    ck1 = np.load(tmp_path / "mh_ckpt.host1.npz")
    assert ck0["positions"].shape == (10, 4, 3)
    assert ck1["positions"].shape == (10, 4, 3)
    assert not np.allclose(ck0["positions"], ck1["positions"])
    assert ck0["step_size"] == ck1["step_size"]
