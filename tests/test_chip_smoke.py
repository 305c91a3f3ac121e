"""CPU rehearsal of ``chip_smoke.py``: every phase at toy sizes.

The phases run exactly as on the card, with the fused kernels in the
Pallas interpreter and the four-card phases on virtual CPU devices.
The script itself must refuse to run without a GPU and print no result.
"""

import dataclasses
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

_REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(_REPO))

import chip_smoke  # noqa: E402

TINY = dataclasses.replace(
    chip_smoke.FULL,
    dense_n=256, dense_test=32, mle_steps=3, chains=4, sampler_n=40,
    warmup=4, samples=4, iter_n=1024, iter_sub=4, precond_rank=64,
    cg_block=256, kernel_n=300, twofloat_n=4096, bc_n=512, bc_block=32,
    sharded_chains=8, chees_step_rtol=0.5, nuts_step_rtol=0.5,
    interpret=True,
)


@pytest.mark.parametrize("name", sorted(chip_smoke.ONE_CARD))
def test_one_card_phase_rehearsal(name):
    out = chip_smoke.ONE_CARD[name](TINY)
    assert isinstance(out, dict) and out


@pytest.mark.parametrize("name", sorted(chip_smoke.FOUR_CARDS))
def test_four_card_phase_rehearsal(name):
    out = chip_smoke.FOUR_CARDS[name](TINY)
    assert isinstance(out, dict) and out


def _run_alone(cwd, *args):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run(
        [sys.executable, "chip_smoke.py", *args], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300,
    )


@pytest.mark.parametrize("args", [(), ("--chips", "4")])
def test_refuses_without_gpu(args):
    proc = _run_alone(_REPO, *args)
    assert proc.returncode == 2, proc.stderr[-2000:]
    assert "no GPU" in proc.stderr
    assert '"ok"' not in proc.stdout


def test_fails_outside_the_repo(tmp_path):
    shutil.copy(_REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH="")
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_check_rejects_nan_and_excess():
    chip_smoke._check("x", 1e-4, 1e-3)
    with pytest.raises(chip_smoke.CheckFailed):
        chip_smoke._check("x", 2e-3, 1e-3)
    with pytest.raises(chip_smoke.CheckFailed):
        chip_smoke._check("x", float("nan"), 1e-3)


@pytest.mark.parametrize("sampler", ["chees", "nuts"])
@pytest.mark.parametrize("pooled", [True, False])
def test_replica_spread_catches_per_device_adaptation(monkeypatch, sampler,
                                                      pooled):
    """The four-card phase's pooling check on four virtual devices: pooled
    adaptation leaves one step size on every device, and a planted fault
    that adapts each device on its own chains (no pmean) is caught."""
    import jax.numpy as jnp

    from gaussian_processes_tpu.parallel import (
        make_chain_mesh,
        sample_chees_sharded,
        sample_nuts_sharded,
        sharded,
    )

    if not pooled:
        def local(axis):
            return (lambda x: jnp.mean(x)), (lambda w: w)

        monkeypatch.setattr(sharded, "_pooled_reducers", local)
        monkeypatch.setattr(
            sharded, "_chees_reducers",
            lambda axis: (*local(axis), lambda x: jnp.mean(x, axis=0)))
    sz = dataclasses.replace(TINY, sharded_chains=16)
    log_post, init, key = chip_smoke.sharded_sampler_problem(sz)
    fn = sample_chees_sharded if sampler == "chees" else sample_nuts_sharded
    extra = {"max_depth": 4} if sampler == "nuts" else {}
    r = fn(log_post, init, key, mesh=make_chain_mesh(4), num_warmup=8,
           num_samples=2, init_step_size=0.05, **extra)
    spread = chip_smoke.replica_spread(r.step_size)
    if pooled:
        assert spread <= chip_smoke.REPLICA_RTOL
    else:
        assert spread > 10 * chip_smoke.REPLICA_RTOL
