"""Gate on the sharding machinery's weak-scaling overhead (VERDICT r2 #6).

On the 8-virtual-device CPU mesh every device shares the same host
cores, so running the SAME chain population sharded vs unsharded
executes identical FLOPs on identical silicon; the wall-clock ratio
isolates what the sharding layer (shard_map dispatch, pooled-adaptation
collectives, device-folded RNG) costs.  BASELINE.json:11's >= 80%
efficiency gate is applied to that ratio here; the real-pod protocol is
docs/multihost.md + benchmarks/weak_scaling.py.
"""

import sys
import os

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))

from benchmarks.weak_scaling import constant_work_efficiency  # noqa: E402
import pytest

# slow tier (VERDICT r2 item 8): minutes-long on 4 host cores; run via
# `make test-all` / CI. The default `make test` gate stays < 10 min.
pytestmark = pytest.mark.slow


def test_sharding_overhead_efficiency_gate():
    # moderate sizes keep this under ~1 min on 4 host cores while the
    # collection phase is long enough to dominate compile/dispatch noise.
    # n_devices=None -> min(virtual devices, physical cores): an
    # oversubscribed mesh (8 device threads on 4 cores) measures XLA-CPU
    # collective busy-waiting, not the sharding layer — measured round 4:
    # eff 1.19 at 2/4 devices vs 0.49 at 8 on this 4-core host
    # (round-4 measurement).
    eff = constant_work_efficiency(
        n_chains=256, num_warmup=60, num_samples=60, verbose=True
    )
    assert eff >= 0.8, (
        f"sharded ChEES (non-oversubscribed virtual mesh) is "
        f"{1/eff:.2f}x slower than the identical unsharded run — "
        f"sharding overhead exceeds the 20% weak-scaling budget "
        f"(BASELINE.json:11)"
    )


def test_sharding_overhead_8dev_oversubscribed_floor():
    # ADVICE r4: the >=0.8 gate above runs on a non-oversubscribed mesh,
    # which on this 4-core host means the 8-device configuration is no
    # longer asserted at all.  Keep it asserted at a LOOSER documented
    # bound: the measured oversubscription collapse is 0.49-0.59 (XLA-CPU
    # collectives busy-waiting, 8 device threads on 4 cores —
    # round-4 measurement), so 0.30
    # leaves ~40% headroom for host noise while still catching a genuine
    # sharding-layer regression (which would land far below).  On hosts
    # with >= 8 physical cores the mesh is not oversubscribed and the
    # same assertion tightens naturally via the measured ratio.
    import os

    eff = constant_work_efficiency(
        n_chains=256, num_warmup=60, num_samples=60, verbose=True,
        n_devices=8,
    )
    floor = 0.30 if (os.cpu_count() or 1) < 8 else 0.8
    assert eff >= floor, (
        f"8-device sharded ChEES efficiency {eff:.2f} fell below the "
        f"documented {floor} floor (measured oversubscribed baseline "
        f"0.49-0.59 on a 4-core host) — sharding-layer regression"
    )
