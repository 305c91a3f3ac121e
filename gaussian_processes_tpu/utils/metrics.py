"""Structured metrics logging (SURVEY.md §6.5).

The reference reports nothing beyond return values; this framework's
observability surface is a lightweight JSONL logger: one JSON object per
event to stdout and/or a file — steps/s, samples/s, acceptance rate,
divergence count, step size, per-phase wall-clock.
"""

from __future__ import annotations

import json
import sys
import time
from contextlib import contextmanager
from typing import IO, Optional


class MetricsLogger:
    def __init__(self, path: Optional[str] = None, stream: Optional[IO] = None,
                 echo: bool = True):
        self._file = open(path, "a") if path else None
        self._stream = stream if stream is not None else (sys.stdout if echo else None)
        self._t0 = time.time()

    def log(self, event: str, **fields) -> dict:
        rec = {"event": event, "t": round(time.time() - self._t0, 4), **fields}
        line = json.dumps(rec, default=float)
        if self._file:
            self._file.write(line + "\n")
            self._file.flush()
        if self._stream:
            print(line, file=self._stream, flush=True)
        return rec

    @contextmanager
    def phase(self, name: str, **fields):
        """Wall-clock a phase; emits ``{event: phase, name, wall_s}``."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.log("phase", name=name, wall_s=round(time.perf_counter() - t0, 6),
                     **fields)

    def close(self):
        if self._file:
            self._file.close()
            self._file = None


def summarize_nuts(result) -> dict:
    """Standard sampler health summary from a (Sharded)NUTSResult."""
    import numpy as np

    acc = np.asarray(result.accept_prob)
    div = np.asarray(result.diverging)
    nl = np.asarray(result.num_leapfrog)
    return {
        "n_samples": int(acc.shape[0]),
        "n_chains": int(acc.shape[1]),
        "accept_rate": float(acc.mean()),
        "divergence_frac": float(div.mean()),
        "mean_leapfrog": float(nl.mean()),
        "step_size": float(np.asarray(result.step_size)),
    }
