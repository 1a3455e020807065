"""Stage timing and the real-time factor (port of
diffse_tpu/train/profiling.py; the device traces are
``diffse_tpu_torch.profiling``'s).

  - :class:`StageTimer`: named wall-clock stages, each ended by a
    synchronisation of the CUDA device when one is in use, so that the time
    covers the stage's device work;
  - :func:`rtf`: the real-time factor.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict

import torch


class StageTimer:
    """Named wall-clock stage timing with device sync.

    Usage:
        timer = StageTimer()
        with timer.stage("stft"):
            ...
        print(timer.summary())
    """

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def stage(self, name: str, sync: bool = True):
        t0 = time.perf_counter()
        yield
        if sync and torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        self.totals[name] = self.totals.get(name, 0.0) + dt
        self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> str:
        lines = []
        for name, total in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            n = self.counts[name]
            lines.append(f"{name}: {total:.3f}s total, {total / n * 1e3:.1f}ms avg x{n}")
        return "\n".join(lines)


def rtf(wall_seconds: float, audio_seconds: float) -> float:
    """Real-time factor: processing seconds per second of audio (< 1 is faster
    than real time)."""
    return wall_seconds / audio_seconds
