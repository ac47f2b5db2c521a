"""Tracing / profiling utilities.

Counterpart of `vins_tpu/utils/trace.py` (the reference's TicToc and
printStatistics, vins_estimator/src/utility/tic_toc.h,
visualization.cpp:65-104): `TicToc`, `StageStats` (running mean/max/count
per named stage) and `Tracer` (context-manager spans feeding a StageStats,
with one structured JSON line per `emit`).

Device time: CUDA launches return before the work is done.  A `Tracer`
built with `sync=torch.cuda.synchronize` waits for the device at the end of
every span, so a span's wall time covers the work it queued; without it a
span that ends in no blocking copy measures only the time to queue.
"""
from __future__ import annotations

import json
import time
from contextlib import contextmanager


class TicToc:
    """Wall-clock stopwatch (tic_toc.h API: construct = tic, toc → ms)."""

    def __init__(self):
        self.tic()

    def tic(self):
        self._t0 = time.perf_counter()

    def toc(self) -> float:
        return (time.perf_counter() - self._t0) * 1e3


class StageStats:
    """Running per-stage statistics (printStatistics's running averages)."""

    def __init__(self):
        self._n: dict = {}
        self._sum: dict = {}
        self._max: dict = {}
        self._last: dict = {}

    def reset(self):
        """Drop accumulated stats (e.g. after a warm-up segment)."""
        self.__init__()

    def add(self, stage: str, ms: float):
        self._n[stage] = self._n.get(stage, 0) + 1
        self._sum[stage] = self._sum.get(stage, 0.0) + ms
        self._max[stage] = max(self._max.get(stage, 0.0), ms)
        self._last[stage] = ms

    def mean(self, stage: str) -> float:
        n = self._n.get(stage, 0)
        return self._sum.get(stage, 0.0) / n if n else 0.0

    def last(self, stage: str) -> float:
        return self._last.get(stage, 0.0)

    def count(self, stage: str) -> int:
        return self._n.get(stage, 0)

    def snapshot(self) -> dict:
        return {
            s: {"n": self._n[s], "mean_ms": round(self.mean(s), 3),
                "max_ms": round(self._max[s], 3),
                "last_ms": round(self._last[s], 3)}
            for s in sorted(self._n)
        }

    def report(self) -> str:
        return "\n".join(
            f"{s:24s} n={v['n']:6d} mean={v['mean_ms']:8.3f}ms "
            f"max={v['max_ms']:8.3f}ms" for s, v in self.snapshot().items()
        )


class Tracer:
    """Instrumentation hub: `with tracer.span("solve"): ...` accumulates into
    StageStats; `emit()` returns one JSON line (structured trace record).
    `sync`, when given, is called before a span's clock stops."""

    def __init__(self, enabled: bool = True, sync=None):
        self.enabled = enabled
        self.sync = sync
        self.stats = StageStats()

    @contextmanager
    def span(self, stage: str):
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self.sync is not None:
                self.sync()
            self.stats.add(stage, (time.perf_counter() - t0) * 1e3)

    def emit(self, **extra) -> str:
        rec = {"stats": self.stats.snapshot()}
        rec.update(extra)
        return json.dumps(rec, sort_keys=True)
