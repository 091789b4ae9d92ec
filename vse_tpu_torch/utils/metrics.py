"""Per-stage throughput counters (the port of ``vse_tpu/utils/metrics.py``,
unchanged: thread-safe, the same ``report()`` and ``as_dict()``).

The reference's only instrumentation is wall-clock prints and tqdm bars.
Here per-stage items/second counters are first-class: wrap a stage in
``StageTimer.stage`` and read ``report()`` or ``as_dict()``.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Dict


@dataclass
class Throughput:
    """Counts items and elapsed time for one pipeline stage."""

    name: str
    items: int = 0
    seconds: float = 0.0

    def add(self, n: int, dt: float) -> None:
        self.items += n
        self.seconds += dt

    @property
    def per_second(self) -> float:
        return self.items / self.seconds if self.seconds > 0 else 0.0

    def __str__(self) -> str:
        return f"{self.name}: {self.items} items, {self.per_second:.1f}/s"


class StageTimer:
    """Thread-safe registry of stage throughputs.

    Usage:
        timer = StageTimer()
        with timer.stage("det", n=batch):
            ...device call...
        print(timer.report())
    """

    def __init__(self):
        self._stages: Dict[str, Throughput] = {}
        self._lock = threading.Lock()

    def get(self, name: str) -> Throughput:
        with self._lock:
            if name not in self._stages:
                self._stages[name] = Throughput(name)
            return self._stages[name]

    def stage(self, name: str, n: int = 1):
        timer = self

        class _Ctx:
            def __enter__(self):
                self.t0 = time.perf_counter()
                return self

            def __exit__(self, *exc):
                timer.get(name).add(n, time.perf_counter() - self.t0)
                return False

        return _Ctx()

    def report(self) -> str:
        with self._lock:
            return "; ".join(str(s) for s in self._stages.values())

    def as_dict(self) -> Dict[str, float]:
        with self._lock:
            return {k: v.per_second for k, v in self._stages.items()}
