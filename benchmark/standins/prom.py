"""The Prometheus the controller queries: a frozen copy of the port's
`collector/prometheus.py FakePromAPI` (answers keyed by the exact query
string; an unknown query answers one fresh sample of 1.0) behind a fixed
latency per query, as `bench_torch_collect.LatencyPromAPI` puts it.

Grouped fleet queries answer one labelled sample per (model, namespace)
group; `set_group` replaces one group's samples in place, so a load
change costs the harness what it touches and not the fleet.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass


@dataclass
class Sample:
    labels: dict
    value: float
    timestamp: float  # unix seconds


class PromStandIn:
    def __init__(self, now, latency_s: float, sleep=time.sleep):
        self._now = now
        self.latency_s = float(latency_s)
        self._sleep = sleep
        self._lock = threading.Lock()
        self.single: dict[str, list] = {}
        self.grouped: dict[str, dict] = {}
        self.count = 0

    def set_single(self, promql: str, value: float) -> None:
        s = Sample(labels={}, value=float(value), timestamp=self._now())
        with self._lock:
            self.single[promql] = [s]

    def set_group(self, promql: str, labels: dict, value: float) -> None:
        key = tuple(sorted(labels.items()))
        s = Sample(labels=dict(labels), value=float(value),
                   timestamp=self._now())
        with self._lock:
            self.grouped.setdefault(promql, {})[key] = s

    def declare_grouped(self, promql: str) -> None:
        with self._lock:
            self.grouped.setdefault(promql, {})

    def query(self, promql: str) -> list:
        with self._lock:
            self.count += 1
            if promql in self.grouped:
                out = list(self.grouped[promql].values())
            elif promql in self.single:
                out = list(self.single[promql])
            else:
                out = [Sample(labels={}, value=1.0, timestamp=self._now())]
        if self.latency_s > 0:
            self._sleep(self.latency_s)
        return out
