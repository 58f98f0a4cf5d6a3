"""Metric readers: one file a metric, portbench/end_to_end/<name>.py or
portbench/layers/<name>.py, found by the metric's name in BENCHMARK.json.
A reader's `read(run)` returns the metric's value, or None where the run
holds nothing for it to read (the metric is then left out of the line).

`run` is a Run: the cell's requests as the window issued them, and with
`--trace 1` the device's operations over the same window."""

from __future__ import annotations

import dataclasses
import importlib.util
import os
from typing import Optional

from .generator import PKG
from .stats import covered
from .trace import busy_intervals, is_copy


@dataclasses.dataclass
class Run:
    kind: str                    # the traffic's request kind: "solve"
    requests: "list[dict]"       # wall_s, t0_ns, t1_ns, pods, answered, counters
    setup_s: float
    device: "Optional[list]" = None   # (name, start_ns, end_ns), traced runs

    @property
    def window_s(self) -> float:
        return sum(r["wall_s"] for r in self.requests)

    @property
    def windows_ns(self) -> "list[tuple[int, int]]":
        return [(r["t0_ns"], r["t1_ns"]) for r in self.requests]

    def answered(self) -> "list[dict]":
        return [r for r in self.requests if r["answered"]]

    def mean_counter(self, kind: str, fn) -> Optional[float]:
        """The mean over answered requests of `fn(request)`, in a run of
        `kind`; None otherwise."""
        rs = self.answered() if self.kind == kind else []
        if not rs:
            return None
        return sum(fn(r) for r in rs) / len(rs)

    def busy_s(self) -> float:
        return covered(busy_intervals(self.device, self.windows_ns)) / 1e9

    def idle_share(self, kind: str) -> Optional[float]:
        if self.kind != kind or not self.device or not self.requests:
            return None
        return 100.0 * (1.0 - self.busy_s() / self.window_s)

    def device_ms_per_request(self, kind: str, names) -> Optional[float]:
        """Device ms a request of the operations whose names hold one of
        `names`; None where none ran."""
        if self.kind != kind or not self.device or not self.requests:
            return None
        ns = [e - s for n, s, e in self.device
              if any(k in n for k in names)]
        if not ns:
            return None
        return sum(ns) / 1e6 / len(self.requests)

    def kernels(self) -> "list[tuple[str, int, int]]":
        return [ev for ev in (self.device or ()) if not is_copy(ev[0])]


def reader(group: str, name: str):
    path = os.path.join(PKG, group, f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"portbench_{group}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
