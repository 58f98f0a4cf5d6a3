"""The device trace of a traced window: torch.profiler's CUDA activity
(kernels, copies, sets) as (name, start_ns, end_ns) on the host's clock,
and the breakdown the result line carries."""

from __future__ import annotations

from collections import defaultdict
from typing import Sequence

from .stats import clip, merge, split


class DeviceTrace:
    """torch.profiler over the window, CUDA activity only, so the host's
    own operations are not recorded and pay no profiler cost."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CUDA])

    def start(self) -> None:
        self._prof.start()

    def stop(self) -> "list[tuple[str, int, int]]":
        self._prof.stop()
        events = self._prof.profiler.kineto_results.events()
        return [(e.name(), e.start_ns(), e.end_ns()) for e in events
                if str(e.device_type()).endswith("CUDA")]


def is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset"))


def short_name(name: str, keep: int = 160) -> str:
    """A device operation's name as the breakdown keeps it: ATen's
    kernels are named by their whole template, cut here to `keep`
    characters."""
    return name if len(name) <= keep else name[:keep] + "..."


def busy_intervals(events, windows: "Sequence[tuple[int, int]]"
                   ) -> "list[tuple[int, int]]":
    """The device's busy time inside the request windows."""
    return clip(merge((s, e) for _, s, e in events), merge(windows))


def breakdown(events, windows: "Sequence[tuple[int, int]]",
              top: int = 10) -> dict:
    """device_ops: seconds by operation name; idle_gaps: seconds of each
    request's idle device by what the host was doing, told by position:
    before the request's first device operation (service and encode),
    between its operations (the enqueue), after its last (read-back,
    decode and service), or in a request with no device operation."""
    by_op: "dict[str, float]" = defaultdict(float)
    for name, s, e in events:
        by_op[short_name(name)] += (e - s) / 1e9
    busy = merge((s, e) for _, s, e in events)
    windows = merge(windows)
    gaps: "dict[str, float]" = defaultdict(float)
    for (ws, we), inside in zip(windows, split(busy, windows)):
        if not inside:
            gaps["no_device_op"] += (we - ws) / 1e9
            continue
        gaps["before_first_device_op"] += (inside[0][0] - ws) / 1e9
        gaps["after_last_device_op"] += (we - inside[-1][1]) / 1e9
        gaps["between_device_ops"] += sum(
            b[0] - a[1] for a, b in zip(inside, inside[1:])) / 1e9

    def ranked(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])
                ][:top]

    return {"device_ops": ranked(by_op), "idle_gaps": ranked(gaps)}
