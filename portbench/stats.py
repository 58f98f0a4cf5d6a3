"""The yardstick's arithmetic: percentiles over every request, and the
device's busy time as the union of its operations' intervals."""

from __future__ import annotations

from typing import Iterable, Sequence


def percentile(values: "Sequence[float]", q: float) -> float:
    """The q-th percentile of every value, linear between closest ranks
    (numpy's default method), in plain Python."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def merge(intervals: "Iterable[tuple[int, int]]") -> "list[tuple[int, int]]":
    """The union of [start, end) intervals, sorted and disjoint."""
    out: "list[list[int]]" = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def split(intervals: "Sequence[tuple[int, int]]",
          windows: "Sequence[tuple[int, int]]"
          ) -> "list[list[tuple[int, int]]]":
    """For each of the sorted disjoint `windows`, the parts of the sorted
    disjoint `intervals` inside it."""
    out, j = [], 0
    for ws, we in windows:
        while j < len(intervals) and intervals[j][1] <= ws:
            j += 1
        part, k = [], j
        while k < len(intervals) and intervals[k][0] < we:
            s, e = max(intervals[k][0], ws), min(intervals[k][1], we)
            if s < e:
                part.append((s, e))
            k += 1
        out.append(part)
    return out


def clip(intervals: "Sequence[tuple[int, int]]",
         windows: "Sequence[tuple[int, int]]") -> "list[tuple[int, int]]":
    """The parts of sorted disjoint `intervals` inside sorted disjoint
    `windows`."""
    return [iv for part in split(intervals, windows) for iv in part]


def covered(intervals: "Sequence[tuple[int, int]]") -> int:
    return sum(e - s for s, e in intervals)
