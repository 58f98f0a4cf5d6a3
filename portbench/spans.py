"""A Solve's span record, as the per-layer readers read it.

The program keeps one record a Solve, last_solve_info["spans"]: tuples
(name, start_ns, end_ns) on the profiler's clock (time.time_ns, the clock
of a request's window and of the device trace's events), which drive.py
copies into each request's counters. Where a Solve carries no record (a
program from before it had one), each reader here returns None.

    python3 -m portbench.spans --workload <cell> --seed <n> --seconds <s>

runs one traced window of a cell on the card and prints, as one JSON line,
the idle device time of a request put down to the span that covers it, and
the share of requests whose kernels all lie between the start of their
enqueue and the end of their transfer (the two clocks agree).
"""

from __future__ import annotations

import argparse
import bisect
import json
import sys
from typing import Optional

from .stats import clip, covered, merge, split

#: the spans no other span of the record holds (a collection lies inside
#: the phase it paused): the idle device time inside a request's window
#: that none of them covers is the host's unnamed time
LEAVES = ("solver.split", "solver.encode.groups", "solver.encode.fold",
          "solver.encode.bounds", "solver.dispatch.inputs",
          "solver.dispatch.enqueue", "solver.transfer", "solver.decode",
          "runtime.gc")


def records(run) -> "Optional[list]":
    """The answered Solves' span records; None where one has none."""
    rs = run.answered() if run.kind == "solve" else []
    recs = [r["counters"].get("spans") for r in rs]
    if not recs or any(rec is None for rec in recs):
        return None
    return recs


def intervals(record, name: str) -> "list[tuple[int, int]]":
    return merge((s, e) for n, s, e in record if n == name)


def span_ms(run, name: str) -> Optional[float]:
    """ms of the spans named `name` a Solve, a request's mean."""
    recs = records(run)
    if recs is None:
        return None
    return sum(covered(intervals(rec, name)) for rec in recs) / len(recs) / 1e6


def overlap_ms(run, name: str, within: str) -> Optional[float]:
    """ms of the spans named `name` inside those named `within` a Solve, a
    request's mean."""
    recs = records(run)
    if recs is None:
        return None
    return sum(covered(clip(intervals(rec, name), intervals(rec, within)))
               for rec in recs) / len(recs) / 1e6


def idle_parts(run) -> "Optional[list]":
    """For each answered Solve of a traced run, (the idle device intervals
    inside its window, its record); None without a trace or a record."""
    recs = records(run)
    if recs is None or not run.device:
        return None
    windows = [(r["t0_ns"], r["t1_ns"]) for r in run.answered()]
    busy = split(merge((s, e) for _, s, e in run.device), windows)
    out = []
    for (ws, we), inside, rec in zip(windows, busy, recs):
        edges = [ws] + [t for iv in inside for t in iv] + [we]
        idle = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if a < b]
        out.append((idle, rec))
    return out


def unspanned_idle_ms(run) -> Optional[float]:
    """ms a Solve of idle device time that no leaf span covers, a
    request's mean."""
    parts = idle_parts(run)
    if parts is None:
        return None
    leaves = set(LEAVES)
    total = 0
    for idle, rec in parts:
        spanned = merge((s, e) for n, s, e in rec if n in leaves)
        total += covered(idle) - covered(clip(spanned, idle))
    return total / len(parts) / 1e6


def idle_by_span(run) -> "Optional[dict]":
    """ms a Solve of idle device time under each leaf span (a collection's
    time is counted under runtime.gc and under the phase it paused), and
    `unspanned`, request means."""
    parts = idle_parts(run)
    if parts is None:
        return None
    out = {name: sum(covered(clip(intervals(rec, name), idle))
                     for idle, rec in parts) / len(parts) / 1e6
           for name in LEAVES}
    out["unspanned"] = unspanned_idle_ms(run)
    return out


def kernels_inside_share(run) -> "Optional[tuple[float, int]]":
    """The share of answered Solves whose kernels (those starting inside the
    Solve's window) all lie between the first start of its enqueue and the
    last end of its transfer, and the kernels that start inside no
    window."""
    recs = records(run)
    if recs is None or not run.device:
        return None
    kernels = sorted((s, e) for _, s, e in run.kernels())
    starts = [s for s, _ in kernels]
    rs = run.answered()
    good, seen = 0, 0
    for r, rec in zip(rs, recs):
        lo = bisect.bisect_left(starts, r["t0_ns"])
        hi = bisect.bisect_right(starts, r["t1_ns"])
        seen += hi - lo
        enq, tr = intervals(rec, "solver.dispatch.enqueue"), \
            intervals(rec, "solver.transfer")
        if not enq or not tr:
            continue
        a, b = enq[0][0], tr[-1][1]
        good += all(a <= s and e <= b for s, e in kernels[lo:hi])
    return good / len(rs), len(kernels) - seen


def main(argv=None) -> int:
    from . import run as bench_run
    from .drive import System
    from .generator import Traffic, load_json
    from .readers import Run, reader

    bench_run.fix_environment()
    p = argparse.ArgumentParser(prog="python3 -m portbench.spans")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA card: no result", file=sys.stderr)
        return 2
    bench = load_json("BENCHMARK.json")
    cell, config, traffic = bench_run.cell_spec(bench, args.workload)
    gen = Traffic(config, traffic, args.seed)
    system = System(config)
    for rec in gen.warmup():
        system.call(rec, system.inputs(rec))
    torch.cuda.synchronize()
    requests, _, events = bench_run.window(system, gen, args.seconds, True)
    run = Run(kind=gen.kind, requests=requests, setup_s=0.0, device=events)
    share = kernels_inside_share(run)
    out = {"device": torch.cuda.get_device_name(0),
           "requests": len(requests),
           "wall_ms": run.window_s * 1e3 / len(requests),
           "kernels_inside_share": share and share[0],
           "kernels_outside_windows": share and share[1],
           "idle_ms_by_span": idle_by_span(run),
           "metrics": {m["name"]: reader("layers", m["name"])(run)
                       for m in bench_run.metrics_of(bench, cell, True)}}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
