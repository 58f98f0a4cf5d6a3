"""Run one cell of the port's benchmark once.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout on a machine with the cell's CUDA cards. The
cell, its configuration and its traffic come from BENCHMARK.json and the
files it names under portbench/. Set-up builds the port's catalog from the
frozen JSON, syncs one SolverService, and warms every request shape the
traffic sends; then a closed loop of one caller issues the traffic's
Solves for `--seconds` of the caller's waiting (the clock stops while the
caller builds its next request). Each request is timed on the host around
the service call, which ends with its answer on the host. The interpreter's
garbage collector is left as the service leaves it. After the window
a sample of the answers, drawn from the seed, is compared with the
reference (portbench/reference).

The last line of standard output is one JSON object: correct, attempted,
failed, metrics (the cell's end-to-end metrics, or with --trace 1 its
per-layer metrics, read from a device trace of the same window), device,
with --trace 1 a breakdown, and last the numbers compared with their
limits, which are also the last lines of standard error.

Without a CUDA card, or with fewer than the cell asks for, it prints no
result and exits 2; with JAX or the JAX package loaded once the window
has closed, it exits 3.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

from .generator import PKG, Traffic, load_json

# the fewest answers a run checks against the reference
CHECK_MIN = 64

# top-level module names no run may hold (compared whole)
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "karpenter_tpu", "benchmarks",
                     "bench", "chip_smoke")


def process_age() -> float:
    """Seconds since this process started (Linux)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def fix_environment() -> None:
    """Caches inside the checkout, at fixed paths; no library loads JAX."""
    cache = os.path.join(PKG, ".cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def forbidden_loaded() -> "list[str]":
    return sorted({m.split(".", 1)[0] for m in sys.modules}
                  & set(FORBIDDEN_MODULES))


def cell_spec(bench: dict, workload: str) -> "tuple[dict, dict, dict]":
    cell = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if cell is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    config = next(c for c in bench["configs"] if c["name"] == cell["config"])
    return (cell, load_json(config["file"]),
            load_json(f"portbench/traffic/{cell['traffic']}.json"))


def metrics_of(bench: dict, cell: dict, trace: bool) -> "list[dict]":
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group
            if "workloads" not in m or cell["name"] in m["workloads"]]


def run_cell(bench: dict, cell: dict, config: dict, traffic: dict, seed: int,
             seconds: float, trace: bool, device=None, system=None,
             log=sys.stderr) -> dict:
    """One run of a cell. -> the result object. `device` None is the CUDA
    card; the tests pass "cpu" and their own broken `system`."""
    import torch

    from .drive import System
    from .readers import Run, reader
    from .reference.answer import Reference
    from .trace import breakdown

    gen = Traffic(config, traffic, seed)
    t_start = process_age()
    if system is None:
        system = System(config, device=device)
    on_card = system.device_type == "cuda"
    t_synced = process_age()
    for rec in gen.warmup():
        system.call(rec, system.inputs(rec))
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = process_age()
    print(f"set-up: {t_start:.2f} s to the harness, {t_synced - t_start:.2f}"
          f" s to a synced service, {setup_s - t_synced:.2f} s of warm-up",
          file=log)

    requests, answers, events = window(system, gen, seconds, trace)
    memory_peak = torch.cuda.max_memory_allocated() if on_card else 0

    # the program's state goes before the reference runs
    system = None
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    ref = Reference(config)
    wrong = sum(1 for r in requests if not r["answered"])
    sample = checked(requests, seed)
    t_ref = time.perf_counter()
    for k in sample:
        got = answers[k]
        if not requests[k]["answered"]:
            continue
        want = ref.answer(gen.request(k))
        if got != want:
            wrong += 1
            if wrong <= 3:
                print(f"request {k}: program {got!r}\n  reference {want!r}",
                      file=log)
    t_ref = time.perf_counter() - t_ref
    rung = traffic.get("require_rung")
    failed = sum(1 for r in requests if not r["answered"]
                 or (rung and r["counters"].get("routing") != rung))
    for r in requests:
        if r["error"]:
            print(f"failed request: {r['error']}", file=log)
            break

    run = Run(kind=gen.kind, requests=requests, setup_s=setup_s,
              device=events)
    metrics = {}
    for m in metrics_of(bench, cell, trace):
        group = "layers" if trace else "end_to_end"
        value = reader(group, m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    rungs: "dict[str, int]" = {}
    for r in requests:
        key = str(r["counters"].get("routing"))
        rungs[key] = rungs.get(key, 0) + 1
    misses = sum(1 for r in requests
                 if r["counters"].get("compile_cache") == "miss")
    print(f"rungs {json.dumps(rungs)}; first dispatches of a shape in the "
          f"window: {misses}; requests {len(requests)}; waited "
          f"{run.window_s:.3f} s; the reference checked {len(sample)} in "
          f"{t_ref:.3f} s", file=log)

    result = {"correct": wrong == 0, "attempted": len(requests),
              "failed": failed, "metrics": metrics,
              "device": device_info(on_card, memory_peak)}
    if trace and events is not None:
        result["device"]["busy_s"] = run.busy_s()
        result["device"]["window_s"] = run.window_s
        result["breakdown"] = breakdown(events, run.windows_ns)
    checks = {"wrong_answers": {"value": wrong, "limit": 0}}
    for name, c in checks.items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=log)
    result["checks"] = checks
    return result


def checked(requests: "list[dict]", seed: int) -> "list[int]":
    """The requests whose answers the reference checks: an eighth of the
    window's, at least CHECK_MIN, drawn from the seed, and the one with the
    most pods among them; in window order."""
    import numpy as np

    n = len(requests)
    k = min(n, max(CHECK_MIN, n // 8))
    pick = set(np.random.default_rng([seed % 2**63, 3]).choice(
        n, size=k, replace=False).tolist())
    if n:
        pick.add(max(range(n), key=lambda i: requests[i]["pods"]))
    return sorted(pick)


def window(system, gen, seconds: float, trace: bool):
    """The closed loop: request i of the traffic, built while the clock
    stands, then issued and timed, until the caller has waited `seconds`.
    -> (requests, answers, device events or None). A request's record
    holds its wall, its window on the profiler's clock, the pods it
    carried, whether it was answered, the program's counters, and the
    seconds the interpreter's garbage collector ran inside it."""
    from .trace import DeviceTrace

    gc_s = [0.0, 0.0]  # collecting since, collected in the current request

    def on_gc(phase, _info):
        if phase == "start":
            gc_s[0] = time.perf_counter()
        else:
            gc_s[1] += time.perf_counter() - gc_s[0]

    requests, answers = [], []
    prof = DeviceTrace() if trace else None
    gc.callbacks.append(on_gc)
    try:
        if prof is not None:
            prof.start()
        waited, i = 0.0, 0
        while waited < seconds:
            rec = gen.request(i)
            inputs = system.inputs(rec)
            gc_s[1] = 0.0
            t0_ns, t0 = time.time_ns(), time.perf_counter()
            try:
                out = system.call(rec, inputs)
            except Exception as e:  # a request that raises is failed
                t1, t1_ns = time.perf_counter(), time.time_ns()
                out = {"t0": t0, "t1": t1, "t0_ns": t0_ns, "t1_ns": t1_ns,
                       "answer": None, "counters": {"routing": "error"},
                       "error": f"{type(e).__name__}: {e}"}
            gc_in = gc_s[1]
            answered = "error" not in out and out["answer"] is not None
            requests.append({
                "wall_s": out["t1"] - out["t0"], "t0_ns": out["t0_ns"],
                "t1_ns": out["t1_ns"], "answered": answered,
                "pods": int(rec["counts"].sum()),
                "gc_s": gc_in, "counters": out["counters"],
                "error": out.get("error")})
            answers.append(out["answer"])
            waited += out["t1"] - out["t0"]
            i += 1
            del inputs
        events = prof.stop() if prof is not None else None
    finally:
        gc.callbacks.remove(on_gc)
    return requests, answers, events


def device_info(on_card: bool, memory_peak: int) -> dict:
    import torch

    if not on_card:
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": 1, "memory_peak_bytes": int(memory_peak)}


def main(argv=None) -> int:
    fix_environment()
    p = argparse.ArgumentParser(prog="python3 -m portbench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    bench = load_json("BENCHMARK.json")
    cell, config, traffic = cell_spec(bench, args.workload)
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA card(s); "
              f"torch sees {torch.cuda.device_count()}: no result",
              file=sys.stderr)
        return 2
    result = run_cell(bench, cell, config, traffic, args.seed, args.seconds,
                      bool(args.trace))
    loaded = forbidden_loaded()
    if loaded:
        print(f"modules loaded that no run may hold: {loaded}",
              file=sys.stderr)
        return 3
    sys.stdout.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
