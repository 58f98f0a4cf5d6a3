"""A solve's span record (last_solve_info["spans"]), on the CPU.

* A solve records its phases once, as (name, start_ns, end_ns) on the
  profiler's clock (time.time_ns), in order and inside the solve's window;
  its encode_ms, dispatch_ms, transfer_ms and decode_ms are those spans'
  lengths, and the children cover their parents.
* A two-round (co-pending affinity) solve keeps both rounds' spans and sums
  its phase times.
* The tracer files each span at its start: the Chrome export and
  /debug/traces draw a solve's phases in sequence.
* A collection inside a solve is a runtime.gc span inside the phase it
  paused; with the profiling plane off the collector's ring stays as it
  was.
* Every literal span name the port records, and every name of a solve's
  record, is in the port's PHASE_REGISTRY (the port's counterpart of
  hack/check_phase_accounting.py, which scans the JAX package).
"""

from __future__ import annotations

import ast
import gc
import importlib.util
import time
from pathlib import Path

import pytest

from karpenter_tpu_torch import profiling
from karpenter_tpu_torch.apis import wellknown as wk
from karpenter_tpu_torch.apis.provisioner import Provisioner
from karpenter_tpu_torch.models import encode
from karpenter_tpu_torch.models.instancetype import Catalog, make_instance_type
from karpenter_tpu_torch.models.pod import PodAffinityTerm, make_pod
from karpenter_tpu_torch.profiling.gcpause import GC_PAUSES
from karpenter_tpu_torch.solver.core import TorchSolver
from karpenter_tpu_torch.tracing import (DYNAMIC_PHASE_PREFIXES,
                                         PHASE_REGISTRY, TRACER)

REPO = Path(__file__).resolve().parent.parent

PHASES = ("solver.split", "solver.encode", "solver.encode.groups",
          "solver.encode.fold", "solver.encode.bounds",
          "solver.dispatch.execute", "solver.dispatch.inputs",
          "solver.dispatch.enqueue", "solver.transfer", "solver.decode")
TOP = ("solver.split", "solver.encode", "solver.dispatch.execute",
       "solver.transfer", "solver.decode")
CHILDREN = {"solver.encode": ("solver.encode.groups", "solver.encode.fold",
                              "solver.encode.bounds"),
            "solver.dispatch.execute": ("solver.dispatch.inputs",
                                        "solver.dispatch.enqueue")}
TIMES = {"encode_ms": "solver.encode", "dispatch_ms": "solver.dispatch.execute",
         "transfer_ms": "solver.transfer", "decode_ms": "solver.decode"}


@pytest.fixture(autouse=True)
def _profiling_on():
    prev = profiling.set_enabled(True)
    yield
    profiling.set_enabled(prev)


def solver() -> TorchSolver:
    prov = Provisioner(name="default")
    prov.set_defaults()
    return TorchSolver(Catalog(types=[make_instance_type(
        "m.4x", cpu=4, memory="16Gi", od_price=0.2)]), [prov], device="cpu")


def pods(n: int) -> list:
    return [make_pod(f"p-{i}", cpu="1", memory="1Gi") for i in range(n)]


def two_round_pods() -> list:
    db = [make_pod(f"db-{i}", cpu="1", memory="1Gi", labels=(("app", "db"),))
          for i in range(2)]
    return db + [make_pod(f"s-{i}", cpu="250m", memory="256Mi", pod_affinity=(
        PodAffinityTerm(match_labels=(("app", "db"),),
                        topology_key=wk.LABEL_HOSTNAME),)) for i in range(2)]


def timed_solve(s: TorchSolver, batch: list) -> "tuple[int, int, tuple]":
    """-> the solve's window on the profiler's clock, and its record."""
    t0 = time.time_ns()
    s.solve(batch)
    return t0, time.time_ns(), s.last_solve_info["spans"]


def phases_of(record) -> "list[tuple[str, int, int]]":
    return [sp for sp in record if sp[0] != "runtime.gc"]


def test_a_solve_records_its_phases_in_order_inside_its_window():
    s = solver()
    s.solve(pods(50))  # the first dispatch of the shape
    t0, t1, record = timed_solve(s, pods(50))
    phases = phases_of(record)
    assert tuple(name for name, _, _ in phases) == PHASES
    assert all(t0 <= a <= b <= t1 for _, a, b in record)
    starts = [a for _, a, _ in phases]
    assert starts == sorted(starts)
    spans = dict((name, (a, b)) for name, a, b in phases)
    top = [spans[name] for name in TOP]
    assert all(prev[1] <= nxt[0] for prev, nxt in zip(top, top[1:]))
    for parent, children in CHILDREN.items():
        a, b = spans[parent]
        assert all(a <= spans[c][0] <= spans[c][1] <= b for c in children)


def test_phase_times_are_their_spans_lengths():
    s = solver()
    _, _, record = timed_solve(s, pods(20))
    spans = {name: (a, b) for name, a, b in phases_of(record)}
    for key, name in TIMES.items():
        a, b = spans[name]
        assert s.last_solve_info[key] == (b - a) / 1e6


def test_children_cover_encode_and_dispatch():
    s = solver()
    s.solve(pods(4000))
    _, _, record = timed_solve(s, pods(4000))
    spans = {name: (a, b) for name, a, b in phases_of(record)}
    for parent, children in CHILDREN.items():
        a, b = spans[parent]
        covered = sum(spans[c][1] - spans[c][0] for c in children)
        assert covered >= 0.95 * (b - a), (parent, covered, b - a)


def test_a_two_round_solve_keeps_both_rounds():
    s = solver()
    _, _, record = timed_solve(s, two_round_pods())
    info = s.last_solve_info
    assert info["rounds"] == 2
    names = [name for name, _, _ in phases_of(record)]
    assert names == list(PHASES) + [n for n in PHASES if n != "solver.split"]
    for key, name in TIMES.items():
        lengths = [(b - a) / 1e6 for n, a, b in record if n == name]
        assert len(lengths) == 2
        assert info[key] == pytest.approx(sum(lengths), rel=1e-12, abs=0)
    steps = [sp for sp in record if sp[0] == "solver.dispatch.enqueue"]
    assert len(steps) == 2 and info["steps"] >= 2


def test_the_tracer_draws_a_solves_phases_in_sequence():
    s = solver()
    s.solve(pods(50))
    TRACER.clear()
    with TRACER.start_span("solver.service.Solve") as root:
        s.solve(pods(50))
    events = {e["name"]: e for e in TRACER.chrome_trace(root.trace_id)[
        "traceEvents"]}
    enc, disp = events["solver.encode"], events["solver.dispatch.execute"]
    # the export's microseconds are floats of ~1.7e15: 1 us of slack
    assert enc["ts"] + enc["dur"] <= disp["ts"] + 1.0
    assert events["solver.encode.groups"]["ts"] >= enc["ts"] - 1.0
    (trace,) = [t for t in TRACER.traces() if t["trace_id"] == root.trace_id]
    top = [sp for sp in trace["spans"] if sp["name"] in TOP]
    assert [sp["name"] for sp in top] == list(TOP)
    for prev, nxt in zip(top, top[1:]):
        assert prev["start_ts"] + prev["duration_ms"] / 1e3 <= \
            nxt["start_ts"] + 1e-6
    by_id = {sp["span_id"]: sp["name"] for sp in trace["spans"]}
    for parent, children in CHILDREN.items():
        for sp in trace["spans"]:
            if sp["name"] in children:
                assert by_id[sp["parent_id"]] == parent


def test_a_collection_inside_encode_is_a_gc_span_inside_it(monkeypatch):
    s = solver()
    s.solve(pods(10))
    real = encode.prepare_groups

    def collecting(*args, **kwargs):
        gc.collect()
        return real(*args, **kwargs)

    monkeypatch.setattr(encode, "prepare_groups", collecting)
    TRACER.clear()
    _, _, record = timed_solve(s, pods(10))
    (enc,) = [(a, b) for n, a, b in record if n == "solver.encode"]
    full = [sp for sp in TRACER.finished_spans() if sp.name == "runtime.gc"
            and sp.attributes["generation"] == 2]
    assert len(full) == 1 and full[0].attributes["collected"] >= 0
    inside = [(a, b) for n, a, b in record if n == "runtime.gc"
              and enc[0] <= a <= b <= enc[1]]
    assert inside
    # the collector's spans come last, and each is filed with the tracer
    assert [n for n, _, _ in record[-len(inside):]] == ["runtime.gc"] * len(
        inside)

    with profiling.disabled():
        size = len(GC_PAUSES)
        _, _, record = timed_solve(s, pods(10))
        gc.collect()
        assert len(GC_PAUSES) == size
    assert "runtime.gc" not in [n for n, _, _ in record]


def _phase_lint():
    spec = importlib.util.spec_from_file_location(
        "check_phase_accounting", REPO / "hack" / "check_phase_accounting.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_every_span_the_port_records_is_registered():
    lint = _phase_lint()
    port = REPO / "karpenter_tpu_torch"
    bad, seen = [], set()
    for path in sorted(port.rglob("*.py")):
        if path == port / "tracing" / "__init__.py":
            continue  # the Tracer's own plumbing passes names through
        for node, arg in lint._span_name_args(ast.parse(path.read_text())):
            for name in lint._literal_strings(arg):
                seen.add(name)
                if name not in PHASE_REGISTRY and not name.startswith(
                        DYNAMIC_PHASE_PREFIXES):
                    bad.append(f"{path.relative_to(REPO)}:{node.lineno} "
                               f"{name}")
    assert not bad, bad
    assert "solver.service.Solve" in seen  # the scan finds the call sites
    s = solver()
    for batch in (pods(10), two_round_pods()):
        _, _, record = timed_solve(s, batch)
        assert {name for name, _, _ in record} <= set(PHASE_REGISTRY)
