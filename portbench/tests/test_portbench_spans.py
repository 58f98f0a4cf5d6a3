"""The span record's readers (portbench/spans.py and the six layers that
read it), on a synthetic run whose spans and device events give known
values."""

import pytest

from portbench.readers import Run, reader
from portbench.spans import idle_by_span, kernels_inside_share

MS = 1_000_000
READERS = ("encode_groups_ms.solve", "encode_fold_ms.solve",
           "pack_inputs_ms.solve", "enqueue_ms.solve",
           "gc_in_encode_ms.solve", "unspanned_idle_ms.solve")


def record(t0, gcs):
    """One round's phases at `t0` + the offsets below (ms), then the
    collector's pauses `gcs`."""
    phases = (("solver.split", 0.1, 0.3), ("solver.encode", 0.3, 5.3),
              ("solver.encode.groups", 0.4, 3.4),
              ("solver.encode.fold", 3.4, 4.4),
              ("solver.encode.bounds", 4.4, 5.2),
              ("solver.dispatch.execute", 5.3, 7.3),
              ("solver.dispatch.inputs", 5.3, 5.8),
              ("solver.dispatch.enqueue", 5.8, 7.3),
              ("solver.transfer", 7.3, 9.0), ("solver.decode", 9.0, 9.5))
    return tuple((n, t0 + round(a * MS), t0 + round(b * MS))
                 for n, a, b in phases) + tuple(
        ("runtime.gc", t0 + round(a * MS), t0 + round(b * MS))
        for a, b in gcs)


def request(t0, t1, spans=None, answered=True):
    counters = {"encode_ms": 5.0, "routing": "cuda"}
    if spans is not None:
        counters["spans"] = spans
    return {"wall_s": (t1 - t0) / 1e9, "t0_ns": t0, "t1_ns": t1,
            "answered": answered, "pods": 10, "gc_s": 0.0,
            "counters": counters, "error": None}


def span_run(device=True, spans=True):
    a = record(0, [(1.0, 2.0), (9.6, 9.8)])
    b = record(20 * MS, [(1.0, 3.0)])
    reqs = [request(0, 10 * MS, a if spans else None),
            request(12 * MS, 13 * MS, answered=False),
            request(20 * MS, 30 * MS, b if spans else None)]
    events = []
    for t0 in (0, 20 * MS):
        events += [("Memcpy HtoD", t0 + 59 * MS // 10, t0 + 6 * MS),
                   ("pack_kernel", t0 + 6 * MS, t0 + 61 * MS // 10),
                   ("min_kernel", t0 + 75 * MS // 10, t0 + 85 * MS // 10)]
    # a kernel before the second request's enqueue, one between requests
    events += [("early_kernel", 20 * MS + 50_000, 20 * MS + 60_000),
               ("stray_kernel", 15 * MS, 15 * MS + 10_000)]
    return Run("solve", reqs, 9.5, events if device else None)


def test_the_readers_give_the_records_known_values():
    run = span_run()
    got = {name: reader("layers", name)(run) for name in READERS}
    assert got == pytest.approx({
        "encode_groups_ms.solve": 3.0, "encode_fold_ms.solve": 1.0,
        "pack_inputs_ms.solve": 0.5, "enqueue_ms.solve": 1.5,
        # the first request's second pause lies outside its encode
        "gc_in_encode_ms.solve": (1.0 + 2.0) / 2,
        # idle and under no leaf: 0.1 + 0.1 + 0.1 + 0.1 + 0.2 ms in the
        # first window; 0.1 less the early kernel's 0.01, 0.1, 0.1 and 0.5
        # in the second
        "unspanned_idle_ms.solve": (0.6 + 0.79) / 2}, rel=1e-9)


def test_idle_time_is_put_down_to_the_leaf_spans():
    by = idle_by_span(span_run())
    assert by["solver.encode.groups"] == pytest.approx(3.0)
    assert by["runtime.gc"] == pytest.approx((1.2 + 2.0) / 2)
    # the transfer's 1.7 ms less the 1 ms kernel inside it
    assert by["solver.transfer"] == pytest.approx(0.7)
    # the copy and the first kernel lie inside the enqueue's 1.5 ms
    assert by["solver.dispatch.enqueue"] == pytest.approx(1.3)
    assert by["unspanned"] == pytest.approx(0.695)


def test_the_clock_check_finds_a_kernel_outside_its_requests_device_phases():
    share, outside = kernels_inside_share(span_run())
    assert share == 0.5 and outside == 1


def test_a_run_without_span_records_gives_none():
    for run in (span_run(spans=False), Run("other", span_run().requests, 9.5,
                                           span_run().device)):
        for name in READERS:
            assert reader("layers", name)(run) is None
        assert idle_by_span(run) is None
        assert kernels_inside_share(run) is None
    untraced = span_run(device=False)
    assert reader("layers", "unspanned_idle_ms.solve")(untraced) is None
    assert reader("layers", "encode_fold_ms.solve")(untraced) == \
        pytest.approx(1.0)
