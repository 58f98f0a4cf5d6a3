"""The yardstick's arithmetic and the metric readers, on synthetic runs."""

import random

import numpy as np
import pytest

from portbench.readers import Run, reader
from portbench.stats import clip, covered, merge, percentile, split
from portbench.trace import breakdown


@pytest.mark.parametrize("n", [1, 2, 3, 19, 20, 21, 400])
def test_percentile_is_numpys_linear_percentile_of_every_value(n):
    rng = random.Random(n)
    xs = [rng.expovariate(1.0) for _ in range(n)]
    for q in (50, 95, 99):
        assert percentile(xs, q) == pytest.approx(np.percentile(xs, q),
                                                  rel=1e-12)


def test_intervals():
    assert merge([(5, 7), (1, 3), (2, 4), (7, 8)]) == [(1, 4), (5, 8)]
    busy = [(1, 4), (5, 8), (10, 12)]
    assert split(busy, [(0, 2), (3, 6), (9, 11), (13, 14)]) == \
        [[(1, 2)], [(3, 4), (5, 6)], [(10, 11)], []]
    assert clip(busy, [(3, 11)]) == [(3, 4), (5, 8), (10, 11)]
    assert covered(clip(busy, [(0, 100)])) == 8


def request(t0, t1, **counters):
    return {"wall_s": (t1 - t0) / 1e9, "t0_ns": t0, "t1_ns": t1,
            "answered": True, "pods": 10, "gc_s": 0.001,
            "counters": counters, "error": None}


def solve_run(device=None):
    phases = dict(encode_ms=2.0, dispatch_ms=3.0, transfer_ms=0.5,
                  decode_ms=0.5)
    reqs = [request(0, 10_000_000, **phases),
            request(20_000_000, 40_000_000, **phases)]
    reqs[1]["answered"] = False
    return Run("solve", reqs, 9.5, device)


def test_tails_and_rates_count_every_request_of_the_window():
    run = solve_run()
    assert reader("end_to_end", "solve_p95_ms")(run) == pytest.approx(
        percentile([10.0, 20.0], 95))
    # pods of answered requests over all the time waited
    assert reader("end_to_end", "pods_per_s")(run) == pytest.approx(10 / 0.03)
    assert reader("end_to_end", "setup_s")(run) == 9.5


def test_layer_readers_on_a_solve_run():
    events = [("open_claim_qmax_kernel<4>", 1_000_000, 1_100_000),
              ("elementwise", 1_050_000, 2_000_000),
              ("Memcpy DtoH", 9_000_000, 9_500_000),
              ("open_claim_apply_kernel<4>", 25_000_000, 25_300_000)]
    run = solve_run(events)
    assert reader("layers", "service_ms.solve")(run) == pytest.approx(4.0)
    assert reader("layers", "encode_ms.solve")(run) == 2.0
    assert reader("layers", "gc_ms.solve")(run) == pytest.approx(1.0)
    # busy 1.0 + 0.5 + 0.3 ms of 30 ms waited
    assert reader("layers", "idle_share.solve")(run) == pytest.approx(
        100 * (1 - 1.8 / 30))
    assert reader("layers", "kernels_per_solve")(run) == 1.5
    assert reader("layers", "fill_ms.solve")(run) == pytest.approx(0.2)


def test_a_reader_with_nothing_to_read_is_silent():
    run = solve_run([("elementwise", 1_000_000, 2_000_000)])
    other = Run("other", run.requests, 9.5, run.device)
    for group, name in (("end_to_end", "solve_p95_ms"),
                        ("end_to_end", "pods_per_s"),
                        ("layers", "idle_share.solve"),
                        ("layers", "encode_ms.solve")):
        assert reader(group, name)(other) is None
    assert reader("layers", "fill_ms.solve")(run) is None
    assert reader("layers", "kernels_per_solve")(solve_run()) is None


def test_breakdown_names_the_idle_time_by_position():
    events = [("a", 2, 4), ("b", 6, 7), ("a", 12, 13)]
    got = breakdown(events, [(0, 10), (11, 14), (20, 30)])
    assert dict(map(tuple, got["device_ops"])) == pytest.approx(
        {"a": 3e-9, "b": 1e-9})
    gaps = dict(map(tuple, got["idle_gaps"]))
    assert gaps == pytest.approx({
        "before_first_device_op": 3e-9, "between_device_ops": 2e-9,
        "after_last_device_op": 4e-9, "no_device_op": 10e-9})
