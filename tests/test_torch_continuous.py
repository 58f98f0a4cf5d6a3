"""The port's continuous profiler (profiling/continuous.py, its hooks in the
gap ledger and /debug/profilez) against the JAX package's, on the CPU.

* The JAX package's TestContinuousProfiler, TestStrictNoop and
  TestProfilezEndpoint of tests/test_profiling.py run against the port,
  loaded by `tests.test_torch_operator.retarget` (every Operator and
  TPUSolver built with device="cpu"; the profilez document's `tool` read
  as the port's, "karpenter_tpu_torch.profilez") and collected here under
  their own names. The rest of that file (the gap ledger and roofline
  classes, the phase-vocabulary lint of the JAX tree) is held elsewhere
  (tests/test_torch_profiling.py) or is the JAX package's own.
* The profiling plane's `activity()`, `snapshot()` and `profilez()` have
  the JAX package's keys, and so have their sections.
* The port's own rung: a CUDA-event span is inert off the card, an event
  is labelled by how it was measured, and a solve on the CPU records one
  cpu-synthetic event with the gap row's device_exec milliseconds.
"""

from __future__ import annotations

import pytest

from karpenter_tpu import profiling as jprof
from karpenter_tpu_torch import profiling
from karpenter_tpu_torch.profiling import continuous
from tests.test_torch_operator import cases_except, collect, retarget

KEEP = ("TestContinuousProfiler", "TestStrictNoop", "TestProfilezEndpoint")
_mod = retarget("test_profiling", f"{__name__}_profiling", labels=(
    ('doc["tool"] == "karpenter_tpu.profilez"',
     'doc["tool"] == "karpenter_tpu_torch.profilez"'),))
COLLECTED = collect(_mod, "profiling", {}, globals(),
                    cases_except("test_profiling", KEEP))


def test_the_three_classes_are_collected():
    assert sorted(n for n in COLLECTED if n.startswith("Test")) == [
        "TestProfiling_ContinuousProfiler", "TestProfiling_ProfilezEndpoint",
        "TestProfiling_StrictNoop"]


def two_levels(doc: dict) -> dict:
    return {k: sorted(v) if isinstance(v, dict) else None
            for k, v in doc.items()}


@pytest.mark.parametrize("read", ["activity", "snapshot", "profilez"])
def test_profiling_reads_have_the_jax_keys(read):
    prev = (jprof.set_enabled(True), profiling.set_enabled(True))
    try:
        jprof.PROFILER.device.observe(0.001, bucket="g8n32e1")
        profiling.PROFILER.device.observe(0.001, bucket="g8n32e1")
        want, got = getattr(jprof, read)(), getattr(profiling, read)()
    finally:
        jprof.set_enabled(prev[0])
        profiling.set_enabled(prev[1])
    # the keys two levels down: deeper, the gap ledger's totals and the
    # host stacks hold what this process happened to run
    assert two_levels(got) == two_levels(want)
    if read == "profilez":
        assert got["tool"] == "karpenter_tpu_torch.profilez"


def test_cuda_event_span_is_inert_off_the_card():
    span = continuous.CudaEventSpan("cpu")
    span.start()
    span.stop()
    assert span.seconds() is None


def test_an_event_is_labelled_by_how_it_was_measured():
    ladder = continuous.DeviceEventLadder()
    prev = profiling.set_enabled(True)
    try:
        ladder.observe(0.002, bucket="b", mode="cuda-events")
        ladder.observe(0.001, bucket="b")
        with pytest.raises(ValueError, match="tpu-sync"):
            ladder.observe(0.001, mode="tpu-sync")
    finally:
        profiling.set_enabled(prev)
    assert [e["mode"] for e in ladder.events()] == ["cuda-events",
                                                    "cpu-synthetic"]
    assert ladder.events()[0]["ms"] == 2.0
    assert continuous.DEVICE_EVENTS.value(mode="cuda-events") >= 1


def test_detect_backend_reads_the_solver_device_and_never_jax():
    assert continuous.detect_backend("cpu") == "cpu"
    assert continuous.detect_backend("cuda") == "cuda"
    assert continuous.detect_backend() in ("cpu", "cuda")


def test_a_cpu_solve_records_a_synthetic_event_of_its_gap_row():
    from karpenter_tpu_torch.apis.provisioner import Provisioner
    from karpenter_tpu_torch.models.instancetype import (Catalog,
                                                         make_instance_type)
    from karpenter_tpu_torch.models.pod import make_pod
    from karpenter_tpu_torch.solver.core import TorchSolver

    prov = Provisioner(name="default")
    prov.set_defaults()
    solver = TorchSolver(Catalog(types=[make_instance_type(
        "m.large", cpu=4, memory="16Gi", od_price=0.2)]), [prov],
        device="cpu")
    prev = profiling.set_enabled(True)
    try:
        before = profiling.activity()
        solver.solve([make_pod(f"p{i}", cpu="1", memory="1Gi")
                      for i in range(6)])
        after = profiling.activity()
    finally:
        profiling.set_enabled(prev)
    assert after["device_events"] == before["device_events"] + 1
    assert after["gap_rows"] == before["gap_rows"] + 1
    ev = profiling.PROFILER.device.events()[-1]
    row = profiling.GAP_LEDGER.rows()[-1]
    assert ev["mode"] == "cpu-synthetic" and ev["route"] == "single"
    assert ev["ms"] == pytest.approx(row["phases_ms"]["device_exec"],
                                     abs=0.01)
    assert ev["bucket"] == row["bucket"]
