"""The port's profiling plane (gap ledger, critical path, roofline peaks,
HBM ledger) against the JAX package's, on the CPU.

* One solve through each package (a single round, a two-round affinity
  solve, a solve_many wave) files one gap-ledger row each, with equal phase
  sets, equal row keys and equal `annotate` keys; the port's row names its
  backend ("cpu" here: the solver's device type).
* The row's `critical` subsection has overlap_ratio exactly 0.0 and
  critical_path_ms == total_work_ms, as in the JAX package.
* PEAKS has a "cuda" row, and peaks_for("cuda") returns it.
* Strict noop: under profiling.disabled() no row lands and no counter
  moves; under critical.disabled() the row lands without `critical` and no
  critical counter moves.
* HbmLedger.set_resident replaces, and refuses a non-static class.
* A host-sampler sweep that passed its enabled check before
  set_enabled(False) lands before an activity() read that follows the
  switch, or not at all (the port's repair of the strict-noop race).
"""

from __future__ import annotations

import threading
import types

import pytest

from karpenter_tpu import profiling as jprof
from karpenter_tpu.apis import wellknown as jwk
from karpenter_tpu.apis.provisioner import Provisioner as JProvisioner
from karpenter_tpu.models import instancetype as jit
from karpenter_tpu.models import pod as jpod
from karpenter_tpu.models import requirements as jreq
from karpenter_tpu.profiling import gapledger as jgap
from karpenter_tpu.solver.core import TPUSolver
from karpenter_tpu_torch import profiling
from karpenter_tpu_torch.apis import wellknown as wk
from karpenter_tpu_torch.apis.provisioner import Provisioner
from karpenter_tpu_torch.models import instancetype as it
from karpenter_tpu_torch.models import pod as tpod
from karpenter_tpu_torch.models import requirements as treq
from karpenter_tpu_torch.profiling import critical, gapledger, roofline
from karpenter_tpu_torch.profiling.continuous import HostSampler
from karpenter_tpu_torch.solver.core import TorchSolver

JAX = types.SimpleNamespace(wk=jwk, Provisioner=JProvisioner, it=jit,
                            pod=jpod, req=jreq, gap=jgap, prof=jprof)
PORT = types.SimpleNamespace(wk=wk, Provisioner=Provisioner, it=it, pod=tpod,
                             req=treq, gap=gapledger, prof=profiling)


@pytest.fixture(autouse=True)
def _planes_on():
    from karpenter_tpu.profiling import critical as jcrit

    mods = (jprof, jcrit, profiling, critical)
    prev = [m.enabled() for m in mods]
    for m in mods:
        m.set_enabled(True)
    yield
    for m, was in zip(mods, prev):
        m.set_enabled(was)


def catalog(side):
    return side.it.Catalog(types=[
        side.it.make_instance_type("m.large", cpu=4, memory="16Gi",
                                   od_price=0.2, spot_price=0.07),
        side.it.make_instance_type("m.xlarge", cpu=16, memory="64Gi",
                                   od_price=0.8, spot_price=0.28)])


def provisioner(side):
    p = side.Provisioner(name="default", requirements=side.req.Requirements.of(
        (side.wk.LABEL_CAPACITY_TYPE, side.req.OP_IN, ["spot", "on-demand"])))
    p.set_defaults()
    return p


def pods(side, n=12):
    return [side.pod.make_pod(f"p-{i}", cpu="1", memory="1Gi")
            for i in range(n)]


def affinity_pods(side):
    """Zone-spread pods and co-pending followers: a two-round solve."""
    spread = (side.pod.TopologySpreadConstraint(
        max_skew=1, topology_key=side.wk.LABEL_ZONE),)
    out = [side.pod.make_pod(f"s-{i}", cpu="1", memory="1Gi", topology=spread,
                             labels=(("app", "s"),)) for i in range(6)]
    out += [side.pod.make_pod(f"f-{i}", cpu="500m", memory="512Mi",
                              pod_affinity=(side.pod.PodAffinityTerm(
                                  match_labels=(("app", "s"),),
                                  topology_key=side.wk.LABEL_ZONE),))
            for i in range(2)]
    return out


def solver(side):
    if side is JAX:
        return TPUSolver(catalog(JAX), [provisioner(JAX)])
    return TorchSolver(catalog(PORT), [provisioner(PORT)], device="cpu")


CASES = {
    "single": lambda side, s: s.solve(pods(side)),
    "two_round": lambda side, s: s.solve(affinity_pods(side)),
    "wave": lambda side, s: s.solve_many(
        [{"pods": pods(side, n)} for n in (4, 7, 9)]),
}


def solve_row(side, case: str, monkeypatch) -> "tuple[dict, set]":
    """The gap-ledger row of one solve, and the keys annotate was given."""
    keys: "set[str]" = set()
    ledger = side.gap.GAP_LEDGER
    real = ledger.annotate

    def spy(**attrs):
        keys.update(attrs)
        real(**attrs)

    monkeypatch.setattr(ledger, "annotate", spy)
    s = solver(side)
    before = ledger.rows_total
    CASES[case](side, s)
    assert ledger.rows_total == before + 1
    return ledger.rows()[-1], keys


@pytest.mark.parametrize("case", sorted(CASES))
def test_gap_row_matches_jax(case, monkeypatch):
    want, want_keys = solve_row(JAX, case, monkeypatch)
    got, got_keys = solve_row(PORT, case, monkeypatch)
    assert got["source"] == want["source"]
    assert set(got) == set(want)
    assert set(got["phases_ms"]) == set(want["phases_ms"])
    assert got_keys == want_keys
    assert set(got["critical"]) == set(want["critical"])
    if case != "wave":  # a wave annotates nothing in either package
        assert got["roofline"]["backend"] == "cpu"
        assert got["bucket"] == want["bucket"] and got["route"] == "single"


@pytest.mark.parametrize("case", sorted(CASES))
def test_critical_overlap_is_exactly_zero(case, monkeypatch):
    row, _ = solve_row(PORT, case, monkeypatch)
    crit = row["critical"]
    assert crit["overlap_ratio"] == 0.0
    assert crit["critical_path_ms"] == crit["total_work_ms"]


def test_cuda_peaks_row(monkeypatch):
    monkeypatch.delenv(roofline.BW_ENV, raising=False)
    monkeypatch.delenv(roofline.FLOPS_ENV, raising=False)
    assert roofline.peaks_for("cuda") == roofline.PEAKS["cuda"] \
        == (64.0, 67_000.0)
    assert "tpu" not in roofline.PEAKS
    rf = roofline.estimate(32, 32, 16384, backend="cuda")
    assert rf.bw_gbps == 64.0 and rf.backend == "cuda"


def test_profiling_disabled_is_strict_noop():
    s = solver(PORT)
    with profiling.disabled():
        before = (profiling.activity(), critical.activity())
        s.solve(pods(PORT))
        assert (profiling.activity(), critical.activity()) == before


def test_critical_disabled_leaves_the_flat_row():
    s = solver(PORT)
    with critical.disabled():
        before = critical.activity()
        rows = gapledger.GAP_LEDGER.rows_total
        s.solve(pods(PORT))
        assert critical.activity() == before
    assert gapledger.GAP_LEDGER.rows_total == rows + 1
    assert "critical" not in gapledger.GAP_LEDGER.rows()[-1]


def test_hbm_ledger_replace_semantics():
    from karpenter_tpu_torch.solver.buckets import HbmLedger

    ledger = HbmLedger()
    ledger.set_resident("inc", "assignment", 1024.0)
    ledger.set_resident("inc", "assignment", 512.0)
    assert ledger._static["inc"]["assignment"] == 512.0
    assert ledger.resident_bytes("inc") == 512.0
    with pytest.raises(ValueError):
        ledger.set_resident("inc", "not-a-static-class", 1.0)
    ledger.set_resident("other", "catalog", 256.0)
    assert ledger.resident_bytes() == 768.0
    assert ledger.release("inc") == 512.0
    assert ledger.resident_bytes("inc") == 0.0
    assert ledger.resident_bytes() == 256.0


class _SweepGate:
    """The sampler's lock, with a gate on the sampler thread's sweeps: once
    armed, the next sweep (the first of the two acquisitions of each
    sampling round; the second adds the sweep's cost) signals `paused` and
    waits for `go` before it takes the lock, that is after its own enabled
    check. Other threads take the lock as usual."""

    def __init__(self):
        self._lock = threading.Lock()
        self._rounds = 0
        self.armed = False
        self.paused = threading.Event()
        self.go = threading.Event()

    def __enter__(self):
        if threading.current_thread().name == "profiling-sampler":
            self._rounds += 1
            if self.armed and self._rounds % 2 == 1:
                self.armed = False
                self.paused.set()
                self.go.wait(timeout=10)
        self._lock.acquire()
        return self

    def __exit__(self, *exc):
        self._lock.release()


def test_a_sweep_in_flight_at_the_switch_adds_no_sample_after_the_read(
        monkeypatch):
    """A sweep that passed its enabled check, then set_enabled(False), then
    activity(): when the sweep goes on, host_samples stays at what the read
    gave (it reads the switch again under its lock)."""
    host = HostSampler(hz=500)
    gate = _SweepGate()
    host._lock = gate
    monkeypatch.setattr(profiling.PROFILER, "host", host)
    try:
        assert host.ensure_started()
        gate.armed = True
        assert gate.paused.wait(timeout=10), "the sampler never swept"
        profiling.set_enabled(False)
        before = profiling.activity()
        gate.go.set()
        host.stop()                 # joins the sampler: its sweep has ended
        assert not host.running()
        assert profiling.activity()["host_samples"] == \
            before["host_samples"]
        assert profiling.activity()["host_ring"] == before["host_ring"]
    finally:
        gate.go.set()
        host.stop()
