"""The solver service's resident heap (solver/heap.py) and a solve's
gc_full_ms, on the CPU.

* A Sync that installs freezes the live heap (gc.freeze) and counts it in
  eviction_stats(); a repeat Sync of a resident key freezes nothing new; the
  freeze does not wait on the profiling plane.
* The first Sync of a service, and a Sync that evicted, unfreeze and
  collect the whole heap first: a capacity-evicted solver's reference
  cycles (and the tensors they hold) are gone after the Sync that evicted
  it. An installing Sync that evicted nothing runs no such collection.
* gc_full_ms is the sum of a solve's generation-2 pauses, 0 where none ran.
* A Solve decides the same with the heap frozen and unfrozen.
* The benchmark's harness leaves the heap as the service leaves it.
"""

from __future__ import annotations

import gc
import time
import weakref
from pathlib import Path

import pytest
import torch

from karpenter_tpu_torch import overload, profiling
from karpenter_tpu_torch.apis.provisioner import Provisioner
from karpenter_tpu_torch.models import encode
from karpenter_tpu_torch.models.instancetype import Catalog, make_instance_type
from karpenter_tpu_torch.models.pod import make_pod
from karpenter_tpu_torch.profiling.gcpause import GC_PAUSES
from karpenter_tpu_torch.solver.core import TorchSolver
from karpenter_tpu_torch.solver.service import SolverService

REPO = Path(__file__).resolve().parent.parent
HEAP = ("heap_freezes", "heap_full_collects", "heap_frozen")


@pytest.fixture(autouse=True)
def _unfrozen_after():
    """Each case starts and ends with nothing frozen by it."""
    prev = profiling.set_enabled(True)
    gc.unfreeze()
    yield
    gc.unfreeze()
    profiling.set_enabled(prev)


class _Cycle:
    """An object only the collector can reclaim: it refers to itself."""

    def __init__(self):
        self.me = self
        self.tensor = torch.zeros(16)


def catalog(scale: float) -> Catalog:
    return Catalog(types=[
        make_instance_type(f"m.{n}x", cpu=n, memory=f"{4 * n}Gi",
                           od_price=0.05 * n * scale)
        for n in (1, 2, 4, 8)])


def provisioners() -> list:
    prov = Provisioner(name="default")
    prov.set_defaults()
    return [prov]


def pods(n: int) -> list:
    return [make_pod(f"p-{i}", cpu="1", memory="1Gi") for i in range(n)]


def synced(*scales: float) -> SolverService:
    svc = SolverService(device="cpu")
    for k in scales:
        svc.sync((int(k * 100), 0), catalog(k), provisioners())
    return svc


def heap(svc: SolverService) -> dict:
    stats = svc.eviction_stats()
    return {k: stats[k] for k in HEAP}


def test_an_installing_sync_freezes_the_heap():
    svc = SolverService(device="cpu")
    assert heap(svc) == dict.fromkeys(HEAP, 0)
    svc.sync((100, 0), catalog(1.0), provisioners())
    got = heap(svc)
    assert got["heap_freezes"] == 1 and got["heap_full_collects"] == 1
    # frozen objects that lose their last reference are still freed
    assert got["heap_frozen"] >= gc.get_freeze_count() > 0


def test_a_repeat_sync_of_a_resident_key_freezes_nothing_new():
    svc = synced(1.0)
    before, frozen = heap(svc), gc.get_freeze_count()
    svc.sync((100, 0), catalog(1.0), provisioners())
    assert heap(svc) == before and gc.get_freeze_count() <= frozen


def test_an_install_without_eviction_collects_only_what_is_unfrozen():
    svc = synced(1.0)
    svc.sync((200, 0), catalog(2.0), provisioners())
    got = heap(svc)
    assert svc.eviction_stats()["evictions"] == 0
    assert got["heap_freezes"] == 2 and got["heap_full_collects"] == 1


def test_a_capacity_evicted_solvers_cycles_go_at_the_sync_that_evicted_it():
    # the plain LRU: with the overload plane on, a newcomer to a full LRU
    # waits on probation instead of evicting
    with overload.disabled():
        svc = SolverService(device="cpu")
        svc.LRU_CAPACITY = 2
        svc.sync((100, 0), catalog(1.0), provisioners())
        solver = svc.checkout((100, 0))[0]
        svc.checkin((100, 0))
        solver.probe = _Cycle()
        probe = weakref.ref(solver.probe)
        tensor = weakref.ref(solver.probe.tensor)
        del solver
        # installs without evicting: the probe is frozen with its solver
        svc.sync((200, 0), catalog(2.0), provisioners())
        assert heap(svc)["heap_full_collects"] == 1
        gc.collect()
        assert probe() is not None
        # installs and evicts the LRU's oldest, the probe's solver
        svc.sync((300, 0), catalog(3.0), provisioners())
    assert list(svc._cache) == [(200, 0), (300, 0)]
    assert svc.eviction_stats()["evictions"] == 1
    assert heap(svc)["heap_full_collects"] == 2
    assert probe() is None and tensor() is None


def test_the_freeze_does_not_wait_on_the_profiling_plane():
    with profiling.disabled():
        svc = synced(1.0)
    assert heap(svc)["heap_freezes"] == 1 and gc.get_freeze_count() > 0


def solver() -> TorchSolver:
    return TorchSolver(catalog(1.0), provisioners(), device="cpu")


@pytest.mark.parametrize("generation,full", [(2, 1), (2, 2), (1, 0)],
                         ids=["one-full", "two-full", "young-only"])
def test_gc_full_ms_sums_the_solves_generation_2_pauses(
        generation, full, monkeypatch):
    s = solver()
    s.solve(pods(10))
    real = encode.prepare_groups
    n_forced = max(full, 1)

    def collecting(*args, **kwargs):
        for _ in range(n_forced):
            gc.collect(generation)
        return real(*args, **kwargs)

    monkeypatch.setattr(encode, "prepare_groups", collecting)
    was = gc.isenabled()
    gc.disable()  # only the forced collections run
    try:
        t0 = time.perf_counter_ns()
        s.solve(pods(10))
        t1 = time.perf_counter_ns()
    finally:
        if was:
            gc.enable()
    pauses = [p for p in GC_PAUSES.between(t0, t1) if p[2] == 2]
    assert len(pauses) == full
    assert s.last_solve_info["gc_full_ms"] == sum(
        e - s for s, e, _, _ in pauses) / 1e6
    assert (s.last_solve_info["gc_full_ms"] > 0) == (full > 0)


def test_gc_full_ms_is_zero_where_no_collection_ran():
    s = solver()
    was = gc.isenabled()
    gc.disable()
    try:
        s.solve(pods(10))
    finally:
        if was:
            gc.enable()
    assert s.last_solve_info["gc_full_ms"] == 0


def test_a_burst_decides_the_same_frozen_and_unfrozen():
    svc = synced(1.0)
    batch = pods(500)
    assert gc.get_freeze_count() > 0
    frozen, _ = svc.solve((100, 0), batch)
    gc.unfreeze()
    unfrozen, _ = svc.solve((100, 0), batch)
    assert unfrozen.decisions() == frozen.decisions()
    assert unfrozen.unschedulable_count() == frozen.unschedulable_count()
    assert frozen.decisions() == solver().solve(batch).decisions()


@pytest.mark.parametrize("name", ["run.py", "drive.py"])
def test_the_harness_leaves_the_heap_alone(name):
    text = (REPO / "portbench" / name).read_text()
    assert "gc.freeze" not in text and "gc.unfreeze" not in text


@pytest.mark.parametrize("counters,want", [
    ({"gc_full_ms": 3.0}, 3.0), ({}, None)], ids=["counted", "uncounted"])
def test_the_benchmarks_reader_of_gc_full_ms(counters, want):
    """The mean over a run's answered Solves; None where the program keeps
    no such counter, so an older program's line leaves the metric out."""
    from portbench.readers import Run, reader

    req = {"wall_s": 0.1, "t0_ns": 0, "t1_ns": 1, "pods": 1,
           "answered": True, "counters": counters}
    run = Run(kind="solve", requests=[req, dict(req)], setup_s=0.0)
    assert reader("layers", "gc_full_ms.solve")(run) == want
