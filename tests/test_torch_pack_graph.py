"""A single Solve's pack as the replay of a CUDA graph
(karpenter_tpu_torch/ops/pack_graph.py), on the CPU.

The capture itself needs the card (chip_smoke.py's pack_graph phase holds
a replay to the eager pack there, bit for bit). Here a stand-in capture
whose "replay" runs the captured function again into the captured output
drives everything around it: the staging layout, the static views that
every later pack of a key reads (a stale buffer would show), the key, the
lock, the cache's bound, which packs engage, the launch counts held aside
and added back, the counters a Solve records and the benchmark's reader
of them.
"""

from __future__ import annotations

import gc
import threading

import numpy as np
import pytest
import torch

from karpenter_tpu_torch.apis.provisioner import Provisioner
from karpenter_tpu_torch.device import LAUNCHES, LaunchCounts
from karpenter_tpu_torch.models.encode import encode_problem
from karpenter_tpu_torch.models.instancetype import Catalog, make_instance_type
from karpenter_tpu_torch.models.pod import make_pod
from karpenter_tpu_torch.ops import pack_graph
from karpenter_tpu_torch.ops.pack_graph import PackGraph, PackGraphs, key_of
from karpenter_tpu_torch.ops.packer import (n_eff_of, pack_flat,
                                            pack_inputs_from_numpy)
from karpenter_tpu_torch.solver import buckets
from karpenter_tpu_torch.solver.core import (TorchSolver, _fold_rounds,
                                             build_pack_inputs)
from portbench.generator import Traffic, load_json


def replaying(fn):
    """capture_cuda's stand-in: a "graph" whose replay runs fn again into
    the captured output, its launch counts held aside as a capture's."""
    with LAUNCHES.held() as held:
        out = fn()

    class Graph:
        def replay(self):
            with LAUNCHES.held():
                out.copy_(fn())

    return Graph(), out, dict(held)


def graphs_on_cpu() -> PackGraphs:
    return PackGraphs("cpu", capture=replaying)


def eager_flat(fields: dict, n_slots: int) -> np.ndarray:
    inputs = pack_inputs_from_numpy(fields, "cpu")
    return pack_flat(inputs, n_slots, n_eff_of(fields["group_count"])).numpy()


def sight(graphs: PackGraphs, fields: dict, n_slots: int) -> None:
    """A key's first sighting: the lease yields no graph (the pack runs
    eager) and the key is remembered."""
    with graphs.lease(fields, n_slots, n_eff_of(fields["group_count"])) \
            as graph:
        assert graph is None


def graph_flat(graphs: PackGraphs, fields: dict, n_slots: int):
    """-> (flat, replayed) of the pack through its key's graph."""
    n_eff = n_eff_of(fields["group_count"])
    with graphs.lease(fields, n_slots, n_eff) as graph:
        assert graph is not None
        flat = graph.run(fields, n_slots, n_eff).numpy().copy()
        return flat, graph.replayed


# -- field sets ----------------------------------------------------------------

def _solver(types=2, provisioners=1) -> TorchSolver:
    provs = []
    for i in range(provisioners):
        p = Provisioner(name=f"p{i}", weight=i)
        p.set_defaults()
        provs.append(p)
    return TorchSolver(Catalog(types=[
        make_instance_type(f"m.{2 ** k}x", cpu=2 ** (k + 1),
                           memory=f"{2 ** (k + 3)}Gi", od_price=0.1 * 2 ** k)
        for k in range(types)]), provs, device="cpu")


def synthetic_fields(seed: int) -> "tuple[dict, int]":
    """A problem with existing nodes and every optional leaf (ex_cap,
    group_origin, prov_overhead, prov_pods_cap, res_sel/res_mask), at the
    padded shapes build_pack_inputs gives, against a solver's resident
    catalog tensors; its content drawn from `seed`, its n_eff fixed at 6
    of 8 rows. -> (fields, n_slots)."""
    solver = _SYNTH_SOLVER
    plan = buckets.BucketPlan(groups=8, slots=32, existing=4)
    fields = solver._synth_inputs(solver.grid(), plan, 2,
                                  (True, True, True, True))
    rng = np.random.default_rng(seed)
    G, Ne, R = plan.groups, plan.existing, fields["group_vec"].shape[1]
    T, S = fields["group_feas"].shape[2:]
    count = rng.integers(0, 12, G).astype(np.int32)
    count[5], count[6:] = 7, 0
    vec = rng.integers(0, 3, (G, R)).astype(np.int32)
    vec[:, 0] = 1  # the pods column
    fields.update(
        group_vec=vec, group_count=count,
        group_cap=np.where(rng.random(G) < 0.5, 3, 2**30).astype(np.int32),
        group_feas=rng.random((G, 2, T, S)) < 0.7,
        group_newprov=rng.integers(-1, 2, G).astype(np.int32),
        overhead=rng.integers(0, 2, R).astype(np.int32),
        ex_alloc=rng.integers(4, 40, (Ne, R)).astype(np.int32),
        ex_used=rng.integers(0, 4, (Ne, R)).astype(np.int32),
        ex_feas=rng.random((G, Ne)) < 0.6,
        ex_cap=rng.integers(0, 5, (G, Ne)).astype(np.int32),
        group_origin=np.array([0, 0, 2, 1, 4, 4, 6, 7], np.int32),
        prov_overhead=rng.integers(0, 2, (2, R)).astype(np.int32),
        prov_pods_cap=rng.integers(5, 60, (2, T)).astype(np.int32),
        res_sel=np.arange(R, dtype=np.int32), res_mask=np.ones(R, bool))
    return fields, plan.slots


_SYNTH_SOLVER = _solver(types=3)


@pytest.fixture(scope="module")
def cells():
    """The benchmark's two configurations on a CPU SolverService each (the
    Syncs' heap freeze is undone after the module)."""
    from portbench.drive import System

    systems = {name: System(load_json(f"portbench/configs/{name}.json"),
                            device="cpu")
               for name in ("inflate", "boutique")}
    yield systems
    gc.unfreeze()


def small_burst(pods: int = 300) -> dict:
    return {"request": "solve", "pods": {"fixed": pods}, "block": 1,
            "pool_seed": 10000}


SMALL_BURST = small_burst()


def cell_fields(system, seed: int, pods: int) -> "tuple[dict, int]":
    """A burst of `pods` pods of the cell's configuration, as _solve_once
    builds its pack fields. -> (fields, n_slots)."""
    solver = system.solver
    pods = system.inputs(Traffic(system.config, small_burst(pods),
                                 seed).request(0))
    enc = encode_problem(solver.catalog, solver.provisioners, pods, (),
                         grid=solver.grid(), group_cache=solver._group_cache)
    fields, plan = build_pack_inputs(enc, solver._dev_alloc_t,
                                     solver._dev_tiebreak)
    return fields, plan.slots


def field_sets(cells, kind: str):
    """Three problems of one key, each with its own content."""
    seeds = (1, 2**31 + 7, 3100000019)
    if kind == "synthetic":
        return [synthetic_fields(seed) for seed in seeds]
    return [cell_fields(cells[kind], seed, pods)
            for seed, pods in zip(seeds, (300, 260, 340))]


KINDS = ["inflate", "boutique", "synthetic"]


# -- the staging layout and the replays ---------------------------------------

@pytest.mark.parametrize("kind", KINDS)
def test_the_staged_views_hold_the_uploaded_leaves(cells, kind):
    """Each leaf of the staged inputs equals pack_inputs_from_numpy's, in
    dtype, shape and value; the resident catalog tensors are used as they
    are; every staged leaf starts on the staging alignment, so
    group_feas's option planes keep their word."""
    fields, _ = field_sets(cells, kind)[0]
    graph = PackGraph(torch.device("cpu"), replaying)
    graph.stage(fields)
    want = pack_inputs_from_numpy(fields, "cpu")
    for name, got, ref in zip(want._fields, graph.inputs, want):
        assert (got is None) == (ref is None), name
        if got is None:
            continue
        assert got.dtype == ref.dtype and got.shape == ref.shape, name
        assert torch.equal(got, ref), name
        if isinstance(fields[name], torch.Tensor):
            assert got is fields[name], name
        else:
            assert got.data_ptr() % pack_graph._ALIGN == 0, name


@pytest.mark.parametrize("kind", KINDS)
def test_three_packs_of_a_key_equal_the_eager_pack(cells, kind):
    """After the key's first sighting, its graph's first pack runs eager
    and captures, the next two replay on the staged views: every flat
    buffer equals the eager pack of the same fields, bit for bit (inflate:
    1 step, boutique: 6, the synthetic problem with existing nodes and
    ex_cap: 6)."""
    graphs = graphs_on_cpu()
    sets = field_sets(cells, kind)
    steps = {"inflate": 1, "boutique": 6, "synthetic": 6}[kind]
    sight(graphs, *sets[0])
    for i, (fields, n_slots) in enumerate(sets):
        assert n_eff_of(fields["group_count"]) == steps
        flat, replayed = graph_flat(graphs, fields, n_slots)
        assert replayed == (i > 0)
        np.testing.assert_array_equal(flat, eager_flat(fields, n_slots))
    assert len(graphs) == 1
    assert not np.array_equal(eager_flat(*sets[0]), eager_flat(*sets[1]))


def test_a_replay_adds_back_the_launches_its_capture_held():
    graphs = PackGraphs("cpu", capture=lambda fn: (*replaying(fn)[:2],
                                                   {"k": 3}))
    fields, n_slots = synthetic_fields(1)
    sight(graphs, fields, n_slots)
    LAUNCHES.reset()
    graph_flat(graphs, fields, n_slots)
    assert LAUNCHES.get("k") == 0
    for n in (3, 6):
        graph_flat(graphs, fields, n_slots)
        assert LAUNCHES.get("k") == n
    LAUNCHES.reset()


def test_a_pack_counts_one_staged_upload():
    fields, n_slots = synthetic_fields(2)
    graphs = graphs_on_cpu()
    sight(graphs, fields, n_slots)
    for _ in range(2):
        n0 = buckets.UPLOADS.value(tensor="delta")
        b0 = buckets.UPLOAD_BYTES.value(tensor="delta")
        graph_flat(graphs, fields, n_slots)
        assert buckets.UPLOADS.value(tensor="delta") == n0 + 1
        (graph,) = graphs._graphs.values()
        assert buckets.UPLOAD_BYTES.value(tensor="delta") \
            == b0 + graph._host.nbytes
        assert graph._host.nbytes >= sum(
            np.asarray(v).nbytes for v in fields.values()
            if v is not None and not isinstance(v, torch.Tensor))


def test_launch_counts_held_aside_are_this_threads_alone():
    counts = LaunchCounts()
    with counts.held() as held:
        counts.add("a")
        other = threading.Thread(target=counts.add, args=("a",))
        other.start()
        other.join(timeout=10)
        assert not other.is_alive()
        counts.add("b", 2)
    counts.add("a")
    assert held == {"a": 1, "b": 2}
    assert (counts.get("a"), counts.get("b")) == (2, 0)


# -- the key --------------------------------------------------------------------

def _variants(fields: dict, n_slots: int, n_eff: int):
    """(label, key) for each part of the key changed alone."""
    yield "n_slots", key_of(fields, n_slots * 4, n_eff)
    yield "n_eff", key_of(fields, n_slots, n_eff - 1)

    def pad(name, axis=0, n=8):
        a = fields[name]
        widths = [(0, 0)] * a.ndim
        widths[axis] = (0, n)
        return np.pad(a, widths)

    plan_g = {k: pad(k) for k in ("group_vec", "group_count", "group_cap",
                                  "group_feas", "group_newprov", "ex_feas",
                                  "ex_cap", "group_origin")}
    yield "groups", key_of({**fields, **plan_g}, n_slots, n_eff)
    plan_e = {"ex_alloc": pad("ex_alloc"), "ex_used": pad("ex_used"),
              "ex_feas": pad("ex_feas", 1), "ex_cap": pad("ex_cap", 1)}
    yield "existing", key_of({**fields, **plan_e}, n_slots, n_eff)
    width = {k: pad(k, -1, 4) for k in ("group_vec", "overhead", "ex_alloc",
                                        "ex_used", "prov_overhead",
                                        "res_sel", "res_mask")}
    yield "resource width", key_of({**fields, **width}, n_slots, n_eff)
    pv = {"group_feas": pad("group_feas", 1, 1),
          "prov_overhead": pad("prov_overhead", 0, 1),
          "prov_pods_cap": pad("prov_pods_cap", 0, 1)}
    yield "Pv", key_of({**fields, **pv}, n_slots, n_eff)
    for leaf in ("ex_cap", "group_origin", "prov_overhead", "prov_pods_cap"):
        yield leaf, key_of({**fields, leaf: None}, n_slots, n_eff)
    yield "res_sel", key_of({**fields, "res_sel": None, "res_mask": None},
                            n_slots, n_eff)
    for leaf in ("alloc_t", "tiebreak"):
        yield leaf, key_of({**fields, leaf: fields[leaf].clone()}, n_slots,
                           n_eff)


def test_the_key_changes_with_each_of_its_parts():
    fields, n_slots = synthetic_fields(1)
    n_eff = n_eff_of(fields["group_count"])
    base = key_of(fields, n_slots, n_eff)
    # the content is no part of it: another problem of the shape shares it
    assert key_of(synthetic_fields(2)[0], n_slots, n_eff) == base
    seen = {base}
    for label, key in _variants(fields, n_slots, n_eff):
        assert key not in seen, label
        seen.add(key)


# -- which packs engage ----------------------------------------------------------

def _pods(n=12):
    return [make_pod(f"p-{i}", cpu="1", memory="1Gi") for i in range(n)]


def _graphed_solver(**kw) -> TorchSolver:
    solver = _solver(**kw)
    solver._pack_graphs = graphs_on_cpu()
    return solver


def test_a_cpu_solver_packs_eager():
    assert PackGraphs("cpu")._capture is None
    with PackGraphs("cpu").lease(*synthetic_fields(1), 6) as graph:
        assert graph is None
    solver = _solver()
    for _ in range(2):
        solver.solve(_pods())
        info = solver.last_solve_info
        assert (info["graph_replays"], info["graph_captures"]) == (0, 0)
    assert len(solver._pack_graphs) == 0


def test_a_solver_with_graphs_replays_its_repeated_shape():
    solver, plain = _graphed_solver(), _solver()
    counts = []
    for n in (12, 11, 12):
        solver.solve(_pods(n))
        plain.solve(_pods(n))
        np.testing.assert_array_equal(solver.last_flat, plain.last_flat)
        info = solver.last_solve_info
        counts.append((info["graph_captures"], info["graph_replays"]))
    assert counts == [(0, 0), (1, 0), (0, 1)]


class _Mesh:
    """A stand-in mesh context: dispatch_flat packs eager on the CPU."""

    device_count = 2

    def dispatch_flat(self, fields, n_slots, grid):
        return torch.from_numpy(eager_flat(fields, n_slots))


class _Sharded:
    def route(self, plan):
        return "sharded"


def test_the_mesh_route_packs_eager():
    solver = _graphed_solver()
    solver._router, solver._mesh_ctx = _Sharded(), _Mesh()
    plain = _solver()
    solver.solve(_pods())
    plain.solve(_pods())
    info = solver.last_solve_info
    assert info["routing"] == "cpu-sharded"
    assert (info["graph_replays"], info["graph_captures"]) == (0, 0)
    assert len(solver._pack_graphs) == 0
    np.testing.assert_array_equal(solver.last_flat, plain.last_flat)


def test_solve_many_packs_its_lanes_and_solos_eager():
    solver = _graphed_solver()
    solver.solve_many([{"pods": _pods(12)}, {"pods": _pods(10)}])
    solver.solve_many([{"pods": _pods(12)}])
    assert len(solver._pack_graphs) == 0


def test_a_pack_that_finds_its_key_held_runs_eager():
    solver, plain = _graphed_solver(), _solver()
    solver.solve(_pods())
    solver.solve(_pods())
    (graph,) = solver._pack_graphs._graphs.values()
    assert graph.lock.acquire(blocking=False)
    try:
        res = solver.solve(_pods())
        info = solver.last_solve_info
        assert (info["graph_replays"], info["graph_captures"]) == (0, 0)
    finally:
        graph.lock.release()
    assert res.decisions() == plain.solve(_pods()).decisions()
    np.testing.assert_array_equal(solver.last_flat, plain.last_flat)
    solver.solve(_pods())
    assert solver.last_solve_info["graph_replays"] == 1


def test_the_cache_keeps_the_most_recently_used_graphs():
    graphs = graphs_on_cpu()
    fields, _ = synthetic_fields(1)
    n = pack_graph.MAX_GRAPHS

    def lease(slots):
        with graphs.lease(fields, slots, 6) as graph:
            return graph

    def seen_twice(slots):
        assert lease(slots) is None
        return lease(slots)

    first = [seen_twice(8 + k) for k in range(n)]
    assert len(graphs) == n and graphs.evictions == 0
    assert lease(8) is first[0]          # the oldest, used again
    seen_twice(8 + n)                     # evicts the least recently used
    assert len(graphs) == n and graphs.evictions == 1
    assert lease(8) is first[0]
    assert lease(9) is None               # was evicted: seen afresh
    assert lease(9) is not first[1]       # and a new graph
    assert graphs.evictions == 2


# -- the counters -------------------------------------------------------------------

def test_a_two_round_solve_sums_its_graph_counts():
    from karpenter_tpu_torch.apis import wellknown as wk
    from karpenter_tpu_torch.models.pod import PodAffinityTerm

    def pods():
        return (
            [make_pod(f"a-{i}", cpu="1", memory="1Gi",
                      labels=(("app", "a"),)) for i in range(3)]
            + [make_pod("side", cpu="100m", memory="64Mi",
                        pod_affinity=(PodAffinityTerm(
                            match_labels=(("app", "a"),),
                            topology_key=wk.LABEL_HOSTNAME),))])

    solver, plain = _graphed_solver(), _solver()
    counts = []
    for _ in range(2):
        res = solver.solve(pods())
        assert res.decisions() == plain.solve(pods()).decisions()
        np.testing.assert_array_equal(solver.last_flat, plain.last_flat)
        info = solver.last_solve_info
        counts.append((info["rounds"], info["graph_captures"],
                       info["graph_replays"]))
    # round 2's pack has round 1's shape: the shape's second sighting
    # captures, and the next solve replays both rounds
    assert counts == [(2, 1, 0), (2, 0, 2)]
    first = {"graph_replays": 1, "graph_captures": 0, "rounds": 1}
    info = {"graph_replays": 0, "graph_captures": 1, "rounds": 1}
    assert _fold_rounds(first, info) == {"graph_replays": 1,
                                         "graph_captures": 1}


def test_the_enqueue_span_carries_the_graph_counts():
    from karpenter_tpu_torch import profiling
    from karpenter_tpu_torch.tracing import TRACER

    solver = _graphed_solver()
    prev = profiling.set_enabled(True)
    try:
        for _ in range(3):
            TRACER.clear()
            solver.solve(_pods())
        (span,) = [sp for sp in TRACER.finished_spans()
                   if sp.name == "solver.dispatch.enqueue"]
        assert (span.attributes["graph_replays"],
                span.attributes["graph_captures"]) == (1, 0)
    finally:
        profiling.set_enabled(prev)


def _run(counters):
    from portbench.readers import Run

    reqs = [{"wall_s": 0.1, "t0_ns": 0, "t1_ns": 1, "pods": 1,
             "answered": True, "counters": c} for c in counters]
    return Run(kind="solve", requests=reqs, setup_s=0.0)


def test_the_benchmarks_reader_of_the_replay_share():
    from portbench.readers import reader

    read = reader("layers", "graph_replay_share.solve")
    assert read(_run([{"graph_replays": 1, "rounds": 1},
                      {"graph_replays": 1, "rounds": 2},
                      {"graph_replays": 0, "rounds": 1}])) == 50.0
    assert read(_run([{"graph_replays": 2, "rounds": 2}])) == 100.0
    # a program that keeps no such count (the parent) leaves it out
    assert read(_run([{"rounds": 1}])) is None
    assert read(_run([])) is None


def test_the_benchmark_names_the_replay_share():
    bench = load_json("BENCHMARK.json")
    (m,) = [m for m in bench["per_layer"]
            if m["name"] == "graph_replay_share.solve"]
    assert m == {"name": "graph_replay_share.solve", "unit": "%",
                 "better": "higher", "source": "program_counter",
                 "layer": "ops.packer", "moves": "pods_per_s",
                 "workloads": ["inflate.burst", "boutique.burst"]}
    assert bench["per_layer"][-1] is m


@pytest.mark.parametrize("name", ["inflate", "boutique"])
def test_a_cells_service_replays_from_its_third_solve(cells, name):
    """Through the cell's SolverService, as the benchmark drives it (its
    warm-up sends the one shape twice): the first Solve of a shape packs
    eager, the second captures, every later one replays, and each decides
    as a solver that packs eager."""
    system = cells[name]
    system.solver._pack_graphs = graphs_on_cpu()
    plain = TorchSolver(system.catalog, system.provisioners, device="cpu")
    counts = []
    for seed in (5, 6, 7, 8):
        rec = Traffic(system.config, SMALL_BURST, seed).request(0)
        out = system.call(rec, system.inputs(rec))
        c = out["counters"]
        counts.append((c["graph_captures"], c["graph_replays"]))
        plain.solve(system.inputs(rec))
        np.testing.assert_array_equal(system.solver.last_flat,
                                      plain.last_flat)
    assert counts == [(0, 0), (1, 0), (0, 1), (0, 1)]
    system.solver._pack_graphs = PackGraphs("cpu")


def test_a_synced_catalog_solver_starts_with_no_graphs():
    """The graphs live on the solver: one built for another catalog (a
    Sync's, or adopt_static's successor) holds none of its donor's."""
    donor = _graphed_solver()
    donor.solve(_pods())
    donor.solve(_pods())
    assert len(donor._pack_graphs) == 1
    succ = TorchSolver(donor.catalog, donor.provisioners, device="cpu")
    succ.adopt_static(donor)
    assert len(succ._pack_graphs) == 0
    assert succ._pack_graphs is not donor._pack_graphs


def test_fields_of_one_shape_in_other_dtypes_stage_as_the_upload_casts():
    """np.copyto with _to_tensor's casts: int64 host arrays of the same
    shape share the key and stage to the same int32 leaves."""
    fields, n_slots = synthetic_fields(3)
    wide = {k: v.astype(np.int64) if isinstance(v, np.ndarray)
            and v.dtype == np.int32 else v for k, v in fields.items()}
    n_eff = n_eff_of(fields["group_count"])
    assert key_of(wide, n_slots, n_eff) == key_of(fields, n_slots, n_eff)
    graphs = graphs_on_cpu()
    sight(graphs, fields, n_slots)
    graph_flat(graphs, fields, n_slots)
    flat, replayed = graph_flat(graphs, wide, n_slots)
    assert replayed
    np.testing.assert_array_equal(flat, eager_flat(fields, n_slots))


def test_a_shape_seen_once_is_forgotten_past_the_bound():
    """Keys seen once are kept as many as graphs, the least recently seen
    forgotten first: a shape seen again after that packs eager again."""
    graphs = graphs_on_cpu()
    fields, _ = synthetic_fields(1)
    n = pack_graph.MAX_GRAPHS

    def lease(slots):
        with graphs.lease(fields, slots, 6) as graph:
            return graph

    for k in range(n + 1):
        assert lease(8 + k) is None
    assert len(graphs) == 0
    assert lease(9) is not None           # still remembered: a graph
    assert lease(8) is None               # forgotten: a first sighting
    assert lease(8) is not None
    assert len(graphs) == 2 and graphs.evictions == 0


def test_the_packs_counter_names_each_way():
    fields, n_slots = synthetic_fields(4)
    n_eff = n_eff_of(fields["group_count"])
    graphs = graphs_on_cpu()
    ways = ("first", "held", "capture", "replay")
    before = {w: pack_graph.PACKS.value(way=w) for w in ways}
    sight(graphs, fields, n_slots)
    graph_flat(graphs, fields, n_slots)
    graph_flat(graphs, fields, n_slots)
    with graphs.lease(fields, n_slots, n_eff) as held:
        with graphs.lease(fields, n_slots, n_eff) as other:
            assert held is not None and other is None
    assert {w: pack_graph.PACKS.value(way=w) - before[w] for w in ways} \
        == {"first": 1, "held": 1, "capture": 1, "replay": 2}
