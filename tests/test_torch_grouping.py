"""The port's pod grouping held to the JAX package's.

`karpenter_tpu_torch.models.pod.group_pods` groups a pod that carries no
current stamp on a flat content key, then merges the content keys whose
canonical group keys are equal; `karpenter_tpu.models.pod.group_pods`
interns every pod's canonical key. Both must give the same partition:
groups, counts, pod-name order, group order and representatives, and so
must `prepare_groups` built on them.

* Seeded random batches: requirements added in another key order and In
  sets that fold bounds (content keys that must merge, interleaved),
  preferences, tolerations, labels, spread, affinity terms, DaemonSets.
* Mixed batches of stamped and fresh pods; the intern table's epoch churn;
  a stamped pod's requirements refuse `add`.
* The stamps a pass leaves: pods grouped on a content key get a stamp of
  the table's current epoch, one stamp object per content key; merged
  content keys carry equal tokens; a repeat pass leaves every stamp object
  as it was.
* A solve's last_solve_info keys and its groups span, and the fold of a
  two-round solve's infos (solver/core.py _fold_rounds).
* The benchmark's 10,000-pod inflate and boutique batches.
"""

from __future__ import annotations

import dataclasses
import importlib
import random

import pytest

import karpenter_tpu.models.pod as jpod
import karpenter_tpu.oracle.scheduler as jsched
import karpenter_tpu_torch.models.pod as tpod
from karpenter_tpu.models.requirements import Requirements as JRequirements
from karpenter_tpu_torch import explain, profiling
from karpenter_tpu_torch.apis import wellknown as wk
from karpenter_tpu_torch.apis.provisioner import Provisioner
from karpenter_tpu_torch.models.instancetype import Catalog, make_instance_type
from karpenter_tpu_torch.models.requirements import Requirement
from karpenter_tpu_torch.oracle.scheduler import ExistingNode, prepare_groups
from karpenter_tpu_torch.solver.core import TorchSolver, _fold_rounds
from karpenter_tpu_torch.tracing import TRACER
from test_torch_solver import to_port

ZONES = ("zone-1a", "zone-1b", "zone-1c")
GEN = "karpenter.k8s.aws/instance-generation"


def to_jax(obj):
    """Rebuild a port pod (and what it holds) from the JAX package's copy
    of each class, field by field; requirements keep their key order."""
    if isinstance(obj, (str, int, float, bool, type(None))):
        return obj
    if type(obj) in (tuple, list):
        return type(obj)(to_jax(x) for x in obj)
    if isinstance(obj, frozenset):
        return frozenset(to_jax(x) for x in obj)
    mod = type(obj).__module__
    cls = getattr(importlib.import_module(
        "karpenter_tpu." + mod[len("karpenter_tpu_torch."):]),
        type(obj).__qualname__)
    if dataclasses.is_dataclass(obj):
        return cls(**{f.name: to_jax(getattr(obj, f.name))
                      for f in dataclasses.fields(obj) if f.init})
    out = cls()
    for r in obj:
        out.add(to_jax(r))
    return out


def partition(groups) -> list:
    """Group order, representative, count and names, and the spec's
    constraints (prepare_groups rewrites specs when it splits)."""
    return [(g.spec.name, g.count, list(g.pod_names),
             [tuple(x) for x in g.spec.requirements.to_specs()],
             [[tuple(x) for x in t.to_specs()] for t in g.spec.preferences])
            for g in groups]


def unstamp(pods) -> None:
    for p in pods:
        if hasattr(p, "_group"):
            object.__delattr__(p, "_group")


def content_key(p) -> tuple:
    """group_pods' flat content key of a pod it finds unstamped: group_key()'s
    fields, the requirements as their per-key entries in insertion order."""
    return (p.requests, tuple(p.requirements._by_key.values()),
            p.preferences, p.tolerations, p.topology,
            p.anti_affinity_hostname, p.anti_affinity_zone,
            p.pod_affinity, p.pod_anti_affinity, p.labels)


def assert_fresh_stamps(pods) -> None:
    """What one pass leaves on the pods it grouped on their content key: a
    (token, epoch, key) stamp of the table's current epoch, whose token is
    the pod's group_token(), and one stamp object per content key."""
    shared: dict = {}
    for p in pods:
        stamp = p._group
        assert stamp[1] == tpod._group_key_epoch
        assert p.group_token() == stamp[0]
        assert shared.setdefault(content_key(p), stamp) is stamp
    assert len({id(s) for s in shared.values()}) == len(shared)


# -- seeded batches, built with the JAX package's classes ----------------------

def _shape(rng: random.Random, i: int) -> dict:
    """A Deployment's pod template: its requirement entries (each pod
    adds them in its own order, and may reach the generation set through a
    bound that folds), and its other constraints."""
    reqs = []
    if rng.random() < 0.6:
        reqs.append((wk.LABEL_ZONE, "In", sorted(rng.sample(ZONES, 2))))
    if rng.random() < 0.5:
        reqs.append((wk.LABEL_ARCH, "In", ["amd64"]))
    if rng.random() < 0.4:
        reqs.append(("team", "NotIn", ["batch"]))
    gen = rng.random() < 0.5
    return {
        "cpu": rng.choice(["100m", "250m", "1"]),
        "memory": rng.choice(["64Mi", "1Gi"]),
        "reqs": reqs, "gen": gen,
        "prefer": rng.choice(ZONES) if rng.random() < 0.3 else None,
        "tolerations": (jpod.Toleration(key="gpu", operator="Exists"),)
        if rng.random() < 0.3 else (),
        "topology": (jpod.TopologySpreadConstraint(
            max_skew=1, topology_key=wk.LABEL_ZONE,
            when_unsatisfiable=rng.choice(["DoNotSchedule",
                                           "ScheduleAnyway"])),)
        if rng.random() < 0.3 else (),
        "labels": (("app", f"d{rng.randrange(3)}"),)
        if rng.random() < 0.6 else (),
        "anti": rng.random() < 0.15,
        "affinity": (jpod.PodAffinityTerm(match_labels=(("app", "d0"),),
                                          topology_key=wk.LABEL_ZONE),)
        if rng.random() < 0.2 else (),
        "daemon": rng.random() < 0.1,
    }


def _jax_pod(rng: random.Random, name: str, shape: dict):
    reqs = list(shape["reqs"])
    if shape["gen"]:
        # In {4, 5} alone, or In {2, 4, 5} cut by Gt 3: one canonical form
        reqs += [(GEN, "In", ["2", "4", "5"]), (GEN, "Gt", ["3"])] \
            if rng.random() < 0.5 else [(GEN, "In", ["4", "5"])]
    rng.shuffle(reqs)
    r = JRequirements.of(*reqs)
    prefs = (JRequirements.of((wk.LABEL_ZONE, "In", [shape["prefer"]])),) \
        if shape["prefer"] else ()
    return jpod.make_pod(
        name, cpu=shape["cpu"], memory=shape["memory"], requirements=r,
        preferences=prefs, tolerations=shape["tolerations"],
        topology=shape["topology"], labels=shape["labels"],
        anti_affinity_hostname=shape["anti"], pod_affinity=shape["affinity"],
        owner_kind="DaemonSet" if shape["daemon"] else "ReplicaSet")


def batch(seed: int) -> "tuple[list, list]":
    """-> (the JAX package's pods, the port's copies of them)."""
    rng = random.Random(seed)
    shapes = [_shape(rng, i) for i in range(rng.randrange(2, 7))]
    jax_pods = [_jax_pod(rng, f"p-{seed}-{i}", rng.choice(shapes))
                for i in range(rng.randrange(40, 160))]
    return jax_pods, to_port(jax_pods)


SEEDS = list(range(12)) + [2**31 + 5, 3100000201]


@pytest.mark.parametrize("seed", SEEDS)
def test_group_pods_matches_the_jax_package(seed):
    jax_pods, pods = batch(seed)
    want = partition(jpod.group_pods(jax_pods))
    assert partition(tpod.group_pods(pods)) == want
    # again, now every pod reads its stamp
    assert partition(tpod.group_pods(pods)) == want


@pytest.mark.parametrize("seed", SEEDS)
def test_prepare_groups_matches_the_jax_package(seed):
    jax_pods, pods = batch(seed)
    want = partition(jsched.prepare_groups(jax_pods, ZONES))
    assert partition(prepare_groups(pods, ZONES)) == want


@pytest.mark.parametrize("seed", range(6))
def test_mixed_stamped_and_fresh_batches_give_the_same_partition(seed):
    jax_pods, pods = batch(seed)
    want = partition(jpod.group_pods(jax_pods))
    rng = random.Random(seed)
    half = rng.sample(pods, len(pods) // 2)
    tpod.group_pods(half)
    stamps = [p._group for p in half]
    assert partition(tpod.group_pods(pods)) == want
    # the stamped half was grouped on its stamps, the rest on content keys
    assert all(p._group is st for p, st in zip(half, stamps))
    stamped = {id(p) for p in half}
    assert_fresh_stamps([p for p in pods if id(p) not in stamped])


def _canonical_twins(n: int):
    """n pods of one canonical group in two content keys, alternating: zone
    then arch, and arch then zone."""
    forms = [((wk.LABEL_ZONE, "In", ["zone-1a"]), (wk.LABEL_ARCH, "In", ["amd64"])),
             ((wk.LABEL_ARCH, "In", ["amd64"]), (wk.LABEL_ZONE, "In", ["zone-1a"]))]
    out = []
    for i in range(n):
        r = JRequirements.of(*forms[i % 2])
        out.append(jpod.make_pod(f"t-{i}", cpu="250m", memory="64Mi",
                                 requirements=r))
    return out


def test_interleaved_content_keys_merge_in_input_order():
    jax_pods = _canonical_twins(9) + [
        jpod.make_pod("odd", cpu="1", memory="1Gi")]
    jax_pods.insert(4, jpod.make_pod("odd-2", cpu="1", memory="1Gi"))
    pods = to_port(jax_pods)
    got = tpod.group_pods(pods)
    assert partition(got) == partition(jpod.group_pods(jax_pods))
    assert [g.pod_names for g in got][0] == [
        p.name for p in pods if p.name.startswith("t-")]
    assert_fresh_stamps(pods)
    # two key orders of one group: two stamps, merged on one token
    zone_first, arch_first = pods[0]._group, pods[1]._group
    assert zone_first is not arch_first
    assert zone_first[0] == arch_first[0] != pods[-1]._group[0]


def test_a_fresh_content_key_merges_into_a_stamped_group():
    jax_pods = _canonical_twins(8)
    pods = to_port(jax_pods)
    tpod.group_pods(pods[1::2])  # stamps the arch-first pods
    stamps = [p._group for p in pods[1::2]]
    got = tpod.group_pods(pods)
    assert partition(got) == partition(jpod.group_pods(jax_pods))
    assert got[0].spec is pods[0]
    # the stamped pods kept their stamps; the fresh key took one of its own
    # on the same token
    assert all(p._group is st for p, st in zip(pods[1::2], stamps))
    assert_fresh_stamps(pods[::2])
    assert pods[0]._group is not stamps[0]
    assert pods[0]._group[0] == stamps[0][0]


def test_bound_folded_in_sets_merge():
    plain = jpod.make_pod("a", cpu="1", requirements=JRequirements.of(
        (GEN, "In", ["4", "5"])))
    folded = jpod.make_pod("b", cpu="1", requirements=JRequirements.of(
        (GEN, "In", ["2", "4", "5"]), (GEN, "Gt", ["3"])))
    pods = to_port([folded, plain, folded])
    got = tpod.group_pods(pods)
    assert [(g.spec.name, g.pod_names) for g in got] == [("b", ["b", "a", "b"])]


def test_labels_still_separate_deployments():
    a = [tpod.make_pod(f"a-{i}", cpu="1", labels=(("app", "a"),))
         for i in range(3)]
    b = [tpod.make_pod(f"b-{i}", cpu="1", labels=(("app", "b"),))
         for i in range(3)]
    got = tpod.group_pods([a[0], b[0], a[1], b[1], a[2], b[2]])
    assert [g.pod_names for g in got] == [["a-0", "a-1", "a-2"],
                                          ["b-0", "b-1", "b-2"]]


def test_counters_on_a_fresh_burst_and_its_repeat():
    """A fresh burst is grouped on its two content keys and stamped; its
    repeat reads the stamps and leaves each stamp object as it was."""
    pods = [tpod.make_pod(f"p-{i}", cpu="1" if i % 3 else "250m")
            for i in range(300)]
    first = partition(tpod.group_pods(pods))
    assert_fresh_stamps(pods)
    stamps = [p._group for p in pods]
    assert len({id(st) for st in stamps}) == 2
    assert partition(tpod.group_pods(pods)) == first
    assert all(p._group is st for p, st in zip(pods, stamps))


def test_a_stamped_pods_requirements_refuse_add():
    pods = to_port(_canonical_twins(6))
    pods.append(tpod.make_pod("pref", cpu="1", preferences=(
        tpod.Requirements.of((wk.LABEL_ZONE, "In", ["zone-1b"])),)))
    tpod.group_pods(pods)
    for p in pods:
        assert p.group_token() == p._group[0]
        with pytest.raises(RuntimeError, match="copy-on-write"):
            p.requirements.add(Requirement.create("team", "In", ["web"]))
    with pytest.raises(RuntimeError, match="copy-on-write"):
        pods[-1].preferences[0].add(Requirement.create("team", "In", ["x"]))
    # a copy is free to change, and is a pod of its own group
    q = dataclasses.replace(pods[0], name="q",
                            requirements=pods[0].requirements.copy())
    q.requirements.add(Requirement.create("team", "In", ["web"]))
    got = tpod.group_pods(pods + [q])
    assert [g.pod_names for g in got][-1] == ["q"]


def test_group_pods_survives_intern_table_epoch_churn():
    """The port's copy of tests/test_encode.py's churn test: a mid-pass
    intern-table clear must not split equal-key pods, and churn faster than
    a pass ends in the raw-key fallback with the same partition, the JAX
    package's. The twins' two content keys sit apart, so a clear between
    their interns would give them two tokens."""
    twins = _canonical_twins(10)
    jax_pods = []
    for i in range(20):
        if i < len(twins):
            jax_pods.append(twins[i])
        jax_pods += [jpod.make_pod(f"q{i}", cpu="500m", memory="128Mi"),
                     jpod.make_pod(f"r{i}", cpu="250m", memory="64Mi")]
    pods = to_port(jax_pods)
    want = partition(jpod.group_pods(jax_pods))
    assert partition(tpod.group_pods(pods)) == want and len(want) == 3

    saved = tpod._GROUP_KEY_TABLE_MAX
    try:
        for size in (1, 2):  # every new intern (or every second) clears
            tpod._GROUP_KEY_TABLE_MAX = size
            with tpod._group_key_lock:
                tpod._group_key_tokens.clear()
                tpod._group_key_epoch += 1
            unstamp(pods)
            assert partition(tpod.group_pods(pods)) == want
        tpod._GROUP_KEY_TABLE_MAX = saved
        # half the pods stamped, then the table cleared: their stale stamps
        # must not keep them apart from the fresh half
        unstamp(pods)
        tpod.group_pods(pods[::2])
        with tpod._group_key_lock:
            tpod._group_key_tokens.clear()
            tpod._group_key_epoch += 1
        assert partition(tpod.group_pods(pods)) == want
    finally:
        tpod._GROUP_KEY_TABLE_MAX = saved


def test_resident_counts_read_the_shared_stamp():
    pods = to_port(_canonical_twins(4))
    tpod.group_pods(pods)
    node = ExistingNode(name="n", labels={}, allocatable=[0] * wk.NUM_RESOURCES,
                        used=[0] * wk.NUM_RESOURCES, resident=tuple(pods))
    assert node.resident_counts == {pods[0].group_key(): 4}
    fresh = to_port(_canonical_twins(4))
    assert fresh[1].group_key() == pods[1].group_key()


# -- what a solve records -------------------------------------------------------

def _solver() -> TorchSolver:
    prov = Provisioner(name="default")
    prov.set_defaults()
    return TorchSolver(Catalog(types=[make_instance_type(
        "m.4x", cpu=4, memory="16Gi", od_price=0.2)]), [prov], device="cpu")


def test_last_solve_info_and_the_groups_span_carry_the_counters():
    """A single-round solve's last_solve_info holds its phase times, its
    rung, its pack's counts and its span record, in that order; the groups
    span carries the pods and groups of the encode."""
    s = _solver()
    pods = to_port(_canonical_twins(6)) + [
        tpod.make_pod(f"p-{i}", cpu="1", memory="1Gi") for i in range(5)]
    prev = profiling.set_enabled(True)
    try:
        TRACER.clear()
        s.solve(pods)
        info = s.last_solve_info
        assert list(info) == [
            "encode_ms", "dispatch_ms", "transfer_ms", "decode_ms",
            "routing", "bucket", "plan", "slots", "res_width", "steps",
            "fill_pods", "fill_rows", "graph_replays", "graph_captures",
            "rounds", "compile_cache",
            "device_count"] + (["decision"] if explain.enabled() else []) \
            + ["gc_full_ms", "spans"]
        (span,) = [sp for sp in TRACER.finished_spans()
                   if sp.name == "solver.encode.groups"]
        assert span.attributes == {"pods": 11, "groups": 2}
    finally:
        profiling.set_enabled(prev)


def test_a_two_round_solve_sums_the_counters():
    """_fold_rounds folds round 1's info into round 2's: every *_ms time
    and every additive count round 2 has summed, the span records joined,
    rounds=2, the rest round 2's."""
    first = {"encode_ms": 1.5, "dispatch_ms": 2.0, "routing": "cpu",
             "bucket": "g8", "steps": 3, "fill_pods": 4, "fill_rows": 5,
             "rounds": 1, "gc_full_ms": 0.25,
             "spans": (("solver.split", 1, 2), ("solver.encode", 2, 3))}
    info = {"encode_ms": 10.0, "dispatch_ms": 20.0, "routing": "cpu",
            "bucket": "g16", "steps": 30, "fill_pods": 40, "fill_rows": 50,
            "rounds": 1, "compile_cache": "hit", "gc_full_ms": 0.5,
            "spans": (("solver.encode", 5, 6),)}
    summed = _fold_rounds(first, info)
    assert summed == {"encode_ms": 11.5, "dispatch_ms": 22.0, "steps": 33,
                      "fill_pods": 44, "fill_rows": 55, "gc_full_ms": 0.75}
    assert info == {**summed, "routing": "cpu", "bucket": "g16",
                    "rounds": 2, "compile_cache": "hit",
                    "spans": (("solver.split", 1, 2), ("solver.encode", 2, 3),
                              ("solver.encode", 5, 6))}
    # the native scan's info: no fill counts and no span record
    first = {"encode_ms": 1.0, "scan_ms": 2.0, "shape": (1, 8, 0),
             "steps": 0, "rounds": 1}
    info = {"encode_ms": 3.0, "scan_ms": 4.0, "shape": (2, 8, 1),
            "steps": 0, "rounds": 1}
    assert _fold_rounds(first, info) == {"encode_ms": 4.0, "scan_ms": 6.0,
                                         "steps": 0}
    assert info == {"encode_ms": 4.0, "scan_ms": 6.0, "shape": (2, 8, 1),
                    "steps": 0, "rounds": 2}


# -- the benchmark's batches ---------------------------------------------------

@pytest.mark.parametrize("config,groups", [("inflate", 1), ("boutique", 6)])
def test_the_benchmarks_10k_batches_group_as_the_jax_package(config, groups):
    from portbench.drive import PodFactory
    from portbench.generator import Traffic, load_json

    cfg = load_json(f"portbench/configs/{config}.json")
    record = Traffic(cfg, load_json("portbench/traffic/burst.json"),
                     3100000201).request(0)
    pods = PodFactory(cfg).pods(record)
    assert len(pods) == 10000
    want = partition(jsched.prepare_groups(to_jax(pods), ZONES))
    assert len(want) == groups
    assert not any(hasattr(p, "_group") for p in pods)
    assert partition(prepare_groups(pods, ZONES)) == want
    assert_fresh_stamps(pods)
    stamps = [p._group for p in pods]
    # a controller re-solving the same pending pods reads their stamps
    assert partition(prepare_groups(pods, ZONES)) == want
    assert all(p._group is st for p, st in zip(pods, stamps))
