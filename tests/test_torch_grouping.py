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
* The three counters (group_keyed, group_stamped, group_merged), through
  `group_counts` and through a solve's last_solve_info and its span.
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
from karpenter_tpu_torch import profiling
from karpenter_tpu_torch.apis import wellknown as wk
from karpenter_tpu_torch.apis.provisioner import Provisioner
from karpenter_tpu_torch.models.instancetype import Catalog, make_instance_type
from karpenter_tpu_torch.models.requirements import Requirement
from karpenter_tpu_torch.oracle.scheduler import ExistingNode, prepare_groups
from karpenter_tpu_torch.solver.core import TorchSolver
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
    tpod.group_pods(rng.sample(pods, len(pods) // 2))
    keyed, stamped, _ = tpod.group_counts()
    assert partition(tpod.group_pods(pods)) == want
    after = tpod.group_counts()
    assert (after[0] - keyed, after[1] - stamped) == \
        (len(pods) - len(pods) // 2, len(pods) // 2)


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
    before = tpod.group_counts()
    got = tpod.group_pods(pods)
    after = tpod.group_counts()
    assert partition(got) == partition(jpod.group_pods(jax_pods))
    assert [g.pod_names for g in got][0] == [
        p.name for p in pods if p.name.startswith("t-")]
    # two key orders of one group: one merge
    assert tuple(a - b for a, b in zip(after, before)) == (11, 0, 1)


def test_a_fresh_content_key_merges_into_a_stamped_group():
    jax_pods = _canonical_twins(8)
    pods = to_port(jax_pods)
    tpod.group_pods(pods[1::2])  # stamps the arch-first pods
    before = tpod.group_counts()
    got = tpod.group_pods(pods)
    after = tpod.group_counts()
    assert partition(got) == partition(jpod.group_pods(jax_pods))
    assert got[0].spec is pods[0]
    assert tuple(a - b for a, b in zip(after, before)) == (4, 4, 1)


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
    pods = [tpod.make_pod(f"p-{i}", cpu="1" if i % 3 else "250m")
            for i in range(300)]
    c0 = tpod.group_counts()
    first = partition(tpod.group_pods(pods))
    c1 = tpod.group_counts()
    assert partition(tpod.group_pods(pods)) == first
    c2 = tpod.group_counts()
    assert tuple(a - b for a, b in zip(c1, c0)) == (300, 0, 0)
    assert tuple(a - b for a, b in zip(c2, c1)) == (0, 300, 0)


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


# -- the solver's counters -----------------------------------------------------

def _solver() -> TorchSolver:
    prov = Provisioner(name="default")
    prov.set_defaults()
    return TorchSolver(Catalog(types=[make_instance_type(
        "m.4x", cpu=4, memory="16Gi", od_price=0.2)]), [prov], device="cpu")


def test_last_solve_info_and_the_groups_span_carry_the_counters():
    s = _solver()
    pods = to_port(_canonical_twins(6)) + [
        tpod.make_pod(f"p-{i}", cpu="1", memory="1Gi") for i in range(5)]
    prev = profiling.set_enabled(True)
    try:
        TRACER.clear()
        s.solve(pods)
        info = s.last_solve_info
        assert (info["group_keyed"], info["group_stamped"],
                info["group_merged"]) == (11, 0, 1)
        (span,) = [sp for sp in TRACER.finished_spans()
                   if sp.name == "solver.encode.groups"]
        assert {k: span.attributes[k] for k in
                ("group_keyed", "group_stamped", "group_merged")} == \
            {"group_keyed": 11, "group_stamped": 0, "group_merged": 1}
        s.solve(pods)
        info = s.last_solve_info
        assert (info["group_keyed"], info["group_stamped"],
                info["group_merged"]) == (0, 11, 0)
    finally:
        profiling.set_enabled(prev)


def test_a_two_round_solve_sums_the_counters():
    s = _solver()
    db = [tpod.make_pod(f"db-{i}", cpu="1", memory="1Gi",
                        labels=(("app", "db"),)) for i in range(2)]
    web = [tpod.make_pod(f"s-{i}", cpu="250m", memory="256Mi", pod_affinity=(
        tpod.PodAffinityTerm(match_labels=(("app", "db"),),
                             topology_key=wk.LABEL_HOSTNAME),))
        for i in range(3)]
    s.solve(db + web)
    info = s.last_solve_info
    assert info["rounds"] == 2
    # the affinity split grouped (and stamped) every pod before round 1
    assert (info["group_keyed"], info["group_stamped"],
            info["group_merged"]) == (0, 5, 0)


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
    c0 = tpod.group_counts()
    assert partition(prepare_groups(pods, ZONES)) == want
    c1 = tpod.group_counts()
    assert tuple(a - b for a, b in zip(c1, c0)) == (10000, 0, 0)
    # a controller re-solving the same pending pods reads their stamps
    assert partition(prepare_groups(pods, ZONES)) == want
    c2 = tpod.group_counts()
    assert tuple(a - b for a, b in zip(c2, c1)) == (0, 10000, 0)
