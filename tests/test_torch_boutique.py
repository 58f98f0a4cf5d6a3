"""The benchmark's Online Boutique deployment (portbench/configs/boutique.json)
on the port, on the CPU, and the open-claim fill's counters.

* The configuration's seeded requests through SolverService decide as the
  benchmark's reference does, in six pack steps.
* The port groups the seven same-shaped Deployments as one pod group (the
  harness's pods carry no labels); the reference keeps a group a
  Deployment. Both forms give the same decisions.
* The control (the reference with a guarantee broken) answers wrong.
* fill_pods and fill_rows, read off the decoded assign matrix, on a
  hand-built two-group solve and an inflate burst; the readers of the
  benchmark's pack_steps, fill_pods and fill_rows metrics.
"""

from __future__ import annotations

import gc

import numpy as np
import pytest

from karpenter_tpu_torch.apis.provisioner import Provisioner
from karpenter_tpu_torch.models.instancetype import Catalog, make_instance_type
from karpenter_tpu_torch.models.pod import make_pod
from karpenter_tpu_torch.solver.core import TorchSolver, _fill_counts
from portbench.control import control_wrong
from portbench.generator import (Traffic, cpu_millis, first_names, load_json,
                                 mem_mib)
from portbench.reference import scheduler
from portbench.reference.answer import Reference

CONFIG = load_json("portbench/configs/boutique.json")

# Online Boutique's release/kubernetes-manifests.yaml: each Deployment's
# resources.requests (cpu, memory)
PUBLISHED = {
    "emailservice": ("100m", "64Mi"), "checkoutservice": ("100m", "64Mi"),
    "frontend": ("100m", "64Mi"), "paymentservice": ("100m", "64Mi"),
    "productcatalogservice": ("100m", "64Mi"),
    "currencyservice": ("100m", "64Mi"), "shippingservice": ("100m", "64Mi"),
    "recommendationservice": ("100m", "220Mi"),
    "cartservice": ("200m", "64Mi"), "adservice": ("200m", "180Mi"),
    "loadgenerator": ("300m", "256Mi"), "redis-cart": ("70m", "200Mi"),
}


def traffic(pods: int) -> dict:
    return {"request": "solve", "pods": {"fixed": pods}, "block": 1,
            "pool_seed": 10000}


@pytest.fixture(scope="module")
def boutique():
    """One SolverService on the CPU with the configuration synced, as the
    benchmark drives it, and the reference; the Sync's heap freeze is
    undone after the module."""
    from portbench.drive import System

    yield System(CONFIG, device="cpu"), Reference(CONFIG)
    gc.unfreeze()


def test_the_configuration_holds_the_published_requests():
    assert {d["name"]: (d["cpu"], d["memory"]) for d in CONFIG["mix"]} \
        == PUBLISHED
    assert all(d["share"] == 1.0 and d["zone"] is None
               and not d["zone_spread"] for d in CONFIG["mix"])
    bench = load_json("BENCHMARK.json")
    cell = next(w for w in bench["workloads"] if w["name"] == "boutique.burst")
    assert (cell["config"], cell["traffic"], cell["chips"]) == \
        ("boutique", "burst", 1)


@pytest.mark.parametrize("seed", [7, 2**31 + 11, 3100000017])
@pytest.mark.parametrize("pods", [300, 1000, 2500])
def test_the_port_decides_as_the_reference(boutique, pods, seed):
    system, ref = boutique
    rec = Traffic(CONFIG, traffic(pods), seed).request(0)
    out = system.call(rec, system.inputs(rec))
    assert out["counters"]["routing"] == "cpu"
    assert out["answer"] == ref.answer(rec)
    # twelve Deployments in six shapes: a pack step a shape
    assert out["counters"]["steps"] == 6
    assert out["counters"]["fill_pods"] > 0


def _reference_groups(ref: Reference, rec: dict, merged: bool):
    """The reference's groups for a request: one a Deployment, or (merged)
    one a distinct (cpu, memory), named by its first pod in the request,
    as the port's group key forms them for pods with no labels."""
    by_shape: dict = {}
    specs = []
    for d, (dep, count, name) in enumerate(zip(
            CONFIG["mix"], rec["counts"], first_names(CONFIG, rec))):
        if count <= 0:
            continue
        spec = dict(name=name, cpu=cpu_millis(dep["cpu"]),
                    memory=mem_mib(dep["memory"]), zone=None, spread=False,
                    count=int(count), at=int(np.argmax(rec["order"] == d)))
        key = (spec["cpu"], spec["memory"])
        first = by_shape.get(key) if merged else None
        if first is None:
            by_shape[key] = spec
            specs.append(spec)
            continue
        first["count"] += spec["count"]
        if spec["at"] < first["at"]:
            first.update(name=spec["name"], at=spec["at"])
    return scheduler.prepare_groups(specs, ref.options.zones)


@pytest.mark.parametrize("seed", [5, 2**31 + 3])
@pytest.mark.parametrize("pods", [300, 2500, 10000])
def test_merged_and_per_deployment_groups_decide_alike(pods, seed):
    ref = Reference(CONFIG)
    rec = Traffic(CONFIG, traffic(pods), seed).request(0)
    answers = []
    for merged in (False, True):
        groups = _reference_groups(ref, rec, merged)
        assert len(groups) == (6 if merged else 12)
        res = scheduler.schedule(ref.options, ref.provisioners, groups)
        answers.append((res.decisions, res.unschedulable))
    assert answers[0] == ref.answer(rec)
    assert answers[1] == answers[0]


@pytest.mark.parametrize("seed", [1, 2**31 + 5])
def test_the_control_answers_wrong(seed):
    assert control_wrong(CONFIG, traffic(10000), seed, 2) == 2


@pytest.mark.parametrize("rounds", [1, 2])
def test_a_two_group_solve_counts_its_fill_exactly(rounds):
    """Three 1.5-cpu pods open two 4-cpu claims (2 + 1); then ten 0.4-cpu
    pods fill 2 onto the first and 6 onto the second, and open a third
    for the last 2. The second step's fill saw the 2 open claims. A pod
    with affinity to the first group takes a second round, onto the
    first claim: the counts are both rounds' sums."""
    from karpenter_tpu_torch.apis import wellknown as wk
    from karpenter_tpu_torch.models.pod import PodAffinityTerm

    prov = Provisioner(name="default")
    prov.set_defaults()
    solver = TorchSolver(Catalog(types=[make_instance_type(
        "m.4x", cpu=4, memory="16Gi", od_price=0.2)]), [prov], device="cpu")
    pods = ([make_pod(f"a-{i}", cpu="1500m", memory="1Gi",
                      labels=(("app", "a"),)) for i in range(3)]
            + [make_pod(f"b-{i}", cpu="400m", memory="256Mi")
               for i in range(10)])
    if rounds == 2:
        pods.append(make_pod("side", cpu="100m", memory="64Mi", pod_affinity=(
            PodAffinityTerm(match_labels=(("app", "a"),),
                            topology_key=wk.LABEL_HOSTNAME),)))
    res = solver.solve(pods)
    assert sorted(n.pod_count for n in res.nodes) == \
        [2, 2 + 2 + rounds - 1, 1 + 6]
    info = solver.last_solve_info
    assert info["rounds"] == rounds
    assert (info["fill_pods"], info["fill_rows"]) == (8, 2)


@pytest.mark.parametrize("assign,n_eff,want", [
    # slot 0 opened by group 0 (3 pods), filled by groups 1 and 3; slot 1
    # opened by group 2 (2 pods), filled by group 3; row 4 lies past n_eff
    ([[3, 0, 0], [1, 0, 0], [0, 2, 0], [4, 5, 0], [9, 9, 9]], 4,
     (1 + 4 + 5, 3 + 1)),
    ([[0, 0], [0, 0]], 2, (0, 0)),
    ([[1, 1]], 0, (0, 0)),
], ids=["filled", "no-claims", "no-steps"])
def test_fill_counts_of_an_assign_matrix(assign, n_eff, want):
    assert _fill_counts(np.array(assign, np.int32), n_eff) == want


def test_an_inflate_burst_has_one_step_and_no_fill():
    from portbench.drive import System

    config = load_json("portbench/configs/inflate.json")
    rec = Traffic(config, load_json("portbench/traffic/burst.json"),
                  2**31 + 1).request(0)
    try:
        system = System(config, device="cpu")
        counters = system.call(rec, system.inputs(rec))["counters"]
    finally:
        gc.unfreeze()
    assert (counters["steps"], counters["fill_pods"],
            counters["fill_rows"]) == (1, 0, 0)


@pytest.mark.parametrize("name,counter", [
    ("pack_steps.solve", "steps"), ("fill_pods.solve", "fill_pods"),
    ("fill_rows.solve", "fill_rows")])
def test_the_benchmarks_readers_of_the_pack_counters(name, counter):
    """The mean over a run's answered Solves; the fill's readers are None
    where the program keeps no such counter (an older program's line
    leaves the metric out)."""
    from portbench.readers import Run, reader

    def run(*values):
        reqs = [{"wall_s": 0.1, "t0_ns": 0, "t1_ns": 1, "pods": 1,
                 "answered": True,
                 "counters": {} if v is None else {counter: v}}
                for v in values]
        return Run(kind="solve", requests=reqs, setup_s=0.0)

    assert reader("layers", name)(run(6, 4)) == 5
    if counter != "steps":
        assert reader("layers", name)(run(6, None)) is None
