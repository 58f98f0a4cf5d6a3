"""Pod labels in the harness, on the CPU: a zone-redundant Online Boutique.

Each of Online Boutique's twelve Deployments labels its pods `app: <name>`
(release/kubernetes-manifests.yaml); spread over the zones with the
Kubernetes docs' constraint (maxSkew 1, topology.kubernetes.io/zone,
DoNotSchedule, labelSelector app: <name>), each balances its own pods.
The port counts a spread over "pods of its own group", and the group key
holds the labels, so labelled Deployments spread apart as the reference
spreads them; unlabelled ones of one shape would spread as one union, and
`check_mix` refuses such a mix.
"""

from __future__ import annotations

import copy
import gc

import pytest

from portbench.generator import Traffic, check_mix, load_json
from portbench.reference.answer import Reference

BOUTIQUE = load_json("portbench/configs/boutique.json")
INFLATE = load_json("portbench/configs/inflate.json")


def boutique(spread, labels: bool) -> dict:
    """Online Boutique with the zone spread on the Deployments `spread`
    names (all of them for True) and, with `labels`, each pod template's
    `app: <name>` label."""
    config = copy.deepcopy(BOUTIQUE)
    for d in config["mix"]:
        d["zone_spread"] = spread is True or d["name"] in spread
        if labels:
            d["labels"] = {"app": d["name"]}
    return config


HA = boutique(True, labels=True)
LABELLED = boutique((), labels=True)


def traffic(pods: int) -> dict:
    return {"request": "solve", "pods": {"fixed": pods}, "block": 1,
            "pool_seed": 10000}


@pytest.fixture(scope="module")
def system():
    """One SolverService on the CPU with the configuration's catalog and
    NodePool synced (every Boutique mix shares them); the Sync's heap
    freeze is undone after the module."""
    from portbench.drive import System

    yield System(HA, device="cpu")
    gc.unfreeze()


@pytest.mark.parametrize("config,keys", [(BOUTIQUE, 6), (LABELLED, 12),
                                         (HA, 12)],
                         ids=["boutique", "labelled", "zone-redundant"])
def test_labels_keep_same_shaped_deployments_apart(config, keys):
    """The seven 100m/64Mi Deployments are one group key unlabelled and
    seven labelled (test_portbench_generator holds each pod to what
    make_pod builds)."""
    from portbench.drive import PodFactory

    factory = PodFactory(config)
    rec = Traffic(config, traffic(300), 4).request(0)
    pods = factory.pods(rec)
    assert all(p.labels == factory.templates[d].labels
               for p, d in zip(pods, rec["order"].tolist()))
    assert len({p.group_key() for p in pods}) == keys
    assert len({t.group_key() for t in factory.templates}) == keys


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("pods", [300, 1000, 2500])
def test_the_zone_redundant_boutique_decides_as_the_reference(system, pods,
                                                              seed):
    rec = Traffic(HA, traffic(pods), seed).request(0)
    out = system.call(rec, system.inputs(rec))
    assert out["counters"]["routing"] == "cpu"
    assert out["answer"] == Reference(HA).answer(rec)
    # twelve Deployments, each split over three zones: a pack step each
    assert out["counters"]["steps"] == 36


def test_a_zone_redundant_10k_burst_decides_as_the_reference(system):
    rec = Traffic(HA, load_json("portbench/traffic/burst.json"),
                  3100000211).request(0)
    out = system.call(rec, system.inputs(rec))
    assert out["answer"] == Reference(HA).answer(rec)
    assert out["counters"]["steps"] == 36
    zones = {}
    for _type, zone, _cap, n in out["answer"][0]:
        zones[zone] = zones.get(zone, 0) + n
    assert sorted(zones) == HA["catalog"]["zones"]
    assert max(zones.values()) - min(zones.values()) <= 12


@pytest.mark.parametrize("seed", [5, 2**31 + 7])
@pytest.mark.parametrize("pods", [1000, 2500])
def test_labelled_unspread_boutique_decides_as_the_reference(system, pods,
                                                             seed):
    from portbench.drive import PodFactory

    rec = Traffic(LABELLED, traffic(pods), seed).request(0)
    out = system.call(rec, PodFactory(LABELLED).pods(rec))
    assert out["answer"] == Reference(LABELLED).answer(rec)
    assert out["counters"]["steps"] == 12


@pytest.mark.parametrize("config,names", [
    (boutique(True, labels=False),
     ["emailservice", "frontend", "shippingservice"]),
    (boutique({"frontend"}, labels=False),
     ["frontend", "emailservice", "currencyservice"]),
], ids=["all-spread", "frontend-spread"])
def test_a_mix_the_program_would_group_otherwise_is_refused(config, names):
    with pytest.raises(ValueError) as err:
        check_mix(config)
    assert all(n in str(err.value) for n in names)
    with pytest.raises(ValueError):
        Traffic(config, traffic(300), 1)


@pytest.mark.parametrize("labels", [{"app": 7}, [["app", "web"]]],
                         ids=["number", "list"])
def test_labels_other_than_strings_are_refused(labels):
    config = copy.deepcopy(LABELLED)
    config["mix"][0]["labels"] = labels
    with pytest.raises(ValueError, match="emailservice"):
        check_mix(config)


@pytest.mark.parametrize("config", [INFLATE, BOUTIQUE, LABELLED, HA],
                         ids=["inflate", "boutique", "labelled",
                              "zone-redundant"])
def test_the_benchmarks_mixes_pass_the_check(config):
    check_mix(config)
