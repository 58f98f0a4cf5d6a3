"""The reference against hand-worked cases and, at small sizes, against the
program's own scalar oracle on the CPU (a witness, not a dependency: the
reference imports nothing of the program)."""

import numpy as np
import pytest

from portbench.generator import ROOT, Traffic, load_json
from portbench.reference import scheduler
from portbench.reference.answer import Reference
from portbench.reference.catalog import (allocatable, build_options,
                                         category, kube_reserved_cpu,
                                         load_catalog)
from portbench.tests.test_portbench_generator import (INFLATE, MIXED, SCALE5,
                                                      SIZES)

TYPES = load_catalog(f"{ROOT}/portbench/data/fleet_catalog.json")
ZONES = ["zone-1a", "zone-1b", "zone-1c"]


def test_allocatable_of_m5_2xlarge_by_hand():
    e = next(t for t in TYPES if t["name"] == "m5.2xlarge")
    # 8 cores: 60 + 10 + 2 * 5 + 4 * 2.5 = 90 millicores reserved
    assert kube_reserved_cpu(8) == 90
    # memory: 32768 MiB less 7.5% (2457.6 MiB), 11 * 58 + 255 MiB kube
    # reserved and 100 MiB eviction: 3450.6 MiB, floored
    assert allocatable(e) == (8000 - 90, 32768 - 3450, 58)


def inflate_types():
    """Config 0's universe: 20 general-purpose amd64 types of the fleet."""
    return [t for t in TYPES if t["arch"] == "amd64"
            and t["family"] in ("m5", "c5", "r5")][:20]


def test_config0_inflate_100_pods_over_20_types_by_hand():
    types = inflate_types()
    assert len(types) == 20
    opts = build_options(types, ["zone-1a"], 0.65)
    prov = scheduler.Provisioner("default", ("on-demand",))
    groups = scheduler.prepare_groups(
        [dict(name="inflate-0", cpu=1000, memory=256, zone=None, spread=False,
              count=100)], ["zone-1a"])
    res = scheduler.schedule(opts, [prov], groups)
    # by hand: each node takes as many pods as the largest type fits, and
    # launches the cheapest type that holds that many; the last node the
    # cheapest type that holds what is left
    fit = {t["name"]: min(allocatable(t)[0] // 1000, allocatable(t)[1] // 256,
                          allocatable(t)[2]) for t in types}
    price = {t["name"]: t["od_price_usd"] for t in types}
    k = max(fit.values())
    want, left = [], 100
    while left:
        n = min(k, left)
        name = min((t for t in fit if fit[t] >= n),
                   key=lambda t: (price[t], t))
        want.append((name, "zone-1a", "on-demand", n))
        left -= n
    assert res.decisions == sorted(want) and res.unschedulable == 0


def oracle_decisions(pods, catalog, provs):
    from karpenter_tpu_torch.oracle.scheduler import Scheduler

    sched = Scheduler(catalog, provs)
    res = sched.schedule(list(pods))
    return res.node_decisions(sched.options), len(res.unschedulable)


def test_an_inflate_burst_by_hand():
    """10,000 one-cpu pods: each node takes the most pods an admissible
    type holds (191 on a 192-core type, whose kubelet keeps 550 millicores)
    and launches the cheapest type that holds them; the last node the
    cheapest that holds the 68 left."""
    ok = [t for t in TYPES if t["arch"] == "amd64"
          and category(t["family"]) in ("c", "m", "r")
          and t["generation"] > 2]
    fit = {t["name"]: min(allocatable(t)[0] // 1000, allocatable(t)[2])
           for t in ok}
    price = {t["name"]: t["od_price_usd"] for t in ok}
    assert max(fit.values()) == 191 and kube_reserved_cpu(192) == 550

    def cheapest(n):
        return min((t for t in fit if fit[t] >= n),
                   key=lambda t: (price[t], t))
    want = sorted([(cheapest(191), "zone-1a", "on-demand", 191)] * 52
                  + [(cheapest(68), "zone-1a", "on-demand", 68)])
    gen = Traffic(INFLATE, load_json("portbench/traffic/burst.json"), 9)
    assert Reference(INFLATE).answer(gen.request(0)) == (want, 0)
    assert want[-1][0] == "c6a.48xlarge"


@pytest.mark.parametrize("config,mix,seed", [
    (INFLATE, SCALE5, 1), (INFLATE, SCALE5, 2),
    (MIXED, SIZES, 1), (MIXED, SIZES, 2), (MIXED, SIZES, 3)])
def test_requests_equal_the_programs_scalar_oracle(config, mix, seed):
    from portbench.drive import PodFactory, build_catalog, build_provisioners

    catalog, provs = build_catalog(config), build_provisioners(config)
    t = load_json(f"portbench/traffic/{mix}.json") if isinstance(mix, str) \
        else mix
    gen = Traffic(config, t, seed)
    ref, pods = Reference(config), PodFactory(config)
    for i in range(4):
        rec = gen.request(i)
        assert ref.answer(rec) == oracle_decisions(pods.pods(rec), catalog,
                                                   provs)


def test_a_small_inflate_burst_equals_the_programs_scalar_oracle():
    from portbench.drive import PodFactory, build_catalog, build_provisioners

    t = {"request": "solve", "pods": {"fixed": 500}, "block": 1,
         "pool_seed": 1}
    rec = Traffic(INFLATE, t, 4).request(0)
    got = Reference(INFLATE).answer(rec)
    assert got == oracle_decisions(PodFactory(INFLATE).pods(rec),
                                   build_catalog(INFLATE),
                                   build_provisioners(INFLATE))
    assert [d[3] for d in got[0]] == sorted([191, 191, 118])
