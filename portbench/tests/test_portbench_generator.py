"""The generator: the same seed gives the same requests, every seed the
same work, and a Solve's pods keep the mix's shares."""

import copy

import numpy as np
import pytest

from portbench.generator import (Traffic, check_mix, cpu_millis, load_json,
                                 mem_mib)

INFLATE = load_json("portbench/configs/inflate.json")

# a configuration of several deployments, zone pins and a zone spread, to
# hold the generator, the pod builder and the reference to every field a
# configuration's mix may use
MIXED = copy.deepcopy(INFLATE)
MIXED["mix"] = [
    {"name": "web", "share": 0.30, "cpu": "500m", "memory": "1Gi",
     "zone": None, "zone_spread": True},
    {"name": "api", "share": 0.20, "cpu": "1", "memory": "2Gi",
     "zone": None, "zone_spread": False},
    {"name": "batch", "share": 0.25, "cpu": "250m", "memory": "512Mi",
     "zone": None, "zone_spread": False},
    {"name": "zone-a", "share": 0.15, "cpu": "1", "memory": "1Gi",
     "zone": "zone-1a", "zone_spread": False},
    {"name": "bare", "share": 0.10, "cpu": "2", "memory": None,
     "zone": None, "zone_spread": False}]
# the same deployments, each pod carrying its template's labels
LABELLED = copy.deepcopy(MIXED)
for _d in LABELLED["mix"]:
    _d["labels"] = {"app": _d["name"], "tier": "demo"}
SIZES = {"request": "solve", "pods": {"sizes": [1, 3, 40, 250]},
         "block": 4, "pool_seed": 77}
# the source's own scale-up, `kubectl scale deployment inflate --replicas 5`
SCALE5 = {"request": "solve", "pods": {"fixed": 5}, "block": 1,
          "pool_seed": 5}


def traffic(name):
    return load_json(f"portbench/traffic/{name}.json")


def same(a, b):
    return a.keys() == b.keys() and all(
        np.array_equal(a[k], b[k]) if isinstance(a[k], np.ndarray)
        else a[k] == b[k] for k in a)


@pytest.mark.parametrize("config,mix", [(INFLATE, "burst"),
                                        (INFLATE, SCALE5),
                                        (MIXED, SIZES)])
@pytest.mark.parametrize("seed", [0, 7, 2**31 + 11, 2**40 + 3, -5])
def test_a_seed_makes_the_same_requests_and_another_seed_others(config, mix,
                                                                seed):
    t = traffic(mix) if isinstance(mix, str) else mix
    a, b = Traffic(config, t, seed), Traffic(config, t, seed)
    other = Traffic(config, t, seed + 1)
    for i in (0, 1, 37):
        assert same(a.request(i), b.request(i))
        assert not same(a.request(i), other.request(i))
    assert not same(a.request(0), a.request(1))


@pytest.mark.parametrize("mix,n", [("burst", 10_000), (SCALE5, 5)])
def test_inflate_requests_are_the_traffics_fixed_batch(mix, n):
    gen = Traffic(INFLATE, traffic(mix) if isinstance(mix, str) else mix,
                  12345)
    for i in range(5):
        rec = gen.request(i)
        assert rec["counts"].tolist() == [n]
        assert len(set(rec["tokens"].tolist())) == n


def test_a_mixed_solve_keeps_the_shares():
    t = dict(SIZES, pods={"fixed": 10_000}, block=8)
    gen = Traffic(MIXED, t, 5)
    counts = np.array([gen.request(i)["counts"] for i in range(64)])
    assert (counts.sum(axis=1) == 10_000).all()
    shares = counts.sum(axis=0) / counts.sum()
    want = np.array([d["share"] for d in MIXED["mix"]])
    np.testing.assert_allclose(shares, want / want.sum(), atol=0.01)
    rec = gen.request(3)
    assert np.array_equal(np.bincount(rec["order"], minlength=5),
                          rec["counts"])


@pytest.mark.parametrize("seed", [1, 99, 2**33])
def test_every_block_sends_the_pools_shapes_in_the_seeds_order(seed):
    gen = Traffic(MIXED, SIZES, seed)
    k = len(gen.pool)
    assert k == 4 and gen.pool.sum(axis=1).tolist() == [1, 3, 40, 250]
    for block in range(3):
        got = sorted(gen.shape(block * k + j) for j in range(k))
        assert got == list(range(k))
        for j in range(k):
            i = block * k + j
            assert np.array_equal(gen.request(i)["counts"],
                                  gen.pool[gen.shape(i)])
    other = Traffic(MIXED, SIZES, seed + 1)
    assert np.array_equal(other.pool, gen.pool)
    assert [gen.shape(j) for j in range(3 * k)] != \
        [other.shape(j) for j in range(3 * k)]


@pytest.mark.parametrize("config", [MIXED, LABELLED])
def test_the_mixed_deployments_pass_the_mix_check(config):
    check_mix(config)


def test_a_size_list_must_fill_its_block_and_the_kind_must_be_known():
    with pytest.raises(ValueError):
        Traffic(MIXED, dict(SIZES, block=3), 0)
    with pytest.raises(ValueError):
        Traffic(MIXED, dict(SIZES, request="consolidate"), 0)


@pytest.mark.parametrize("config,mix", [(INFLATE, "burst"), (MIXED, SIZES)])
def test_warmup_sends_every_shape_of_the_pool_and_is_not_the_window(config,
                                                                    mix):
    gen = Traffic(config, traffic(mix) if isinstance(mix, str) else mix, 4)
    warm = gen.warmup()
    assert len(warm) == max(len(gen.pool), 2)
    for j, r in enumerate(warm):
        assert np.array_equal(r["counts"], gen.pool[j % len(gen.pool)])
    assert not same(warm[0], gen.request(0))


def test_quantities():
    assert [cpu_millis(q) for q in ("500m", "1", "2", "250m")] == \
        [500, 1000, 2000, 250]
    assert [mem_mib(q) for q in ("1Gi", "512Mi", "8Gi", "1500Ki", None)] == \
        [1024, 512, 8192, 2, 0]


@pytest.mark.parametrize("config,mix", [(INFLATE, SCALE5), (MIXED, SIZES),
                                        (LABELLED, SIZES)])
def test_the_harness_builds_the_pods_make_pod_builds(config, mix):
    from karpenter_tpu_torch.apis import wellknown as wk
    from karpenter_tpu_torch.models.pod import (TopologySpreadConstraint,
                                                make_pod)
    from portbench.drive import PodFactory
    from portbench.generator import pod_name

    t = traffic(mix) if isinstance(mix, str) else mix
    rec = Traffic(config, t, 3).request(5)
    pods = PodFactory(config).pods(rec)
    spread = (TopologySpreadConstraint(max_skew=1,
                                       topology_key=wk.LABEL_ZONE),)
    for p, d, tok in zip(pods, rec["order"].tolist(), rec["tokens"].tolist()):
        dep = config["mix"][d]
        want = make_pod(pod_name(dep["name"], tok), cpu=dep["cpu"],
                        memory=dep["memory"] or "0",
                        node_selector={wk.LABEL_ZONE: dep["zone"]}
                        if dep["zone"] else None,
                        topology=spread if dep["zone_spread"] else (),
                        labels=tuple(sorted(dep.get("labels", {}).items())))
        assert p == want and p.group_key() == want.group_key()


def test_the_provisioner_admits_the_sources_categories_and_generations():
    from karpenter_tpu_torch.apis import wellknown as wk
    from portbench.drive import build_catalog, build_provisioners, families

    fams = families(INFLATE, ["c", "m", "r"])
    assert {"c5", "c5n", "m5zn", "r5b", "c6g"} <= set(fams)
    assert not {"cc2", "t3", "x1", "u", "i3"} & set(fams)
    (prov,) = build_provisioners(INFLATE)
    catalog = build_catalog(INFLATE)
    ok = {t.name for t in catalog.types
          if prov.requirements.matches_labels(
              {**t.labels_dict(), wk.LABEL_ZONE: "zone-1a",
               wk.LABEL_CAPACITY_TYPE: "on-demand"})}
    assert "c6a.48xlarge" in ok and "m5.large" in ok
    assert not {"c4.large", "m3.medium"} - ok  # generation 3 and 4 pass
    assert not {"c1.medium", "m1.small", "t3.large", "c6g.large"} & ok
    assert wk.LABEL_INSTANCE_GENERATION in prov.requirements.keys()
