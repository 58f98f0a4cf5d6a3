"""The port's mesh (parallel/sharded.py, parallel/multihost.py) against the
JAX package's, on the CPU, over gloo process groups.

JAX's mesh is one process over 8 virtual CPU devices (conftest); the
port's is one process per rank. For each rank count (2, 4 and 8) one
process group of `tests/test_torch_mesh_worker.py` ranks is spawned, which
rendezvous through a FileStore in tmp_path, import nothing of JAX, and run
every case of that rank count in turn; this process holds their outputs to
the JAX package's:

* the cases of tests/test_sharded.py: the mesh shape; sharded_pack at 2, 4
  and 8 ranks equal, in every PackResult field, to JAX's sharded_pack on
  as many virtual devices and to JAX's pack; the odd type count (5 types
  on a 2 x 2 mesh, padded); the hybrid mesh of 2 hosts x 4 ranks, whose
  mesh_description equals what tests/test_multiprocess.py asserts of
  JAX's 2-process mesh, and the single-host one equal to JAX's
  single-process description; the lane-sharded consolidation verdicts
  equal to JAX's single sweep;
* a richer problem (existing nodes with residents, hostname anti-affinity,
  zone spread, the compressed resource layout) so every collective of a
  step crosses ranks, at 2, 4 and 8 ranks;
* ShardedContext on a 2 x 2 mesh: rank 0 drives TorchSolver's sharded
  route (routing "cpu-sharded", device_count 4), the other ranks follow,
  and both flat buffers (cold catalog, then resident) equal the single
  solve's;
* every rank's result equals rank 0's.

And, in this process: the plain fill's split (row max, fill, waterfall,
used update, mask shrink) in lockstep with the fused plain fill, step by
step, through a pack.
"""

from __future__ import annotations

import json
import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from karpenter_tpu.ops.packer import pack as jax_pack
from karpenter_tpu.parallel import sharded as jax_sharded
from tests.test_sharded import build_inputs, pad_inputs

REPO = Path(__file__).resolve().parent.parent
WORKER = REPO / "tests" / "test_torch_mesh_worker.py"
FIELDS = ("assign", "ex_assign", "unsched", "used", "active", "nprov",
          "decided", "n_open")


def odd_type_inputs():
    """tests/test_sharded.py's odd-type-count problem: 5 types, 25 pods."""
    from karpenter_tpu.apis.provisioner import Provisioner
    from karpenter_tpu.models.encode import encode_problem
    from karpenter_tpu.models.instancetype import Catalog, make_instance_type
    from karpenter_tpu.models.pod import make_pod

    catalog = Catalog(types=[
        make_instance_type(f"o.{i}x", cpu=2 * (i + 1), memory=f"{8 * (i + 1)}Gi",
                           od_price=0.1 * (i + 1), spot_price=0.03 * (i + 1))
        for i in range(5)])
    prov = Provisioner(name="default")
    prov.set_defaults()
    pods = [make_pod(f"a{i}", cpu="1", memory="2Gi") for i in range(25)]
    return pad_inputs(encode_problem(catalog, [prov], pods))


def rich_inputs():
    """Existing nodes (partly used, every third hosting a hostname
    anti-affinity resident), zone-spread, pinned and anti-affinity pods,
    through JAX's build_pack_inputs (res_sel, ex_cap, group_origin)."""
    from karpenter_tpu.apis import wellknown as wk
    from karpenter_tpu.apis.provisioner import Provisioner
    from karpenter_tpu.models.encode import encode_problem
    from karpenter_tpu.models.instancetype import Catalog, make_instance_type
    from karpenter_tpu.models.pod import TopologySpreadConstraint, make_pod
    from karpenter_tpu.oracle.scheduler import ExistingNode
    from karpenter_tpu.solver.core import build_pack_inputs

    types = [make_instance_type(f"r.{i}x", cpu=2 * (i + 1),
                                memory=f"{4 * (i + 1)}Gi",
                                od_price=0.11 * (i + 1),
                                spot_price=0.04 * (i + 1)) for i in range(9)]
    prov = Provisioner(name="default")
    prov.set_defaults()
    rng = np.random.default_rng(3)
    cpu_i = wk.RESOURCE_INDEX[wk.RESOURCE_CPU]
    mem_i = wk.RESOURCE_INDEX[wk.RESOURCE_MEMORY]
    single = lambda name: make_pod(name, cpu="250m", memory="512Mi",
                                   anti_affinity_hostname=True)
    existing = []
    for i in range(10):
        t = types[2 + i % 5]
        alloc = list(t.allocatable_vector())
        used = [0] * wk.NUM_RESOURCES
        used[cpu_i] = int(alloc[cpu_i] * rng.uniform(0.2, 0.7))
        used[mem_i] = int(alloc[mem_i] * rng.uniform(0.2, 0.7))
        labels = t.labels_dict()
        labels[wk.LABEL_ZONE] = ("zone-1a", "zone-1b", "zone-1c")[i % 3]
        labels[wk.LABEL_CAPACITY_TYPE] = "on-demand"
        existing.append(ExistingNode(
            name=f"e{i}", labels=labels, allocatable=alloc, used=used,
            resident=(single(f"res-{i}"),) if i % 3 == 0 else ()))
    spread = (TopologySpreadConstraint(max_skew=1,
                                       topology_key=wk.LABEL_ZONE),)
    # the hostname anti-affinity pods open a node each, over both halves
    # of the slots, and the small batch pods then fill those open claims
    # first-fit across every rank's slots
    pods = ([make_pod(f"web-{i}", cpu="500m", memory="1Gi", topology=spread)
             for i in range(40)]
            + [make_pod(f"db-{i}", cpu="2", memory="6Gi",
                        node_selector={wk.LABEL_ZONE: "zone-1b"})
               for i in range(9)]
            + [make_pod(f"one-{i}", cpu="1500m", memory="3Gi",
                        anti_affinity_hostname=True) for i in range(30)]
            + [make_pod(f"batch-{i}", cpu="250m", memory="256Mi")
               for i in range(400)])
    enc = encode_problem(Catalog(types=types), [prov], pods, existing)
    inputs, _, _ = build_pack_inputs(enc)
    assert inputs.res_sel is not None and inputs.ex_cap is not None
    # 24 slots, not the bucket's 128: the 23 nodes it opens then reach
    # every node slice of every mesh here
    return inputs, 24


def consolidation_batch():
    """tests/test_sharded.py's 13-node consolidation cluster (not a rank
    multiple, so the no-op lane padding runs)."""
    from karpenter_tpu.apis import wellknown as wk
    from karpenter_tpu.apis.provisioner import Provisioner
    from karpenter_tpu.models.cluster import ClusterState, StateNode
    from karpenter_tpu.models.instancetype import Catalog, make_instance_type
    from karpenter_tpu.models.pod import make_pod
    from karpenter_tpu.ops.consolidate import encode_consolidation

    big = make_instance_type("m.2xl", cpu=8, memory="32Gi",
                             od_price=0.40, spot_price=0.15)
    small = make_instance_type("m.s", cpu=2, memory="8Gi",
                               od_price=0.09, spot_price=0.04)
    cluster = ClusterState()
    for i in range(13):
        cluster.add_node(StateNode(
            name=f"n-{i:02d}",
            labels={**big.labels_dict(), wk.LABEL_ZONE: f"zone-1{'ab'[i % 2]}",
                    wk.LABEL_CAPACITY_TYPE: "on-demand",
                    wk.LABEL_PROVISIONER: "default"},
            allocatable=big.allocatable_vector(),
            instance_type=big.name, zone=f"zone-1{'ab'[i % 2]}",
            capacity_type="on-demand", price=big.offerings[0].price,
            provisioner_name="default",
            pods=[make_pod(f"p-{i}-{j}", cpu="500m", memory="1Gi",
                           node_name=f"n-{i:02d}") for j in range(i % 3)]))
    prov = Provisioner(name="default", consolidation_enabled=True)
    prov.set_defaults()
    return encode_consolidation(cluster, Catalog(types=[big, small]), [prov])


def host_fields(inputs) -> dict:
    return {k: None if v is None else np.asarray(v)
            for k, v in inputs._asdict().items()}


def jax_results(inputs, n_slots: int, n_devices: int):
    """JAX's pack and JAX's sharded_pack on n_devices virtual devices."""
    base = jax.device_get(jax_pack(jax.device_put(inputs), n_slots=n_slots))
    sh = jax_sharded.sharded_pack(inputs, n_slots,
                                  jax_sharded.make_mesh(n_devices))
    return ({f: np.asarray(getattr(base, f)) for f in FIELDS},
            {f: np.asarray(getattr(sh, f)) for f in FIELDS})


PROBLEMS = {"basic": lambda: pad_inputs(build_inputs()),
            "odd_types": odd_type_inputs, "rich": rich_inputs}
# the cases each rank count runs: (job name, problem, hybrid host size)
PACKS = {2: [("basic", "basic", None), ("rich", "rich", None)],
         4: [("basic", "basic", None), ("odd_types", "odd_types", None),
             ("rich", "rich", None)],
         8: [("basic", "basic", None), ("rich", "rich", None),
             ("hybrid", "graft", 4), ("one_host", "basic", 8)]}


def graft_inputs():
    """The problem tests/test_multiprocess.py packs on JAX's 2-process
    hybrid mesh (__graft_entry__._example_problem, 32 pods, 8 types)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "graft_entry", REPO / "__graft_entry__.py")
    ge = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ge)
    return ge._pad_inputs(ge._example_problem(n_pods=32, n_types=8))


PROBLEMS["graft"] = graft_inputs


def run_group(world: int, tmp: Path, jobs: list, timeout: float = 120.0):
    """Spawn `world` worker ranks on one FileStore in `tmp`, running
    `jobs`; wait for each, and fail with its output if one fails."""
    spec = tmp / "spec.json"
    spec.write_text(json.dumps({"world": world, "store": str(tmp / "store"),
                                "jobs": jobs}))
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("XLA_", "JAX_", "PALLAS_"))}
    env.update(OMP_NUM_THREADS="1", PYTHONPATH=str(REPO))
    procs = [subprocess.Popen([sys.executable, str(WORKER), str(spec),
                               str(r)], cwd=REPO, env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"RANK_OK {r}" in out, \
            f"rank {r} of {world} failed:\n{out[-3000:]}"


_GROUPS: dict = {}


def mesh_group(world: int, tmp_path_factory):
    """One process group of `world` ranks, every case of that count run in
    it (once per module): -> (world, {job: every rank's output}, the host
    inputs by problem, the consolidation batch)."""
    if world in _GROUPS:
        return _GROUPS[world]
    tmp = tmp_path_factory.mktemp(f"mesh{world}")
    problems, jobs = {}, []
    for name, problem, host in PACKS[world]:
        if problem not in problems:
            problems[problem] = PROBLEMS[problem]()
            inputs, n_slots = problems[problem]
            (tmp / f"{problem}.pkl").write_bytes(pickle.dumps(
                (host_fields(inputs), n_slots)))
        job = {"kind": "pack", "inputs": str(tmp / f"{problem}.pkl"),
               "out": str(tmp / name)}
        if host is not None:
            job.update(hybrid=True, local_world_size=host)
        jobs.append(job)
    batch = consolidation_batch()
    (tmp / "lanes.pkl").write_bytes(pickle.dumps((
        host_fields(batch.inputs), 2, batch.feas_table, batch.feas_idx)))
    jobs.append({"kind": "lanes", "inputs": str(tmp / "lanes.pkl"),
                 "out": str(tmp / "lanes")})
    if world == 4:
        jobs.append({"kind": "context", "seed": 11, "pods": 60,
                     "out": str(tmp / "context")})
    run_group(world, tmp, jobs)
    outs = {}
    for name, _, _ in PACKS[world]:
        outs[name] = [pickle.loads((tmp / f"{name}.{r}").read_bytes())
                      for r in range(world)]
    outs["lanes"] = [pickle.loads((tmp / f"lanes.{r}").read_bytes())
                     for r in range(world)]
    if world == 4:
        outs["context"] = pickle.loads((tmp / "context").read_bytes())
    _GROUPS[world] = (world, outs, problems, batch)
    return _GROUPS[world]


@pytest.mark.parametrize("world", [2, 4, 8])
def test_every_rank_holds_the_same_result(world, tmp_path_factory):
    _, outs, _, _ = mesh_group(world, tmp_path_factory)
    for name, ranks in outs.items():
        if name == "context":
            continue
        for r in range(1, world):
            if name == "lanes":
                np.testing.assert_array_equal(ranks[r], ranks[0])
                continue
            for f in FIELDS:
                np.testing.assert_array_equal(
                    ranks[r]["result"][f], ranks[0]["result"][f],
                    err_msg=f"{name}: rank {r} differs on {f}")


@pytest.mark.parametrize("world", [2, 4, 8])
def test_mesh_shape_follows_jax(world, tmp_path_factory):
    _, outs, _, _ = mesh_group(world, tmp_path_factory)
    jmesh = jax_sharded.make_mesh(world)
    assert outs["basic"][0]["desc"]["axes"] == dict(zip(
        jmesh.axis_names, jmesh.devices.shape))
    assert outs["basic"][0]["desc"]["n_devices"] == world


@pytest.mark.parametrize("world,name", [
    (world, name) for world, cases in PACKS.items()
    for name, _, host in cases if host is None])
def test_sharded_pack_equals_jax_sharded_pack_and_pack(world, name,
                                                       tmp_path_factory):
    _, outs, problems, _ = mesh_group(world, tmp_path_factory)
    inputs, n_slots = problems[name]
    base, sh = jax_results(inputs, n_slots, world)
    got = outs[name][0]["result"]
    for f in FIELDS:
        np.testing.assert_array_equal(got[f], base[f],
                                      err_msg=f"{name} vs pack: {f}")
        np.testing.assert_array_equal(got[f], sh[f],
                                      err_msg=f"{name} vs sharded_pack: {f}")


def test_hybrid_mesh_and_its_description_follow_jax(tmp_path_factory):
    _, outs, problems, _ = mesh_group(8, tmp_path_factory)
    # tests/test_multiprocess.py's assertions on JAX's 2-process mesh
    desc = outs["hybrid"][0]["desc"]
    assert desc == {"axes": {"nodes": 4, "types": 2}, "n_devices": 8,
                    "n_processes": 2, "types_axis_crosses_hosts": False,
                    "nodes_axis_spans_processes": True}
    inputs, n_slots = problems["graft"]
    base, _ = jax_results(inputs, n_slots, 8)
    got = outs["hybrid"][0]["result"]
    for f in FIELDS:
        np.testing.assert_array_equal(got[f], base[f], err_msg=f)
    assert int(got["assign"].sum()) + int(got["ex_assign"].sum()) == 32
    assert int(got["unsched"].sum()) == 0
    # one host of 8 ranks: JAX's single-process description
    from karpenter_tpu.parallel.multihost import (make_hybrid_mesh,
                                                  mesh_description)

    assert outs["one_host"][0]["desc"] == mesh_description(make_hybrid_mesh())


@pytest.mark.parametrize("world", [2, 4, 8])
def test_lane_sharded_verdicts_equal_the_single_sweep(world,
                                                      tmp_path_factory):
    from karpenter_tpu.ops.consolidate import N_SLOTS, _batched_pack_verdicts

    _, outs, _, batch = mesh_group(world, tmp_path_factory)
    assert N_SLOTS == 2
    single = np.asarray(jax.device_get(_batched_pack_verdicts(
        jax.device_put(batch.inputs), N_SLOTS,
        feas_table=jax.device_put(batch.feas_table),
        feas_idx=jax.device_put(batch.feas_idx))))
    assert outs["lanes"][0].shape == single.shape
    np.testing.assert_array_equal(outs["lanes"][0], single)


def test_sharded_context_drives_the_solver_route(tmp_path_factory):
    _, outs, _, _ = mesh_group(4, tmp_path_factory)
    ctx = outs["context"]
    assert ctx["describe"] == "nodes=2xtypes=2"
    for flat, info in zip(ctx["flats"], ctx["infos"]):
        assert info["routing"] == "cpu-sharded"
        assert info["device_count"] == 4
        np.testing.assert_array_equal(flat, ctx["single"])
    assert [i["compile_cache"] for i in ctx["infos"]] == ["miss", "hit"]


def test_split_plain_fill_is_in_lockstep_with_the_fused_one(monkeypatch):
    """Through a whole pack on the CPU, every step's fill run as the mesh's
    split (rowmax, claim_fill, _waterfall, placed_used, apply) equals the
    fused plain fill on the same state."""
    from karpenter_tpu_torch.ops import open_claim, packer

    inputs, n_slots = rich_inputs()
    fields = host_fields(inputs)
    lanes = packer.as_lanes(packer.pack_inputs_from_numpy(fields, "cpu"))
    fused = open_claim.OpenClaimFill.__call__
    steps = []

    def both(self, vec, cap, feas, og, claim_placed, used, optmask, nprov,
             active, rem):
        split = open_claim.OpenClaimFill(self.alloc_t, self.prov_pods_cap,
                                         self.pods_i)
        used2, mask2 = used.clone(), optmask.clone()
        args = (vec, cap, feas, og, claim_placed, used2, mask2, nprov,
                active, rem)
        qmax = split.rowmax(*args)
        m2 = open_claim._waterfall(rem, open_claim.claim_fill(
            qmax, cap, og, claim_placed))
        used2.copy_(open_claim.placed_used(used2, vec, m2))
        split.apply(*args, m2)
        rem2 = rem - m2.sum(dim=-1, dtype=torch.int32)
        m, rem_out = fused(self, vec, cap, feas, og, claim_placed, used,
                           optmask, nprov, active, rem)
        assert torch.equal(m, m2) and torch.equal(rem_out, rem2)
        assert torch.equal(used, used2) and torch.equal(optmask, mask2)
        steps.append(int(m.sum()))
        return m, rem_out

    monkeypatch.setattr(open_claim.OpenClaimFill, "__call__", both)
    packer.pack_lanes(lanes, n_slots, packer.n_eff_of(fields["group_count"]))
    assert len(steps) == packer.n_eff_of(fields["group_count"]) > 3
    assert sum(steps) > 0  # some step placed pods on open claims


def test_a_process_group_without_a_card_raises_unless_the_cpu_is_asked(
        monkeypatch):
    """initialize_distributed resolves its device as every entry point
    does: configured for a group, with no card and no device named, it
    raises before it makes a group, and never quietly builds one on the
    CPU."""
    import torch.distributed as dist

    from karpenter_tpu_torch.parallel import multihost

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        multihost.initialize_distributed("file:///nonexistent/store", 2, 0)
    assert not dist.is_initialized()
