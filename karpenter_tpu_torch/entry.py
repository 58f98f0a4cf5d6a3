"""Driver entry points of the port: the counterpart of the repo root's
__graft_entry__.py, which drives the JAX package.

- entry(device=None) -> (fn, args): the single-card pack (the FFD packer,
  the solver's hot loop) on a 64-pod, 16-type problem. On the card a step
  launches the fused open-claim fill twice.
- dryrun_multichip(n_devices, n_pods=50_000, device=None) -> dict: the
  full pack at BASELINE config 4 over an n-rank (nodes, types) mesh, with
  the JAX dry run's four checks. JAX runs one process over n virtual
  devices; the port runs one process per rank, joined over gloo. On the
  card the ranks share it (NCCL refuses two ranks on one GPU), so the run
  proves parity, not speed.

    python -m karpenter_tpu_torch.entry [n] [--device cpu]

runs entry() and then the dry run on n ranks (default 8), on the card
after a subprocess probe of it (utils/cudaenv.probe_card), or on the CPU
when asked. Where the JAX driver falls back to the CPU after a failed
probe, this one exits non-zero with the probe's note.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from .device import LAUNCHES, prepare_device, resolve_device
from .ops.packer import (PackInputs, PackResult, as_lanes, n_eff_of,
                         pack_inputs_from_numpy, pack_lanes)

#: how long a group of ranks (spawn_ranks) may run before all are killed
RANK_TIMEOUT_S = 300.0


def example_problem(n_pods: int = 64, n_types: int = 16):
    """entry()'s problem, encoded: `n_types` instance types and `n_pods`
    pods of two shapes under one default provisioner."""
    from .apis.provisioner import Provisioner
    from .models.encode import encode_problem
    from .models.instancetype import Catalog, make_instance_type
    from .models.pod import make_pod

    catalog = Catalog(types=[
        make_instance_type(f"m.{i}x", cpu=2 * (i + 1), memory=f"{8 * (i + 1)}Gi",
                           od_price=0.1 * (i + 1), spot_price=0.03 * (i + 1))
        for i in range(n_types)
    ])
    prov = Provisioner(name="default")
    prov.set_defaults()
    pods = [make_pod(f"a{i}", cpu="1", memory="2Gi") for i in range(n_pods // 2)] + [
        make_pod(f"b{i}", cpu="500m", memory="1Gi") for i in range(n_pods - n_pods // 2)]
    return encode_problem(catalog, [prov], pods)


def pad_inputs(enc) -> "tuple[PackInputs, int]":
    """An encoded problem's pack leaves (numpy), the group axis padded to
    its bucket, and the claim-slot bucket: -> (PackInputs, n_slots)."""
    from .solver.core import _bucket

    Gb = _bucket(enc.group_vec.shape[0])

    def pad(a, n, axis=0, fill=0):
        if a.shape[axis] == n:
            return a
        w = [(0, 0)] * a.ndim
        w[axis] = (0, n - a.shape[axis])
        return np.pad(a, w, constant_values=fill)

    inputs = PackInputs(
        alloc_t=enc.alloc_t, tiebreak=enc.tiebreak,
        group_vec=pad(enc.group_vec, Gb), group_count=pad(enc.group_count, Gb),
        group_cap=pad(enc.group_cap, Gb), group_feas=pad(enc.group_feas, Gb),
        group_newprov=pad(enc.group_newprov, Gb, fill=-1), overhead=enc.overhead,
        ex_alloc=enc.ex_alloc, ex_used=enc.ex_used, ex_feas=pad(enc.ex_feas, Gb),
    )
    return inputs, _bucket(enc.n_slots)


def _pack_one(pack_inputs: PackInputs, n_slots: int,
              n_eff: int) -> PackResult:
    """One problem's single-device pack (one lane): the PackResult on the
    inputs' device."""
    r = pack_lanes(as_lanes(pack_inputs), n_slots, n_eff)
    return PackResult(*(x[0] for x in r))


def entry(device=None):
    """(fn, args) for the single-card check: fn(pack_inputs) packs
    example_problem() at its slot bucket and returns the PackResult on the
    device. The card is the default (its kernels are built here); without
    one this raises unless device="cpu" is given."""
    dev = prepare_device(device)
    inputs, n_slots = pad_inputs(example_problem())
    n_eff = n_eff_of(inputs.group_count)

    def forward(pack_inputs: PackInputs) -> PackResult:
        return _pack_one(pack_inputs, n_slots, n_eff)

    return forward, (pack_inputs_from_numpy(inputs._asdict(), dev),)


def stress_problem(n_pods: int = 50_000):
    """BASELINE config 4 (the stress shape), as
    benchmarks/baseline_configs.py:194-223 (stress_problem_50k) builds it:
    the 603-type fleet catalog, 8 provisioners with overlapping
    capacity-type and arch requirements, and 25 deployments of
    n_pods // 25 pods. -> (catalog, provisioners, pods)."""
    from .apis import wellknown as wk
    from .apis.provisioner import Provisioner
    from .models.pod import make_pod
    from .models.requirements import OP_IN, Requirements
    from .providers.instancetypes import generate_fleet_catalog

    catalog = generate_fleet_catalog()
    provisioners = []
    for i, (ct, archs) in enumerate((
            (["on-demand"], ["amd64"]),
            (["spot", "on-demand"], ["amd64"]),
            (["spot"], ["amd64"]),
            (["on-demand"], ["arm64"]),
            (["spot", "on-demand"], ["arm64"]),
            (["spot", "on-demand"], ["amd64", "arm64"]),
            (["on-demand"], ["amd64", "arm64"]),
            (["spot"], ["amd64", "arm64"]))):
        p = Provisioner(name=f"prov-{i}", weight=i,
                        requirements=Requirements.of(
                            (wk.LABEL_CAPACITY_TYPE, OP_IN, ct),
                            (wk.LABEL_ARCH, OP_IN, archs)))
        p.set_defaults()
        provisioners.append(p)
    n_dep = 25
    per = n_pods // n_dep
    pods = [make_pod(f"d{d}-p{i}", cpu=f"{250 * (d % 4 + 1)}m",
                     memory=f"{512 * (d % 8 + 1)}Mi")
            for d in range(n_dep) for i in range(per)]
    return catalog, provisioners, pods


def _consolidation_cluster(catalog, provisioners, n_nodes: int):
    """The dry run's consolidation cluster: `n_nodes` on-demand nodes of
    catalog.types[0] in zone-1a under the first provisioner, one 250m/512Mi
    pod each."""
    from .apis import wellknown as wk
    from .models.cluster import ClusterState, StateNode
    from .models.pod import make_pod

    big, prov = catalog.types[0], provisioners[0].name
    cluster = ClusterState()
    for i in range(n_nodes):
        cluster.add_node(StateNode(
            name=f"cn-{i:03d}",
            labels={**big.labels_dict(), wk.LABEL_ZONE: "zone-1a",
                    wk.LABEL_CAPACITY_TYPE: "on-demand",
                    wk.LABEL_PROVISIONER: prov},
            allocatable=big.allocatable_vector(),
            instance_type=big.name, zone="zone-1a",
            capacity_type="on-demand", price=big.offerings[0].price,
            provisioner_name=prov,
            pods=[make_pod(f"cp-{i}", cpu="250m", memory="512Mi",
                           node_name=f"cn-{i:03d}")]))
    return cluster


# -- the dry run ------------------------------------------------------------------


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"dryrun_multichip: {msg}")


def _action_key(a):
    return None if a is None else (a.kind, a.nodes, a.replacement)


def _rank_main(spec_path: str, rank: int) -> int:
    """One rank of the dry run. Every rank builds and encodes config 4,
    packs it over the (nodes, types) mesh and sweeps the consolidation
    cluster over the lane mesh, each counted from 0; rank 0 then leaves the
    group and runs the four checks against the single-device pack, the
    native scan, the oracle and the one-shot sweep. Writes this rank's
    results to the spec's `out`.RANK."""
    from .models.encode import encode_problem
    from .ops.consolidate import run_consolidation
    from .parallel import multihost, sharded

    spec = json.loads(Path(spec_path).read_text())
    world, dev = spec["world"], resolve_device(spec["device"])
    os.environ.update(LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    catalog, provisioners, pods = stress_problem(spec["n_pods"])
    enc = encode_problem(catalog, provisioners, pods, grid=None)
    inputs, n_slots = pad_inputs(enc)
    cluster = _consolidation_cluster(catalog, provisioners, 4 * world + 1)
    multihost.initialize_distributed(f"file://{spec['store']}", world, rank,
                                     device=dev.type)
    try:
        mesh = sharded.make_mesh(world)
        LAUNCHES.reset()
        sharded.COLLECTIVES.reset()
        t0 = time.perf_counter()
        result = sharded.sharded_pack(inputs, n_slots, mesh, device=dev)
        host = PackResult(*(x.cpu().numpy() for x in result))
        wall_ms = (time.perf_counter() - t0) * 1e3
        pack = {"launches": LAUNCHES.take(),
                "collectives": sharded.COLLECTIVES.take()}
        t0 = time.perf_counter()
        a_mesh = run_consolidation(cluster, catalog, provisioners,
                                   mesh=sharded.make_lane_mesh(world),
                                   multi_node=False, device=dev)
        lanes_ms = (time.perf_counter() - t0) * 1e3
        lanes = {"launches": LAUNCHES.take(),
                 "collectives": sharded.COLLECTIVES.take()}
        axes = dict(mesh.shape)
    finally:
        multihost.shutdown_distributed()
    out = {"rank": rank, "pack": pack, "lanes": lanes}
    if rank == 0:
        out.update(_checks(enc, catalog, provisioners, pods, cluster,
                           inputs, n_slots, host, a_mesh, dev),
                   axes=axes, wall_ms=wall_ms, lanes_wall_ms=lanes_ms)
    Path(f"{spec['out']}.{rank}").write_bytes(pickle.dumps(out))
    return 0


def _checks(enc, catalog, provisioners, pods, cluster, inputs,
            n_slots, host, a_mesh, dev) -> dict:
    """Rank 0's four checks of the mesh's results (__graft_entry__.py
    :112-184): -> the numbers the dry run reports."""
    from .ops.consolidate import run_consolidation
    from .oracle.scheduler import Scheduler
    from .solver.core import NativeSolver, TorchSolver, decode

    placed = int(host.assign.sum()) + int(host.ex_assign.sum())
    unsched = int(host.unsched.sum())
    total = int(enc.group_count.sum())
    _check(placed + unsched == total, f"{placed} placed + {unsched} "
                                      f"unschedulable != {total} pods")
    ms = {}
    # 1) bit parity with the single-device pack of the same padded problem
    t0 = time.perf_counter()
    single = _pack_one(pack_inputs_from_numpy(inputs._asdict(), dev),
                       n_slots, n_eff_of(inputs.group_count))
    for field in PackResult._fields:
        a, b = getattr(host, field), getattr(single, field).cpu().numpy()
        _check(a.shape == b.shape and bool((a == b).all()),
               f"mesh/single divergence in {field}")
    ms["single"] = (time.perf_counter() - t0) * 1e3
    # 2) decision parity at full size with the C++ native scan
    t0 = time.perf_counter()
    decisions = decode(enc, host, []).decisions()
    native = NativeSolver(catalog, provisioners).solve(pods).decisions()
    _check(decisions == native, f"native divergence: {len(decisions)} vs "
                                f"{len(native)}")
    ms["native"] = (time.perf_counter() - t0) * 1e3
    # 3) decision parity with the scalar oracle on a subsample (pods with
    # index < 80 in their deployment: 2k at 50k pods)
    sub = [p for p in pods if int(p.name.split("-p")[1]) < 80]
    t0 = time.perf_counter()
    sub_decisions = TorchSolver(catalog, provisioners,
                                device=dev).solve(sub).decisions()
    ms["solve_sub"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    oracle = Scheduler(catalog, provisioners)
    oracle_decisions = oracle.schedule(sub).node_decisions(oracle.options)
    ms["oracle"] = (time.perf_counter() - t0) * 1e3
    _check(sub_decisions == oracle_decisions,
           f"oracle divergence at {len(sub)}: {len(sub_decisions)} vs "
           f"{len(oracle_decisions)}")
    # 4) the lane mesh's consolidation action equals the one-shot sweep's
    a_single = run_consolidation(cluster, catalog, provisioners,
                                 multi_node=False, device=dev)
    _check(_action_key(a_mesh) == _action_key(a_single),
           f"lane-mesh action {_action_key(a_mesh)} != one-shot "
           f"{_action_key(a_single)}")
    return {"pods_total": total, "placed": placed, "unsched": unsched,
            "types": len(catalog.types), "provisioners": len(provisioners),
            "nodes": int(host.active.sum()),
            "result_arrays": len(PackResult._fields),
            "native_decisions": len(decisions), "oracle_pods": len(sub),
            "oracle_decisions": len(sub_decisions),
            "candidates": len(cluster.nodes),
            "action": a_mesh.kind if a_mesh else "no-action",
            "check_ms": ms,
            "result": {f: getattr(host, f) for f in PackResult._fields}}


_RANK_CODE = ("import sys\n"
              "from karpenter_tpu_torch.entry import _rank_main\n"
              "sys.exit(_rank_main(sys.argv[1], int(sys.argv[2])))\n")


def spawn_ranks(rank_argv, world: int, log_path,
                timeout_s: float = RANK_TIMEOUT_S) -> None:
    """Start `world` processes, rank r running the command rank_argv(r)
    from the repo's root with its output in the file log_path(r), and wait
    for all. On any rank's failure, or at timeout_s for the group, kill
    every rank and raise RuntimeError with that rank's exit code and the
    tail of its log."""
    root = str(Path(__file__).resolve().parent.parent)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (root, os.environ.get("PYTHONPATH")) if p))
    logs = [open(log_path(r), "w") for r in range(world)]
    procs = [subprocess.Popen(rank_argv(r), cwd=root, env=env,
                              stdout=logs[r], stderr=subprocess.STDOUT)
             for r in range(world)]
    failed = None
    try:
        deadline = time.monotonic() + timeout_s
        while failed is None and any(p.poll() is None for p in procs):
            failed = next((r for r, p in enumerate(procs)
                           if p.poll() not in (None, 0)), None)
            if failed is None and time.monotonic() > deadline:
                failed = next(r for r, p in enumerate(procs)
                              if p.poll() is None)
            time.sleep(0.1)
        if failed is None:
            failed = next((r for r, p in enumerate(procs)
                           if p.returncode != 0), None)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for log in logs:
            log.close()
    if failed is not None:
        tail = Path(log_path(failed)).read_text()[-3000:]
        raise RuntimeError(f"rank {failed} of {world} exited "
                           f"{procs[failed].returncode}:\n{tail}")


def dryrun_multichip(n_devices: int, n_pods: int = 50_000,
                     device=None) -> dict:
    """The full pack at BASELINE config 4 (stress_problem(n_pods), 603
    types, 8 provisioners) over an n_devices-rank mesh, with the JAX dry
    run's checks, on rank 0:

    1. bit parity: every PackResult field of the mesh pack equals the
       single-device pack's;
    2. decision parity at full size with the C++ native scan;
    3. decision parity with the scalar oracle on the pods with index < 80
       in their deployment;
    4. the lane mesh's consolidation action over 4n+1 candidates (the lane
       pad path) equals the one-shot sweep's.

    Each rank is a process of a gloo group; on the card they share it. The
    kernels are built here, before any rank starts. Every rank's launch
    counts must be equal. Prints the JAX dry run's summary line and returns
    its numbers, rank 0's walls and checks' times, each rank's counts and
    the mesh's PackResult (numpy) under "result"."""
    if n_devices < 1:
        raise ValueError(f"n_devices must be >= 1, got {n_devices}")
    dev = prepare_device(device)
    with tempfile.TemporaryDirectory(prefix="karpenter-dryrun-") as td:
        tmp = Path(td)
        spec = tmp / "spec.json"
        spec.write_text(json.dumps({
            "world": n_devices, "n_pods": n_pods, "device": dev.type,
            "store": str(tmp / "store"), "out": str(tmp / "out")}))
        t0 = time.perf_counter()
        try:
            spawn_ranks(lambda r: [sys.executable, "-c", _RANK_CODE,
                                   str(spec), str(r)], n_devices,
                        lambda r: tmp / f"rank{r}.log")
        except RuntimeError as e:
            raise RuntimeError(f"dryrun_multichip: {e}") from None
        group_s = time.perf_counter() - t0
        ranks = [pickle.loads((tmp / f"out.{r}").read_bytes())
                 for r in range(n_devices)]
    head = ranks[0]
    for r in ranks[1:]:
        _check(r["pack"]["launches"] == head["pack"]["launches"]
               and r["lanes"]["launches"] == head["lanes"]["launches"],
               f"rank {r['rank']} launched {r['pack']['launches']} "
               f"{r['lanes']['launches']}, rank 0 {head['pack']['launches']} "
               f"{head['lanes']['launches']}")
    out = {k: v for k, v in head.items() if k not in ("rank", "pack",
                                                       "lanes")}
    out.update(n_devices=n_devices, device=dev.type, group_s=group_s,
               launches_per_rank=[{"pack": r["pack"]["launches"],
                                   "lanes": r["lanes"]["launches"]}
                                  for r in ranks],
               collectives_rank0={"pack": head["pack"]["collectives"],
                                  "lanes": head["lanes"]["collectives"]})
    print(f"dryrun_multichip OK: {n_devices} devices, mesh {out['axes']}, "
          f"STRESS shape {out['pods_total']} pods x {out['types']} types x "
          f"{out['provisioners']} provisioners -> "
          f"{out['placed']}/{out['pods_total']} pods on {out['nodes']} nodes; "
          f"bit-parity with single-device solve across all "
          f"{out['result_arrays']} result arrays; decision parity with the "
          f"C++ native scan at {n_pods // 1000}k ({out['native_decisions']} "
          f"node decisions) and with the scalar oracle at "
          f"{out['oracle_pods'] / 1000:g}k ({out['oracle_decisions']} "
          f"decisions); consolidation lane-mesh parity over "
          f"{out['candidates']} candidates ({out['action']})", flush=True)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m karpenter_tpu_torch.entry",
        description="entry()'s single-card pack, then the config-4 dry run "
                    "over n ranks")
    p.add_argument("n", nargs="?", type=int, default=8,
                   help="ranks of the dry run's mesh (default 8)")
    p.add_argument("--device", choices=("cuda", "cpu"), default=None,
                   help="the card (default) or the CPU")
    args = p.parse_args(argv)
    if args.device != "cpu":
        from .utils.cudaenv import probe_card

        ok, note = probe_card()
        if not ok:
            print(f"entry: no usable CUDA card ({note}); pass --device cpu "
                  f"to run on the CPU", file=sys.stderr)
            return 1
    fn, fargs = entry(args.device)
    out = fn(*fargs)
    print(f"entry OK on {out.assign.device.type}:", int(out.assign.sum()),
          flush=True)
    dryrun_multichip(args.n, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
