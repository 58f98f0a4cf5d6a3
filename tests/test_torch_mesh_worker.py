"""One rank of a torch.distributed process group for the port's mesh tests
(tests/test_torch_sharded.py, tests/test_torch_service.py).

    python tests/test_torch_mesh_worker.py SPEC.json RANK

SPEC names the group (`world`, and `store`: the FileStore file every rank
rendezvouses through, so concurrent test workers never race for a port)
and the `jobs` to run in order, each a dict with a `kind`:

* "pack": sharded_pack of the pickled (PackInputs fields, n_slots) at
  `inputs` over the (nodes, types) mesh, or the hybrid mesh with
  `local_world_size` ranks a host; writes {"result": PackResult fields,
  "desc": mesh_description} to `out`.RANK;
* "lanes": sharded_consolidation_verdicts of the pickled (inputs fields,
  n_slots, feas_table, feas_idx) at `inputs` over the lane mesh; writes
  the [C, 3] table to `out`.RANK;
* "context": rank 0 solves the seeded problem of `solve_problem` through a
  TorchSolver whose router sends every plan to the process's
  ShardedContext, and through a plain one, and writes both flat buffers,
  the routing and the device count to `out`; the other ranks follow;
* "follow": follow rank 0's ShardedContext until it closes (the rank 1 of
  a served mesh whose rank 0 is another process).

Runs on the CPU over gloo and imports nothing of the JAX package; it
asserts that at the end. Its own test runs it as a one-rank group.
"""

from __future__ import annotations

import json
import os
import pickle
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def solve_problem(seed: int, n_pods: int):
    """A small catalog, one provisioner and `n_pods` seeded pods (a third
    of them zone-spread) in the port's objects."""
    import numpy as np

    from karpenter_tpu_torch.apis import wellknown as wk
    from karpenter_tpu_torch.apis.provisioner import Provisioner
    from karpenter_tpu_torch.models.instancetype import (Catalog,
                                                         make_instance_type)
    from karpenter_tpu_torch.models.pod import (TopologySpreadConstraint,
                                                make_pod)

    catalog = Catalog(types=[
        make_instance_type(f"t.{i}x", cpu=2 * (i + 1),
                           memory=f"{8 * (i + 1)}Gi",
                           od_price=0.1 * (i + 1), spot_price=0.03 * (i + 1))
        for i in range(7)])
    prov = Provisioner(name="default")
    prov.set_defaults()
    rng = np.random.default_rng(seed)
    spread = (TopologySpreadConstraint(max_skew=1,
                                       topology_key=wk.LABEL_ZONE),)
    pods = []
    for i in range(n_pods):
        cpu = int(rng.choice([250, 500, 1000, 2000]))
        pods.append(make_pod(f"p{i}", cpu=f"{cpu}m", memory=f"{cpu * 2}Mi",
                             topology=spread if i % 3 == 0 else ()))
    return catalog, [prov], pods


def main(spec_path: str, rank: int) -> None:
    spec = json.loads(Path(spec_path).read_text())
    import torch

    torch.set_num_threads(1)
    from karpenter_tpu_torch.ops.packer import PackInputs
    from karpenter_tpu_torch.parallel import multihost, sharded

    multihost.initialize_distributed(f"file://{spec['store']}",
                                     spec["world"], rank, device="cpu")
    for job in spec["jobs"]:
        kind = job["kind"]
        os.environ["LOCAL_WORLD_SIZE"] = str(job.get("local_world_size",
                                                     spec["world"]))
        if kind == "pack":
            fields, n_slots = pickle.loads(Path(job["inputs"]).read_bytes())
            mesh = (multihost.make_hybrid_mesh() if job.get("hybrid")
                    else sharded.make_mesh())
            r = sharded.sharded_pack(PackInputs(**fields), n_slots, mesh,
                                     device="cpu")
            Path(f"{job['out']}.{rank}").write_bytes(pickle.dumps({
                "result": {k: v.numpy() for k, v in r._asdict().items()},
                "desc": multihost.mesh_description(mesh)}))
        elif kind == "lanes":
            fields, n_slots, table, idx = pickle.loads(
                Path(job["inputs"]).read_bytes())
            verdicts = sharded.sharded_consolidation_verdicts(
                PackInputs(**fields), n_slots, sharded.make_lane_mesh(),
                feas_table=table, feas_idx=idx, device="cpu")
            Path(f"{job['out']}.{rank}").write_bytes(pickle.dumps(verdicts))
        elif kind == "context":
            ctx = sharded.shared_context("cpu")
            if rank != 0:
                ctx.follow()
                continue
            from karpenter_tpu_torch.solver import buckets
            from karpenter_tpu_torch.solver.core import TorchSolver

            catalog, provs, pods = solve_problem(job["seed"], job["pods"])
            mesh_solver = TorchSolver(
                catalog, provs, device="cpu", mesh_ctx=ctx,
                router=buckets.ShapeRouter(n_devices=ctx.device_count,
                                           crossover_cells=0))
            flats, infos = [], []
            for _ in range(2):  # the second solve hits the resident catalog
                mesh_solver.solve(pods)
                flats.append(mesh_solver.last_flat)
                infos.append(dict(mesh_solver.last_solve_info))
            single = TorchSolver(catalog, provs, device="cpu")
            single.solve(pods)
            ctx.close()
            Path(job["out"]).write_bytes(pickle.dumps({
                "flats": flats, "single": single.last_flat,
                "infos": infos, "describe": ctx.describe()}))
        elif kind == "follow":
            sharded.shared_context("cpu").follow()
        else:
            raise ValueError(f"unknown job {kind!r}")
    # a group, or a subgroup the mesh caches, left up at exit can abort
    # the interpreter in gloo's threads
    multihost.shutdown_distributed()
    assert not any(m == "jax" or m.startswith(("jax.", "jaxlib",
                                               "karpenter_tpu."))
                   for m in sys.modules), "a rank imported JAX"
    print(f"RANK_OK {rank}", flush=True)


def test_a_one_rank_group_packs_as_the_single_device(tmp_path):
    """This script as a one-rank gloo group: its sharded_pack (a 1 x 1
    mesh, every collective over the world group) of a seeded problem in
    the compressed resource layout equals pack_lanes on the CPU in every
    PackResult field."""
    import subprocess

    import numpy as np

    from karpenter_tpu_torch.models.encode import encode_problem
    from karpenter_tpu_torch.ops import packer
    from karpenter_tpu_torch.solver.core import TorchSolver, build_pack_inputs

    catalog, provs, pods = solve_problem(seed=3, n_pods=40)
    solver = TorchSolver(catalog, provs, device="cpu")
    enc = encode_problem(catalog, provs, pods, grid=solver.grid())
    fields, plan = build_pack_inputs(enc)
    (tmp_path / "problem.pkl").write_bytes(pickle.dumps((fields, plan.slots)))
    spec = tmp_path / "spec.json"
    spec.write_text(json.dumps({"world": 1, "store": str(tmp_path / "store"),
                                "jobs": [{"kind": "pack",
                                          "inputs": str(tmp_path /
                                                        "problem.pkl"),
                                          "out": str(tmp_path / "out")}]}))
    proc = subprocess.run([sys.executable, __file__, str(spec), "0"],
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and "RANK_OK 0" in proc.stdout, \
        proc.stdout[-2000:] + proc.stderr[-2000:]
    got = pickle.loads((tmp_path / "out.0").read_bytes())
    assert got["desc"]["axes"] == {"nodes": 1, "types": 1}
    want = packer.pack_lanes(
        packer.as_lanes(packer.pack_inputs_from_numpy(fields, "cpu")),
        plan.slots, packer.n_eff_of(fields["group_count"]))
    assert fields["res_sel"] is not None
    for name, value in want._asdict().items():
        np.testing.assert_array_equal(got["result"][name], value[0].numpy(),
                                      err_msg=name)
    assert int(got["result"]["n_open"]) > 0


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]))
