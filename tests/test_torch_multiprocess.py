"""`solver-serve --distributed`: the port's multi-process solver service, on
the CPU.

Two processes of `python -m karpenter_tpu_torch solver-serve --distributed
--device cpu`, started as torchrun starts its ranks (WORLD_SIZE, RANK,
LOCAL_RANK and LOCAL_WORLD_SIZE in the environment), join one gloo process
group through a FileStore in tmp_path (`--coordinator file://...`, so
concurrent test workers never race for a port). Rank 0 prints JAX's
`distributed: {mesh_description}` line and serves gRPC; rank 1 follows its
mesh. A RemoteSolver's Solve, with the shape router's crossover at 0, is
routed "cpu-sharded" over 2 devices and decodes to the decisions of the
single-process solve of both packages; Consolidate over the lane mesh (64
nodes, CONSOLIDATE_LANE_MESH_MIN) picks the in-process action. Solves and
a Consolidate sent at once from threads each equal their single-card
answers: the ranks' collectives never interleave. SIGINT stops rank 0,
which stops rank 1, and both exit 0.
"""

from __future__ import annotations

import ast
import os
import queue
import signal
import socket
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import pytest

from tests.test_torch_controllers import JAX, PORT
from tests.test_torch_service import catalog, pods, provisioner

REPO = Path(__file__).resolve().parent.parent


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _lines(proc: subprocess.Popen) -> "queue.Queue[str]":
    """The process's output lines, read on a thread."""
    q: "queue.Queue[str]" = queue.Queue()

    def pump():
        for line in proc.stdout:
            q.put(line)
        q.put("")

    threading.Thread(target=pump, daemon=True).start()
    return q


def _wait_for(q: "queue.Queue[str]", prefix: str, seen: list,
              timeout: float = 90.0) -> str:
    deadline = time.monotonic() + timeout
    while True:
        line = q.get(timeout=max(0.1, deadline - time.monotonic()))
        seen.append(line)
        assert line, f"exited before printing {prefix!r}:\n{''.join(seen)}"
        if line.startswith(prefix):
            return line


def _cluster(pkg: str, n_nodes: int = 64):
    """n_nodes m.xlarge nodes with one small pod each (consolidatable)."""
    import importlib

    m = lambda name: importlib.import_module(f"{pkg}.{name}")
    wk, cl, pod = m("apis.wellknown"), m("models.cluster"), m("models.pod")
    it = catalog(pkg).types[1]
    cluster = cl.ClusterState()
    for i in range(n_nodes):
        cluster.add_node(cl.StateNode(
            name=f"n-{i:03d}",
            labels={**it.labels_dict(), wk.LABEL_ZONE: "zone-1a",
                    wk.LABEL_CAPACITY_TYPE: "on-demand",
                    wk.LABEL_PROVISIONER: "default"},
            allocatable=it.allocatable_vector(), instance_type=it.name,
            zone="zone-1a", capacity_type="on-demand",
            price=it.offerings[0].price, provisioner_name="default",
            pods=[pod.make_pod(f"p-{i}", cpu="500m", memory="1Gi",
                               node_name=f"n-{i:03d}")]))
    return cluster


@pytest.fixture(scope="module")
def served_pair(tmp_path_factory):
    """Two `solver-serve --distributed --device cpu` ranks on one FileStore:
    -> (rank 0's gRPC port, its `distributed: ` line). SIGINT stops rank 0
    after the module's cases, which stops rank 1; both must exit 0."""
    tmp = tmp_path_factory.mktemp("served_pair")
    port = _free_port()
    base = {k: v for k, v in os.environ.items()
            if not k.startswith(("XLA_", "JAX_", "PALLAS_"))}
    base.update(WORLD_SIZE="2", LOCAL_WORLD_SIZE="2", OMP_NUM_THREADS="1",
                KARPENTER_TPU_SHARD_CROSSOVER_CELLS="0")
    procs = [subprocess.Popen(
        [sys.executable, "-m", PORT, "solver-serve", "--distributed",
         "--device", "cpu", "--port", str(port), "--coordinator",
         f"file://{tmp / 'store'}"],
        cwd=REPO, env=dict(base, RANK=str(r), LOCAL_RANK=str(r)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    outs = [[], []]
    q0 = _lines(procs[0])
    try:
        desc = _wait_for(q0, "distributed: ", outs[0])
        _wait_for(q0, "solver service listening on", outs[0])
        yield port, desc
    finally:
        if procs[0].poll() is None:
            procs[0].send_signal(signal.SIGINT)
        for r, p in enumerate(procs):
            try:
                p.wait(timeout=60)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        while True:  # rank 0's output, read by its pump thread
            line = q0.get(timeout=10)
            outs[0].append(line)
            if not line:
                break
        outs[1].append(procs[1].stdout.read())
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r}:\n{''.join(outs[r])[-3000:]}"


def _synced_client(port: int, timeout: float = 120.0):
    """A port RemoteSolver on the served pair, its catalog synced: ->
    (client, catalog, provisioners)."""
    from karpenter_tpu_torch.solver import solver_pb2 as pb
    from karpenter_tpu_torch.solver import wire
    from karpenter_tpu_torch.solver.client import RemoteSolver

    cat = catalog(PORT)
    provs = [provisioner(PORT, consolidation_enabled=True)]
    client = RemoteSolver(cat, provs, target=f"127.0.0.1:{port}",
                          timeout=timeout)
    sync = client._call("Sync", pb.SyncRequest(
        catalog=wire.catalog_to_wire(cat),
        provisioners=[wire.provisioner_to_wire(p) for p in provs]))
    return client, cat, provs, sync


def _solve(client, cat, want_pods):
    """A raw Solve RPC of `want_pods`: -> (response, its decisions)."""
    from karpenter_tpu_torch.solver import solver_pb2 as pb
    from karpenter_tpu_torch.solver import wire

    resp = client._call("Solve", pb.SolveRequest(
        catalog_seqnum=cat.seqnum,
        catalog_hash=client.catalog_content_hash(),
        provisioner_hash=client._prov_hash,
        pods=[wire.pod_to_wire(p) for p in want_pods]))
    return resp, client._decode(resp, want_pods).decisions()


def test_solver_serve_distributed_serves_a_sharded_solve(served_pair):
    from karpenter_tpu.solver.core import TPUSolver
    from karpenter_tpu_torch.ops.consolidate import run_consolidation
    from karpenter_tpu_torch.solver.core import TorchSolver

    port, desc = served_pair
    assert ast.literal_eval(desc[len("distributed: "):]) == {
        "axes": {"nodes": 1, "types": 2}, "n_devices": 2,
        "n_processes": 1, "types_axis_crosses_hosts": False,
        "nodes_axis_spans_processes": True}
    client, cat, provs, sync = _synced_client(port)
    assert sync.device_count == 2 and sync.mesh == "nodes=1xtypes=2"
    want_pods = pods(PORT, seed=5, n=48)
    resp, got = _solve(client, cat, want_pods)
    assert resp.routing == "cpu-sharded" and resp.device_count == 2
    assert got == TorchSolver(cat, provs, device="cpu").solve(
        want_pods).decisions()
    assert got == TPUSolver(catalog(JAX), [provisioner(
        JAX, consolidation_enabled=True)]).solve(
        pods(JAX, seed=5, n=48)).decisions()

    cluster = _cluster(PORT)
    action = client.consolidate(cluster, set(cluster.nodes))
    local = run_consolidation(cluster, cat, provs, device="cpu")
    assert local is not None and action is not None
    assert (action.kind, action.nodes, action.replacement) == (
        local.kind, local.nodes, local.replacement)


def test_concurrent_rpcs_take_turns_on_the_mesh(served_pair):
    """Six Solves of three seeded pod sets and a Consolidate over the lane
    mesh, sent at once from threads of their own, so the server's four
    workers run them together: rank 0 holds the mesh lock across each
    announce-and-pack sequence, so the follower matches every collective,
    and each answer equals its single-card one."""
    from karpenter_tpu_torch.ops.consolidate import run_consolidation
    from karpenter_tpu_torch.solver.core import TorchSolver

    port, _ = served_pair
    _, cat, provs, _ = _synced_client(port)
    pod_sets = [pods(PORT, seed=s, n=36 + 6 * s) for s in (7, 8, 9)]
    single = TorchSolver(cat, provs, device="cpu")
    wants = [single.solve(ps).decisions() for ps in pod_sets]
    cluster = _cluster(PORT)
    local = run_consolidation(cluster, cat, provs, device="cpu")
    barrier = threading.Barrier(7)

    def solve(k):
        client, _, _, _ = _synced_client(port, timeout=60.0)
        barrier.wait()
        resp, got = _solve(client, cat, pod_sets[k % 3])
        return k, resp.routing, got

    def consolidate():
        client, _, _, _ = _synced_client(port, timeout=60.0)
        barrier.wait()
        return client.consolidate(cluster, set(cluster.nodes))

    with ThreadPoolExecutor(max_workers=7) as ex:
        solves = [ex.submit(solve, k) for k in range(6)]
        action = ex.submit(consolidate)
        for f in solves:
            k, routing, got = f.result(timeout=180)
            assert routing == "cpu-sharded"
            assert got == wants[k % 3], f"solve {k} differs"
        action = action.result(timeout=180)
    assert local is not None and action is not None
    assert (action.kind, action.nodes, action.replacement) == (
        local.kind, local.nodes, local.replacement)
