"""Multi-host scale-out: the process group and hybrid meshes for the solver.

Port of karpenter_tpu/parallel/multihost.py. The JAX package bootstraps
`jax.distributed` (one process per host, many devices each); the port
joins a torch.distributed process group with one process (rank) per
device, as `torchrun` launches them:

    torchrun --nproc-per-node=N python -m karpenter_tpu_torch \\
        solver-serve --distributed

torchrun's environment (MASTER_ADDR/MASTER_PORT, WORLD_SIZE, RANK,
LOCAL_RANK, LOCAL_WORLD_SIZE) takes the place of JAX_COORDINATOR_ADDRESS,
JAX_NUM_PROCESSES and JAX_PROCESS_ID. The backend is NCCL when each rank
has a card of its own and gloo on the CPU; ranks that share one card (more
ranks on a host than cards) use gloo too, because NCCL refuses two ranks
on one GPU ("Duplicate GPU detected"); gloo's all_reduce and broadcast
take CUDA tensors, the only collectives parallel/sharded.py uses.

Axis placement follows the scaling-book recipe applied to this workload:
- the NODES axis is data-parallel-like: per-slot state with one fill row
  per scan step — cheap, latency-tolerant collectives that can cross
  hosts;
- the TYPES axis is tensor-parallel-like: per-step max/min all-reduces
  over the option grid — so it stays within a host.

Single-host process groups (tests, one machine) use the plain mesh of
parallel/sharded.py — call sites never branch.
"""

from __future__ import annotations

import datetime
import logging
import os
from typing import Optional

import numpy as np
import torch

from ..device import resolve_device
from .sharded import AXIS_NODES, AXIS_TYPES, Mesh, make_mesh, world_size

log = logging.getLogger("karpenter.multihost")

#: how long a collective may wait for the other ranks: a follower waits in
#: a broadcast for rank 0's next solve, so this bounds how long the served
#: mesh may sit idle
TIMEOUT = datetime.timedelta(days=7)


def _env_int(name: str) -> "int | None":
    raw = os.environ.get(name)
    return int(raw) if raw not in (None, "") else None


def local_world_size() -> int:
    """Ranks per host: LOCAL_WORLD_SIZE as torchrun sets it, else the whole
    world (one host)."""
    return _env_int("LOCAL_WORLD_SIZE") or world_size()


def initialize_distributed(coordinator: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           device=None) -> bool:
    """torch.distributed bootstrap. Arguments default from torchrun's
    environment: `coordinator` from MASTER_ADDR:MASTER_PORT (or a
    "tcp://host:port" or "file:///path" init method), `num_processes` from
    WORLD_SIZE, `process_id` from RANK. On `device` "cuda" (the default;
    without a card it raises, as every entry point does) the rank's card is LOCAL_RANK modulo the
    card count, and the backend NCCL, or gloo when the host's ranks
    outnumber its cards; on "cpu" it is gloo. Returns True when running
    multi-process afterwards; safe to call when single-process (nothing
    configured: no process group is made) and when a group is already
    up."""
    import torch.distributed as dist

    if dist.is_initialized():
        return dist.get_world_size() > 1
    if coordinator is None and os.environ.get("MASTER_ADDR") \
            and os.environ.get("MASTER_PORT"):
        coordinator = (f"{os.environ['MASTER_ADDR']}:"
                       f"{os.environ['MASTER_PORT']}")
    if num_processes is None:
        num_processes = _env_int("WORLD_SIZE")
    if process_id is None:
        process_id = _env_int("RANK")
    if coordinator is None and num_processes is None:
        return False  # nothing configured: single-process mode
    if coordinator is None or num_processes is None or process_id is None:
        raise ValueError("a process group needs a coordinator, a process "
                         "count and this process's id (torchrun sets "
                         "MASTER_ADDR/MASTER_PORT, WORLD_SIZE and RANK)")
    dev = resolve_device(device)  # no card raises unless "cpu" is asked
    backend = "gloo"
    if dev.type == "cuda":
        cards = torch.cuda.device_count()
        if (_env_int("LOCAL_WORLD_SIZE") or num_processes) <= cards:
            backend = "nccl"
        torch.cuda.set_device((_env_int("LOCAL_RANK") or 0) % cards)
    init = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    dist.init_process_group(backend, init_method=init,
                            world_size=num_processes, rank=process_id,
                            timeout=TIMEOUT)
    log.info("process group up: rank %d of %d, %s on %s", process_id,
             num_processes, backend, dev)
    return num_processes > 1


def shutdown_distributed() -> None:
    """Tear this process's group down (no collective) and drop its mesh
    contexts: a gloo group left up at interpreter exit can abort it."""
    import torch.distributed as dist

    from .sharded import forget_contexts

    if dist.is_initialized():
        dist.destroy_process_group()
    forget_contexts()


def make_hybrid_mesh(types_dim: Optional[int] = None) -> Mesh:
    """(nodes, types) mesh whose nodes axis spans hosts and whose types
    axis stays inside each host: each host's ranks (LOCAL_WORLD_SIZE of
    them, contiguous as torchrun numbers them) form a block of rows, hosts
    outermost on the nodes axis, so the inter-host hops ride the
    latency-tolerant collectives. Single host: identical to
    parallel.sharded.make_mesh."""
    world = world_size()
    local = local_world_size()
    n_hosts = world // local
    if n_hosts <= 1:
        return make_mesh()
    if types_dim is None:
        types_dim = 2 if local % 2 == 0 and local >= 2 else 1
    nodes_local = local // types_dim
    rows = [np.arange(h * local, (h + 1) * local).reshape(nodes_local,
                                                          types_dim)
            for h in range(n_hosts)]
    ranks = np.concatenate(rows, axis=0)
    assert ranks.shape == (nodes_local * n_hosts, types_dim)
    return Mesh(ranks, (AXIS_NODES, AXIS_TYPES), host_size=local)


def mesh_description(mesh: Mesh) -> dict:
    """Telemetry-friendly summary (which axes cross hosts), in the JAX
    package's five keys: ranks stand for its devices, and hosts (ranks
    grouped by the mesh's host size) for its processes, one per host."""
    dev = np.asarray(mesh.devices)
    host = dev // mesh.host_size
    n_hosts = -(-world_size() // mesh.host_size)
    procs_by_row = [len(set(host[i].flat)) for i in range(dev.shape[0])] \
        if dev.ndim == 2 else []
    return {
        "axes": dict(zip(mesh.axis_names, dev.shape)),
        "n_devices": int(dev.size),
        "n_processes": n_hosts,
        "types_axis_crosses_hosts": any(p > 1 for p in procs_by_row),
        # the nodes axis SHOULD span every host (hosts outermost)
        "nodes_axis_spans_processes": len(set(host.flat)) == n_hosts,
    }
