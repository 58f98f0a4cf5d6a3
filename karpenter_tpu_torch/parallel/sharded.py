"""Multi-rank scale-out for the packer, on torch.distributed.

Port of karpenter_tpu/parallel/sharded.py. The JAX package runs one
process over many devices and lets GSPMD insert the collectives; PyTorch's
counterpart is one process per device (a rank), joined in a process group,
with every collective written out. Only two collectives are used,
`all_reduce` and `broadcast`, so the same code runs on NCCL (one card per
rank), on gloo over the CPU (the tests) and on gloo over CUDA tensors
(ranks that share one card, where NCCL refuses a second rank).

Mesh axes and their classic-parallelism analogues for this workload:
- "nodes": node-claim slots sharded like DATA parallelism — each rank owns
  a slice of the bin (node) population;
- "types": the instance-type axis sharded like TENSOR parallelism — the
  [N, T, S] option mask and the [N, T] capacity quotients are computed
  rank-local; the argmax-style reductions become all-reduces;
- the group scan stays sequential on every rank, as in the JAX package.

A rank (i, j) holds node slice i and type slice j, and runs the single
card's pack step (ops/packer._step, given the mesh). Per pack step:
  (i)   the open-claim row max over its types, then `all_reduce` MAX of
        qmax [L, N_local] over the types axis;
  (ii)  the first-fit waterfall over every slot: each rank writes its
        slots' fill into a zeroed [L, N] row and the nodes axis
        `all_reduce`s it by SUM, so every rank runs the single card's
        _waterfall on the whole row and takes its slots' m. (Summing only
        each rank's fill total would give the prefix, but not the pods
        placed, whose int32 sum wraps slot by slot; the whole row is one
        collective of N int32 and exact);
  (iii) the fresh-node kstar, `all_reduce` MAX [L] over the types axis;
  (iv)  step 1, the existing nodes, replicated: no collective.
At the end `decided` is the first minimum over the global (t, s) index:
`all_reduce` MIN of the int64 key tiebreak << 32 | global flat index
(tiebreak lies in [0, INT_BIG], so the key orders exactly as argmin's
first minimum on ties), and the node-sliced outputs are gathered by an
`all_reduce` SUM into zeroed full-size tensors over the nodes axis. So the
result equals the single-card pack bit for bit (tests/test_torch_sharded.py).

On CUDA, step (i) is launch 1 of csrc/open_claim.cu in its row-max mode
and the mask shrink is its launch 2 (ops/open_claim.OpenClaimFill.rowmax
and .apply); on the CPU, their plain halves.

ShardedContext is the serving path's process-lifetime context: rank 0
drives (the solver service calls dispatch_flat and, for consolidation,
sharded_consolidation_verdicts over its lane mesh); every other rank runs
`follow()`, which receives each dispatch by broadcast (the catalog once
per grid, then each solve's shape key and delta) and a stop message when
rank 0 closes the context. Each of rank 0's mesh operations (a dispatch
with its catalog, a sweep, the stop) is a sequence of broadcasts and
all_reduces that the followers match in order, so rank 0 holds the
process group's mesh lock across the whole sequence: concurrent RPCs of
the solver service take their turns on the mesh.
"""

from __future__ import annotations

import os
import pickle
import threading
from typing import Optional

import numpy as np
import torch

from ..device import LaunchCounts, resolve_device
from ..ops import packer as _packer
from ..ops.packer import (INT_BIG, PackInputs, PackResult, as_lanes,
                          flatten_result, lane_inputs_from_numpy, n_eff_of,
                          pack_lanes, pack_inputs_from_numpy, reduce_verdicts)

AXIS_NODES = _packer.AXIS_NODES  # the pack step reduces over these two
AXIS_TYPES = _packer.AXIS_TYPES
AXIS_LANES = "lanes"

_I32 = torch.int32

#: collectives issued by this process, by kind ("all_reduce", "broadcast")
COLLECTIVES = LaunchCounts()


def _dist():
    """torch.distributed when a process group is up, else None."""
    import torch.distributed as dist

    return dist if dist.is_available() and dist.is_initialized() else None


def world_size() -> int:
    """The process group's rank count; 1 without a process group."""
    dist = _dist()
    return dist.get_world_size() if dist is not None else 1


def _rank() -> int:
    dist = _dist()
    return dist.get_rank() if dist is not None else 0


def pad_types(inputs: PackInputs, multiple: int) -> PackInputs:
    """Pad the instance-type axis to a multiple of the mesh's type dimension
    with never-selectable entries: zero capacity, INT_BIG tiebreak, infeasible
    everywhere. Transparent to consumers — `decided` flat ids are t*S+s with S
    unchanged, so real types keep their ids."""
    T = inputs.alloc_t.shape[0]
    Tp = -(-T // multiple) * multiple
    if Tp == T:
        return inputs
    pad_n = Tp - T

    def pad(a, axis, value):
        a = np.asarray(a)
        w = [(0, 0)] * a.ndim
        w[axis] = (0, pad_n)
        return np.pad(a, w, constant_values=value)

    out = inputs._replace(
        alloc_t=pad(inputs.alloc_t, 0, 0),
        tiebreak=pad(inputs.tiebreak, 0, int(INT_BIG)),
        group_feas=pad(inputs.group_feas, 2, False),
    )
    if inputs.prov_pods_cap is not None:
        out = out._replace(prov_pods_cap=pad(inputs.prov_pods_cap, 1, 0))
    return out


def pad_types_catalog(alloc_t, tiebreak, multiple: int):
    """pad_types' catalog half, standalone: the serving path pads + uploads
    these ONCE per synced grid (never-selectable rows: zero capacity,
    INT_BIG tiebreak)."""
    T = alloc_t.shape[0]
    Tp = -(-T // multiple) * multiple
    if Tp == T:
        return np.asarray(alloc_t), np.asarray(tiebreak)
    pad_n = Tp - T
    alloc_t = np.pad(np.asarray(alloc_t), [(0, pad_n), (0, 0)],
                     constant_values=0)
    tiebreak = np.pad(np.asarray(tiebreak), [(0, pad_n), (0, 0)],
                      constant_values=int(INT_BIG))
    return alloc_t, tiebreak


def pad_types_delta(inputs: PackInputs, multiple: int) -> PackInputs:
    """pad_types' per-solve half: the type axis of the delta leaves
    (group_feas, prov_pods_cap) padded infeasible/zero to the mesh
    multiple. alloc_t/tiebreak are expected absent (resident)."""
    T = inputs.group_feas.shape[2]
    Tp = -(-T // multiple) * multiple
    if Tp == T:
        return inputs
    pad_n = Tp - T

    def pad(a, axis, value):
        a = np.asarray(a)
        w = [(0, 0)] * a.ndim
        w[axis] = (0, pad_n)
        return np.pad(a, w, constant_values=value)

    out = inputs._replace(group_feas=pad(inputs.group_feas, 2, False))
    if inputs.prov_pods_cap is not None:
        out = out._replace(prov_pods_cap=pad(inputs.prov_pods_cap, 1, 0))
    return out


# -- the mesh -------------------------------------------------------------------

# process groups by their ranks, made once per process group: creating a
# group is itself collective (every rank of the default group must make
# every group, in the same order), so a second mesh of the same layout
# reuses the groups instead of asking the other ranks to join again
_GROUPS: "dict[tuple, object]" = {}
_GROUPS_LOCK = threading.Lock()


def _groups(members: "list[list[int]]") -> list:
    """The process group of each rank list (the default group for the whole
    world), made in this order on first use; None entries without a
    process group (one rank, no collectives)."""
    dist = _dist()
    if dist is None:
        return [None] * len(members)
    world = dist.get_world_size()
    out = []
    with _GROUPS_LOCK:
        for ranks in members:
            key = (id(dist.group.WORLD), tuple(ranks))
            if key not in _GROUPS:
                _GROUPS[key] = (dist.group.WORLD
                                if sorted(ranks) == list(range(world))
                                else dist.new_group(ranks=list(ranks)))
            out.append(_GROUPS[key])
    return out


class Mesh:
    """A grid of process-group ranks with named axes: (nodes, types) for the
    pack, (lanes,) for the consolidation sweep. `devices` is the grid of
    ranks (the JAX Mesh's name for it), `shape` maps each axis to its size.
    For the calling rank, `coords` is its position and `group[axis]` the
    process group of the ranks that differ from it along that axis only.
    `host_size` is the ranks per host (LOCAL_WORLD_SIZE as torchrun sets
    it, else the whole group), which mesh_description uses to tell hosts
    apart. `driver`, set on rank 0 of
    a ShardedContext's lane mesh, announces each sweep to the followers."""

    def __init__(self, ranks, axis_names: "tuple[str, ...]",
                 host_size: "int | None" = None):
        self.devices = np.asarray(ranks, dtype=np.int64)
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, self.devices.shape))
        world = world_size()
        if sorted(self.devices.flat) != list(range(world)):
            raise ValueError(f"a mesh must hold every rank of the process "
                             f"group once: {self.devices.tolist()} for a "
                             f"world of {world}")
        self.rank = _rank()
        self.host_size = host_size or int(
            os.environ.get("LOCAL_WORLD_SIZE") or world)
        self.coords = tuple(int(c) for c in
                            np.argwhere(self.devices == self.rank)[0])
        self.group: dict = {}
        self.driver = None
        for ax, name in enumerate(self.axis_names):
            lines = np.moveaxis(self.devices, ax, -1).reshape(
                -1, self.devices.shape[ax])
            groups = _groups([list(map(int, line)) for line in lines])
            mine = next(k for k, line in enumerate(lines)
                        if self.rank in line)
            self.group[name] = groups[mine]

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def index(self, axis: str) -> int:
        return self.coords[self.axis_names.index(axis)]

    def node_bounds(self, n_slots: int) -> "tuple[int, int]":
        """Slot range [n0, n1) of this rank's node slice: the first
        n_slots % nodes slices hold one slot more (np.array_split's
        split)."""
        base, extra = divmod(n_slots, self.shape[AXIS_NODES])
        i = self.index(AXIS_NODES)
        n0 = i * base + min(i, extra)
        return n0, n0 + base + (1 if i < extra else 0)

    def all_reduce(self, t: torch.Tensor, op: str, axis: str) -> None:
        """In place: `t` reduced by op ("sum", "max", "min") over the ranks
        along `axis`. Without a process group the mesh has one rank and
        this is the identity."""
        group = self.group[axis]
        if group is None:
            return
        dist = _dist()
        dist.all_reduce(t, op={"sum": dist.ReduceOp.SUM,
                               "max": dist.ReduceOp.MAX,
                               "min": dist.ReduceOp.MIN}[op], group=group)
        COLLECTIVES.add("all_reduce")


def make_mesh(n_devices: Optional[int] = None, devices=None) -> Mesh:
    """The (nodes, types) mesh over the process group's ranks, with JAX's
    shape rule: types = 2 when the rank count is even, nodes = the rest.
    `n_devices` (or `devices`, a rank list) must name every rank: a mesh
    over part of the group would leave the other ranks out of its
    collectives."""
    ranks = (list(devices) if devices is not None
             else list(range(world_size())))
    if n_devices is not None:
        ranks = ranks[:n_devices]
    n = len(ranks)
    types_dim = 2 if n % 2 == 0 and n >= 2 else 1
    nodes_dim = n // types_dim
    return Mesh(np.array(ranks).reshape(nodes_dim, types_dim),
                (AXIS_NODES, AXIS_TYPES))


def make_lane_mesh(n_devices: Optional[int] = None, devices=None) -> Mesh:
    """1-D mesh for the consolidation sweep: candidate lanes are mutually
    independent simulations, so the batch shards like DATA parallelism —
    every rank owns C/n lanes and no collective crosses lanes at all, but
    the one that assembles the verdict table."""
    ranks = (list(devices) if devices is not None
             else list(range(world_size())))
    if n_devices is not None:
        ranks = ranks[:n_devices]
    return Mesh(np.array(ranks), (AXIS_LANES,))


# -- the pack on the mesh -------------------------------------------------------


def _type_slice(T: int, mesh: Mesh) -> "tuple[int, int]":
    """Global type range [t0, t1) of this rank's slice of T (type-padded)
    types."""
    Tl = T // mesh.shape[AXIS_TYPES]
    t0 = mesh.index(AXIS_TYPES) * Tl
    return t0, t0 + Tl


# the leaves with a type axis, and which axis it is
_TYPE_AXES = (("alloc_t", 0), ("tiebreak", 0), ("group_feas", 2),
              ("prov_pods_cap", 1))


def _local_fields(fields: dict, mesh: Mesh) -> dict:
    """This rank's type slice of the type-padded pack fields."""
    t0, t1 = _type_slice(fields["group_feas"].shape[2], mesh)
    out = dict(fields)
    for name, axis in _TYPE_AXES:
        v = fields.get(name)
        if v is not None:
            index = [slice(None)] * v.ndim
            index[axis] = slice(t0, t1)
            out[name] = v[tuple(index)]
    return out


def sharded_pack(inputs: PackInputs, n_slots: int, mesh: Mesh,
                 device=None) -> PackResult:
    """Run the packer SPMD over `mesh`: every rank calls it with the same
    host (numpy) inputs and gets the whole PackResult (tensors on `device`,
    default the CUDA card) back. Bit-identical to the single-card pack
    (tests/test_torch_sharded.py)."""
    device = resolve_device(device)
    inputs = pad_types(inputs, mesh.shape[AXIS_TYPES])
    fields = _local_fields(inputs._asdict(), mesh)
    local = as_lanes(pack_inputs_from_numpy(fields, device))
    r = pack_lanes(local, n_slots, n_eff_of(fields["group_count"]), mesh)
    return PackResult(*(x[0] for x in r))


# -- the serving path: one context per process, rank 0 drives ---------------------


class ShardedContext:
    """Process-lifetime device context for the serving path: ONE mesh (and
    its 1-D lane-mesh view for consolidation), plus the type-sharded
    resident catalog arrays per synced grid (each rank holds its own type
    slice). Rank 0 drives: TorchSolver calls dispatch_flat when its router
    picks the mesh, and the service's consolidation runs over lane_mesh.
    Every other rank calls follow(), which serves rank 0's dispatches until
    rank 0 calls close(). Building a context is collective (it makes the
    mesh's process groups), so every rank builds one, in the same order;
    shared_context() returns this process's one context."""

    RESIDENT_CAPACITY = 4  # matches SolverService.LRU_CAPACITY

    def __init__(self, n_devices: "Optional[int]" = None, device=None):
        self.device = resolve_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.mesh = make_mesh(n_devices)
        self.lane_mesh = make_lane_mesh(n_devices)
        # key -> (host alloc_t kept alive so its id is not reused, this
        # rank's device alloc_t slice, tiebreak slice); insertion = LRU.
        # One store per process group and device, shared by every context
        # of the process, so rank 0's contexts and each follower's hold the
        # same keys in the same order
        self._lock, self._resident = _resident_store(self.device)
        # held by rank 0 across each announce-and-run sequence
        self.mesh_lock = _mesh_lock()
        self._closed = False
        if self.driving and self.device_count > 1:
            self.lane_mesh.driver = self

    @property
    def device_count(self) -> int:
        return self.mesh.size

    @property
    def driving(self) -> bool:
        return self.mesh.rank == 0

    def describe(self) -> str:
        return (f"{AXIS_NODES}={self.mesh.shape[AXIS_NODES]}"
                f"x{AXIS_TYPES}={self.mesh.shape[AXIS_TYPES]}")

    # -- messages from rank 0 to the followers ---------------------------------

    def _send(self, msg: tuple) -> None:
        if self.device_count == 1:
            return
        dist = _dist()
        payload = np.frombuffer(pickle.dumps(msg), dtype=np.uint8)
        n = torch.tensor([payload.size], dtype=torch.int64, device=self.device)
        dist.broadcast(n, src=0)
        dist.broadcast(torch.from_numpy(payload.copy()).to(self.device),
                       src=0)
        COLLECTIVES.add("broadcast")
        COLLECTIVES.add("broadcast")

    def _recv(self) -> tuple:
        dist = _dist()
        n = torch.zeros((1,), dtype=torch.int64, device=self.device)
        dist.broadcast(n, src=0)
        buf = torch.empty((int(n.item()),), dtype=torch.uint8,
                          device=self.device)
        dist.broadcast(buf, src=0)
        COLLECTIVES.add("broadcast")
        COLLECTIVES.add("broadcast")
        return pickle.loads(buf.cpu().numpy().tobytes())

    # -- the resident catalog --------------------------------------------------

    def _install(self, key: int, host_ref, alloc_t, tiebreak) -> tuple:
        from ..solver.buckets import tracked_device_put

        t0, t1 = _type_slice(alloc_t.shape[0], self.mesh)
        cat = (host_ref,
               tracked_device_put(np.ascontiguousarray(alloc_t[t0:t1]),
                                  "catalog", self.device),
               tracked_device_put(np.ascontiguousarray(tiebreak[t0:t1]),
                                  "catalog", self.device))
        with self._lock:
            self._resident[key] = cat
            while len(self._resident) > self.RESIDENT_CAPACITY:
                self._resident.pop(next(iter(self._resident)))
        return cat

    def catalog_arrays(self, grid) -> "tuple":
        """This rank's type slice of the resident (alloc_t, tiebreak) for a
        grid, uploaded on first use (and sent to the followers) and served
        from residency after (the upload counters prove it: repeat Solves
        add zero catalog uploads)."""
        key = id(grid.alloc_t)
        with self.mesh_lock:
            with self._lock:
                hit = self._resident.get(key)
                if hit is not None and hit[0] is grid.alloc_t:
                    return hit[1:]
            alloc_t, tiebreak = pad_types_catalog(
                grid.alloc_t, grid.tiebreak, self.mesh.shape[AXIS_TYPES])
            self._send(("catalog", key, alloc_t, tiebreak))
            return self._install(key, grid.alloc_t, alloc_t, tiebreak)[1:]

    # -- dispatch ----------------------------------------------------------------

    def dispatch_flat(self, fields: dict, n_slots: int, grid) -> torch.Tensor:
        """Enqueue one solve on the mesh: `fields` are build_pack_inputs'
        (the catalog leaves are taken from `grid`'s residency, not from
        them); returns the flat int32 buffer on this rank's device, equal
        bit for bit to the single card's pack_flat. No host read happens
        here, but the collectives wait for the other ranks."""
        delta = {k: v for k, v in fields.items()
                 if k not in ("alloc_t", "tiebreak")}
        delta = pad_types_delta(
            PackInputs(alloc_t=None, tiebreak=None, **delta),
            self.mesh.shape[AXIS_TYPES])._asdict()
        n_eff = n_eff_of(delta["group_count"])
        with self.mesh_lock:
            cat = self.catalog_arrays(grid)
            self._send(("pack", id(grid.alloc_t), n_slots, n_eff, delta))
            return self._pack(cat, n_slots, n_eff, delta)

    def _pack(self, cat: tuple, n_slots: int, n_eff: int,
              delta: dict) -> torch.Tensor:
        from ..solver.buckets import tracked_tree_put

        local = tracked_tree_put(_local_fields(delta, self.mesh), "delta",
                                 self.device)
        local.update(alloc_t=cat[0], tiebreak=cat[1])
        inputs = as_lanes(pack_inputs_from_numpy(local, self.device))
        return flatten_result(pack_lanes(inputs, n_slots, n_eff,
                                         self.mesh))[0]

    def follow(self) -> None:
        """A follower's loop: serve rank 0's catalogs, solves and sweeps
        until it closes the context."""
        if self.driving:
            raise RuntimeError("rank 0 drives the mesh; follow() is for the "
                               "other ranks")
        while True:
            msg = self._recv()
            op = msg[0]
            if op == "stop":
                return
            if op == "catalog":
                _, key, alloc_t, tiebreak = msg
                self._install(key, None, alloc_t, tiebreak)
            elif op == "pack":
                _, key, n_slots, n_eff, delta = msg
                self._pack(self._resident[key][1:], n_slots, n_eff, delta)
            elif op == "lanes":
                _, inputs, n_slots, feas_table, feas_idx = msg
                sharded_consolidation_verdicts(
                    PackInputs(**inputs), n_slots, self.lane_mesh,
                    feas_table=feas_table, feas_idx=feas_idx,
                    device=self.device)
            else:
                raise RuntimeError(f"unknown mesh message {op!r}")

    def close(self) -> None:
        """Rank 0: stop the followers (once)."""
        with self.mesh_lock:
            if self.driving and not self._closed:
                self._closed = True
                self._send(("stop",))


_SHARED: "dict[tuple, ShardedContext]" = {}
_SHARED_LOCK = threading.Lock()
_RESIDENT: "dict[tuple, tuple]" = {}
_RESIDENT_LOCK = threading.Lock()
_MESH_LOCKS: "dict[object, threading.RLock]" = {}


def _group_key(device) -> tuple:
    dist = _dist()
    return (id(dist.group.WORLD) if dist is not None else None, str(device))


def _mesh_lock() -> threading.RLock:
    """The process group's mesh lock: one for every context over the group,
    since they share its collectives."""
    with _RESIDENT_LOCK:
        return _MESH_LOCKS.setdefault(_group_key(None)[0], threading.RLock())


def _resident_store(device) -> tuple:
    """(lock, resident dict) of the process group and device."""
    with _RESIDENT_LOCK:
        return _RESIDENT.setdefault(_group_key(device),
                                    (threading.Lock(), {}))


def shared_context(device=None) -> ShardedContext:
    """This process's one ShardedContext over the process group on `device`
    (built at the first call, collectively: every rank must call it, rank 0
    typically from the solver service's first Sync, the others before
    follow())."""
    key = _group_key(resolve_device(device))
    with _SHARED_LOCK:
        ctx = _SHARED.get(key)
        if ctx is None:
            ctx = _SHARED[key] = ShardedContext(device=device)
        return ctx


def forget_contexts() -> None:
    """Drop this process's contexts and groups (after the process group is
    destroyed; a later group builds its own)."""
    with _SHARED_LOCK:
        _SHARED.clear()
    with _RESIDENT_LOCK:
        _RESIDENT.clear()
        _MESH_LOCKS.clear()
    with _GROUPS_LOCK:
        _GROUPS.clear()


# -- consolidation lanes ------------------------------------------------------------


def _pad_lanes(inputs: PackInputs, multiple: int) -> "tuple[PackInputs, int]":
    """Pad the leading candidate axis to a device multiple with NO-OP lanes
    (zero pod counts, infeasible everywhere): they place nothing, open
    nothing, and the caller slices verdicts back to the true lane count."""
    C = inputs.group_vec.shape[0]
    Cp = -(-C // multiple) * multiple
    if Cp == C:
        return inputs, C
    pad_n = Cp - C

    def pad(a, value=0):
        a = np.asarray(a)
        w = [(0, 0)] * a.ndim
        w[0] = (0, pad_n)
        return np.pad(a, w, constant_values=value)

    out = inputs._replace(
        group_vec=pad(inputs.group_vec), group_count=pad(inputs.group_count),
        group_cap=pad(inputs.group_cap, int(INT_BIG)),
        group_newprov=pad(inputs.group_newprov, -1),
        ex_feas=pad(inputs.ex_feas, False),
    )
    if inputs.group_feas is not None:  # None when a feas table+idx rides along
        out = out._replace(group_feas=pad(inputs.group_feas, False))
    if inputs.ex_cap is not None:
        out = out._replace(ex_cap=pad(inputs.ex_cap, int(INT_BIG)))
    if inputs.group_origin is not None:
        out = out._replace(group_origin=pad(inputs.group_origin))
    return out, C


# the leaves with a leading candidate-lane axis (_pad_lanes pads them)
_LANE_LEAVES = ("group_vec", "group_count", "group_cap", "group_newprov",
                "ex_feas", "group_feas", "ex_cap", "group_origin")


def sharded_consolidation_verdicts(inputs: PackInputs, n_slots: int,
                                   mesh: Mesh, feas_table=None,
                                   feas_idx=None, device=None) -> np.ndarray:
    """The [C, 3] verdict table of the consolidation sweep, with candidate
    lanes sharded across `mesh` (host inputs, as encode_consolidation
    builds them): the lanes are padded with no-op lanes to a multiple of
    the ranks, each rank packs its own lanes with no collective inside the
    pack, and the table is assembled by an `all_reduce` SUM into a zeroed
    [Cp, 3], then sliced to C. Bit-identical to the single-card sweep
    (tests/test_torch_sharded.py). When a unique-row feasibility table
    rides along (inputs.group_feas is None), the table replicates and only
    the per-lane indices shard. On rank 0 of a ShardedContext the sweep is
    first announced to the followers, under its mesh lock."""
    driver = mesh.driver
    if driver is None:
        return _lane_verdicts(inputs, n_slots, mesh, feas_table, feas_idx,
                              device)
    with driver.mesh_lock:
        driver._send(("lanes", inputs._asdict(), n_slots, feas_table,
                      feas_idx))
        return _lane_verdicts(inputs, n_slots, mesh, feas_table, feas_idx,
                              device)


def _lane_verdicts(inputs, n_slots, mesh, feas_table, feas_idx,
                   device) -> np.ndarray:
    """sharded_consolidation_verdicts on this rank, once announced. Every
    rank steps through the whole batch's groups, so each launches as often
    as the others (a lane's steps past its own groups are identities)."""
    device = resolve_device(device)
    n = mesh.size
    inputs, C = _pad_lanes(inputs, n)
    Cp = inputs.group_vec.shape[0]
    if feas_idx is not None and feas_idx.shape[0] != Cp:
        feas_idx = np.pad(feas_idx, [(0, Cp - feas_idx.shape[0]), (0, 0)])
    Cl = Cp // n
    c0 = mesh.index(AXIS_LANES) * Cl
    fields = {k: (v[c0:c0 + Cl] if k in _LANE_LEAVES and v is not None
                  else v) for k, v in inputs._asdict().items()}
    lanes = lane_inputs_from_numpy(
        fields, device, feas_table=feas_table,
        feas_idx=None if feas_idx is None else feas_idx[c0:c0 + Cl])
    table = torch.zeros((Cp, 3), dtype=_I32, device=device)
    table[c0:c0 + Cl] = reduce_verdicts(pack_lanes(
        lanes, n_slots, n_eff_of(inputs.group_count)))
    mesh.all_reduce(table, "sum", AXIS_LANES)
    return table.cpu().numpy()[:C]
