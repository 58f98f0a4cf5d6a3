"""The provisioning solve on a CUDA device: encode -> pack -> decode.

Port of karpenter_tpu/solver/core.py (TPUSolver) to PyTorch. A solve runs:

1. encode_problem builds dense numpy arrays on the host (models/encode.py);
2. build_pack_inputs pads them to the bucket ladder and compresses the
   resource axis to its active columns;
3. pack_inputs_from_numpy uploads the per-solve arrays (the catalog arrays
   stay resident on the device, keyed by catalog seqnum);
4. ops/packer.pack_flat enqueues the pack, whose open-claim fill is a
   hand-written CUDA kernel (ops/open_claim.py), two launches a step;
5. one .cpu() read brings back the flat int32 buffer, the solve's only
   device sync;
6. decode turns it into node decisions, and _fill_counts reads off the same
   buffer what the open-claim fill placed (fill_pods, fill_rows).

solve_many runs a wave of independent problems: same-shape problems fold
into one lane pack per bucket (K lanes, padded to the wave ladder), and
every bucket's flat buffers come back in one .cpu() read.

Groups with required pod-(anti-)affinity to co-pending groups take a second
round, fed by _carry_round1_existing and folded back by _merge_rounds,
exactly as in the JAX package.

Each solve reads its phase boundaries once and keeps them as one span
record, last_solve_info["spans"]: (name, start_ns, end_ns) on the clock
of torch.profiler's events (time.time_ns), for the split, encode (its
groups, fold and bounds), dispatch (its inputs and enqueue), transfer and
decode, then each garbage collection inside the solve (runtime.gc, from
profiling/gcpause.py). From that record come its encode_ms, dispatch_ms,
transfer_ms and decode_ms, gc_full_ms (its generation-2 collections), the
tracer's spans, each filed at its start, and, as the JAX solver files them,
the encode/link/device_exec/decode notes of the gap ledger (profiling/)
with the rung's shape and `backend` (the solver's device type, "cuda" or
"cpu"); while the explain plane is on, the winning rung and the mask
dimensions ride in last_solve_info["decision"]. The encode's grouping
counts (models/pod.py group_pods: pods grouped on their content key, pods
grouped on their stamp, content keys merged) ride in last_solve_info as
group_keyed, group_stamped and group_merged, and on the groups span.

The solver runs on the CUDA card unless it is given device="cpu"; without a
card and without that argument it raises. NativeSolver is the same encode
and decode around the C++ host scan (native/), the controllers' second rung.

For the solver service: a ShapeRouter (`router=`), `last_shape_key`, and
Sync-time warmup (`warm_shapes`). With a mesh context (`mesh_ctx=`, the
process's parallel/sharded.ShardedContext on rank 0 of a process group of
two or more ranks), a plan the router sends to the mesh runs there
(`routing` "<device type>-sharded", `device_count` the mesh's ranks); its
flat buffer equals the single card's bit for bit.
The catalog arrays go up once through buckets.tracked_device_put (class
`catalog`) and each solve's arrays through buckets.tracked_tree_put (class
`delta`), so the upload counters and the HBM ledger see what crosses. The
kernels are built before the first solve, so there is no compile cache:
`compile_cache` reads "miss" for the first dispatch of a shape key (the
plan, provisioner count, optional leaves, catalog and resource widths) on
a device in this process, which pays the caching allocator's growth and
the first launches at that shape, and "hit" after; a warmup's dispatch
counts as COMPILE_WARMUPS instead of a miss.

On the card each solve brackets its pack with two CUDA events
(profiling.continuous.CudaEventSpan), whose span the continuous profiler's
device ladder records. Not ported: the measured roofline (XLA's
cost_analysis() has no torch counterpart, so no measured row is recorded)
and the callback readback (a TPU relay workaround with no CUDA
counterpart).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Optional, Sequence

import numpy as np
import torch

from .. import explain
from ..apis import wellknown as wk
from ..apis.provisioner import Provisioner
from ..device import resolve_device
from ..models.encode import EncodedProblem, OptionGrid, build_grid, encode_problem
from ..models.instancetype import Catalog
from ..models.pod import PodSpec, group_counts
from ..ops.packer import (INT_BIG, PackInputs, PackResult,
                          lane_inputs_from_numpy, n_eff_of, pack_flat,
                          pack_flat_lanes, pack_inputs_from_numpy,
                          unflatten_result)
from ..oracle.scheduler import (ExistingNode, Option, effective_alloc,
                                kubelet_overhead_vector, option_labels,
                                split_deferred_pods)
from ..profiling.continuous import CudaEventSpan, detect_backend
from ..profiling.gapledger import GAP_LEDGER
from ..profiling.gcpause import GC_PAUSES
from ..tracing import TRACER
from . import buckets

# The admission rule's mask factorization, in first-rejection order: the
# encoder ANDs exactly these constraint dimensions into group_feas
# (tolerations -> requirement fold -> fresh-node resource fit -> offering
# availability -> the spot plane's optional diversity-floor option mask),
# and whatever survives option admission can only be zeroed by cross-pod
# constraints inside the pack. The explain plane's reason vocabulary
# (explain/reasons.py DIMENSIONS) must stay in lockstep.
MASK_DIMENSIONS = (
    "taints",
    "requirements",
    "resources",
    "availability",
    "diversity",
    "constraints",
)


def _bucket(n: int, lo: int = 8) -> int:
    """Ladder-rung bucket under its historic name: `lo` names the
    dimension's ladder (8 -> groups/slots, 1 -> existing nodes, 2 -> wave
    lanes); any other `lo` doubles from it."""
    dim = {8: "groups", 1: "existing", 2: "wave"}.get(lo)
    if dim is None:
        b = lo
        while b < n:
            b *= 2
        return b
    return buckets.bucket_up(n, dim)


# shape keys dispatched so far in this process, per device: the first
# dispatch of a key is the compile cache's "miss" (see the module docstring)
_DISPATCHED: "set[tuple]" = set()
_DISPATCHED_LOCK = threading.Lock()


# a solve's span record: each child's parent, and the gap-ledger phase and
# lane of each span the ledger attributes
_PARENTS = {
    "solver.encode.groups": "solver.encode",
    "solver.encode.fold": "solver.encode",
    "solver.encode.bounds": "solver.encode",
    "solver.dispatch.inputs": "solver.dispatch.execute",
    "solver.dispatch.enqueue": "solver.dispatch.execute",
}
_LEDGER = {
    "solver.split": ("encode", "encode"),
    "solver.encode": ("encode", "encode"),
    "solver.dispatch.execute": ("link", "solver"),
    "solver.transfer": ("device_exec", "device"),
    "solver.decode": ("decode", "encode"),
}


def _file_spans(record: tuple, attrs: dict, pauses: list,
                anchor: int) -> None:
    """File a solve's span record, (name, start_ns, end_ns) on the
    profiler's clock (time.time_ns), with the tracer (each at its start,
    children under their parents, the record's last len(pauses) entries
    the collector's) and the ledger's spans with the gap ledger (`anchor`
    takes them back to perf_counter's clock)."""
    made: dict = {}
    n = len(record) - len(pauses)
    for name, s, e in record[:n]:
        made[name] = TRACER.record_span(
            name, (e - s) / 1e9, parent=made.get(_PARENTS.get(name)),
            start_ts=s / 1e9, **attrs.get(name, {}))
        if name in _LEDGER:
            # seconds as a difference of the two perf_counter floats, so
            # that one phase's start lands on the last one's end exactly
            phase, lane = _LEDGER[name]
            s_pc, e_pc = (s - anchor) / 1e9, (e - anchor) / 1e9
            GAP_LEDGER.note(phase, e_pc - s_pc, lane=lane, end_pc=e_pc)
    for (name, s, e), (_, _, gen, collected) in zip(record[n:], pauses):
        TRACER.record_span(name, (e - s) / 1e9, start_ts=s / 1e9,
                           generation=gen, collected=collected)


def _grouping(before: "tuple[int, int, int]") -> dict:
    """group_pods' counts on this thread since `before` (a group_counts()
    read): pods grouped on their content key, pods grouped on their stamp,
    and content keys merged into a group an earlier key began."""
    keyed, stamped, merged = (a - b for a, b in zip(group_counts(), before))
    return {"group_keyed": keyed, "group_stamped": stamped,
            "group_merged": merged}


def _first_dispatch(key: tuple) -> bool:
    """Record a dispatch of `key`; True when it is the first one."""
    with _DISPATCHED_LOCK:
        if key in _DISPATCHED:
            return False
        _DISPATCHED.add(key)
        return True


@dataclasses.dataclass
class SolvedNode:
    """One node decision (the Machine the controller would create)."""

    option: Option
    pod_counts: "dict[int, int]"  # group index -> pods
    provisioner: Provisioner

    @property
    def pod_count(self) -> int:
        return sum(self.pod_counts.values())


@dataclasses.dataclass
class SolveResult:
    nodes: "list[SolvedNode]"
    existing_counts: "dict[str, int]"  # existing node name -> pods placed
    unschedulable: "dict[int, int]"  # group index -> pod count
    groups: list
    # existing node name -> {group index -> pods placed} (binding plan)
    existing_by_group: "dict[str, dict[int, int]]" = dataclasses.field(default_factory=dict)

    def decisions(self) -> "list[tuple[str, str, str, int]]":
        """Fingerprint [(type, zone, capacityType, pods)] — comparable with
        oracle SchedulingResult.node_decisions()."""
        return sorted(
            (n.option.itype.name, n.option.zone, n.option.capacity_type, n.pod_count)
            for n in self.nodes
        )

    def unschedulable_count(self) -> int:
        return sum(self.unschedulable.values())


class TorchSolver:
    """Catalog-resident solver. The encoded option grid stays on the host
    and its alloc_t/tiebreak arrays stay on the device across solves; only
    the per-solve group arrays are uploaded."""

    def __init__(self, catalog: Catalog, provisioners: Sequence[Provisioner],
                 device: "str | torch.device | None" = None,
                 router: "Optional[buckets.ShapeRouter]" = None,
                 mesh_ctx=None):
        self.device = resolve_device(device)
        self.catalog = catalog
        self.provisioners = list(provisioners)
        # the solver service's per-solver route state and the process's
        # mesh context (parallel/sharded.ShardedContext, rank 0 of a process
        # group of >= 2 ranks): the router picks the mesh only with both
        self._router = router
        self._mesh_ctx = mesh_ctx
        # raw shape key of the last solve ((G, n_slots, Ne, Pv, optional
        # leaf flags)): the service's warmup history records these
        self.last_shape_key: "Optional[tuple]" = None
        self._grid: Optional[OptionGrid] = None
        # an evicted predecessor's grid (adopt_static): build_grid's reuse
        # donor for this solver's first grid, never installed as the grid
        self._donor_grid: Optional[OptionGrid] = None
        self._dev_alloc_t: Optional[torch.Tensor] = None
        self._dev_tiebreak: Optional[torch.Tensor] = None
        # encode_group memo across solves (this instance's provisioner set is
        # fixed; layout/seqnum two-level invalidation — see encode_problem)
        self._group_cache: dict = {}
        self.last_solve_info: dict = {}
        # solve_many's last wave: its buckets and phase times, and each
        # problem's flat buffer as read back (None for a solo problem)
        self.last_wave_info: dict = {}
        self.last_wave_flats: "list[Optional[np.ndarray]]" = []
        # flat int32 buffer of the last pack, as read back to the host
        self.last_flat: Optional[np.ndarray] = None
        GC_PAUSES.install()

    def adopt_static(self, other: "TorchSolver",
                     share_group_cache: bool = True) -> None:
        """An evicted predecessor (the controllers' solver caches rebuild on
        catalog content changes) donates its grid, its device copies of
        alloc_t/tiebreak and its group cache: when only availability changed
        (ICE churn), build_grid shares every static array and the cache's
        static level stays warm. The grid is only build_grid's reuse donor,
        never installed as the live grid (seqnums are per-catalog counters;
        only build_grid's layout_key check decides what is reusable). Device
        tensors are taken only from a donor on the same device.

        share_group_cache=False copies the cache's static level into a fresh
        dict instead of sharing the donor's: the solver service's donor
        stays live in its LRU, serving other clients, and two solvers
        mutating one cache dict would race.

        Port of karpenter_tpu/solver/core.py::TPUSolver.adopt_static."""
        if not isinstance(other, TorchSolver):
            return
        self._donor_grid = other._grid or other._donor_grid
        if other.device == self.device:
            self._dev_alloc_t = other._dev_alloc_t
            self._dev_tiebreak = other._dev_tiebreak
        if list(other.provisioners) != self.provisioners:
            return
        if share_group_cache:
            self._group_cache = other._group_cache
            return
        try:
            src = other._group_cache
            layout = src.get("layout")
            statics = dict(src.get("static") or {})
        except RuntimeError:  # donor inserted concurrently mid-copy
            return
        if layout is not None:
            self._group_cache = {"layout": layout, "static": statics}

    def grid(self) -> OptionGrid:
        """The option grid of the catalog's current seqnum. On a seqnum bump
        the previous (or donated) grid is build_grid's reuse donor (its
        layout_key check decides what is shared), and the device copies of
        alloc_t/tiebreak are replaced only when the host arrays changed."""
        if self._grid is None or self._grid.seqnum != self.catalog.seqnum:
            old = self._grid or self._donor_grid
            self._donor_grid = None
            self._grid = build_grid(self.catalog, reuse=old)
            if old is None or self._grid.alloc_t is not old.alloc_t \
                    or self._dev_alloc_t is None:
                self._dev_alloc_t = buckets.tracked_device_put(
                    self._grid.alloc_t, "catalog", self.device)
                self._dev_tiebreak = buckets.tracked_device_put(
                    self._grid.tiebreak, "catalog", self.device)
        return self._grid

    def solve(
        self,
        pods: "list[PodSpec]",
        existing: Sequence[ExistingNode] = (),
        daemon_overhead: Optional[Sequence[int]] = None,
        n_slots: Optional[int] = None,
        option_mask=None,
    ) -> SolveResult:
        """Two-round solve (shared semantics with the oracle's schedule):
        groups whose required pod-(anti-)affinity terms target CO-PENDING
        groups are deferred; round 1's solved claims join `existing` as
        pseudo nodes carrying their pods as residents, so round 2 resolves
        the terms through the resident-based affinity machinery.

        `option_mask` (bool [T, S] or None) ANDs into new-node admission on
        both rounds (models/encode.py encode_problem).

        The gap ledger's wall bracket opens here (outermost opener wins), so
        both rounds' phase notes file against this one wall; the affinity
        split and the round-2 carry are host problem preparation (encode),
        the merge is decode. last_solve_info["spans"] holds both rounds'
        span records, and its phase times and counts are their sums."""
        with GAP_LEDGER.solve_scope("solver"):
            t0 = time.perf_counter_ns()
            primary, deferred = split_deferred_pods(pods)
            split = (t0, time.perf_counter_ns(), len(pods))
            if not deferred:
                return self._solve_once(pods, existing, daemon_overhead,
                                        n_slots, option_mask=option_mask,
                                        split=split)
            res = self._solve_once(primary, existing, daemon_overhead,
                                   n_slots, option_mask=option_mask,
                                   split=split)
            first = self.last_solve_info
            # Round 2 must see round 1's consumption of the REAL existing
            # nodes (the oracle mutates its views in place; this path
            # re-encodes, so carry used + origin-keyed in-run counts on
            # fresh copies).
            t1 = time.perf_counter()
            carried = _carry_round1_existing(existing, res)
            pseudo = self._nodes_as_existing(res, daemon_overhead)
            GAP_LEDGER.note("encode", time.perf_counter() - t1,
                            lane="encode")
            res2 = self._solve_once(deferred, carried + pseudo,
                                    daemon_overhead, n_slots,
                                    option_mask=option_mask)
            info = self.last_solve_info
            summed = {k: first[k] + v for k, v in info.items()
                      if k.endswith("_ms")
                      or k in ("steps", "fill_pods", "fill_rows",
                               "group_keyed", "group_stamped",
                               "group_merged")}
            info.update(summed, rounds=2)
            TRACER.annotate(**summed, rounds=2)
            if "spans" in first:
                info["spans"] = first["spans"] + info["spans"]
            t2 = time.perf_counter()
            merged = _merge_rounds(res, res2, {p.name: i for i, p in
                                               enumerate(pseudo)})
            GAP_LEDGER.note("decode", time.perf_counter() - t2,
                            lane="encode")
            return merged

    def solve_many(self, problems: "Sequence[dict]") -> "list[SolveResult]":
        """A wave of independent solves. Each problem is a dict of solve()
        kwargs (pods, existing, daemon_overhead, n_slots). Problems bucket
        by padded shape; a bucket of one runs as a single pack, a bigger
        one as ONE lane pack whose lane count is padded to the wave ladder
        by repeating its first member (duplicate lanes are never read
        back). All buckets' flat buffers come back in ONE .cpu() read.
        Problems whose pods carry co-pending affinity need the two-round
        solve and go through solve() on their own.

        Port of karpenter_tpu/solver/core.py::solve_many/_solve_many_impl.
        The wave runs on the catalog grid of one snapshot: each problem
        ships the catalog arrays of the grid its encode actually used, and
        the bucket key carries that array's identity, so lanes from
        different grids never stack. One gap-ledger wall bracket covers the
        whole wave: solo problems recurse into solve(), whose nested scope
        is transparent."""
        with GAP_LEDGER.solve_scope("solver.many"):
            return self._solve_many_impl(problems)

    def _solve_many_impl(self, problems: "Sequence[dict]"
                         ) -> "list[SolveResult]":
        t0 = time.perf_counter()
        wave_grid = self.grid()
        dev_alloc_t, dev_tiebreak = self._dev_alloc_t, self._dev_tiebreak
        slots: "list[tuple]" = []  # (mode, payload)
        for prob in problems:
            pods = prob.get("pods", [])
            # cheap pre-check (attribute scan) before the real split: only
            # affinity-bearing pod sets can need the two-round solve
            if any(p.pod_affinity or p.pod_anti_affinity for p in pods) \
                    and split_deferred_pods(pods)[1]:
                slots.append(("solo", prob))
                continue
            existing = prob.get("existing", ())
            enc = encode_problem(
                self.catalog, self.provisioners, pods, existing,
                prob.get("daemon_overhead"), prob.get("n_slots"),
                grid=wave_grid, group_cache=self._group_cache)
            if enc.alloc_t is wave_grid.alloc_t:
                fields, plan = build_pack_inputs(enc, dev_alloc_t,
                                                 dev_tiebreak)
            else:  # encode rebuilt a fresh grid (catalog bumped mid-wave)
                fields, plan = build_pack_inputs(enc)
            slots.append(("wave", (enc, fields, plan, list(existing))))
        t1 = time.perf_counter()
        GAP_LEDGER.note("encode", t1 - t0, lane="encode", end_pc=t1)

        shape_waves: "dict[tuple, list[int]]" = {}
        for i, (mode, payload) in enumerate(slots):
            if mode == "wave":
                _, fields, plan, _ = payload
                key = (plan, id(fields["alloc_t"]),  # grid identity
                       fields["group_vec"].shape[1],  # compressed width
                       *(fields[k] is not None for k in (
                           "res_sel", "ex_cap", "group_origin",
                           "prov_overhead", "prov_pods_cap")))
                shape_waves.setdefault(key, []).append(i)
        flats: "list[tuple[list[int], torch.Tensor]]" = []
        waves = []
        host: "dict[int, np.ndarray]" = {}
        with CudaEventSpan(self.device) as span:
            for key, idxs in shape_waves.items():
                plan = key[0]
                members = [slots[i][1][1] for i in idxs]
                if len(members) == 1:
                    n_eff = n_eff_of(members[0]["group_count"])
                    flat2d = dispatch_pack_inputs(members[0], plan,
                                                  self.device,
                                                  span=span)[None]
                else:
                    stacked = _stack_pack_inputs(members)
                    n_eff = n_eff_of(stacked["group_count"])
                    flat2d = _wave_pack_flat(stacked, plan.slots,
                                             self.device, span=span)
                flats.append((idxs, flat2d))
                waves.append({"bucket": plan.label(), "problems": len(idxs),
                              "lanes": flat2d.shape[0], "steps": n_eff,
                              "res_width": key[2]})
            t2 = time.perf_counter()
            GAP_LEDGER.note("link", t2 - t1, lane="solver", end_pc=t2)
            if flats:
                cat = torch.cat([f.reshape(-1) for _, f in flats]).cpu() \
                    .numpy()
                t_fetch = time.perf_counter()
                GAP_LEDGER.note("device_exec", t_fetch - t2, lane="device",
                                end_pc=t_fetch)
                GAP_LEDGER.note_device_event(span.seconds())
                off = 0
                for idxs, f in flats:
                    K, L = f.shape
                    for j, slot_i in enumerate(idxs):
                        host[slot_i] = cat[off + j * L: off + (j + 1) * L]
                    off += K * L
        t3 = time.perf_counter()

        out: "list[SolveResult]" = []
        t_dec = 0.0
        for i, (mode, payload) in enumerate(slots):
            if mode == "solo":
                out.append(self.solve(
                    payload.get("pods", []), payload.get("existing", ()),
                    payload.get("daemon_overhead"), payload.get("n_slots")))
            else:
                enc, _, plan, existing = payload
                t_dec0 = time.perf_counter()
                out.append(decode(enc, unflatten_result(host[i], *plan),
                                  [e.name for e in existing]))
                t_dec += time.perf_counter() - t_dec0
        GAP_LEDGER.note("decode", t_dec, lane="encode")
        self.last_wave_info = {
            "encode_ms": (t1 - t0) * 1000,
            "dispatch_ms": (t2 - t1) * 1000,
            "transfer_ms": (t3 - t2) * 1000,
            "decode_ms": (time.perf_counter() - t3) * 1000,
            "routing": self.device.type,
            "waves": waves,
            "solo": sum(mode == "solo" for mode, _ in slots),
        }
        self.last_wave_flats = [host.get(i) for i in range(len(slots))]
        return out

    def warm_shapes(self, shapes: "Sequence[tuple]",
                    limit: int = 8) -> "list[str]":
        """Sync-time warmup: dispatch a zero-count synthetic problem at each
        raw shape's bucket through the real dispatch path, so the first
        real solve of that bucket is not the first dispatch of its shape on
        this device. Each shape is (G, n_slots, Ne) or the extended
        last_shape_key (adds Pv and the optional-leaf flags). A count-0
        problem runs no pack step: what it buys on the card is the caching
        allocator's blocks at that shape (the kernels are built before the
        first solve). Returns the bucket labels dispatched for the first
        time."""
        grid = self.grid()
        warmed: "list[str]" = []
        seen: "set[tuple]" = set()
        for shape in list(shapes)[:max(0, limit)]:
            G, slots_n, Ne = int(shape[0]), int(shape[1]), int(shape[2])
            pv = int(shape[3]) if len(shape) > 3 else max(
                1, len(self.provisioners))
            flags = (tuple(bool(f) for f in shape[4:8])
                     if len(shape) >= 8 else (False, False, False, False))
            plan = buckets.plan_for(G, slots_n, Ne)
            key = (plan, pv, flags)
            if key in seen:
                continue
            seen.add(key)
            fields = self._synth_inputs(grid, plan, pv, flags)
            route = ("single" if self._router is None
                     or self._mesh_ctx is None
                     else self._router.steady_route(plan))
            if route == "sharded":
                host_fetch(self._mesh_ctx.dispatch_flat(fields, plan.slots,
                                                        grid))
            else:
                host_fetch(dispatch_pack_inputs(fields, plan, self.device))
            if _first_dispatch(self._dispatch_key(
                    plan, pv, flags, grid,
                    buckets.LADDERS["resources"][0], route)):
                buckets.COMPILE_WARMUPS.inc()
                warmed.append(plan.label())
            # the JAX solver files XLA's cost_analysis() of the rung's
            # compiled program into the measured roofline here; no torch
            # backend has such a count, so the port records no measured
            # row and roofline.measured_snapshot() says the source is
            # unavailable (it invents no substitute)
        return warmed

    def _dispatch_key(self, plan, pv: int, flags: tuple, grid: OptionGrid,
                      res_width: int, route: str = "single") -> tuple:
        """The identity of a dispatched shape on this solver's device and
        route."""
        return (str(self.device), plan, pv, flags,
                tuple(grid.tiebreak.shape), res_width, route)

    def _synth_inputs(self, grid: OptionGrid, plan: "buckets.BucketPlan",
                      pv: int, flags: "tuple") -> dict:
        """Zero-count pack fields at exactly the padded shapes (and dtypes)
        build_pack_inputs would produce, against the resident catalog
        tensors, in the compressed resource layout of the bottom
        "resources" rung, where cpu+memory+pods workloads land."""
        has_ex_cap, has_origin, has_prov_ovh, has_pods_cap = flags
        T, S = grid.tiebreak.shape
        R = buckets.LADDERS["resources"][0]
        res_sel = np.zeros((R,), np.int32)
        res_sel[0] = wk.RESOURCE_INDEX[wk.RESOURCE_PODS]
        Gb, Nb, Neb = plan.groups, plan.slots, plan.existing
        return dict(
            alloc_t=self._dev_alloc_t, tiebreak=self._dev_tiebreak,
            group_vec=np.zeros((Gb, R), np.int32),
            group_count=np.zeros((Gb,), np.int32),
            group_cap=np.full((Gb,), int(INT_BIG), np.int32),
            group_feas=np.zeros((Gb, pv, T, S), bool),
            group_newprov=np.full((Gb,), -1, np.int32),
            overhead=np.zeros((R,), np.int32),
            ex_alloc=np.zeros((Neb, R), np.int32),
            ex_used=np.zeros((Neb, R), np.int32),
            ex_feas=np.zeros((Gb, Neb), bool),
            prov_overhead=(np.zeros((pv, R), np.int32)
                           if has_prov_ovh else None),
            prov_pods_cap=(np.zeros((pv, T), np.int32)
                           if has_pods_cap else None),
            ex_cap=(np.full((Gb, Neb), int(INT_BIG), np.int32)
                    if has_ex_cap else None),
            group_origin=(np.arange(Gb, dtype=np.int32)
                          if has_origin else None),
            res_sel=res_sel, res_mask=np.arange(R) < 1,
        )

    def _nodes_as_existing(self, res: SolveResult,
                           daemon_overhead) -> "list[ExistingNode]":
        """Round-1 claims as existing nodes (mirror of the oracle's
        _claims_as_existing: decided-option labels/alloc, pods resident)."""
        out = []
        for i, n in enumerate(res.nodes):
            used = [d + k for d, k in zip(
                list(daemon_overhead or [0] * wk.NUM_RESOURCES),
                kubelet_overhead_vector(n.provisioner.kubelet))]
            resident: "list[PodSpec]" = []
            for g_idx, count in n.pod_counts.items():
                spec = res.groups[g_idx].spec
                vec = res.groups[g_idx].vector
                for r in range(wk.NUM_RESOURCES):
                    used[r] += vec[r] * count
                resident.extend([spec] * count)
            out.append(ExistingNode(
                name=f"__round1-claim-{i}",
                labels=option_labels(n.option, n.provisioner),
                allocatable=list(effective_alloc(n.option, n.provisioner)),
                used=used,
                taints=n.provisioner.taints,
                resident=tuple(resident),
            ))
        return out

    def _solve_once(
        self,
        pods: "list[PodSpec]",
        existing: Sequence[ExistingNode] = (),
        daemon_overhead: Optional[Sequence[int]] = None,
        n_slots: Optional[int] = None,
        option_mask=None,
        split: "Optional[tuple]" = None,
    ) -> SolveResult:
        # Phases: encode is host work; dispatch is padding, the upload and
        # the asynchronous enqueue of the pack; transfer is the one
        # synchronising device->host read, so it holds the device's time;
        # decode is host-side result shaping. Each boundary is read once,
        # on perf_counter_ns's clock; `split` is solve()'s (start, end,
        # pods) of the affinity split, which round 1 files.
        marks: list = []
        counts = group_counts()
        t0 = time.perf_counter_ns()
        enc = encode_problem(
            self.catalog, self.provisioners, pods, existing,
            daemon_overhead, n_slots, grid=self.grid(),
            group_cache=self._group_cache, option_mask=option_mask,
            marks=marks,
        )
        t1 = time.perf_counter_ns()
        grouping = _grouping(counts)
        G, Ne = enc.group_vec.shape[0], enc.ex_alloc.shape[0]
        fields, plan = build_pack_inputs(enc, self._dev_alloc_t,
                                         self._dev_tiebreak)
        n_eff = n_eff_of(fields["group_count"])
        t_in = time.perf_counter_ns()
        route = "single"
        if self._router is not None and self._mesh_ctx is not None:
            route = self._router.route(plan)
        with CudaEventSpan(self.device) as span:
            if route == "sharded":
                # enc.grid is the grid this encode actually used (the
                # resident sharded catalog arrays are keyed on its identity)
                flat = _bracketed(span, lambda: self._mesh_ctx.dispatch_flat(
                    fields, plan.slots, enc.grid))
            else:
                flat = dispatch_pack_inputs(fields, plan, self.device,
                                            span=span)
            t2 = time.perf_counter_ns()
            host = host_fetch(flat)
            t3 = time.perf_counter_ns()
            GAP_LEDGER.note_device_event(span.seconds())
        device_count = (self._mesh_ctx.device_count if route == "sharded"
                        else 1)
        result = unflatten_result(host, *plan)
        out = decode(enc, result, [e.name for e in existing])
        fill_pods, fill_rows = _fill_counts(result.assign, n_eff)
        t4 = time.perf_counter_ns()
        pv = int(enc.group_feas.shape[1])
        flags = (enc.ex_cap is not None, enc.group_origin is not None,
                 enc.prov_overhead is not None,
                 enc.prov_pods_cap is not None)
        if _first_dispatch(self._dispatch_key(
                plan, pv, flags, enc.grid, int(fields["group_vec"].shape[1]),
                route)):
            compile_cache = "miss"
            buckets.COMPILE_MISSES.inc()
        else:
            compile_cache = "hit"
            buckets.COMPILE_HITS.inc()
        buckets.observe_plan(plan, G, enc.n_slots, Ne, route)
        self.last_shape_key = (G, enc.n_slots, Ne, pv) + flags
        self.last_flat = host
        self.last_solve_info = {
            "encode_ms": (t1 - t0) / 1e6,
            "dispatch_ms": (t2 - t1) / 1e6,
            "transfer_ms": (t3 - t2) / 1e6,
            "decode_ms": (t4 - t3) / 1e6,
            "routing": (f"{self.device.type}-sharded" if route == "sharded"
                        else self.device.type),
            "bucket": plan.label(),
            "plan": tuple(plan),  # (Gb, Nb, Neb), the padded shape
            "slots": plan.slots,
            "res_width": int(fields["group_vec"].shape[1]),
            "steps": n_eff,
            "fill_pods": fill_pods,
            "fill_rows": fill_rows,
            **grouping,
            "rounds": 1,
            "compile_cache": compile_cache,
            "device_count": device_count,
        }
        TRACER.annotate(**self.last_solve_info)
        # decision provenance: the winning bucket rung + mask-dimension
        # vocabulary ride along for the DecisionRecord the controller
        # emits after this solve; gated so a disabled explain plane leaves
        # the solve byte-identical (explain-strict-noop)
        if explain.enabled():
            self.last_solve_info["decision"] = {
                "rung": plan.rung(),
                "dimensions": MASK_DIMENSIONS,
            }
        # the solve's span record, the one source of the tracer's phase
        # spans (children of the current solve span; kernels are built
        # before the first solve, so dispatch is always an execute, never a
        # compile) and of the gap ledger's notes, each pinned at its phase
        # boundary so the critical plane sees the serial chain encode ->
        # link -> fetch -> decode (the .cpu() read is the device sync, so
        # the transfer is the device_exec evidence); the collector's pauses
        # inside the solve follow
        g0, g1, f1, b1, misses = marks
        spans = [("solver.encode", t0, t1),
                 ("solver.encode.groups", g0, g1),
                 ("solver.encode.fold", g1, f1),
                 ("solver.encode.bounds", f1, b1),
                 ("solver.dispatch.execute", t1, t2),
                 ("solver.dispatch.inputs", t1, t_in),
                 ("solver.dispatch.enqueue", t_in, t2),
                 ("solver.transfer", t2, t3),
                 ("solver.decode", t3, t4)]
        if split is not None:
            spans.insert(0, ("solver.split", split[0], split[1]))
        pauses = GC_PAUSES.between(spans[0][1], t4)
        spans += [("runtime.gc", p[0], p[1]) for p in pauses]
        # the full collections among them, which walk the whole unfrozen heap
        self.last_solve_info["gc_full_ms"] = sum(
            p[1] - p[0] for p in pauses if p[2] == 2) / 1e6
        anchor = time.time_ns() - time.perf_counter_ns()
        record = tuple((name, s + anchor, e + anchor) for name, s, e in spans)
        self.last_solve_info["spans"] = record
        _file_spans(record, {
            "solver.split": {"pods": split[2] if split else 0},
            "solver.encode.groups": {"pods": len(pods),
                                     "groups": len(enc.groups),
                                     **grouping},
            "solver.encode.fold": {"hits": len(enc.groups) - misses,
                                   "misses": misses},
            "solver.dispatch.execute": {"compile_cache": compile_cache,
                                        "bucket": plan.label()},
            "solver.dispatch.enqueue": {"steps": n_eff, "fill_pods": fill_pods,
                                        "fill_rows": fill_rows}},
            pauses, anchor)
        tb_shape = enc.grid.tiebreak.shape
        GAP_LEDGER.annotate(
            bucket=plan.label(), route=route,
            groups=plan.groups, slots=plan.slots, existing=plan.existing,
            pv=pv, t=int(tb_shape[0]),
            s=int(tb_shape[-1]), backend=detect_backend(self.device),
            device_count=device_count)
        return out


class NativeSolver(TorchSolver):
    """TorchSolver's encode and decode around the C++ host scan
    (native/native_pack) in place of the pack: no padding, no device.
    The controllers' second rung, after the card. A missing g++ or a failed
    build raises native.NativeUnavailable at the first solve.

    Port of karpenter_tpu/solver/core.py::NativeSolver. `last_flat` is the
    scan's result in the pack's flat layout at the unpadded shape
    `last_solve_info["shape"]` = (G, N, Ne); native.crop_flat cuts a card
    solve's padded buffer to the same shape."""

    def __init__(self, catalog: Catalog, provisioners: Sequence[Provisioner],
                 build_dir=None, device: "str | torch.device" = "cpu"):
        if torch.device(device).type != "cpu":
            raise ValueError("NativeSolver is a host scan: device must be "
                             "'cpu'")
        super().__init__(catalog, provisioners, device="cpu")
        self.build_dir = build_dir

    def solve_many(self, problems: "Sequence[dict]") -> "list[SolveResult]":
        """One host scan after another: no lane pack, no device."""
        return [self.solve(p.get("pods", []), p.get("existing", ()),
                           p.get("daemon_overhead"), p.get("n_slots"))
                for p in problems]

    def grid(self) -> OptionGrid:
        """The option grid, host only (the scan reads the numpy arrays)."""
        if self._grid is None or self._grid.seqnum != self.catalog.seqnum:
            old = self._grid or self._donor_grid
            self._donor_grid = None
            self._grid = build_grid(self.catalog, reuse=old)
        return self._grid

    def _solve_once(
        self,
        pods: "list[PodSpec]",
        existing: Sequence[ExistingNode] = (),
        daemon_overhead: Optional[Sequence[int]] = None,
        n_slots: Optional[int] = None,
        option_mask=None,
        split: "Optional[tuple]" = None,
    ) -> SolveResult:
        from ..native import flatten_host, native_pack

        if split is not None:  # the affinity split, as TorchSolver files it
            anchor = time.time_ns() - time.perf_counter_ns()
            _file_spans((("solver.split", split[0] + anchor,
                          split[1] + anchor),),
                        {"solver.split": {"pods": split[2]}}, [], anchor)

        counts = group_counts()
        t0 = time.perf_counter()
        enc = encode_problem(
            self.catalog, self.provisioners, pods, existing,
            daemon_overhead, n_slots, grid=self.grid(),
            group_cache=self._group_cache, option_mask=option_mask,
        )
        t1 = time.perf_counter()
        grouping = _grouping(counts)
        inputs = PackInputs(
            alloc_t=enc.alloc_t, tiebreak=enc.tiebreak,
            group_vec=enc.group_vec, group_count=enc.group_count,
            group_cap=enc.group_cap, group_feas=enc.group_feas,
            group_newprov=enc.group_newprov, overhead=enc.overhead,
            ex_alloc=enc.ex_alloc, ex_used=enc.ex_used, ex_feas=enc.ex_feas,
            prov_overhead=enc.prov_overhead, prov_pods_cap=enc.prov_pods_cap,
            ex_cap=enc.ex_cap, group_origin=enc.group_origin,
        )
        result = native_pack(inputs, n_slots=enc.n_slots,
                             build_dir=self.build_dir)
        t2 = time.perf_counter()
        out = decode(enc, result, [e.name for e in existing])
        t3 = time.perf_counter()
        self.last_flat = flatten_host(result)
        self.last_solve_info = {
            "encode_ms": (t1 - t0) * 1000,
            "scan_ms": (t2 - t1) * 1000,
            "transfer_ms": 0.0,
            "decode_ms": (t3 - t2) * 1000,
            "routing": "native",
            "compile_cache": "n/a",
            "shape": (enc.group_vec.shape[0], enc.n_slots,
                      enc.ex_alloc.shape[0]),
            "steps": 0,  # no pack steps: the scan is one host call
            **grouping,
            "rounds": 1,
        }
        return out


def _carry_round1_existing(existing: "Sequence[ExistingNode]",
                           res: SolveResult) -> "list[ExistingNode]":
    """Fresh ExistingNode copies reflecting round-1 placements: used grows
    by the placed vectors, and group_counts carries the origin-keyed in-run
    counts (the oracle's cap rule is resident_counts[okey] +
    group_counts[okey]; encode_problem consumes both). `resident` stays
    untouched — round-1 placements are NOT affinity anchors in the oracle's
    round 2 either (they live in assignments, not resident)."""
    out: "list[ExistingNode]" = []
    for e in existing:
        per_group = res.existing_by_group.get(e.name, {})
        used = list(e.used)
        # pre-seeded counts are part of the contract (encode subtracts them
        # from ex_cap); chained solves must not reset them
        counts: "dict[object, int]" = dict(e.group_counts)
        for g_idx, count in per_group.items():
            vec = res.groups[g_idx].vector
            for r in range(wk.NUM_RESOURCES):
                used[r] += vec[r] * count
            okey = res.groups[g_idx].spec.origin_key()
            counts[okey] = counts.get(okey, 0) + count
        ne = ExistingNode(name=e.name, labels=e.labels,
                          allocatable=list(e.allocatable), used=used,
                          taints=e.taints, resident=e.resident)
        ne.group_counts = counts
        out.append(ne)
    return out


def _merge_rounds(res: SolveResult, res2: SolveResult,
                  pseudo_index: "dict[str, int]") -> SolveResult:
    """Fold the deferred round back: group indices offset by round-1's
    group count; dependents placed on pseudo nodes join the claim's
    pod_counts; real-node assignments and unschedulables merge."""
    offset = len(res.groups)
    groups = list(res.groups) + list(res2.groups)
    nodes = list(res.nodes)
    for name, per_group in res2.existing_by_group.items():
        claim_i = pseudo_index.get(name)
        if claim_i is None:
            continue
        counts = nodes[claim_i].pod_counts
        for g_idx, count in per_group.items():
            counts[g_idx + offset] = counts.get(g_idx + offset, 0) + count
    nodes.extend(dataclasses.replace(
        n, pod_counts={g + offset: c for g, c in n.pod_counts.items()})
        for n in res2.nodes)
    existing_by_group = {name: dict(d)
                         for name, d in res.existing_by_group.items()}
    for name, per_group in res2.existing_by_group.items():
        if name in pseudo_index:
            continue
        tgt = existing_by_group.setdefault(name, {})
        for g_idx, count in per_group.items():
            tgt[g_idx + offset] = tgt.get(g_idx + offset, 0) + count
    existing_counts = {name: sum(d.values())
                       for name, d in existing_by_group.items() if d}
    unschedulable = dict(res.unschedulable)
    for g_idx, count in res2.unschedulable.items():
        unschedulable[g_idx + offset] = count
    return SolveResult(nodes, existing_counts, unschedulable, groups,
                       existing_by_group)


def build_pack_inputs(enc: EncodedProblem, dev_alloc_t=None,
                      dev_tiebreak=None) -> "tuple[dict, buckets.BucketPlan]":
    """Pad to shape buckets and assemble the host-side pack fields — no
    device work. Returns (fields, plan), plan being the padded
    (groups, slots, existing) = (Gb, Nb, Neb); fields maps each
    PackInputs leaf to a numpy array (or None), except alloc_t/tiebreak,
    which are the resident device tensors when given."""
    plan = buckets.plan_for(enc.group_vec.shape[0], enc.n_slots,
                            enc.ex_alloc.shape[0])
    Gb, Nb, Neb = plan

    def pad(a, n, axis=0, fill=0):
        if a.shape[axis] == n:
            return a
        widths = [(0, 0)] * a.ndim
        widths[axis] = (0, n - a.shape[axis])
        return np.pad(a, widths, constant_values=fill)

    # Resource-axis compression: gather the columns demanded by ANY group
    # (pods always, and always first — the pods-cap path needs a fixed
    # index) and ship the compressed leaves. alloc_t stays full-width (it
    # is the resident catalog array); the pack gathers its columns on the
    # device off res_sel. Exact by the INT_BIG convention: a column with
    # zero demand everywhere quotients to INT_BIG whatever its
    # availability. Wider-than-ladder problems keep the full-width layout.
    pods_res = wk.RESOURCE_INDEX[wk.RESOURCE_PODS]
    R_full = enc.group_vec.shape[1]
    act = enc.group_vec.max(axis=0) > 0
    act[pods_res] = True
    n_act = int(act.sum())
    res_sel = res_mask = None
    if n_act <= buckets.LADDERS["resources"][-1] < R_full:
        Rb = buckets.bucket_up(n_act, "resources")
        others = np.flatnonzero(act)
        sel = np.concatenate(
            ([pods_res], others[others != pods_res])).astype(np.int32)
        res_sel = np.zeros((Rb,), np.int32)
        res_sel[:n_act] = sel
        res_mask = np.arange(Rb) < n_act

        def rsel(a):
            if a is None:
                return None
            out = a[..., res_sel]
            out[..., n_act:] = 0
            return out

        enc = dataclasses.replace(
            enc, group_vec=rsel(enc.group_vec), overhead=rsel(enc.overhead),
            ex_alloc=rsel(enc.ex_alloc), ex_used=rsel(enc.ex_used),
            prov_overhead=rsel(enc.prov_overhead))

    ex_feas = pad(enc.ex_feas, Gb)
    if ex_feas.shape[1] != Neb:
        ex_feas = pad(ex_feas, Neb, axis=1)
    ex_cap = enc.ex_cap
    if ex_cap is not None:
        ex_cap = pad(pad(ex_cap, Gb, fill=int(INT_BIG)), Neb, axis=1,
                     fill=int(INT_BIG))
    group_origin = enc.group_origin
    if group_origin is not None:
        # padded rows are their own origin (identity) so they stay no-ops
        ident = np.arange(Gb, dtype=np.int32)
        ident[:group_origin.shape[0]] = group_origin
        group_origin = ident
    fields = dict(
        alloc_t=dev_alloc_t if dev_alloc_t is not None else enc.alloc_t,
        tiebreak=dev_tiebreak if dev_tiebreak is not None else enc.tiebreak,
        group_vec=pad(enc.group_vec, Gb),
        group_count=pad(enc.group_count, Gb),
        group_cap=pad(enc.group_cap, Gb),
        group_feas=pad(enc.group_feas, Gb),
        group_newprov=pad(enc.group_newprov, Gb, fill=-1),
        overhead=enc.overhead,
        ex_alloc=pad(enc.ex_alloc, Neb),
        ex_used=pad(enc.ex_used, Neb),
        ex_feas=ex_feas,
        prov_overhead=enc.prov_overhead, prov_pods_cap=enc.prov_pods_cap,
        ex_cap=ex_cap, group_origin=group_origin,
        res_sel=res_sel, res_mask=res_mask,
    )
    return fields, plan


def _tracked_upload(fields: dict, device) -> dict:
    """The pack fields on `device`, counted: the catalog tensors ride
    resident (a counted no-op when they are already there), the rest go up
    as this solve's `delta`."""
    cat = {k: buckets.tracked_device_put(fields[k], "catalog", device)
           for k in ("alloc_t", "tiebreak")}
    delta = buckets.tracked_tree_put(
        {k: v for k, v in fields.items() if k not in cat}, "delta", device)
    return {**delta, **cat}


def dispatch_pack_inputs(fields: dict, plan: "buckets.BucketPlan",
                         device, span: "Optional[CudaEventSpan]" = None
                         ) -> torch.Tensor:
    """ENQUEUE the pack of already-padded fields on `device`, no device
    read. Returns the flat int32 result buffer on the device. `span`'s
    events bracket the pack's kernels, after the upload."""
    inputs = pack_inputs_from_numpy(_tracked_upload(fields, device), device)
    return _bracketed(span, lambda: pack_flat(
        inputs, plan.slots, n_eff_of(fields["group_count"])))


def _bracketed(span: "Optional[CudaEventSpan]", fn):
    """fn() between span's events (a wave's span covers all its packs: the
    start is recorded once, the stop after each)."""
    if span is None:
        return fn()
    span.start()
    out = fn()
    span.stop()
    return out


def dispatch_pack(enc: EncodedProblem, dev_alloc_t=None, dev_tiebreak=None,
                  device="cpu"):
    """build_pack_inputs + dispatch_pack_inputs: -> (flat device buffer,
    plan); host_fetch reads it back, so a caller can enqueue several packs
    before the one read."""
    fields, plan = build_pack_inputs(enc, dev_alloc_t, dev_tiebreak)
    return dispatch_pack_inputs(fields, plan, device), plan


def _wave_pack_flat(stacked: dict, n_slots: int, device,
                    span: "Optional[CudaEventSpan]" = None) -> torch.Tensor:
    """One lane pack for a bucket of same-shape problems (the stacked
    fields of _stack_pack_inputs; the catalog tensors shared by the lanes).
    -> [K, L] flat buffers on the device."""
    inputs = lane_inputs_from_numpy(_tracked_upload(stacked, device), device)
    return _bracketed(span, lambda: pack_flat_lanes(
        inputs, n_slots, n_eff_of(stacked["group_count"])))


def host_fetch(dev_arr: torch.Tensor) -> np.ndarray:
    """The solver's device->host read (it waits for the device)."""
    return dev_arr.cpu().numpy()


def _stack_pack_inputs(members: "list[dict]") -> dict:
    """Stack same-shape problems' pack fields along a new leading K axis,
    K padded to the wave ladder by repeating the first member (duplicate
    lanes are never read back). alloc_t/tiebreak (the catalog arrays,
    possibly device-resident) stay shared from the first member; None
    leaves stay None. Port of karpenter_tpu/solver/core.py::
    _stack_pack_inputs; lane_inputs_from_numpy uploads the result."""
    first = members[0]
    Kb = buckets.bucket_up(len(members), "wave")
    members = list(members) + [first] * (Kb - len(members))
    return {name: first[name] if name in ("alloc_t", "tiebreak")
            or first[name] is None
            else np.stack([m[name] for m in members])
            for name in PackInputs._fields}


def _fill_counts(assign: np.ndarray, n_eff: int) -> "tuple[int, int]":
    """What a pack's open-claim fill did, from its host-side assign matrix
    ([G, N] pods per group and claim slot): (fill_pods, fill_rows).

    A slot's opener is the first group with pods on it; step 3 of that
    group's pack step opened it, and every later group's pods on it came
    from step 2, the fill. fill_pods counts those pods; fill_rows counts
    the claim rows open when each of the n_eff steps' fill ran (a slot
    opened by step g is open for steps g + 1 .. n_eff - 1)."""
    if n_eff < 2:
        return 0, 0
    # seen[g, n]: a group up to g has pods on slot n, so the slot was open
    # when step g + 1's fill ran
    seen = np.logical_or.accumulate(assign[:n_eff - 1] > 0, axis=0)
    fill_pods = int((assign[1:n_eff] * seen).sum(dtype=np.int64))
    return fill_pods, int(np.count_nonzero(seen))


def decode(enc: EncodedProblem, result: PackResult,
           existing_names: "list[str]") -> SolveResult:
    """Host-side PackResult (numpy, from unflatten_result) -> SolveResult."""
    assign, ex_assign, unsched = result.assign, result.ex_assign, result.unsched
    active, decided, nprov = result.active, result.decided, result.nprov
    G = len(enc.groups)

    nodes: "list[SolvedNode]" = []
    for n in np.nonzero(active)[0]:
        counts_col = assign[:G, n]
        counts = {int(g): int(counts_col[g]) for g in np.nonzero(counts_col)[0]}
        if decided[n] < 0:
            # an active slot must always retain >=1 option
            raise RuntimeError(f"active claim slot {n} has no surviving option")
        nodes.append(SolvedNode(
            option=enc.grid.options[int(decided[n])], pod_counts=counts,
            provisioner=enc.provisioners[int(nprov[n])],
        ))
    ex_totals = ex_assign[:G].sum(axis=0)
    existing_counts = {
        name: int(ex_totals[e]) for e, name in enumerate(existing_names)
        if ex_totals[e] > 0
    }
    existing_by_group = {
        name: {int(g): int(ex_assign[g, e]) for g in range(G) if ex_assign[g, e] > 0}
        for e, name in enumerate(existing_names) if ex_totals[e] > 0
    }
    unschedulable = {int(g): int(unsched[g]) for g in np.nonzero(unsched[:G] > 0)[0]}
    return SolveResult(nodes, existing_counts, unschedulable, enc.groups,
                       existing_by_group)
