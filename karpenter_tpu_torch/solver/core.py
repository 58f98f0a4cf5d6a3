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
6. decode turns it into node decisions.

Groups with required pod-(anti-)affinity to co-pending groups take a second
round, fed by _carry_round1_existing and folded back by _merge_rounds,
exactly as in the JAX package.

The solver runs on the CUDA card unless it is given device="cpu"; without a
card and without that argument it raises. Not ported yet (each has its own
later slice): the tracing, gap-ledger and explain notes, solve_many waves,
warm_shapes and the measured roofline, the callback readback (a TPU relay
workaround with no CUDA counterpart), the mesh route and NativeSolver.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Sequence

import numpy as np
import torch

from ..apis import wellknown as wk
from ..apis.provisioner import Provisioner
from ..device import resolve_device
from ..models.encode import EncodedProblem, OptionGrid, build_grid, encode_problem
from ..models.instancetype import Catalog
from ..models.pod import PodSpec
from ..ops.packer import (INT_BIG, PackResult, n_eff_of, pack_flat,
                          pack_inputs_from_numpy, unflatten_result)
from ..oracle.scheduler import (ExistingNode, Option, effective_alloc,
                                kubelet_overhead_vector, option_labels,
                                split_deferred_pods)
from . import buckets


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
                 device: "str | torch.device | None" = None):
        self.device = resolve_device(device)
        self.catalog = catalog
        self.provisioners = list(provisioners)
        self._grid: Optional[OptionGrid] = None
        self._dev_alloc_t: Optional[torch.Tensor] = None
        self._dev_tiebreak: Optional[torch.Tensor] = None
        # encode_group memo across solves (this instance's provisioner set is
        # fixed; layout/seqnum two-level invalidation — see encode_problem)
        self._group_cache: dict = {}
        self.last_solve_info: dict = {}
        # flat int32 buffer of the last pack, as read back to the host
        self.last_flat: Optional[np.ndarray] = None

    def grid(self) -> OptionGrid:
        """The option grid of the catalog's current seqnum. On a seqnum bump
        the previous grid is build_grid's reuse donor (its layout_key check
        decides what is shared), and the device copies of alloc_t/tiebreak
        are replaced only when the host arrays changed."""
        if self._grid is None or self._grid.seqnum != self.catalog.seqnum:
            old = self._grid
            self._grid = build_grid(self.catalog, reuse=old)
            if old is None or self._grid.alloc_t is not old.alloc_t \
                    or self._dev_alloc_t is None:
                self._dev_alloc_t = torch.from_numpy(
                    np.ascontiguousarray(self._grid.alloc_t)).to(self.device)
                self._dev_tiebreak = torch.from_numpy(
                    np.ascontiguousarray(self._grid.tiebreak)).to(self.device)
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
        both rounds (models/encode.py encode_problem)."""
        primary, deferred = split_deferred_pods(pods)
        if not deferred:
            return self._solve_once(pods, existing, daemon_overhead, n_slots,
                                    option_mask=option_mask)
        res = self._solve_once(primary, existing, daemon_overhead, n_slots,
                               option_mask=option_mask)
        steps = self.last_solve_info["steps"]
        # Round 2 must see round 1's consumption of the REAL existing nodes
        # (the oracle mutates its views in place; this path re-encodes, so
        # carry used + origin-keyed in-run counts on fresh copies).
        carried = _carry_round1_existing(existing, res)
        pseudo = self._nodes_as_existing(res, daemon_overhead)
        res2 = self._solve_once(deferred, carried + pseudo, daemon_overhead,
                                n_slots, option_mask=option_mask)
        self.last_solve_info["steps"] += steps
        self.last_solve_info["rounds"] = 2
        return _merge_rounds(res, res2, {p.name: i for i, p in
                                         enumerate(pseudo)})

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
    ) -> SolveResult:
        # Phases: encode is host work; dispatch is padding, the upload and
        # the asynchronous enqueue of the pack; transfer is the one
        # synchronising device->host read, so it holds the device's time;
        # decode is host-side result shaping.
        t0 = time.perf_counter()
        enc = encode_problem(
            self.catalog, self.provisioners, pods, existing,
            daemon_overhead, n_slots, grid=self.grid(),
            group_cache=self._group_cache, option_mask=option_mask,
        )
        t1 = time.perf_counter()
        fields, plan = build_pack_inputs(enc, self._dev_alloc_t,
                                         self._dev_tiebreak)
        n_eff = n_eff_of(fields["group_count"])
        inputs = pack_inputs_from_numpy(fields, self.device)
        flat = pack_flat(inputs, plan.slots, n_eff)
        t2 = time.perf_counter()
        host = flat.cpu().numpy()
        t3 = time.perf_counter()
        out = decode(enc, unflatten_result(host, *plan),
                     [e.name for e in existing])
        t4 = time.perf_counter()
        self.last_flat = host
        self.last_solve_info = {
            "encode_ms": (t1 - t0) * 1000,
            "dispatch_ms": (t2 - t1) * 1000,
            "transfer_ms": (t3 - t2) * 1000,
            "decode_ms": (t4 - t3) * 1000,
            "routing": self.device.type,
            "bucket": plan.label(),
            "slots": plan.slots,
            "res_width": int(fields["group_vec"].shape[1]),
            "steps": n_eff,
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
