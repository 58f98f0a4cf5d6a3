"""Batched consolidation search on the device, in PyTorch.

Port of karpenter_tpu/ops/consolidate.py. The consolidation hot loop (for
each candidate node SET: simulate re-scheduling its pods onto the rest of
the cluster plus at most one cheaper replacement) runs as ONE lane pack:
every candidate set is a lane of ops/packer.pack_lanes, whose open-claim
fill is the hand-written CUDA kernel (ops/open_claim.py) with a lane axis.
The catalog, overhead, existing-node and kubelet leaves are shared by the
lanes (expanded views); the group and ex_feas/ex_cap leaves are per lane.
N_SLOTS = 2: a second opening proves a lane non-consolidatable. The lanes
reduce on the device to a [C, 3] verdict table, read back once.

Scoring (disruption cost, lifetime weighting) and action selection stay on
the host; oracle/consolidation.py is the spec both paths answer to.

The sweep runs on the CUDA card unless it is given device="cpu"; without a
card and without that argument it raises. Each sweep annotates the current
tracing span with its timings, and while the explain plane is on
_decode_actions captures every candidate lane's keep/evict verdict into
`last_verdicts` (a streamed sweep keeps only its last chunk's, as the JAX
package does). The deprovisioning controller's card rung calls
sweep_consolidation, which streams only when the one-shot pack would not
fit in the device's free memory; with `record_last_chunk` its capture
keeps only the lanes of the last stream_lanes() chunk, as the JAX rung's
streamed sweep does, and without it every lane's, as the JAX one-shot
sweep's does, whichever way it ran. With `mesh` (a lane mesh of
parallel/sharded.py) the candidate lanes shard over the process group's
ranks, as the JAX package's mesh sweep does. The timings of the last sweep
are kept in `last_timings` on every run.
"""

from __future__ import annotations

import dataclasses
import os as _os
import time as _time
import weakref as _weakref
from typing import Optional, Sequence

import numpy as np
import torch

from .. import explain
from ..apis import wellknown as wk
from ..apis.provisioner import Provisioner
from ..device import resolve_device
from ..models.cluster import ClusterState, StateNode
from ..models.encode import (INT_BIG, OptionGrid, build_grid, encode_group,
                             fold_node_mask, kubelet_arrays)
from ..models.instancetype import Catalog
from ..models.pod import tolerates_all
from ..oracle.consolidation import (
    ConsolidationAction, MAX_PAIR_CANDIDATES, REPLACE_PRICE_EPS,
    candidate_pairs, disruption_cost, eligible,
)
from ..oracle.scheduler import prepare_groups
from ..tracing import TRACER
from .packer import (PackInputs, lane_inputs_from_numpy, n_eff_of, pack_lanes,
                     reduce_verdicts)

N_SLOTS = 2  # 1 replacement allowed; a 2nd opening proves non-consolidatable

# phase split of the last sweep (encode/flatten/put/dispatch/fetch/decode)
last_timings: "dict | None" = None
# the last sweep's [C, 3] verdict table as read back (a streamed sweep's
# chunks concatenated, padded lanes dropped)
last_verdict_table: "np.ndarray | None" = None

# grid memo for grid-less callers: build_grid costs ~120ms at 551 types in
# the JAX package's profile. weakref to the catalog: identity comparison
# against a LIVE object stays sound (a dead ref is just a miss, never an
# id()-recycling alias) without pinning a retired catalog + grid in memory.
_grid_memo: "tuple | None" = None  # (weakref(catalog), seqnum, grid)


def _grid_for(catalog: Catalog, grid: "Optional[OptionGrid]") -> OptionGrid:
    global _grid_memo
    if grid is not None and grid.seqnum == catalog.seqnum:
        return grid
    m = _grid_memo
    if m is not None and m[0]() is catalog and m[1] == catalog.seqnum:
        return m[2]
    # a caller-held or memoized stale grid can still donate its static
    # arrays when only availability changed (build_grid layout check)
    g = build_grid(catalog, reuse=grid if grid is not None
                   else (m[2] if m is not None else None))
    _grid_memo = (_weakref.ref(catalog), catalog.seqnum, g)
    return g


@dataclasses.dataclass
class ConsolidationBatch:
    # host PackInputs (numpy leaves): group/ex leaves carry a leading C
    # axis, the catalog, overhead, existing-node and kubelet leaves none
    inputs: PackInputs
    candidates: "list[tuple[StateNode, ...]]"  # one SET per lane (singles or pairs)
    provisioners: "list[Provisioner]"
    grid: OptionGrid
    # group feasibility ships as a unique-row table + per-lane indices and
    # is expanded to the full [C,Gb,Pv,T,S] ON DEVICE (inputs.group_feas is
    # None): candidate lanes in a real cluster repeat a handful of distinct
    # (group spec, price band) rows, so the dense array is ~97% duplicate
    # bytes — 1.6MB at 500 singles, ~13MB at the 2016-lane pair sweep.
    # Row 0 is all-False (padded/unused groups).
    feas_table: "np.ndarray" = None  # [U, Pv, T, S] bool
    feas_idx: "np.ndarray" = None  # [C, Gb] int32


def encode_consolidation(
    cluster: ClusterState,
    catalog: Catalog,
    provisioners: Sequence[Provisioner],
    daemon_overhead: Optional[Sequence[int]] = None,
    grid: Optional[OptionGrid] = None,
    cand_sets: "Optional[list[tuple[StateNode, ...]]]" = None,
    candidate_filter=None,
) -> Optional[ConsolidationBatch]:
    """cand_sets=None encodes the single-node sweep; pass node tuples (e.g.
    candidate_pairs) for the multi-node search — each set is one lane
    whose group batch is the set's combined pods and whose cheaper-option
    mask is priced against the set's combined price."""
    grid = _grid_for(catalog, grid)
    provs = sorted(provisioners, key=lambda p: (-p.weight, p.name))
    overhead = np.asarray(daemon_overhead if daemon_overhead is not None
                          else [0] * wk.NUM_RESOURCES, dtype=np.int32)
    cols = grid.get_cols()
    T, S, R, Pv = grid.T, grid.S, wk.NUM_RESOURCES, len(provs)
    # [T, S]; inf only where NO offering is defined — unavailable offerings
    # carry real prices on the static grid, so every price test must mask
    # with grid.valid
    price = grid.price

    if cand_sets is None:
        cand_sets = [(cluster.nodes[name],) for name in sorted(cluster.nodes)
                     if eligible(cluster.nodes[name], cluster)
                     and (candidate_filter is None
                          or candidate_filter(cluster.nodes[name]))]
    candidates = cand_sets
    if not candidates:
        return None

    all_nodes = sorted(cluster.nodes)
    node_index = {n: i for i, n in enumerate(all_nodes)}
    Ne = len(all_nodes)
    # HOT:BEGIN(consolidation-encode) — existing rows gather straight off
    # the cluster's columns (int64 clamped to the kernel's i32 domain);
    # per-node dataclass views never materialize on this path unless an
    # affinity/topology pre-pass touches them
    ccols = cluster.columns
    rows = np.fromiter((ccols.row_of[n] for n in all_nodes),
                       dtype=np.int64, count=Ne)
    ex_alloc = np.minimum(ccols.alloc[rows], INT_BIG).astype(np.int32)
    ex_used = np.minimum(ccols.used[rows], INT_BIG).astype(np.int32)
    # HOT:END(consolidation-encode)

    C = len(candidates)
    per_cand = []
    gmax = 1
    # cheaper-option mask + zone set depend ONLY on the set's total price —
    # homogeneous clusters (and especially the O(n^2) pair sweep) repeat a
    # handful of distinct prices across thousands of lanes, so both are
    # memoized per price (profiled round 4: the per-lane [T,S] scan was
    # ~40% of pair-sweep encode)
    by_price: "dict[float, tuple]" = {}
    for cand in candidates:
        total_price = sum(n.price for n in cand)
        hit = by_price.get(total_price)
        if hit is None:
            # AND with availability: the static grid carries real prices on
            # unavailable options (old grids encoded them as inf)
            cheaper_opt = (price < (total_price - REPLACE_PRICE_EPS)) \
                & grid.valid  # [T, S]
            zs = {grid.zones[s // len(grid.capacity_types)]
                  for t, s in zip(*np.nonzero(cheaper_opt))}
            hit = by_price[total_price] = (cheaper_opt, sorted(zs))
        cheaper_opt, zones_c = hit
        pods = [p for n in cand for p in n.non_daemon_pods()]
        # domain-population-aware split must see the surviving nodes (the
        # oracle path passes cluster.existing_views(exclude=cand) the same
        # way, oracle/consolidation.py:107) — but both pre-passes gate on
        # the pod set's terms before touching `existing`
        # (resolve_pod_affinity: pod_(anti_)affinity; split_zone_spread:
        # zone topology / anti_affinity_zone), so lanes with term-free
        # pods skip the per-lane snapshot entirely: it was ~40% of the
        # 996-lane streamed encode on a plain-pod cluster
        if any(p.pod_affinity or p.pod_anti_affinity or p.topology
               or p.anti_affinity_zone for p in pods):
            survivors = cluster.existing_columns(
                exclude={n.name for n in cand})
        else:
            survivors = ()
        groups = prepare_groups(pods, zones_c, survivors)
        gmax = max(gmax, len(groups))
        per_cand.append((cand, total_price, groups))

    Gb = gmax
    group_vec = np.zeros((C, Gb, R), dtype=np.int32)
    group_count = np.zeros((C, Gb), dtype=np.int32)
    group_cap = np.full((C, Gb), INT_BIG, dtype=np.int32)
    feas_idx = np.zeros((C, Gb), dtype=np.int32)  # 0 = all-False row
    feas_rows: "list[np.ndarray]" = []  # unique [Pv,T,S] rows, 1-based
    feas_row_index: "dict[tuple, int]" = {}
    group_newprov = np.full((C, Gb), -1, dtype=np.int32)
    ex_feas = np.zeros((C, Gb, Ne), dtype=bool)
    # origin-representative rows: zone-split subgroups share one per-node cap
    # budget (identity for padded/unsplit rows — see encode_problem)
    group_origin = np.broadcast_to(
        np.arange(Gb, dtype=np.int32), (C, Gb)).copy()

    # label/taint fit of a pod-group against the existing nodes, memoized as
    # ONE boolean vector per distinct group spec (token-keyed): the same
    # spec recurs across most candidate lanes in a homogeneous cluster, and
    # per-(lane, node) scalar checks were the pair-sweep encode hotspot
    # (125k calls at 64 nodes, profiled round 4). Now folded over the label
    # columns (RAW labels — this path tests matches_labels(node.labels)
    # with no hostname defaulting, unlike the scheduler's effective view)
    # with each distinct interned taint set checked once, not per node.
    # HOT:BEGIN(consolidation-fit)
    alive = ~ccols.marked[rows]
    taint_codes = ccols.taint_code[rows]
    gather_cache: "dict[str, object]" = {}

    def _label_lookup(key):
        hit = gather_cache.get(key, False)
        if hit is not False:
            return hit
        kc = ccols.label_cols.get(key)
        out = None if kc is None else (kc.codes[rows], kc.num[rows], kc.vocab)
        gather_cache[key] = out
        return out

    fitvec_cache: "dict[int, np.ndarray]" = {}

    def fit_vector(spec) -> "np.ndarray":
        tok = spec.group_token()
        vec = fitvec_cache.get(tok)
        if vec is None:
            vec = fold_node_mask(spec.requirements, _label_lookup, Ne)
            for code in np.unique(taint_codes):
                taints = ccols.taint_sets[int(code)]
                if taints and not tolerates_all(spec.tolerations, taints):
                    vec = vec & (taint_codes != code)
            vec &= alive
            fitvec_cache[tok] = vec
        return vec
    # HOT:END(consolidation-fit)

    prov_overhead, prov_pods_cap = kubelet_arrays(provs, catalog)
    feas_cache: "dict[tuple, tuple]" = {}
    ex_cap_arr = None  # [C, Gb, Ne] remaining caps; built on first capped group
    # per-origin-key resident counts over ALL nodes, memoized across lanes
    # (the incremental StateNode aggregates make this O(Ne) with no pod scan)
    rc_cache: "dict[object, np.ndarray]" = {}

    def resident_vec(okey) -> "np.ndarray":
        v = rc_cache.get(okey)
        if v is None:
            v = np.fromiter(
                (cluster.nodes[n]._resident_counts.get(okey, 0)
                 for n in all_nodes), dtype=np.int32, count=Ne)
            rc_cache[okey] = v
        return v

    for ci, (cand, total_price, groups) in enumerate(per_cand):
        cheaper_opt = by_price[total_price][0]
        member_idx = [node_index[n.name] for n in cand]
        first_by_origin: "dict[object, int]" = {}
        for gi, g in enumerate(groups):
            group_origin[ci, gi] = first_by_origin.setdefault(
                g.spec.origin_key(), gi)
        for gi, g in enumerate(groups):
            gkey = (g.spec.group_token(), total_price)
            enc = feas_cache.get(gkey)
            if enc is None:
                enc = encode_group(g, provs, grid, cols, overhead,
                                   extra_mask=cheaper_opt,
                                   prov_overhead=prov_overhead,
                                   prov_pods_cap=prov_pods_cap)
                feas_cache[gkey] = enc
            vec, cap, feas, newprov = enc
            group_vec[ci, gi] = vec
            group_count[ci, gi] = g.count
            group_cap[ci, gi] = cap
            ridx = feas_row_index.get(gkey)
            if ridx is None:
                feas_rows.append(feas)
                ridx = feas_row_index[gkey] = len(feas_rows)  # 1-based
            feas_idx[ci, gi] = ridx
            group_newprov[ci, gi] = newprov
            row = ex_feas[ci, gi]
            row[:] = fit_vector(g.spec)
            row[member_idx] = False  # pods must not land back on the set
            if cap < int(INT_BIG):
                # hostname spread/anti-affinity counts pods RESIDENT on the
                # surviving nodes (mirrors encode_problem's ex_cap; the
                # in-run group_counts term is zero here — resident counts
                # come fresh off the node aggregates each sweep). Candidate
                # members keep the raw cap: their pods are the ones being
                # moved, and ex_feas already bars landing back on the set
                if ex_cap_arr is None:
                    ex_cap_arr = np.full((C, Gb, Ne), INT_BIG, dtype=np.int32)
                okey = g.spec.origin_key()
                ex_cap_arr[ci, gi, :] = np.maximum(0, cap - resident_vec(okey))
                ex_cap_arr[ci, gi, member_idx] = cap

    feas_table = np.zeros((1 + len(feas_rows), Pv, T, S), dtype=bool)
    for i, feas in enumerate(feas_rows):
        feas_table[1 + i] = feas
    inputs = PackInputs(
        alloc_t=grid.alloc_t, tiebreak=grid.tiebreak,
        group_vec=group_vec, group_count=group_count, group_cap=group_cap,
        group_feas=None,  # expanded on device from (feas_table, feas_idx)
        group_newprov=group_newprov,
        overhead=np.asarray(overhead, dtype=np.int32),
        # ex_used is IDENTICAL across lanes (a candidate's own nodes are
        # excluded via ex_feas, never via usage), so it is shared by the
        # lanes like ex_alloc: a per-lane copy at 500 lanes x 500 nodes
        # would ship ~6MB host->device per sweep
        ex_alloc=ex_alloc, ex_used=ex_used,
        ex_feas=ex_feas,
        prov_overhead=prov_overhead, prov_pods_cap=prov_pods_cap,
        ex_cap=ex_cap_arr, group_origin=group_origin,
    )
    return ConsolidationBatch(inputs, candidates, provs, grid,
                              feas_table=feas_table, feas_idx=feas_idx)


def _note_verdict(capture: "list[dict]", cand, verdict: str,
                  savings: float = 0.0, replacement=None) -> None:
    """One consolidation keep/evict verdict into the explain capture.
    `verdict` must be a reasons.CONSOLIDATION_VERDICTS literal at every
    call site."""
    total_price = sum(n.price for n in cand)
    capture.append({
        "nodes": sorted(n.name for n in cand),
        "verdict": verdict,
        "evict": verdict in ("delete", "replace"),
        "current_price_per_hour": round(total_price, 6),
        "savings_per_hour": round(savings, 6),
        "cost_delta_per_hour": round(-savings, 6),
        "replacement": replacement,
    })


# Per-pass keep/evict verdicts for the deprovisioner's consolidation
# audit record (set by _decode_actions when the explain plane is ON;
# untouched — strict-noop — when it is disabled).
last_verdicts: "list[dict] | None" = None


def _decode_actions(batch: ConsolidationBatch, verdicts, now: float
                    ) -> "list[ConsolidationAction]":
    """verdicts: [C, 3] host array — (unsched_total, n_open, decided0) per
    candidate lane (see _verdicts_flat)."""
    global last_verdicts

    capture: "list[dict] | None" = [] if explain.enabled() else None
    actions = []
    for ci, cand in enumerate(batch.candidates):
        if int(verdicts[ci, 0]) > 0:  # any pod unschedulable in this lane
            if capture is not None:
                _note_verdict(capture, cand, "unschedulable-pods")
            continue
        opened = int(verdicts[ci, 1])
        if opened > 1:
            if capture is not None:
                _note_verdict(capture, cand, "opens-more-than-one-node")
            continue
        total_price = sum(n.price for n in cand)
        cost = sum(
            disruption_cost(
                n, next((p for p in batch.provisioners
                         if p.name == n.provisioner_name), None), now)
            for n in cand)
        names = tuple(sorted(n.name for n in cand))
        if opened == 0:
            if capture is not None:
                _note_verdict(capture, cand, "delete", savings=total_price)
            actions.append(ConsolidationAction(
                "delete", names[0], cost, savings=total_price, nodes=names))
            continue
        if any(n.capacity_type == wk.CAPACITY_TYPE_SPOT for n in cand):
            # spot nodes consolidate by DELETION only — replacing with the
            # now-cheapest offering would defeat capacity-optimized spot
            # selection and raise interruption rates (reference
            # website deprovisioning.md:88; mirrored in the oracle's
            # evaluate_candidate_set)
            if capture is not None:
                _note_verdict(capture, cand, "spot-replace-barred")
            continue
        flat = int(verdicts[ci, 2])
        if flat < 0:
            raise AssertionError(
                f"candidate {names}: open claim slot has no surviving option")
        opt = batch.grid.options[flat]
        if opt.price >= total_price - REPLACE_PRICE_EPS:
            if capture is not None:
                _note_verdict(capture, cand, "no-cheaper-option")
            continue
        repl = (opt.itype.name, opt.zone, opt.capacity_type, opt.price)
        if capture is not None:
            _note_verdict(capture, cand, "replace",
                          savings=total_price - opt.price, replacement=repl)
        actions.append(ConsolidationAction(
            "replace", names[0], cost, savings=total_price - opt.price,
            replacement=repl, nodes=names))
    if capture is not None:
        last_verdicts = capture
    return actions


# device-resident catalog arrays for grid-less callers: keyed on the grid
# OBJECT (weakref — numpy arrays are not weakref-able), its seqnum and the
# device; a dead ref is a miss, never an aliasing hazard
_dev_grid_memo: "tuple | None" = None  # (weakref(grid), seqnum, device, alloc, tb)


def _dev_grid_arrays(grid: OptionGrid, device: torch.device):
    global _dev_grid_memo
    m = _dev_grid_memo
    if m is not None and m[0]() is grid and m[1] == grid.seqnum \
            and m[2] == device:
        return m[3], m[4]
    dev_alloc = torch.from_numpy(np.ascontiguousarray(
        grid.alloc_t, dtype=np.int32)).to(device)
    dev_tb = torch.from_numpy(np.ascontiguousarray(
        grid.tiebreak, dtype=np.int32)).to(device)
    _dev_grid_memo = (_weakref.ref(grid), grid.seqnum, device, dev_alloc,
                      dev_tb)
    return dev_alloc, dev_tb


def _flatten_batch(batch: ConsolidationBatch):
    """Host-side pack of every DYNAMIC leaf into two contiguous buffers
    (one i32, one u8), so the sweep ships exactly two arrays however many
    leaves the problem has: each host->device copy is an operation of its
    own. The static catalog arrays (alloc_t/tiebreak) stay device-resident
    via _dev_grid_arrays.

    Returns (i32_buf, u8_buf, dims) where dims is the shape tuple
    _verdicts_flat uses to slice the buffers back apart on the device."""
    inp = batch.inputs
    C, Gb, R = inp.group_vec.shape
    Ne = inp.ex_alloc.shape[0]
    U = batch.feas_table.shape[0]
    Pv, T, S = batch.feas_table.shape[1:]
    i32_parts = [inp.group_vec, inp.group_count, inp.group_cap,
                 inp.group_newprov, inp.group_origin, inp.overhead,
                 inp.ex_alloc, inp.ex_used, batch.feas_idx]
    if inp.ex_cap is not None:
        i32_parts.append(inp.ex_cap)
    if inp.prov_overhead is not None:
        i32_parts.append(inp.prov_overhead)
    if inp.prov_pods_cap is not None:
        i32_parts.append(inp.prov_pods_cap)
    i32 = np.concatenate(
        [np.ascontiguousarray(a, dtype=np.int32).ravel() for a in i32_parts])
    u8 = np.concatenate(
        [np.ascontiguousarray(inp.ex_feas, dtype=np.uint8).ravel(),
         np.ascontiguousarray(batch.feas_table, dtype=np.uint8).ravel()])
    dims = (C, Gb, R, Ne, U, Pv, T, S,
            inp.ex_cap is not None, inp.prov_overhead is not None,
            inp.prov_pods_cap is not None)
    return i32, u8, dims


def _verdicts_flat(i32: torch.Tensor, u8: torch.Tensor, alloc_t: torch.Tensor,
                   tiebreak: torch.Tensor, dims: tuple, n_slots: int,
                   n_eff: int) -> torch.Tensor:
    """Device-side unpack of _flatten_batch's two buffers, then the lane
    pack reduced to the [C, 3] int32 verdict table. The slices are views
    of the two uploads; the u8 -> bool casts and the feas_table/feas_idx
    gather run on the device. `n_eff` is the host's trip count
    (n_eff_of(batch.inputs.group_count)). Port of karpenter_tpu/ops/
    consolidate.py::_verdicts_flat."""
    (C, Gb, R, Ne, U, Pv, T, S, has_excap, has_povh, has_pcap) = dims
    o = 0

    def take(shape):
        nonlocal o
        n = int(np.prod(shape))
        part = i32[o:o + n]
        o += n
        return part.view(shape)

    fields = {
        "alloc_t": alloc_t, "tiebreak": tiebreak,
        "group_vec": take((C, Gb, R)), "group_count": take((C, Gb)),
        "group_cap": take((C, Gb)), "group_newprov": take((C, Gb)),
        "group_origin": take((C, Gb)), "overhead": take((R,)),
        "ex_alloc": take((Ne, R)), "ex_used": take((Ne, R)),
    }
    feas_idx = take((C, Gb))
    fields["ex_cap"] = take((C, Gb, Ne)) if has_excap else None
    fields["prov_overhead"] = take((Pv, R)) if has_povh else None
    fields["prov_pods_cap"] = take((Pv, T)) if has_pcap else None
    # layout drift guard: an array added to _flatten_batch without the
    # matching take() here would read shifted values that still reshape
    if o != i32.shape[0]:
        raise ValueError(f"i32 layout drift: consumed {o} of {i32.shape[0]}")
    if u8.shape[0] != C * Gb * Ne + U * Pv * T * S:
        raise ValueError(f"u8 layout drift: {u8.shape[0]} != "
                         f"{C * Gb * Ne + U * Pv * T * S}")
    fields["ex_feas"] = u8[:C * Gb * Ne].view(C, Gb, Ne).bool()
    feas_table = u8[C * Gb * Ne:].view(U, Pv, T, S).bool()
    fields["group_feas"] = feas_table[feas_idx.long()]
    inputs = lane_inputs_from_numpy(fields, i32.device)
    return reduce_verdicts(pack_lanes(inputs, n_slots, n_eff))


def _verdicts(batch: ConsolidationBatch, device: torch.device,
              timings: "dict | None" = None, mesh=None) -> np.ndarray:
    """The sweep's device work for one batch: two uploads, the lane pack,
    one read of the [C, 3] verdict table; or, with a lane mesh, the
    candidate lanes sharded over its ranks (pure data parallelism — see
    parallel/sharded.py make_lane_mesh), whose uploads, packs, assembly
    and read are one call, timed as its dispatch."""
    t0 = _time.perf_counter()
    if mesh is not None:
        from ..parallel.sharded import sharded_consolidation_verdicts

        out = sharded_consolidation_verdicts(
            batch.inputs, N_SLOTS, mesh, feas_table=batch.feas_table,
            feas_idx=batch.feas_idx, device=device)
        if timings is not None:
            timings.update({
                "flatten_ms": 0.0, "put_ms": 0.0,
                "dispatch_ms": (_time.perf_counter() - t0) * 1000,
                "fetch_ms": 0.0,
                "steps": n_eff_of(batch.inputs.group_count),
            })
        return out
    i32, u8, dims = _flatten_batch(batch)
    n_eff = n_eff_of(batch.inputs.group_count)
    dev_alloc, dev_tb = _dev_grid_arrays(batch.grid, device)
    t1 = _time.perf_counter()
    dev_i32 = torch.from_numpy(i32).to(device)
    dev_u8 = torch.from_numpy(u8).to(device)
    t2 = _time.perf_counter()
    flat = _verdicts_flat(dev_i32, dev_u8, dev_alloc, dev_tb, dims, N_SLOTS,
                          n_eff)
    t3 = _time.perf_counter()
    out = flat.cpu().numpy()
    if timings is not None:
        t4 = _time.perf_counter()
        timings.update({
            "flatten_ms": (t1 - t0) * 1000,
            "put_ms": (t2 - t1) * 1000,
            "dispatch_ms": (t3 - t2) * 1000,
            "fetch_ms": (t4 - t3) * 1000,
            "steps": n_eff,
        })
    return out


def _candidate_sets(cluster, provisioners, now, multi_node,
                    max_pair_candidates, candidate_filter, cand_nodes):
    """The sweep's candidate sets in lane order: pairs (the multi-node
    mechanism, which decides first) then singles; None when no node is a
    candidate."""
    provs_sorted = sorted(provisioners, key=lambda p: (-p.weight, p.name))
    if cand_nodes is None:
        cand_nodes = [cluster.nodes[name] for name in sorted(cluster.nodes)
                      if eligible(cluster.nodes[name], cluster)
                      and (candidate_filter is None
                           or candidate_filter(cluster.nodes[name]))]
    else:
        cand_nodes = list(cand_nodes)
    if not cand_nodes:
        return None
    sets: "list[tuple]" = [(n,) for n in cand_nodes]
    if multi_node:
        sets = candidate_pairs(cluster, provs_sorted, now,
                               max_pair_candidates, nodes=cand_nodes) + sets
    return sets


def _best(actions: "list[ConsolidationAction]"
          ) -> Optional[ConsolidationAction]:
    """Mechanism precedence (a multi-node action shadows a single-node
    one), then the least disruption cost."""
    if not actions:
        return None
    multi_actions = [a for a in actions if len(a.nodes) > 1]
    return min(multi_actions or actions, key=ConsolidationAction.sort_key)


def run_consolidation(
    cluster: ClusterState,
    catalog: Catalog,
    provisioners: Sequence[Provisioner],
    daemon_overhead: Optional[Sequence[int]] = None,
    now: float = 0.0,
    grid: Optional[OptionGrid] = None,
    multi_node: bool = True,
    max_pair_candidates: int = MAX_PAIR_CANDIDATES,
    candidate_filter=None,
    mesh=None,
    cand_nodes: "Optional[Sequence[StateNode]]" = None,
    device: "str | torch.device | None" = None,
) -> Optional[ConsolidationAction]:
    """Batched equivalent of the oracle search.

    Mechanism order matches the reference (deprovisioning.md:74-77,
    v0.24.0): MULTI-NODE pairs decide before single-node — a bigger win
    shadows a smaller one. Pair lanes and single lanes ride ONE lane pack
    and one read; mechanism precedence is applied to the decoded verdicts.
    `cand_nodes` reuses an eligibility sweep already done; with `mesh` (a
    lane mesh, parallel/sharded.make_lane_mesh) the lanes shard over its
    ranks."""
    device = resolve_device(device)
    t0 = _time.perf_counter()
    sets = _candidate_sets(cluster, provisioners, now, multi_node,
                           max_pair_candidates, candidate_filter, cand_nodes)
    if sets is None:
        return None
    return _one_shot(cluster, catalog, provisioners, daemon_overhead, now,
                     grid, sets, device, t0, {}, mesh=mesh)


def _one_shot(cluster, catalog, provisioners, daemon_overhead, now, grid,
              sets, device, t0, timings, mesh=None):
    """run_consolidation from its candidate sets on: one C-lane encode, one
    lane pack, one decode. `timings` starts the sweep's timings dict."""
    global last_timings, last_verdict_table
    batch = encode_consolidation(cluster, catalog, provisioners,
                                 daemon_overhead, grid, cand_sets=sets)
    if batch is None:
        return None
    t1 = _time.perf_counter()
    verdicts = _verdicts(batch, device, timings=timings, mesh=mesh)
    t2 = _time.perf_counter()
    actions = _decode_actions(batch, verdicts, now)
    timings["encode_ms"] = (t1 - t0) * 1000
    timings["verdicts_ms"] = (t2 - t1) * 1000
    timings["decode_ms"] = (_time.perf_counter() - t2) * 1000
    timings["lanes"] = len(batch.candidates)
    TRACER.annotate(transfer_ms=timings["fetch_ms"], **timings)
    last_timings = timings
    last_verdict_table = verdicts
    return _best(actions)


STREAM_LANES_ENV = "KARPENTER_TPU_CONSOLIDATE_STREAM_LANES"
# 128 lanes a chunk: the JAX package's default (its width sweep on the
# 996-lane 500-node sweep bottomed out there on a CPU host)
DEFAULT_STREAM_LANES = 128


class _TypePrunedGrid:
    """Type-axis subset view of an OptionGrid for the streamed sweep's
    dispatch+decode: every feasibility row is already ANDed with the
    cheaper-option mask at encode (encode_group extra_mask), so types not
    cheaper than ANY candidate set's price carry all-False feasibility in
    every lane and can never be decided — slicing them off the [T, S] axis
    shrinks the pack kernel's option scan without changing any verdict.
    Exposes exactly what _dev_grid_arrays (alloc_t/tiebreak/seqnum) and
    _decode_actions (options[flat]) read; `flat` indexes PRUNED coords, so
    the options list is re-laid-out to match. Tiebreak ranks are a subset
    of the full grid's total order — relative rank among survivors is
    preserved, so min-rank picks the same option."""

    def __init__(self, grid: OptionGrid, keep_idx: np.ndarray):
        S = grid.S
        self.alloc_t = np.ascontiguousarray(grid.alloc_t[keep_idx])
        self.tiebreak = np.ascontiguousarray(grid.tiebreak[keep_idx])
        self.seqnum = grid.seqnum
        self.options = [grid.options[int(t) * S + s]
                        for t in keep_idx for s in range(S)]


def stream_lanes() -> int:
    raw = _os.environ.get(STREAM_LANES_ENV)
    if raw is None:
        return DEFAULT_STREAM_LANES
    try:
        v = int(raw)
        return v if v > 0 else DEFAULT_STREAM_LANES
    except ValueError:
        return DEFAULT_STREAM_LANES


def stream_consolidation(
    cluster: ClusterState,
    catalog: Catalog,
    provisioners: Sequence[Provisioner],
    daemon_overhead: Optional[Sequence[int]] = None,
    now: float = 0.0,
    grid: Optional[OptionGrid] = None,
    multi_node: bool = True,
    max_pair_candidates: int = MAX_PAIR_CANDIDATES,
    candidate_filter=None,
    mesh=None,
    cand_nodes: "Optional[Sequence[StateNode]]" = None,
    batch_lanes: "Optional[int]" = None,
    device: "str | torch.device | None" = None,
) -> Optional[ConsolidationAction]:
    """run_consolidation, streamed: the same candidate sets in the same
    order, encoded and packed as fixed-width chunks of `batch_lanes` lanes
    instead of one C-lane batch. Every chunk has one shape — the last
    chunk is PADDED by repeating its final set — while decode still sees
    every lane, and mechanism precedence plus min-cost selection are
    applied over the FULL action list, so the chosen action is identical
    to the one-shot sweep's."""
    device = resolve_device(device)
    t0 = _time.perf_counter()
    sets = _candidate_sets(cluster, provisioners, now, multi_node,
                           max_pair_candidates, candidate_filter, cand_nodes)
    if sets is None:
        return None
    width = batch_lanes if batch_lanes is not None else stream_lanes()
    return _streamed(cluster, catalog, provisioners, daemon_overhead, now,
                     grid, sets, width, device, t0, {}, mesh=mesh)


def _streamed(cluster, catalog, provisioners, daemon_overhead, now, grid,
              sets, width, device, t0, timings, record_every_chunk=False,
              mesh=None):
    """stream_consolidation from its candidate sets on, in chunks of
    `width` lanes. `timings` starts the sweep's timings dict. With
    `record_every_chunk`, `last_verdicts` gathers every chunk's verdicts,
    as a one-shot sweep's record holds every lane; else it keeps the last
    chunk's."""
    global last_timings, last_verdict_table, last_verdicts
    # type-axis prune, ONE shape for the whole call: types not cheaper
    # (after availability) than the PRICIEST candidate set can't be a
    # replacement for any lane — their feasibility rows are all-False by
    # the encode-time cheaper mask, so slicing them shrinks the option
    # scan with provably identical verdicts (see _TypePrunedGrid)
    full_grid = _grid_for(catalog, grid)
    max_price = max(sum(n.price for n in s) for s in sets)
    cheap_any = (full_grid.price < (max_price - REPLACE_PRICE_EPS)) \
        & full_grid.valid
    keep_t = cheap_any.any(axis=1)
    keep_idx = np.nonzero(keep_t)[0]
    pruned = (_TypePrunedGrid(full_grid, keep_idx)
              if 0 < len(keep_idx) < full_grid.T else None)
    timings.update(encode_ms=0.0, verdicts_ms=0.0, decode_ms=0.0)
    actions: "list[ConsolidationAction]" = []
    tables: "list[np.ndarray]" = []
    gathered = [] if record_every_chunk and explain.enabled() else None
    chunks = steps = 0
    for start in range(0, len(sets), width):
        chunk = sets[start:start + width]
        live = len(chunk)
        if len(chunk) < width and chunks > 0:
            # pad to the chunk width (duplicate verdicts are dropped
            # below); a single undersized chunk (C <= width) just runs
            # at its natural size
            chunk = chunk + [chunk[-1]] * (width - len(chunk))
        tc0 = _time.perf_counter()
        batch = encode_consolidation(cluster, catalog, provisioners,
                                     daemon_overhead, full_grid,
                                     cand_sets=chunk)
        tc1 = _time.perf_counter()
        if batch is None:
            continue
        if pruned is not None \
                and not batch.feas_table[:, :, ~keep_t, :].any():
            # safety net: a feasible bit on a pruned type (can't happen
            # while encode applies the cheaper mask) packs this chunk on
            # the full grid instead of silently mis-decoding
            batch.feas_table = np.ascontiguousarray(
                batch.feas_table[:, :, keep_t, :])
            batch.inputs = batch.inputs._replace(
                alloc_t=pruned.alloc_t, tiebreak=pruned.tiebreak)
            batch.grid = pruned
        chunk_timings: dict = {}
        verdicts = _verdicts(batch, device, timings=chunk_timings,
                             mesh=mesh)
        steps += chunk_timings["steps"]
        tc2 = _time.perf_counter()
        # decode walks batch.candidates by lane index: truncating to the
        # live prefix skips the padded lanes' (duplicate) verdict rows
        batch.candidates = batch.candidates[:live]
        tables.append(verdicts[:live])
        actions.extend(_decode_actions(batch, verdicts, now))
        if gathered is not None:
            gathered.extend(last_verdicts)
        timings["encode_ms"] += (tc1 - tc0) * 1000
        timings["verdicts_ms"] += (tc2 - tc1) * 1000
        timings["decode_ms"] += (_time.perf_counter() - tc2) * 1000
        chunks += 1
    timings["lanes"] = len(sets)
    timings["chunks"] = chunks
    timings["steps"] = steps  # pack steps, summed over the chunks
    timings["stream_width"] = width
    timings["total_ms"] = (_time.perf_counter() - t0) * 1000
    timings["pruned_types"] = None if pruned is None else len(keep_idx)
    TRACER.annotate(streamed=True, **timings)
    last_timings = timings
    last_verdict_table = np.concatenate(tables) if tables else None
    if gathered is not None:
        last_verdicts = gathered
    return _best(actions)


# device bytes the one-shot sweep holds per (lane, group, existing node):
# ex_feas as uploaded (u8) and as cast (bool), ex_cap, ex_placed and
# ex_assign (int32 each)
_CELL_BYTES = 14
# the one-shot sweep runs while its estimate is at most this share of the
# device's free memory: the pack step's temporaries come on top of it
_FIT_SHARE = 0.5


def one_shot_bytes(sets, n_existing: int, n_provs: int,
                   grid: OptionGrid) -> int:
    """Estimate of the device bytes run_consolidation's lane pack holds for
    the candidate `sets`: per lane, the [G, Ne] leaves, four int32 [Ne, R]
    rows (the existing nodes' usage and its quotients) and the gathered
    [G, Pv, T, S] feasibility. G is bounded by the largest set's pod count,
    since a group holds at least one pod."""
    g = max(1, max(sum(len(n.non_daemon_pods()) for n in s) for s in sets))
    per_lane = (g * n_existing * _CELL_BYTES
                + 16 * n_existing * wk.NUM_RESOURCES
                + g * n_provs * grid.T * grid.S)
    return len(sets) * per_lane


def device_free_bytes(device: torch.device) -> "int | None":
    """Bytes a sweep may still take on `device`: the card's free memory
    plus what PyTorch's allocator holds cached but unused; on the CPU the
    host's available memory, or None where the platform does not say."""
    if device.type == "cuda":
        free, _total = torch.cuda.mem_get_info(device)
        return (free + torch.cuda.memory_reserved(device)
                - torch.cuda.memory_allocated(device))
    try:
        return _os.sysconf("SC_AVPHYS_PAGES") * _os.sysconf("SC_PAGE_SIZE")
    except (ValueError, OSError, AttributeError):
        return None


def sweep_consolidation(
    cluster: ClusterState,
    catalog: Catalog,
    provisioners: Sequence[Provisioner],
    daemon_overhead: Optional[Sequence[int]] = None,
    now: float = 0.0,
    grid: Optional[OptionGrid] = None,
    multi_node: bool = True,
    max_pair_candidates: int = MAX_PAIR_CANDIDATES,
    candidate_filter=None,
    cand_nodes: "Optional[Sequence[StateNode]]" = None,
    device: "str | torch.device | None" = None,
    record_last_chunk: bool = False,
) -> Optional[ConsolidationAction]:
    """The deprovisioning controller's sweep: run_consolidation's one
    C-lane pack while one_shot_bytes fits in half of device_free_bytes,
    else stream_consolidation's chunks of stream_lanes() lanes; the action
    is the same either way. The JAX package streams whenever its
    incremental plane is on, so that its compiled program keeps one shape;
    a CUDA launch needs no fixed shape and the one-shot sweep is the faster
    one on the card, so here memory alone decides. `last_timings` carries
    the estimate and the free bytes it was held against.

    `record_last_chunk` makes `last_verdicts` what the JAX streamed sweep
    leaves there: the verdicts of the lanes in its last chunk of
    stream_lanes() lanes (the controller asks for it while the incremental
    plane is on, when the JAX rung streams). Without it the record holds
    every lane, as the JAX one-shot sweep's does, however the sweep ran."""
    global last_verdicts
    device = resolve_device(device)
    t0 = _time.perf_counter()
    sets = _candidate_sets(cluster, provisioners, now, multi_node,
                           max_pair_candidates, candidate_filter, cand_nodes)
    if sets is None:
        return None
    grid = _grid_for(catalog, grid)
    need = one_shot_bytes(sets, len(cluster.nodes), len(provisioners), grid)
    free = device_free_bytes(device)
    sized = {"one_shot_bytes": need, "free_bytes": free}
    if free is not None and need > _FIT_SHARE * free:
        return _streamed(cluster, catalog, provisioners, daemon_overhead,
                         now, grid, sets, stream_lanes(), device, t0, sized,
                         record_every_chunk=not record_last_chunk)
    before = last_verdicts
    action = _one_shot(cluster, catalog, provisioners, daemon_overhead, now,
                       grid, sets, device, t0, sized)
    if record_last_chunk and last_verdicts is not before \
            and last_verdicts is not None:
        # one capture entry per lane, in lane order: the streamed sweep's
        # last chunk starts at the last multiple of its width
        width = stream_lanes()
        last_verdicts = last_verdicts[(len(sets) - 1) // width * width:]
    return action
