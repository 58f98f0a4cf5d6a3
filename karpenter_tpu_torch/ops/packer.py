"""FFD bin-packing on the device, in PyTorch, for L problems at once.

Port of karpenter_tpu/ops/packer.py (the JAX pack program), together with
the batch axis that jax.vmap gives it in solve_many waves
(karpenter_tpu/solver/core.py::_wave_pack_flat) and in the consolidation
sweep (karpenter_tpu/ops/consolidate.py::_batched_pack). The semantics, the
state and the flat int32 result layout are the JAX package's; only the
idiom changes:

* The pack is written with a native leading lane axis: every PackInputs
  leaf is [L, ...], either per lane or a view shared by every lane
  (`expand`, lane stride 0), and every state tensor is per lane. One
  problem is L = 1 of the same code (pack_flat), so a single
  solve enqueues exactly the kernels it did before the lane axis.
* The scan over pod groups is a Python loop over range(n_eff), where n_eff
  (one past the last group holding pods in ANY lane) is computed on the
  host from the numpy group counts before the upload. A lane whose own
  groups end earlier steps through count-0 rows, which are exact identity
  steps, as the vmapped fori_loop of the JAX package makes them. Inside the
  loop nothing reads a device value back: n_open, n_new and the other
  per-lane scalars stay [L] device tensors, so a pack pays one device sync,
  at the final read.
* Step 2, the open-claim fill, is ops/open_claim.OpenClaimFill, made once
  per pack so that a step pays no argument checks: on a CUDA device two
  launches of a hand-written kernel over every lane (the redesign of K1,
  whose [L, N, T] quotient never reaches device memory), on the CPU the
  plain tensor code. Steps 1 and 3 stay tensor code: their [Ne]
  and [T] quotients are small, and plain XLA in the JAX package.
* Integer floor division is exact in torch, so the JAX package's
  XLA:CPU division workaround (_floor_div) has no counterpart here, and
  the quotient needs no value gate.
* Carried state (claim_placed, ex_placed, the result rows, and step 2's
  used and optmask) is updated in place, which saves an allocation per
  step; every read of a row happens before the row's update, as in the JAX
  step. Every sum names dtype=torch.int32: torch would promote an int32 sum
  to int64, and JAX keeps int32.
* The same step runs on one rank of a multi-rank mesh
  (parallel/sharded.py), given the mesh: the state then holds the rank's
  node slice and the inputs its type slice. Step 2 splits around two
  collectives (the row max over the types axis, the fill over the nodes
  axis), step 3 reduces kstar over the types axis, and the end takes the
  first minimum over every rank's types and gathers the node slices.
  Without a mesh none of this runs, and a step keeps its two launches.

Layout of one problem's flat buffer (flatten_result gives one per lane):
    [assign (G*N) | ex_assign (G*Ne) | unsched (G) | active (N) |
     nprov (N) | decided (N) | n_open (1)]
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..apis import wellknown as wk
from .open_claim import (OpenClaimFill, _waterfall, claim_fill,
                         open_claim_workspace, placed_used)
from .quotient import INT_BIG, _pods_cap_quotient, _quotient, type_major

_PODS_I = wk.RESOURCE_INDEX[wk.RESOURCE_PODS]
_I32 = torch.int32
_LOW32 = (1 << 32) - 1

# the axes of a pack mesh (parallel/sharded.py): node-claim slots, types
AXIS_NODES = "nodes"
AXIS_TYPES = "types"


class PackInputs(NamedTuple):
    """One problem's leaves (the shapes below), or L problems' with a
    leading lane axis on every leaf (lane_inputs_from_numpy)."""

    # catalog (device-resident)
    alloc_t: torch.Tensor    # i32 [T, R]
    tiebreak: torch.Tensor   # i32 [T, S] (INT_BIG where no valid offering)
    # groups (FFD-sorted)
    group_vec: torch.Tensor      # i32 [G, R]
    group_count: torch.Tensor    # i32 [G]
    group_cap: torch.Tensor      # i32 [G] per-node cap (INT_BIG if none)
    group_feas: torch.Tensor     # bool [G, Pv, T, S]
    group_newprov: torch.Tensor  # i32 [G] (-1 => no provisioner admits)
    overhead: torch.Tensor       # i32 [R]
    # existing nodes
    ex_alloc: torch.Tensor   # i32 [Ne, R]
    ex_used: torch.Tensor    # i32 [Ne, R]
    ex_feas: torch.Tensor    # bool [G, Ne]
    # optional leaves, None when not in play (see karpenter_tpu/ops/packer.py
    # PackInputs for each one's meaning)
    prov_overhead: Optional[torch.Tensor] = None  # i32 [Pv, R]
    prov_pods_cap: Optional[torch.Tensor] = None  # i32 [Pv, T]
    ex_cap: Optional[torch.Tensor] = None         # i32 [G, Ne]
    group_origin: Optional[torch.Tensor] = None   # i32 [G]
    res_sel: Optional[torch.Tensor] = None        # i32 [Rb]
    res_mask: Optional[torch.Tensor] = None       # bool [Rb]


_BOOL_FIELDS = frozenset({"group_feas", "ex_feas", "res_mask"})
# rank of each leaf for one problem; a batch adds the lane axis
_RANK = {"alloc_t": 2, "tiebreak": 2, "group_vec": 2, "group_count": 1,
         "group_cap": 1, "group_feas": 4, "group_newprov": 1, "overhead": 1,
         "ex_alloc": 2, "ex_used": 2, "ex_feas": 2, "prov_overhead": 2,
         "prov_pods_cap": 2, "ex_cap": 2, "group_origin": 1, "res_sel": 1,
         "res_mask": 1}


class PackState(NamedTuple):
    used: torch.Tensor      # i32 [L, N, R]
    optmask: torch.Tensor   # bool [L, N, T, S]
    nprov: torch.Tensor     # i32 [L, N]
    active: torch.Tensor    # bool [L, N]
    n_open: torch.Tensor    # i32 [L]
    ex_used: torch.Tensor   # i32 [L, Ne, R]
    # in-run pods placed per (origin row, node), updated in place
    ex_placed: torch.Tensor     # i32 [L, G, Ne]
    claim_placed: torch.Tensor  # i32 [L, G, N]


class PackResult(NamedTuple):
    """One problem's result (the shapes below), or L problems' with a
    leading lane axis (pack_lanes)."""

    assign: "torch.Tensor | np.ndarray"      # i32 [G, N]
    ex_assign: "torch.Tensor | np.ndarray"   # i32 [G, Ne]
    unsched: "torch.Tensor | np.ndarray"     # i32 [G]
    used: "torch.Tensor | np.ndarray"        # i32 [N, R]
    active: "torch.Tensor | np.ndarray"      # bool [N]
    nprov: "torch.Tensor | np.ndarray"       # i32 [N]
    decided: "torch.Tensor | np.ndarray"     # i32 [N] flat option id t*S+s
    n_open: "torch.Tensor | np.ndarray"      # i32 []


def _to_tensor(name: str, v, device: torch.device) -> torch.Tensor:
    dtype = torch.bool if name in _BOOL_FIELDS else _I32
    if isinstance(v, torch.Tensor):
        if v.dtype != dtype or v.device.type != device.type:
            raise ValueError(f"{name}: resident tensor is {v.dtype} on "
                             f"{v.device}, want {dtype} on {device}")
        return v
    a = np.ascontiguousarray(v, dtype=bool if dtype is torch.bool
                             else np.int32)
    if not a.flags.writeable:  # torch.from_numpy wants a writable buffer
        a = a.copy()
    return torch.from_numpy(a).to(device)


def pack_inputs_from_numpy(fields: dict, device) -> PackInputs:
    """PackInputs of tensors on `device` from a mapping of host arrays —
    the port's build_pack_inputs fields, or the JAX package's PackInputs
    (`inputs._asdict()` of karpenter_tpu.solver.core.build_pack_inputs,
    whose leaves are numpy arrays). None leaves stay None; masks become
    bool and everything else int32. A leaf that is already a tensor on
    `device` (the resident catalog arrays) is used as it is."""
    device = torch.device(device)
    return PackInputs(**{
        name: None if fields.get(name) is None
        else _to_tensor(name, fields[name], device)
        for name in PackInputs._fields})


def lane_inputs_from_numpy(fields: dict, device, feas_table=None,
                           feas_idx=None) -> PackInputs:
    """pack_inputs_from_numpy for a batch of L problems: -> PackInputs with
    a leading lane axis on every leaf. A leaf of one problem's rank is
    shared by the lanes and becomes an `expand`ed view of one upload; a leaf
    with a leading lane axis is per lane. So `fields` may be the port's
    _stack_pack_inputs result, the JAX package's (`_stack_pack_inputs(...)
    ._asdict()`, shared alloc_t/tiebreak) or a JAX ConsolidationBatch's
    `inputs._asdict()` (shared catalog, overhead, existing-node and kubelet
    leaves). With (feas_table [U, Pv, T, S], feas_idx [L, G]) and no
    group_feas, the lanes' feasibility is gathered from the table on the
    device, as consolidation ships it."""
    device = torch.device(device)
    L = int(np.shape(fields["group_count"])[0])
    out = {}
    for name in PackInputs._fields:
        v = fields.get(name)
        if name == "group_feas" and v is None and feas_table is not None:
            table = _to_tensor(name, feas_table, device)
            idx = torch.from_numpy(np.asarray(feas_idx, np.int64)).to(device)
            out[name] = table[idx]
            continue
        if v is None:
            out[name] = None
            continue
        t = _to_tensor(name, v, device)
        if t.dim() == _RANK[name]:
            t = t.expand(L, *t.shape)
        elif t.dim() != _RANK[name] + 1 or t.shape[0] != L:
            raise ValueError(f"{name}: shape {tuple(t.shape)} is neither one "
                             f"problem's nor {L} lanes'")
        out[name] = t
    return PackInputs(**out)


def as_lanes(inputs: PackInputs) -> PackInputs:
    """One problem's PackInputs as L = 1 of a batch (views, no copies)."""
    return PackInputs(*(None if v is None else v[None] for v in inputs))


def n_eff_of(group_count: np.ndarray) -> int:
    """One past the last group row holding pods (in any lane, for [L, G]
    counts): the pack's trip count. A count=0 row is an exact identity
    step, so the loop stops there and bucket padding costs memory, not
    steps."""
    live = np.asarray(group_count) > 0
    if live.ndim > 1:
        live = live.any(axis=0)
    nz = np.flatnonzero(live)
    return int(nz[-1]) + 1 if nz.size else 0


def _shared(x: torch.Tensor) -> bool:
    """Whether every lane of x is the same memory (one lane, or stride 0)."""
    return x.shape[0] == 1 or x.stride(0) == 0


def _type_major(alloc_t: torch.Tensor) -> torch.Tensor:
    """[L, T, R] with each lane laid out [R, T] (open_claim_fill's layout);
    a shared alloc_t stays one copy."""
    if _shared(alloc_t):
        return type_major(alloc_t[0]).expand(alloc_t.shape)
    return alloc_t.transpose(1, 2).contiguous().transpose(1, 2)


class _Loop(NamedTuple):
    """Per-pack constants of the step loop, made once before it."""

    alloc_t: torch.Tensor     # i32 [L, T, R] active columns, any layout
    origin: torch.Tensor      # i64 [G, L] origin row per group and lane
    origin_flat: torch.Tensor  # i64 [G, L] its row in the [L*G, ...] views
    newprov: torch.Tensor     # i64 [G, L] group_newprov, as an index
    lane_idx: torch.Tensor    # i64 [L]
    slot_idx: torch.Tensor    # i32 [N] every slot, a mesh rank's included
    pods_i: int               # pods column in the (compressed) layout
    fill: OpenClaimFill       # step 2, with its scratch on CUDA


def _make_loop(inputs: PackInputs, n_slots: int,
               n_local: Optional[int] = None) -> _Loop:
    """The per-pack constants of pack_lanes's step loop; `n_local` is the
    slots a mesh rank holds (all n_slots without a mesh)."""
    dev = inputs.group_vec.device
    L, G = inputs.group_count.shape
    alloc_t = inputs.alloc_t
    if inputs.res_sel is not None:
        # gather each lane's active resource columns out of the full-width
        # resident catalog array once per pack; padding lanes are zeroed so
        # they stay INT_BIG no-ops in every quotient
        sel, mask = inputs.res_sel, inputs.res_mask
        T = alloc_t.shape[1]
        idx = sel.long()[:, None, :].expand(L, T, sel.shape[1])
        alloc_t = torch.where(mask[:, None, :],
                              torch.gather(alloc_t, 2, idx), 0)
    lane_idx = torch.arange(L, device=dev)
    origin = (torch.arange(G, device=dev)[:, None].expand(G, L)
              if inputs.group_origin is None
              else inputs.group_origin.t().long()).contiguous()
    # pods column: 0 in the compressed layout (res_sel pins it there), the
    # wellknown index in the full-width layout
    pods_i = 0 if inputs.res_sel is not None else _PODS_I
    return _Loop(
        alloc_t=alloc_t, origin=origin,
        origin_flat=origin if L == 1 else origin + lane_idx[None, :] * G,
        newprov=inputs.group_newprov.t().long().contiguous(),
        lane_idx=lane_idx,
        slot_idx=torch.arange(n_slots, dtype=_I32, device=dev),
        pods_i=pods_i,
        fill=OpenClaimFill(
            _type_major(alloc_t), inputs.prov_pods_cap, pods_i,
            open_claim_workspace(n_slots if n_local is None else n_local,
                                 dev, L)
            if dev.type == "cuda" else None))


def _split_fill(loop: _Loop, args: tuple, mesh, n0: int, N: int):
    """Step 2 on a mesh rank, whose slots are [n0, n0 + N_local) of N:
    launch 1 in its row-max mode, then (i) the row max over the types
    axis; the fill into a zeroed row of every slot, then (ii) its sum over
    the nodes axis, so each rank runs the single card's waterfall on the
    whole row (summing only each rank's fill total would give the prefix,
    but not the pods placed, whose int32 sum wraps slot by slot); the used
    update, then launch 2. -> (m [L, N_local], rem after [L])."""
    vec, cap, _, og, claim_placed, used, _, _, _, rem = args
    qmax = loop.fill.rowmax(*args)                                   # [L, Nl]
    mesh.all_reduce(qmax, "max", AXIS_TYPES)
    L, Nl = qmax.shape
    fill = torch.zeros((L, N), dtype=_I32, device=qmax.device)
    fill[:, n0:n0 + Nl] = claim_fill(qmax, cap, og, claim_placed)
    mesh.all_reduce(fill, "sum", AXIS_NODES)
    m_all = _waterfall(rem, fill)                                    # [L, N]
    m_n = m_all[:, n0:n0 + Nl].contiguous()
    used.copy_(placed_used(used, vec, m_n))
    loop.fill.apply(*args, m_n)
    return m_n, rem - m_all.sum(dim=-1, dtype=_I32)


def _step(inputs: PackInputs, loop: _Loop, state: PackState, g: int,
          mesh=None, n0: int = 0):
    """Pack step g in every lane: -> (new state, (assign row [L, N_local],
    ex_assign row [L, Ne], unsched [L])). On a mesh rank the state holds
    slots [n0, n0 + N_local) and the inputs the rank's type slice; without
    a mesh N_local is every slot and n0 is 0."""
    vec = inputs.group_vec[:, g]       # [L, R]
    cap = inputs.group_cap[:, g]       # [L]
    count = inputs.group_count[:, g]   # [L]
    og = loop.origin[g]                # [L] origin row of this group
    ogf = loop.origin_flat[g]          # [L] its row in the [L*G, ...] views
    L, G, Ne = state.ex_placed.shape
    Nl = state.active.shape[1]
    N = loop.slot_idx.shape[0]

    # ---- 1) existing nodes (replicated on every mesh rank) -------------------
    q_ex = _quotient(inputs.ex_alloc - state.ex_used, vec[:, None, :])  # [L, Ne]
    cap_ex = cap[:, None] if inputs.ex_cap is None else inputs.ex_cap[:, g]
    ex_placed = state.ex_placed.view(L * G, Ne)
    cap_ex = cap_ex - ex_placed.index_select(0, ogf)
    fill_ex = torch.clamp(torch.minimum(q_ex, cap_ex), 0, INT_BIG)
    fill_ex = torch.where(inputs.ex_feas[:, g], fill_ex, 0)
    m_ex = _waterfall(count, fill_ex)                                # [L, Ne]
    ex_used = state.ex_used + m_ex[:, :, None] * vec[:, None, :]
    ex_placed.index_add_(0, ogf, m_ex)
    rem = count - m_ex.sum(dim=-1, dtype=_I32)

    # ---- 2) open claims, first-fit in creation order -------------------------
    gf = inputs.group_feas[:, g]                                     # [L, Pv, T, S]
    used, optmask = state.used, state.optmask      # updated in place below
    args = (vec, cap, gf, og, state.claim_placed, used, optmask, state.nprov,
            state.active, rem)
    if mesh is None:
        m_n, rem = loop.fill(*args)                                  # [L, N], [L]
    else:
        m_n, rem = _split_fill(loop, args, mesh, n0, N)              # [L, Nl], [L]

    # ---- 3) bulk-open fresh nodes --------------------------------------------
    pods_i = loop.pods_i
    p = inputs.group_newprov[:, g]                                   # [L]
    p1 = torch.clamp(loop.newprov[g], min=0)                         # [L] i64
    lane = loop.lane_idx
    freshfeas = gf[lane, p1] & (p >= 0)[:, None, None]               # [L, T, S]
    ovh = inputs.overhead                                            # [L, R]
    if inputs.prov_overhead is not None:
        ovh = ovh + inputs.prov_overhead[lane, p1]
    q0 = _quotient(loop.alloc_t - ovh[:, None, :], vec[:, None, :])  # [L, T]
    if inputs.prov_pods_cap is not None:
        cap_t = inputs.prov_pods_cap[lane, p1]                       # [L, T]
        q0 = torch.minimum(q0, _pods_cap_quotient(
            cap_t - ovh[:, pods_i:pods_i + 1], vec[:, pods_i:pods_i + 1]))
    kstar = torch.where(freshfeas, q0[:, :, None], 0).amax(dim=(1, 2))  # [L]
    if mesh is not None:
        mesh.all_reduce(kstar, "max", AXIS_TYPES)                    # (iii)
    kstar = torch.clamp(torch.minimum(kstar, cap), 0, INT_BIG)
    n_new = torch.where(
        kstar > 0,
        torch.div(rem + kstar - 1, torch.clamp(kstar, min=1),
                  rounding_mode="floor"),
        0)
    n_new = torch.minimum(n_new, N - state.n_open)  # overflow -> unschedulable
    placed_new = torch.where(n_new > 0, (n_new - 1) * kstar, 0)
    last_cnt = torch.minimum(torch.clamp(rem - placed_new, min=0), kstar)

    idx = loop.slot_idx                                              # [N]
    n_open = state.n_open[:, None]
    in_all = (idx >= n_open) & (idx < n_open + n_new[:, None])       # [L, N]
    cnt_all = torch.where(idx == n_open + n_new[:, None] - 1,
                          last_cnt[:, None], kstar[:, None])
    cnt_all = torch.where(in_all, cnt_all, 0)                        # [L, N]
    in_range = in_all[:, n0:n0 + Nl]                                 # [L, Nl]
    cnt = cnt_all[:, n0:n0 + Nl]
    fresh_used = ovh[:, None, :] + cnt[:, :, None] * vec[:, None, :]
    used = torch.where(in_range[:, :, None], fresh_used, used)
    fresh_mask = freshfeas[:, None] & (q0[:, None, :]
                                       >= cnt[:, :, None])[:, :, :, None]
    optmask = torch.where(in_range[:, :, None, None], fresh_mask, optmask)
    active = state.active | in_range
    nprov = torch.where(in_range, p[:, None], state.nprov)
    n_open = state.n_open + n_new
    unsched = rem - cnt_all.sum(dim=-1, dtype=_I32)

    row_n = m_n + cnt
    state.claim_placed.view(L * G, Nl).index_add_(0, ogf, row_n)
    new_state = PackState(used, optmask, nprov, active, n_open, ex_used,
                          state.ex_placed, state.claim_placed)
    return new_state, (row_n, m_ex, unsched)


def pack_lanes(inputs: PackInputs, n_slots: int, n_eff: int,
               mesh=None) -> PackResult:
    """Run the pack of L problems (leading lane axis on every leaf) over
    groups [0, n_eff): -> PackResult with a leading lane axis. Rows past
    n_eff must hold no pods in any lane (n_eff_of computes it from the host
    group counts). On a rank of a pack mesh (parallel/sharded.py) `inputs`
    hold the rank's type slice, and the whole result comes back on every
    rank."""
    dev = inputs.group_vec.device
    L, G, R = inputs.group_vec.shape
    T, S = inputs.tiebreak.shape[1:]
    Ne = inputs.ex_alloc.shape[1]
    n0, n1 = (0, n_slots) if mesh is None else mesh.node_bounds(n_slots)
    Nl = n1 - n0
    loop = _make_loop(inputs, n_slots, Nl)
    state = PackState(
        used=torch.zeros((L, Nl, R), dtype=_I32, device=dev),
        optmask=torch.zeros((L, Nl, T, S), dtype=torch.bool, device=dev),
        nprov=torch.full((L, Nl), -1, dtype=_I32, device=dev),
        active=torch.zeros((L, Nl), dtype=torch.bool, device=dev),
        n_open=torch.zeros((L,), dtype=_I32, device=dev),
        ex_used=inputs.ex_used,
        ex_placed=torch.zeros((L, G, Ne), dtype=_I32, device=dev),
        claim_placed=torch.zeros((L, G, Nl), dtype=_I32, device=dev),
    )
    assign = torch.zeros((L, G, n_slots), dtype=_I32, device=dev)
    ex_assign = torch.zeros((L, G, Ne), dtype=_I32, device=dev)
    unsched = torch.zeros((L, G), dtype=_I32, device=dev)
    for g in range(n_eff):
        state, (row_n, row_ex, row_us) = _step(inputs, loop, state, g, mesh,
                                               n0)
        assign[:, g, n0:n1] = row_n
        ex_assign[:, g] = row_ex
        unsched[:, g] = row_us

    # decision: cheapest surviving option per active claim
    rank = torch.where(state.optmask, inputs.tiebreak[:, None], INT_BIG)
    flatrank = rank.reshape(L, Nl, -1)
    best = torch.argmin(flatrank, dim=-1)  # first minimum on ties
    low = flatrank.amin(dim=-1)
    if mesh is not None:
        # the first minimum over every rank's types: (tiebreak, global flat
        # id) as one int64 key (tiebreak lies in [0, INT_BIG], so the key
        # orders exactly as argmin's first minimum on ties)
        key = (low.long() << 32) | (best + mesh.index(AXIS_TYPES) * T * S)
        mesh.all_reduce(key, "min", AXIS_TYPES)
        low, best = key >> 32, key & _LOW32
    decided = torch.where(state.active & (low < INT_BIG), best.to(_I32), -1)

    r = PackResult(
        assign=assign, ex_assign=ex_assign, unsched=unsched,
        used=state.used, active=state.active, nprov=state.nprov,
        decided=decided, n_open=state.n_open,
    )
    return r if mesh is None else _gather_slots(r, n_slots, n0, mesh)


def _gather_slots(r: PackResult, n_slots: int, n0: int, mesh) -> PackResult:
    """A mesh rank's result with the node-sliced fields (and assign, whose
    other slots are zero) summed over the nodes axis into zeroed full-size
    rows, in one all_reduce: the whole result on every rank."""
    L, G, _ = r.assign.shape
    Nl, R = r.used.shape[1:]
    parts = (r.active.to(_I32), r.nprov, r.decided, r.used.reshape(L, -1))
    full = torch.zeros((L, len(parts), n_slots * R), dtype=_I32,
                       device=r.assign.device)
    for k, v in enumerate(parts):
        width = v.shape[1] // Nl if Nl else 1
        full[:, k, n0 * width:(n0 + Nl) * width] = v
    buf = torch.cat([r.assign.reshape(L, -1), full.reshape(L, -1)], dim=1)
    mesh.all_reduce(buf, "sum", AXIS_NODES)
    full = buf[:, G * n_slots:].reshape(L, len(parts), n_slots * R)
    return r._replace(
        assign=buf[:, :G * n_slots].reshape(L, G, n_slots),
        active=full[:, 0, :n_slots] != 0, nprov=full[:, 1, :n_slots],
        decided=full[:, 2, :n_slots],
        used=full[:, 3].reshape(L, n_slots, R))


def flatten_result(r: PackResult) -> torch.Tensor:
    """Everything the decoder needs, per lane, as ONE int32 [L, F] array
    (one flat buffer per lane), so a pack pays exactly one device->host
    read."""
    L = r.assign.shape[0]
    return torch.cat([
        r.assign.reshape(L, -1), r.ex_assign.reshape(L, -1), r.unsched,
        r.active.to(_I32), r.nprov, r.decided, r.n_open[:, None],
    ], dim=1)


def pack_flat_lanes(inputs: PackInputs, n_slots: int,
                    n_eff: int) -> torch.Tensor:
    """pack_lanes + flatten_result: -> int32 [L, F], lane l's row equal to
    pack_flat of problem l alone."""
    return flatten_result(pack_lanes(inputs, n_slots, n_eff))


def pack_flat(inputs: PackInputs, n_slots: int, n_eff: int) -> torch.Tensor:
    """One problem's flat buffer [F]: the one device program of a solve."""
    return pack_flat_lanes(as_lanes(inputs), n_slots, n_eff)[0]


def reduce_verdicts(r: PackResult) -> torch.Tensor:
    """Lane PackResult -> the [L, 3] int32 verdict table of consolidation:
    (total unschedulable, nodes opened, decided option of slot 0). Port of
    karpenter_tpu/ops/consolidate.py::_reduce_verdicts."""
    return torch.stack([r.unsched.sum(dim=1, dtype=_I32), r.n_open,
                        r.decided[:, 0]], dim=1)


def unflatten_result(flat: np.ndarray, G: int, N: int, Ne: int) -> PackResult:
    """Host-side parse of the flat buffer back into PackResult (used is
    omitted — the decoder never reads it)."""
    o = 0
    assign = flat[o:o + G * N].reshape(G, N); o += G * N
    ex_assign = flat[o:o + G * Ne].reshape(G, Ne); o += G * Ne
    unsched = flat[o:o + G]; o += G
    active = flat[o:o + N].astype(bool); o += N
    nprov = flat[o:o + N]; o += N
    decided = flat[o:o + N]; o += N
    n_open = flat[o]
    return PackResult(
        assign=assign, ex_assign=ex_assign, unsched=unsched,
        used=np.zeros((0,), np.int32), active=active, nprov=nprov,
        decided=decided, n_open=n_open,
    )
