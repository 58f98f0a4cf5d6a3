"""FFD bin-packing on the device, in PyTorch.

Port of karpenter_tpu/ops/packer.py (the JAX pack program). The semantics,
the state and the flat int32 result layout are the JAX package's; only the
idiom changes:

* The scan over pod groups is a Python loop over range(n_eff), where n_eff
  (one past the last group holding pods) is computed on the host from the
  numpy group counts before the upload. Inside the loop nothing reads a
  device value back: n_open, n_new and the other scalars stay 0-d device
  tensors, so a solve pays one device sync, at the final read.
* Step 2, the open-claim fill, is ops/open_claim.open_claim_fill: on a
  CUDA device two launches of a hand-written kernel (the redesign of K1,
  whose [N, T] quotient never reaches device memory), on the CPU the plain
  tensor code. Steps 1 and 3 stay tensor code: their [Ne] and [T]
  quotients are small, and plain XLA in the JAX package.
* Integer floor division is exact in torch, so the JAX package's
  XLA:CPU division workaround (_floor_div) has no counterpart here, and
  the quotient needs no value gate.
* Carried state (claim_placed, ex_placed, the result rows, and step 2's
  used and optmask) is updated in place, which saves an allocation per
  step; every read of a row happens before the row's update, as in the JAX
  step.

Layout of the flat buffer (flatten_result):
    [assign (G*N) | ex_assign (G*Ne) | unsched (G) | active (N) |
     nprov (N) | decided (N) | n_open (1)]
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..apis import wellknown as wk
from .open_claim import _waterfall, open_claim_fill, open_claim_workspace
from .quotient import INT_BIG, _pods_cap_quotient, _quotient, type_major

_PODS_I = wk.RESOURCE_INDEX[wk.RESOURCE_PODS]
_I32 = torch.int32


class PackInputs(NamedTuple):
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


class PackState(NamedTuple):
    used: torch.Tensor      # i32 [N, R]
    optmask: torch.Tensor   # bool [N, T, S]
    nprov: torch.Tensor     # i32 [N]
    active: torch.Tensor    # bool [N]
    n_open: torch.Tensor    # i32 []
    ex_used: torch.Tensor   # i32 [Ne, R]
    # in-run pods placed per (origin row, node), updated in place
    ex_placed: torch.Tensor     # i32 [G, Ne]
    claim_placed: torch.Tensor  # i32 [G, N]


class PackResult(NamedTuple):
    assign: "torch.Tensor | np.ndarray"      # i32 [G, N]
    ex_assign: "torch.Tensor | np.ndarray"   # i32 [G, Ne]
    unsched: "torch.Tensor | np.ndarray"     # i32 [G]
    used: "torch.Tensor | np.ndarray"        # i32 [N, R]
    active: "torch.Tensor | np.ndarray"      # bool [N]
    nprov: "torch.Tensor | np.ndarray"       # i32 [N]
    decided: "torch.Tensor | np.ndarray"     # i32 [N] flat option id t*S+s
    n_open: "torch.Tensor | np.ndarray"      # i32 []


def pack_inputs_from_numpy(fields: dict, device) -> PackInputs:
    """PackInputs of tensors on `device` from a mapping of host arrays —
    the port's build_pack_inputs fields, or the JAX package's PackInputs
    (`inputs._asdict()` of karpenter_tpu.solver.core.build_pack_inputs,
    whose leaves are numpy arrays). None leaves stay None; masks become
    bool and everything else int32. A leaf that is already a tensor on
    `device` (the resident catalog arrays) is used as it is."""
    device = torch.device(device)
    out = {}
    for name in PackInputs._fields:
        v = fields.get(name)
        if v is None:
            out[name] = None
            continue
        dtype = torch.bool if name in _BOOL_FIELDS else _I32
        if isinstance(v, torch.Tensor):
            if v.dtype != dtype or v.device.type != device.type:
                raise ValueError(f"{name}: resident tensor is {v.dtype} on "
                                 f"{v.device}, want {dtype} on {device}")
            out[name] = v
            continue
        a = np.ascontiguousarray(v, dtype=bool if dtype is torch.bool
                                 else np.int32)
        if not a.flags.writeable:  # torch.from_numpy wants a writable buffer
            a = a.copy()
        out[name] = torch.from_numpy(a).to(device)
    return PackInputs(**out)


def n_eff_of(group_count: np.ndarray) -> int:
    """One past the last group row holding pods: the pack's trip count. A
    count=0 row is an exact identity step, so the loop stops there and
    bucket padding costs memory, not steps."""
    nz = np.flatnonzero(np.asarray(group_count) > 0)
    return int(nz[-1]) + 1 if nz.size else 0


class _Loop(NamedTuple):
    """Per-solve constants of the step loop, made once before it."""

    alloc_t: torch.Tensor     # i32 [T, R] active columns, any layout
    alloc_tm: torch.Tensor    # the same, type-major (open_claim_fill's layout)
    origin: torch.Tensor      # i64 [G] origin row per group
    slot_idx: torch.Tensor    # i32 [N]
    pods_i: int               # pods column in the (compressed) layout
    workspace: Optional[torch.Tensor]  # open_claim_fill's scratch (CUDA)


def _make_loop(inputs: PackInputs, n_slots: int) -> _Loop:
    """The per-solve constants of pack_impl's step loop."""
    dev = inputs.group_vec.device
    alloc_t = inputs.alloc_t
    if inputs.res_sel is not None:
        # gather the active resource columns out of the full-width resident
        # catalog array once per solve; padding lanes are zeroed so they
        # stay INT_BIG no-ops in every quotient
        alloc_t = torch.where(inputs.res_mask[None, :],
                              alloc_t.index_select(1, inputs.res_sel.long()),
                              0)
    G = inputs.group_vec.shape[0]
    origin = (torch.arange(G, device=dev) if inputs.group_origin is None
              else inputs.group_origin.long())
    return _Loop(
        alloc_t=alloc_t, alloc_tm=type_major(alloc_t),
        origin=origin,
        slot_idx=torch.arange(n_slots, dtype=_I32, device=dev),
        # pods column: 0 in the compressed layout (res_sel pins it there),
        # the wellknown index in the full-width layout
        pods_i=0 if inputs.res_sel is not None else _PODS_I,
        workspace=(open_claim_workspace(n_slots, dev)
                   if dev.type == "cuda" else None))


def _step(inputs: PackInputs, loop: _Loop, state: PackState, g: int):
    vec = inputs.group_vec[g]          # [R]
    cap = inputs.group_cap[g]          # []
    count = inputs.group_count[g]      # []
    og = loop.origin[g:g + 1]          # [1] origin row of this group

    # ---- 1) existing nodes ---------------------------------------------------
    q_ex = _quotient(inputs.ex_alloc - state.ex_used, vec)          # [Ne]
    cap_ex = cap if inputs.ex_cap is None else inputs.ex_cap[g]
    cap_ex = cap_ex - state.ex_placed.index_select(0, og)[0]
    fill_ex = torch.clamp(torch.minimum(q_ex, cap_ex), 0, INT_BIG)
    fill_ex = torch.where(inputs.ex_feas[g], fill_ex, 0)
    m_ex = _waterfall(count, fill_ex)                                # [Ne]
    ex_used = state.ex_used + m_ex[:, None] * vec[None, :]
    state.ex_placed.index_add_(0, og, m_ex[None, :])
    rem = count - m_ex.sum(dtype=_I32)

    # ---- 2) open claims, first-fit in creation order -------------------------
    gf = inputs.group_feas[g]                                        # [Pv, T, S]
    used, optmask = state.used, state.optmask      # updated in place below
    m_n, rem = open_claim_fill(
        loop.alloc_tm, vec, cap, gf, og, state.claim_placed,
        inputs.prov_pods_cap, loop.pods_i, used, optmask, state.nprov,
        state.active, rem, loop.workspace)                           # [N], []

    # ---- 3) bulk-open fresh nodes --------------------------------------------
    pods_i = loop.pods_i
    p = inputs.group_newprov[g]                                      # []
    p1 = torch.clamp(p, min=0).reshape(1)
    freshfeas = gf.index_select(0, p1)[0] & (p >= 0)                 # [T, S]
    ovh = inputs.overhead
    if inputs.prov_overhead is not None:
        ovh = ovh + inputs.prov_overhead.index_select(0, p1)[0]
    q0 = _quotient(loop.alloc_t - ovh[None, :], vec)                 # [T]
    if inputs.prov_pods_cap is not None:
        cap_t = inputs.prov_pods_cap.index_select(0, p1)[0]          # [T]
        q0 = torch.minimum(q0, _pods_cap_quotient(
            cap_t - ovh[pods_i], vec[pods_i]))
    kstar = torch.where(freshfeas, q0[:, None], 0).amax()
    kstar = torch.clamp(torch.minimum(kstar, cap), 0, INT_BIG)
    n_new = torch.where(
        kstar > 0,
        torch.div(rem + kstar - 1, torch.clamp(kstar, min=1),
                  rounding_mode="floor"),
        0)
    n_slots = state.active.shape[0]
    n_new = torch.minimum(n_new, n_slots - state.n_open)  # overflow -> unschedulable
    placed_new = torch.where(n_new > 0, (n_new - 1) * kstar, 0)
    last_cnt = torch.minimum(torch.clamp(rem - placed_new, min=0), kstar)

    idx = loop.slot_idx
    in_range = (idx >= state.n_open) & (idx < state.n_open + n_new)
    cnt = torch.where(idx == state.n_open + n_new - 1, last_cnt, kstar)
    cnt = torch.where(in_range, cnt, 0)                              # [N]
    fresh_used = ovh[None, :] + cnt[:, None] * vec[None, :]
    used = torch.where(in_range[:, None], fresh_used, used)
    fresh_mask = freshfeas[None, :, :] & (q0[None, :] >= cnt[:, None])[:, :, None]
    optmask = torch.where(in_range[:, None, None], fresh_mask, optmask)
    active = state.active | in_range
    nprov = torch.where(in_range, p, state.nprov)
    n_open = state.n_open + n_new
    unsched = rem - cnt.sum(dtype=_I32)

    row_n = m_n + cnt
    state.claim_placed.index_add_(0, og, row_n[None, :])
    new_state = PackState(used, optmask, nprov, active, n_open, ex_used,
                          state.ex_placed, state.claim_placed)
    return new_state, (row_n, m_ex, unsched)


def pack_impl(inputs: PackInputs, n_slots: int, n_eff: int) -> PackResult:
    """Run the pack over groups [0, n_eff). Rows past n_eff must hold no
    pods (n_eff_of computes it from the host group counts)."""
    dev = inputs.group_vec.device
    G, R = inputs.group_vec.shape
    T, S = inputs.tiebreak.shape
    Ne = inputs.ex_alloc.shape[0]
    loop = _make_loop(inputs, n_slots)
    state = PackState(
        used=torch.zeros((n_slots, R), dtype=_I32, device=dev),
        optmask=torch.zeros((n_slots, T, S), dtype=torch.bool, device=dev),
        nprov=torch.full((n_slots,), -1, dtype=_I32, device=dev),
        active=torch.zeros((n_slots,), dtype=torch.bool, device=dev),
        n_open=torch.zeros((), dtype=_I32, device=dev),
        ex_used=inputs.ex_used,
        ex_placed=torch.zeros((G, Ne), dtype=_I32, device=dev),
        claim_placed=torch.zeros((G, n_slots), dtype=_I32, device=dev),
    )
    assign = torch.zeros((G, n_slots), dtype=_I32, device=dev)
    ex_assign = torch.zeros((G, Ne), dtype=_I32, device=dev)
    unsched = torch.zeros((G,), dtype=_I32, device=dev)
    for g in range(n_eff):
        state, (row_n, row_ex, row_us) = _step(inputs, loop, state, g)
        assign[g] = row_n
        ex_assign[g] = row_ex
        unsched[g] = row_us

    # decision: cheapest surviving option per active claim
    rank = torch.where(state.optmask, inputs.tiebreak[None, :, :], INT_BIG)
    flatrank = rank.reshape(n_slots, -1)
    best = torch.argmin(flatrank, dim=-1).to(_I32)  # first minimum on ties
    has_opt = flatrank.amin(dim=-1) < INT_BIG
    decided = torch.where(state.active & has_opt, best, -1)

    return PackResult(
        assign=assign, ex_assign=ex_assign, unsched=unsched,
        used=state.used, active=state.active, nprov=state.nprov,
        decided=decided, n_open=state.n_open,
    )


def flatten_result(r: PackResult) -> torch.Tensor:
    """Everything the decoder needs as ONE int32 vector, so a solve pays
    exactly one device->host read."""
    return torch.cat([
        r.assign.reshape(-1), r.ex_assign.reshape(-1), r.unsched.reshape(-1),
        r.active.to(_I32), r.nprov, r.decided, r.n_open.reshape(1),
    ])


def pack_flat(inputs: PackInputs, n_slots: int, n_eff: int) -> torch.Tensor:
    """pack_impl + flatten_result: the one device program of a solve."""
    return flatten_result(pack_impl(inputs, n_slots, n_eff))


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
