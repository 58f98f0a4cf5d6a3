"""Step 2 of the pack step, the open-claim fill: the redesign of kernel K1.

For one pod group (demand `vec`, per-node cap `cap`, origin row `og`) and
`rem` pods left after the existing nodes, the fill places pods on the open
node claims first-fit in creation order:

    nodefeas[n,t,s] = optmask[n,t,s] & feas[plane(n),t,s] & active[n]
    q[n,t]   = K1's quotient of alloc_t[t] - used[n] by vec, then the min
               with the kubelet pods-cap quotient when prov_pods_cap is given
    qmax[n]  = max of q[n,t] over types with a feasible option, else -1
    fill[n]  = clip(min(qmax[n], cap - claim_placed[og, n]), 0, INT_BIG)
    m        = _waterfall(rem, fill)
    where m[n] > 0: optmask[n] &= nodefeas[n] & (q[n,t] >= m[n]),
                    used[n] += m[n] * vec
    rem     -= sum(m)

Replaces the TPU kernel karpenter_tpu/ops/pallas_kernels.py:101
(quotient_nt) and the tensor code around it in
karpenter_tpu/ops/packer.py::_step (:245-279).

- `open_claim_fill` is the wrapper. On CUDA tensors it makes two launches of
  csrc/open_claim.cu (qmax + waterfall, then the in-place mask shrink); the
  [N, T] quotient never reaches device memory. It never falls back: a
  failed launch raises. On CPU tensors it runs the plain version. Either way
  it updates `used` and `optmask` in place and returns (m, rem after).
  Launch bound, not byte bound; the source note in csrc/open_claim.cu says
  what the design does about it.
- `open_claim_fill_reference` is the plain PyTorch version: the step-2
  tensor code the packer ran before the redesign, unchanged, with K1's plain
  version as its quotient. It returns new tensors and changes nothing. The
  CPU path and the tests use it; chip_smoke.py holds the kernel to it on the
  card, bit for bit.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..device import LAUNCHES
from .quotient import (INT_BIG, MAX_WIDTH, _pods_cap_quotient,
                       quotient_nt_reference)

KERNEL = "open_claim_fill"
MAX_SLOTS = 65535  # the CUDA grid's y limit: one row of CTAs per slot

_I32 = torch.int32
_fns = None


def _waterfall(count: torch.Tensor, fill: torch.Tensor) -> torch.Tensor:
    """First-fit distribution of `count` pods over slots with per-slot
    capacity `fill` (in slot order): m_i = clip(count - sum_{j<i} fill_j,
    0, fill_i). fill is clamped to `count` first, so the int32 cumsum
    cannot wrap over several INT_BIG slots."""
    fill = torch.minimum(fill, count)
    before = torch.cumsum(fill, 0, dtype=_I32) - fill
    return torch.minimum(torch.clamp(count - before, min=0), fill)


def open_claim_fill_reference(alloc_t, vec, cap, feas, og, claim_placed,
                              prov_pods_cap, pods_i, used, optmask, nprov,
                              active, rem, quotient=quotient_nt_reference):
    """Plain PyTorch version (any device): -> (m, optmask, used, rem), all
    new tensors. `quotient` computes q[n, t] from (alloc_t, used, vec); only
    chip_smoke.py passes another one (K1's kernel, to time the sequence the
    redesign replaced)."""
    nprov0 = torch.clamp(nprov, min=0)
    feas_n = feas[0][None] if feas.shape[0] == 1 \
        else feas.index_select(0, nprov0)                            # [N, T, S]
    nodefeas = optmask & feas_n & active[:, None, None]
    q_nt = quotient(alloc_t, used, vec)                              # [N, T]
    if prov_pods_cap is not None:
        cap_nt = prov_pods_cap.index_select(0, nprov0)               # [N, T]
        q_extra = _pods_cap_quotient(
            cap_nt - used[:, pods_i][:, None], vec[pods_i])
        q_nt = torch.minimum(q_nt, q_extra)
    feas_t = nodefeas.any(dim=-1)                                    # [N, T]
    qmax = torch.where(feas_t, q_nt, -1).amax(dim=-1)                # [N]
    cap_n = cap - claim_placed.index_select(0, og)[0]                # [N]
    fill_n = torch.clamp(torch.minimum(qmax, cap_n), 0, INT_BIG)
    m_n = _waterfall(rem, fill_n)                                    # [N]
    new_used = used + m_n[:, None] * vec[None, :]
    shrunk = nodefeas & (q_nt >= m_n[:, None])[:, :, None]
    placed = m_n > 0
    optmask = torch.where(placed[:, None, None], shrunk, optmask)
    used = torch.where(placed[:, None], new_used, used)
    rem = rem - m_n.sum(dtype=_I32)
    return m_n, optmask, used, rem


def open_claim_workspace(n_slots: int, device) -> torch.Tensor:
    """The kernel's scratch for one solve: a ticket and one row max per
    slot, zero between steps (the kernel leaves it zeroed)."""
    return torch.zeros((1 + n_slots,), dtype=_I32, device=device)


def _check(alloc_t, vec, cap, feas, og, claim_placed, prov_pods_cap, pods_i,
           used, optmask, nprov, active, rem) -> None:
    named = {"alloc_t": alloc_t, "vec": vec, "cap": cap, "feas": feas,
             "og": og, "claim_placed": claim_placed, "used": used,
             "optmask": optmask, "nprov": nprov, "active": active,
             "rem": rem}
    if prov_pods_cap is not None:
        named["prov_pods_cap"] = prov_pods_cap
    dtypes = {"feas": torch.bool, "optmask": torch.bool, "active": torch.bool,
              "og": torch.int64}
    for name, x in named.items():
        want = dtypes.get(name, _I32)
        if x.dtype != want:
            raise TypeError(f"open_claim_fill: {name} must be {want}, "
                            f"got {x.dtype}")
        if x.device != used.device:
            raise ValueError(f"open_claim_fill: {name} is on {x.device}, "
                             f"used on {used.device}")
    if used.dim() != 2 or optmask.dim() != 3 or feas.dim() != 3:
        raise ValueError("open_claim_fill: want used [N, R], optmask "
                         f"[N, T, S], feas [Pv, T, S]; got {tuple(used.shape)}"
                         f", {tuple(optmask.shape)}, {tuple(feas.shape)}")
    N, R = used.shape
    _, T, S = optmask.shape
    Pv = feas.shape[0]
    want = {"alloc_t": (T, R), "vec": (R,), "cap": (), "og": (1,),
            "nprov": (N,), "active": (N,), "rem": ()}
    if prov_pods_cap is not None:
        want["prov_pods_cap"] = (Pv, T)
    for name, shape in want.items():
        if tuple(named[name].shape) != shape:
            raise ValueError(f"open_claim_fill: {name} is "
                             f"{tuple(named[name].shape)}, want {shape}")
    if claim_placed.dim() != 2 or claim_placed.shape[1] != N:
        raise ValueError("open_claim_fill: claim_placed must be [G, N], got "
                         f"{tuple(claim_placed.shape)}")
    if not 1 <= R <= MAX_WIDTH:
        raise ValueError(f"open_claim_fill: width {R} outside 1..{MAX_WIDTH}")
    if not 0 <= pods_i < R:
        raise ValueError(f"open_claim_fill: pods column {pods_i} outside "
                         f"0..{R - 1}")
    if T < 1 or Pv < 1 or S < 1:
        raise ValueError("open_claim_fill: want at least one type, option "
                         "and provisioner plane")
    if not alloc_t.t().is_contiguous():
        raise ValueError("open_claim_fill: alloc_t must be type-major "
                         "(use quotient.type_major(alloc_t))")
    for name, x in named.items():
        if name != "alloc_t" and not x.is_contiguous():
            raise ValueError(f"open_claim_fill: {name} must be contiguous")


def _launchers():
    global _fns
    if _fns is None:
        from . import _build

        lib = _build.load("open_claim")
        step_args = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 7
        _fns = (lib.open_claim_qmax_launch, lib.open_claim_apply_launch)
        for fn in _fns:
            fn.argtypes = step_args + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
    return _fns


def _word(S: int, *tensors: torch.Tensor) -> int:
    """The widest word (4, 2 or 1 bytes) in which the S option bytes of a
    type can be read: it divides S and both base addresses."""
    for w in (4, 2):
        if S % w == 0 and all(x.data_ptr() % w == 0 for x in tensors):
            return w
    return 1


def launch_qmax(args: tuple) -> None:
    """Launch 1 alone (qmax, waterfall, m, rem and used), for timing; the
    arguments are `cuda_args`'s."""
    err = _launchers()[0](*args)
    if err != 0:
        raise RuntimeError(f"open_claim_fill: launch 1 failed with CUDA "
                           f"error {err}")
    LAUNCHES.add(KERNEL)


def launch_apply(args: tuple) -> None:
    """Launch 2 alone (the in-place mask shrink of placed rows)."""
    err = _launchers()[1](*args)
    if err != 0:
        raise RuntimeError(f"open_claim_fill: launch 2 failed with CUDA "
                           f"error {err}")
    LAUNCHES.add(KERNEL)


def cuda_args(alloc_t, vec, cap, feas, og, claim_placed, prov_pods_cap,
              pods_i, used, optmask, nprov, active, rem, workspace, m,
              rem_out) -> tuple:
    """The C entry points' arguments for checked CUDA tensors."""
    N, R = used.shape
    _, T, S = optmask.shape
    if tuple(workspace.shape) != (1 + N,) or workspace.dtype != _I32 \
            or workspace.device != used.device:
        raise ValueError("open_claim_fill: workspace must be int32 [1 + N] "
                         "on the tensors' device (open_claim_workspace)")
    stream = torch.cuda.current_stream(used.device).cuda_stream
    ptrs = [alloc_t, vec, cap, feas, og, claim_placed, prov_pods_cap, nprov,
            active, rem, used, optmask, m, rem_out, workspace]
    return (*(0 if x is None else x.data_ptr() for x in ptrs),
            N, T, S, feas.shape[0], R, pods_i, _word(S, optmask, feas),
            stream)


def open_claim_fill(alloc_t, vec, cap, feas, og, claim_placed, prov_pods_cap,
                    pods_i: int, used, optmask, nprov, active, rem,
                    workspace: Optional[torch.Tensor] = None):
    """Step 2 of the pack step for one group: -> (m [N], rem after), with
    `used` [N, R] and `optmask` [N, T, S] updated in place. CUDA tensors
    launch the kernel (two launches) or raise; CPU tensors take the plain
    version. `alloc_t` is type-major (quotient.type_major); `og` is the
    group's origin row as an int64 [1] tensor; `cap` and `rem` are 0-d.
    On CUDA, `workspace` (open_claim_workspace) is required and reused
    across the steps of a solve; the CPU path ignores it."""
    _check(alloc_t, vec, cap, feas, og, claim_placed, prov_pods_cap, pods_i,
           used, optmask, nprov, active, rem)
    if used.device.type == "cpu":
        m, new_mask, new_used, rem_out = open_claim_fill_reference(
            alloc_t, vec, cap, feas, og, claim_placed, prov_pods_cap, pods_i,
            used, optmask, nprov, active, rem)
        optmask.copy_(new_mask)
        used.copy_(new_used)
        return m, rem_out
    if used.device.type != "cuda":
        raise ValueError(f"open_claim_fill: no kernel for device "
                         f"{used.device}")
    N = used.shape[0]
    if not 1 <= N <= MAX_SLOTS:
        raise ValueError(f"open_claim_fill: {N} slots outside 1..{MAX_SLOTS}")
    if workspace is None:
        raise ValueError("open_claim_fill: CUDA tensors need a workspace "
                         "(open_claim_workspace)")
    m = torch.empty((N,), dtype=_I32, device=used.device)
    rem_out = torch.empty((), dtype=_I32, device=used.device)
    with torch.cuda.device(used.device):
        args = cuda_args(alloc_t, vec, cap, feas, og, claim_placed,
                         prov_pods_cap, pods_i, used, optmask, nprov, active,
                         rem, workspace, m, rem_out)
        launch_qmax(args)
        launch_apply(args)
    return m, rem_out
