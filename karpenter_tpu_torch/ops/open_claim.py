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

Every operand carries a leading lane axis: L independent problems are
filled at once, each lane exactly as if it were alone. The single solve is
L = 1; a solve_many wave has a lane per tenant problem and the
consolidation sweep a lane per candidate set (the batch axis vmap gives
the JAX pack). An input shared by every lane may be an `expand`ed view
(lane stride 0), as consolidation passes alloc_t and prov_pods_cap.

Replaces the TPU kernel karpenter_tpu/ops/pallas_kernels.py:101
(quotient_nt) and the tensor code around it in
karpenter_tpu/ops/packer.py::_step (:245-279), with vmap's batch axis.

- `open_claim_fill` is the wrapper. On CUDA tensors it makes two launches of
  csrc/open_claim.cu (qmax + waterfall, then the in-place mask shrink) over
  every lane; the [L, N, T] quotient never reaches device memory. It never
  falls back: a failed launch raises. On CPU tensors it runs the plain
  version. Either way it updates `used` and `optmask` in place and returns
  (m, rem after). Launch bound, not byte bound, at one problem; the source
  note in csrc/open_claim.cu says what the design does about it.
- `OpenClaimFill` is the same wrapper for the steps of one pack: it checks
  the operands and builds the constant launch arguments at its first call,
  so each later step pays only its pointers and the two launches. Its
  `rowmax` and `apply` are the multi-rank mesh's split of a step
  (parallel/sharded.py): launch 1 in its row-max mode (counted as
  ROWMAX_KERNEL), the caller's reduction, fill, waterfall and used update,
  then launch 2. The single card never splits.
- `open_claim_fill_reference` is the plain PyTorch version: the step-2
  tensor code the packer ran before the redesign, with a leading lane axis
  and K1's plain version as its quotient. It returns new tensors and
  changes nothing. The CPU path and the tests use it; chip_smoke.py holds
  the kernel to it on the card, bit for bit. It is composed of the split's
  plain halves (open_claim_rowmax_reference, claim_fill, _waterfall,
  placed_used, open_claim_apply_reference), which the CPU mesh runs.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..device import LAUNCHES
from .quotient import INT_BIG, MAX_WIDTH, _pods_cap_quotient, _quotient

KERNEL = "open_claim_fill"
ROWMAX_KERNEL = "open_claim_rowmax"  # launch 1's row-max mode (the mesh)
MAX_SLOTS = 65535  # the CUDA grid's y limit: one row of CTAs per slot
MAX_LANES = 65535  # the CUDA grid's z limit: one plane of CTAs per lane

_I32 = torch.int32
_fns = None


def _waterfall(count: torch.Tensor, fill: torch.Tensor) -> torch.Tensor:
    """First-fit distribution of `count` [L] pods over slots with per-slot
    capacity `fill` [L, N] (in slot order), lane by lane: m_i =
    clip(count - sum_{j<i} fill_j, 0, fill_i). fill is clamped to `count`
    first, so the int32 cumsum cannot wrap over several INT_BIG slots."""
    count = count[:, None]
    fill = torch.minimum(fill, count)
    before = torch.cumsum(fill, -1, dtype=_I32) - fill
    return torch.minimum(torch.clamp(count - before, min=0), fill)


def lane_quotient(alloc_t: torch.Tensor, used: torch.Tensor,
                  vec: torch.Tensor) -> torch.Tensor:
    """K1's plain version per lane: alloc_t [L, T, R], used [L, N, R],
    vec [L, R] -> q [L, N, T]."""
    return _quotient(alloc_t[:, None, :, :] - used[:, :, None, :],
                     vec[:, None, None, :])


def open_claim_rowmax_reference(alloc_t, vec, feas, prov_pods_cap, pods_i,
                                used, optmask, nprov, active,
                                quotient=lane_quotient):
    """The plain version of the fill's first half, up to the row max, lane
    by lane: -> (qmax [L, N], q [L, N, T], nodefeas [L, N, T, S]), all new
    tensors. The mesh's row-max mode: each rank's qmax is over its own
    types, and the ranks of the types axis reduce it by max."""
    lane = torch.arange(used.shape[0], device=used.device)
    nprov0 = torch.clamp(nprov, min=0)                               # [L, N]
    feas_n = feas[:, 0][:, None] if feas.shape[1] == 1 \
        else feas[lane[:, None], nprov0]                             # [L, N, T, S]
    nodefeas = optmask & feas_n & active[:, :, None, None]
    q_nt = quotient(alloc_t, used, vec)                              # [L, N, T]
    if prov_pods_cap is not None:
        cap_nt = prov_pods_cap[lane[:, None], nprov0]                # [L, N, T]
        q_extra = _pods_cap_quotient(
            cap_nt - used[:, :, pods_i][:, :, None],
            vec[:, pods_i][:, None, None])
        q_nt = torch.minimum(q_nt, q_extra)
    feas_t = nodefeas.any(dim=-1)                                    # [L, N, T]
    qmax = torch.where(feas_t, q_nt, -1).amax(dim=-1)                # [L, N]
    return qmax, q_nt, nodefeas


def claim_fill(qmax, cap, og, claim_placed):
    """fill[n] = clip(min(qmax[n], cap - claim_placed[og, n]), 0, INT_BIG)
    per lane: the slots' capacity for this group, the waterfall's input."""
    lane = torch.arange(qmax.shape[0], device=qmax.device)
    cap_n = cap[:, None] - claim_placed[lane, og]                    # [L, N]
    return torch.clamp(torch.minimum(qmax, cap_n), 0, INT_BIG)


def placed_used(used, vec, m_n):
    """used after placing m_n [L, N] pods of demand vec in each slot (the
    rows with m = 0 unchanged)."""
    new_used = used + m_n[:, :, None] * vec[:, None, :]
    return torch.where((m_n > 0)[:, :, None], new_used, used)


def open_claim_apply_reference(q_nt, nodefeas, m_n, optmask):
    """The plain version of launch 2: the option mask after placing m_n,
    from the first half's q and nodefeas (taken before `used` moved)."""
    shrunk = nodefeas & (q_nt >= m_n[:, :, None])[:, :, :, None]
    return torch.where((m_n > 0)[:, :, None, None], shrunk, optmask)


def open_claim_fill_reference(alloc_t, vec, cap, feas, og, claim_placed,
                              prov_pods_cap, pods_i, used, optmask, nprov,
                              active, rem, quotient=lane_quotient):
    """Plain PyTorch version (any device), lane by lane: -> (m [L, N],
    optmask, used, rem [L]), all new tensors. `quotient` computes
    q [L, N, T] from (alloc_t, used, vec); only chip_smoke.py passes another
    one (K1's kernel, to time the sequence the redesign replaced). It is
    the row max, the fill, the waterfall, the used update and the mask
    shrink in turn, the same functions the mesh's split runs."""
    qmax, q_nt, nodefeas = open_claim_rowmax_reference(
        alloc_t, vec, feas, prov_pods_cap, pods_i, used, optmask, nprov,
        active, quotient)
    m_n = _waterfall(rem, claim_fill(qmax, cap, og, claim_placed))  # [L, N]
    optmask = open_claim_apply_reference(q_nt, nodefeas, m_n, optmask)
    used = placed_used(used, vec, m_n)
    rem = rem - m_n.sum(dim=-1, dtype=_I32)
    return m_n, optmask, used, rem


def open_claim_workspace(n_slots: int, device, lanes: int = 1) -> torch.Tensor:
    """The kernel's scratch for one solve: per lane a ticket and one row
    max per slot, zero between steps (the kernel leaves it zeroed)."""
    return torch.zeros((lanes, 1 + n_slots), dtype=_I32, device=device)


# the inputs that carry a lane stride, in the C entry points' order
_STRIDED = ("alloc_t", "vec", "cap", "feas", "og", "claim_placed",
            "prov_pods_cap", "nprov", "active", "rem")


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
    if used.dim() != 3 or optmask.dim() != 4 or feas.dim() != 4:
        raise ValueError("open_claim_fill: want used [L, N, R], optmask "
                         "[L, N, T, S], feas [L, Pv, T, S]; got "
                         f"{tuple(used.shape)}, {tuple(optmask.shape)}, "
                         f"{tuple(feas.shape)}")
    L, N, R = used.shape
    T, S = optmask.shape[2:]
    Pv = feas.shape[1]
    want = {"alloc_t": (L, T, R), "vec": (L, R), "cap": (L,), "og": (L,),
            "optmask": (L, N, T, S), "feas": (L, Pv, T, S),
            "nprov": (L, N), "active": (L, N), "rem": (L,)}
    if prov_pods_cap is not None:
        want["prov_pods_cap"] = (L, Pv, T)
    for name, shape in want.items():
        if tuple(named[name].shape) != shape:
            raise ValueError(f"open_claim_fill: {name} is "
                             f"{tuple(named[name].shape)}, want {shape}")
    if claim_placed.dim() != 3 or claim_placed.shape[0] != L \
            or claim_placed.shape[2] != N:
        raise ValueError("open_claim_fill: claim_placed must be [L, G, N], "
                         f"got {tuple(claim_placed.shape)}")
    if not 1 <= R <= MAX_WIDTH:
        raise ValueError(f"open_claim_fill: width {R} outside 1..{MAX_WIDTH}")
    if not 0 <= pods_i < R:
        raise ValueError(f"open_claim_fill: pods column {pods_i} outside "
                         f"0..{R - 1}")
    if L < 1 or T < 1 or Pv < 1 or S < 1:
        raise ValueError("open_claim_fill: want at least one lane, type, "
                         "option and provisioner plane")
    if not alloc_t[0].t().is_contiguous():
        raise ValueError("open_claim_fill: alloc_t must be type-major in "
                         "each lane (use quotient.type_major)")
    for name in ("used", "optmask"):
        if not named[name].is_contiguous():
            raise ValueError(f"open_claim_fill: {name} must be contiguous")
    for name in _STRIDED:
        x = named.get(name)
        if name != "alloc_t" and x is not None and not x[0].is_contiguous():
            raise ValueError(f"open_claim_fill: each lane of {name} must be "
                             "contiguous")


def _launchers():
    global _fns
    if _fns is None:
        from . import _build

        lib = _build.load("open_claim")
        args = ([ctypes.c_void_p] * 15 + [ctypes.c_int] * 8
                + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p])
        _fns = (lib.open_claim_qmax_launch, lib.open_claim_apply_launch,
                lib.open_claim_rowmax_launch)
        for fn in _fns:
            fn.argtypes = args
            fn.restype = ctypes.c_int
    return _fns


def _lane_stride(x: Optional[torch.Tensor]) -> int:
    """x's stride over lanes, in elements (0 when every lane shares it)."""
    return 0 if x is None or x.shape[0] == 1 else x.stride(0)


def _word(S: int, feas: torch.Tensor, optmask: torch.Tensor) -> int:
    """The widest word (4, 2 or 1 bytes) in which the S option bytes of a
    type can be read: it divides S, both base addresses and feas's lane
    stride (optmask's is a multiple of S)."""
    for w in (4, 2):
        if S % w == 0 and feas.data_ptr() % w == 0 \
                and optmask.data_ptr() % w == 0 and _lane_stride(feas) % w == 0:
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


def launch_rowmax(args: tuple) -> None:
    """Launch 1 in its row-max mode (the mesh's split): qmax into `m`."""
    err = _launchers()[2](*args)
    if err != 0:
        raise RuntimeError(f"open_claim_fill: launch 1 (row-max mode) "
                           f"failed with CUDA error {err}")
    LAUNCHES.add(ROWMAX_KERNEL)


def launch_apply(args: tuple) -> None:
    """Launch 2 alone (the in-place mask shrink of placed rows)."""
    err = _launchers()[1](*args)
    if err != 0:
        raise RuntimeError(f"open_claim_fill: launch 2 failed with CUDA "
                           f"error {err}")
    LAUNCHES.add(KERNEL)


class OpenClaimFill:
    """open_claim_fill for the steps of one pack. The operands that stay
    the same for the whole pack (alloc_t, prov_pods_cap, pods_i and, on
    CUDA, the workspace) are given once; each call passes its step's own.
    The first call checks every operand and builds the
    launch arguments that do not change from step to step: the sizes, the
    lane strides, the option word and the stream. Later calls pass their
    pointers, so a step pays two small allocations and two launches.

    Every call must give operands of the first call's shapes, dtypes and
    strides, as the pack's steps do: each slices the same inputs at another
    group and makes its state with the same operations. A call checks
    again what the kernel writes through (the shapes and contiguity of
    `used` and `optmask`) and the alignment of the option word."""

    def __init__(self, alloc_t, prov_pods_cap, pods_i: int,
                 workspace: Optional[torch.Tensor] = None):
        self.alloc_t = alloc_t
        self.prov_pods_cap = prov_pods_cap
        self.pods_i = pods_i
        self.workspace = workspace
        self._tail = None   # the constant launch arguments; () on the CPU
        self._split = None  # the CPU split's (q, nodefeas) between halves

    def _prepare(self, vec, cap, feas, og, claim_placed, used, optmask,
                 nprov, active, rem) -> None:
        _check(self.alloc_t, vec, cap, feas, og, claim_placed,
               self.prov_pods_cap, self.pods_i, used, optmask, nprov, active,
               rem)
        if used.device.type == "cpu":
            self._tail = ()
            return
        if used.device.type != "cuda":
            raise ValueError(f"open_claim_fill: no kernel for device "
                             f"{used.device}")
        L, N, R = used.shape
        T, S = optmask.shape[2:]
        if not 1 <= N <= MAX_SLOTS:
            raise ValueError(f"open_claim_fill: {N} slots outside "
                             f"1..{MAX_SLOTS}")
        if not 1 <= L <= MAX_LANES:
            raise ValueError(f"open_claim_fill: {L} lanes outside "
                             f"1..{MAX_LANES}")
        ws = self.workspace
        if ws is None or tuple(ws.shape) != (L, 1 + N) or ws.dtype != _I32 \
                or ws.device != used.device or not ws.is_contiguous():
            raise ValueError("open_claim_fill: CUDA tensors need an int32 "
                             "[L, 1 + N] workspace on their device "
                             "(open_claim_workspace)")
        strided = (self.alloc_t, vec, cap, feas, og, claim_placed,
                   self.prov_pods_cap, nprov, active, rem)
        strides = (ctypes.c_longlong * len(strided))(
            *(_lane_stride(x) for x in strided))
        self._device = used.device.index
        self._head = (self.alloc_t.data_ptr(),
                      0 if self.prov_pods_cap is None
                      else self.prov_pods_cap.data_ptr(), ws.data_ptr())
        self._sizes = ((L, N), (L, N, R), (L, N, T, S))
        self._tail = (N, T, S, feas.shape[1], R, self.pods_i,
                      _word(S, feas, optmask), L, strides,
                      torch.cuda.current_stream(used.device).cuda_stream)

    def args(self, vec, cap, feas, og, claim_placed, used, optmask, nprov,
             active, rem, m, rem_out) -> tuple:
        """The C entry points' arguments for one step on CUDA tensors,
        writing m [L, N] and rem_out [L]."""
        if self._tail is None:
            self._prepare(vec, cap, feas, og, claim_placed, used, optmask,
                          nprov, active, rem)
        if not self._tail:
            raise ValueError("open_claim_fill: the launch arguments are for "
                             "CUDA tensors")
        _, used_size, mask_size = self._sizes
        if used.shape != used_size or optmask.shape != mask_size \
                or not (used.is_contiguous() and optmask.is_contiguous()):
            raise ValueError("open_claim_fill: used and optmask must keep "
                             "the first step's shapes and be contiguous")
        fp, op = feas.data_ptr(), optmask.data_ptr()
        if (fp | op) % self._tail[6]:
            raise ValueError("open_claim_fill: the option planes lost the "
                             "first step's alignment")
        alloc_p, cap_p, ws_p = self._head
        return (alloc_p, vec.data_ptr(), cap.data_ptr(), fp, og.data_ptr(),
                claim_placed.data_ptr(), cap_p, nprov.data_ptr(),
                active.data_ptr(), rem.data_ptr(), used.data_ptr(), op,
                m.data_ptr(), rem_out.data_ptr(), ws_p, *self._tail)

    def __call__(self, vec, cap, feas, og, claim_placed, used, optmask, nprov,
                 active, rem):
        """One step: -> (m [L, N], rem after [L]), with `used` and
        `optmask` updated in place."""
        if self._tail is None:
            self._prepare(vec, cap, feas, og, claim_placed, used, optmask,
                          nprov, active, rem)
        if not self._tail:   # CPU tensors: the plain version
            m, new_mask, new_used, rem_out = open_claim_fill_reference(
                self.alloc_t, vec, cap, feas, og, claim_placed,
                self.prov_pods_cap, self.pods_i, used, optmask, nprov,
                active, rem)
            optmask.copy_(new_mask)
            used.copy_(new_used)
            return m, rem_out
        if torch.cuda.current_device() != self._device:
            with torch.cuda.device(self._device):
                return self(vec, cap, feas, og, claim_placed, used, optmask,
                            nprov, active, rem)
        m_size = self._sizes[0]
        m = torch.empty(m_size, dtype=_I32, device=used.device)
        rem_out = torch.empty(m_size[:1], dtype=_I32, device=used.device)
        args = self.args(vec, cap, feas, og, claim_placed, used, optmask,
                         nprov, active, rem, m, rem_out)
        launch_qmax(args)
        launch_apply(args)
        return m, rem_out


    def rowmax(self, vec, cap, feas, og, claim_placed, used, optmask, nprov,
               active, rem) -> torch.Tensor:
        """The mesh's first half of a step: -> qmax [L, N] over this rank's
        types (launch 1 in its row-max mode on CUDA; on the CPU the plain
        version, whose q and nodefeas the next `apply` reuses). The caller
        reduces qmax over the types axis, runs the fill and the waterfall
        (claim_fill, _waterfall), moves `used` in place (placed_used), then
        calls apply."""
        if self._tail is None:
            self._prepare(vec, cap, feas, og, claim_placed, used, optmask,
                          nprov, active, rem)
        if not self._tail:
            qmax, q_nt, nodefeas = open_claim_rowmax_reference(
                self.alloc_t, vec, feas, self.prov_pods_cap, self.pods_i,
                used, optmask, nprov, active)
            self._split = (q_nt, nodefeas)
            return qmax
        if torch.cuda.current_device() != self._device:
            with torch.cuda.device(self._device):
                return self.rowmax(vec, cap, feas, og, claim_placed, used,
                                   optmask, nprov, active, rem)
        qmax = torch.empty(self._sizes[0], dtype=_I32, device=used.device)
        # rem_out: the row-max mode neither reads nor writes it
        launch_rowmax(self.args(vec, cap, feas, og, claim_placed, used,
                                optmask, nprov, active, rem, qmax, rem))
        return qmax

    def apply(self, vec, cap, feas, og, claim_placed, used, optmask, nprov,
              active, rem, m) -> None:
        """The mesh's second half of a step: shrinks `optmask` in place for
        the slots placed by m [L, N] (contiguous int32), after the caller
        moved `used` by m (launch 2, unchanged, on CUDA)."""
        if not self._tail:
            q_nt, nodefeas = self._split
            self._split = None
            optmask.copy_(open_claim_apply_reference(q_nt, nodefeas, m,
                                                     optmask))
            return
        if torch.cuda.current_device() != self._device:
            with torch.cuda.device(self._device):
                return self.apply(vec, cap, feas, og, claim_placed, used,
                                  optmask, nprov, active, rem, m)
        if m.shape != self._sizes[0] or m.dtype != _I32 \
                or not m.is_contiguous():
            raise ValueError("open_claim_fill: m must be a contiguous int32 "
                             f"{tuple(self._sizes[0])}")
        # rem_out: launch 2 neither reads nor writes it
        launch_apply(self.args(vec, cap, feas, og, claim_placed, used,
                               optmask, nprov, active, rem, m, rem))


def cuda_args(alloc_t, vec, cap, feas, og, claim_placed, prov_pods_cap,
              pods_i, used, optmask, nprov, active, rem, workspace, m,
              rem_out) -> tuple:
    """The C entry points' arguments for one checked call on CUDA tensors."""
    return OpenClaimFill(alloc_t, prov_pods_cap, pods_i, workspace).args(
        vec, cap, feas, og, claim_placed, used, optmask, nprov, active, rem,
        m, rem_out)


def open_claim_fill(alloc_t, vec, cap, feas, og, claim_placed, prov_pods_cap,
                    pods_i: int, used, optmask, nprov, active, rem,
                    workspace: Optional[torch.Tensor] = None):
    """Step 2 of the pack step for one group in each of L lanes: ->
    (m [L, N], rem after [L]), with `used` [L, N, R] and `optmask`
    [L, N, T, S] updated in place. CUDA tensors launch the kernel (two
    launches for all the lanes) or raise; CPU tensors take the plain
    version. `alloc_t` [L, T, R] is type-major in each lane
    (quotient.type_major); `og` is each lane's origin row as int64 [L];
    `vec` is [L, R], `cap` and `rem` [L], `feas` [L, Pv, T, S],
    `claim_placed` [L, G, N], `prov_pods_cap` [L, Pv, T] or None. An input
    may be shared by the lanes through an `expand`ed view. On CUDA,
    `workspace` (open_claim_workspace) is required and reused across the
    steps of a solve; the CPU path ignores it. A pack's step loop uses
    OpenClaimFill, which checks once per pack."""
    return OpenClaimFill(alloc_t, prov_pods_cap, pods_i, workspace)(
        vec, cap, feas, og, claim_placed, used, optmask, nprov, active, rem)
