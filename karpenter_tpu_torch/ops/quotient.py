"""The pack step's capacity quotient: kernel K1 of the port.

    q[n, t] = min over r of floor((alloc_t[t, r] - used[n, r]) / vec[r])

with the packer's conventions: a resource with vec[r] <= 0 is not demanded
and contributes INT_BIG, negative availability of a demanded resource gives
-1, and the result is clipped to [-1, INT_BIG].

Replaces the TPU kernel karpenter_tpu/ops/pallas_kernels.py::quotient_nt
(wrapper quotient_nt_auto), which the JAX package runs in
karpenter_tpu/ops/packer.py::_step's open-claim fill. The port's pack step
no longer launches it: its redesign, ops/open_claim.py, fuses the quotient
with the rest of the fill. It stays as the standalone kernel, held to its
plain version and timed by chip_smoke.py.

- `quotient_nt` is the wrapper. On a CUDA tensor it launches the
  hand-written kernel csrc/quotient.cu (exact int32 division, so it needs no
  value gate) or raises; it never falls back. On a CPU tensor it returns
  the plain version.
- `quotient_nt_reference` is the plain PyTorch version: the packer's
  `_quotient` over the broadcast [N, T, R] availability. The CPU path and
  the tests use it; chip_smoke.py holds the kernel to it on the card.

`alloc_t` is [T, R] but must lie type-major in memory (an [R, T]
contiguous tensor seen through `.t()`, as `type_major` makes it), so that
the kernel's loads coalesce; the packer makes that view once per solve.
"""

from __future__ import annotations

import ctypes

import torch

from ..device import LAUNCHES

INT_BIG = 2**30
KERNEL = "quotient_nt"
MAX_WIDTH = 16  # widths instantiated in csrc/quotient.cu

_fn = None


def _quotient(avail: torch.Tensor, vec: torch.Tensor) -> torch.Tensor:
    """How many `vec`-sized pods fit into `avail`: min over resources of
    floor(avail/vec), with zero-demand resources ignored. avail [..., R]."""
    pos = vec > 0
    vsafe = torch.clamp(vec, min=1)
    div = torch.div(avail, vsafe, rounding_mode="floor")
    q = torch.where(pos, div, INT_BIG)
    # negative availability of a demanded resource -> -1 (a non-demanded
    # one already holds INT_BIG above)
    q = torch.where((avail < 0) & pos, -1, q)
    return torch.clamp(q.amin(dim=-1), -1, INT_BIG)


def _pods_cap_quotient(cap_avail: torch.Tensor,
                       vec_pods: torch.Tensor) -> torch.Tensor:
    """How many more pods the kubelet pods cap admits: floor(cap_avail/vec)
    with the same zero-demand/negative conventions as _quotient."""
    pos = vec_pods > 0
    div = torch.div(cap_avail, torch.clamp(vec_pods, min=1),
                    rounding_mode="floor")
    q = torch.where(pos, div, INT_BIG)
    q = torch.where((cap_avail < 0) & pos, -1, q)
    return torch.clamp(q, -1, INT_BIG)


def type_major(alloc_t: torch.Tensor) -> torch.Tensor:
    """[T, R] view of an [R, T] contiguous copy: the layout quotient_nt
    takes."""
    return alloc_t.t().contiguous().t()


def quotient_nt_reference(alloc_t: torch.Tensor, used: torch.Tensor,
                          vec: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel (any layout, any device)."""
    return _quotient(alloc_t[None, :, :] - used[:, None, :], vec)


def _check(alloc_t: torch.Tensor, used: torch.Tensor,
           vec: torch.Tensor) -> None:
    for name, x in (("alloc_t", alloc_t), ("used", used), ("vec", vec)):
        if x.dtype != torch.int32:
            raise TypeError(f"quotient_nt: {name} must be int32, "
                            f"got {x.dtype}")
        if x.device != used.device:
            raise ValueError(f"quotient_nt: {name} is on {x.device}, "
                             f"used on {used.device}")
    if alloc_t.dim() != 2 or used.dim() != 2 or vec.dim() != 1:
        raise ValueError("quotient_nt: want alloc_t [T, R], used [N, R], "
                         f"vec [R]; got {tuple(alloc_t.shape)}, "
                         f"{tuple(used.shape)}, {tuple(vec.shape)}")
    R = vec.shape[0]
    if alloc_t.shape[1] != R or used.shape[1] != R:
        raise ValueError("quotient_nt: resource widths differ: "
                         f"{alloc_t.shape[1]}, {used.shape[1]}, {R}")
    if not 1 <= R <= MAX_WIDTH:
        raise ValueError(f"quotient_nt: width {R} outside 1..{MAX_WIDTH}")
    if not alloc_t.t().is_contiguous():
        raise ValueError("quotient_nt: alloc_t must be type-major "
                         "(use type_major(alloc_t))")
    if not (used.is_contiguous() and vec.is_contiguous()):
        raise ValueError("quotient_nt: used and vec must be contiguous")


def _launcher():
    global _fn
    if _fn is None:
        from . import _build

        fn = _build.load("quotient").quotient_nt_launch
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def quotient_nt(alloc_t: torch.Tensor, used: torch.Tensor,
                vec: torch.Tensor) -> torch.Tensor:
    """q[n, t] as int32 [N, T]. CUDA tensors launch the kernel (or raise);
    CPU tensors take the plain version."""
    _check(alloc_t, used, vec)
    if used.device.type == "cpu":
        return quotient_nt_reference(alloc_t, used, vec)
    if used.device.type != "cuda":
        raise ValueError(f"quotient_nt: no kernel for device {used.device}")
    N, R = used.shape
    T = alloc_t.shape[0]
    out = torch.empty((N, T), dtype=torch.int32, device=used.device)
    if N == 0 or T == 0:
        return out
    fn = _launcher()
    with torch.cuda.device(used.device):
        stream = torch.cuda.current_stream(used.device).cuda_stream
        err = fn(alloc_t.data_ptr(), used.data_ptr(), vec.data_ptr(),
                 out.data_ptr(), N, T, R, stream)
    if err != 0:
        raise RuntimeError(f"quotient_nt: kernel launch failed with CUDA "
                           f"error {err}")
    LAUNCHES.add(KERNEL)
    return out
