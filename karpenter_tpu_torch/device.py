"""Device resolution and kernel launch counters for the port.

Entry points take a `device` argument. None means the CUDA card, and a
missing card is an error: the port never falls back to the CPU on its own.
The CPU is used only when the caller asks for it (`device="cpu"`), which is
how the tests run the plain PyTorch path against the JAX package.

LAUNCHES counts, per hand-written kernel, the launches its wrapper made.
A wrapper adds one where it launches its kernel and nowhere else, so a run
can show that its main path went through the kernels: reset the counts
before the run and read them after. A CUDA graph's capture makes no
launch on the card: its wrappers' counts are held aside (`held`), and each
replay of the graph adds them.
"""

from __future__ import annotations

import contextlib
import threading

import torch


def resolve_device(device: "str | torch.device | None" = None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names the
    CPU. Raises when CUDA is asked for (explicitly or by default) and no
    CUDA device is present."""
    dev = torch.device("cuda") if device is None else torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "karpenter_tpu_torch runs on a CUDA device by default and "
                "none is available; pass device='cpu' to run the plain "
                "PyTorch path on the CPU")
        return dev
    if dev.type == "cpu":
        return dev
    raise ValueError(f"unsupported device {dev!s}: use 'cuda' or 'cpu'")


def prepare_device(device: "str | torch.device | None" = None) -> torch.device:
    """resolve_device for a long-lived caller (a controller). On the card it
    also builds and loads the kernels that the solve and the consolidation
    sweep launch, so a missing toolchain or a failed build raises when the
    caller is built, as a missing card does, and never surfaces first as a
    failed solve."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        from .ops import _build

        _build.load("open_claim")
    return dev


class LaunchCounts:
    """Per-kernel launch counts (plain integers, safe across threads)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counts: "dict[str, int]" = {}
        self._local = threading.local()

    def add(self, kernel: str, n: int = 1) -> None:
        held = getattr(self._local, "held", None)
        if held is not None:
            held[kernel] = held.get(kernel, 0) + n
            return
        with self._lock:
            self._counts[kernel] = self._counts.get(kernel, 0) + n

    @contextlib.contextmanager
    def held(self):
        """Inside the block, the launches this thread's wrappers count go
        to the yielded dict and not to the counts (a graph's capture)."""
        self._local.held = held = {}
        try:
            yield held
        finally:
            self._local.held = None

    def get(self, kernel: str) -> int:
        with self._lock:
            return self._counts.get(kernel, 0)

    def reset(self) -> None:
        with self._lock:
            self._counts.clear()

    def take(self) -> "dict[str, int]":
        """The counts, set to 0 in the same step."""
        with self._lock:
            counts, self._counts = self._counts, {}
            return counts


LAUNCHES = LaunchCounts()
