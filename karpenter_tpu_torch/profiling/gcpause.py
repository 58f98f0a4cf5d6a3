"""The interpreter's garbage-collector pauses, for the solver's span record.

One process-wide `gc.callbacks` hook keeps the last RING pauses as
(start_ns, end_ns, generation, collected), on time.perf_counter_ns's clock.
At its end a solve takes the pauses that fall inside its window
(`GC_PAUSES.between`) and files them as `runtime.gc` spans, so a phase's
time can be told from the collector's inside it.

Part of the profiling plane: while the plane is off (state.enabled() is
False, KARPENTER_TPU_PROFILING=0) the hook returns before it reads a clock
and the ring does not grow.

The ring is read by copying it whole: a collection can start at any
allocation, in any thread, and append while a reader walks it, and a lock
taken by both would deadlock when the collection runs in the reader's own
thread.
"""

from __future__ import annotations

import collections
import gc
import threading
import time

from . import state

#: pauses kept: a 10,000-pod solve runs about 50 collections, most of them
#: of generation 0
RING = 1024


class GcPauses:
    """A bounded ring of the collector's pauses, fed by gc.callbacks."""

    def __init__(self, size: int = RING):
        self._ring: "collections.deque[tuple[int, int, int, int]]" = \
            collections.deque(maxlen=size)
        self._start_ns = 0
        self._installed = False
        self._lock = threading.Lock()

    def install(self) -> None:
        """Add the hook to gc.callbacks, once a process (idempotent)."""
        with self._lock:
            if not self._installed:
                gc.callbacks.append(self._on_gc)
                self._installed = True

    def _on_gc(self, phase: str, info: dict) -> None:
        if not state.enabled():
            self._start_ns = 0
            return
        if phase == "start":
            self._start_ns = time.perf_counter_ns()
        elif self._start_ns:
            self._ring.append((self._start_ns, time.perf_counter_ns(),
                               info["generation"], info["collected"]))
            self._start_ns = 0

    def between(self, start_ns: int, end_ns: int
                ) -> "list[tuple[int, int, int, int]]":
        """The pauses that began at or after `start_ns` and ended by
        `end_ns` (perf_counter_ns readings), oldest first."""
        if not state.enabled():
            return []
        out = []
        for pause in reversed(tuple(self._ring)):
            if pause[0] < start_ns:
                break
            if pause[1] <= end_ns:
                out.append(pause)
        out.reverse()
        return out

    def __len__(self) -> int:
        return len(self._ring)


GC_PAUSES = GcPauses()
