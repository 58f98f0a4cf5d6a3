"""The solver service's resident heap, moved into the collector's permanent
generation once a Sync has changed what is resident.

A generation-2 collection walks every object the interpreter tracks. In a
process that serves a resident solver most of them are the solver, its
catalog and torch's modules, none of which can become garbage while the
service holds them, and a 10,000-pod Solve allocates enough to start such a
collection every few Solves. So after a Sync that installed or evicted, the
service freezes the live heap (gc.freeze), and the Solves' collections walk
only what was made since.

A frozen object is never collected. An evicted solver may sit in reference
cycles, and its device tensors with it, so a Sync that evicted, and the first
Sync of a service, unfreeze and collect the whole heap before they freeze
again; any other installing Sync collects only what the last freeze left
out, which walks nothing frozen.
"""

from __future__ import annotations

import gc
import threading
from typing import Optional


class ResidentHeap:
    """A service's freezes of the heap, and their counts."""

    def __init__(self):
        # one settle at a time: a freeze between another settle's unfreeze
        # and its collection would freeze the evicted garbage again
        self._settling = threading.Lock()
        # the service's (installs, evictions) at the last freeze
        self._seen: "Optional[tuple[int, int]]" = None
        # (freezes, full collections, objects frozen), replaced whole
        self._counts = (0, 0, 0)

    def settle(self, installs: int, evictions: int) -> None:
        """After a Sync, given the service's install and eviction counts:
        nothing if neither moved since the last freeze; else collect, the
        whole heap where this is the first freeze or an eviction came
        since, and freeze what is left."""
        with self._settling:
            seen, self._seen = self._seen, (installs, evictions)
            if seen == (installs, evictions):
                return
            full = seen is None or seen[1] != evictions
            if full:
                gc.unfreeze()
            gc.collect()
            gc.freeze()
            freezes, fulls, _ = self._counts
            self._counts = (freezes + 1, fulls + full, gc.get_freeze_count())

    def stats(self) -> dict:
        freezes, fulls, frozen = self._counts
        return {"heap_freezes": freezes, "heap_full_collects": fulls,
                "heap_frozen": frozen}
