"""One problem's pack as the replay of a CUDA graph, one graph a pack shape.

pack_flat enqueues some 30 small kernels a pack and 93 a pack step
(ops/packer.py), and each pays Python dispatch and a launch on the host
while the card waits. Nothing inside the pack reads the device back and
its trip count n_eff comes from the host, so the whole pack of one shape,
the open-claim fill's launches included, can be captured once as a CUDA
graph and replayed:

* PackGraphs is a solver's cache of them (TorchSolver keeps one, so they
  go with the solver when the service evicts it or a Sync installs another
  catalog): at most MAX_GRAPHS, the least recently used out first. A key
  gets a graph only when it is seen a second time: its first pack runs
  eager, as a solver without graphs packs, so a shape that never repeats
  costs nothing more (the keys seen once are kept as many, the least
  recently seen forgotten first). Its key is what decides the captured
  kernels and their pointers: n_slots, n_eff, the shape of every uploaded
  leaf (the padded plan, the resource width, Pv and which optional leaves
  are present), and the identity and shape of every leaf already on the
  device (the resident alloc_t and tiebreak). The exact n_eff keeps a
  replay's work that of the eager pack, with no padded steps.
* PackGraph is one key's graph and its static inputs: a host staging
  buffer (pinned on the card) and a device buffer of the same bytes, every
  uploaded leaf a view at a fixed offset, aligned so that group_feas keeps
  the option-word alignment OpenClaimFill checks. A pack copies its fields
  into the staging views (np.copyto, with _to_tensor's casts), and one
  host-to-device copy replaces an upload a leaf.
* The first pack of a key's graph runs eager on the static views, which
  answers it (allocator growth and the fill's first-call checks happen
  there, and device.LAUNCHES counts what ran); then pack_flat on the same
  views is captured, its launch counts held aside. Every later pack
  stages, copies and replays, and adds the held counts: the same kernels
  in the same order on the same buffers, each zero-initialised state
  tensor zeroed again inside the graph, so the flat buffer equals the
  eager one bit for bit.
* A replay writes the graph's static buffers and its output, so a key is
  held from staging until the output has been read (PackGraphs.lease). A
  pack that finds its key held runs eager. PACKS counts the leases by
  the way their pack ran.
* A capture is thread-local (capture_error_mode="thread_local"): a graph
  or a buffer freed in another thread meanwhile, as a solver dropped
  there frees its graphs, does not invalidate it.

A capture exists only on a CUDA device. The solver engages the cache on
its single route alone, for one problem: the CPU, the mesh
(parallel/sharded.py), solve_many's lane packs and consolidation's
pack_lanes run eager.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import gc
import threading
from typing import Callable, Optional

import numpy as np
import torch

from ..device import LAUNCHES
from ..metrics import REGISTRY
from ..solver import buckets
from .packer import _BOOL_FIELDS, PackInputs, _to_tensor, pack_flat

# graphs a solver keeps, the least recently used evicted first (and as
# many keys seen once)
MAX_GRAPHS = 16
# byte alignment of every leaf in the staging buffers
_ALIGN = 64

PACKS = REGISTRY.counter(
    "karpenter_solver_pack_graph_packs_total",
    "Single-problem packs on a device that captures CUDA graphs, by way "
    "(first = a shape's first sighting, held = its graph in use by another "
    "pack, both eager; capture; replay).",
    ("way",))


def capture_cuda(fn: Callable[[], torch.Tensor]):
    """Capture fn()'s kernels on a side stream into a graph of their own
    memory pool: -> (graph, fn's output as captured, the launches the
    capture counted, held aside). The capture is thread-local: other
    threads keep using the card meanwhile."""
    graph = torch.cuda.CUDAGraph()
    # a collection inside the capture may destroy a CUDA object, which
    # invalidates the capture
    collecting = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.stream(torch.cuda.Stream()), \
                LAUNCHES.held() as launches:
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                out = fn()
            except BaseException:
                try:
                    graph.capture_end()
                except RuntimeError:
                    pass  # the capture broke with fn; fn's error is the one
                raise
            graph.capture_end()
    finally:
        if collecting:
            gc.enable()
    return graph, out, launches


def key_of(fields: dict, n_slots: int, n_eff: int) -> tuple:
    """The graph key of a pack of these fields (see the module docstring)."""
    parts = []
    for name in PackInputs._fields:
        v = fields.get(name)
        if v is None:
            parts.append(None)
        elif isinstance(v, torch.Tensor):
            parts.append((v.data_ptr(), tuple(v.shape), v.dtype))
        else:
            parts.append(np.shape(v))
    return (n_slots, n_eff, *parts)


class PackGraph:
    """One key's graph, its static inputs and its output. Used by the
    holder of its lock only (PackGraphs.lease)."""

    def __init__(self, device: torch.device, capture):
        self.lock = threading.Lock()
        self.device = device
        self._capture = capture
        self._host: Optional[torch.Tensor] = None   # uint8 staging
        self._dev: Optional[torch.Tensor] = None    # uint8 on the device
        self._views: "dict[str, np.ndarray]" = {}   # leaf -> staging view
        self.inputs: Optional[PackInputs] = None    # the static views
        self.graph = None
        self.flat: Optional[torch.Tensor] = None    # the graph's output
        self.launches: "dict[str, int]" = {}        # counted by a replay
        self.replayed = False                       # the last run's way

    def _allocate(self, fields: dict) -> None:
        """The staging and device buffers, and every uploaded leaf's view
        into both at its offset."""
        spans, off = {}, 0
        for name in PackInputs._fields:
            v = fields.get(name)
            # a host array goes up through the staging buffers; a tensor
            # (the resident catalog arrays) is used as it is
            if v is not None and not isinstance(v, torch.Tensor):
                dtype = np.bool_ if name in _BOOL_FIELDS else np.int32
                nbytes = int(np.prod(np.shape(v), dtype=np.int64)) \
                    * np.dtype(dtype).itemsize
                spans[name] = (off, nbytes, dtype)
                off += -(-nbytes // _ALIGN) * _ALIGN
        size = max(off, _ALIGN)
        self._host = torch.empty(size, dtype=torch.uint8,
                                 pin_memory=self.device.type == "cuda")
        self._dev = torch.empty(size, dtype=torch.uint8, device=self.device)
        host = self._host.numpy()
        leaves = {}
        for name in PackInputs._fields:
            v = fields.get(name)
            if name not in spans:
                leaves[name] = None if v is None \
                    else _to_tensor(name, v, self.device)
                continue
            o, n, dtype = spans[name]
            shape = np.shape(v)
            self._views[name] = host[o:o + n].view(dtype).reshape(shape)
            leaves[name] = self._dev[o:o + n].view(
                torch.bool if dtype is np.bool_ else torch.int32
            ).view(shape)
        self.inputs = PackInputs(**leaves)

    def stage(self, fields: dict) -> None:
        """Copy the pack's host arrays into the staging views and the
        staging buffer to the device (one copy, counted as this solve's
        `delta` upload)."""
        if self.inputs is None:
            self._allocate(fields)
        for name, view in self._views.items():
            np.copyto(view, fields[name], casting="unsafe")
        nbytes = float(self._host.nbytes)
        buckets.UPLOADS.inc(tensor="delta")
        buckets.UPLOAD_BYTES.inc(nbytes, tensor="delta")
        buckets.HBM.track(nbytes, "delta")
        self._dev.copy_(self._host, non_blocking=True)

    def run(self, fields: dict, n_slots: int, n_eff: int,
            span=None) -> torch.Tensor:
        """The pack of `fields` (of this graph's key) -> its flat buffer on
        the device, valid until the lock is released. The first run packs
        eager and captures; later runs replay. `span` (a CudaEventSpan)
        brackets the pack's kernels, after the upload."""
        self.stage(fields)
        if span is not None:
            span.start()
        if self.graph is None:
            flat = pack_flat(self.inputs, n_slots, n_eff)
            self.graph, self.flat, self.launches = self._capture(
                functools.partial(pack_flat, self.inputs, n_slots, n_eff))
            self.replayed = False
        else:
            self.graph.replay()
            for kernel, n in self.launches.items():
                LAUNCHES.add(kernel, n)
            flat = self.flat
            self.replayed = True
        if span is not None:
            span.stop()
        return flat


class PackGraphs:
    """A solver's graphs, one a pack key seen twice, the least recently
    used evicted past MAX_GRAPHS (`evictions` counts them). `capture`
    makes a graph (capture_cuda on a CUDA device, none elsewhere: the
    cache then never engages); the tests give a stand-in."""

    def __init__(self, device, capture: Optional[Callable] = None):
        self.device = torch.device(device)
        if capture is None and self.device.type == "cuda":
            capture = capture_cuda
        self._capture = capture
        self._lock = threading.Lock()
        self._graphs: "collections.OrderedDict[tuple, PackGraph]" = \
            collections.OrderedDict()
        self._seen: "collections.OrderedDict[tuple, None]" = \
            collections.OrderedDict()               # keys seen once
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._graphs)

    @contextlib.contextmanager
    def lease(self, fields: dict, n_slots: int, n_eff: int):
        """Yield the held PackGraph of this pack's key, released on exit,
        or None: no capture on this device, the key's first sighting, or
        the key held by another pack (the caller then runs the eager
        pack)."""
        if self._capture is None:
            yield None
            return
        key = key_of(fields, n_slots, n_eff)
        with self._lock:
            graph = self._graphs.get(key)
            if graph is not None:
                self._graphs.move_to_end(key)
            elif key in self._seen:
                del self._seen[key]
                graph = self._graphs[key] = PackGraph(self.device,
                                                      self._capture)
                while len(self._graphs) > MAX_GRAPHS:
                    self._graphs.popitem(last=False)
                    self.evictions += 1
            else:
                self._seen[key] = None
                while len(self._seen) > MAX_GRAPHS:
                    self._seen.popitem(last=False)
        if graph is None:
            PACKS.inc(way="first")
            yield None
            return
        if not graph.lock.acquire(blocking=False):
            PACKS.inc(way="held")
            yield None
            return
        try:
            PACKS.inc(way="capture" if graph.graph is None else "replay")
            yield graph
        finally:
            graph.lock.release()
