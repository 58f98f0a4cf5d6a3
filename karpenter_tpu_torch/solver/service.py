"""Solver gRPC service: the device-resident half of the architecture.

Copy of karpenter_tpu/solver/service.py for the PyTorch port, which imports
nothing of the JAX package, edited; tests/test_torch_copies.py holds it to
the original's names and bounds the edit. The service is split in two:

* its core works on the port's own objects and holds the resident-solver
  LRU, the pins, probation and the admission filter of the overload plane,
  the thrash accounting, the HBM pressure passes, the shape history and
  Sync-time warmup, the solve, the consolidation search, health and the
  profiler hook (`sync`, `solve`, `consolidate`, `health`). It imports
  neither grpc nor protobuf, so it runs on a machine that has neither (the
  CUDA card's); its failures are port exceptions (NotSynced, Shed);
* the RPC methods (Sync, Solve, Consolidate, Health, with the JAX
  package's names and signatures) and `serve` are its edge: they import
  the generated messages and edge.py (grpc) when called, turn messages
  into objects and back, key the core by the wire's content hashes
  (wire.catalog_hash / provisioners_hash, the JAX package's formula, so a
  controller of either package can use this sidecar), and turn NotSynced
  and Shed into FAILED_PRECONDITION and DEADLINE_EXCEEDED.

The service's solvers run on `device` (None: the CUDA card, which must be
present; "cpu": the plain PyTorch path). In a process group of two or
more ranks (solver-serve --distributed under torchrun) the service is rank
0 and builds the process's mesh context at its first Sync
(parallel/sharded.shared_context; the other ranks follow it): Sync answers
the mesh's rank count and shape, each solver's ShapeRouter has that many
devices, and Consolidate of CONSOLIDATE_LANE_MESH_MIN nodes or more runs
its lanes over the lane mesh. Where the JAX package logs a warning and
serves single-chip when its mesh fails to build, the port raises: a mesh
that was asked for never quietly becomes one card. Without a process group
(one card) Sync answers device_count=1 and mesh="", every ShapeRouter routes
`single` and Consolidate runs the one-shot lane search on the service's
device. Health reports the device type. With `trace_dir`,
every `trace_every`-th solve runs under torch.profiler (CUDA activity on
the card) and writes a Chrome trace there; a profiler failure never fails
a solve.

Parity/architecture target: SURVEY.md §7.1 — controller half <-> solver half
over gRPC (SolveRequest/SolveResponse), catalog arrays device-resident and
versioned by seqnum so only the pod delta crosses the boundary per solve.
The liveness Health RPC mirrors the reference's chained LivenessProbe
(upstream pkg/cloudprovider/cloudprovider.go:163-168).

Service stubs are registered with grpc generic handlers (the image has
grpcio but not grpcio-tools, so messages come from protoc --python_out and
the method table is wired by hand).
"""

from __future__ import annotations

import contextlib
import functools
import logging
import os
import threading
import time
from collections import OrderedDict
from typing import Optional, Sequence

from ..apis.provisioner import Provisioner
from ..device import resolve_device
from ..models.instancetype import Catalog
from ..tracing import TRACER
from .. import overload
from ..overload import eviction as overload_eviction
from ..overload import metrics as overload_metrics
from .core import SolveResult, TorchSolver
from . import buckets

log = logging.getLogger("karpenter.solver.service")

SERVICE_NAME = "karpenter.solver.Solver"

# Requests arriving with less remaining deadline budget (ms) than this are
# shed up front (DEADLINE_EXCEEDED): the caller's reconcile cycle will have
# given up on the answer before the solve finishes, so computing it only
# burns device time someone else is queued for.
SHED_MIN_BUDGET_MS = 10.0

# Consolidation requests with at least this many nodes run their
# candidate lanes over the persistent lane mesh (data parallelism) when the
# process group has one; below it the mesh's fixed collective cost
# dominates and the one-shot lane search runs on the service's device.
CONSOLIDATE_LANE_MESH_MIN = 64

# Most shape buckets a single Sync will warm: warmup runs inline in the
# Sync RPC, so the cap bounds Sync latency; the shape history keeps the
# spent dispatches the most useful ones.
WARMUP_LIMIT = 8

# When the HBM ledger reports residency above this fraction of the declared
# device capacity (KARPENTER_TPU_HBM_CAPACITY_BYTES), Sync evicts extra LRU
# entries beyond the count cap until pressure clears — a count-only LRU is
# blind to one giant catalog crowding out three small ones. Disarmed (no-op)
# when no capacity is declared, which is the CPU-host default.
HBM_PRESSURE_EVICT = 0.9

# With the overload plane enabled, a pressure eviction pass drains to this
# fraction in ONE pass instead of evicting exactly back under the trigger:
# per-request single evictions under sustained churn are the eviction-storm
# signature (evict one, next Sync re-triggers, repeat) — hysteresis between
# trigger and low-water makes pressure passes rare instead of constant.
HBM_LOW_WATER = 0.7

# Sliding window (in installs) over which a re-install of a recently
# evicted key counts as a thrash event. Always-on measurement: the churn
# drill's A/B needs the OFF window to report its thrash honestly too.
THRASH_WINDOW = 32


def hbm_key(key: "tuple[int, int]") -> str:
    """The ledger/metric label for a resident solver: the content-hash
    pair that IS the LRU identity, hex (matches the eviction log lines)."""
    return f"{key[0]:x}/{key[1]:x}"

def _hint_shape(pods: int) -> tuple:
    """Crude pod-count -> problem-shape mapping for warm_pod_counts hints:
    ~16 pods fold into one scheduling group in the deployment's workloads
    and slot demand tracks group count. Only the ladder rung matters —
    plan_for() buckets the result, so being 2x off usually lands on the
    same bucket anyway."""
    g = max(1, pods // 16)
    return (g, max(8, g), 0)


# RPC name -> (request, response) message class names in solver_pb2: the
# edge resolves them when it serves or calls, so this module imports
# without protobuf
METHODS = {
    "Sync": ("SyncRequest", "SyncResponse"),
    "Solve": ("SolveRequest", "SolveResponse"),
    "Consolidate": ("ConsolidateRequest", "ConsolidateResponse"),
    "Health": ("HealthRequest", "HealthResponse"),
}


def __getattr__(name: str):
    # `pb`, the generated messages (a module-level name in the JAX
    # package), imported on first use so this module imports without
    # protobuf
    if name == "pb":
        from . import solver_pb2

        return solver_pb2
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


class NotSynced(LookupError):
    """No resident solver for the key: the caller must Sync first."""


class Shed(RuntimeError):
    """The request's remaining deadline budget is below
    SHED_MIN_BUDGET_MS."""


def result_to_response(result: SolveResult, solve_ms: float,
                       seqnum: int):
    from . import solver_pb2 as pb

    def counts(d: "dict[int, int]"):
        return [pb.GroupCount(group=g, count=c) for g, c in sorted(d.items())]

    return pb.SolveResponse(
        nodes=[pb.NodeDecisionMsg(
            instance_type=n.option.itype.name,
            zone=n.option.zone,
            capacity_type=n.option.capacity_type,
            price=n.option.price,
            provisioner=n.provisioner.name,
            pods=counts(n.pod_counts),
        ) for n in result.nodes],
        existing=[pb.ExistingAssignmentMsg(node=name, pods=counts(per_group))
                  for name, per_group in sorted(result.existing_by_group.items())],
        unschedulable=counts(result.unschedulable),
        groups=[pb.GroupMsg(pod_names=list(g.pod_names)) for g in result.groups],
        solve_ms=solve_ms,
        catalog_seqnum=seqnum,
    )


class SolverService:
    """Stateful solver host: a small LRU of synced (catalog, provisioners)
    pairs, each with a TorchSolver whose device-resident grid persists
    across Solve calls. The LRU (vs a single slot) keeps multiple controller
    replicas with briefly divergent catalogs from thrashing grid rebuilds
    against each other — each replica's grid stays resident and its Solves
    are served directly."""

    LRU_CAPACITY = 4

    # probation side-car width: at most this many unearned newcomers hold
    # HBM at once — a churn stream of one-shot catalogs recycles this slot
    # among themselves and never touches the warm residents
    PROBATION_CAPACITY = 1

    def __init__(self, trace_dir: "Optional[str]" = None,
                 trace_every: int = 100,
                 crossover_cells: "Optional[int]" = None,
                 device=None):
        # where every solver of this service runs: no card and no
        # device="cpu" raises here, before anything is served
        self.device = resolve_device(device)
        self._lock = threading.Lock()
        # (cat_hash, prov_hash) -> (TorchSolver, seqnum); insertion order = LRU
        self._cache: "OrderedDict[tuple[int, int], tuple[TorchSolver, int]]" = \
            OrderedDict()
        # in-flight pin refcounts: a pinned entry can NEVER be evicted, so
        # a concurrent Sync's eviction pass cannot release a solver mid
        # solve (checkout/checkin). Unconditional correctness — not gated
        # on the overload plane.
        self._pins: "dict[tuple[int, int], int]" = {}
        # probation side-car (overload plane only): an unearned newcomer
        # lands here instead of displacing a warm resident; it is promoted
        # into the main LRU once the admission filter sees it again
        self._probation: "OrderedDict[tuple[int, int], tuple[TorchSolver, int]]" = \
            OrderedDict()
        self._admission = overload.AdmissionFilter()
        # always-on eviction-thrash accounting (see THRASH_WINDOW):
        # recently evicted key -> install-seq at eviction time
        self._installs = 0
        self._evictions = 0
        self._thrash_events = 0
        self._recent_evicted: "OrderedDict[tuple[int, int], int]" = \
            OrderedDict()
        # single-vs-sharded crossover shared by every solver's router
        # (None = env/default); one card routes every plan `single`
        self._crossover_cells = crossover_cells
        # the process's mesh context, looked up at the FIRST Sync (never in
        # __init__): None without a process group of >= 2 ranks
        self._mesh_ctx = None
        self._mesh_ctx_built = False
        # raw shape keys of recent Solves (most recent last, bounded):
        # the warmup working set a re-Sync warms first
        self._shape_seen: "OrderedDict[tuple, int]" = OrderedDict()
        # device-path profiling (SURVEY §5.1): when trace_dir is set, every
        # trace_every-th Solve runs under torch.profiler so production
        # captures the device timeline continuously
        self._trace_dir = trace_dir
        self._trace_every = max(1, trace_every)
        self._solve_count = 0
        self._trace_active = False  # single-flight: one profiler at a time

    def _mru(self) -> "tuple[Optional[TorchSolver], int, int]":
        """(solver, seqnum, cat_hash) of the most recently used entry.
        Callers must hold self._lock."""
        if not self._cache:
            return None, -1, 0
        key = next(reversed(self._cache))
        solver, seqnum = self._cache[key]
        return solver, seqnum, key[0]

    @property
    def _cat_hash(self) -> int:
        """Most-recently-used catalog hash (observability/tests)."""
        with self._lock:
            return self._mru()[2]

    # -- residency: pins, admission, eviction accounting ---------------------------

    def checkout(self, key: "tuple[int, int]") \
            -> "Optional[tuple[TorchSolver, int]]":
        """Pin + fetch the resident (solver, seqnum) for `key` (main LRU
        or the probation slot); None when not synced. While the pin is
        held no eviction pass — capacity, HBM pressure, or low-water —
        can release this solver, so a dispatch can never race an
        eviction. Callers MUST pair with checkin()."""
        with self._lock:
            entry = self._cache.get(key)
            if entry is not None:
                self._cache.move_to_end(key)
            else:
                entry = self._probation.get(key)
            if entry is None:
                return None
            self._pins[key] = self._pins.get(key, 0) + 1
            return entry

    def checkin(self, key: "tuple[int, int]") -> None:
        """Release one checkout() pin."""
        with self._lock:
            n = self._pins.get(key, 0) - 1
            if n > 0:
                self._pins[key] = n
            else:
                self._pins.pop(key, None)

    def _note_install_locked(self, key: "tuple[int, int]") -> None:
        self._installs += 1
        if key in self._recent_evicted:
            self._thrash_events += 1
            del self._recent_evicted[key]
        while self._recent_evicted:
            oldest, seq = next(iter(self._recent_evicted.items()))
            if self._installs - seq > THRASH_WINDOW:
                del self._recent_evicted[oldest]
            else:
                break

    def _note_eviction_locked(self, key: "tuple[int, int]") -> None:
        self._evictions += 1
        self._recent_evicted.pop(key, None)
        self._recent_evicted[key] = self._installs

    def _evict_one_locked(self, stores, *,
                          protect: "Optional[tuple[int, int]]" = None) \
            -> "Optional[tuple[int, int]]":
        """Evict the first UNPINNED entry (LRU order, probation before the
        main cache when both are offered) other than `protect`; releases
        its HBM ledger rows. None when every candidate is pinned — the
        count/pressure bound then yields to correctness and the caller
        stops evicting."""
        for store in stores:
            for k in store:
                if k == protect or self._pins.get(k, 0) > 0:
                    continue
                del store[k]
                buckets.HBM.release(hbm_key(k))
                self._note_eviction_locked(k)
                return k
        return None

    def eviction_stats(self) -> dict:
        """Always-on thrash accounting (statusz + churn drill A/B): a
        thrash event is an install of a key evicted within the last
        THRASH_WINDOW installs — the work-to-retain-nothing signature."""
        with self._lock:
            installs, evictions = self._installs, self._evictions
            thrash = self._thrash_events
            resident, probation = len(self._cache), len(self._probation)
            pinned = sum(1 for n in self._pins.values() if n > 0)
        ratio = (thrash / installs) if installs else 0.0
        return {"installs": installs, "evictions": evictions,
                "thrash_events": thrash, "thrash_ratio": round(ratio, 4),
                "window": THRASH_WINDOW, "resident": resident,
                "probation": probation, "pinned": pinned}

    def _device_context(self):
        """The process-lifetime mesh context (parallel/sharded
        .shared_context) when this process is rank 0 of a process group of
        two or more ranks, built at the FIRST Sync; None otherwise (the
        router then always picks single-card). A mesh that fails to build
        raises: it never degrades to one card."""
        with self._lock:
            if self._mesh_ctx_built:
                return self._mesh_ctx
        from ..parallel.sharded import shared_context, world_size

        ctx = shared_context(self.device) if world_size() >= 2 else None
        with self._lock:
            if not self._mesh_ctx_built:
                self._mesh_ctx = ctx
                self._mesh_ctx_built = True
            return self._mesh_ctx

    def _record_shape(self, solver: TorchSolver) -> None:
        key = solver.last_shape_key
        if key is None:
            return
        with self._lock:
            self._shape_seen[key] = self._shape_seen.pop(key, 0) + 1
            while len(self._shape_seen) > 32:
                self._shape_seen.popitem(last=False)

    def _warm(self, solver: TorchSolver, warm_pod_counts) -> int:
        """Sync-time warmup: dispatch the shape buckets traffic actually
        hits — the service's own recent-solve history first (exact shape
        keys), then the client's pod-count hints (crude pods->shape
        mapping; the ladder's coarse rungs absorb the sloppiness). Guarded:
        warmup can never fail a Sync."""
        shapes: "list[tuple]" = []
        with self._lock:
            shapes.extend(reversed(self._shape_seen))  # most recent first
        for count in warm_pod_counts:
            shapes.append(_hint_shape(int(count)))
        if not shapes:
            return 0
        try:
            return len(solver.warm_shapes(shapes, limit=WARMUP_LIMIT))
        except Exception as e:
            log.warning("shape warmup failed (serving cold): %s", e)
            return 0

    # -- the core: port objects in, port objects out ------------------------------

    def sync(self, key: "tuple[int, int]", catalog: Catalog,
             provisioners: Sequence[Provisioner], warm_pod_counts=(),
             trace_context=None) -> dict:
        """Install (or refresh) the resident solver for `key`, the content
        key pair the caller derived from `catalog` and `provisioners`, and
        warm it. -> the SyncResponse fields: seqnum, catalog_hash
        (key[0]), device_count, mesh, warmed_buckets."""
        with TRACER.start_span("solver.service.Sync", context=trace_context,
                               types=len(catalog.types)):
            return self._sync_traced(key, catalog, list(provisioners),
                                     warm_pod_counts)

    def _sync_traced(self, key, catalog: Catalog, provisioners,
                     warm_pod_counts) -> dict:
        # Staleness is keyed on catalog CONTENT, not seqnum: seqnums are
        # process-local counters that reset when a controller restarts, so a
        # fresh client with a low seqnum but identical content must be treated
        # as synced, and a content change must rebuild even if its seqnum is
        # lower than an installed one (content owns identity, not ordering).
        cat_hash = key[0]
        with self._lock:
            hit = self._cache.get(key)
            in_probation = False
            if hit is not None:
                # idempotent re-Sync: keep the device-resident grid
                self._cache.move_to_end(key)
                self._cache[key] = (hit[0], catalog.seqnum)
            else:
                hit = self._probation.get(key)
                in_probation = hit is not None
        if hit is not None:
            if in_probation:
                # a repeat sighting of a probationer: offer it to the
                # admission filter again — earning promotes the EXISTING
                # device-resident solver into the main LRU (no rebuild)
                earned = self._admission.offer(hbm_key(key))
                with self._lock:
                    entry = self._probation.pop(key, None)
                    if entry is not None and earned:
                        self._cache[key] = (entry[0], catalog.seqnum)
                        self._cache.move_to_end(key)
                        while len(self._cache) > self.LRU_CAPACITY:
                            if self._evict_one_locked((self._cache,),
                                                      protect=key) is None:
                                break
                    elif entry is not None:
                        self._probation[key] = (entry[0], catalog.seqnum)
                        self._probation.move_to_end(key)
            # re-Sync still warms: the client may ship fresh hints and the
            # shape history may have grown since the solver was installed
            warmed = self._warm(hit[0], warm_pod_counts)
            return self._sync_reply(catalog.seqnum, cat_hash, warmed)
        ctx = self._device_context()
        solver = TorchSolver(
            catalog, provisioners, device=self.device, mesh_ctx=ctx,
            router=buckets.ShapeRouter(
                n_devices=ctx.device_count if ctx is not None else 1,
                crossover_cells=self._crossover_cells))
        # the most recent resident solver donates its static grid arrays +
        # group-encode folds: an ICE-only catalog change (spot storms bump
        # content per message) then skips the grid rebuild AND the device
        # re-put of alloc/tiebreak — the layout check inside build_grid
        # decides, so a real layout change still rebuilds from scratch
        with self._lock:
            donor, _, _ = self._mru()
        if donor is not None:
            # the donor keeps serving its own clients from the LRU: copy the
            # static fold level rather than sharing the live cache dict
            solver.adopt_static(donor, share_group_cache=False)
        # build + device-put the option grid OUTSIDE the lock so Health stays
        # responsive during catalog churn, then swap atomically; the hbm
        # scope files the grid's device puts under this solver's ledger key
        plane_on = overload.enabled()
        to_probation = False
        if plane_on:
            with self._lock:
                full = len(self._cache) >= self.LRU_CAPACITY
            # a residency cap that fits fewer solvers than LRU_CAPACITY
            # means the COUNT never fills — crowding shows up as ledger
            # pressure instead, and above the low-water mark one more
            # resident forces a drain just as surely as a full LRU does
            pressure = buckets.HBM.pressure()
            crowded = pressure is not None and pressure >= HBM_LOW_WATER
            if full or crowded:
                # installing would evict a warm resident: a newcomer must
                # have EARNED that (one-shot catalog hashes stay on
                # probation and recycle one slot instead)
                to_probation = not self._admission.offer(hbm_key(key))
        with buckets.hbm_scope(hbm_key(key)):
            solver.grid()
        with self._lock:
            if to_probation:
                while len(self._probation) >= self.PROBATION_CAPACITY:
                    if self._evict_one_locked((self._probation,),
                                              protect=key) is None:
                        break
                self._probation[key] = (solver, catalog.seqnum)
                self._note_install_locked(key)
            else:
                if not plane_on and self._probation:
                    # plane toggled off with probationers resident: drain
                    # them — disabled must behave like the plain LRU
                    while self._probation:
                        if self._evict_one_locked((self._probation,),
                                                  protect=key) is None:
                            break
                self._cache[key] = (solver, catalog.seqnum)
                self._cache.move_to_end(key)
                self._note_install_locked(key)
                while len(self._cache) > self.LRU_CAPACITY:
                    evicted_key = self._evict_one_locked((self._cache,),
                                                         protect=key)
                    if evicted_key is None:
                        break  # all pinned: bound yields to correctness
                    log.info("evicted solver for catalog hash=%x",
                             evicted_key[0])
                    if plane_on:
                        overload_metrics.EVICTIONS.inc(cause="capacity")
            # HBM pressure pass: residency, not count, is what actually
            # overflows a device — keep at least the entry just installed
            pressure = buckets.HBM.pressure()
            if plane_on:
                # low-water drain: one pass down to HBM_LOW_WATER — the
                # hysteresis band between trigger and mark keeps pressure
                # passes rare under churn instead of one-per-request
                evicted_n = 0
                if pressure is not None and pressure > HBM_PRESSURE_EVICT:
                    while (pressure is not None
                           and pressure > HBM_LOW_WATER
                           and len(self._cache) + len(self._probation) > 1):
                        evicted_key = self._evict_one_locked(
                            (self._probation, self._cache), protect=key)
                        if evicted_key is None:
                            break
                        evicted_n += 1
                        log.info("HBM pressure %.2f: evicted solver for "
                                 "catalog hash=%x (low-water drain)",
                                 pressure, evicted_key[0])
                        pressure = buckets.HBM.pressure()
                    overload_eviction.note_lowwater(evicted_n)
            else:
                while (pressure is not None
                       and pressure > HBM_PRESSURE_EVICT
                       and len(self._cache) > 1):
                    evicted_key = self._evict_one_locked((self._cache,),
                                                         protect=key)
                    if evicted_key is None:
                        break  # all pinned: bound yields to correctness
                    log.info("HBM pressure %.2f: evicted solver for "
                             "catalog hash=%x", pressure, evicted_key[0])
                    pressure = buckets.HBM.pressure()
        if plane_on:
            overload_metrics.THRASH_RATIO.set(
                self.eviction_stats()["thrash_ratio"])
        warmed = self._warm(solver, warm_pod_counts)
        log.info("synced catalog seqnum=%d hash=%x (%d types, %d "
                 "provisioners, %d buckets warmed)",
                 catalog.seqnum, cat_hash, len(catalog.types),
                 len(provisioners), warmed)
        return self._sync_reply(catalog.seqnum, cat_hash, warmed)

    def _sync_reply(self, seqnum: int, cat_hash: int, warmed: int) -> dict:
        ctx = self._device_context()
        return {"seqnum": seqnum, "catalog_hash": cat_hash,
                "device_count": ctx.device_count if ctx is not None else 1,
                "mesh": ctx.describe() if ctx is not None else "",
                "warmed_buckets": warmed}

    def solve(self, key: "tuple[int, int]", pods, existing=(),
              daemon_overhead: "Optional[Sequence[int]]" = None,
              deadline_ms: int = 0, tenant_id: str = "",
              trace_context=None) -> "tuple[SolveResult, dict]":
        """Solve on the resident solver for `key`. -> (result, info), info
        holding what the Solve RPC echoes: solve_ms, seqnum, routing,
        compile_cache, transfer_ms, bucket, device_count. Raises NotSynced
        when `key` is not resident and Shed when `deadline_ms` (remaining
        budget, 0 = none) is below SHED_MIN_BUDGET_MS."""
        with self._solving(key, len(pods), deadline_ms, tenant_id,
                           trace_context) as run:
            return run(list(pods), list(existing), daemon_overhead)

    @contextlib.contextmanager
    def _solving(self, key, n_pods: int, deadline_ms, tenant_id: str,
                 trace_context):
        """The solve's span, pin, shed check and gap-ledger wall bracket
        around the caller's body, which gets the runner; the Solve RPC
        decodes and encodes its messages inside it."""
        # join the caller's trace when it sent one (wire trace_context);
        # an untraced caller roots a fresh service-local trace instead
        span = TRACER.start_span("solver.service.Solve",
                                 context=trace_context, pods=n_pods)
        if tenant_id:
            # multi-tenant fleet callers tag their cluster; the solver
            # stays tenant-blind but the trace shouldn't
            span.set_attribute("tenant", tenant_id)
        try:
            # checkout pins the entry for the whole dispatch: a concurrent
            # Sync's eviction pass (capacity, pressure, or low-water) can
            # never release this solver's device grid mid-solve
            entry = self.checkout(key)
            if entry is None:
                raise NotSynced(f"catalog hash={key[0]:x} not synced; "
                                f"re-Sync required")
            try:
                if deadline_ms and deadline_ms < SHED_MIN_BUDGET_MS:
                    raise Shed(f"{deadline_ms}ms of cycle budget remaining; "
                               f"shedding solve")
                from ..profiling import GAP_LEDGER

                # the gap ledger's OUTERMOST wall bracket for remote
                # callers: wire decode + solve + response encode all file
                # against this wall
                with GAP_LEDGER.solve_scope("service"):
                    yield functools.partial(self._run_solve, key, entry,
                                            span)
            finally:
                self.checkin(key)
        except BaseException as e:
            span.set_attribute("error", True)
            span.set_attribute("error.type", type(e).__name__)
            raise
        finally:
            span.end()

    def _run_solve(self, key, entry, span, pods, existing,
                   overhead) -> "tuple[SolveResult, dict]":
        solver, seqnum = entry
        with self._lock:
            self._solve_count += 1
            trace_now = (self._trace_dir is not None
                         and (self._solve_count - 1) % self._trace_every == 0
                         and not self._trace_active)
            if trace_now:
                self._trace_active = True
        t0 = time.perf_counter()
        # the hbm scope attributes this solve's delta uploads to the
        # resident solver; the rung is attributed after the solve, once
        # the bucket label is known (attribute_delta below)
        if trace_now:
            result = self._traced_solve(solver, key, pods, existing,
                                        overhead)
        else:
            with buckets.hbm_scope(hbm_key(key)):
                result = solver.solve(pods, existing=existing,
                                      daemon_overhead=overhead or None)
        solve_ms = (time.perf_counter() - t0) * 1000
        self._record_shape(solver)
        si = getattr(solver, "last_solve_info", None) or {}
        info = {"solve_ms": solve_ms, "seqnum": seqnum,
                "routing": str(si.get("routing", self.device.type)),
                "compile_cache": str(si.get("compile_cache", "unknown")),
                "transfer_ms": float(si.get("transfer_ms", 0.0)),
                "bucket": str(si.get("bucket", "")),
                "device_count": int(si.get("device_count", 1))}
        # file the solve's pending delta bytes under its actual rung
        buckets.HBM.attribute_delta(hbm_key(key), info["bucket"] or "unknown")
        span.set_attributes(routing=info["routing"],
                            compile_cache=info["compile_cache"],
                            transfer_ms=info["transfer_ms"],
                            bucket=info["bucket"],
                            device_count=info["device_count"],
                            solve_ms=solve_ms)
        return result, info

    def _traced_solve(self, solver, key, pods, existing, overhead):
        """One solve under torch.profiler, its Chrome trace written into
        trace_dir. Profiling must never fail a production Solve: start and
        stop are guarded apart, so an unwritable dir or a failing profiler
        degrades to an untraced solve."""
        prof = None
        try:
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                activities.append(ProfilerActivity.CUDA)
            prof = profile(activities=activities)
            prof.start()
        except Exception as e:
            log.warning("profiler start failed: %s", e)
            prof = None
        try:
            with buckets.hbm_scope(hbm_key(key)):
                return solver.solve(pods, existing=existing,
                                    daemon_overhead=overhead or None)
        finally:
            if prof is not None:
                try:
                    prof.stop()
                    os.makedirs(self._trace_dir, exist_ok=True)
                    path = os.path.join(
                        self._trace_dir,
                        f"solve-{self._solve_count}.trace.json")
                    prof.export_chrome_trace(path)
                    log.info("profiler trace for solve #%d -> %s",
                             self._solve_count, path)
                except Exception as e:
                    log.warning("profiler stop failed: %s", e)
            with self._lock:
                self._trace_active = False

    def consolidate(self, key: "tuple[int, int]", nodes,
                    eligible_names, daemon_overhead=None, now: float = 0.0,
                    multi_node: bool = True,
                    max_pair_candidates: "Optional[int]" = None,
                    deadline_ms: int = 0, trace_context=None):
        """The consolidation search on the service's device against the
        resident catalog of `key`: `nodes` are the cluster's StateNodes and
        `eligible_names` the controller's pre-computed eligibility verdicts
        (the service has no PDB store). -> (action or None, ms). Raises
        NotSynced and Shed as solve does."""
        from ..models.cluster import ClusterState
        from ..oracle.consolidation import MAX_PAIR_CANDIDATES
        from ..ops.consolidate import run_consolidation

        with TRACER.start_span("solver.service.Consolidate",
                               context=trace_context,
                               nodes=len(nodes)) as span:
            # checkout pins the entry for the candidate search — the same
            # eviction-vs-dispatch race solve closes (see _solving)
            entry = self.checkout(key)
            if entry is None:
                raise NotSynced(f"catalog hash={key[0]:x} not synced; "
                                f"re-Sync required")
            try:
                if deadline_ms and deadline_ms < SHED_MIN_BUDGET_MS:
                    raise Shed(f"{deadline_ms}ms of cycle budget "
                               f"remaining; shedding consolidation")
                solver, _seqnum = entry
                cluster = ClusterState()
                for node in nodes:
                    cluster.add_node(node)
                eligible = set(eligible_names)
                # big requests shard their candidate lanes over the
                # persistent lane mesh (data parallelism); small ones stay
                # on the service's device
                ctx = self._device_context()
                lane_mesh = (ctx.lane_mesh if ctx is not None
                             and len(nodes) >= CONSOLIDATE_LANE_MESH_MIN
                             else None)
                t0 = time.perf_counter()
                action = run_consolidation(
                    cluster, solver.catalog, solver.provisioners,
                    daemon_overhead=daemon_overhead or None, now=now,
                    grid=solver.grid(),  # Sync'd device-resident — no rebuild
                    multi_node=multi_node,
                    max_pair_candidates=(MAX_PAIR_CANDIDATES
                                         if max_pair_candidates is None
                                         else max_pair_candidates),
                    candidate_filter=lambda n: n.name in eligible,
                    mesh=lane_mesh, device=self.device)
                ms = (time.perf_counter() - t0) * 1000
                span.set_attributes(found=action is not None,
                                    consolidate_ms=ms)
                return action, ms
            finally:
                self.checkin(key)

    def health(self) -> dict:
        """-> the HealthResponse fields: ok, backend (the device type),
        catalog_seqnum and n_types of the most recently used solver."""
        with self._lock:
            solver, seqnum, _ = self._mru()
            n_types = len(solver.catalog.types) if solver else 0
        return {"ok": True, "backend": self.device.type,
                "catalog_seqnum": seqnum, "n_types": n_types}

    # -- RPC methods (the edge; called by the generic handler) -------------------

    def Sync(self, request, context):
        from . import solver_pb2 as pb
        from . import wire

        provisioners = [wire.provisioner_from_wire(m)
                        for m in request.provisioners]
        key = (wire.catalog_hash(request.catalog),
               wire.provisioners_hash(provisioners))
        reply = self.sync(
            key, wire.catalog_from_wire(request.catalog), provisioners,
            warm_pod_counts=list(request.warm_pod_counts),
            trace_context=wire.trace_context_from_wire(request.trace_context))
        return pb.SyncResponse(**reply)

    def Solve(self, request, context):
        from ..profiling import GAP_LEDGER
        from . import wire

        key = (request.catalog_hash, request.provisioner_hash)
        try:
            with self._solving(
                    key, len(request.pods), request.deadline_ms,
                    request.tenant_id,
                    wire.trace_context_from_wire(request.trace_context)) as run:
                w0 = time.perf_counter()
                pods = [wire.pod_from_wire(m) for m in request.pods]
                existing = [wire.existing_from_wire(m)
                            for m in request.existing]
                overhead = list(request.daemon_overhead) or None
                wire_in_s = time.perf_counter() - w0
                TRACER.record_span("solver.serialize", wire_in_s,
                                   direction="decode", pods=len(pods))
                GAP_LEDGER.note("serialize", wire_in_s, lane="wire")
                result, info = run(pods, existing, overhead)
                e0 = time.perf_counter()
                resp = result_to_response(result, info["solve_ms"],
                                          info["seqnum"])
                wire_out_s = time.perf_counter() - e0
                TRACER.record_span("solver.serialize", wire_out_s,
                                   direction="encode")
                GAP_LEDGER.note("serialize", wire_out_s, lane="wire")
                # echo the device-path observability back over the wire so
                # the CLIENT-side rpc span carries the same attributes
                for field in ("routing", "compile_cache", "transfer_ms",
                              "bucket", "device_count"):
                    setattr(resp, field, info[field])
                return resp
        except (NotSynced, Shed) as e:
            from .edge import abort

            abort(context, e)

    def Consolidate(self, request, context):
        """The consolidation search on the service's device: the controller
        ships cluster-state views (with its PDB/do-not-evict eligibility
        verdicts pre-computed), the service runs the batched candidate/pair
        kernels against the SYNCED catalog and returns the chosen action —
        the deployment's chip never has to live in the controller container
        (SURVEY.md 7.1 split)."""
        from . import wire

        nodes, eligible = [], set()
        for msg in request.nodes:
            node, node_eligible = wire.consolidation_node_from_wire(msg)
            nodes.append(node)
            if node_eligible:
                eligible.add(node.name)
        try:
            action, ms = self.consolidate(
                (request.catalog_hash, request.provisioner_hash), nodes,
                eligible, daemon_overhead=list(request.daemon_overhead),
                now=request.now, multi_node=request.multi_node,
                # -1 = unset sentinel -> server default; 0 legitimately
                # DISABLES the pair search (proto3 zero-value trap)
                max_pair_candidates=(None if request.max_pair_candidates < 0
                                     else request.max_pair_candidates),
                deadline_ms=request.deadline_ms,
                trace_context=wire.trace_context_from_wire(
                    request.trace_context))
        except (NotSynced, Shed) as e:
            from .edge import abort

            abort(context, e)
        return wire.action_to_response(action, ms)

    def Health(self, request, context):
        from . import solver_pb2 as pb

        return pb.HealthResponse(**self.health())


def serve(address: str = "127.0.0.1:0", max_workers: int = 4,
          service: Optional[SolverService] = None, device=None):
    """Start the solver service; returns (server, bound_port, service).
    Without `service`, a SolverService on `device` (None: the CUDA card).
    Solves are serialized per-solver by the GIL+device anyway; max_workers>1
    keeps Health responsive during long solves. Needs grpcio (edge.py)."""
    from .edge import serve_grpc

    service = service or SolverService(device=device)
    server, port = serve_grpc(service, address, max_workers)
    log.info("solver service listening on port %d", port)
    return server, port, service
