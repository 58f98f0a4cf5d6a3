"""Dependency-free span tracing (same zero-deps stance as metrics/).

Copy of karpenter_tpu/tracing/__init__.py for the PyTorch port, which
imports nothing of the JAX package, edited; tests/test_torch_copies.py
holds it to the original's names and bounds the edit. record_span takes a
span's start, the registry names the solve's inner phases and its garbage
collections, and ids come from a generator of the tracer's own.

The scheduling cycle is really a routing decision between a ~7ms native
path and a ~129ms on-chip path with poorly understood state transitions
(BENCH_r05 link_state.after_first_read: 0.05ms -> 68ms); duration
histograms alone cannot attribute a slow cycle to its phase. This module
adds the missing causal layer: spans with parent links, attributes, a
thread-safe bounded ring buffer of finished spans, and Chrome
`trace_event` JSON export loadable in Perfetto / chrome://tracing.

Span taxonomy (names double as the `phase` label of the
karpenter_scheduling_phase_duration_seconds histogram):

  provisioning.cycle            root, one per reconcile_once
    provisioning.mask           constraint-mask build (catalog/zones/overhead)
    provisioning.solve          routed solve; attrs: routing, pods,
                                compile_cache, transfer_ms
    provisioning.bind           launch + bind (_apply)
  deprovisioning.cycle          root, one per reconcile_once
    deprovisioning.<mechanism>  emptiness | expiration | drift | consolidation
  solver.rpc.<Method>           client side of the wire (RemoteSolver)
  solver.service.<Method>       sidecar side; joins the caller's trace via
                                the wire trace_context field
  solver.solve                  in-process solver pipeline; attrs:
                                encode_ms, dispatch_ms, transfer_ms,
                                decode_ms, compile_cache
    solver.split                the co-pending affinity split; attrs: pods
    solver.encode               children: .groups (attrs: pods, groups),
                                .fold (attrs: hits, misses), .bounds
    solver.dispatch.execute     children: solver.dispatch.inputs (padding),
                                solver.dispatch.enqueue (upload and
                                launches; attrs: steps)
    solver.transfer, solver.decode
    runtime.gc                  a garbage collection inside a solve; attrs:
                                generation, collected

Trace context crosses the solver wire as (trace_id, span_id) strings —
see solver/wire.py trace_context_to_wire / trace_context_from_wire.

Export surfaces: serving.py `/debug/traces` (recent traces as JSON;
`?id=<trace_id>` returns that trace as Chrome trace_event JSON), and the
span-end hook feeding metrics.REGISTRY so Prometheus and traces agree.
"""

from __future__ import annotations

import collections
import json
import os
import random
import threading
import time
from typing import Optional

from ..metrics import NAMESPACE, REGISTRY

PHASE_METRIC = f"{NAMESPACE}_scheduling_phase_duration_seconds"

# finished-span ring capacity: ~200 traces of a dozen spans; bounded so a
# long-lived operator cannot grow without limit (KARPENTER_TPU_TRACE_RING
# overrides for soak tests)
_DEFAULT_RING = 2048

#: Every LITERAL span name the codebase records, in one place. The
#: profiling gap ledger maps its phase table onto entries here, and
#: hack/check_phase_accounting.py (make presubmit) fails the build when a
#: span literal appears in code without appearing below — the drift
#: tripwire that keeps attribution accounting honest. Span families built
#: with f-strings (client RPC methods, deprovisioning mechanisms) are
#: covered by DYNAMIC_PHASE_PREFIXES instead.
PHASE_REGISTRY = (
    "provisioning.cycle",
    "provisioning.mask",
    "provisioning.solve",
    "provisioning.bind",
    "provisioning.bind.existing",
    "provisioning.bind.pods",
    "provisioning.create",
    "deprovisioning.cycle",
    "deprovisioning.emptiness",
    "deprovisioning.expiration",
    "deprovisioning.drift",
    "deprovisioning.consolidation",
    "solver.service.Sync",
    "solver.service.Solve",
    "solver.service.Consolidate",
    "solver.extract",
    "solver.warm_start",
    "solver.split",
    "solver.encode",
    "solver.encode.groups",
    "solver.encode.fold",
    "solver.encode.bounds",
    "solver.serialize",
    "solver.dispatch.execute",
    "solver.dispatch.inputs",
    "solver.dispatch.enqueue",
    "solver.dispatch.compile",
    "solver.transfer",
    "solver.decode",
    "ingest.decode",
    "ingest.apply",
    "fleet.queue_wait",
    "runtime.gc",
)

#: prefixes legitimising dynamically-built span names (f-strings)
DYNAMIC_PHASE_PREFIXES = (
    "solver.rpc.",
    "deprovisioning.",
)


# span and trace ids: a generator of the tracer's own, seeded from
# os.urandom and again in a forked child, so an id costs no system call
# (a solve files a span for each of its phases and collections) and no
# caller's random.seed() repeats one
_IDS = random.Random()
if hasattr(os, "register_at_fork"):
    os.register_at_fork(after_in_child=_IDS.seed)


def _new_id(nbytes: int = 8) -> str:
    return f"{_IDS.getrandbits(nbytes * 8):0{nbytes * 2}x}"


class SpanContext:
    """The propagatable identity of a span: (trace_id, span_id). This is
    what crosses the solver wire; everything else stays process-local."""

    __slots__ = ("trace_id", "span_id")

    def __init__(self, trace_id: str, span_id: str):
        self.trace_id = trace_id
        self.span_id = span_id

    def __bool__(self) -> bool:
        return bool(self.trace_id)

    def __repr__(self):
        return f"SpanContext(trace_id={self.trace_id!r}, span_id={self.span_id!r})"


class Span:
    """One timed operation. Created by Tracer.start_span; usable as a
    context manager (ends on exit, exceptions recorded as error=True)."""

    def __init__(self, tracer: "Tracer", name: str, trace_id: str,
                 span_id: str, parent_id: str, attributes: dict):
        self.tracer = tracer
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.attributes = dict(attributes)
        self.start_ts = time.time()
        self._t0 = time.perf_counter()
        self.duration_s: "Optional[float]" = None
        self.thread_id = threading.get_ident()
        self.thread_name = threading.current_thread().name

    def context(self) -> SpanContext:
        return SpanContext(self.trace_id, self.span_id)

    def set_attribute(self, key: str, value) -> "Span":
        self.attributes[key] = value
        return self

    def set_attributes(self, **attrs) -> "Span":
        self.attributes.update(attrs)
        return self

    def end(self) -> None:
        if self.duration_s is not None:  # idempotent: double-end is a no-op
            return
        self.duration_s = time.perf_counter() - self._t0
        self.tracer._finish(self)

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is not None:
            self.attributes["error"] = True
            self.attributes.setdefault("error.type", exc_type.__name__)
        self.end()
        return False

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "start_ts": self.start_ts,
            "duration_ms": (self.duration_s or 0.0) * 1e3,
            "attributes": self.attributes,
            "thread": self.thread_name,
        }


class Tracer:
    """Span factory + bounded recorder.

    Parenting: an explicit `parent` Span (or remote SpanContext via
    `context=`) wins; otherwise the thread-local current span — so
    controller code only names the root and children nest themselves.
    Finished spans land in a ring buffer (deque maxlen) under a lock;
    the span-end hook observes duration into the phase histogram.
    """

    def __init__(self, ring_size: "Optional[int]" = None,
                 registry=REGISTRY):
        if ring_size is None:
            try:
                ring_size = int(os.environ.get(
                    "KARPENTER_TPU_TRACE_RING", _DEFAULT_RING))
            except ValueError:
                ring_size = _DEFAULT_RING
        self._lock = threading.Lock()
        self._finished: "collections.deque[Span]" = collections.deque(
            maxlen=max(1, ring_size))
        self._tls = threading.local()
        self._phase_hist = registry.histogram(
            PHASE_METRIC,
            "Duration of scheduling phases, recorded from tracing spans.",
            ("phase",)) if registry is not None else None

    # -- span lifecycle ------------------------------------------------------

    def _stack(self) -> list:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def current_span(self) -> "Optional[Span]":
        st = self._stack()
        return st[-1] if st else None

    def start_span(self, name: str, parent: "Optional[Span]" = None,
                   context: "Optional[SpanContext]" = None,
                   **attributes) -> Span:
        """Open a span. Resolution of the parent link: explicit `parent`
        span > remote `context` (joins that trace) > thread-local current
        span > new root."""
        if parent is not None:
            trace_id, parent_id = parent.trace_id, parent.span_id
        elif context is not None and context.trace_id:
            trace_id, parent_id = context.trace_id, context.span_id
        else:
            cur = self.current_span()
            if cur is not None:
                trace_id, parent_id = cur.trace_id, cur.span_id
            else:
                trace_id, parent_id = _new_id(), ""
        span = Span(self, name, trace_id, _new_id(), parent_id, attributes)
        self._stack().append(span)
        return span

    def annotate(self, **attrs) -> None:
        """Attach attributes to the current span, if any (deep layers —
        solver core, ops kernels — annotate without plumbing a span)."""
        cur = self.current_span()
        if cur is not None:
            cur.attributes.update(attrs)

    def record_span(self, name: str, duration_s: float,
                    parent: "Optional[Span]" = None,
                    context: "Optional[SpanContext]" = None,
                    start_ts: "Optional[float]" = None,
                    **attributes) -> Span:
        """Synthesize an already-measured span, starting at `start_ts`
        (time.time() seconds) where given, else backdated by `duration_s`
        from now. Hot paths that time phases with raw perf_counter deltas
        — solver encode/dispatch, fleet queue wait, watch-ingest batches —
        file those measurements as first-class spans without paying a
        context manager per inner iteration; a caller that files its
        phases after the last one ends passes each phase's start, so the
        phases are drawn where they ran. Parent resolution matches
        start_span; the span never touches the thread-local stack."""
        if parent is not None:
            trace_id, parent_id = parent.trace_id, parent.span_id
        elif context is not None and context.trace_id:
            trace_id, parent_id = context.trace_id, context.span_id
        else:
            cur = self.current_span()
            if cur is not None:
                trace_id, parent_id = cur.trace_id, cur.span_id
            else:
                trace_id, parent_id = _new_id(), ""
        span = Span(self, name, trace_id, _new_id(), parent_id, attributes)
        if start_ts is None:
            span.start_ts -= duration_s
        else:
            span.start_ts = start_ts
        span.duration_s = max(0.0, duration_s)
        self._finish(span)
        return span

    def _finish(self, span: Span) -> None:
        st = self._stack()
        if span in st:  # tolerate out-of-order ends from with-blocks
            st.remove(span)
        with self._lock:
            self._finished.append(span)
        if self._phase_hist is not None:
            # the trace id rides along as the series exemplar, so a slow
            # histogram percentile resolves to a concrete trace
            self._phase_hist.observe(span.duration_s,
                                     exemplar=span.trace_id, phase=span.name)

    # -- read side -----------------------------------------------------------

    def finished_spans(self) -> "list[Span]":
        with self._lock:
            return list(self._finished)

    def phase_sum(self, phase: str) -> float:
        """Cumulative seconds observed for one phase; benchmarks read
        deltas of this around a measured window to attribute wall clock."""
        return (self._phase_hist.sum(phase=phase)
                if self._phase_hist is not None else 0.0)

    def trace(self, trace_id: str) -> "list[dict]":
        return [s.to_dict() for s in self.finished_spans()
                if s.trace_id == trace_id]

    def traces(self, limit: int = 20) -> "list[dict]":
        """Most recent `limit` traces, newest first, each with its spans in
        start order and a root-derived summary line."""
        by_trace: "dict[str, list[Span]]" = {}
        order: "list[str]" = []
        for s in self.finished_spans():
            if s.trace_id not in by_trace:
                order.append(s.trace_id)
                by_trace[s.trace_id] = []
            by_trace[s.trace_id].append(s)
        out = []
        for tid in reversed(order[-limit:] if limit else order):
            spans = sorted(by_trace[tid], key=lambda s: s.start_ts)
            roots = [s for s in spans if not s.parent_id]
            root = roots[0] if roots else spans[0]
            out.append({
                "trace_id": tid,
                "root": root.name,
                "start_ts": root.start_ts,
                "duration_ms": (root.duration_s or 0.0) * 1e3,
                "n_spans": len(spans),
                "spans": [s.to_dict() for s in spans],
            })
        return out

    def trace_index(self, limit: int = 20) -> "list[dict]":
        """The `/debug/traces` index: the most recent `limit` trace ids,
        newest first, WITHOUT span bodies — just what a triage needs to
        pick an id: root span name, duration, span count, and the tenant/
        replica annotations found anywhere in the trace (the fleet files
        `tenant` on queue-wait and Solve spans, federation files
        `replica`)."""
        out = []
        for t in self.traces(limit):
            tenants: "set[str]" = set()
            replicas: "set[str]" = set()
            for s in t["spans"]:
                attrs = s.get("attributes", {})
                if attrs.get("tenant"):
                    tenants.add(str(attrs["tenant"]))
                if attrs.get("replica"):
                    replicas.add(str(attrs["replica"]))
            out.append({
                "trace_id": t["trace_id"],
                "root": t["root"],
                "start_ts": t["start_ts"],
                "duration_ms": t["duration_ms"],
                "n_spans": t["n_spans"],
                "tenants": sorted(tenants),
                "replicas": sorted(replicas),
            })
        return out

    def chrome_trace(self, trace_id: "Optional[str]" = None) -> dict:
        """Chrome trace_event JSON (the Perfetto / chrome://tracing
        format): complete ("X") events, µs timestamps, one pid, tid =
        recording thread."""
        events = []
        pid = os.getpid()
        for s in self.finished_spans():
            if trace_id is not None and s.trace_id != trace_id:
                continue
            events.append({
                "name": s.name,
                "cat": s.trace_id,
                "ph": "X",
                "ts": s.start_ts * 1e6,
                "dur": (s.duration_s or 0.0) * 1e6,
                "pid": pid,
                "tid": s.thread_id,
                "args": {k: v for k, v in s.attributes.items()},
            })
        events.sort(key=lambda e: e["ts"])
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def chrome_trace_json(self, trace_id: "Optional[str]" = None) -> str:
        return json.dumps(self.chrome_trace(trace_id), default=str)

    def phase_coverage(self, trace_id: "Optional[str]" = None,
                       root_name: str = "provisioning.cycle") -> "Optional[dict]":
        """How much of a root span's wall clock its direct children account
        for. The SLO plane's attribution invariant (docs/designs/slo.md):
        if coverage drops below ~95%, someone added work to the cycle
        outside any phase span, and a cycle-latency burn can no longer be
        attributed. Picks the newest finished trace containing `root_name`
        when `trace_id` is not given."""
        spans = self.finished_spans()
        if trace_id is None:
            for s in reversed(spans):
                if s.name == root_name and not s.parent_id:
                    trace_id = s.trace_id
                    break
            if trace_id is None:
                return None
        in_trace = [s for s in spans if s.trace_id == trace_id]
        roots = [s for s in in_trace
                 if s.name == root_name or not s.parent_id]
        if not roots or not in_trace:
            return None
        root = roots[0]
        children = [s for s in in_trace if s.parent_id == root.span_id]
        root_s = root.duration_s or 0.0
        covered_s = sum(s.duration_s or 0.0 for s in children)
        return {
            "trace_id": trace_id,
            "root": root.name,
            "root_s": root_s,
            "covered_s": covered_s,
            "coverage": (min(1.0, covered_s / root_s) if root_s > 0 else 1.0),
            "phases": {s.name: round(s.duration_s or 0.0, 6)
                       for s in children},
        }

    def clear(self) -> None:
        with self._lock:
            self._finished.clear()


TRACER = Tracer()


def start_span(name: str, **kwargs) -> Span:
    return TRACER.start_span(name, **kwargs)


def current_span() -> "Optional[Span]":
    return TRACER.current_span()


def annotate(**attrs) -> None:
    TRACER.annotate(**attrs)
