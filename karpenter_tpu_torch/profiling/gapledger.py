"""Gap ledger: per-solve wall-time decomposition with an explicit residue.

Copy of karpenter_tpu/profiling/gapledger.py for the PyTorch port, which
imports nothing of the JAX package; tests/test_torch_copies.py holds it to
the original's names and bounds the edit. On the CUDA card a row's
device-event time is the CUDA-event span the solver files
(note_device_event); without one, the row's device_exec phase, as in the
JAX package.

The motivating gap: the recorded device trace
shows device-exec at 0.644 ms/run while the on-chip headline was
129.1 ms, and nothing could say where the other ~128 ms went. The ledger
closes that hole by accounting, not by guessing: an OUTER wall-time scope
(service RPC body, or TPUSolver.solve for in-process callers) brackets
the whole solve, INNER layers file what they measured into named phases,
and whatever the phases don't cover is published — loudly — as
``unaccounted``. A residue near zero makes the headline decomposition
trustworthy; a growing residue is itself the finding.

The scope is the hbm_scope idiom from solver/buckets.py: thread-local,
outermost-opener-wins, so the service scope subsumes the solver scope
which subsumes both rounds of the two-round solve — nested layers just
accumulate notes into the one open record.

Phase table (the ONLY phase vocabulary; hack/check_phase_accounting.py
asserts every backing span name below exists in the Tracer phase
registry):

    encode       host problem encoding (solver.encode)
    serialize    wire decode + response encode at the service boundary
    link         host dispatch / XLA link+compile (solver.dispatch.*)
    device_exec  the one blocking device->host fetch (solver.transfer)
    decode       host result shaping (solver.decode)

Shares always sum to exactly 1: with ``total = max(wall, Σphases)``,
``unaccounted = max(0, wall − Σphases)`` and both shares divide by
``total`` — residue can never go negative even under clock skew.
"""
from __future__ import annotations

import contextlib
import logging
import os
import threading
import time
from collections import deque

from ..metrics import REGISTRY
from . import critical, roofline, state

log = logging.getLogger(__name__)

#: gap phase -> backing Tracer span names. Order is presentation order in
#: statusz / profilez / the drill artifact.
PHASES = (
    ("extract", ("solver.extract",)),
    ("warm_start", ("solver.warm_start",)),
    ("encode", ("solver.encode",)),
    ("serialize", ("solver.serialize",)),
    ("link", ("solver.dispatch.execute", "solver.dispatch.compile")),
    ("device_exec", ("solver.transfer",)),
    ("decode", ("solver.decode",)),
)
PHASE_NAMES = tuple(name for name, _spans in PHASES)

RING_ENV = "KARPENTER_TPU_PROFILE_GAP_RING"
DEFAULT_RING = 512

PHASE_MS = REGISTRY.counter(
    "karpenter_profile_phase_ms_total",
    "Cumulative per-phase solve milliseconds (phase=unaccounted is the residue)",
    ("phase",))
GAP_SOLVES = REGISTRY.counter(
    "karpenter_profile_solves_total",
    "Solves observed by the gap ledger",
    ("source",))
UNACCOUNTED_SHARE = REGISTRY.gauge(
    "karpenter_profile_unaccounted_share",
    "Unaccounted share of the most recent solve's wall time",
    ("source",))


def _ring_cap() -> int:
    raw = os.environ.get(RING_ENV)
    if raw is None:
        return DEFAULT_RING
    try:
        v = int(raw)
        if v <= 0:
            raise ValueError(raw)
        return min(v, 65536)
    except ValueError:
        log.warning("%s=%r invalid (want a positive integer); using %d",
                    RING_ENV, raw, DEFAULT_RING)
        return DEFAULT_RING


class _Record:
    __slots__ = ("phases", "attrs", "intervals", "waits", "wall0", "perf0",
                 "device_event_s")

    def __init__(self):
        self.phases: "dict[str, float]" = {}
        self.attrs: "dict[str, object]" = {}
        # the critical-plane side of the record: interval records per
        # note, explicit cross-thread wait notes, and the wall/monotonic
        # anchor pair (wall places Perfetto slices; perf positions the
        # relative interval times)
        self.intervals: "list[critical.Interval]" = []
        self.waits: "list[tuple[str, str, float]]" = []
        self.wall0 = time.time()
        self.perf0 = time.perf_counter()
        # CUDA-event seconds of the record's device work (note_device_event)
        self.device_event_s: "float | None" = None


class GapLedger:
    def __init__(self, ring: "int | None" = None):
        self._tls = threading.local()
        self._lock = threading.Lock()
        self._rows: "deque[dict]" = deque(
            maxlen=ring if ring is not None else _ring_cap())
        self.rows_total = 0
        self._phase_ms_total: "dict[str, float]" = {}

    # -- write side ----------------------------------------------------------

    @contextlib.contextmanager
    def solve_scope(self, source: str):
        """Outermost-opener-wins wall bracket (hbm_scope idiom). Nested
        opens are transparent: they yield the already-open record so inner
        layers keep accumulating into the outer wall measurement."""
        if not state.enabled():
            yield None
            return
        cur = getattr(self._tls, "rec", None)
        if cur is not None:
            yield cur
            return
        # the always-on part of "always-on": the first profiled solve lazily
        # starts the host sampler (idempotent; refuses while disabled)
        from . import PROFILER

        PROFILER.ensure_started()
        rec = _Record()
        self._tls.rec = rec
        t0 = time.perf_counter()
        try:
            yield rec
        finally:
            self._tls.rec = None
            self._observe(source, time.perf_counter() - t0, rec)

    def note(self, phase: str, seconds: float, *,
             lane: "str | None" = None,
             end_pc: "float | None" = None) -> None:
        """File measured seconds into a named phase of the open record.
        No-op without an open scope (a bare encode_problem in a test) or
        while the plane is disabled.

        The flat accumulation below is the ORIGINAL ledger semantics,
        byte-for-byte — the critical plane rides along as an ADDITIONAL
        interval record (lane + monotonic start/end), so the flat view
        stays a bit-compatible projection of the interval records
        (critical.project_flat; tests assert equality).

        ``lane`` overrides the phase's default lane
        (critical.PHASE_LANES); ``end_pc`` is the perf_counter timestamp
        the measured span ENDED at (defaults to now) — call sites that
        batch several notes after the fact pass their own phase-boundary
        timestamps so the intervals don't artificially stack."""
        rec = getattr(self._tls, "rec", None)
        if rec is None or not state.enabled():
            return
        if phase not in PHASE_NAMES:
            raise ValueError(
                f"unknown gap phase {phase!r} (want one of {PHASE_NAMES})")
        rec.phases[phase] = rec.phases.get(phase, 0.0) + max(0.0, seconds)
        if (critical.enabled()
                and len(rec.intervals) < critical.MAX_INTERVALS_PER_SOLVE):
            if lane is not None and lane not in critical.LANES:
                raise ValueError(
                    f"unknown lane {lane!r} (want one of {critical.LANES})")
            end = (end_pc if end_pc is not None
                   else time.perf_counter()) - rec.perf0
            rec.intervals.append(critical.make_interval(
                lane or critical.PHASE_LANES.get(phase, "solver"),
                phase, end, seconds))

    def note_wait(self, kind: str, seconds: float, *,
                  lane: str = "tick") -> None:
        """File an EXPLICIT wait (critical.WAITS vocabulary) against the
        open record — the cross-thread waits lane geometry cannot see,
        e.g. the fleet frontend's admission->dispatch queue time. No-op
        without an open scope or while either plane is disabled."""
        rec = getattr(self._tls, "rec", None)
        if rec is None or not state.enabled() or not critical.enabled():
            return
        if kind not in critical.WAITS:
            raise ValueError(
                f"unknown wait {kind!r} (want one of {critical.WAITS})")
        if lane not in critical.LANES:
            raise ValueError(
                f"unknown lane {lane!r} (want one of {critical.LANES})")
        rec.waits.append((kind, lane, max(0.0, seconds)))
        critical.CRITICAL.count_wait_note()

    def note_device_event(self, seconds: "float | None") -> None:
        """Add a CUDA-event span's seconds (continuous.CudaEventSpan) to
        the open record's device-event time, which the device ladder
        records in place of the device_exec phase. No-op for None, without
        an open scope or while the plane is disabled."""
        rec = getattr(self._tls, "rec", None)
        if seconds is None or rec is None or not state.enabled():
            return
        rec.device_event_s = (rec.device_event_s or 0.0) + max(0.0, seconds)

    def annotate(self, **attrs) -> None:
        """Attach rung/route metadata to the open record (bucket label,
        rung dims for the roofline, routing, device_count)."""
        rec = getattr(self._tls, "rec", None)
        if rec is None or not state.enabled():
            return
        rec.attrs.update(attrs)

    # -- observe -------------------------------------------------------------

    def _observe(self, source: str, wall_s: float, rec: _Record) -> None:
        if not rec.phases:
            return  # nothing was measured (native solver, error path)
        phases_ms = {k: v * 1e3 for k, v in rec.phases.items()}
        attributed = sum(phases_ms.values())
        wall_ms = wall_s * 1e3
        total = max(wall_ms, attributed, 1e-9)
        unaccounted = max(0.0, wall_ms - attributed)
        row = {
            "ts": time.time(),
            "source": source,
            "wall_ms": round(wall_ms, 4),
            "phases_ms": {k: round(v, 4) for k, v in phases_ms.items()},
            "attributed_ms": round(attributed, 4),
            "unaccounted_ms": round(unaccounted, 4),
            "attributed_share": round(attributed / total, 6),
            "unaccounted_share": round(unaccounted / total, 6),
        }
        for key in ("bucket", "route", "device_count", "batch"):
            if key in rec.attrs:
                row[key] = rec.attrs[key]
        device_ms = phases_ms.get("device_exec", 0.0)
        rf = self._roofline_for(rec)
        if rf is not None:
            row["roofline"] = {
                "bytes_moved": rf.bytes_moved,
                "flops": rf.flops,
                "floor_ms": round(rf.floor_ms, 6),
                "backend": rf.backend,
                "ratio": round(roofline.observe(rf, device_ms), 3),
            }
        # hand the interval records to the critical plane — the row grows
        # a `critical` subsection (chain, overlap ratio, waits) but every
        # pre-existing key above is computed exactly as before
        crit_row = critical.CRITICAL.observe(
            source, rec.intervals, rec.waits, wall_ms, rec.wall0)
        if crit_row is not None:
            row["critical"] = {
                k: crit_row[k]
                for k in ("critical_path_ms", "total_work_ms",
                          "overlap_ratio", "critical_share", "waits_ms",
                          "on_critical_path_ms", "off_critical_path_ms")
            }
        if device_ms > 0:
            from .continuous import PROFILER
            if rec.device_event_s is None:
                seconds, mode = device_ms / 1e3, "cpu-synthetic"
            else:
                seconds, mode = rec.device_event_s, "cuda-events"
            PROFILER.device.observe(
                seconds,
                bucket=str(rec.attrs.get("bucket", "")),
                route=str(rec.attrs.get("route", "single")), mode=mode)
        with self._lock:
            self._rows.append(row)
            self.rows_total += 1
            for k, v in phases_ms.items():
                self._phase_ms_total[k] = self._phase_ms_total.get(k, 0) + v
            self._phase_ms_total["unaccounted"] = (
                self._phase_ms_total.get("unaccounted", 0) + unaccounted)
        for k, v in phases_ms.items():
            PHASE_MS.inc(v, phase=k)
        PHASE_MS.inc(unaccounted, phase="unaccounted")
        GAP_SOLVES.inc(source=source)
        UNACCOUNTED_SHARE.set(row["unaccounted_share"], source=source)

    def _roofline_for(self, rec: _Record):
        a = rec.attrs
        if "groups" not in a or "slots" not in a:
            return None
        try:
            return roofline.estimate(
                a["groups"], a["slots"], a.get("existing", 0),
                pv=a.get("pv", 1), t=a.get("t", 16), s=a.get("s", 4),
                device_count=a.get("device_count", 1),
                backend=a.get("backend", "cpu"),
                bucket=str(a.get("bucket", "")))
        except Exception:  # noqa: BLE001 — advisory
            return None

    # -- read side -----------------------------------------------------------

    def ring_len(self) -> int:
        with self._lock:
            return len(self._rows)

    def rows(self, limit: "int | None" = None) -> "list[dict]":
        with self._lock:
            out = list(self._rows)
        return out[-limit:] if limit else out

    def clear(self) -> None:
        with self._lock:
            self._rows.clear()

    def snapshot(self) -> dict:
        with self._lock:
            rows = list(self._rows)
            totals = dict(self._phase_ms_total)
        grand = sum(totals.values())
        return {
            "phases": list(PHASE_NAMES),
            "rows_total": self.rows_total,
            "ring_len": len(rows),
            "phase_ms_total": {k: round(v, 3) for k, v in totals.items()},
            "phase_share": {
                k: round(v / grand, 4) for k, v in totals.items()
            } if grand > 0 else {},
            "last": rows[-5:],
        }


GAP_LEDGER = GapLedger()
