"""Always-on continuous profiler: sampling host profiler + device ladder.

Copy of karpenter_tpu/profiling/continuous.py for the PyTorch port, which
imports nothing of the JAX package, edited; tests/test_torch_copies.py
holds it to the original's names and bounds the edit. The device ladder's
rungs are the port's: "cuda-events" (CudaEventSpan) in place of
"tpu-sync", torch.profiler in place of jax.profiler, and detect_backend
reads the solver's device type.

Host half: a daemon thread walks ``sys._current_frames()`` at a low rate
(default 19 Hz — deliberately prime so it can't phase-lock with a
controller cycle) and folds each thread's stack into the
``root;frame;...;leaf`` form flamegraph tooling eats directly. Samples
land in a bounded ring (``KARPENTER_TPU_PROFILE_RING``); aggregation to
pprof-style JSON happens at read time (/debug/profilez), never on the
sampling path. The sampler measures ITSELF — cumulative sweep cost over
elapsed wall feeds ``karpenter_profile_overhead_ratio``, so the <5%
overhead claim in the profile drill is the profiler's own number checked
against an enabled-vs-disabled wall-clock A/B.

Device half: a backend ladder in the ShardedContext advisory style. On the
CUDA card a solve records one CUDA event before the pack's first kernel is
enqueued and one after its last; their elapsed time, read after the flat
buffer's .cpu() (which already synchronises), IS the device-exec
measurement ("cuda-events" rung), and ``torch.profiler`` trace capture is
available as a guarded passthrough for deep dives. Without CUDA events
(device="cpu") the same perf_counter interval is recorded as a synthetic
timer ("cpu-synthetic" rung) — identical math, honestly labelled. Nothing
here is load-bearing: every rung degrades to a no-op and never raises into
the solve path.
"""
from __future__ import annotations

import logging
import os
import sys
import threading
import time
from collections import Counter as _TallyCounter
from collections import deque

from ..metrics import REGISTRY
from . import state

log = logging.getLogger(__name__)

HZ_ENV = "KARPENTER_TPU_PROFILE_HZ"
RING_ENV = "KARPENTER_TPU_PROFILE_RING"
DEFAULT_HZ = 19.0
DEFAULT_RING = 4096
DEVICE_RING = 1024
MAX_STACK_DEPTH = 64

#: synthetic pid for the profiling lane in merged Perfetto traces — far
#: outside the replica pids fleetview assigns (0..replicas) and stable
#: across processes so lanes from bundles diff cleanly.
PROFILE_LANE_PID = 0x70F1

OVERHEAD_RATIO = REGISTRY.gauge(
    "karpenter_profile_overhead_ratio",
    "Sampler self-cost: cumulative sweep seconds / elapsed wall seconds",
    ())
HOST_SAMPLES = REGISTRY.counter(
    "karpenter_profile_host_samples_total",
    "Host stack samples captured by the continuous profiler",
    ())
DEVICE_EVENTS = REGISTRY.counter(
    "karpenter_profile_device_events_total",
    "Device-exec events recorded through the backend ladder",
    ("mode",))


def _env_pos(env: str, fallback: float, lo: float, hi: float) -> float:
    raw = os.environ.get(env)
    if raw is None:
        return fallback
    try:
        v = float(raw)
        if v <= 0:
            raise ValueError(raw)
    except ValueError:
        log.warning("%s=%r invalid (want a positive number); using %s",
                    env, raw, fallback)
        return fallback
    return min(max(v, lo), hi)


def detect_backend(device=None) -> str:
    """The solver's device type: `device`'s ("cuda" or "cpu"), or, with no
    device, the one a solver built with device=None runs on ("cuda" when a
    card is present, else "cpu"). Never imports jax; never raises."""
    try:
        import torch

        if device is not None:
            return torch.device(device).type
        return "cuda" if torch.cuda.is_available() else "cpu"
    except Exception:  # noqa: BLE001 — ladder degrades, never raises
        return "cpu"


class CudaEventSpan:
    """The device-exec span of enqueued work: one CUDA event recorded on
    the current stream before the work's first kernel (start, recorded at
    the first call only) and one after its last (stop, recorded again at
    each call). `seconds()` reads their elapsed time and must be called
    after something has synchronised with the stop event (the flat
    buffer's .cpu()), so it adds no sync of its own. A span is inert (every
    method a no-op, seconds() None) off the card or while the plane is
    disabled. Use it as a context manager: leaving the block destroys its
    events there and then, even when the solve raised, so no event is left
    for a later garbage collection to destroy in whatever thread runs it
    (a destroy in the middle of another thread's CUDA-graph capture
    invalidates the capture)."""

    def __init__(self, device):
        self._events = None
        self._started = False
        if getattr(device, "type", device) == "cuda" and state.enabled():
            import torch

            self._events = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True))

    def __enter__(self) -> "CudaEventSpan":
        return self

    def __exit__(self, *exc) -> None:
        self._events = None

    def start(self) -> None:
        if self._events is not None and not self._started:
            self._events[0].record()
            self._started = True

    def stop(self) -> None:
        if self._events is not None:
            self._events[1].record()

    def seconds(self) -> "float | None":
        if self._events is None:
            return None
        return self._events[0].elapsed_time(self._events[1]) / 1e3


def _fold(frame) -> str:
    """frame chain -> 'root;...;leaf' (module.qualname per frame)."""
    parts: "list[str]" = []
    depth = 0
    while frame is not None and depth < MAX_STACK_DEPTH:
        code = frame.f_code
        mod = frame.f_globals.get("__name__", "?")
        name = getattr(code, "co_qualname", code.co_name)
        parts.append(f"{mod}.{name}")
        frame = frame.f_back
        depth += 1
    parts.reverse()
    return ";".join(parts)


class HostSampler:
    """sys._current_frames() wall-clock sampler with bounded ring."""

    def __init__(self, hz: "float | None" = None,
                 ring: "int | None" = None):
        self.hz = hz if hz is not None else _env_pos(
            HZ_ENV, DEFAULT_HZ, 1.0, 1000.0)
        cap = ring if ring is not None else int(_env_pos(
            RING_ENV, DEFAULT_RING, 64, 262144))
        self._ring: "deque[tuple[float, str, str]]" = deque(maxlen=cap)
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: "threading.Thread | None" = None
        self.samples_total = 0
        self.sample_cost_s = 0.0
        self._started_at: "float | None" = None
        self._atexit_registered = False

    # -- lifecycle -----------------------------------------------------------

    def ensure_started(self) -> bool:
        """Idempotent lazy start (first solve / first profilez read).
        Refuses while the plane is disabled — strict-noop."""
        if not state.enabled():
            return False
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return True
            self._stop.clear()
            self._started_at = time.monotonic()
            self._thread = threading.Thread(
                target=self._run, name="profiling-sampler", daemon=True)
            self._thread.start()
            if not self._atexit_registered:
                # join the sampler before interpreter teardown: a daemon
                # thread walking sys._current_frames() while the runtime
                # (and XLA's C++ threadpools) shut down is a crash race
                import atexit

                atexit.register(self.stop)
                self._atexit_registered = True
            return True

    def stop(self) -> None:
        with self._lock:
            t = self._thread
            self._thread = None
        self._stop.set()
        if t is not None and t.is_alive():
            t.join(timeout=2.0)

    def running(self) -> bool:
        t = self._thread
        return t is not None and t.is_alive()

    def _run(self) -> None:
        own = threading.get_ident()
        interval = 1.0 / self.hz
        while not self._stop.wait(interval):
            if not state.enabled():
                continue  # disabled mid-flight: idle, sample nothing
            t0 = time.perf_counter()
            try:
                frames = sys._current_frames()
                names = {t.ident: t.name for t in threading.enumerate()}
                now = time.time()
                n = 0
                with self._lock:
                    # read again under the lock that counts() reads under:
                    # a sweep lands before a read that follows
                    # set_enabled(False), or not at all
                    if not state.enabled():
                        continue
                    for tid, frame in frames.items():
                        if tid == own:
                            continue
                        self._ring.append((
                            now, names.get(tid, f"tid-{tid}"), _fold(frame)))
                        n += 1
                    self.samples_total += n
            except Exception:  # noqa: BLE001 — advisory, never crash
                continue
            cost = time.perf_counter() - t0
            with self._lock:
                self.sample_cost_s += cost
            HOST_SAMPLES.inc(n)
            OVERHEAD_RATIO.set(self.overhead_ratio())

    # -- reads ---------------------------------------------------------------

    def ring_len(self) -> int:
        with self._lock:
            return len(self._ring)

    def counts(self) -> "tuple[int, int]":
        """(samples_total, ring length), read together under the sweep's
        lock (profiling.activity)."""
        with self._lock:
            return self.samples_total, len(self._ring)

    def samples(self) -> "list[tuple[float, str, str]]":
        with self._lock:
            return list(self._ring)

    def overhead_ratio(self) -> float:
        if self._started_at is None:
            return 0.0
        elapsed = time.monotonic() - self._started_at
        return self.sample_cost_s / elapsed if elapsed > 0 else 0.0

    def folded(self, limit: "int | None" = None) -> "list[tuple[str, int]]":
        tally: "_TallyCounter[str]" = _TallyCounter()
        for _ts, _thread, stack in self.samples():
            tally[stack] += 1
        out = tally.most_common(limit)
        return out

    def snapshot(self) -> dict:
        return {
            "running": self.running(),
            "hz": self.hz,
            "ring_len": self.ring_len(),
            "ring_cap": self._ring.maxlen,
            "samples_total": self.samples_total,
            "overhead_ratio": round(self.overhead_ratio(), 6),
        }


MODES = ("cuda-events", "cpu-synthetic")


class DeviceEventLadder:
    """Backend ladder for device-exec evidence: cuda-events -> cpu-synthetic."""

    def __init__(self):
        self._lock = threading.Lock()
        self._ring: "deque[dict]" = deque(maxlen=DEVICE_RING)
        self.events_total = 0
        self._backend: "str | None" = None
        self._trace_active = False
        self._trace = None  # (torch.profiler.profile, logdir) while active

    def mode(self) -> str:
        if self._backend is None:
            self._backend = detect_backend()
        return "cuda-events" if self._backend == "cuda" else "cpu-synthetic"

    def observe(self, seconds: float, *, bucket: str = "",
                route: str = "single", mode: str = "cpu-synthetic") -> None:
        """Record one device-exec event. `mode` names how `seconds` was
        measured: "cuda-events" for a CudaEventSpan, "cpu-synthetic" (the
        default) for a host perf_counter interval."""
        if not state.enabled():
            return
        if mode not in MODES:
            raise ValueError(f"unknown device mode {mode!r} (want one of "
                             f"{MODES})")
        with self._lock:
            self._ring.append({
                "ts": time.time(),
                "ms": round(max(0.0, seconds) * 1e3, 4),
                "bucket": bucket,
                "route": route,
                "mode": mode,
            })
            self.events_total += 1
        DEVICE_EVENTS.inc(mode=mode)

    def ring_len(self) -> int:
        with self._lock:
            return len(self._ring)

    def events(self) -> "list[dict]":
        with self._lock:
            return list(self._ring)

    # guarded torch.profiler passthrough for deep dives on the card —
    # single-flight like the service trace_every capture; stop_trace writes
    # the Chrome trace to <logdir>/trace.json
    def start_trace(self, logdir: str) -> bool:
        if not state.enabled() or self.mode() != "cuda-events":
            return False
        with self._lock:
            if self._trace_active:
                return False
            self._trace_active = True
        try:
            import torch

            prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA])
            prof.start()
            self._trace = (prof, logdir)
            return True
        except Exception:  # noqa: BLE001
            with self._lock:
                self._trace_active = False
            return False

    def stop_trace(self) -> None:
        with self._lock:
            if not self._trace_active:
                return
            self._trace_active = False
            trace, self._trace = self._trace, None
        try:
            prof, logdir = trace
            prof.stop()
            os.makedirs(logdir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
        except Exception:  # noqa: BLE001
            pass

    def snapshot(self) -> dict:
        ev = self.events()
        return {
            "mode": self.mode(),
            "events_total": self.events_total,
            "ring_len": len(ev),
            "last": ev[-3:],
        }


class ContinuousProfiler:
    """Facade owning the host sampler and the device ladder."""

    def __init__(self):
        self.host = HostSampler()
        self.device = DeviceEventLadder()

    def ensure_started(self) -> bool:
        return self.host.ensure_started()

    def stop(self) -> None:
        self.host.stop()

    def merge_chrome(self, doc: dict) -> dict:
        """Append the profiling process lane to a Perfetto/chrome-trace doc
        (the fleetview process-lane idiom: distinct pid + process_name
        metadata, instant events per host sample inside the trace's time
        window). Returns the doc unchanged when profiling is disabled or
        the doc carries no span events."""
        if not state.enabled() or not isinstance(doc, dict):
            return doc
        events = doc.get("traceEvents")
        if not isinstance(events, list) or not events:
            return doc
        spans = [e for e in events if e.get("ph") != "M"]
        if not spans:
            return doc
        lo = min(e["ts"] for e in spans)
        hi = max(e["ts"] + e.get("dur", 0) for e in spans)
        lane: "list[dict]" = []
        for ts, thread, stack in self.host.samples():
            ts_us = ts * 1e6
            if ts_us < lo or ts_us > hi:
                continue
            leaf = stack.rsplit(";", 1)[-1]
            lane.append({
                "name": leaf, "ph": "i", "s": "t",
                "ts": ts_us, "pid": PROFILE_LANE_PID,
                "tid": hash(thread) % 1000,
                "args": {"stack": stack, "thread": thread},
            })
        for ev in self.device.events():
            ts_us = ev["ts"] * 1e6
            if ts_us < lo or ts_us > hi:
                continue
            lane.append({
                "name": f"device_exec[{ev['mode']}]", "ph": "X",
                "ts": ts_us - ev["ms"] * 1e3, "dur": ev["ms"] * 1e3,
                "pid": PROFILE_LANE_PID, "tid": 0,
                "args": {"bucket": ev["bucket"], "route": ev["route"]},
            })
        if not lane:
            return doc
        meta = [e for e in events if e.get("ph") == "M"]
        rest = [e for e in events if e.get("ph") != "M"] + lane
        rest.sort(key=lambda e: e["ts"])
        meta.append({"name": "process_name", "ph": "M",
                     "pid": PROFILE_LANE_PID, "tid": 0,
                     "args": {"name": "profiling"}})
        doc = dict(doc)
        doc["traceEvents"] = meta + rest
        return doc


PROFILER = ContinuousProfiler()
