"""Device/host attribution profiling plane.

Port of karpenter_tpu/profiling/__init__.py for the PyTorch port, which
imports nothing of the JAX package; tests/test_torch_copies.py holds it to
the original's names. Dropped from the original's docstring: the device
ladder's TPU rung (here it is "cuda-events") and the paragraph on
`make profile-drill`, whose drill lives in benchmarks/, which the port
does not carry.

Three instruments behind one advisory switch (state.enabled):

- continuous.PROFILER — always-on sampling host profiler + device-event
  backend ladder (cuda-events -> cpu-synthetic), bounded rings, served at
  /debug/profilez and merged into Perfetto exports as a ``profiling``
  process lane.
- gapledger.GAP_LEDGER — per-solve wall-time decomposition into
  encode/serialize/link/device_exec/decode with an explicit
  ``unaccounted`` residue metric.
- roofline — BucketPlan-rung cost model giving the theoretical floor the
  measured device phase is compared against.
"""
from __future__ import annotations

from . import critical  # noqa: F401
from .continuous import PROFILE_LANE_PID, PROFILER  # noqa: F401
from .critical import CRITICAL, LANES, WAITS  # noqa: F401
from .gapledger import GAP_LEDGER, PHASE_NAMES, PHASES  # noqa: F401
from .state import disabled, enabled, set_enabled  # noqa: F401


def activity() -> dict:
    """Monotonic activity counters + ring lengths — the chaos
    ``profiling-strict-noop`` invariant diffs two of these. The host
    sampler's two counts are read under its sweep's lock, which also
    guards its enabled check: no sweep lands after a read that follows
    set_enabled(False)."""
    host_samples, host_ring = PROFILER.host.counts()
    return {
        "host_samples": host_samples,
        "host_ring": host_ring,
        "device_events": PROFILER.device.events_total,
        "device_ring": PROFILER.device.ring_len(),
        "gap_rows": GAP_LEDGER.rows_total,
        "gap_ring": GAP_LEDGER.ring_len(),
    }


def snapshot() -> dict:
    """The statusz schema-7 ``profiling`` section (also bundled by the
    flight recorder)."""
    return {
        "enabled": enabled(),
        "host": PROFILER.host.snapshot(),
        "device": PROFILER.device.snapshot(),
        "gap": GAP_LEDGER.snapshot(),
    }


def profilez(limit: int = 100) -> dict:
    """pprof-style aggregation served at /debug/profilez?format=json."""
    folded = PROFILER.host.folded(limit)
    return {
        "tool": "karpenter_tpu_torch.profilez",
        "schema": 1,
        "enabled": enabled(),
        "sample_type": {"type": "samples", "unit": "count"},
        "period_ms": round(1e3 / PROFILER.host.hz, 3),
        "host": PROFILER.host.snapshot(),
        "stacks": [
            {"frames": stack.split(";"), "count": count}
            for stack, count in folded
        ],
        "device": PROFILER.device.snapshot(),
        "gap": GAP_LEDGER.snapshot(),
    }


def folded_text(limit: "int | None" = None) -> str:
    """Flamegraph-ready folded stacks (/debug/profilez?format=folded —
    pipe straight into flamegraph.pl / speedscope)."""
    return "\n".join(
        f"{stack} {count}" for stack, count in PROFILER.host.folded(limit))


def merge_chrome(doc: dict) -> dict:
    """Append the ``profiling`` process lane to a chrome-trace doc, then
    the ``critical`` lane (interval records with critical-path marks +
    wait markers) when that plane has evidence in the window."""
    return critical.merge_chrome(PROFILER.merge_chrome(doc))
