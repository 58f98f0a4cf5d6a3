"""Roofline cost model keyed on the BucketPlan rung.

Copy of karpenter_tpu/profiling/roofline.py for the PyTorch port, which
imports nothing of the JAX package; tests/test_torch_copies.py holds it to
the original.

Every solve dispatches one pack kernel at a padded rung shape
``(Gb groups, Nb slots, Neb existing)`` (solver/buckets.py LADDERS), so the
bytes that must cross the host-device boundary and the FLOPs the kernel
must execute are *functions of the rung*, not of the live pod set. That
gives a theoretical floor per solve:

    floor = max(bytes_moved / peak_bandwidth,
                flops / (peak_flops * device_count))

The floor is deliberately optimistic (it prices neither dispatch latency
nor XLA link time) — its job is to be the denominator of
``karpenter_profile_roofline_ratio`` (measured device-exec / floor). A
ratio near 1 means the device phase is at the hardware limit and the
remaining headline milliseconds live on the host side of the gap ledger;
a large ratio means the device phase itself is leaving performance on the
table. Monotone in every rung dimension by construction (sums and maxima
of monotone terms), which tests/test_profiling.py locks in.

Byte model (matches build_pack_inputs' per-solve delta — the catalog
arrays are device-resident and NOT counted, SURVEY.md §7.3 "ship only the
pod delta"):

    h2d  = Gb·(R·4 + 3·4)            group vec / count / cap / newprov
         + Gb·Pv                      feasibility mask (bool)
         + Neb·(2·R·4)                existing alloc + used
         + Gb·Neb                     existing feasibility (bool)
         + R·4                        daemon overhead
    d2h  = Nb·4 + Gb·4 + Neb·4 + 64   flat result + headers
    flops = Gb·Nb·T·S·OPS_PER_CELL    per-slot-step candidate scan

Peaks are per-backend defaults overridable with
``KARPENTER_TPU_ROOFLINE_GBPS`` / ``KARPENTER_TPU_ROOFLINE_GFLOPS``
(warn-and-fallback on garbage, the crossover_cells_default idiom).
"""
from __future__ import annotations

import logging
import os
import threading
from typing import NamedTuple

from ..metrics import REGISTRY

log = logging.getLogger(__name__)

DTYPE_BYTES = 4
#: modelled kernel work per candidate cell per tiebreak step: feasibility
#: compare, capacity subtract, score blend, argmin update (vectorised).
OPS_PER_CELL = 8

BW_ENV = "KARPENTER_TPU_ROOFLINE_GBPS"
FLOPS_ENV = "KARPENTER_TPU_ROOFLINE_GFLOPS"

#: per-backend (bandwidth GB/s, compute GFLOP/s) defaults. The CUDA row is
#: NVIDIA's H100 SXM5 80GB data sheet at 700 W: the modelled bytes cross
#: PCIe Gen5 x16 (128 GB/s both ways, 64 each way), 67 TFLOP/s float32; the
#: CPU row is a single-socket host — both are deliberately round: the ratio
#: gauge is for trend-spotting, not datasheet accounting.
PEAKS = {
    "cuda": (64.0, 67_000.0),
    "cpu": (20.0, 50.0),
}

ROOFLINE_BYTES = REGISTRY.gauge(
    "karpenter_profile_roofline_bytes",
    "Modelled bytes crossing the host-device boundary per solve at this rung",
    ("bucket",))
ROOFLINE_FLOPS = REGISTRY.gauge(
    "karpenter_profile_roofline_flops",
    "Modelled kernel FLOPs per solve at this rung",
    ("bucket",))
ROOFLINE_FLOOR_MS = REGISTRY.gauge(
    "karpenter_profile_roofline_floor_ms",
    "Theoretical per-solve floor ms = max(bytes/bw, flops/peak) at this rung",
    ("bucket",))
ROOFLINE_RATIO = REGISTRY.gauge(
    "karpenter_profile_roofline_ratio",
    "Measured device-exec ms / roofline floor ms (1.0 = at the roofline)",
    ("bucket",))

# -- the measured (not modelled) floor -----------------------------------------
# At compile-cache warmup the solver captures `compiled.cost_analysis()` /
# `memory_analysis()` per BucketPlan rung — XLA's own bytes/FLOPs for the
# exact compiled program — so the floor the kernel arc chases is the
# compiler's number. The modelled gauges above survive for trend
# continuity; drift between the two >DRIFT_THRESHOLD× is a warning event
# plus a statusz flag (the hand model silently diverging from the real
# program is exactly the failure mode this layer exists to catch).

#: modelled-vs-measured FLOPs ratio above which the model is flagged
DRIFT_THRESHOLD = 2.0

ROOFLINE_MEASURED_BYTES = REGISTRY.gauge(
    "karpenter_profile_roofline_measured_bytes",
    "XLA cost_analysis bytes accessed per solve at this rung",
    ("bucket",))
ROOFLINE_MEASURED_FLOPS = REGISTRY.gauge(
    "karpenter_profile_roofline_measured_flops",
    "XLA cost_analysis FLOPs per solve at this rung",
    ("bucket",))
ROOFLINE_MEASURED_FLOOR_MS = REGISTRY.gauge(
    "karpenter_profile_roofline_measured_floor_ms",
    "Per-solve floor ms = max(bytes/bw, flops/peak) from MEASURED numbers",
    ("bucket",))

_measured_lock = threading.Lock()
_measured: "dict[str, dict]" = {}


class Roofline(NamedTuple):
    bucket: str
    bytes_moved: int
    flops: int
    floor_ms: float
    bw_gbps: float
    peak_gflops: float
    backend: str
    device_count: int


def _env_float(env: str, fallback: float) -> float:
    raw = os.environ.get(env)
    if raw is None:
        return fallback
    try:
        v = float(raw)
        if v <= 0:
            raise ValueError(raw)
        return v
    except ValueError:
        log.warning("%s=%r invalid (want a positive number); using %s",
                    env, raw, fallback)
        return fallback


def peaks_for(backend: str) -> "tuple[float, float]":
    bw, fl = PEAKS.get(backend, PEAKS["cpu"])
    return _env_float(BW_ENV, bw), _env_float(FLOPS_ENV, fl)


def estimate(groups: int, slots: int, existing: int, *,
             pv: int = 1, t: int = 16, s: int = 4,
             resources: int = 8, device_count: int = 1,
             backend: str = "cpu", bucket: str = "") -> Roofline:
    """Roofline for one solve at the padded rung (duck-typed on the
    BucketPlan dims so hack/ lints can call it without importing jax)."""
    gb, nb, neb = max(1, int(groups)), max(1, int(slots)), max(0, int(existing))
    pv = max(1, int(pv))
    h2d = (gb * (resources * DTYPE_BYTES + 3 * DTYPE_BYTES)
           + gb * pv
           + neb * (2 * resources * DTYPE_BYTES)
           + gb * neb
           + resources * DTYPE_BYTES)
    d2h = nb * DTYPE_BYTES + gb * DTYPE_BYTES + neb * DTYPE_BYTES + 64
    flops = gb * nb * max(1, int(t)) * max(1, int(s)) * OPS_PER_CELL
    bw_gbps, peak_gflops = peaks_for(backend)
    dc = max(1, int(device_count))
    floor_s = max((h2d + d2h) / (bw_gbps * 1e9),
                  flops / (peak_gflops * 1e9 * dc))
    return Roofline(
        bucket=bucket or f"g{gb}n{nb}e{neb}",
        bytes_moved=h2d + d2h,
        flops=flops,
        floor_ms=floor_s * 1e3,
        bw_gbps=bw_gbps,
        peak_gflops=peak_gflops,
        backend=backend,
        device_count=dc,
    )


def observe(rf: Roofline, device_exec_ms: float) -> float:
    """Publish the rung's roofline gauges; returns the measured/floor ratio
    (callers record it into the gap-ledger row)."""
    ROOFLINE_BYTES.set(float(rf.bytes_moved), bucket=rf.bucket)
    ROOFLINE_FLOPS.set(float(rf.flops), bucket=rf.bucket)
    ROOFLINE_FLOOR_MS.set(rf.floor_ms, bucket=rf.bucket)
    ratio = device_exec_ms / rf.floor_ms if rf.floor_ms > 0 else 0.0
    ROOFLINE_RATIO.set(ratio, bucket=rf.bucket)
    return ratio


def record_measured(bucket: str, *, flops: float, bytes_accessed: float,
                    backend: str = "cpu", device_count: int = 1,
                    modelled: "Roofline | None" = None,
                    memory_bytes: "float | None" = None) -> dict:
    """File one rung's XLA-measured cost numbers: publish the measured
    gauges, compute the measured floor against the same per-backend peaks
    the model uses, and run the drift check — modelled-vs-measured FLOPs
    ratio beyond DRIFT_THRESHOLD in either direction logs a warning event
    and flags the rung in the statusz snapshot (the drill and tests read
    the flag; flagged rungs are reported, never hidden).

    FLOPs compare like-for-like (same quantity, two estimators); the byte
    numbers measure DIFFERENT quantities (the model prices host<->device
    boundary traffic, cost_analysis prices total memory traffic inside
    the program), so the bytes delta is reported informationally and
    never flags."""
    fl = max(0.0, float(flops))
    by = max(0.0, float(bytes_accessed))
    bw_gbps, peak_gflops = peaks_for(backend)
    dc = max(1, int(device_count))
    floor_ms = max(by / (bw_gbps * 1e9),
                   fl / (peak_gflops * 1e9 * dc)) * 1e3
    entry = {
        "bucket": bucket,
        "backend": backend,
        "flops": fl,
        "bytes_accessed": by,
        "floor_ms": round(floor_ms, 6),
        "flagged": False,
    }
    if memory_bytes is not None:
        entry["memory_bytes"] = float(memory_bytes)
    if modelled is not None:
        entry["modelled_flops"] = float(modelled.flops)
        entry["modelled_bytes"] = float(modelled.bytes_moved)
        entry["modelled_floor_ms"] = round(modelled.floor_ms, 6)
        if fl > 0 and modelled.flops > 0:
            drift = max(fl / modelled.flops, modelled.flops / fl)
            entry["flops_drift"] = round(drift, 3)
            if drift > DRIFT_THRESHOLD:
                entry["flagged"] = True
                log.warning(
                    "roofline drift at rung %s: modelled %.3g FLOPs vs "
                    "measured %.3g (%.1fx > %.1fx) — the cost model has "
                    "diverged from the compiled program",
                    bucket, modelled.flops, fl, drift, DRIFT_THRESHOLD)
    ROOFLINE_MEASURED_BYTES.set(by, bucket=bucket)
    ROOFLINE_MEASURED_FLOPS.set(fl, bucket=bucket)
    ROOFLINE_MEASURED_FLOOR_MS.set(floor_ms, bucket=bucket)
    with _measured_lock:
        _measured[bucket] = entry
    return entry


def measured_snapshot() -> dict:
    """Per-rung measured entries + an any-rung-flagged rollup (the statusz
    `critical` section embeds this; the drill ledgers the deltas)."""
    with _measured_lock:
        rungs = {k: dict(v) for k, v in _measured.items()}
    return {
        # XLA's cost_analysis() has no torch counterpart: no rung records
        "source": "unavailable on this backend (no compiler cost analysis)",
        "drift_threshold": DRIFT_THRESHOLD,
        "rungs": rungs,
        "drift_flagged": sorted(k for k, v in rungs.items()
                                if v.get("flagged")),
    }


def clear_measured() -> None:
    """Test hook: drop recorded measured entries."""
    with _measured_lock:
        _measured.clear()
