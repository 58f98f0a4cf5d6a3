#!/usr/bin/env python3
"""Drive the PyTorch port's provisioning solve, waves, consolidation,
controllers, their incremental and explain planes, the operator and its
spot plane, the served operator over the HTTP coordination plane, the
solver service, the CLI, the fleet (its frontend, wire adapter and
replica processes), the chaos drills, the continuous profiler and the
multi-rank mesh on one CUDA card.

    python3 chip_smoke.py            # the smoke: every phase below
    python3 chip_smoke.py --slice    # paths A and B and phases 27-31 only
    python3 chip_smoke.py --ab-path-a DIR...   # path A in each checkout
    python3 chip_smoke.py --pack-graph   # phase 32 only

`--ab-path-a` compares checkouts on one card (give them in turns, as
parent change change parent): for each DIR in order, a process in DIR
builds its kernels and runs its own chip_smoke's path A phase
AB_PATH_A_RUNS times, printing DIR and each phase line.

Runs from the root of a checkout on a machine with one NVIDIA H100 (or any
CUDA card the kernels build for: sm_90a). It imports karpenter_tpu_torch
only, never jax or karpenter_tpu, and prints one line per phase:

1. device  — the card's name and power limit (nvidia-smi) and torch's name;
2. build   — nvcc builds every kernel of karpenter_tpu_torch/csrc;
3. k1      — the standalone quotient kernel (csrc/quotient.cu) against its
             plain PyTorch version on the card, bit for bit (tolerance 0:
             int32 in, int32 out), at N in {8, 128, 512, 2048} x T = 603 x
             R in {4, 11}, on inputs with negative availability, zero
             demand, exact-boundary divisions and values from 2**24 up to
             INT_BIG; its time, the plain version's and the byte bound;
4. open_claim — the pack step's open-claim fill (csrc/open_claim.cu, two
             launches) against its plain
             version open_claim_fill_reference, bit for bit (tolerance 0),
             at N in {32, 128, 512, 1000, 2048} x T = 603 x S = 6 x
             R in {4, 11}, Pv in {1, 3}, with and without the kubelet pods
             cap, on adversarial states (inactive rows with stale masks,
             rows with no feasible option, exact-boundary and one-below
             divisions, values from 2**24 up to INT_BIG, rem = 0 and rem
             above the total fill), plus S in {3, 4, 8} for the other word
             widths, one lane each;
5. path A  — the north-star solve: the real 603-type catalog, 10k pending
             pods in the 8-deployment headline mix, one spot+on-demand
             provisioner; one warm-up solve, then 5 timed solves;
6. path B  — 5k mixed pods with hostname anti-affinity and zone spread over
             3 zones, plus 64 partly used existing nodes of catalog types;
7. path C  — a solve_many wave of 16 tenant problems (the fleet frontend's
             default max_wave) of ~625 headline-mix pods each, 10k in all,
             which share one bucket: one warm-up wave, then 5 timed; each
             lane's flat buffer equals that problem's single solve on the
             card and the device="cpu" wave, bit for bit;
8. path D  — BASELINE config 3's consolidation sweep: 500 m5.2xlarge nodes
             with one small pod each, pairs on, so 996 lanes; one warm-up
             sweep, then 5 timed, with the encode/flatten/put/dispatch/
             fetch split; the streamed sweep at 128 lanes a chunk picks the
             same action; both verdict tables equal the device="cpu" runs
             bit for bit; and config 5's 64-node pair sweep, which must give
             a two-node replace equal to the device="cpu" run's;
9. open_claim_lanes — the fill's lane axis against the plain version, bit
             for bit, at L in {1, 16, 996} lanes x N in {2, 32, 128} x
             T = 603 x S = 6, with one alloc shared by every lane (R = 11,
             Pv = 1, as the consolidation sweep) and a per-lane alloc
             (R = 4, Pv = 3, pods cap, as a wave), lanes with rem = INT_BIG,
             0 and 37 side by side;
10. profile — one solve of paths A and B, one wave (C) and one sweep (D)
             under torch.profiler: kernels, device busy time, idle share;
11. timing — K1 and the open-claim fill at path A's and path B's shapes,
             and the lane fill at D's (996 lanes x 2 slots, one shared
             alloc) and C's (16 lanes x the wave's slots, per-lane alloc):
             each launch's device ms, their sum, the byte bound summed over
             the lanes, the plain version, for one lane the sequence the
             fill replaced (K1 plus the step-2 tensor code), all as medians
             of CUDA-graph replays; and the host time per call;
12. parity — decisions equal the scalar oracle on the 100-pod inflate case
             over 20 catalog types;
13. ctrl_provision — path A through the port's controllers, every plane
             (incremental, explain, profiling) at its default, on: a fake
             cloud over the 603-type catalog, a NodeTemplate over the three
             zones, path A's provisioner and its 10k pods pending in the
             KubeStore; one ProvisioningController.reconcile_once on the
             card, which files one provisioning DecisionRecord of its solve,
             and three MachineLifecycleController passes. Every pod is bound or
             reported unschedulable exactly as in the same scenario run with
             device="cpu", the launched machines' (type, zone, capacity
             type, pods) rows are equal, the solve is served by the "cuda"
             rung and the fill launched twice per pack step. Then 5 more
             scenarios (the cluster emptied by the termination controller in
             between): the median reconcile wall and its mask/solve/bind
             split from the port's tracing spans, beside the solve's
             encode/dispatch/transfer/decode and the launch spans, which wait
             on the fake cloud's batchers; after each of them the
             controller's solver encodes the reconcile's own pod objects
             again, then fresh ones of the same mix;
14. ctrl_consolidate — config 3's 500 m5.2xlarge nodes launched and
             initialized through the controllers, one pod bound to each; the
             card's sweep_consolidation with a filler tensor holding all but
             1.5 times the one-shot estimate of the card's free memory,
             which must stream at 128 lanes a chunk, and without it, which
             must not; then one DeprovisioningController pass on the card
             with the planes on, where the one-shot pack fits and runs; then
             the termination controller. Every action equals
             sweep_consolidation(device="cpu")'s and the device="cpu"
             streamed sweep's on the same state, the pass's consolidation
             record's verdicts equal the last 128-lane chunk of the
             device="cpu" sweep's (what the JAX rung, which streams while
             the incremental plane is on, records) and its Consolidated
             event cites the record; its nodes are cordoned, drained and deleted from cloud,
             store and cluster, the "cuda" rung served it with two fill
             launches a pack step. The same on 5 more fresh clusters over
             the same catalog, the first pass being the warm-up: the median
             pass wall, consolidation share and both sweeps' walls;
15. ctrl_incremental — a smoke of the incremental plane's path, not a
             model of user traffic: 10,000 initialized m5.4xlarge nodes (16 vCPU / 64 GiB / 110 pods, zones
             round-robin, every fourth spot, 10 bound pods each from
             bench.py --soak's templates) seeded into the ClusterState and
             the store; path A's provisioner; 12 reconciles, each after 200
             churn events in the soak's mix, a 1 s clock step, 200 pending
             pods of path A's seven spread-free deployments (chosen so that
             no cycle takes the entangled escape that path A's zone-spread
             "web" pods force) and one pod of 1,000 vCPU. Run (a) on the card with every plane on, (b) on the
             card with the incremental plane off, (c) on device="cpu" with
             the planes on. Every cycle binds the same pods to the same
             nodes, leaves the same pods unschedulable and launches the same
             machines in all three; (a) starts with the cold-start escape and
             is incremental from its third cycle on with no audit
             divergence, each card cycle is served by the cuda rung with two
             fill launches a pack step and files a gap-ledger row with the
             cuda backend and an overlap ratio of exactly 0.0; each cycle
             files one provisioning record whose entry for the 1,000-vCPU
             pod names "resources" with parity, cited by the pod's
             FailedScheduling event, and (a)'s records equal (c)'s but for
             trace ids and timestamps. Per cycle: mode, escape, dirty, sub
             and full nodes, resident bytes, each card run's bucket, solve
             span and solver phases, the extract and warm_start spans and
             the fill launches; overall the median solve span of (a)'s
             incremental cycles against (b)'s;
16. native_vs_card — NativeSolver (the C++ host scan) and TorchSolver on
             path A's mix at 100, 1k and 10k pods: flat buffers equal bit for
             bit (the card's cut to the scan's unpadded shape), and both
             medians. Routing is not changed by it;
17. ctrl_operator — path A through the port's Operator: every plane at its
             default (spot on at the static or ledger forecast, so its
             objective is inactive; incremental and explain on), the store
             watch attached, path A's provisioner with consolidation on, a
             NodeTemplate over the three zones and the interruption queue
             set, so all ten controllers run. One device="cpu" operator,
             then one warm-up and 5 timed reconcile_all_once passes, each on
             a fresh card operator over one catalog: each pass is served by
             the "cuda" rung for the solve and the consolidation sweep,
             launches the fill, and equals the CPU operator's machines,
             bindings, pending pods, consolidation actions and event
             reasons. Per pass: the wall, the provisioning cycle/solve/bind
             spans, the deprovisioning cycle and the time the operator's
             watch spends on pod events (timed by a wrapper here). Then one
             spot interruption warning for one launched node on both
             operators' queues and two passes: the node is cordoned,
             drained and terminated, its pods (created again, as their
             workload controller would) are placed on the card, and the
             outcome equals the CPU operator's;
18. ctrl_spot_storm — path A's provisioning reconcile on fresh card
             operators whose forecaster reads a hot schedule (the rebalance
             threshold + 0.2 on the spot pools of the zone where the
             static solve put most spot types), so the risk-aware objective
             drives the solve: the risk-adjusted solve, the spread re-solve
             and the masked re-solves of its bar phase. One device="cpu"
             run, then one warm-up and 5 timed: every routed solve on the
             "cuda" rung, at least one carrying an option_mask, the solve
             span marked spot_risk, no machine on a barred pool, and the
             machines, bindings, spot counter deltas and the record's
             barred, accepted and spread lists equal to the CPU run's;
19. ctrl_served — path A through the served port Operator: the port's mini
             apiserver (fake/apiserver.py); an HttpKubeStore over it, which
             the Operator is built with (serve_http, every listener on a
             free port, the store watch, ctrl_operator's settings) and
             through which ctrl_operator's NodeTemplate, provisioner
             (consolidation on) and path A's 10k pods are created; one
             reconcile_all_once on the card. Read back through a second
             HttpKubeStore (machines, bindings, pending pods) and the
             listeners: /debug/decisions (each new record by id, without
             ids, trace ids and timestamps, machine and node names written
             as their machine's row), /readyz 200, /metrics with
             karpenter_scheduling_phase_duration_seconds, /debug/statusz
             (its fleet and overload sections holding data), /eventz, a
             /validate review of the NodeTemplate (allowed) and of one with a restricted
             cluster tag (denied), and the port CLI's statusz, explain (one
             bound pod) and events against the served ports. The same run
             with device="cpu" on its own apiserver first: the outcome,
             bindings and records are equal, the card's solve and sweep
             ran on the "cuda" rung and the fill launched. Per run: the
             creates' wall, the pass wall, the provisioning cycle, solve
             and bind spans, the apiserver's requests and watch events
             (counted here), the fill launches and each endpoint's time;
20. service — the solver service's protobuf-free core (SolverService's
             sync, solve, consolidate and health) on the card at path A's
             size, keyed by the content keys a controller
             computes (wire.catalog_key/provisioners_key): the cold Sync of
             the 603-type catalog (grid build and upload) and a warm
             re-Sync; five Solves of path A's 10k pods, each equal bit for
             bit (flat buffer and decisions) to a direct TorchSolver solve
             on the card and to the same service on device="cpu", with 20
             fill launches each, catalog uploads flat after the first and
             delta uploads rising; the HBM ledger's catalog bytes for the
             key equal to the device alloc_t's and tiebreak's; the first
             Solve after a Sync with warm_pod_counts=[10000] against one
             without (the caching allocator emptied before each); the LRU
             at LRU_CAPACITY: four catalogs of new prices, the fourth on
             probation until its second Sync earns it, which evicts the
             least recently used key and releases its ledger row, a pinned
             (checkout) entry surviving the next eviction pass, and an
             availability-only change taking the donor path (no catalog
             upload, the group cache copied); Consolidate of config 3's 500
             nodes equal to run_consolidation on the card and on
             device="cpu" with two fill launches; Health reporting cuda and
             603 types; and a trace_every=1 service writing a Chrome trace
             that holds the open_claim kernels. Where grpcio is installed
             (service_wire), the same served over gRPC in this process and
             a RemoteSolver against it: 5 Solves of path A with the core's
             decisions and 20 fill launches each, a Consolidate of config 3
             with the core's action, and the wire's serialize and rpc
             spans;
21. cli_boot — `python -m karpenter_tpu_torch controller --simulate` on
             free ports in its own process: /readyz 200 within 60 s, a boot
             line naming the cuda device, /debug/statusz; SIGINT stops it
             with exit code 0 within 30 s and the state file written. And
             `solver-serve` exits 2 naming grpcio where grpcio is missing,
             or, where it is installed, serves and answers Health with
             cuda;
22. fleet — path C's 16 tenant problems through FleetFrontend(service=
             SolverService()) on the card, max_wave 16, ticked here: the 16
             tenants (one content, registered by the wire's content key)
             submit and one tick serves them in ONE mega-solve with as many
             fill launches as path C's wave; each tenant's flat buffer and
             decisions equal a direct solve_many on the card and a
             device="cpu" frontend's; the median of 5 submit-to-resolve
             walls beside the direct solve_many's, in turns; 64 tenants in
             four mega-solves with every wait within the starvation bound;
             a 1 ms budget shed at admission; statusz's fleet and overload
             sections listing the frontend;
23. fleet_wire — where grpcio imports: two FleetServices on the card
             served in this process behind a FleetRouter, path C's tenants
             sent 16 at once by RemoteSolver(tenant_id=...) to their home
             replica: every answer equals the in-process mega-solve's, each
             frontend holds only its home tenants; a served Operator
             answers /debug/fleetz with 200; the client's solve walls;
24. fleet_replicas — where grpcio imports: two `python -m
             karpenter_tpu_torch fleet-replica --device cuda` processes on
             one rendezvous directory, each with its own CUDA context; the
             small fleet drill's shape (benchmarks/fleet_drill.py SMALL: 48
             tenants, a 4 s closed loop of 8 workers, max_wave 4, one
             replica SIGKILLed at 45% of the window) through
             FailoverClient, MembershipManager and FleetView: every tenant
             served with no error, the kill absorbed within 3 membership
             cycles (the kill lands between two ticks, so each cycle
             counted from it probed after it) with the victim's fleetz row
             failing on "connect", each replica's Health reporting cuda,
             sampled tenants' answers equal to an in-process device="cpu"
             solve; each replica's boot-to-registration time, its solves,
             the client's p50 and p99, and the fill launches the survivor
             made in the window and in the sampled solves apart (a replica
             reports its counts on SIGUSR1 and counts from 0 again);
25. chaos — ChaosRunner(seed=0, scenarios=3, device="cuda") and the
             crash drill (seed 0), each passing with no violation, its
             artifact (durations, timestamps and paths stripped) equal to
             the same runner's on device="cpu", every consolidation pass on
             the "cuda" rung with the fill launched, no injected solver
             crash escaping the provisioning ladder; then `python -m
             karpenter_tpu_torch chaos --seed 0 --device cuda --out-dir
             <tmp>` exits 0;
26. chaos_spot_storm — the spot-storm drill at its default 10,000 nodes
             and 2,000 simultaneous reclaims on the card: it passes, every
             routed provisioning solve on the "cuda" rung, the fill
             launched; its key numbers (its equality with device="cpu" is
             held by the CPU tests at 500 nodes);
27. profiler — path A's solve 5 times with the profiling plane on (the
             continuous profiler's host sampler running, as it has since
             the first solve), 5 with the sampler alone held stopped and
             5 with the plane disabled, interleaved a solve at a time:
             each solve with the plane on files
             one device-ladder event in mode cuda-events (two CUDA events
             around the pack), within the solve's wall and at least path
             A's device-busy ms from the profile phase; none while
             disabled, and no sample with the sampler stopped; the three
             medians, the sampler's overhead gauge and its sweep seconds
             over each window's wall, the process's thread count;
             /debug/profilez of a served
             operator answering 200 with samples in both formats; a
             torch.profiler trace through the ladder's start_trace and
             stop_trace under port_results/;
28. mesh_1 — the mesh's split of the fill (launch 1 in its row-max mode,
             the waterfall as tensor code, launch 2) against its plain
             halves, bit for bit, at A's and B's shapes, the row-max mode
             timed against its plain version and its bound; then a
             world-size-1 NCCL process group in this process (a FileStore
             under port_results/) and ShardedContext 1 x 1: path A's flat
             buffer through dispatch_flat equal to the card's single
             dispatch, one launch in each mode a step, 3 all_reduces a step
             and 2 at the end;
29. mesh_ranks — separate processes (`chip_smoke.py --mesh-rank`) share
             the card over gloo, the kernels built once by this process:
             parity, not speed. A 2-rank mesh (nodes 1 x types 2) and a
             4-rank mesh (2 x 2) each solve BASELINE config 4 (50k pods in
             25 deployments, the 603-type catalog, 8 provisioners;
             karpenter_tpu_torch.entry.stress_problem) routed
             cuda-sharded, flat buffer equal to the single card's and
             decisions equal to the native scan's; the 4-rank mesh also
             path B, whose existing nodes and slots span both node slices;
             the 2-rank lane mesh config 3's 996 lanes, verdict table and
             action equal to the one-shot sweep's; per mesh the walls, the
             fill launches per rank and the collectives per solve. Then
             `solver-serve --distributed` as 2 ranks launched as torchrun
             launches them answers a gRPC Solve routed cuda-sharded over 2
             devices with the direct solve's decisions, and both ranks exit
             0 after SIGINT;
30. entry  — the driver's single-card callable (karpenter_tpu_torch.entry.
             entry(), the pack of a 64-pod, 16-type problem): its
             PackResult on the card equal, field for field, to
             entry(device="cpu")'s, the fused fill launched twice a step
             and K1 never; the median wall of 5 calls;
31. dryrun_multichip_8 — karpenter_tpu_torch.entry.dryrun_multichip(8):
             8 rank processes share the card over gloo (parity, not
             speed), the kernels built once by this process. BASELINE
             config 4 at 50k pods over the (nodes 4 x types 2) mesh, with
             rank 0's four checks: every PackResult field equal to the
             single card's pack, the decisions equal to the native scan's
             at 50k and to the oracle's on the 2k-pod subsample, and the
             lane mesh's consolidation action over 33 candidates (the lane
             pad path) equal to the one-shot sweep's. 50000 of 50000 pods
             placed; every rank's row-max and fill launches equal and
             above 0; rank 0's mesh walls and its checks' times;
32. pack_graph — a single Solve's pack as a CUDA graph replay
             (ops/pack_graph.py) at both benchmark cells' shapes
             (portbench's inflate and boutique configurations, 10k-pod
             burst requests): the shape's first sighting engages no graph;
             then for three requests in a row, the eager pack and the
             graph's run (capture at the first, replays after) of the same
             fields give the same flat buffer, bit for bit, and the same
             fill launch count; the median host time of the enqueue, eager
             against replay, over alternating packs, and the capturing
             run's beside an eager pack's; under torch.profiler, after a
             pack that warms it up, three replays and three eager packs,
             each in its own host window:
             the same operations in each pack's window (those in no
             window counted), and a replay's fill kernels (open_claim_qmax and
             open_claim_apply, counted in the trace) 2 a step, equal to
             the launches LAUNCHES was given back; its kernels and
             memcpy32_post kernels (a graph's device-to-device copies)
             beside the eager pack's kernels; through the cell's
             SolverService, the first Solve of a shape eager, the second
             capturing, the third a replay, and a Sync of a catalog of new
             prices giving a solver with no graph whose second Solve
             captures. After the fleet and chaos drills, one line a path
             (`pack_graph_ways`): its single-problem packs on the card by
             way (first sighting, key held, capture, replay) and the share
             replayed.

Paths A and B check that every node's used vector fits its decided type,
that packed plus unschedulable equals the input pods, that the open-claim
kernel's launch count rose by at least twice the solve's pack steps while
the standalone K1 was not launched, and that the flat result buffer equals
the same solve run with device="cpu", bit for bit. Paths C and D check
that the fill launched exactly twice per pack step of the wave or sweep
(its lanes share the launches). Each path's launch counts start at 0 just
before it and are read just after; for the controllers, just before and
after each reconcile or pass, which must report the "cuda" rung: a solve
that quietly degraded to the native scan or the oracle fails the run.

The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}. Any failure exits non-zero without that
line, as does a machine with no CUDA device.
"""

from __future__ import annotations

import collections
import contextlib
import gc
import itertools
import json
import math
import os
import statistics
import subprocess
import sys
import threading
import time
import traceback

INT_BIG = 2**30
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory (NVIDIA data sheet)
CUDA_CORE_OPS_PER_S = 67e12    # H100 SXM float32 outside the tensor cores
K1_SHAPES = [(n, 603, r) for r in (4, 11) for n in (8, 128, 512, 2048)]
# (N, T, S, R, Pv, pods cap?) of the open-claim sweep
OPEN_CLAIM_SHAPES = (
    [(n, 603, 6, r, pv, cap) for n in (32, 128, 512, 1000, 2048)
     for r in (4, 11) for pv in (1, 3) for cap in (False, True)]
    + [(128, 603, s, 4, 3, True) for s in (3, 4, 8)])
# (L, N, shared alloc?) of the lane-axis sweep
OPEN_CLAIM_LANE_CASES = [(L, N, shared) for L in (1, 16, 996)
                         for N in (2, 32, 128) for shared in (False, True)]
TIMED_SOLVES = 5

# (name, share out of 10_000, cpu, memory, zone-pin, zone-spread?): the
# headline mix of benchmarks/workloads.py, copied so this script imports
# nothing of the JAX side of the repo.
_DEPLOYMENTS = [
    ("web", 3000, "500m", "1Gi", None, True),
    ("api", 2000, "1", "2Gi", None, False),
    ("cache", 1000, "2", "8Gi", None, False),
    ("batch", 1500, "250m", "512Mi", None, False),
    ("etl", 800, "4", "8Gi", None, False),
    ("zone-a", 700, "1", "1Gi", "zone-1a", False),
    ("zone-b", 500, "1", "1Gi", "zone-1b", False),
    ("mem", 500, "500m", "4Gi", None, False),
]


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def phase(name, **fields):
    print(f"[{name}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# -- workloads ----------------------------------------------------------------

def provisioner(**kw):
    from karpenter_tpu_torch.apis import wellknown as wk
    from karpenter_tpu_torch.apis.provisioner import Provisioner
    from karpenter_tpu_torch.models.requirements import OP_IN, Requirements

    p = Provisioner(name="default", requirements=Requirements.of(
        (wk.LABEL_CAPACITY_TYPE, OP_IN, ["spot", "on-demand"])), **kw)
    p.set_defaults()
    return p


def mixed_workload(n: int, prefix: str = "") -> list:
    from karpenter_tpu_torch.apis import wellknown as wk
    from karpenter_tpu_torch.models.pod import TopologySpreadConstraint, make_pod

    spread = (TopologySpreadConstraint(max_skew=1, topology_key=wk.LABEL_ZONE),)
    counts = [max(0, round(n * share / 10_000)) for _, share, *_ in _DEPLOYMENTS]
    counts[0] += n - sum(counts)
    pods = []
    for (name, _, cpu, mem, zone, has_spread), count in zip(_DEPLOYMENTS, counts):
        sel = {wk.LABEL_ZONE: zone} if zone else {}
        topo = spread if has_spread else ()
        for i in range(count):
            pods.append(make_pod(f"{prefix}{name}-{i}", cpu=cpu, memory=mem,
                                 node_selector=dict(sel), topology=topo))
    return pods


def singleton_pod(name):
    from karpenter_tpu_torch.models.pod import make_pod

    return make_pod(name, cpu="250m", memory="512Mi",
                    anti_affinity_hostname=True)


def mixed_5k_pods() -> list:
    """The 5k config-1 mix (benchmarks/baseline_configs.py _mixed_5k_pods)."""
    from karpenter_tpu_torch.apis import wellknown as wk
    from karpenter_tpu_torch.models.pod import TopologySpreadConstraint, make_pod

    spread = (TopologySpreadConstraint(max_skew=1, topology_key=wk.LABEL_ZONE),)
    pods = []
    for name, count, cpu, mem, topo in (
            ("web", 1500, "500m", "1Gi", spread),
            ("api", 1200, "1", "2Gi", spread),
            ("cache", 700, "2", "8Gi", ()),
            ("batch", 1000, "250m", "512Mi", ()),
            ("mem", 500, "500m", "4Gi", ())):
        for i in range(count):
            pods.append(make_pod(f"{name}-{i}", cpu=cpu, memory=mem,
                                 topology=topo))
    pods += [singleton_pod(f"singleton-{i}") for i in range(100)]
    return pods


def existing_nodes(catalog, count=64, seed=7) -> list:
    """`count` partly used nodes of general-purpose amd64 catalog types,
    spread over the 3 zones; every fourth one already hosts a singleton
    replica, so hostname anti-affinity must count residents (ex_cap)."""
    import numpy as np

    from karpenter_tpu_torch.apis import wellknown as wk
    from karpenter_tpu_torch.oracle.scheduler import ExistingNode

    rng = np.random.default_rng(seed)
    pool = [t for t in catalog.types
            if t.labels_dict().get(wk.LABEL_ARCH) == "amd64"
            and not any(k.endswith("gpu") or "neuron" in k or "gaudi" in k
                        for k in dict(t.capacity))
            and 4000 <= dict(t.capacity)[wk.RESOURCE_CPU] <= 32000]
    cpu_i = wk.RESOURCE_INDEX[wk.RESOURCE_CPU]
    mem_i = wk.RESOURCE_INDEX[wk.RESOURCE_MEMORY]
    pods_i = wk.RESOURCE_INDEX[wk.RESOURCE_PODS]
    zones = ("zone-1a", "zone-1b", "zone-1c")
    out = []
    for i in range(count):
        t = pool[int(rng.integers(len(pool)))]
        alloc = list(t.allocatable_vector())
        used = [0] * wk.NUM_RESOURCES
        frac = float(rng.uniform(0.2, 0.8))
        used[cpu_i] = int(alloc[cpu_i] * frac)
        used[mem_i] = int(alloc[mem_i] * frac)
        used[pods_i] = int(rng.integers(1, 8))
        labels = t.labels_dict()
        labels[wk.LABEL_ZONE] = zones[i % 3]
        labels[wk.LABEL_CAPACITY_TYPE] = "on-demand"
        resident = (singleton_pod(f"resident-{i}"),) if i % 4 == 0 else ()
        out.append(ExistingNode(name=f"node-{i}", labels=labels,
                                allocatable=alloc, used=used,
                                resident=resident))
    return out


def copy_existing(nodes):
    from karpenter_tpu_torch.oracle.scheduler import ExistingNode

    return [ExistingNode(name=e.name, labels=dict(e.labels),
                         allocatable=list(e.allocatable), used=list(e.used),
                         taints=e.taints, resident=e.resident) for e in nodes]


# -- timing -------------------------------------------------------------------

def device_ms(fn, reps=25, inner=20, warm=5, reset=None):
    """Device time of one call of `fn`: the median over `reps` runs (after
    `warm` warm-up calls) of one CUDA-graph replay of `inner` back-to-back
    calls, timed with CUDA events and divided by `inner`. The graph keeps
    the host's per-call Python overhead, and the replay's own launch cost
    is shared by `inner` calls. `reset`, when given, runs before every
    replay, outside the timed span."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    # a garbage collection in the middle of the capture may destroy a CUDA
    # object, which invalidates the capture; the capture is thread-local, so
    # what other threads do to the card meanwhile (the solver's graphs are
    # destroyed in whichever thread next packs) does not reach it
    gc.collect()
    gc.disable()
    try:
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            for _ in range(inner):
                fn()
    finally:
        gc.enable()
    if reset is not None:
        reset()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if reset is not None:
            reset()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def host_us(fn, calls=200, reps=5):
    """Host time of one call of `fn` (its enqueue, not its device time):
    the median over `reps` runs of `calls` back-to-back calls on the
    host clock, each run ended by a synchronize outside the timed span."""
    import torch

    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        times.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    return statistics.median(times)


def k1_bound_ms(N, T, R):
    nbytes = (N * T + (T + N) * R + R) * 4
    ops = N * T * R
    b = nbytes / HBM_BYTES_PER_S * 1e3
    o = ops / CUDA_CORE_OPS_PER_S * 1e3
    return max(b, o), ("bytes" if b >= o else "operations")


# -- phases -------------------------------------------------------------------

def k1_inputs(N, T, R, seed):
    """Adversarial int32 inputs: magnitudes from 1 to INT_BIG, ~40% zero
    demand, rows with negative availability and rows landing exactly on (and
    one below) a multiple of the demand."""
    import numpy as np

    rng = np.random.default_rng(seed)

    def mixed(shape, lo_bits, hi_bits):
        bits = rng.integers(lo_bits, hi_bits + 1, size=shape)
        return rng.integers(0, 2 ** bits.astype(np.int64) + 1).astype(np.int64)

    alloc = mixed((T, R), 4, 30)
    alloc[0] = INT_BIG
    alloc[1] = 2**24
    used = mixed((N, R), 0, 30)
    vec = np.maximum(mixed((R,), 0, 24), 1)
    vec[rng.random(R) < 0.4] = 0
    vec[0] = max(int(vec[0]), 1)
    used[0] = 0
    if N > 2:
        # exact multiples for type 2 in row 1, one below in row 2
        q = alloc[2] // np.maximum(vec, 1)
        used[1] = alloc[2] - q * vec
        used[2] = np.minimum(used[1] + 1, alloc[2])
    if N > 3:
        used[3] = alloc[3] + 1           # negative availability everywhere
    return (np.clip(alloc, 0, INT_BIG).astype(np.int32),
            np.clip(used, 0, INT_BIG).astype(np.int32), vec.astype(np.int32))


def run_k1(torch, quotient):
    import numpy as np

    rows = []
    worst = 0
    for i, (N, T, R) in enumerate(K1_SHAPES):
        a_np, u_np, v_np = k1_inputs(N, T, R, seed=100 + i)
        dev = torch.device("cuda")
        alloc = quotient.type_major(torch.from_numpy(a_np).to(dev))
        used = torch.from_numpy(u_np).to(dev)
        cases = (("mixed", v_np), ("unit_vec", (v_np > 0).astype(np.int32)),
                 ("zero_vec", 0 * v_np))
        for case, vec_np in cases:
            vec = torch.from_numpy(vec_np).to(dev)
            got = quotient.quotient_nt(alloc, used, vec)
            want = quotient.quotient_nt_reference(alloc, used, vec)
            torch.cuda.synchronize()
            err = int((got.long() - want.long()).abs().max())
            worst = max(worst, err)
            check(torch.equal(got, want),
                  f"K1 differs from its plain version at N={N} T={T} R={R} "
                  f"({case}): max |diff| {err}")
            if case == "zero_vec":
                check(bool((got == INT_BIG).all()), "zero vec must give INT_BIG")
            elif case == "unit_vec":
                check(int(got.max()) >= 2**24, "unit vec must reach 2**24")
            else:
                check(bool((got == -1).any()), "mixed inputs must reach -1")
        vec = torch.from_numpy(v_np).to(dev)
        ms = device_ms(lambda: quotient.quotient_nt(alloc, used, vec))
        plain_ms = device_ms(
            lambda: quotient.quotient_nt_reference(alloc, used, vec))
        bound, by = k1_bound_ms(N, T, R)
        rows.append({"N": N, "T": T, "R": R, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bound, "bound_by": by})
        phase("k1", N=N, T=T, R=R, exact=True, ms=f"{ms:.5f}",
              plain_ms=f"{plain_ms:.5f}", bound_ms=f"{bound:.6f}",
              bound_by=by, library_ms="null")
    return rows, worst


def open_claim_case(torch, N, T, S, R, Pv, pods_cap, seed, rem):
    """open_claim_fill's arguments on the card for one adversarial state
    made from `seed`, as one lane (L = 1): a fifth of the rows inactive
    with stale masks, an active row with no feasible option, rows landing
    exactly on and one below a multiple of the demand, a row with negative
    availability, a row whose alloc - used wraps in int32, capacities and
    usage from 1 up to INT_BIG, and pods column 0 (the compressed
    layout's)."""
    import numpy as np

    from karpenter_tpu_torch.ops import quotient

    rng = np.random.default_rng(seed)
    alloc, used, vec = k1_inputs(N, T, R, seed)
    used = used.astype(np.int64)
    small = rng.random(N) < 0.7          # most rows leave room to fill
    used[small] = used[small] % (1 + alloc.min(axis=0) // 4)
    vec[0] = 1
    active = rng.random(N) < 0.8
    optmask = rng.random((N, T, S)) < 0.5
    if N > 5:
        active[1:5] = True
        optmask[1] = False               # no feasible option
        optmask[2:4, 2] = True           # k1_inputs' boundary rows, type 2
        used[4] = alloc.max(axis=0).astype(np.int64) + 1
    used = np.clip(used, 0, INT_BIG)
    if N > 6:
        used[5] = -2**31 + rng.integers(0, 2**10, size=R)  # alloc - used wraps
    nprov = np.where(active | (rng.random(N) < 0.5),
                     rng.integers(0, Pv, size=N), -1)
    case = {
        "alloc_t": quotient.type_major(torch.from_numpy(alloc))[None],
        "vec": torch.from_numpy(vec)[None],
        "cap": torch.tensor([INT_BIG if seed % 2 else 97], dtype=torch.int32),
        "feas": torch.from_numpy(rng.random((1, Pv, T, S)) < 0.6),
        "og": torch.tensor([1], dtype=torch.int64),
        "claim_placed": torch.from_numpy(
            rng.integers(0, 4, size=(1, 3, N)).astype(np.int32)),
        "prov_pods_cap": (torch.from_numpy(
            rng.integers(0, 250, size=(1, Pv, T)).astype(np.int32))
            if pods_cap else None),
        "pods_i": 0,
        "used": torch.from_numpy(used.astype(np.int32))[None],
        "optmask": torch.from_numpy(optmask)[None],
        "nprov": torch.from_numpy(nprov.astype(np.int32))[None],
        "active": torch.from_numpy(active)[None],
        "rem": torch.tensor([rem], dtype=torch.int32),
    }
    dev = torch.device("cuda")
    return {k: v.to(dev) if isinstance(v, torch.Tensor) else v
            for k, v in case.items()}


def run_open_claim_kernel(torch, oc, case):
    """Both launches on copies of the case's state, with a fresh workspace
    that must come back zeroed: -> (m, optmask, used, rem)."""
    used, optmask = case["used"].clone(), case["optmask"].clone()
    L, N = used.shape[:2]
    ws = oc.open_claim_workspace(N, used.device, L)
    m = torch.empty((L, N), dtype=torch.int32, device=used.device)
    rem_out = torch.empty((L,), dtype=torch.int32, device=used.device)
    args = oc.cuda_args(**dict(case, used=used, optmask=optmask),
                        workspace=ws, m=m, rem_out=rem_out)
    oc.launch_qmax(args)
    oc.launch_apply(args)
    torch.cuda.synchronize()
    check(not bool(ws.any()), "open_claim_fill left its workspace dirty")
    return m, optmask, used, rem_out


def run_open_claim(torch, oc):
    """The bit-for-bit sweep of the open-claim fill against the plain
    version. -> max |diff| (0)."""
    worst = 0
    cases = 0
    left_over = 0   # rem = INT_BIG cases whose fill left pods unplaced
    for i, (N, T, S, R, Pv, pods_cap) in enumerate(OPEN_CLAIM_SHAPES):
        for j, rem in enumerate((0, 37, INT_BIG)):
            case = open_claim_case(torch, N, T, S, R, Pv, pods_cap,
                                   seed=300 + 3 * i + j, rem=rem)
            want = oc.open_claim_fill_reference(**case)
            got = run_open_claim_kernel(torch, oc, case)
            for name, g, w in zip(("m", "optmask", "used", "rem"), got, want):
                err = int((g.long() - w.long()).abs().max())
                worst = max(worst, err)
                check(torch.equal(g, w),
                      f"open_claim_fill differs from its plain version in "
                      f"{name} at N={N} T={T} S={S} R={R} Pv={Pv} "
                      f"pods_cap={pods_cap} rem={rem}: max |diff| {err}")
            cases += 1
            placed = int((want[0] > 0).sum())
            if rem == 0:
                check(placed == 0, "rem = 0 must place nothing")
            elif rem == INT_BIG:
                check(placed > 0, "rem = INT_BIG must place pods")
                left_over += int(want[3][0]) > 0
    torch.cuda.synchronize()
    check(left_over > 0, "no case had rem above the total fill")
    phase("open_claim", cases=cases, shapes=len(OPEN_CLAIM_SHAPES),
          rem_above_fill_cases=left_over, exact=True, max_abs_err=worst)
    return worst


def lane_case(torch, L, N, T, S, R, Pv, shared, pods_cap, seed,
              device="cuda"):
    """open_claim_fill's arguments on the card for L lanes of adversarial
    state, made on the card from `seed`: per lane a fifth of the rows
    inactive with stale masks, capacities and usage from 1 up to INT_BIG,
    ~40% zero demand, its own cap, origin row and claim counts; lanes with
    rem = INT_BIG, 0 and 37 side by side; in every lane with N > 5 an
    active row with no feasible option, rows landing exactly on and one
    below a multiple of the demand, a row with negative availability and a
    row whose alloc - used wraps in int32. With `shared` the lanes share
    one alloc_t (and pods cap) through an expanded view, as the
    consolidation sweep passes them; else each lane has its own, as a
    wave's lanes do."""
    from karpenter_tpu_torch.ops import quotient

    dev = torch.device(device)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)

    def rand(shape):
        return torch.rand(shape, generator=g, device=dev)

    def ints(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=g, device=dev)

    def mixed(shape, lo_bits, hi_bits):
        bits = ints(lo_bits, hi_bits + 1, shape).double()
        return (torch.rand(shape, generator=g, device=dev, dtype=torch.float64)
                * (2.0 ** bits + 1)).floor().long()

    La = 1 if shared else L
    alloc = mixed((La, T, R), 4, 30)
    alloc[:, 0] = INT_BIG
    alloc[:, 1] = 2**24
    vec = torch.maximum(mixed((L, R), 0, 24), torch.ones((), dtype=torch.long,
                                                         device=dev))
    vec[rand((L, R)) < 0.4] = 0
    vec[:, 0] = 1
    used = mixed((L, N, R), 0, 30)
    small = rand((L, N)) < 0.7           # most rows leave room to fill
    room = 1 + alloc.amin(dim=1) // 4    # [La, R]
    used = torch.where(small[:, :, None], used % room[:, None, :], used)
    active = rand((L, N)) < 0.8
    optmask = rand((L, N, T, S)) < 0.5
    if N > 5:
        a2 = alloc[:, 2].expand(L, R)    # type 2 of each lane's catalog
        v = vec.clamp(min=1)
        used[:, 1] = a2 - (a2 // v) * v              # exact multiples
        used[:, 2] = torch.minimum(used[:, 1] + 1, a2)   # one below
        optmask[:, 1:3, 2] = True
        active[:, :5] = True
        optmask[:, 3] = False                        # no feasible option
        used[:, 4] = alloc.amax(dim=1).expand(L, R) + 1  # negative everywhere
    used = used.clamp(0, INT_BIG)
    if N > 6:
        used[:, 5] = -2**31 + ints(0, 2**10, (L, R))     # alloc - used wraps
    nprov = torch.where(active | (rand((L, N)) < 0.5), ints(0, Pv, (L, N)),
                        -1)
    lane = torch.arange(L, device=dev)
    alloc_tm = quotient.type_major(alloc[0].int())[None].expand(L, T, R) \
        if shared else alloc.int().transpose(1, 2).contiguous().transpose(1, 2)
    pc = None
    if pods_cap:
        pc = ints(0, 250, (La, Pv, T)).int()
        pc = pc.expand(L, Pv, T) if shared else pc
    return {
        "alloc_t": alloc_tm,
        "vec": vec.int(),
        "cap": torch.where(lane % 2 == 1, INT_BIG, 97).int(),
        "feas": rand((L, Pv, T, S)) < 0.6,
        "og": ints(0, 3, (L,)),
        "claim_placed": ints(0, 4, (L, 3, N)).int(),
        "prov_pods_cap": pc,
        "pods_i": 0,
        "used": used.int(),
        "optmask": optmask,
        "nprov": nprov.int(),
        "active": active,
        "rem": torch.tensor((INT_BIG, 0, 37), dtype=torch.int32,
                            device=dev).repeat(L // 3 + 1)[:L],
    }


def open_claim_bound_ms(case, m):
    """The larger of the fill's bytes over the memory rate and its
    divisions over the CUDA-core rate, counting what this state needs,
    summed over the lanes. An inactive row's outputs (m = 0, used and mask
    unchanged) depend on its `active` byte alone, so only active rows'
    mask, used, nprov and claim_placed entries are read, with the
    feasibility and pods-cap planes that active rows use and the alloc
    columns of demanded resources; one division per demanded resource for
    each active (n, t) with a feasible option; m and rem written, and
    placed rows' mask and demanded used entries. An input the lanes share
    (alloc_t, the pods cap, lane stride 0) is read once: the alloc columns
    any lane demands, the pods-cap planes any lane uses."""
    import torch

    used, optmask, active, vec = (case["used"], case["optmask"],
                                  case["active"], case["vec"])
    L, N, R = used.shape
    T, S = optmask.shape[2:]
    feas, pc, pods_i = case["feas"], case["prov_pods_cap"], case["pods_i"]
    Pv = feas.shape[1]
    lane = torch.arange(L, device=used.device)
    nprov0 = case["nprov"].clamp(min=0).long()
    feas_n = feas[:, 0][:, None] if Pv == 1 else feas[lane[:, None], nprov0]
    pairs = (optmask & feas_n & active[:, :, None, None]).any(dim=-1) \
        .sum(dim=(1, 2)).long()                                  # [L]
    n_act = active.sum(dim=1).long()
    demanded = (vec > 0).sum(dim=1).long()
    placed = (m > 0).sum(dim=1).long()
    use_pc = (vec[:, pods_i] > 0) if pc is not None \
        else torch.zeros((L,), dtype=torch.bool, device=used.device)
    plane_used = torch.zeros((L, Pv), dtype=torch.bool, device=used.device)
    plane_used[lane[:, None].expand(L, N)[active], nprov0[active]] = True
    if Pv == 1:
        plane_used[:] = (n_act > 0)[:, None]
    planes = plane_used.sum(dim=1).long()
    shared_alloc = L > 1 and case["alloc_t"].stride(0) == 0
    shared_pc = pc is not None and L > 1 and pc.stride(0) == 0
    live = n_act > 0
    per_lane = (R * 4 + 4 + 8 + 4 + N                      # vec cap og rem active
                + n_act * (T * S + demanded * 4 + 4)       # mask used claim_placed
                + torch.where((Pv > 1) | use_pc, n_act * 4, 0)   # nprov
                + planes * T * S                           # feas
                + N * 4 + 4 + placed * (T * S + demanded * 4))   # written
    if not shared_alloc:
        per_lane = per_lane + T * demanded * 4
    if not shared_pc:
        per_lane = per_lane + torch.where(use_pc & live, planes * T * 4, 0)
    nbytes = int(per_lane.sum())
    if shared_alloc:
        nbytes += T * 4 * int((vec > 0).any(dim=0).sum())
    if shared_pc:
        nbytes += T * 4 * int((plane_used & (use_pc & live)[:, None])
                              .any(dim=0).sum())
    b = nbytes / HBM_BYTES_PER_S * 1e3
    o = int((pairs * (demanded + use_pc.long())).sum()) \
        / CUDA_CORE_OPS_PER_S * 1e3
    return max(b, o), ("bytes" if b >= o else "operations")


def time_open_claim(torch, oc, quotient, label, case):
    """The open-claim fill on a timing state (`case`, in lane form): each
    launch's device time, their sum, the bound, the plain version and the
    host time per call of the wrapper; for one lane also the sequence the
    fill replaced (K1 plus the step-2 tensor code) and its host time. The
    wrapper's host time is taken twice: per step of a pack (an
    OpenClaimFill made once, as the pack's loop makes it) and for one
    checked call (open_claim_fill, which checks every operand). Each
    timed call of launch 1 runs on its own copy of the checked state's used
    rows, restored before every replay, so it does the checked call's work
    and must give its outputs. Launch 2 is timed on the state the checked
    call left, with its m: its shrink is idempotent and its work does not
    depend on the mask's values, so every call rewrites the same words as
    the checked call."""
    want = oc.open_claim_fill_reference(**case)
    used, optmask = case["used"].clone(), case["optmask"].clone()
    L, N, R = used.shape
    T, S = optmask.shape[2:]
    ws = oc.open_claim_workspace(N, used.device, L)
    m = torch.empty((L, N), dtype=torch.int32, device=used.device)
    rem_out = torch.empty((L,), dtype=torch.int32, device=used.device)
    state = dict(case, used=used, optmask=optmask)

    def args():
        return oc.cuda_args(**state, workspace=ws, m=m, rem_out=rem_out)

    oc.launch_qmax(args())
    oc.launch_apply(args())
    torch.cuda.synchronize()
    check(torch.equal(m, want[0]) and torch.equal(optmask, want[1])
          and torch.equal(used, want[2]) and torch.equal(rem_out, want[3]),
          f"open_claim_fill differs from its plain version at {label}")
    placed_m = m.clone()

    inner = 20
    clones = [case["used"].clone() for _ in range(inner)]
    m1 = torch.empty_like(m)
    rem1 = torch.empty_like(rem_out)
    rows = itertools.cycle(clones)

    def restore():
        for u in clones:
            u.copy_(case["used"])

    def launch1():   # its arguments name the stream it is captured on
        oc.launch_qmax(oc.cuda_args(**dict(case, used=next(rows)),
                                    workspace=ws, m=m1, rem_out=rem1))

    l1 = device_ms(launch1, inner=inner, reset=restore)
    torch.cuda.synchronize()
    check(torch.equal(m1, want[0]) and torch.equal(rem1, want[3])
          and all(torch.equal(u, want[2]) for u in clones),
          f"launch 1's timed calls left other outputs than the checked "
          f"call at {label}")
    l2 = device_ms(lambda: oc.launch_apply(args()))
    plain = device_ms(lambda: oc.open_claim_fill_reference(**case))
    fill = oc.OpenClaimFill(case["alloc_t"], case["prov_pods_cap"],
                            case["pods_i"], ws)
    step = {k: v for k, v in state.items()
            if k not in ("alloc_t", "prov_pods_cap", "pods_i")}
    host = host_us(lambda: fill(**step))
    host_checked = host_us(lambda: oc.open_claim_fill(**state, workspace=ws))
    bound, by = open_claim_bound_ms(case, placed_m)
    row = {"L": L, "N": N, "T": T, "S": S, "R": R,
           "Pv": case["feas"].shape[1],
           "shared_alloc": L > 1 and case["alloc_t"].stride(0) == 0,
           "active_rows": int(case["active"].sum()),
           "placed_rows": int((placed_m > 0).sum()),
           "launch1_ms": l1, "launch2_ms": l2, "ms": l1 + l2,
           "plain_ms": plain, "host_us": host, "host_us_checked": host_checked,
           "bound_ms": bound, "bound_by": by}
    if L == 1:
        def k1(a, u, v):
            return quotient.quotient_nt(a[0], u[0], v[0])[None]

        row["k1_sequence_ms"] = device_ms(
            lambda: oc.open_claim_fill_reference(**case, quotient=k1))
        row["k1_sequence_host_us"] = host_us(
            lambda: oc.open_claim_fill_reference(**case, quotient=k1))
    phase(f"open_claim_{label}_shape",
          **{k: (f"{v:.5f}" if isinstance(v, float) else v)
             for k, v in row.items()})
    return row


def run_open_claim_lanes(torch, oc):
    """The lane-axis fill against its plain version, bit for bit, over
    L x N x {shared, per-lane alloc}. -> (cases, max |diff|)."""
    worst = 0
    cases = 0
    filled = 0   # rem = INT_BIG lanes that placed pods
    for i, (L, N, shared) in enumerate(OPEN_CLAIM_LANE_CASES):
        R, Pv = (11, 1) if shared else (4, 3)
        pods_cap = not shared or N == 32
        case = lane_case(torch, L, N, 603, 6, R, Pv, shared, pods_cap,
                         seed=700 + i)
        want = oc.open_claim_fill_reference(**case)
        got = run_open_claim_kernel(torch, oc, case)
        for name, g, w in zip(("m", "optmask", "used", "rem"), got, want):
            err = int((g.long() - w.long()).abs().max())
            worst = max(worst, err)
            check(torch.equal(g, w),
                  f"lane fill differs from its plain version in {name} at "
                  f"L={L} N={N} shared_alloc={shared}: max |diff| {err}")
        rem = case["rem"]
        placed = (want[0] > 0).any(dim=1)
        check(not bool(placed[rem == 0].any()),
              "a lane with rem = 0 placed pods")
        filled += int(placed[rem == INT_BIG].sum())
        cases += 1
        del want, got, case
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    check(filled > 0, "no lane with rem = INT_BIG placed pods")
    phase("open_claim_lanes", cases=cases,
          lanes=",".join(str(x) for x in sorted({c[0] for c in
                                                 OPEN_CLAIM_LANE_CASES})),
          slots=",".join(str(x) for x in sorted({c[1] for c in
                                                 OPEN_CLAIM_LANE_CASES})),
          shared_and_per_lane_alloc=True, int_big_lanes_filled=filled,
          exact=True, max_abs_err=worst)
    return worst


def node_fit_errors(res, pods_total, existing=()):
    """Violations of the solve invariants (empty when all hold)."""
    from karpenter_tpu_torch.apis import wellknown as wk
    from karpenter_tpu_torch.oracle.scheduler import (effective_alloc,
                                                      kubelet_overhead_vector)

    errs = []
    for n in res.nodes:
        used = list(kubelet_overhead_vector(n.provisioner.kubelet))
        for g, c in n.pod_counts.items():
            vec = res.groups[g].vector
            for r in range(wk.NUM_RESOURCES):
                used[r] += vec[r] * c
        alloc = effective_alloc(n.option, n.provisioner)
        if any(u > a for u, a in zip(used, alloc)):
            errs.append(f"node {n.option.itype.name} over-packed")
    by_name = {e.name: e for e in existing}
    for name, per_group in res.existing_by_group.items():
        e = by_name[name]
        used = list(e.used)
        for g, c in per_group.items():
            vec = res.groups[g].vector
            for r in range(wk.NUM_RESOURCES):
                used[r] += vec[r] * c
        if any(u > a for u, a in zip(used, e.allocatable)):
            errs.append(f"existing node {name} over-packed")
    packed = sum(n.pod_count for n in res.nodes) + sum(
        res.existing_counts.values())
    if packed + res.unschedulable_count() != pods_total:
        errs.append(f"packed {packed} + unschedulable "
                    f"{res.unschedulable_count()} != {pods_total} pods")
    return errs


def run_path(label, catalog, prov, pods, existing, LAUNCHES, TorchSolver,
             KERNEL, K1):
    import numpy as np

    solver = TorchSolver(catalog, [prov])        # device=None: the card
    check(solver.device.type == "cuda", "TorchSolver must default to cuda")
    infos = []
    res = None
    for i in range(1 + TIMED_SOLVES):
        before, k1_before = LAUNCHES.get(KERNEL), LAUNCHES.get(K1)
        t0 = time.perf_counter()
        res = solver.solve(list(pods), existing=copy_existing(existing))
        wall = (time.perf_counter() - t0) * 1000
        info = dict(solver.last_solve_info, wall_ms=wall)
        rose = LAUNCHES.get(KERNEL) - before
        check(rose >= 2 * info["steps"] > 0,
              f"{label}: open-claim launches rose by {rose} over "
              f"{info['steps']} pack steps (two launches a step)")
        check(LAUNCHES.get(K1) == k1_before,
              f"{label}: the main path launched the standalone K1")
        info["open_claim_launches"] = rose
        errs = node_fit_errors(res, len(pods), existing)
        check(not errs, f"{label}: " + "; ".join(errs[:5]))
        if i:
            infos.append(info)
    cuda_flat = solver.last_flat
    cpu_solver = TorchSolver(catalog, [prov], device="cpu")
    cpu_res = cpu_solver.solve(list(pods), existing=copy_existing(existing))
    check(cuda_flat.dtype == np.int32 and cpu_solver.last_flat.dtype == np.int32,
          f"{label}: flat buffers must be int32")
    check(np.array_equal(cuda_flat, cpu_solver.last_flat),
          f"{label}: CUDA flat buffer differs from the device='cpu' solve")
    check(res.decisions() == cpu_res.decisions(),
          f"{label}: decisions differ from the device='cpu' solve")
    med = {k: statistics.median(i[k] for i in infos)
           for k in ("encode_ms", "dispatch_ms", "transfer_ms", "decode_ms",
                     "wall_ms")}
    phase(label, bucket=infos[-1]["bucket"], routing=infos[-1]["routing"],
          pods=len(pods), existing=len(existing), nodes=len(res.nodes),
          unschedulable=res.unschedulable_count(),
          steps_per_solve=infos[-1]["steps"],
          open_claim_launches_per_solve=infos[-1]["open_claim_launches"],
          k1_launches_per_solve=0,
          flat_bit_equal_cpu=True,
          **{f"median_{k}": f"{v:.3f}" for k, v in med.items()})
    return infos[-1]


def wave_problems(n_problems=16, total=10_000):
    """Path C's wave: `n_problems` tenant problems of the headline mix, each
    about total / n_problems pods, its size drawn from its own seed (the
    last one takes what is left of `total`)."""
    import numpy as np

    mean = total // n_problems
    sizes = [int(np.random.default_rng(1000 + k).integers(mean - 40,
                                                          mean + 41))
             for k in range(n_problems - 1)]
    sizes.append(total - sum(sizes))
    return [{"pods": mixed_workload(n, prefix=f"t{k}-")}
            for k, n in enumerate(sizes)]


def run_path_c(catalog, prov, LAUNCHES, TorchSolver, KERNEL, K1):
    """Path C: a solve_many wave of 16 tenant problems (the fleet
    frontend's default max_wave) on the card. Checks: one bucket holds all
    16; each lane's flat buffer equals that problem's single solve on the
    card and the device="cpu" wave's, bit for bit; the fill launched twice
    per pack step of the wave, not per problem; the solve invariants."""
    import numpy as np

    problems = wave_problems()
    n_pods = sum(len(p["pods"]) for p in problems)
    solver = TorchSolver(catalog, [prov])
    LAUNCHES.reset()
    infos = []
    for i in range(1 + TIMED_SOLVES):
        before = LAUNCHES.get(KERNEL)
        t0 = time.perf_counter()
        results = solver.solve_many(problems)
        wall = (time.perf_counter() - t0) * 1000
        info = dict(solver.last_wave_info, wall_ms=wall)
        (wave,) = info["waves"]
        check(wave["problems"] == len(problems) == wave["lanes"],
              f"pathC: the problems did not share one bucket: "
              f"{info['waves']}")
        rose = LAUNCHES.get(KERNEL) - before
        check(rose == 2 * wave["steps"] > 0,
              f"pathC: open-claim launches rose by {rose} over "
              f"{wave['steps']} pack steps of the wave (two a step)")
        info["open_claim_launches"] = rose
        if i:
            infos.append(info)
    launches = {KERNEL: LAUNCHES.get(KERNEL), K1: LAUNCHES.get(K1)}
    check(launches[K1] == 0, "pathC: the main path launched the standalone K1")
    flats = list(solver.last_wave_flats)
    for prob, res in zip(problems, results):
        errs = node_fit_errors(res, len(prob["pods"]))
        check(not errs, "pathC: " + "; ".join(errs[:5]))
    single = TorchSolver(catalog, [prov])
    seq_wall = 0.0
    for k, prob in enumerate(problems):
        t0 = time.perf_counter()
        single.solve(list(prob["pods"]))
        seq_wall += (time.perf_counter() - t0) * 1000
        check(np.array_equal(flats[k], single.last_flat),
              f"pathC: lane {k}'s flat buffer differs from its single solve")
    cpu = TorchSolver(catalog, [prov], device="cpu")
    cpu.solve_many(problems)
    for k, flat in enumerate(cpu.last_wave_flats):
        check(flat.dtype == np.int32 and np.array_equal(flats[k], flat),
              f"pathC: lane {k}'s flat buffer differs from the device='cpu' "
              f"wave")
    med = {k: statistics.median(i[k] for i in infos)
           for k in ("encode_ms", "dispatch_ms", "transfer_ms", "decode_ms",
                     "wall_ms")}
    wave = infos[-1]["waves"][0]
    phase("pathC", bucket=wave["bucket"], K=wave["lanes"],
          problems=len(problems), pods=n_pods,
          nodes=sum(len(r.nodes) for r in results),
          steps_per_wave=wave["steps"],
          open_claim_launches_per_wave=infos[-1]["open_claim_launches"],
          k1_launches_per_wave=0, lanes_equal_single_solves=True,
          lanes_equal_cpu_wave=True,
          sequential_solves_wall_ms=f"{seq_wall:.3f}",
          **{f"median_{k}": f"{v:.3f}" for k, v in med.items()})
    return infos[-1], launches, problems


def config3_cluster(catalog, n_nodes=500):
    """BASELINE config 3 (benchmarks/baseline_configs.py:158-191, copied):
    500 m5.2xlarge on-demand nodes in zone-1a, each holding one 500m/1Gi
    pod, so every node is a candidate."""
    from karpenter_tpu_torch.apis import wellknown as wk
    from karpenter_tpu_torch.models.cluster import ClusterState, StateNode
    from karpenter_tpu_torch.models.pod import make_pod

    big = catalog.by_name["m5.2xlarge"]
    cluster = ClusterState()
    for i in range(n_nodes):
        cluster.add_node(StateNode(
            name=f"n-{i}",
            labels={**big.labels_dict(), wk.LABEL_ZONE: "zone-1a",
                    wk.LABEL_CAPACITY_TYPE: "on-demand",
                    wk.LABEL_PROVISIONER: "default"},
            allocatable=big.allocatable_vector(),
            instance_type=big.name, zone="zone-1a", capacity_type="on-demand",
            price=big.offerings[0].price, provisioner_name="default",
            pods=[make_pod(f"p-{i}", cpu="500m", memory="1Gi",
                           node_name=f"n-{i}")]))
    return cluster


def config5_problem():
    """BASELINE config 5 (benchmarks/baseline_configs.py:316-356, copied):
    64 FULL nodes of the cheapest >= 8-vCPU type, and a bulk type priced so
    one bulk node undercuts two of them but not one. No single-node action
    exists; a pair replace does. -> (catalog, cluster)."""
    from karpenter_tpu_torch.apis import wellknown as wk
    from karpenter_tpu_torch.models.cluster import ClusterState, StateNode
    from karpenter_tpu_torch.models.instancetype import make_instance_type
    from karpenter_tpu_torch.models.pod import make_pod
    from karpenter_tpu_torch.providers.instancetypes import generate_fleet_catalog

    catalog = generate_fleet_catalog()
    big = min((t for t in catalog.types
               if dict(t.capacity)[wk.RESOURCE_CPU] >= 8000),
              key=lambda t: t.offerings[0].price)
    bulk_price = round(big.offerings[0].price * 1.7, 4)
    catalog.types.append(make_instance_type(
        "bulk.32xlarge", cpu=32, memory="128Gi", od_price=bulk_price))
    catalog.bump()
    cluster = ClusterState()
    alloc = big.allocatable_vector()
    cpu_free = alloc[wk.RESOURCE_INDEX[wk.RESOURCE_CPU]]
    for i in range(64):
        n_pods = max(1, cpu_free // 1000)
        cluster.add_node(StateNode(
            name=f"n-{i:03d}",
            labels={**big.labels_dict(), wk.LABEL_ZONE: "zone-1a",
                    wk.LABEL_CAPACITY_TYPE: "on-demand",
                    wk.LABEL_PROVISIONER: "default"},
            allocatable=list(alloc),
            instance_type=big.name, zone="zone-1a", capacity_type="on-demand",
            price=big.offerings[0].price, provisioner_name="default",
            pods=[make_pod(f"p{i}-{j}", cpu="1", memory="1Gi",
                           node_name=f"n-{i:03d}") for j in range(n_pods)]))
    return catalog, cluster


def consolidation_provisioner():
    from karpenter_tpu_torch.apis.provisioner import Provisioner

    p = Provisioner(name="default", consolidation_enabled=True)
    p.set_defaults()
    return p


def action_key(a):
    return None if a is None else (a.kind, a.nodes, a.replacement)


def run_path_d(catalog, LAUNCHES, consolidate, KERNEL, K1, n_nodes=500):
    """Path D: BASELINE config 3's consolidation sweep on the card, pairs
    on (996 lanes), a warm-up then TIMED_SOLVES timed sweeps; the streamed
    sweep at 128 lanes a chunk must pick the same action; both verdict
    tables must equal the device="cpu" runs bit for bit."""
    import numpy as np

    cluster = config3_cluster(catalog, n_nodes)
    prov = consolidation_provisioner()
    LAUNCHES.reset()
    timings = []
    action = None
    for i in range(1 + TIMED_SOLVES):
        before = LAUNCHES.get(KERNEL)
        t0 = time.perf_counter()
        action = consolidate.run_consolidation(cluster, catalog, [prov])
        wall = (time.perf_counter() - t0) * 1000
        t = dict(consolidate.last_timings, wall_ms=wall)
        rose = LAUNCHES.get(KERNEL) - before
        check(rose == 2 * t["steps"] > 0,
              f"pathD: open-claim launches rose by {rose} over {t['steps']} "
              f"pack steps of the sweep (two a step)")
        t["open_claim_launches"] = rose
        if i:
            timings.append(t)
    launches = {KERNEL: LAUNCHES.get(KERNEL), K1: LAUNCHES.get(K1)}
    check(launches[K1] == 0, "pathD: the main path launched the standalone K1")
    check(action is not None, "pathD: config 3 found no action")
    lanes = timings[-1]["lanes"]
    # pairs of the MAX_PAIR_CANDIDATES cheapest to disrupt, then singles:
    # 496 + 500 = 996 at config 3's 500 nodes
    want = math.comb(min(n_nodes, 32), 2) + n_nodes
    check(lanes == want, f"pathD: {lanes} lanes, want {want}")
    table = consolidate.last_verdict_table.copy()
    streamed = consolidate.stream_consolidation(cluster, catalog, [prov],
                                                batch_lanes=128)
    stream_table = consolidate.last_verdict_table.copy()
    stream_t = dict(consolidate.last_timings)
    check(action_key(streamed) == action_key(action),
          f"pathD: streamed action {streamed} differs from one-shot {action}")
    cpu_action = consolidate.run_consolidation(cluster, catalog, [prov],
                                               device="cpu")
    check(np.array_equal(consolidate.last_verdict_table, table),
          "pathD: verdict table differs from the device='cpu' sweep")
    check(action_key(cpu_action) == action_key(action),
          "pathD: action differs from the device='cpu' sweep")
    consolidate.stream_consolidation(cluster, catalog, [prov],
                                     batch_lanes=128, device="cpu")
    check(np.array_equal(consolidate.last_verdict_table, stream_table),
          "pathD: streamed verdict table differs from the device='cpu' one")
    med = {k: statistics.median(t[k] for t in timings)
           for k in ("encode_ms", "flatten_ms", "put_ms", "dispatch_ms",
                     "fetch_ms", "decode_ms", "wall_ms")}
    phase("pathD", lanes=lanes, steps_per_sweep=timings[-1]["steps"],
          open_claim_launches_per_sweep=timings[-1]["open_claim_launches"],
          k1_launches_per_sweep=0, action=action.kind,
          nodes="+".join(action.nodes),
          replacement=(action.replacement[0] if action.replacement else None),
          savings_per_hour=f"{action.savings:.4f}",
          streamed_same_action=True, stream_chunks=stream_t["chunks"],
          stream_pruned_types=stream_t["pruned_types"],
          stream_total_ms=f"{stream_t['total_ms']:.3f}",
          verdicts_bit_equal_cpu=True,
          **{f"median_{k}": f"{v:.3f}" for k, v in med.items()})
    return timings[-1], launches, cluster, prov


def run_config5(LAUNCHES, consolidate, KERNEL):
    """BASELINE config 5's 64-node pair sweep: the action must be a
    two-node replace, equal to the device="cpu" sweep's, with equal verdict
    tables."""
    import numpy as np

    catalog, cluster = config5_problem()
    prov = consolidation_provisioner()
    LAUNCHES.reset()
    action = consolidate.run_consolidation(cluster, catalog, [prov])
    launches = LAUNCHES.get(KERNEL)
    t = dict(consolidate.last_timings)
    table = consolidate.last_verdict_table.copy()
    check(action is not None and action.kind == "replace"
          and len(action.nodes) == 2,
          f"config5: want a two-node replace, got {action}")
    cpu_action = consolidate.run_consolidation(cluster, catalog, [prov],
                                               device="cpu")
    check(action_key(cpu_action) == action_key(action),
          "config5: action differs from the device='cpu' sweep")
    check(np.array_equal(consolidate.last_verdict_table, table),
          "config5: verdict table differs from the device='cpu' sweep")
    phase("config5", lanes=t["lanes"], steps=t["steps"],
          open_claim_launches=launches, action=action.kind,
          nodes="+".join(action.nodes), replacement=action.replacement[0],
          savings_per_hour=f"{action.savings:.4f}", equal_cpu=True)
    return launches


# -- the controllers ---------------------------------------------------------

def controller_stack(catalog, device, prov, zero_windows=False):
    """The port's controllers wired as the JAX operator wires them
    (karpenter_tpu/operator.py:84-107, 151-217): a KubeStore, ClusterState,
    EventRecorder, the fake cloud behind a CloudProvider, an IntentJournal,
    the provisioning, termination, deprovisioning and machine-lifecycle
    controllers on `device`, and cluster.pdbs; one NodeTemplate over the
    three zones and `prov`. The operator's store watch is not attached: a
    bound pod joins its node through the provisioning controller's own
    append, as in standalone use. The clock is a FakeClock and the pod batch
    windows are 0, as in the JAX package's end-to-end tests; the cloud
    batchers keep their defaults (CreateFleet 35 ms idle, Describe and
    Terminate 100 ms, 1 s max, on the host's clock), or with `zero_windows`
    flush at once on the FakeClock, as the port's CPU parity tests set
    them."""
    import types

    from karpenter_tpu_torch.apis.nodetemplate import NodeTemplate
    from karpenter_tpu_torch.apis.settings import Settings
    from karpenter_tpu_torch.cloudprovider import CloudProvider
    from karpenter_tpu_torch.controllers.deprovisioning import DeprovisioningController
    from karpenter_tpu_torch.controllers.machinelifecycle import MachineLifecycleController
    from karpenter_tpu_torch.controllers.provisioning import ProvisioningController
    from karpenter_tpu_torch.controllers.termination import TerminationController
    from karpenter_tpu_torch.events import EventRecorder
    from karpenter_tpu_torch.fake.cloud import FakeCloud
    from karpenter_tpu_torch.fake.kube import KubeStore
    from karpenter_tpu_torch.models.cluster import ClusterState
    from karpenter_tpu_torch.recovery.journal import IntentJournal
    from karpenter_tpu_torch.utils.clock import FakeClock

    st = types.SimpleNamespace()
    st.clock = FakeClock()
    st.cloud = FakeCloud(catalog=catalog, clock=st.clock)
    st.settings = Settings(cluster_name="smoke",
                           cluster_endpoint="https://k.example",
                           batch_idle_duration=0.0, batch_max_duration=0.0)
    st.kube = KubeStore()
    st.cluster = ClusterState()
    st.recorder = EventRecorder(clock=st.clock)
    st.cp = CloudProvider(st.cloud, st.settings, catalog, clock=st.clock)
    if zero_windows:
        from karpenter_tpu_torch.batcher import fleet

        inst = st.cp.instances
        for attr, cls in (("fleet", fleet.CreateFleetBatcher),
                          ("describe", fleet.DescribeInstancesBatcher),
                          ("terminate", fleet.TerminateInstancesBatcher)):
            getattr(inst, attr).stop()
            setattr(inst, attr, cls(st.cloud, clock=st.clock, idle=0.0,
                                    max_wait=0.0))
    st.cp.template_source = lambda name: st.kube.get("nodetemplates", name)
    st.journal = IntentJournal(st.kube, clock=st.clock)
    st.provisioning = ProvisioningController(
        st.kube, st.cp, st.cluster, st.settings, clock=st.clock,
        recorder=st.recorder, journal=st.journal, device=device)
    st.termination = TerminationController(
        st.kube, st.cp, st.cluster, clock=st.clock, recorder=st.recorder,
        journal=st.journal)
    st.deprovisioning = DeprovisioningController(
        st.kube, st.cp, st.cluster, st.termination, clock=st.clock,
        recorder=st.recorder, provisioning=st.provisioning,
        journal=st.journal, device=device)
    st.lifecycle = MachineLifecycleController(st.kube, st.cp, st.cluster,
                                              clock=st.clock)

    st.cluster.pdbs = st.kube.pdbs()
    st.kube.create("nodetemplates", "default", NodeTemplate(
        name="default",
        subnet_selector={"id": "subnet-zone-1a,subnet-zone-1b,subnet-zone-1c"},
        security_group_selector={"id": "sg-default"}))
    st.kube.create("provisioners", prov.name, prov)
    return st


def close_stack(st):
    st.provisioning.stop()
    for b in (st.cp.instances.fleet, st.cp.instances.describe,
              st.cp.instances.terminate):
        b.stop()


def span_ms(spans, name):
    return sum(sp.duration_s for sp in spans if sp.name == name) * 1000


def provision_outcome(st):
    """(launched machines as sorted (type, zone, capacity type, pods)
    rows, bound pod names, pods reported unschedulable)."""
    by_node = {}
    for p in st.kube.pods():
        if p.node_name:
            by_node.setdefault(p.node_name, []).append(p.name)
    machines = sorted(
        (m.status.instance_type, m.status.zone, m.status.capacity_type,
         tuple(sorted(by_node.get(m.status.node_name, ()))))
        for m in st.kube.machines())
    bound = sorted(p.name for p in st.kube.pods() if p.node_name)
    unsched = sorted(e.object_ref for e in
                     st.recorder.by_reason("FailedScheduling"))
    return machines, bound, unsched


def run_ctrl_provision(catalog, pods_fn, LAUNCHES, KERNEL, K1,
                       timed=TIMED_SOLVES):
    """ctrl_provision: path A through ProvisioningController.reconcile_once
    on the card, checked against the same scenario on device="cpu", then
    `timed` more fresh scenarios (the cluster emptied through the
    termination controller in between, the controller and its solver warm)
    for the reconcile's wall and its mask/solve/bind split. Every plane is
    at its default (on); each reconcile files one provisioning record."""
    from karpenter_tpu_torch import explain
    from karpenter_tpu_torch.tracing import TRACER

    cpu = controller_stack(catalog, "cpu", provisioner(provider_ref="default"))
    for p in pods_fn():
        cpu.kube.create("pods", p.name, p)
    cpu.provisioning.reconcile_once()
    for _ in range(3):
        cpu.lifecycle.reconcile_once()
    want = provision_outcome(cpu)
    close_stack(cpu)

    st = controller_stack(catalog, None, provisioner(provider_ref="default"))
    check(st.provisioning.device.type == "cuda"
          and st.deprovisioning.device.type == "cuda",
          "ctrl_provision: the controllers must default to cuda")
    rows = []
    for i in range(1 + timed):
        pods = pods_fn()
        for p in pods:
            st.kube.create("pods", p.name, p)
        LAUNCHES.reset()
        TRACER.clear()
        recs0 = len(explain.DECISIONS.records(kind="provisioning"))
        t0 = time.perf_counter()
        res = st.provisioning.reconcile_once()
        wall = (time.perf_counter() - t0) * 1000
        launches = LAUNCHES.get(KERNEL)
        spans = TRACER.finished_spans()
        (solver,) = st.provisioning._solver_cache.values()
        info = dict(solver.last_solve_info)
        recs = explain.DECISIONS.records(kind="provisioning")[recs0:]
        check(len(recs) == 1 and recs[0]["nodes"] == len(res.nodes)
              and recs[0]["unschedulable_pods"] == res.unschedulable_count()
              and recs[0]["routing"] == "cuda",
              f"ctrl_provision: {len(recs)} provisioning records for one "
              f"reconcile, or a record that differs from its solve")
        check(st.provisioning.last_solver_kind == "cuda"
              and st.provisioning.solve_ladder.rung() == 0,
              f"ctrl_provision: served by {st.provisioning.last_solver_kind},"
              f" ladder at rung {st.provisioning.solve_ladder.rung()}")
        check(launches == 2 * info["steps"] > 0,
              f"ctrl_provision: {launches} open-claim launches over "
              f"{info['steps']} pack steps (two a step)")
        check(LAUNCHES.get(K1) == 0,
              "ctrl_provision: the reconcile launched the standalone K1")
        creates = [sp.duration_s * 1000 for sp in spans
                   if sp.name == "provisioning.create"]
        probe = {}
        if i:
            # the controller's solver encodes the reconcile's own pod objects
            # a second time, then fresh objects of the same mix: which of
            # the two the reconcile's encode matches says whether new pod
            # objects explain its cost over path A's
            solver.solve(pods)
            probe["same_pods_encode_ms"] = solver.last_solve_info["encode_ms"]
            solver.solve(pods_fn())
            probe["fresh_pods_encode_ms"] = solver.last_solve_info["encode_ms"]
        rows.append({
            "wall_ms": wall,
            "cycle_ms": span_ms(spans, "provisioning.cycle"),
            "mask_ms": span_ms(spans, "provisioning.mask"),
            "solve_ms": span_ms(spans, "provisioning.solve"),
            "bind_ms": span_ms(spans, "provisioning.bind"),
            "create_max_ms": max(creates, default=0.0),
            "create_sum_ms": sum(creates),
            "bind_pods_sum_ms": span_ms(spans, "provisioning.bind.pods"),
            **{k: info[k] for k in ("encode_ms", "dispatch_ms",
                                    "transfer_ms", "decode_ms")},
            "launches": launches, "steps": info["steps"],
            "nodes": len(res.nodes), "creates": len(creates), **probe,
        })
        if i == 0:
            for _ in range(3):
                st.lifecycle.reconcile_once()
            got = provision_outcome(st)
            check(got[0] == want[0], "ctrl_provision: launched machines "
                                     "differ from the device='cpu' run")
            check(got[1] == want[1] and got[2] == want[2],
                  "ctrl_provision: bound or unschedulable pods differ from "
                  "the device='cpu' run")
            check(len(got[1]) + len(got[2]) == len(pods),
                  "ctrl_provision: a pod was neither bound nor reported")
            check(all(n.initialized for n in st.cluster.nodes.values()),
                  "ctrl_provision: a launched node did not initialize")
            first = (got, rows[0])
        # the next scenario starts from an empty cluster, later than the
        # event recorder's dedupe window (with every entry inside it, the
        # recorder rescans its whole index on each event past 40k)
        for name in sorted(st.cluster.nodes):
            st.termination.request_deletion(name)
        st.termination.reconcile_once()
        check(not st.cluster.nodes and not st.kube.pods(),
              "ctrl_provision: termination left nodes or pods behind")
        st.clock.step(300)
    close_stack(st)
    timed_rows = rows[1:]
    med = {k: statistics.median(r[k] for r in timed_rows)
           for k in timed_rows[0] if k.endswith("_ms")}
    got, row0 = first
    phase("ctrl_provision", pods=len(got[1]) + len(got[2]),
          machines=len(got[0]), bound=len(got[1]),
          unschedulable=len(got[2]), solver_kind="cuda", ladder_rung=0,
          planes="on", records_per_reconcile=1,
          steps=row0["steps"], open_claim_launches_per_reconcile=row0[
              "launches"], creates=row0["creates"], equal_cpu=True,
          scenarios=len(timed_rows),
          **{f"median_{k}": f"{v:.3f}" for k, v in med.items()})
    return row0, med


def seed_config3(st, n_nodes):
    """BASELINE config 3 as initialized machines: `n_nodes` m5.2xlarge
    on-demand machines in zone-1a launched through the provisioning
    controller's own launch path (as a consolidation replacement is),
    initialized by the lifecycle controller, then one 500m/1Gi pod bound to
    each."""
    from karpenter_tpu_torch.models.pod import make_pod
    from karpenter_tpu_torch.oracle.scheduler import Option
    from karpenter_tpu_torch.solver.core import SolvedNode, SolveResult

    catalog = st.cp.catalog_for(None)
    big = catalog.by_name["m5.2xlarge"]
    (off,) = [o for o in big.offerings
              if o.zone == "zone-1a" and o.capacity_type == "on-demand"]
    prov = st.kube.get("provisioners", "default")
    solved = SolvedNode(option=Option(
        index=-1, itype=big, zone="zone-1a", capacity_type="on-demand",
        price=off.price, alloc=tuple(big.allocatable_vector())),
        pod_counts={}, provisioner=prov)
    empty = SolveResult(nodes=[], existing_counts={}, unschedulable={},
                        groups=[])
    futures = [st.provisioning._pool.submit(st.provisioning._launch_node,
                                            solved, {}, empty)
               for _ in range(n_nodes)]
    check(all(f.result() is not None for f in futures),
          "ctrl_consolidate: a config-3 machine failed to launch")
    for _ in range(3):
        st.lifecycle.reconcile_once()
    names = sorted(st.cluster.nodes)
    check(len(names) == n_nodes
          and all(st.cluster.nodes[n].initialized for n in names),
          "ctrl_consolidate: config-3 machines did not initialize")
    for i, name in enumerate(names):
        p = make_pod(f"p-{i}", cpu="500m", memory="1Gi")
        st.kube.create("pods", p.name, p)
        st.kube.bind_pod(p.name, name)
        st.cluster.nodes[name].pods.append(st.kube.get("pods", p.name))
    check(all(len(st.cluster.nodes[n].pods) == 1 for n in names),
          "ctrl_consolidate: a config-3 node does not hold its pod")


def sweep_past_free_memory(torch, LAUNCHES, KERNEL, consolidate, st, cat,
                           provs, now, need):
    """The card's sweep_consolidation with all but 1.5 times the one-shot
    estimate `need` of the card's free memory held by a filler tensor, so
    that the estimate exceeds half of what is free: the sweep must stream,
    in stream_lanes() chunks of one pack step and two fill launches each.
    Returns (action, wall ms, the sweep's timings)."""
    dev = torch.device("cuda")
    torch.cuda.empty_cache()
    free = consolidate.device_free_bytes(dev)
    check(free > 3 * need, f"ctrl_consolidate: {free} bytes free on the "
                           f"card for a one-shot estimate of {need}")
    filler = torch.empty(free - 3 * need // 2, dtype=torch.uint8, device=dev)
    try:
        LAUNCHES.reset()
        t0 = time.perf_counter()
        action = consolidate.sweep_consolidation(st.cluster, cat, provs,
                                                 now=now)
        ms = (time.perf_counter() - t0) * 1000
        launches = LAUNCHES.get(KERNEL)
    finally:
        del filler
        torch.cuda.empty_cache()
    timings = dict(consolidate.last_timings)
    check(timings.get("chunks") == -(-timings["lanes"]
                                     // timings["stream_width"]) > 1
          and timings["one_shot_bytes"] == need
          and need > timings["free_bytes"] / 2,
          f"ctrl_consolidate: the sweep did not stream past the card's free "
          f"memory: {timings}")
    check(launches == 2 * timings["steps"] == 2 * timings["chunks"],
          f"ctrl_consolidate: {launches} open-claim launches over "
          f"{timings['steps']} pack steps in {timings['chunks']} chunks "
          f"(want one step, two launches, a chunk)")
    return action, ms, timings


def consolidate_scenario(torch, catalog, LAUNCHES, KERNEL, K1, consolidate,
                         n_nodes):
    """One fresh config-3 cluster of `n_nodes` nodes: the device="cpu"
    sweeps; the card's sweep past its free memory (sweep_past_free_memory),
    which streams; the card's sweep with its memory free, which packs every
    lane at once; then one DeprovisioningController pass on the card with
    every plane at its default, where the one-shot pack fits; then the
    termination controller, with every check of ctrl_consolidate. Returns
    the pass's numbers."""
    from karpenter_tpu_torch import explain
    from karpenter_tpu_torch.apis.provisioner import Provisioner
    from karpenter_tpu_torch.tracing import TRACER

    prov = Provisioner(name="default", consolidation_enabled=True,
                       provider_ref="default")
    prov.set_defaults()
    # 500 launches and registrations are set-up, not measured: the cloud
    # batchers flush at once
    st = controller_stack(catalog, None, prov, zero_windows=True)
    seed_config3(st, n_nodes)
    cat = st.cp.catalog_for(None)
    provs = st.cp.constrain_to_template_zones(
        sorted(st.kube.provisioners(), key=lambda p: (-p.weight, p.name)),
        cat)
    now = st.clock.now()
    cpu_stream = consolidate.stream_consolidation(st.cluster, cat, provs,
                                                  now=now, device="cpu")
    want = consolidate.sweep_consolidation(st.cluster, cat, provs, now=now,
                                           device="cpu")
    check(want is not None, "ctrl_consolidate: the CPU sweep found no action")
    need = consolidate.last_timings["one_shot_bytes"]
    check("chunks" not in consolidate.last_timings,
          "ctrl_consolidate: the CPU sweep streamed")
    cpu_verdicts = list(consolidate.last_verdicts)
    streamed, streamed_ms, stream_t = sweep_past_free_memory(
        torch, LAUNCHES, KERNEL, consolidate, st, cat, provs, now, need)
    # the filler's release emptied the allocator's cache: the card's
    # one-shot sweep on the same state refills it, as the pass before it
    # would have in a deployment, so the pass below is timed warm
    t0 = time.perf_counter()
    oneshot = consolidate.sweep_consolidation(st.cluster, cat, provs, now=now)
    oneshot_ms = (time.perf_counter() - t0) * 1000
    check("chunks" not in consolidate.last_timings,
          "ctrl_consolidate: the card's sweep streamed with the card free")
    for got, what in ((cpu_stream, "the CPU streamed sweep"),
                      (streamed, "the card's streamed sweep"),
                      (oneshot, "the card's one-shot sweep")):
        check(action_key(got) == action_key(want),
              f"ctrl_consolidate: {what} found {got}, the CPU one-shot "
              f"sweep {want}")
    provider_ids = {n: st.cluster.nodes[n].provider_id for n in want.nodes}
    recs0 = len(explain.DECISIONS.records(kind="consolidation"))
    LAUNCHES.reset()
    TRACER.clear()
    t0 = time.perf_counter()
    action = st.deprovisioning.reconcile_once()
    wall = (time.perf_counter() - t0) * 1000
    launches = LAUNCHES.get(KERNEL)
    spans = TRACER.finished_spans()
    timings = dict(consolidate.last_timings)
    (cons,) = [sp for sp in spans if sp.name == "deprovisioning.consolidation"]
    check(cons.attributes.get("routing") == "cuda"
          and st.deprovisioning.consolidate_ladder.rung() == 0,
          f"ctrl_consolidate: served by {cons.attributes.get('routing')}")
    check(cons.attributes.get("streamed") is None and "chunks" not in timings
          and timings["lanes"] == len(cpu_verdicts)
          and timings["one_shot_bytes"] == need
          and need <= timings["free_bytes"] / 2,
          f"ctrl_consolidate: the pass did not pack its {len(cpu_verdicts)} "
          f"lanes at once: {timings}")
    check(launches == 2 * timings["steps"] > 0,
          f"ctrl_consolidate: {launches} open-claim launches over "
          f"{timings['steps']} pack steps")
    check(LAUNCHES.get(K1) == 0,
          "ctrl_consolidate: the pass launched the standalone K1")
    check(action_key(action) == action_key(want),
          f"ctrl_consolidate: action {action} differs from the "
          f"device='cpu' sweep's {want}")
    recs = explain.DECISIONS.records(kind="consolidation")[recs0:]
    check(len(recs) == 1 and recs[0]["routing"] == "cuda"
          and recs[0]["action"]["nodes"] == list(action.nodes),
          "ctrl_consolidate: the pass filed no consolidation record of its "
          "action")
    # with the incremental plane on, the record keeps the lanes of the last
    # stream_lanes() chunk, as the JAX rung's streamed sweep does
    width = consolidate.stream_lanes()
    last_chunk = cpu_verdicts[(len(cpu_verdicts) - 1) // width * width:]
    check(recs[0]["verdicts"] == last_chunk and last_chunk,
          "ctrl_consolidate: the record's verdicts differ from the last "
          "chunk of the device='cpu' sweep's")
    (ev,) = [e for e in st.recorder.by_reason("Consolidated")
             if e.object_ref == f"node/{action.node}"]
    check(ev.message.endswith(f" (decision {recs[0]['id']})"),
          f"ctrl_consolidate: the Consolidated event cites no record: "
          f"{ev.message!r}")
    for n in action.nodes:
        check(st.kube.get("nodes", n).marked_for_deletion,
              f"ctrl_consolidate: {n} was not cordoned")
    t1 = time.perf_counter()
    done = st.termination.reconcile_once()
    term_ms = (time.perf_counter() - t1) * 1000
    check(sorted(done) == sorted(action.nodes),
          f"ctrl_consolidate: terminated {done}, want {action.nodes}")
    for n in action.nodes:
        iid = provider_ids[n].rsplit("/", 1)[-1]
        check(n not in st.cluster.nodes and st.kube.get("nodes", n) is None,
              f"ctrl_consolidate: {n} is still in the cluster or the store")
        check(st.cloud.instances[iid].state == "terminated",
              f"ctrl_consolidate: {n}'s instance was not terminated")
    drained = [p.name for p in st.kube.pods() if p.node_name in action.nodes]
    check(not drained, f"ctrl_consolidate: pods left on {action.nodes}")
    close_stack(st)
    cycle_ms = span_ms(spans, "deprovisioning.cycle")
    cons_ms = span_ms(spans, "deprovisioning.consolidation")
    return {"pass_wall_ms": wall, "cycle_ms": cycle_ms,
            "consolidation_ms": cons_ms, "termination_ms": term_ms,
            "streamed_sweep_ms": streamed_ms, "oneshot_sweep_ms": oneshot_ms,
            **{f"sweep_{k}": timings[k]
               for k in ("encode_ms", "verdicts_ms", "decode_ms")},
            "lanes": timings["lanes"], "steps": timings["steps"],
            "launches": launches, "one_shot_bytes": need,
            "free_bytes": timings["free_bytes"],
            "stream_free_bytes": stream_t["free_bytes"],
            "stream_chunks": stream_t["chunks"],
            "verdicts": len(cpu_verdicts), "action": action}


def run_ctrl_consolidate(torch, LAUNCHES, KERNEL, K1, consolidate,
                         n_nodes=500, timed=TIMED_SOLVES):
    """ctrl_consolidate: config 3's nodes through one DeprovisioningController
    pass on the card, then the termination controller, on 1 + `timed` fresh
    clusters over one catalog. With every plane at its default the pass
    packs every candidate lane at once, since that fits in the card's free
    memory; the card's sweep streams when a filler tensor leaves too little
    free. Both actions must equal sweep_consolidation(device="cpu")'s and
    the device="cpu" streamed sweep's on the same state, the record's
    verdicts the device="cpu" sweep's, and the pass's nodes are cordoned,
    drained and deleted from cloud, store and cluster; the first pass is
    the warm-up, the phase reports the medians of the others."""
    from karpenter_tpu_torch.providers.instancetypes import generate_fleet_catalog

    catalog = generate_fleet_catalog()
    rows = [consolidate_scenario(torch, catalog, LAUNCHES, KERNEL, K1,
                                 consolidate, n_nodes)
            for _ in range(1 + timed)]
    first, timed_rows = rows[0], rows[1:]
    med = {k: statistics.median(r[k] for r in timed_rows)
           for k in timed_rows[0] if k.endswith("_ms")}
    action = first["action"]
    phase("ctrl_consolidate", nodes=n_nodes, lanes=first["lanes"],
          steps=first["steps"],
          open_claim_launches_per_pass=first["launches"],
          action=action.kind, action_nodes=len(action.nodes),
          savings_per_hour=f"{action.savings:.4f}", routing="cuda",
          planes="on", streamed=False,
          one_shot_bytes=first["one_shot_bytes"],
          free_bytes=first["free_bytes"],
          stream_free_bytes=first["stream_free_bytes"],
          stream_chunks=first["stream_chunks"], equal_cpu=True,
          equal_streamed=True, record_verdicts_equal_cpu=first["verdicts"],
          cordoned_drained_deleted=True, scenarios=len(timed_rows),
          warmup_pass_wall_ms=f"{first['pass_wall_ms']:.3f}",
          **{f"median_{k}": f"{v:.3f}" for k, v in med.items()},
          median_consolidation_share=f"{med['consolidation_ms'] / med['cycle_ms']:.4f}")
    return first["launches"], med


# -- the incremental plane's steady state ---------------------------------------

FLEET_NODES = 10_000
FLEET_CYCLES = 12
CHURN_EVENTS = 200
PENDING_PER_CYCLE = 200


def soak_templates():
    """The 8 bound-pod templates of bench.py --soak (bench.py:658-661):
    250m-1000m CPU, 512Mi-2Gi."""
    from karpenter_tpu_torch.models.pod import make_pod

    return [make_pod(f"tmpl-{i}", cpu=f"{250 * (1 + i % 4)}m",
                     memory=f"{512 * (1 + i % 4)}Mi", owner_kind="ReplicaSet")
            for i in range(8)]


def fleet_node(catalog, name, k, rng, templates, now):
    """One fleet node as bench.py --soak builds it (bench.py:663-681), of the
    catalog's 16-vCPU / 64-GiB m5.4xlarge: allocatable 16 vCPU / 64 GiB /
    110 pods, initialized, owned by path A's provisioner ("default"), zone
    round-robin over zone-1a..1c by `k`, spot on every fourth, 10 bound pods
    drawn from the soak's templates."""
    import dataclasses

    from karpenter_tpu_torch.apis import wellknown as wk
    from karpenter_tpu_torch.models.cluster import StateNode

    t = catalog.by_name["m5.4xlarge"]
    zone = ("zone-1a", "zone-1b", "zone-1c")[k % 3]
    cap = "spot" if k % 4 == 0 else "on-demand"
    (price,) = [o.price for o in t.offerings
                if o.zone == zone and o.capacity_type == cap]
    pods = [dataclasses.replace(templates[rng.randrange(len(templates))],
                                name=f"{name}-p{j}", node_name=name)
            for j in range(10)]
    return StateNode(
        name=name,
        labels={**t.labels_dict(), wk.LABEL_ZONE: zone,
                wk.LABEL_CAPACITY_TYPE: cap,
                wk.LABEL_PROVISIONER: "default",
                "team": f"t{rng.randrange(12)}"},
        allocatable=wk.capacity_vector({wk.RESOURCE_CPU: 16_000,
                                        wk.RESOURCE_MEMORY: 64 * 2**30,
                                        wk.RESOURCE_PODS: 110}),
        provisioner_name="default", instance_type=t.name, zone=zone,
        capacity_type=cap, price=price, created_ts=now, initialized=True,
        pods=pods)


def seed_fleet(st, catalog, n_nodes, rng, templates):
    """`n_nodes` fleet nodes straight into the stack's ClusterState and its
    store (bench.py:683-690 seeds the soak's cluster the same way); returns
    the node names in creation order."""
    names = []
    now = st.clock.now()
    for k in range(n_nodes):
        name = f"fleet-{k:05d}"
        node = fleet_node(catalog, name, k, rng, templates, now)
        st.cluster.add_node(node)
        st.kube.create("nodes", name, node)
        names.append(name)
    return names


def fleet_churn(st, catalog, names, cycle, rng, templates, events):
    """One cycle of watch-stream deltas in bench.py --soak's mix
    (bench.py:744-766): 45% bind a template pod, 30% unbind one, 10% toggle
    the deletion mark, 10% relabel, 5% replace the node."""
    import dataclasses

    for j in range(events):
        op = rng.random()
        name = names[rng.randrange(len(names))]
        node = st.cluster.nodes[name]
        if op < 0.45:
            t = templates[rng.randrange(len(templates))]
            st.cluster.bind_pod(name, dataclasses.replace(
                t, name=f"churn-{cycle}-{j}", node_name=name))
        elif op < 0.75:
            if node.pods:
                node.pods.pop(rng.randrange(len(node.pods)))
        elif op < 0.85:
            node.marked_for_deletion = not node.marked_for_deletion
        elif op < 0.95:
            node.labels["team"] = f"t{rng.randrange(12)}"
        else:
            idx = names.index(name)
            st.cluster.delete_node(name)
            st.kube.delete("nodes", name)
            names[idx] = f"fleet-r{cycle}-{j}"
            fresh = fleet_node(catalog, names[idx], idx, rng, templates,
                               st.clock.now())
            st.cluster.add_node(fresh)
            st.kube.create("nodes", fresh.name, fresh)


def fleet_pending(cycle, rng):
    """`PENDING_PER_CYCLE` pods drawn, by their shares, from the seven
    deployments of path A's mix that carry no zone spread (all but "web",
    whose spread makes every cycle the entangled escape), and one pod of
    1,000 vCPU that fits no type. The batch is chosen to drive the
    incremental path; no public source gives its rate."""
    from karpenter_tpu_torch.apis import wellknown as wk
    from karpenter_tpu_torch.models.pod import make_pod

    deps = [d for d in _DEPLOYMENTS if not d[5]]
    picks = rng.choices(deps, weights=[d[1] for d in deps],
                        k=PENDING_PER_CYCLE)
    pods = []
    for j, (name, _, cpu, mem, zone, _) in enumerate(picks):
        sel = {wk.LABEL_ZONE: zone} if zone else {}
        pods.append(make_pod(f"c{cycle}-{name}-{j}", cpu=cpu, memory=mem,
                             node_selector=sel))
    pods.append(make_pod(f"huge-{cycle}", cpu="1000", memory="1Gi"))
    return pods


def record_key(rec):
    return {k: v for k, v in rec.items() if k not in ("trace_id", "ts")}


def fleet_run(label, catalog, device, incremental_on, LAUNCHES, KERNEL, K1,
              seed=20261016):
    """One run of ctrl_incremental: a fresh controller stack on `device`
    over a fresh fleet (the same seed every run), then FLEET_CYCLES reconciles,
    each after churn, a 1 s clock step and new pending pods. The incremental
    plane is switched to `incremental_on` for the run; the explain and
    profiling planes stay at their defaults (on). Returns one row per
    cycle."""
    import random

    from karpenter_tpu_torch import explain, incremental
    from karpenter_tpu_torch.profiling.gapledger import GAP_LEDGER
    from karpenter_tpu_torch.tracing import TRACER

    templates = soak_templates()
    st = controller_stack(catalog, device, provisioner(provider_ref="default"),
                          zero_windows=True)
    fleet_rng, churn_rng, pend_rng = (random.Random(seed + i)
                                      for i in range(3))
    t0 = time.perf_counter()
    names = seed_fleet(st, catalog, FLEET_NODES, fleet_rng, templates)
    seed_s = time.perf_counter() - t0
    # each run numbers its records from d-0, so two runs' records compare
    # whole, ids and citations included
    explain.DECISIONS.clear()
    explain.DECISIONS._next_id = 0
    prev = incremental.set_enabled(incremental_on)
    rows = []
    try:
        for cycle in range(FLEET_CYCLES):
            fleet_churn(st, catalog, names, cycle, churn_rng, templates,
                        CHURN_EVENTS)
            st.clock.step(1.0)
            if cycle:
                st.kube.delete("pods", f"huge-{cycle - 1}")
            pending = fleet_pending(cycle, pend_rng)
            for p in pending:
                st.kube.create("pods", p.name, p)
            LAUNCHES.reset()
            TRACER.clear()
            act0 = incremental.activity()
            gap0 = GAP_LEDGER.rows_total
            recs0 = len(explain.DECISIONS.records(kind="provisioning"))
            events0 = len(st.recorder.by_reason("FailedScheduling"))
            gc0 = gc.get_stats()[2]["collections"]
            t1 = time.perf_counter()
            st.provisioning.reconcile_once()
            wall = (time.perf_counter() - t1) * 1000
            gc2 = gc.get_stats()[2]["collections"] - gc0
            launches = LAUNCHES.get(KERNEL)
            check(LAUNCHES.get(K1) == 0, f"ctrl_incremental[{label}] cycle "
                                         f"{cycle}: the standalone K1 ran")
            spans = TRACER.finished_spans()
            act = incremental.activity()
            (solver,) = st.provisioning._solver_cache.values()
            info = dict(solver.last_solve_info)
            last = dict(st.provisioning._incremental.last or {}) \
                if incremental_on else {}
            recs = explain.DECISIONS.records(kind="provisioning")[recs0:]
            gap_rows = GAP_LEDGER.rows()[-(GAP_LEDGER.rows_total - gap0):] \
                if GAP_LEDGER.rows_total > gap0 else []
            events = st.recorder.by_reason("FailedScheduling")[events0:]
            mine = {p.name for p in pending}
            bound = {p.name: p.node_name for p in st.kube.pods()
                     if p.name in mine and p.node_name}
            check(st.provisioning.last_solver_kind == "cuda"
                  and st.provisioning.solve_ladder.rung() == 0,
                  f"ctrl_incremental[{label}] cycle {cycle}: served by "
                  f"{st.provisioning.last_solver_kind}")
            check(len(recs) == 1, f"ctrl_incremental[{label}] cycle {cycle}:"
                                  f" {len(recs)} provisioning records")
            rows.append({
                "cycle": cycle, "wall_ms": wall,
                "solve_ms": span_ms(spans, "provisioning.solve"),
                "solver_ms": sum(info[k] for k in (
                    "encode_ms", "dispatch_ms", "transfer_ms", "decode_ms")),
                **{k: info[k] for k in ("encode_ms", "dispatch_ms",
                                        "transfer_ms", "decode_ms")},
                "gc2": gc2,
                "extract_ms": span_ms(spans, "solver.extract"),
                "warm_start_ms": span_ms(spans, "solver.warm_start"),
                "bucket": info["bucket"], "steps": info["steps"],
                "launches": launches, "last": last,
                "divergences": act["audit_divergences"]
                - act0["audit_divergences"],
                "record": recs[0], "gap_rows": gap_rows,
                "events": [(e.object_ref, e.message) for e in events],
                "bound": bound,
                "unsched": sorted(set(mine) - set(bound)),
                "machines": provision_outcome(st)[0],
            })
    finally:
        incremental.set_enabled(prev)
        close_stack(st)
    return rows, seed_s


def run_ctrl_incremental(catalog, LAUNCHES, KERNEL, K1):
    """ctrl_incremental: the steady state of a large cluster through the
    provisioning controller with every plane on, on the card (a); the same
    with the incremental plane off, every cycle a full solve (b); and (a)
    on device="cpu" (c). Fails unless every cycle binds the same pods to the
    same nodes, leaves the same pods unschedulable and launches the same
    machines in all three; (a) starts with the cold-start escape and is
    incremental from its third cycle on without an audit divergence; every
    card cycle is served by the cuda rung with two fill launches a pack
    step; every cycle files one provisioning record whose entry for the
    1,000-vCPU pod names `resources` with parity, cited by its
    FailedScheduling event; the records of (a) and (c) are equal but for
    trace ids and timestamps; and every card solve's gap-ledger row names
    the cuda backend with an overlap ratio of exactly 0.0."""
    runs = {}
    seed_s = {}
    for label, dev, inc_on in (("a", None, True), ("b", None, False),
                               ("c", "cpu", True)):
        runs[label], seed_s[label] = fleet_run(
            label, catalog, dev, inc_on, LAUNCHES, KERNEL, K1)
    a, b, c = runs["a"], runs["b"], runs["c"]
    for cycle in range(FLEET_CYCLES):
        ra, rb, rc = a[cycle], b[cycle], c[cycle]
        for other, name in ((rb, "b"), (rc, "c")):
            check(ra["bound"] == other["bound"]
                  and ra["unsched"] == other["unsched"]
                  and ra["machines"] == other["machines"],
                  f"ctrl_incremental cycle {cycle}: (a) and ({name}) bind, "
                  f"leave unschedulable or launch differently")
        check(ra["unsched"] == [f"huge-{cycle}"],
              f"ctrl_incremental cycle {cycle}: unschedulable {ra['unsched']}")
        check(record_key(ra["record"]) == record_key(rc["record"]),
              f"ctrl_incremental cycle {cycle}: the records of (a) and (c) "
              f"differ")
        for row in (ra, rb):
            check(row["launches"] == 2 * row["steps"] > 0,
                  f"ctrl_incremental cycle {cycle}: {row['launches']} fill "
                  f"launches over {row['steps']} pack steps")
            check(row["gap_rows"] and all(
                g["roofline"]["backend"] == "cuda"
                and g["critical"]["overlap_ratio"] == 0.0
                for g in row["gap_rows"]),
                f"ctrl_incremental cycle {cycle}: a card gap-ledger row "
                f"without the cuda backend or with overlap")
        for row in (ra, rc):
            check(row["divergences"] == 0,
                  f"ctrl_incremental cycle {cycle}: an audit divergence")
            rec = row["record"]
            (entry,) = [u for u in rec["unassigned"]
                        if f"huge-{cycle}" in u["pods"]]
            check(entry["dimension"] == "resources" and entry["parity"]
                  is True, f"ctrl_incremental cycle {cycle}: the huge pod's "
                           f"attribution is {entry['dimension']}, parity "
                           f"{entry['parity']}")
            (ev,) = [m for ref, m in row["events"]
                     if ref == f"pod/huge-{cycle}"]
            check(ev.endswith(f" (decision {rec['id']})"),
                  f"ctrl_incremental cycle {cycle}: the FailedScheduling "
                  f"event cites no record: {ev!r}")
    check(a[0]["last"].get("escape") == "cold-start",
          f"ctrl_incremental: cycle 1 of (a) is {a[0]['last']}")
    check(all(r["last"]["mode"] == "incremental" for r in a[2:]),
          "ctrl_incremental: a cycle from the third on was not incremental: "
          + str([r["last"].get("escape") for r in a]))
    inc_rows = [r for r in a if r["last"]["mode"] == "incremental"]
    for ra, rb in zip(a, b):
        last = ra["last"]
        phase("ctrl_incremental_cycle", cycle=ra["cycle"] + 1,
              mode=last["mode"], escape=last.get("escape", "none"),
              dirty_nodes=last["dirty_nodes"],
              sub_nodes=last.get("sub_nodes", last["full_nodes"]),
              full_nodes=last["full_nodes"],
              resident_bytes=last.get("resident_bytes", 0),
              bucket_a=ra["bucket"], bucket_b=rb["bucket"],
              solve_ms_a=f"{ra['solve_ms']:.3f}",
              solve_ms_b=f"{rb['solve_ms']:.3f}",
              solver_ms_a=f"{ra['solver_ms']:.3f}",
              solver_ms_b=f"{rb['solver_ms']:.3f}",
              encode_ms_a=f"{ra['encode_ms']:.3f}",
              encode_ms_b=f"{rb['encode_ms']:.3f}",
              dispatch_ms_a=f"{ra['dispatch_ms']:.3f}",
              dispatch_ms_b=f"{rb['dispatch_ms']:.3f}",
              transfer_ms_b=f"{rb['transfer_ms']:.3f}",
              decode_ms_b=f"{rb['decode_ms']:.3f}",
              full_gc_a=ra["gc2"], full_gc_b=rb["gc2"],
              extract_ms=f"{ra['extract_ms']:.3f}",
              warm_start_ms=f"{ra['warm_start_ms']:.3f}",
              wall_ms_a=f"{ra['wall_ms']:.3f}",
              wall_ms_b=f"{rb['wall_ms']:.3f}",
              launches_a=ra["launches"], launches_b=rb["launches"],
              bound=len(ra["bound"]))
    med_a = statistics.median(r["solve_ms"] for r in inc_rows)
    med_b = statistics.median(rb["solve_ms"] for ra, rb in zip(a, b)
                              if ra["last"]["mode"] == "incremental")
    phase("ctrl_incremental", nodes=FLEET_NODES, cycles=FLEET_CYCLES,
          incremental_cycles=len(inc_rows),
          median_incremental_solve_ms_a=f"{med_a:.3f}",
          median_full_solve_ms_b=f"{med_b:.3f}",
          seed_fleet_s=f"{seed_s['a']:.2f}", equal_b=True, equal_cpu=True,
          records_equal_cpu=True, audit_divergences=0, routing="cuda")
    return {"a": a, "b": b, "median_a": med_a, "median_b": med_b,
            "launches": [r["launches"] for r in a]}


# -- the operator and the spot plane ------------------------------------------

OPERATOR_QUEUE = "smoke-interruptions"


def operator_stack(catalog, device, prov, **op_kw):
    """The port's Operator on `device` (None: the card) with every plane at
    its default: the store watch attached, the spot plane on at the static
    or ledger forecast, the incremental and explain planes on; `op_kw` goes
    to the Operator as well (a store, the serving plane). The clock is
    a FakeClock and the pod batch windows are 0, as in the JAX package's
    end-to-end tests; the cloud batchers keep their defaults, on the host's
    clock. The interruption queue is set, so the interruption controller is
    built and runs in every reconcile_all_once. One NodeTemplate over the
    three zones and `prov` are in the store. The operator's watch handler
    is wrapped here (not in the package) to sum the time it spends on pod
    events into `st.watch_s`."""
    import types

    from karpenter_tpu_torch.apis.nodetemplate import NodeTemplate
    from karpenter_tpu_torch.apis.settings import Settings
    from karpenter_tpu_torch.fake.cloud import FakeCloud
    from karpenter_tpu_torch.operator import Operator
    from karpenter_tpu_torch.utils.clock import FakeClock

    st = types.SimpleNamespace(watch_s=0.0, watch_events=0)
    st.clock = FakeClock()
    st.cloud = FakeCloud(catalog=catalog, clock=st.clock)
    st.settings = Settings(cluster_name="smoke",
                           cluster_endpoint="https://k.example",
                           batch_idle_duration=0.0, batch_max_duration=0.0,
                           interruption_queue_name=OPERATOR_QUEUE)
    st.op = op = Operator(st.cloud, st.settings, catalog, clock=st.clock,
                          device=device, **op_kw)
    st.kube, st.cluster, st.recorder = op.kube, op.cluster, op.recorder
    handler = op._on_watch_event

    def timed_handler(kind, action, obj):
        if kind != "pods":
            return handler(kind, action, obj)
        t0 = time.perf_counter()
        try:
            return handler(kind, action, obj)
        finally:
            st.watch_s += time.perf_counter() - t0
            st.watch_events += 1

    # KubeStore.unwatch compares by identity and every attribute read of a
    # bound method makes a new object, so the handler the operator
    # registered is swapped for the wrapper in place; stop() unwatches the
    # wrapper, which it reads from the same attribute. An HttpKubeStore
    # keeps its watchers on its informer cache, a KubeStore
    store = getattr(op.kube, "_cache", op.kube)
    store._watchers = [timed_handler if w == handler else w
                       for w in store._watchers]
    check(timed_handler in store._watchers,
          "operator_stack: the operator's watch handler is not registered")
    op._on_watch_event = timed_handler
    st.actions = []
    deprov = op.deprovisioning.reconcile_once

    def recorded_deprov():
        action = deprov()
        st.actions.append(action_key(action))
        return action

    op.deprovisioning.reconcile_once = recorded_deprov
    tmpl = NodeTemplate(
        name="default",
        subnet_selector={"id": "subnet-zone-1a,subnet-zone-1b,subnet-zone-1c"},
        security_group_selector={"id": "sg-default"})
    st.kube.create("nodetemplates", "default", tmpl)
    op.cloudprovider.register_nodetemplate(
        st.kube.get("nodetemplates", "default"))
    st.kube.create("provisioners", prov.name, prov)
    return st


def operator_outcome(st):
    """What a pass decided, without the uuid-suffixed names: the launched
    machines as sorted (type, zone, capacity type, pods) rows, the bound
    pod names, the pods left pending, the consolidation actions and the
    sorted reasons of the recorded events."""
    machines, bound, _ = provision_outcome(st)
    pending = sorted(p.name for p in st.kube.pending_pods())
    reasons = sorted(e.reason for _, e in st.recorder.recent())
    return {"machines": machines, "bound": bound, "pending": pending,
            "actions": list(st.actions), "reasons": reasons}


def operator_pass(st, LAUNCHES, KERNEL, K1, label, solves=True):
    """One reconcile_all_once on the card with the launch counts from 0,
    checked: both rungs cuda and, where the pass `solves` pending pods, the
    fill launched. Returns its row."""
    from karpenter_tpu_torch.tracing import TRACER

    LAUNCHES.reset()
    TRACER.clear()
    st.watch_s, st.watch_events = 0.0, 0
    t0 = time.perf_counter()
    st.op.reconcile_all_once()
    wall = (time.perf_counter() - t0) * 1000
    launches = LAUNCHES.get(KERNEL)
    spans = TRACER.finished_spans()
    prov = st.op.provisioning
    check(prov.last_solver_kind == "cuda" and prov.solve_ladder.rung() == 0,
          f"{label}: provisioning served by {prov.last_solver_kind}, ladder "
          f"at rung {prov.solve_ladder.rung()}")
    cons = [sp for sp in spans if sp.name == "deprovisioning.consolidation"]
    routing = [sp.attributes.get("routing") for sp in cons]
    check(routing and set(routing) == {"cuda"},
          f"{label}: the consolidation pass ran on {routing}, not cuda")
    check(launches > 0 or not solves,
          f"{label}: no open-claim launch in the pass")
    check(LAUNCHES.get(K1) == 0, f"{label}: the pass launched the "
                                 f"standalone K1")
    return {"wall_ms": wall,
            "cycle_ms": span_ms(spans, "provisioning.cycle"),
            "solve_ms": span_ms(spans, "provisioning.solve"),
            "bind_ms": span_ms(spans, "provisioning.bind"),
            "create_sum_ms": span_ms(spans, "provisioning.create"),
            "bind_pods_sum_ms": span_ms(spans, "provisioning.bind.pods"),
            "deprovisioning_ms": span_ms(spans, "deprovisioning.cycle"),
            "watch_pods_ms": st.watch_s * 1000,
            "watch_pod_events": st.watch_events,
            "launches": launches}


def interrupt_one(st, machines):
    """A spot interruption warning on the operator's queue for the node
    that holds the first pod of `machines`' first spot row (or first row):
    the same node on every device, whatever its uuid-suffixed name."""
    from karpenter_tpu_torch.models.machine import parse_provider_id

    spot = [m for m in machines if m[2] == "spot"] or machines
    pod = st.kube.get("pods", spot[0][3][0])
    node = st.cluster.nodes[pod.node_name]
    _, iid = parse_provider_id(node.provider_id)
    st.op.queue.send(json.dumps({
        "source": "cloud.spot",
        "detail-type": "Spot Instance Interruption Warning",
        "detail": {"instance-id": iid}}))
    return node.name, iid


def run_ctrl_operator(catalog, pods_fn, LAUNCHES, KERNEL, K1,
                      timed=TIMED_SOLVES):
    """ctrl_operator: path A through the port Operator's reconcile_all_once
    on the card, every plane at its default and the store watch attached;
    checked against one device="cpu" operator on the same inputs. One
    warm-up and `timed` passes, each on a fresh operator over one catalog.
    Then one spot interruption warning and two more passes, on the card
    and on the CPU."""
    prov = lambda: provisioner(provider_ref="default",  # noqa: E731
                               consolidation_enabled=True)

    def passes(device, card):
        st = operator_stack(catalog, device, prov())
        check(st.op.device.type == ("cuda" if card else "cpu"),
              f"ctrl_operator: the operator runs on {st.op.device}")
        for p in pods_fn():
            st.kube.create("pods", p.name, p)
        rows = []
        if card:
            rows.append(operator_pass(st, LAUNCHES, KERNEL, K1,
                                      "ctrl_operator"))
        else:
            st.op.reconcile_all_once()
        return st, rows

    cpu, _ = passes("cpu", False)
    want = operator_outcome(cpu)
    check(want["machines"] and want["bound"],
          "ctrl_operator: the device='cpu' operator launched nothing")
    rows = []
    for i in range(1 + timed):
        st, (row,) = passes(None, True)
        got = operator_outcome(st)
        for key in want:
            check(got[key] == want[key],
                  f"ctrl_operator: pass {i}: {key} differ from the "
                  f"device='cpu' operator's")
        rows.append(row)
        if i < timed:
            st.op.stop()
    # the interruption: the last card operator and the CPU one. Pass 1
    # cordons and drains the node (its pods are evicted, which deletes
    # them) and terminates it; the smoke then creates the evicted pods
    # again, as their workload controller would, and pass 2 places them
    before = collections.Counter(operator_outcome(st)["reasons"])
    machines = want["machines"]
    victims = [interrupt_one(s, machines) for s in (cpu, st)]
    inter_rows = []
    evicted = []
    for i in range(2):
        cpu.op.reconcile_all_once()
        # pass 1 has no pending pod to solve; pass 2 places the evicted
        inter_rows.append(operator_pass(st, LAUNCHES, KERNEL, K1,
                                        "ctrl_operator interruption",
                                        solves=bool(i)))
        if i:
            break
        for s, (name, iid) in zip((cpu, st), victims):
            check(name not in s.cluster.nodes
                  and s.op.cloudprovider.cloud.instances[iid].state
                  == "terminated",
                  "ctrl_operator: the interrupted node was not terminated")
            gone = set(want["bound"]) - {p.name for p in s.kube.pods()}
            check(gone, "ctrl_operator: the interrupted node's pods were "
                        "not evicted")
            evicted.append(sorted(gone))
            for p in pods_fn():
                if p.name in gone:
                    s.kube.create("pods", p.name, p)
    check(evicted[0] == evicted[1], "ctrl_operator: the interruption "
                                    "evicted other pods than on the CPU")
    after, after_cpu = operator_outcome(st), operator_outcome(cpu)
    for key in after_cpu:
        check(after[key] == after_cpu[key],
              f"ctrl_operator: after the interruption, {key} differ from "
              f"the device='cpu' operator's")
    check(not after["pending"] and set(evicted[1]) <= set(after["bound"]),
          "ctrl_operator: the evicted pods were not placed again")
    added = collections.Counter(after["reasons"]) - before
    cpu.op.stop()
    st.op.stop()
    timed_rows = rows[1:]
    med = {k: statistics.median(r[k] for r in timed_rows)
           for k in timed_rows[0] if k.endswith("_ms")}
    phase("ctrl_operator", pods=len(want["bound"]) + len(want["pending"]),
          machines=len(want["machines"]), bound=len(want["bound"]),
          pending=len(want["pending"]), solver_kind="cuda",
          consolidation_routing="cuda", planes="on", watch="attached",
          open_claim_launches_per_pass=rows[0]["launches"],
          watch_pod_events=rows[0]["watch_pod_events"], equal_cpu=True,
          passes=len(timed_rows),
          **{f"median_{k}": f"{v:.3f}" for k, v in med.items()})
    phase("ctrl_operator_interruption", evicted=len(evicted[1]),
          open_claim_launches=",".join(str(r["launches"])
                                       for r in inter_rows),
          wall_ms=",".join(f"{r['wall_ms']:.3f}" for r in inter_rows),
          machines=len(after["machines"]), equal_cpu=True,
          events_added=",".join(f"{r}:{n}" for r, n in sorted(added.items())))
    return rows[0], med, sum(r["launches"] for r in inter_rows), machines


def hot_spot_schedule(machines, rate):
    """The storm's live forecast: `rate` on the spot pools of the zone
    where path A's static-forecast solve put most spot machines, for every
    type it launched there (the cheapest spot capacity the solve found)."""
    zones = {}
    for itype, zone, ct, pods in machines:
        if ct == "spot":
            zones.setdefault(zone, set()).add(itype)
    check(zones, "ctrl_spot_storm: the static-forecast solve launched no "
                 "spot machine")
    zone = max(sorted(zones), key=lambda z: len(zones[z]))
    return {(t, zone, "spot"): rate for t in sorted(zones[zone])}


def storm_run(catalog, device, pods_fn, hot, LAUNCHES, KERNEL):
    """One provisioning reconcile of path A on a fresh operator whose
    forecaster reads `hot`; returns (outcome, row)."""
    from karpenter_tpu_torch import explain, spot
    from karpenter_tpu_torch.tracing import TRACER

    st = operator_stack(catalog, device, provisioner(provider_ref="default"))
    fc = st.op.spotforecaster
    fc.set_live_source(lambda: dict(hot))
    fc.refresh()
    check(st.op.spotobjective.active(),
          "ctrl_spot_storm: the hot forecast left the objective inactive")
    for p in pods_fn():
        st.kube.create("pods", p.name, p)
    prov = st.op.provisioning
    routed = prov._routed_solve
    solves = []

    def recorded(*args, option_mask=None, barred=None):
        # the kernel's launches in this one solve, and the pods it was given
        before = LAUNCHES.get(KERNEL)
        result, kind = routed(*args, option_mask=option_mask, barred=barred)
        solves.append((kind, option_mask is not None,
                       LAUNCHES.get(KERNEL) - before, len(args[2])))
        return result, kind

    prov._routed_solve = recorded
    act0 = spot.activity()
    recs0 = explain.DECISIONS.records(kind="spot-objective")
    LAUNCHES.reset()
    TRACER.clear()
    t0 = time.perf_counter()
    prov.reconcile_once()
    wall = (time.perf_counter() - t0) * 1000
    launches = LAUNCHES.get(KERNEL)
    spans = TRACER.finished_spans()
    act = spot.activity()
    deltas = {k: act[k] - act0[k] for k in act
              if k.startswith(("spot_objective_", "spot_pools_", "spot_bars_",
                               "spot_workloads_", "spot_spreads_",
                               "spot_assignments_"))}
    recs = [r for r in explain.DECISIONS.records(kind="spot-objective")
            if r not in recs0]
    check(len(recs) == 1, f"ctrl_spot_storm: {len(recs)} spot-objective "
                          f"records for one reconcile")
    solve_spans = [sp for sp in spans if sp.name == "provisioning.solve"]
    check(solve_spans and all(sp.attributes.get("spot_risk") is True
                              for sp in solve_spans),
          "ctrl_spot_storm: the solve span does not carry spot_risk")
    machines, bound, _ = provision_outcome(st)
    barred = {tuple(p) for p in recs[0]["barred_pools"]}
    check(not any((m[0], m[1], m[2]) in barred for m in machines),
          "ctrl_spot_storm: a machine landed on a barred pool")
    out = {"machines": machines, "bound": bound,
           "pending": sorted(p.name for p in st.kube.pending_pods()),
           "deltas": deltas,
           "accepted": recs[0]["accepted_concentrations"],
           "barred": recs[0]["barred_pools"],
           "spread": recs[0]["workloads_spread"]}
    row = {"wall_ms": wall, "solve_ms": span_ms(spans, "provisioning.solve"),
           "cycle_ms": span_ms(spans, "provisioning.cycle"),
           "launches": launches, "solves": solves}
    st.op.stop()
    return out, row


def run_ctrl_spot_storm(catalog, pods_fn, machines, LAUNCHES, KERNEL,
                        timed=TIMED_SOLVES):
    """ctrl_spot_storm: path A's provisioning reconcile on a fresh card
    operator whose forecaster reads a hot schedule, so the risk-aware
    objective drives the solve: the risk-adjusted solve, the spread
    re-solve and the bar phase's masked re-solves, each through the routed
    chain on the card. Checked against one device="cpu" operator."""
    from karpenter_tpu_torch.spot.forecaster import REBALANCE_RATE_THRESHOLD

    hot = hot_spot_schedule(machines, REBALANCE_RATE_THRESHOLD + 0.2)
    want, _ = storm_run(catalog, "cpu", pods_fn, hot, LAUNCHES, KERNEL)
    rows = []
    for i in range(1 + timed):
        got, row = storm_run(catalog, None, pods_fn, hot, LAUNCHES, KERNEL)
        for key in want:
            check(got[key] == want[key],
                  f"ctrl_spot_storm: run {i}: {key} differ from the "
                  f"device='cpu' run's: {got[key]!s:.200} vs "
                  f"{want[key]!s:.200}")
        kinds = {s[0] for s in row["solves"]}
        check(kinds == {"cuda"}, f"ctrl_spot_storm: run {i}: the objective's "
                                 f"solves ran on {sorted(kinds)}")
        check(any(s[1] for s in row["solves"]),
              f"ctrl_spot_storm: run {i}: no solve carried an option_mask")
        check(row["launches"] > 0,
              f"ctrl_spot_storm: run {i}: no open-claim launch")
        rows.append(row)
    timed_rows = rows[1:]
    med = {k: statistics.median(r[k] for r in timed_rows)
           for k in ("wall_ms", "solve_ms", "cycle_ms")}
    n_solves = len(rows[0]["solves"])
    phase("ctrl_spot_storm",
          hot_pools=";".join("/".join(p) for p in sorted(hot)),
          rate=f"{REBALANCE_RATE_THRESHOLD + 0.2:.2f}",
          routed_solves_per_reconcile=n_solves,
          masked_solves_per_reconcile=sum(s[1] for s in rows[0]["solves"]),
          open_claim_launches_per_reconcile=rows[0]["launches"],
          launches_per_solve=f"{rows[0]['launches'] / n_solves:.1f}",
          # each routed solve in order: masked or not, its open-claim
          # launches, the pods it was given
          per_solve=",".join(f"{'mask' if m else 'nomask'}:{n}:{pods}"
                             for _, m, n, pods in rows[0]["solves"]),
          barred_pools=len(want["barred"]),
          accepted_concentrations=len(want["accepted"]),
          workloads_spread=len(want["spread"]),
          machines=len(want["machines"]), bound=len(want["bound"]),
          pending=len(want["pending"]), equal_cpu=True,
          deltas=json.dumps(want["deltas"], sort_keys=True).replace(" ", ""),
          runs=len(timed_rows),
          **{f"median_{k}": f"{v:.3f}" for k, v in med.items()})
    return rows[0], med


# -- the served operator, the HTTP coordination plane and the CLI ---------------


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def http_call(url, body=None, timeout=60):
    """(status, body text, ms) of one request; an HTTP error is a status."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(url, data=body, method="POST" if body
                                 else "GET",
                                 headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            status, text = r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        status, text = e.code, e.read().decode()
    return status, text, (time.perf_counter() - t0) * 1000


def count_apiserver(srv, state):
    """Counts, from here, the mini apiserver's requests (each do_* call of
    its handler) and watch events (each notify, and the queue puts it fans
    out to the attached watch streams). Returns the Counter."""
    import threading

    counts = collections.Counter()
    lock = threading.Lock()
    base = srv.RequestHandlerClass

    def counted(name):
        fn = getattr(base, name)

        def wrapper(self):
            with lock:
                counts["requests"] += 1
            return fn(self)
        return wrapper

    srv.RequestHandlerClass = type("Counted", (base,), {
        name: counted(name) for name in ("do_GET", "do_POST", "do_PUT",
                                         "do_PATCH", "do_DELETE")
        if hasattr(base, name)})
    notify = state.notify

    def counted_notify(plural, type_, doc):
        with lock:
            counts["watch_events"] += 1
            counts["watch_deliveries"] += len(state.watchers.get(plural, []))
        return notify(plural, type_, doc)

    state.notify = counted_notify
    return counts


def served_records(base, before, names):
    """The DecisionRecords /debug/decisions lists that are not in `before`
    (ids), each fetched by id, without id, trace id and timestamp, and with
    every machine, node, provider and instance name in `names` written as
    its machine's outcome row."""
    status, text, _ = http_call(f"{base}/debug/decisions?limit=256")
    check(status == 200, f"/debug/decisions answered {status}")
    out = []
    for entry in json.loads(text)["decisions"]:
        if entry["id"] in before:
            continue
        status, text, _ = http_call(f"{base}/debug/decisions?id={entry['id']}")
        check(status == 200, f"/debug/decisions?id= answered {status}")
        for name in sorted(names, key=len, reverse=True):
            text = text.replace(name, names[name])
        rec = json.loads(text)
        out.append({k: v for k, v in rec.items()
                    if k not in ("id", "trace_id", "ts")})
    return out


def served_run(catalog, device, pods_fn, LAUNCHES, KERNEL, K1):
    """ctrl_served's run on `device`: the port's mini apiserver; through an
    HttpKubeStore the served Operator (every listener on a free port) and
    ctrl_operator's NodeTemplate, provisioner and path A's pods; one
    reconcile_all_once; the outcome read back through a second
    HttpKubeStore and the listeners, and the port CLI's statusz, explain
    and events against them. Returns (outcome, row)."""
    import contextlib
    import io
    import types

    from karpenter_tpu_torch.__main__ import cmd_events, cmd_explain, cmd_statusz
    from karpenter_tpu_torch.apis.nodetemplate import NodeTemplate
    from karpenter_tpu_torch.coordination import serde
    from karpenter_tpu_torch.coordination.httpkube import HttpKubeStore
    from karpenter_tpu_torch.fake.apiserver import serve

    label = f"ctrl_served ({'card' if device is None else device})"
    srv, port, state = serve()
    url = f"http://127.0.0.1:{port}"
    counts = count_apiserver(srv, state)
    kube = HttpKubeStore(server=url)
    kube.start()
    ports = {k: free_port() for k in ("metrics", "health", "webhook")}
    st = operator_stack(catalog, device,
                        provisioner(provider_ref="default",
                                    consolidation_enabled=True),
                        kube=kube, serve_http=True,
                        metrics_port=ports["metrics"],
                        health_port=ports["health"],
                        webhook_port=ports["webhook"])
    try:
        check(st.op.serving.start() == ports,
              f"{label}: the listeners bound other ports than asked")
        check(st.op.device.type == ("cpu" if device else "cuda"),
              f"{label}: the operator runs on {st.op.device}")
        metrics = f"http://127.0.0.1:{ports['metrics']}"
        health = f"http://127.0.0.1:{ports['health']}"
        t0 = time.perf_counter()
        for p in pods_fn():
            kube.create("pods", p.name, p)
        create_ms = (time.perf_counter() - t0) * 1000
        status, text, _ = http_call(f"{metrics}/debug/decisions?limit=256")
        before = {e["id"] for e in json.loads(text)["decisions"]}
        counts.clear()
        row = operator_pass(st, LAUNCHES, KERNEL, K1, label,
                            solves=device is None)
        row.update(create_ms=create_ms, requests=counts["requests"],
                   watch_events=counts["watch_events"],
                   watch_deliveries=counts["watch_deliveries"])
        # the outcome as a second client reads it over HTTP
        reader = HttpKubeStore(server=url)
        for kind in ("pods", "machines"):
            reader._relist(kind)
        out = operator_outcome(types.SimpleNamespace(
            kube=reader, recorder=st.recorder, actions=st.actions))
        # the names a record may cite differ between runs (uuid suffixes,
        # launch order): each stands for its machine's type, zone, capacity
        # type and first pod
        by_node = collections.defaultdict(list)
        for p in reader.pods():
            by_node[p.node_name].append(p.name)
        names = {}
        for m in reader.machines():
            pods = sorted(by_node.get(m.status.node_name, ()))
            token = "/".join((m.status.instance_type, m.status.zone,
                              m.status.capacity_type, pods[0] if pods else ""))
            for name in (m.name, m.status.node_name, m.status.provider_id,
                         m.status.provider_id.rsplit("/", 1)[-1]):
                if name:
                    names[name] = token
        out["records"] = served_records(metrics, before, names)
        check(out["records"], f"{label}: the pass filed no DecisionRecord")
        # the listeners
        ms = {}
        for name, path, base in (("readyz", "/readyz", health),
                                 ("metrics", "/metrics", metrics),
                                 ("statusz", "/debug/statusz", metrics),
                                 ("decisions", "/debug/decisions", metrics),
                                 ("eventz", "/eventz", health)):
            status, text, ms[name] = http_call(base + path)
            check(status == 200, f"{label}: {path} answered {status}")
            if name == "metrics":
                check("karpenter_scheduling_phase_duration_seconds" in text,
                      f"{label}: /metrics lacks the scheduling phase family")
            if name == "statusz":
                snap = json.loads(text)
                check(snap["tool"] == "karpenter_tpu.statusz"
                      and snap["cluster"] and snap["serving"]["bound"]
                      == ports, f"{label}: /debug/statusz: {text:.200}")
                # the fleet frontend's and the overload plane's sections
                check("frontends" in snap["fleet"]
                      and "enabled" in snap["overload"],
                      f"{label}: statusz's fleet/overload sections: "
                      f"{snap['fleet']} {snap['overload']}")
        for name, tags, allowed in (("validate", {}, True),
                                    ("validate_denied", {
                                        "kubernetes.io/cluster/smoke":
                                            "owned"}, False)):
            tmpl = NodeTemplate(name="default" if allowed else "restricted",
                                subnet_selector={"id": "subnet-zone-1a"},
                                security_group_selector={"id": "sg-default"},
                                tags=tags)
            review = {"apiVersion": "admission.k8s.io/v1",
                      "kind": "AdmissionReview",
                      "request": {"uid": name, "operation": "CREATE",
                                  "resource": {"resource": "nodetemplates"},
                                  "object": serde.to_manifest(
                                      "nodetemplates", tmpl.name, tmpl)}}
            status, text, ms[name] = http_call(
                f"http://127.0.0.1:{ports['webhook']}/validate",
                json.dumps(review).encode())
            resp = json.loads(text)["response"]
            check(status == 200 and resp["allowed"] is allowed
                  and resp["uid"] == name,
                  f"{label}: /validate {name}: {text:.200}")
            if not allowed:
                msg = resp["status"]["message"]
                check("kubernetes.io/cluster" in msg
                      and not msg.startswith("invalid"),
                      f"{label}: the restricted tag was denied for another "
                      f"reason: {msg:.200}")
        # the port CLI against the served listeners, explain for a pod the
        # provisioning record lists (a record names up to 8 pods a node)
        pod = next(r for r in out["records"]
                   if r["kind"] == "provisioning")["assignments"][0]["pods"][0]
        for name, fn, args, want in (
                ("cli_statusz", cmd_statusz, dict(endpoint=metrics), None),
                ("cli_explain", cmd_explain,
                 dict(endpoint=metrics, pod=pod, id=None, limit=20,
                      json=False), f"pod {pod}: ASSIGNED"),
                ("cli_events", cmd_events,
                 dict(endpoint=health, count=100, json=False), None)):
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                rc = fn(types.SimpleNamespace(**args))
            ms[name] = (time.perf_counter() - t0) * 1000
            check(rc == 0, f"{label}: the CLI's {name} returned {rc}")
            text = buf.getvalue()
            if name == "cli_statusz":
                check(json.loads(text)["tool"] == "karpenter_tpu.statusz",
                      f"{label}: the statusz CLI printed {text:.200}")
            else:
                check(text.strip() and (want is None or want in text),
                      f"{label}: the CLI's {name} printed {text:.200}")
        row["endpoint_ms"] = ms
        return out, row
    finally:
        st.op.stop()
        kube.stop()
        srv.shutdown()
        srv.server_close()


def first_row_difference(got, want) -> str:
    """Where two outcome lists first differ: the row's index and both rows,
    a machine row's pods given as the names only one side holds."""
    if not (isinstance(got, list) and isinstance(want, list)):
        return f"{got!s:.300} vs {want!s:.300}"
    for i, (g, w) in enumerate(zip(got, want)):
        if g == w:
            continue
        if isinstance(g, tuple) and len(g) == 4 and isinstance(g[3], tuple):
            return (f"row {i}: card {g[:3]} with {len(g[3])} pods, cpu "
                    f"{w[:3]} with {len(w[3])} pods; only on the card's "
                    f"{sorted(set(g[3]) - set(w[3]))[:10]}, only on the "
                    f"cpu's {sorted(set(w[3]) - set(g[3]))[:10]}")
        return f"row {i}: {g!s:.300} vs {w!s:.300}"
    return f"{len(got)} rows vs {len(want)}"


def run_ctrl_served(catalog, pods_fn, LAUNCHES, KERNEL, K1):
    """ctrl_served: path A through the served port Operator over the port's
    mini apiserver and HttpKubeStore, on the card, held to the same run
    with device="cpu" on its own apiserver."""
    want, cpu_row = served_run(catalog, "cpu", pods_fn, LAUNCHES, KERNEL, K1)
    got, row = served_run(catalog, None, pods_fn, LAUNCHES, KERNEL, K1)
    for key in want:
        check(got[key] == want[key],
              f"ctrl_served: {key} differ from the device='cpu' run's: "
              f"{first_row_difference(got[key], want[key])}")
    check(row["launches"] > 0, "ctrl_served: no open-claim launch")
    for run, r in (("card", row), ("cpu", cpu_row)):
        phase("ctrl_served", run=run, pods=len(want["bound"])
              + len(want["pending"]), machines=len(want["machines"]),
              bound=len(want["bound"]), pending=len(want["pending"]),
              records=len(want["records"]), equal_cpu=True,
              solver_kind="cuda", consolidation_routing="cuda",
              create_ms=f"{r['create_ms']:.3f}",
              pass_ms=f"{r['wall_ms']:.3f}",
              cycle_ms=f"{r['cycle_ms']:.3f}",
              solve_ms=f"{r['solve_ms']:.3f}",
              bind_ms=f"{r['bind_ms']:.3f}",
              watch_pods_ms=f"{r['watch_pods_ms']:.3f}",
              apiserver_requests=r["requests"],
              watch_events=r["watch_events"],
              watch_deliveries=r["watch_deliveries"],
              open_claim_launches=r["launches"],
              **{f"{k}_ms": f"{v:.3f}" for k, v in r["endpoint_ms"].items()})
    return row


def price_variant(catalog, scale):
    """The catalog with every offering's price times `scale` (new content,
    the same layout of capacities)."""
    import dataclasses

    from karpenter_tpu_torch.models.instancetype import Catalog

    return Catalog(types=[dataclasses.replace(t, offerings=type(t.offerings)(
        dataclasses.replace(o, price=round(o.price * scale, 6))
        for o in t.offerings)) for t in catalog.types])


def ice_variant(catalog):
    """The catalog with every spot offering in zone-1a unavailable (an
    insufficient-capacity event: availability only)."""
    import dataclasses

    from karpenter_tpu_torch.models.instancetype import Catalog

    return Catalog(types=[dataclasses.replace(t, offerings=type(t.offerings)(
        dataclasses.replace(o, available=o.available and not (
            o.capacity_type == "spot" and o.zone == "zone-1a"))
        for o in t.offerings)) for t in catalog.types])


def run_service(torch, catalog, prov, pods, LAUNCHES, KERNEL, K1,
                TorchSolver):
    """service: the solver service's core on the card at path A's size
    (see the module docstring, phase 20). -> fill launches by part."""
    import tempfile

    import numpy as np

    from karpenter_tpu_torch.oracle.consolidation import eligible
    from karpenter_tpu_torch.ops.consolidate import run_consolidation
    from karpenter_tpu_torch.solver import buckets, wire
    from karpenter_tpu_torch.solver.service import SolverService, hbm_key

    def key_of(cat, provs):
        return (wire.catalog_key(cat), wire.provisioners_key(provs))

    def uploads(tensor):
        return buckets.UPLOADS.value(tensor=tensor)

    def timed_sync(svc, key, cat, provs, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reply = svc.sync(key, cat, provs, **kw)
        torch.cuda.synchronize()
        return reply, (time.perf_counter() - t0) * 1000

    out = {}
    key = key_of(catalog, [prov])
    svc = SolverService()                        # device=None: the card
    check(svc.device.type == "cuda", "service: SolverService must default "
                                     "to cuda")
    gc.collect()
    torch.cuda.empty_cache()
    mem0 = torch.cuda.memory_allocated()
    cat0 = uploads("catalog")
    reply, cold_ms = timed_sync(svc, key, catalog, [prov])
    check(reply["catalog_hash"] == key[0] and reply["device_count"] == 1
          and reply["mesh"] == "", f"service: Sync answered {reply}")
    check(uploads("catalog") == cat0 + 2,
          f"service: the cold Sync made {uploads('catalog') - cat0} catalog "
          f"uploads, want 2 (alloc_t, tiebreak)")
    sync_mem = torch.cuda.memory_allocated() - mem0
    solver = svc._cache[key][0]
    tensor_bytes = solver._dev_alloc_t.nbytes + solver._dev_tiebreak.nbytes
    ledger = buckets.HBM.snapshot()["solvers"][hbm_key(key)]
    check(ledger["static_bytes"]["catalog"] == tensor_bytes,
          f"service: the ledger holds {ledger['static_bytes']} for the key, "
          f"the device tensors {tensor_bytes} bytes")
    _, warm_sync_ms = timed_sync(svc, key, catalog, [prov])

    # five Solves of path A through the core, held to the direct solve
    direct = TorchSolver(catalog, [prov])
    LAUNCHES.reset()
    solve_ms, direct_ms, per_solve = [], [], []
    for i in range(1 + TIMED_SOLVES):
        cat_before, delta_before = uploads("catalog"), uploads("delta")
        before = LAUNCHES.get(KERNEL)
        t0 = time.perf_counter()
        res, info = svc.solve(key, list(pods))
        wall = (time.perf_counter() - t0) * 1000
        rose = LAUNCHES.get(KERNEL) - before
        per_solve.append(rose)
        check(rose == 20, f"service: solve {i} launched the fill {rose} "
                          f"times, want 20")
        check(info["routing"] == "cuda" and info["device_count"] == 1,
              f"service: solve {i} answered {info}")
        check(uploads("delta") > delta_before,
              f"service: solve {i} uploaded no delta")
        if i:
            check(uploads("catalog") == cat_before,
                  f"service: solve {i} re-uploaded catalog tensors")
            solve_ms.append(wall)
        flat = solver.last_flat
        t0 = time.perf_counter()
        want = direct.solve(list(pods))
        if i:
            direct_ms.append((time.perf_counter() - t0) * 1000)
        check(np.array_equal(flat, direct.last_flat)
              and res.decisions() == want.decisions(),
              f"service: solve {i} differs from the direct card solve")
    out["solves"] = sum(per_solve)
    out["solve_launches"] = per_solve
    check(LAUNCHES.get(K1) == 0, "service: the standalone K1 was launched")
    cpu = SolverService(device="cpu")
    cpu.sync(key, catalog, [prov])
    cpu_res, _ = cpu.solve(key, list(pods))
    check(np.array_equal(cpu._cache[key][0].last_flat, flat)
          and cpu_res.decisions() == res.decisions(),
          "service: the card's flat buffer differs from device='cpu'")

    # warmup: the first Solve after a hinted Sync against one without
    first = {}
    for label, hints in (("cold", ()), ("warm", (10_000,))):
        fresh = SolverService()
        gc.collect()
        torch.cuda.empty_cache()
        reply, ms = timed_sync(fresh, key, catalog, [prov],
                               warm_pod_counts=hints)
        t0 = time.perf_counter()
        fres, finfo = fresh.solve(key, list(pods))
        first[label] = dict(sync_ms=ms, warmed=reply["warmed_buckets"],
                            solve_ms=(time.perf_counter() - t0) * 1000,
                            compile_cache=finfo["compile_cache"])
        check(fres.decisions() == res.decisions(),
              f"service: the {label} service's first solve differs")
        del fresh
    check(first["warm"]["warmed"] >= 1,
          f"service: warm_pod_counts=[10000] warmed {first['warm']}")

    # the LRU at LRU_CAPACITY, with the admission filter and pins
    del solver, direct
    keys = [key]
    variants = {}
    for n in range(1, 5):
        variants[n] = price_variant(catalog, 1 + n / 100)
        keys.append(key_of(variants[n], [prov]))
        svc.sync(keys[n], variants[n], [prov])
    check(keys[4] in svc._probation and key in svc._cache,
          "service: the fourth new catalog did not wait on probation")
    gc.collect()
    mem_before = torch.cuda.memory_allocated()
    svc.sync(keys[4], variants[4], [prov])     # seen again: earned
    gc.collect()
    mem_after = torch.cuda.memory_allocated()
    check(keys[4] in svc._cache and key not in svc._cache
          and list(svc._cache) == keys[1:5],
          f"service: eviction left {list(svc._cache)}")
    check(hbm_key(key) not in buckets.HBM.snapshot()["solvers"],
          "service: the evicted key's ledger row was not released")
    pinned = svc.checkout(keys[1])
    with svc._lock:  # checkout made it the most recent: back to the front
        svc._cache.move_to_end(keys[1], last=False)
    try:
        variants[5] = price_variant(catalog, 1.05)
        keys.append(key_of(variants[5], [prov]))
        svc.sync(keys[5], variants[5], [prov])
        svc.sync(keys[5], variants[5], [prov])
        check(pinned is not None and keys[1] in svc._cache
              and keys[2] not in svc._cache and keys[5] in svc._cache,
              f"service: the pinned entry did not survive: "
              f"{list(svc._cache)}")
    finally:
        svc.checkin(keys[1])
    donor = svc._cache[keys[5]][0]
    iced = ice_variant(variants[5])
    ice_key = key_of(iced, [prov])
    cat_before = uploads("catalog")
    svc.sync(ice_key, iced, [prov])
    ice_solver = (svc._cache.get(ice_key) or svc._probation[ice_key])[0]
    check(uploads("catalog") == cat_before,
          "service: the availability-only Sync uploaded catalog tensors")
    check(ice_solver._group_cache is not donor._group_cache
          and ice_solver._dev_alloc_t is donor._dev_alloc_t,
          "service: the availability-only Sync did not take the donor path")
    stats = svc.eviction_stats()

    # Consolidate of config 3 through the core
    cprov = consolidation_provisioner()
    ckey = key_of(catalog, [cprov])
    csvc = SolverService()
    csvc.sync(ckey, catalog, [cprov])
    cluster = config3_cluster(catalog)
    names = {n for n, node in cluster.nodes.items()
             if eligible(node, cluster)}
    LAUNCHES.reset()
    t0 = time.perf_counter()
    action, cons_ms = csvc.consolidate(
        ckey, list(config3_cluster(catalog).nodes.values()), names, now=0.0)
    cons_wall = (time.perf_counter() - t0) * 1000
    out["consolidate"] = LAUNCHES.get(KERNEL)
    check(out["consolidate"] == 2,
          f"service: Consolidate launched the fill {out['consolidate']} "
          f"times, want 2")
    want_card = run_consolidation(cluster, catalog, [cprov], now=0.0)
    want_cpu = run_consolidation(cluster, catalog, [cprov], now=0.0,
                                 device="cpu")
    check(action is not None and action_key(action) == action_key(want_card)
          == action_key(want_cpu),
          f"service: Consolidate gave {action}, in-process {want_card}")

    health = svc.health()
    check(health["backend"] == "cuda" and health["n_types"] == 603,
          f"service: Health answered {health}")
    out["wire"] = run_service_wire(catalog, prov, pods, res, cprov, names,
                                   action, LAUNCHES, KERNEL)

    with tempfile.TemporaryDirectory() as tmp:
        tsvc = SolverService(trace_dir=tmp, trace_every=1)
        tsvc.sync(key, catalog, [prov])
        tsvc.solve(key, list(pods))
        traces = [f for f in os.listdir(tmp) if "trace" in f]
        check(len(traces) == 1, f"service: trace files {traces}")
        with open(os.path.join(tmp, traces[0])) as f:
            events = json.load(f).get("traceEvents", [])
        fills = sum("open_claim" in str(e.get("name", "")) for e in events)
        check(fills >= 20, f"service: the trace holds {fills} open_claim "
                           f"events")
    phase("service", types=len(catalog.types), pods=len(pods),
          cold_sync_ms=f"{cold_ms:.3f}", warm_resync_ms=f"{warm_sync_ms:.3f}",
          sync_allocated_bytes=sync_mem, ledger_catalog_bytes=tensor_bytes,
          median_solve_ms=f"{statistics.median(solve_ms):.3f}",
          median_direct_solve_ms=f"{statistics.median(direct_ms):.3f}",
          open_claim_launches_per_solve=per_solve[-1],
          flat_bit_equal_direct_and_cpu=True,
          first_solve_cold_ms=f"{first['cold']['solve_ms']:.3f}",
          first_solve_warm_ms=f"{first['warm']['solve_ms']:.3f}",
          warmed_buckets=first["warm"]["warmed"],
          hinted_sync_ms=f"{first['warm']['sync_ms']:.3f}",
          unhinted_sync_ms=f"{first['cold']['sync_ms']:.3f}",
          first_solve_cache=f"{first['cold']['compile_cache']}/"
                            f"{first['warm']['compile_cache']}",
          evicted_allocated_before=mem_before,
          evicted_allocated_after=mem_after,
          pinned_survived=True, ice_donor_path=True,
          installs=stats["installs"], evictions=stats["evictions"],
          consolidate_action=action.kind, consolidate_ms=f"{cons_ms:.3f}",
          consolidate_wall_ms=f"{cons_wall:.3f}",
          consolidate_launches=out["consolidate"],
          health_backend=health["backend"], trace_open_claim_events=fills)
    return out


def run_service_wire(catalog, prov, pods, want, cprov, names, want_action,
                     LAUNCHES, KERNEL) -> dict:
    """service_wire: where grpcio is installed, the same service served
    over gRPC in this process (serve) and a RemoteSolver against it: one
    warm-up and 5 timed Solves of path A, each with 20 fill launches and
    the decisions of the core's solve, and a Consolidate of config 3 with
    the core's action; the wire's decode and encode spans (the service's
    solver.serialize) and the client's rpc span. Where grpcio is missing,
    nothing (the wire is then checked on the CPU only)."""
    import importlib.util

    if importlib.util.find_spec("grpc") is None:
        phase("service_wire", grpcio=False, checked="on the CPU only")
        return {"solves": 0, "consolidate": 0}
    from karpenter_tpu_torch.solver.client import RemoteSolver
    from karpenter_tpu_torch.solver.service import SolverService, serve
    from karpenter_tpu_torch.tracing import TRACER

    server, port, _ = serve("127.0.0.1:0", service=SolverService())
    out = {"solves": 0, "consolidate": 0}
    try:
        rs = RemoteSolver(catalog, [prov], target=f"127.0.0.1:{port}",
                          timeout=120.0)
        rs.sync()
        walls, spans = [], {"decode": [], "encode": [], "rpc": [],
                            "service": []}
        for i in range(1 + TIMED_SOLVES):
            TRACER.clear()
            before = LAUNCHES.get(KERNEL)
            t0 = time.perf_counter()
            got = rs.solve(list(pods))
            wall = (time.perf_counter() - t0) * 1000
            rose = LAUNCHES.get(KERNEL) - before
            out["solves"] += rose
            check(rose == 20, f"service_wire: solve {i} launched the fill "
                              f"{rose} times, want 20")
            check(got.decisions() == want.decisions(),
                  f"service_wire: solve {i} differs from the core's")
            if not i:
                continue
            walls.append(wall)
            for sp in TRACER.finished_spans():
                ms = (sp.duration_s or 0.0) * 1000
                if sp.name == "solver.serialize":
                    spans[sp.attributes.get("direction", "decode")].append(ms)
                elif sp.name == "solver.rpc.Solve":
                    spans["rpc"].append(ms)
                elif sp.name == "solver.service.Solve":
                    spans["service"].append(ms)
        cluster = config3_cluster(catalog)
        crs = RemoteSolver(catalog, [cprov], target=f"127.0.0.1:{port}",
                           timeout=120.0)
        before = LAUNCHES.get(KERNEL)
        t0 = time.perf_counter()
        action = crs.consolidate(cluster, names, now=0.0)
        cons_wall = (time.perf_counter() - t0) * 1000
        out["consolidate"] = LAUNCHES.get(KERNEL) - before
        check(action_key(action) == action_key(want_action),
              f"service_wire: Consolidate gave {action}, the core "
              f"{want_action}")
    finally:
        server.stop(grace=None)
    med = {k: statistics.median(v) for k, v in spans.items() if v}
    phase("service_wire", grpcio=True, pods=len(pods),
          median_solve_wall_ms=f"{statistics.median(walls):.3f}",
          **{f"median_{k}_ms": f"{v:.3f}" for k, v in med.items()},
          open_claim_launches_per_solve=20, decisions_equal_core=True,
          consolidate_wall_ms=f"{cons_wall:.3f}",
          consolidate_launches=out["consolidate"],
          consolidate_action=action.kind)
    return out


def run_cli_boot():
    """cli_boot: `python -m karpenter_tpu_torch controller --simulate` in
    its own process on the card: /readyz within 60 s, a boot line naming
    the cuda device, /debug/statusz, exit 0 within 30 s of SIGINT with the
    state file written; `solver-serve` exits 2 naming grpcio where it is
    missing, or serves and answers Health with cuda."""
    import signal
    import tempfile

    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        state, log = os.path.join(tmp, "account.json"), os.path.join(tmp,
                                                                     "out")
        metrics, health = free_port(), free_port()
        t0 = time.perf_counter()
        with open(log, "w") as out:
            proc = subprocess.Popen(
                [sys.executable, "-m", "karpenter_tpu_torch", "controller",
                 "--simulate", "--metrics-port", str(metrics),
                 "--health-port", str(health), "--webhook-port", "-1",
                 "--state", state], cwd=root, stdout=out,
                stderr=subprocess.STDOUT)
        try:
            ready_s = None
            while time.perf_counter() - t0 < 60 and proc.poll() is None:
                try:
                    status, _, _ = http_call(
                        f"http://127.0.0.1:{health}/readyz", timeout=5)
                except OSError:
                    status = 0
                if status == 200:
                    ready_s = time.perf_counter() - t0
                    break
                time.sleep(0.2)
            with open(log) as f:
                text = f.read()
            check(ready_s is not None,
                  f"cli_boot: no /readyz 200 within 60 s: {text[-2000:]}")
            status, body, statusz_ms = http_call(
                f"http://127.0.0.1:{metrics}/debug/statusz")
            check(status == 200 and json.loads(body)["tool"]
                  == "karpenter_tpu.statusz",
                  f"cli_boot: /debug/statusz answered {status}")
            boot = [ln for ln in text.splitlines()
                    if ln.startswith("controller running")]
            check(boot and "device=cuda" in boot[0],
                  f"cli_boot: the boot line names no cuda device: {boot}")
            proc.send_signal(signal.SIGINT)
            t1 = time.perf_counter()
            rc = proc.wait(timeout=30)
            stop_s = time.perf_counter() - t1
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        with open(log) as f:
            text = f.read()
        check(rc == 0, f"cli_boot: exit code {rc} after SIGINT: "
                       f"{text[-2000:]}")
        check(os.path.isfile(state), "cli_boot: no state file written")
    t2 = time.perf_counter()
    serve_row = run_solver_serve(root)
    phase("cli_boot", ready_s=f"{ready_s:.3f}", boot_line=repr(boot[0]),
          statusz_ms=f"{statusz_ms:.3f}", sigint_exit=rc,
          stop_s=f"{stop_s:.3f}", state_file=True, **serve_row,
          solver_serve_s=f"{time.perf_counter() - t2:.3f}")


def run_solver_serve(root) -> dict:
    """`solver-serve` on the card: where grpcio is missing it exits 2 with
    a message naming grpcio; where it is installed it serves, answers
    Health with cuda and stops with exit code 0 on SIGINT."""
    import importlib.util
    import signal

    if importlib.util.find_spec("grpc") is None:
        solver = subprocess.run([sys.executable, "-m", "karpenter_tpu_torch",
                                 "solver-serve"], cwd=root,
                                capture_output=True, text=True, timeout=120)
        check(solver.returncode == 2 and "grpcio" in solver.stderr,
              f"cli_boot: solver-serve gave {solver.returncode}: "
              f"{solver.stderr[-500:]}")
        return {"grpcio": False, "solver_serve_exit": solver.returncode}
    from karpenter_tpu_torch.solver import solver_pb2 as pb
    from karpenter_tpu_torch.solver.client import _shared_channel

    port = free_port()
    proc = subprocess.Popen([sys.executable, "-m", "karpenter_tpu_torch",
                             "solver-serve", "--port", str(port)], cwd=root,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    try:
        call = _shared_channel(f"127.0.0.1:{port}").unary_unary(
            "/karpenter.solver.Solver/Health",
            request_serializer=lambda msg: msg.SerializeToString(),
            response_deserializer=pb.HealthResponse.FromString)
        t0, health = time.perf_counter(), None
        while health is None and time.perf_counter() - t0 < 60:
            check(proc.poll() is None, f"cli_boot: solver-serve exited "
                                       f"{proc.returncode}")
            try:
                health = call(pb.HealthRequest(), timeout=5)
            except Exception:  # noqa: BLE001 — not serving yet
                time.sleep(0.2)
        check(health is not None and health.backend == "cuda",
              f"cli_boot: solver-serve's Health answered {health}")
        proc.send_signal(signal.SIGINT)
        rc = proc.wait(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    check(rc == 0, f"cli_boot: solver-serve exit code {rc}")
    return {"grpcio": True, "solver_serve_health": health.backend,
            "solver_serve_exit": rc}


def run_native_vs_card(catalog, prov, TorchSolver, NativeSolver,
                       sizes=(100, 1000, 10_000)):
    """native_vs_card: NativeSolver (the C++ host scan) and TorchSolver on
    the same problems of path A's mix. Their flat buffers are equal bit
    for bit once the card's is cut to the scan's unpadded shape
    (native.crop_flat, which also checks that the padding holds nothing);
    the medians of TIMED_SOLVES solves each, after a warm-up, are what a
    later routing change can record as the crossover. Routing is not
    changed here."""
    import numpy as np

    from karpenter_tpu_torch.native import crop_flat

    card, native = TorchSolver(catalog, [prov]), NativeSolver(catalog, [prov])
    out = {}
    for n in sizes:
        pods = mixed_workload(n)
        walls = {"card": [], "native": []}
        for i in range(1 + TIMED_SOLVES):
            for label, solver in (("card", card), ("native", native)):
                t0 = time.perf_counter()
                solver.solve(list(pods))
                if i:
                    walls[label].append((time.perf_counter() - t0) * 1000)
        flat = crop_flat(card.last_flat, card.last_solve_info["plan"],
                         native.last_solve_info["shape"])
        check(flat.dtype == native.last_flat.dtype == np.int32
              and np.array_equal(flat, native.last_flat),
              f"native_vs_card: flat buffers differ at {n} pods")
        med = {k: statistics.median(v) for k, v in walls.items()}
        out[n] = med
        phase("native_vs_card", pods=n, bucket=card.last_solve_info["bucket"],
              shape="x".join(map(str, native.last_solve_info["shape"])),
              flat_bit_equal=True, median_card_ms=f"{med['card']:.3f}",
              median_native_ms=f"{med['native']:.3f}",
              native_scan_ms=f"{native.last_solve_info['scan_ms']:.3f}")
    return out


def profile_run(torch, label, fn):
    """One call of `fn` under torch.profiler (after a warm-up call): the
    device's busy time (union of kernel intervals), its idle share of the
    profiled call's wall time, and the kernels that took the most device
    time. Profiling slows the host, so the wall time here is not the
    path's; the device numbers are."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    if not spans:
        phase(f"profile{label}", device_time="not measured",
              reason="the profiler recorded no device events")
        return None
    busy, end = 0.0, float("-inf")
    by_name: "dict[str, list]" = {}
    for s0, s1, name in spans:
        busy += max(0.0, s1 - max(s0, end))
        end = max(end, s1)
        agg = by_name.setdefault(name, [0, 0.0])
        agg[0] += 1
        agg[1] += s1 - s0
    k1 = [v for k, v in by_name.items() if "quotient_nt_kernel" in k]
    oc = [v for k, v in by_name.items()
          if "open_claim_qmax_kernel" in k or "open_claim_apply_kernel" in k]
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:5]
    out = {"wall_ms": wall_us / 1e3, "device_busy_ms": busy / 1e3,
           "idle_share": 1 - busy / wall_us, "kernels": len(spans),
           "open_claim_launches": sum(v[0] for v in oc),
           "open_claim_ms": sum(v[1] for v in oc) / 1e3,
           "k1_launches": sum(v[0] for v in k1)}
    phase(f"profile{label}", **{k: (f"{v:.4f}" if isinstance(v, float) else v)
                                for k, v in out.items()})
    for name, (n, us) in top:
        print(f"  device {us / 1e3:.4f} ms in {n} launches: {name[:90]}")
    return out


def profile_solve(torch, label, catalog, prov, pods, existing, TorchSolver):
    """One solve of a path under torch.profiler (profile_run)."""
    solver = TorchSolver(catalog, [prov])
    return profile_run(torch, label, lambda: solver.solve(
        list(pods), existing=copy_existing(existing)))



# -- the pack as a CUDA graph (phase 32) ---------------------------------------

PACK_GRAPH_SEEDS = (3100002001, 3100002002, 3100002003)
PACK_GRAPH_TIMED = 10
PACK_GRAPH_WAYS = ("first", "held", "capture", "replay")
FILL_KERNELS = ("open_claim_qmax_kernel", "open_claim_apply_kernel")


def pack_graph_ways() -> "dict[str, int]":
    """The process's single-problem packs on the card so far, by way."""
    from karpenter_tpu_torch.ops.pack_graph import PACKS

    return {w: int(PACKS.value(way=w)) for w in PACK_GRAPH_WAYS}


def report_pack_graph_ways(marks) -> None:
    """pack_graph_ways: each path's packs by way, from the counts taken
    after each path in turn ((path, pack_graph_ways()) pairs, the first
    the start)."""
    for (_, before), (path, after) in zip(marks, marks[1:]):
        ways = {w: after[w] - before[w] for w in PACK_GRAPH_WAYS}
        packs = sum(ways.values())
        if packs:
            phase("pack_graph_ways", path=path, packs=packs, **ways,
                  replay_share=f"{100.0 * ways['replay'] / packs:.1f}")


def run_pack_graph(torch, LAUNCHES, KERNEL) -> None:
    """pack_graph: the graph's run against the eager pack at the benchmark
    cells' shapes (see the module docstring, phase 32)."""
    import numpy as np

    from karpenter_tpu_torch.models.encode import encode_problem
    from karpenter_tpu_torch.ops.pack_graph import PackGraphs
    from karpenter_tpu_torch.ops.packer import n_eff_of
    from karpenter_tpu_torch.solver import core, wire
    from portbench.drive import System, build_catalog
    from portbench.generator import Traffic, load_json
    from portbench.trace import DeviceTrace, is_copy

    def pack(solver, pods):
        """(fields, plan, n_eff) of a Solve of `pods`, as _solve_once
        builds them."""
        enc = encode_problem(solver.catalog, solver.provisioners, pods, (),
                             grid=solver.grid(),
                             group_cache=solver._group_cache)
        fields, plan = core.build_pack_inputs(enc, solver._dev_alloc_t,
                                              solver._dev_tiebreak)
        return fields, plan, n_eff_of(fields["group_count"])

    def eager(fields, plan):
        torch.cuda.synchronize()
        before = LAUNCHES.get(KERNEL)
        t0 = time.perf_counter()
        flat = core.dispatch_pack_inputs(fields, plan, solver.device)
        ms = (time.perf_counter() - t0) * 1000
        return core.host_fetch(flat), LAUNCHES.get(KERNEL) - before, ms

    def graphed(graphs, fields, plan, n_eff):
        torch.cuda.synchronize()
        before = LAUNCHES.get(KERNEL)
        with graphs.lease(fields, plan.slots, n_eff) as graph:
            check(graph is not None, "pack_graph: no graph engaged")
            t0 = time.perf_counter()
            flat = core.dispatch_pack_inputs(fields, plan, solver.device,
                                             graph=graph)
            ms = (time.perf_counter() - t0) * 1000
            host = core.host_fetch(flat)
            replayed = graph.replayed
        return host, LAUNCHES.get(KERNEL) - before, ms, replayed

    def traced(label, fn, n_eff):
        """Four packs under the profiler, each in its own host window: the
        first warms the profiler up (the first window of a fresh trace
        missed two kernels and a copy on the card), the other three give
        a pack's (kernels, fill kernels, memcpy32_post, copies), checked
        alike in each window; and the device operations in no window."""
        torch.cuda.synchronize()
        trace, windows, launched = DeviceTrace(), [], []
        trace.start()
        for _ in range(4):
            before = LAUNCHES.get(KERNEL)
            t0 = time.time_ns()
            fn()
            windows.append((t0, time.time_ns()))
            launched.append(LAUNCHES.get(KERNEL) - before)
        torch.cuda.synchronize()
        events = trace.stop()
        per = []
        for ws, we in windows:
            inside = [n for n, s, e in events if ws <= s and e <= we]
            per.append((sum(not is_copy(n) for n in inside),
                        sum(any(k in n for k in FILL_KERNELS)
                            for n in inside),
                        sum("memcpy32_post" in n for n in inside),
                        sum(is_copy(n) for n in inside)))
        outside = len(events) - sum(p[0] + p[3] for p in per)
        per, launched = per[1:], launched[1:]
        check(len(set(per)) == 1,
              f"pack_graph[{name}]: the {label} packs' traces differ: {per}")
        check(per[0][1] == 2 * n_eff and launched == [2 * n_eff] * 3,
              f"pack_graph[{name}]: the {label} packs ran {per[0][1]} fill "
              f"kernels and counted {launched}, {n_eff} steps")
        return (*per[0], outside)

    traffic = load_json("portbench/traffic/burst.json")
    for name in ("inflate", "boutique"):
        config = load_json(f"portbench/configs/{name}.json")
        system = System(config)                  # device=None: the card
        solver = system.solver
        graphs = PackGraphs(solver.device)
        problems = [pack(solver, system.inputs(
            Traffic(config, traffic, seed).request(0)))
            for seed in PACK_GRAPH_SEEDS]
        fields, plan, n_eff = problems[0]
        with graphs.lease(fields, plan.slots, n_eff) as graph:
            check(graph is None,
                  f"pack_graph[{name}]: a first sighting engaged a graph")
        first = None
        for i, (fields, plan, n_eff) in enumerate(problems):
            want, want_launches, eager_ms = eager(fields, plan)
            got, launches, ms, replayed = graphed(graphs, fields, plan, n_eff)
            check(replayed == (i > 0),
                  f"pack_graph[{name}]: pack {i} replayed={replayed}")
            check(np.array_equal(got, want),
                  f"pack_graph[{name}]: pack {i}'s flat buffer differs from "
                  f"the eager pack's at {np.flatnonzero(got != want)[:5]}")
            check(launches == want_launches == 2 * n_eff,
                  f"pack_graph[{name}]: pack {i} counted {launches} fill "
                  f"launches, the eager pack {want_launches}, "
                  f"{n_eff} steps")
            if i == 0:
                first = (ms, eager_ms)
        eager_ms, replay_ms = [], []
        for k in range(PACK_GRAPH_TIMED):
            fields, plan, n_eff = problems[k % len(problems)]
            for way in ((0, 1) if k % 2 else (1, 0)):
                if way:
                    got, _, ms, _ = graphed(graphs, fields, plan, n_eff)
                    replay_ms.append(ms)
                else:
                    want, _, ms = eager(fields, plan)
                    eager_ms.append(ms)
            check(np.array_equal(got, want),
                  f"pack_graph[{name}]: a timed replay differs")
        fields, plan, n_eff = problems[0]
        replay_trace = traced("replayed", lambda: graphed(
            graphs, fields, plan, n_eff), n_eff)
        eager_trace = traced("eager", lambda: eager(fields, plan), n_eff)

        # through the service: a shape's first Solve packs eager, its
        # second captures, its third replays; a Sync of new prices makes a
        # new solver, whose second Solve captures again
        svc, pods = system.service, system.inputs(
            Traffic(config, traffic, PACK_GRAPH_SEEDS[0]).request(0))
        counts = []
        for _ in range(3):
            svc.solve(system.key, list(pods))
            counts.append((solver.last_solve_info["graph_captures"],
                           solver.last_solve_info["graph_replays"]))
        check(counts == [(0, 0), (1, 0), (0, 1)],
              f"pack_graph[{name}]: the service's Solves counted "
              f"(captures, replays) {counts}")
        repriced = dict(config, catalog=dict(
            config["catalog"],
            spot_discount=config["catalog"]["spot_discount"] * 0.9))
        catalog2 = build_catalog(repriced)
        key2 = (wire.catalog_key(catalog2), system.key[1])
        check(key2 != system.key, f"pack_graph[{name}]: new prices, same key")
        svc.sync(key2, catalog2, system.provisioners)
        solver2 = svc.checkout(key2)[0]
        svc.checkin(key2)
        check(solver2 is not solver and len(solver2._pack_graphs) == 0,
              f"pack_graph[{name}]: the Sync's solver holds "
              f"{len(solver2._pack_graphs)} graphs")
        counts2 = []
        for _ in range(2):
            svc.solve(key2, list(pods))
            info2 = solver2.last_solve_info
            counts2.append((info2["graph_captures"], info2["graph_replays"]))
        check(counts2 == [(0, 0), (1, 0)],
              f"pack_graph[{name}]: the new catalog's Solves counted "
              f"(captures, replays) {counts2}")
        phase("pack_graph", cell=f"{name}.burst", steps=problems[0][2],
              packs_bit_equal=len(problems) + PACK_GRAPH_TIMED,
              launches_equal=True,
              eager_enqueue_ms_median=f"{statistics.median(eager_ms):.3f}",
              replay_enqueue_ms_median=f"{statistics.median(replay_ms):.3f}",
              capture_run_ms=f"{first[0]:.3f}",
              its_eager_ms=f"{first[1]:.3f}",
              replay_kernels=replay_trace[0],
              replay_fill_kernels=replay_trace[1],
              replay_memcpy32_post=replay_trace[2],
              replay_copies=replay_trace[3],
              eager_kernels=eager_trace[0],
              eager_copies=eager_trace[3],
              replay_ops_outside_windows=replay_trace[4],
              eager_ops_outside_windows=eager_trace[4],
              resync_captures_again=True)
        system = solver = solver2 = svc = None
        gc.unfreeze()


# -- the fleet and the chaos drills (phases 22-26) ------------------------------

def _fleet_register(fe, catalog, prov, tids):
    """Register `tids` with the frontend, each keyed by the wire's content
    formula. -> the one solver key they share."""
    keys = {fe.register(t, catalog, [prov]) for t in tids}
    check(len(keys) == 1, f"fleet: tenants of one content got keys {keys}")
    return keys.pop()


def _mega(fe, tids, problems):
    """Submit one problem per tenant and run ONE tick: every ticket must
    resolve in it. -> (results, submit-to-resolve wall ms)."""
    t0 = time.perf_counter()
    tickets = [fe.submit(t, p["pods"]) for t, p in zip(tids, problems)]
    fe.tick()
    results = [t.wait(0) for t in tickets]
    return results, (time.perf_counter() - t0) * 1000


def _wave_flats(svc, key):
    solver, _ = svc.checkout(key)
    svc.checkin(key)
    return list(solver.last_wave_flats)


def run_fleet(torch, catalog, prov, problems, wave_launches, LAUNCHES,
              KERNEL, K1, TorchSolver) -> dict:
    """fleet: path C's 16 tenant problems through FleetFrontend(service=
    SolverService()) on the card (see the module docstring, phase 22).
    -> fill launches by part."""
    import numpy as np

    from karpenter_tpu_torch.fleet.frontend import FleetFrontend, FleetShed
    from karpenter_tpu_torch.introspect import statusz
    from karpenter_tpu_torch.solver.service import SolverService

    tids = [f"tenant-{k:02d}" for k in range(len(problems))]
    svc = SolverService()                        # device=None: the card
    check(svc.device.type == "cuda", "fleet: SolverService must default to "
                                     "cuda")
    fe = FleetFrontend(service=svc, max_wave=16, name="smoke-fleet")
    key = _fleet_register(fe, catalog, prov, tids)
    _mega(fe, tids, problems)                    # warm-up
    LAUNCHES.reset()
    mega0 = fe.mega_solves
    results, _ = _mega(fe, tids, problems)
    rose = LAUNCHES.get(KERNEL)
    check(fe.mega_solves == mega0 + 1,
          f"fleet: 16 tenants took {fe.mega_solves - mega0} mega-solves")
    check(rose == wave_launches, f"fleet: the mega-solve launched the fill "
                                 f"{rose} times, path C's wave {wave_launches}")
    check(LAUNCHES.get(K1) == 0, "fleet: the standalone K1 was launched")
    flats = _wave_flats(svc, key)
    solver, _ = svc.checkout(key)
    svc.checkin(key)
    (wave,) = solver.last_wave_info["waves"]
    check(wave["problems"] == len(problems),
          f"fleet: the mega-solve's waves {solver.last_wave_info['waves']}")
    direct = TorchSolver(catalog, [prov])
    want = direct.solve_many(problems)
    for k, (res, ref) in enumerate(zip(results, want)):
        check(res.decisions() == ref.decisions(),
              f"fleet: tenant {k}'s decisions differ from solve_many's")
        check(np.array_equal(flats[k], direct.last_wave_flats[k]),
              f"fleet: tenant {k}'s flat buffer differs from solve_many's")
    cpu_svc = SolverService(device="cpu")
    cpu_fe = FleetFrontend(service=cpu_svc, max_wave=16,
                           name="smoke-fleet-cpu")
    cpu_key = _fleet_register(cpu_fe, catalog, prov, tids)
    cpu_results, _ = _mega(cpu_fe, tids, problems)
    for k, flat in enumerate(_wave_flats(cpu_svc, cpu_key)):
        check(flat.dtype == np.int32 and np.array_equal(flats[k], flat),
              f"fleet: tenant {k}'s flat buffer differs from device='cpu'")
        check(cpu_results[k].decisions() == results[k].decisions(),
              f"fleet: tenant {k}'s decisions differ from device='cpu'")
    # submit-to-resolve of the 16 tenants beside the direct wave, in turns
    fleet_ms, direct_ms = [], []
    for _ in range(TIMED_SOLVES):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        direct.solve_many(problems)
        direct_ms.append((time.perf_counter() - t0) * 1000)
        _, wall = _mega(fe, tids, problems)
        fleet_ms.append(wall)
    # 64 tenants: four mega-solves, every wait within the starvation bound
    tids64 = [f"tenant64-{k:02d}" for k in range(64)]
    fe64 = FleetFrontend(service=svc, max_wave=16, name="smoke-fleet-64")
    _fleet_register(fe64, catalog, prov, tids64)
    before = LAUNCHES.get(KERNEL)
    tickets = [fe64.submit(t, problems[k % len(problems)]["pods"])
               for k, t in enumerate(tids64)]
    ticks = 0
    while fe64.queued() and ticks < 16:
        fe64.tick()
        ticks += 1
    for t in tickets:
        t.wait(0)
    launches64 = LAUNCHES.get(KERNEL) - before
    stats64 = fe64.stats()
    max_wait = max(t["max_wait_ticks"] for t in stats64["tenants"].values())
    check(fe64.mega_solves == 4 and stats64["served"] == 64,
          f"fleet: 64 tenants took {fe64.mega_solves} mega-solves, served "
          f"{stats64['served']}")
    check(max_wait <= fe64.starvation_bound,
          f"fleet: a tenant waited {max_wait} ticks, bound "
          f"{fe64.starvation_bound}")
    check(launches64 == 4 * wave_launches,
          f"fleet: 64 tenants launched the fill {launches64} times")
    shed = fe.submit(tids[0], problems[0]["pods"], deadline_ms=1)
    try:
        shed.wait(0)
        raise SmokeFailure("fleet: a 1 ms budget was not shed")
    except FleetShed as e:
        check(e.where == "admission", f"fleet: shed at {e.where}")
    fleet_sec = statusz._fleet_section()
    rows = {f["name"]: f for f in fleet_sec["frontends"]}
    check("smoke-fleet" in rows and rows["smoke-fleet"]["served"]
          == 16 * (2 + TIMED_SOLVES)
          and rows["smoke-fleet"]["mega_solves"] == 2 + TIMED_SOLVES,
          f"fleet: statusz's fleet section: {sorted(rows)}")
    over = statusz._overload_section()
    orow = {f["name"]: f for f in over["frontends"]}
    check("smoke-fleet" in orow and "guard" in orow["smoke-fleet"]
          and "eviction" in orow["smoke-fleet"],
          f"fleet: statusz's overload section: {sorted(orow)}")
    phase("fleet", tenants=len(tids), pods=sum(len(p["pods"])
                                                 for p in problems),
          bucket=wave["bucket"], steps=wave["steps"], mega_solves_per_16=1, open_claim_launches_per_mega_solve=rose,
          equal_solve_many_and_cpu=True,
          median_submit_to_resolve_ms=f"{statistics.median(fleet_ms):.3f}",
          median_direct_solve_many_ms=f"{statistics.median(direct_ms):.3f}",
          tenants64_mega_solves=fe64.mega_solves,
          tenants64_max_wait_ticks=max_wait,
          tenants64_launches=launches64, deadline_1ms_shed="admission",
          statusz_fleet_frontends=len(rows),
          statusz_overload_enabled=over["enabled"],
          overload_level_after_64=stats64["overload"]["guard"].get("level"))
    return {"per_mega_solve": rose, "tenants64": launches64,
            "total": rose + launches64}


def run_fleet_wire(catalog, prov, problems, want, LAUNCHES, KERNEL) -> dict:
    """fleet_wire: where grpcio imports, two FleetServices on the card
    served in this process behind a FleetRouter, and RemoteSolver(tenant_id=
    ...) solves of path C's 16 tenants, 16 at once: each answer equals the
    in-process one; each frontend holds only its home tenants; a served
    Operator answers /debug/fleetz with 200 (phase 23)."""
    import importlib.util
    from concurrent.futures import ThreadPoolExecutor

    if importlib.util.find_spec("grpc") is None:
        phase("fleet_wire", grpcio=False, checked="on the CPU only")
        return {"solves": 0}
    from karpenter_tpu_torch.apis.settings import Settings
    from karpenter_tpu_torch.fake.cloud import FakeCloud
    from karpenter_tpu_torch.fleet import FleetFrontend, FleetRouter, \
        FleetService
    from karpenter_tpu_torch.operator import Operator
    from karpenter_tpu_torch.solver.client import RemoteSolver
    from karpenter_tpu_torch.solver.service import SolverService, serve

    names = ("w0", "w1")
    fronts, servers, ports = {}, [], {}
    rounds = [{n: [] for n in names} for _ in range(2)]
    rnd = [0]

    def recording(name, dispatch):
        def run(key, plan, batch):  # each mega-solve's batch size, by round
            rounds[rnd[0]][name].append(len(batch))
            return dispatch(key, plan, batch)
        return run

    try:
        for name in names:
            fe = FleetFrontend(service=SolverService(), tick_interval_s=0.005,
                               max_wave=16, name=f"smoke-wire-{name}")
            fe._dispatch = recording(name, fe._dispatch)
            fe.start()
            fronts[name] = fe
            server, ports[name], _ = serve("127.0.0.1:0",
                                           service=FleetService(fe))
            servers.append(server)
        router = FleetRouter(names)
        tids = [f"tenant-{k:02d}" for k in range(len(problems))]
        home = {t: router.route(t) for t in tids}
        before = LAUNCHES.get(KERNEL)

        def one(k):
            rs = RemoteSolver(catalog, [prov], tenant_id=tids[k],
                              target=f"127.0.0.1:{ports[home[tids[k]]]}",
                              timeout=120.0)
            rs.sync()
            t0 = time.perf_counter()
            got = rs.solve(list(problems[k]["pods"]))
            return got, (time.perf_counter() - t0) * 1000

        walls = []
        for rep in range(2):  # the first round syncs and warms both
            rnd[0] = rep
            t0 = time.perf_counter()
            with ThreadPoolExecutor(len(tids)) as pool:
                outs = list(pool.map(one, range(len(tids))))
            batch_ms = (time.perf_counter() - t0) * 1000
            for k, (got, _) in enumerate(outs):
                check(got.decisions() == want[k].decisions(),
                      f"fleet_wire: tenant {k}'s answer differs from the "
                      f"in-process mega-solve's")
            if rep:
                walls = [w for _, w in outs]
        launches = LAUNCHES.get(KERNEL) - before
        check(launches > 0, "fleet_wire: the fill was never launched")
        for name, fe in fronts.items():
            got_t = set(fe.stats()["tenants"])
            check(got_t == {t for t in tids if home[t] == name},
                  f"fleet_wire: {name} holds tenants {sorted(got_t)}")
        megas = {n: fe.mega_solves for n, fe in fronts.items()}
    finally:
        for fe in fronts.values():
            fe.stop()
        for server in servers:
            server.stop(None)
    small = _small_catalog()
    op = Operator(FakeCloud(catalog=small),
                  Settings(cluster_name="smoke", cluster_endpoint=
                           "https://k.example", batch_idle_duration=0.0,
                           batch_max_duration=0.0), small, serve_http=True,
                  metrics_port=0, health_port=0, webhook_port=-1)
    try:
        bound = op.serving.start()
        status, body, fleetz_ms = http_call(
            f"http://127.0.0.1:{bound['metrics']}/debug/fleetz")
        check(status == 200 and json.loads(body)["tool"]
              == "karpenter-tpu-fleetz", f"fleet_wire: /debug/fleetz "
                                         f"answered {status}")
    finally:
        op.stop()
    phase("fleet_wire", grpcio=True, replicas=len(names), tenants=len(tids),
          home={n: sum(1 for t in tids if home[t] == n) for n in names},
          mega_solves=megas, batch_sizes_by_round=rounds,
          open_claim_launches=launches,
          answers_equal_in_process=True,
          median_client_solve_ms=f"{statistics.median(walls):.3f}",
          max_client_solve_ms=f"{max(walls):.3f}",
          batch_of_16_wall_ms=f"{batch_ms:.3f}", fleetz_status=status,
          fleetz_ms=f"{fleetz_ms:.3f}")
    return {"solves": launches}


def _small_catalog():
    """The fleet drill's catalog (benchmarks/fleet_drill.py _workload,
    copied): two instance types."""
    from karpenter_tpu_torch.models.instancetype import Catalog, \
        make_instance_type

    return Catalog(types=[
        make_instance_type("m.large", cpu=4, memory="16Gi",
                           od_price=0.20, spot_price=0.07),
        make_instance_type("m.xlarge", cpu=16, memory="64Gi",
                           od_price=0.80, spot_price=0.28)])


# the small real-replica drill's shape (benchmarks/fleet_drill.py SMALL)
DRILL_TENANTS, DRILL_SECONDS, DRILL_WORKERS, DRILL_WAVE = 48, 4.0, 8, 4
DRILL_KILL_FRAC, DRILL_RECOVERY, DRILL_PODS = 0.45, 3, 4


def run_fleet_replicas(LAUNCHES, KERNEL) -> dict:
    """fleet_replicas: two `fleet-replica --device cuda` processes on one
    rendezvous directory, the small drill's closed loop through
    FailoverClient, MembershipManager and FleetView, one replica SIGKILLed
    at 45% of the window (phase 24)."""
    import importlib.util
    import random
    import signal
    import tempfile
    import threading

    if importlib.util.find_spec("grpc") is None:
        phase("fleet_replicas", grpcio=False, checked="on the CPU only")
        return {"launches": {}}
    from karpenter_tpu_torch.apis import wellknown as wk
    from karpenter_tpu_torch.apis.provisioner import Provisioner
    from karpenter_tpu_torch.fleet.failover import FailoverClient
    from karpenter_tpu_torch.fleet.membership import MembershipManager
    from karpenter_tpu_torch.fleet.replica import (GrpcReplicaTransport,
                                                   http_probe, spawn_replica,
                                                   wait_for_registrations)
    from karpenter_tpu_torch.fleet.router import FleetRouter
    from karpenter_tpu_torch.introspect.fleetview import FleetView, \
        HttpReplica
    from karpenter_tpu_torch.models.pod import make_pod
    from karpenter_tpu_torch.models.requirements import OP_IN, Requirements
    from karpenter_tpu_torch.resilience.policy import RetryBudget
    from karpenter_tpu_torch.solver import solver_pb2 as pb
    from karpenter_tpu_torch.solver import wire
    from karpenter_tpu_torch.solver.core import TorchSolver
    from karpenter_tpu_torch.solver.service import result_to_response
    from karpenter_tpu_torch.utils.clock import WallClock

    names, victim = ["r0", "r1"], "r1"
    tenants = [f"tenant-{i:04d}" for i in range(DRILL_TENANTS)]
    catalog = _small_catalog()
    prov = Provisioner(name="default", requirements=Requirements.of(
        (wk.LABEL_CAPACITY_TYPE, OP_IN, ["spot", "on-demand"])))
    prov.set_defaults()
    procs, transports, spawned = {}, {}, {}
    stop_tick = threading.Event()
    rv = tempfile.mkdtemp(prefix="smoke-fleet-")
    try:
        for name in names:
            spawned[name] = time.time()
            procs[name] = spawn_replica(name, rv, max_wave=DRILL_WAVE,
                                        starvation_bound=16, device="cuda")
        regs = wait_for_registrations(rv, names, timeout_s=240)
        boot_s = {n: regs[n]["ts"] - spawned[n] for n in names}
        health = {}
        cat_hash, prov_hash = None, wire.provisioners_hash([prov])
        for name in names:
            transports[name] = GrpcReplicaTransport(name, regs[name]["grpc"])
            health[name] = transports[name]._stubs["Health"](
                pb.HealthRequest(), timeout=30).backend
            cat_hash = transports[name].sync(catalog, [prov]).catalog_hash
        check(all(b == "cuda" for b in health.values()),
              f"fleet_replicas: Health reports {health}")
        seq = itertools.count()

        def request(tid):
            i = next(seq)
            pods = [make_pod(f"{tid}-q{i}-p{j}", cpu="1", memory="2Gi")
                    for j in range(DRILL_PODS)]
            return pb.SolveRequest(catalog_hash=cat_hash,
                                   provisioner_hash=prov_hash,
                                   pods=[wire.pod_to_wire(p) for p in pods])

        for name in names:  # warm: one solo solve, then bursts of 2 and 4
            transports[name]("warm", request("warm"), 120.0)
            for k in (2, 4):
                burst = [threading.Thread(target=transports[name], args=(
                    f"warm-{k}-{j}", request(f"warm-{k}-{j}"), 120.0))
                    for j in range(k)]
                for t in burst:
                    t.start()
                for t in burst:
                    t.join()
        router = FleetRouter()
        view = FleetView(router=router, name="smoke-fleet",
                         clock=WallClock())
        membership = MembershipManager(router, view=view, gray_factor=50.0)
        audit = FleetView(name="smoke-fleet-audit", clock=WallClock())
        for name in names:
            membership.register(name, http_probe(regs[name]["health"]),
                                endpoint=HttpReplica(name,
                                                     regs[name]["debug"]))
            audit.add_replica(HttpReplica(name, regs[name]["debug"]))
        for _ in range(20):
            membership.tick()
            if set(membership.members()) == set(names):
                break
        check(set(membership.members()) == set(names),
              f"fleet_replicas: members {membership.members()}")
        cycles, lock, ticking = [], threading.Lock(), threading.Lock()

        def ticker():
            while not stop_tick.is_set():
                with ticking:
                    events = membership.tick()
                    with lock:
                        cycles.append({"ts": time.time(), "ejected": [
                            e["replica"] for e in events
                            if e.get("event") == "ReplicaEjected"]})
                stop_tick.wait(0.25)

        failover = FailoverClient(router, transports, seed=0,
                                  hedge_horizon_s=10.0,
                                  budget=RetryBudget(capacity=128.0,
                                                     refill_per_success=0.5))
        rng = random.Random(0)
        sweep = list(tenants)
        rng.shuffle(sweep)
        deadline = [0.0]
        outcomes, picks = [], threading.Lock()

        def next_tenant():
            with picks:
                if sweep:
                    return sweep.pop()
                if time.perf_counter() >= deadline[0]:
                    return None
                return rng.choice(tenants)

        def worker():
            while True:
                tid = next_tenant()
                if tid is None:
                    return
                t0 = time.perf_counter()
                try:
                    resp = failover.solve(tid, request(tid), timeout_s=30.0)
                    outcomes.append((tid, "served",
                                     (time.perf_counter() - t0) * 1e3, resp))
                except Exception as e:  # noqa: BLE001 — counted as an error
                    outcomes.append((tid, f"{type(e).__name__}: {e}", 0.0,
                                     None))

        kill = {}

        def killer():
            stop_tick.wait(DRILL_SECONDS * DRILL_KILL_FRAC)
            # between two ticks: every cycle counted from the kill probed
            # after it
            with ticking:
                kill["wall"] = time.time()
                procs[victim].kill()

        tick_t = threading.Thread(target=ticker, daemon=True)
        kill_t = threading.Thread(target=killer, daemon=True)
        workers = [threading.Thread(target=worker, daemon=True)
                   for _ in range(DRILL_WORKERS)]
        warm = {n: _replica_launches(procs[n], rv, n).get(KERNEL, 0)
                for n in names}
        t_start = time.perf_counter()
        deadline[0] = t_start + DRILL_SECONDS
        tick_t.start()
        kill_t.start()
        for w in workers:
            w.start()
        for w in workers:
            w.join()
        wall = time.perf_counter() - t_start
        survivor = next(n for n in names if n != victim)
        window = _replica_launches(procs[survivor], rv, survivor)
        kill_t.join(timeout=15)
        t_wait = time.monotonic()
        while time.monotonic() - t_wait < 10:
            with lock:
                post = [c for c in cycles if c["ts"] >= kill["wall"]]
            if any(victim in c["ejected"] for c in post):
                break
            time.sleep(0.05)
        stop_tick.set()
        tick_t.join(timeout=5)
        recovery = next((i + 1 for i, c in enumerate(post)
                         if victim in c["ejected"]), None)
        rows = audit.fleetz()["replicas"]
        served = [o for o in outcomes if o[1] == "served"]
        errors = [o for o in outcomes if o[1] != "served"]
        check(not errors, f"fleet_replicas: {len(errors)} errors: "
                          f"{[o[1] for o in errors[:3]]}")
        check({o[0] for o in served} >= set(tenants),
              "fleet_replicas: not every tenant was served")
        check(recovery is not None and recovery <= DRILL_RECOVERY,
              f"fleet_replicas: the kill was absorbed in {recovery} cycles")
        check(rows[victim]["healthy"] is False
              and rows[victim]["scrape_error"] == "connect",
              f"fleet_replicas: the victim's row {rows[victim]}")
        # sampled tenants' answers against an in-process device="cpu" solve
        cpu = TorchSolver(catalog, [prov], device="cpu")
        sampled = tenants[::len(tenants) // 6]
        for tid in sampled:
            req = request(tid)
            pods = [wire.pod_from_wire(m) for m in req.pods]
            got = failover.solve(tid, req, timeout_s=30.0)
            check(_answer(got) == _answer(result_to_response(
                cpu.solve(pods), 0.0, 0)),
                f"fleet_replicas: {tid}'s answer differs from device='cpu'")
        lats = sorted(o[2] for o in served)
        served_by = {n: rows[n].get("served") for n in names}
    finally:
        stop_tick.set()
        for proc in procs.values():
            if proc.poll() is None:
                proc.send_signal(signal.SIGTERM)
        for proc in procs.values():
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
        for tp in transports.values():
            tp.close()
    sampled_launches = [c.get(KERNEL, 0) for c in _replica_log_launches(
        rv, survivor, "REPLICA_STOPPED")][-1:]
    check(window.get(KERNEL, 0) > 0, f"fleet_replicas: the survivor "
                                     f"launched the fill {window} in the "
                                     f"window")
    check(sampled_launches and sampled_launches[0] > 0,
          f"fleet_replicas: the sampled solves launched the fill "
          f"{sampled_launches} times")
    phase("fleet_replicas", replicas=len(names), victim=victim,
          boot_to_registration_s={n: f"{boot_s[n]:.3f}" for n in names},
          health=health, requests=len(outcomes), served=len(served),
          errors=0, tenants=len({o[0] for o in served}),
          window_s=f"{wall:.3f}", recovery_cycles=recovery,
          victim_scrape_error=rows[victim]["scrape_error"],
          served_by_replica=served_by,
          warm_open_claim_launches=warm,
          survivor_window_open_claim_launches=window.get(KERNEL, 0),
          survivor_sampled_open_claim_launches=sampled_launches[0],
          p50_ms=f"{lats[len(lats) // 2]:.3f}",
          p99_ms=f"{lats[min(len(lats) - 1, int(len(lats) * 0.99))]:.3f}",
          sampled_equal_cpu=len(sampled))
    return {"launches": window}


def _replica_log_launches(rv, name, tag) -> "list[dict]":
    """The launch counts of every `tag` line in replica `name`'s log."""
    with open(os.path.join(rv, f"{name}.log")) as f:
        return [json.loads(line.split(" ", 1)[1])["launches"]
                for line in f if line.startswith(tag + " ")]


def _replica_launches(proc, rv, name, timeout_s=10.0) -> dict:
    """A live replica's launches since its last report, by kernel: SIGUSR1
    makes it print them and count from 0 again (fleet/replica.py)."""
    import signal

    seen = len(_replica_log_launches(rv, name, "REPLICA_LAUNCHES"))
    proc.send_signal(signal.SIGUSR1)
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout_s:
        got = _replica_log_launches(rv, name, "REPLICA_LAUNCHES")
        if len(got) > seen:
            return got[-1]
        time.sleep(0.02)
    raise SmokeFailure(f"fleet_replicas: {name} did not report its launches")


def _answer(resp) -> tuple:
    """A SolveResponse's decisions: its nodes, existing-node assignments,
    unschedulable counts and groups, serialized."""
    return tuple(tuple(m.SerializeToString(deterministic=True)
                       for m in getattr(resp, field))
                 for field in ("nodes", "existing", "unschedulable", "groups"))


def _comparable_artifact(x):
    """A chaos artifact without its volatile fields: durations, timestamps
    and paths."""
    if isinstance(x, dict):
        return {k: _comparable_artifact(v) for k, v in x.items()
                if k not in ("duration_s", "artifact_path", "bundles", "ts",
                             "captured_at") and not k.endswith("_path")}
    if isinstance(x, list):
        return [_comparable_artifact(v) for v in x]
    return x


class _RungLog:
    """Records the rung of every consolidation pass (the method the
    deprovisioner files its decision under) and of every routed provisioning
    solve, by wrapping the two controller methods for the duration."""

    def __enter__(self):
        from karpenter_tpu_torch.controllers import deprovisioning, \
            provisioning

        self.consolidation, self.solves = [], []
        self._dep = deprovisioning.DeprovisioningController
        self._prov = provisioning.ProvisioningController
        self._emit = self._dep._emit_consolidation_decision
        self._routed = self._prov._routed_solve
        log = self

        def emit(ctrl, action, method, verdicts):
            log.consolidation.append(method)
            return log._emit(ctrl, action, method, verdicts)

        def routed(ctrl, *a, **kw):
            out = log._routed(ctrl, *a, **kw)
            log.solves.append(out[1])
            return out

        self._dep._emit_consolidation_decision = emit
        self._prov._routed_solve = routed
        return self

    def __exit__(self, *exc):
        self._dep._emit_consolidation_decision = self._emit
        self._prov._routed_solve = self._routed


def run_chaos(LAUNCHES, KERNEL) -> dict:
    """chaos: the chaos runner's default sweep (seed 0, 3 scenarios) and
    its crash drill on the card, each against the same runner on
    device="cpu", then the CLI's `chaos --device cuda` (phase 25)."""
    import tempfile

    from karpenter_tpu_torch.chaos import ChaosRunner

    out, rows = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for label, kw in (("sweep", {"scenarios": 3}), ("crash",
                                                       {"crash": True})):
            LAUNCHES.reset()
            t0 = time.perf_counter()
            with _RungLog() as rungs:
                art = ChaosRunner(seed=0, device="cuda",
                                  out_dir=os.path.join(tmp, label), **kw).run()
            wall = (time.perf_counter() - t0) * 1000
            launches = LAUNCHES.get(KERNEL)
            bad = [v for s in art["scenarios"] for v in s["violations"]]
            check(art["passed"] and not bad,
                  f"chaos {label}: failed on the card: {bad[:3]}")
            check(set(rungs.consolidation) == {"cuda"} and launches > 0,
                  f"chaos {label}: consolidation rungs {rungs.consolidation}, "
                  f"{launches} fill launches")
            fired = [f["kind"] for s in art["scenarios"]
                     for f in s.get("fired", [])]
            prov_errors = [e for s in art["scenarios"]
                           for e in s.get("controller_errors", [])
                           if e.startswith("provisioning:")]
            check(not prov_errors, f"chaos {label}: a solver crash escaped "
                                   f"the ladder: {prov_errors[:3]}")
            t1 = time.perf_counter()
            cpu = ChaosRunner(seed=0, device="cpu",
                              out_dir=os.path.join(tmp, label + "-cpu"),
                              **kw).run()
            cpu_ms = (time.perf_counter() - t1) * 1000
            check(_comparable_artifact(cpu) == _comparable_artifact(art),
                  f"chaos {label}: the card's artifact differs from "
                  f"device='cpu''s")
            out[label] = launches
            rows[label] = dict(
                scenarios=len(art["scenarios"]), wall_ms=f"{wall:.3f}",
                cpu_wall_ms=f"{cpu_ms:.3f}", open_claim_launches=launches,
                consolidation_passes=rungs.consolidation.count("cuda"),
                routed_solves=collections.Counter(rungs.solves),
                solver_crashes=fired.count("solver-crash"),
                equal_cpu=True)
        t0 = time.perf_counter()
        cli = subprocess.run(
            [sys.executable, "-m", "karpenter_tpu_torch", "chaos", "--seed",
             "0", "--device", "cuda", "--out-dir", os.path.join(tmp, "cli")],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            capture_output=True, text=True, timeout=600)
        cli_s = time.perf_counter() - t0
        check(cli.returncode == 0, f"chaos: the CLI exited {cli.returncode}: "
                                   f"{cli.stdout[-1500:]}{cli.stderr[-1500:]}")
    for label, row in rows.items():
        phase(f"chaos_{label}", **row)
    phase("chaos_cli", exit=cli.returncode, seconds=f"{cli_s:.3f}",
          summary=repr((cli.stdout.strip().splitlines() or [""])[-1]))
    return out


def run_chaos_spot_storm(LAUNCHES, KERNEL) -> int:
    """chaos_spot_storm: `chaos --spot-storm --seed 0` at its default
    10,000 nodes and 2,000 reclaims on the card (phase 26)."""
    import tempfile

    from karpenter_tpu_torch.chaos import ChaosRunner

    LAUNCHES.reset()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp, _RungLog() as rungs:
        art = ChaosRunner(seed=0, spot_storm=True, device="cuda",
                          out_dir=tmp).run()
    wall = (time.perf_counter() - t0) * 1000
    launches = LAUNCHES.get(KERNEL)
    bad = [v for s in art["scenarios"] for v in s["violations"]]
    check(art["passed"] and not bad,
          f"chaos_spot_storm: failed on the card: {bad[:3]}")
    check(launches > 0 and rungs.solves
          and set(rungs.solves) == {"cuda"},
          f"chaos_spot_storm: routed solves {collections.Counter(rungs.solves)}"
          f", {launches} fill launches")
    key = art["key_numbers"]
    phase("chaos_spot_storm", wall_ms=f"{wall:.3f}",
          scenarios=[s["drill"] for s in art["scenarios"]],
          open_claim_launches=launches, routed_solves=len(rungs.solves),
          **{k: v for k, v in key.items()})
    return launches


# -- the continuous profiler and the mesh (phases 27-29) -------------------------

RESULTS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "port_results")


@contextlib.contextmanager
def held_stopped(host):
    """The host sampler stopped for the block, its ensure_started refused
    on this instance, then restarted."""
    host.stop()
    host.ensure_started = lambda: False
    try:
        yield
    finally:
        del host.ensure_started
        check(host.ensure_started(), "profiler: the sampler did not "
                                     "restart")


def run_profiler(torch, catalog, prov, pods, busy_ms):
    """profiler: path A's solve 5 times with the profiling plane on (its
    host sampler has run since the first solve of this process), each
    filing one device-ladder event measured by CUDA events (its ms within
    the solve's wall and at least the profile phase's device-busy ms);
    5 with the plane on and the sampler alone stopped, each still filing
    its event, and no sample taken; 5 with the plane disabled, filing
    none, the three windows interleaved a solve at a time; the three
    medians, the sampler's overhead gauge since it started and its sweep
    seconds over each window's wall; /debug/profilez of a served operator
    in both formats; a torch.profiler trace through start_trace/stop_trace.

    A solve scope restarts a stopped sampler (ensure_started, as in the
    JAX package), and the port adds no switch to hold it stopped, so the
    sampler-off window holds it stopped by refusing this instance's
    ensure_started for the window's length."""
    from karpenter_tpu_torch import profiling
    from karpenter_tpu_torch.apis.settings import Settings
    from karpenter_tpu_torch.fake.cloud import FakeCloud
    from karpenter_tpu_torch.operator import Operator
    from karpenter_tpu_torch.solver.core import TorchSolver
    from karpenter_tpu_torch.utils.clock import FakeClock

    check(profiling.enabled(), "profiler: the profiling plane must be on "
                               "by default")
    dev, host = profiling.PROFILER.device, profiling.PROFILER.host
    check(dev.mode() == "cuda-events", f"profiler: ladder mode {dev.mode()}")
    check(host.running(), "profiler: the sampler is not running after the "
                          "solves of this process")
    solver = TorchSolver(catalog, [prov])
    solver.solve(list(pods))
    labels = ("on", "sampler_off", "off")
    walls = {label: [] for label in labels}
    counts = {label: collections.Counter() for label in labels}
    events = []
    gauge = host.overhead_ratio()
    # the windows interleave, one solve of each a round, so that the
    # host's drift falls on the three alike; off: the plane disabled, as
    # the JAX profile drill's A/B runs it (a disabled plane's sampler
    # idles and files no event)
    for _ in range(TIMED_SOLVES):
        for label in labels:
            with (profiling.disabled() if label == "off"
                  else held_stopped(host) if label == "sampler_off"
                  else contextlib.nullcontext()):
                c = counts[label]
                before, samples0 = dev.events_total, host.samples_total
                cost0, t0 = host.sample_cost_s, time.perf_counter()
                solver.solve(list(pods))
                wall = time.perf_counter() - t0
                c["filed"] += dev.events_total - before
                c["sampled"] += host.samples_total - samples0
                c["running"] += host.running()
                c["cost_s"] += host.sample_cost_s - cost0
                c["wall_s"] += wall
                walls[label].append(wall * 1000)
                if label == "on":
                    events.append((dev.events()[-1], wall * 1000))
    window = {label: c["cost_s"] / c["wall_s"]
              for label, c in counts.items()}
    off, stopped = counts["off"], counts["sampler_off"]
    check(off["filed"] == 0, f"profiler: {off['filed']} events while "
                             f"disabled")
    check(stopped["filed"] == TIMED_SOLVES and stopped["sampled"] == 0
          and stopped["running"] == 0,
          f"profiler: {dict(stopped)} with the sampler stopped")
    check(counts["on"]["filed"] == TIMED_SOLVES,
          f"profiler: {counts['on']['filed']} device events for "
          f"{TIMED_SOLVES} solves")
    for ev, wall in events:
        check(ev["mode"] == "cuda-events", f"profiler: event {ev}")
        check(busy_ms <= ev["ms"] <= wall,
              f"profiler: an event of {ev['ms']} ms outside "
              f"[{busy_ms:.4f}, {wall:.3f}]")
    events = [ev for ev, _ in events]
    check(host.running() and host.samples_total > 0,
          "profiler: the sampler is not running")
    clock = FakeClock()
    op = Operator(FakeCloud(catalog=catalog, clock=clock),
                  Settings(cluster_name="smoke-prof",
                           cluster_endpoint="https://k"),
                  catalog, clock=clock, serve_http=True, metrics_port=0,
                  health_port=-1, webhook_port=-1)
    ports = op.serving.start()
    try:
        base = f"http://127.0.0.1:{ports['metrics']}/debug/profilez"
        code, body, _ = http_call(base)
        doc = json.loads(body)
        check(code == 200 and doc["stacks"]
              and doc["device"]["mode"] == "cuda-events",
              f"profiler: /debug/profilez answered {code}")
        code_f, folded, _ = http_call(base + "?format=folded&n=20")
        check(code_f == 200 and folded.strip(),
              f"profiler: ?format=folded answered {code_f}")
    finally:
        op.serving.stop()
        op.stop()
    trace_dir = os.path.join(RESULTS_DIR, "profiler_trace")
    if os.path.exists(os.path.join(trace_dir, "trace.json")):
        os.remove(os.path.join(trace_dir, "trace.json"))
    check(dev.start_trace(trace_dir), "profiler: start_trace refused")
    solver.solve(list(pods))
    dev.stop_trace()
    trace = os.path.join(trace_dir, "trace.json")
    check(os.path.getsize(trace) > 0, "profiler: no trace written")
    row = {"mode": dev.mode(), "events_per_solve": 1,
           "event_ms": [e["ms"] for e in events], "busy_ms": busy_ms,
           "median_on_ms": statistics.median(walls["on"]),
           "median_sampler_off_ms": statistics.median(walls["sampler_off"]),
           "median_off_ms": statistics.median(walls["off"]),
           "overhead_ratio_gauge": gauge,
           "sweep_share_on_window": window["on"],
           "sweep_share_sampler_off_window": window["sampler_off"],
           "sweep_share_off_window": window["off"],
           "threads": threading.active_count(),
           "samples": host.samples_total, "stacks": len(doc["stacks"]),
           "profilez": code, "folded": code_f,
           "trace_bytes": os.path.getsize(trace)}
    phase("profiler", **{k: (f"{v:.4f}" if isinstance(v, float) else v)
                         for k, v in row.items()})
    return row


def rowmax_bound_ms(case):
    """The row-max mode's bound, one lane: it reads active rows' mask, used
    (demanded columns) and nprov, the feasibility and pods-cap planes they
    use, the demanded alloc columns, vec and every row's active byte, and
    writes qmax [N]; one division per demanded resource (and the pods cap)
    for each active (n, t) with a feasible option."""
    used, optmask, active, vec = (case["used"][0], case["optmask"][0],
                                  case["active"][0], case["vec"][0])
    N, R = used.shape
    T, S = optmask.shape[1:]
    feas, pc, pods_i = case["feas"][0], case["prov_pods_cap"], case["pods_i"]
    nprov0 = case["nprov"][0].clamp(min=0).long()
    feas_n = feas[0][None] if feas.shape[0] == 1 else feas[nprov0]
    pairs = int((optmask & feas_n & active[:, None, None]).any(dim=-1).sum())
    n_act = int(active.sum())
    demanded = int((vec > 0).sum())
    use_pc = pc is not None and bool(vec[pods_i] > 0)
    planes = len(set(nprov0[active].tolist())) if feas.shape[0] > 1 \
        else int(n_act > 0)
    nbytes = (R * 4 + N + n_act * (T * S + demanded * 4 + 4)
              + planes * T * S + T * demanded * 4
              + (planes * T * 4 if use_pc else 0) + N * 4)
    b = nbytes / HBM_BYTES_PER_S * 1e3
    o = pairs * (demanded + int(use_pc)) / CUDA_CORE_OPS_PER_S * 1e3
    return max(b, o), ("bytes" if b >= o else "operations")


def check_rowmax(torch, oc, label, case, timed=False):
    """The split fill on the card against its plain halves, bit for bit:
    launch 1's row-max mode against open_claim_rowmax_reference, then, on
    the plain waterfall's m and the moved used rows, launch 2 against
    open_claim_apply_reference. With `timed`, the row-max launch's device
    ms, the plain row max's and the bound. -> (max |diff|, row)."""
    want_q, q_nt, nodefeas = oc.open_claim_rowmax_reference(
        case["alloc_t"], case["vec"], case["feas"], case["prov_pods_cap"],
        case["pods_i"], case["used"], case["optmask"], case["nprov"],
        case["active"])
    used, optmask = case["used"].clone(), case["optmask"].clone()
    N = used.shape[1]
    fill = oc.OpenClaimFill(case["alloc_t"], case["prov_pods_cap"],
                            case["pods_i"],
                            oc.open_claim_workspace(N, used.device, 1))
    args = dict(vec=case["vec"], cap=case["cap"], feas=case["feas"],
                og=case["og"], claim_placed=case["claim_placed"], used=used,
                optmask=optmask, nprov=case["nprov"], active=case["active"],
                rem=case["rem"])
    qmax = fill.rowmax(**args)
    m = oc._waterfall(case["rem"], oc.claim_fill(
        want_q, case["cap"], case["og"], case["claim_placed"]))
    used.copy_(oc.placed_used(used, case["vec"], m))
    fill.apply(**args, m=m.contiguous())
    want_mask = oc.open_claim_apply_reference(q_nt, nodefeas, m,
                                              case["optmask"])
    torch.cuda.synchronize()
    worst = max(int((qmax.long() - want_q.long()).abs().max()),
                int((optmask.long() - want_mask.long()).abs().max()))
    check(torch.equal(qmax, want_q) and torch.equal(optmask, want_mask),
          f"the row-max split differs from its plain version at {label}: "
          f"max |diff| {worst}")
    row = {"N": N, "T": optmask.shape[2], "R": used.shape[2],
           "placed_rows": int((m > 0).sum())}
    if timed:
        rem_out = torch.empty((1,), dtype=torch.int32, device=used.device)
        q1 = torch.empty_like(qmax)

        # the case's own state (the row-max mode writes neither used nor
        # the mask), so every timed call must give the checked qmax
        state = dict(args, used=case["used"], optmask=case["optmask"])

        def launch():   # its arguments name the stream it is captured on
            oc.launch_rowmax(oc.OpenClaimFill(
                case["alloc_t"], case["prov_pods_cap"], case["pods_i"],
                fill.workspace).args(**state, m=q1, rem_out=rem_out))

        row["ms"] = device_ms(launch)
        row["plain_ms"] = device_ms(lambda: oc.open_claim_rowmax_reference(
            case["alloc_t"], case["vec"], case["feas"], case["prov_pods_cap"],
            case["pods_i"], case["used"], case["optmask"], case["nprov"],
            case["active"]))
        row["bound_ms"], row["bound_by"] = rowmax_bound_ms(case)
        torch.cuda.synchronize()
        check(torch.equal(q1, want_q), f"the timed row-max calls at {label} "
                                       f"left another qmax")
    phase(f"rowmax_{label}_shape", exact=True, max_abs_err=worst,
          **{k: (f"{v:.5f}" if isinstance(v, float) else v)
             for k, v in row.items()})
    return worst, row


def run_mesh_1(torch, catalog, prov, pods_a, info_a, info_b, LAUNCHES):
    """mesh_1: a world-size-1 NCCL process group in this process (a
    FileStore under port_results/), ShardedContext 1 x 1: path A's flat
    buffer through dispatch_flat equals TorchSolver's on the card, the
    split fill launching once in each mode a step; and the split against
    its plain halves at A's and B's shapes, with the row-max mode timed."""
    import numpy as np
    import torch.distributed as dist

    from karpenter_tpu_torch.models.encode import encode_problem
    from karpenter_tpu_torch.ops import open_claim as oc
    from karpenter_tpu_torch.parallel import multihost, sharded
    from karpenter_tpu_torch.solver.core import (TorchSolver,
                                                 build_pack_inputs,
                                                 dispatch_pack_inputs)

    worst, rows = 0, {}
    for label, info in (("pathA", info_a), ("pathB", info_b)):
        case = open_claim_case(torch, info["slots"], 603, 6,
                               info["res_width"], 1, False,
                               seed=info["slots"] + info["res_width"],
                               rem=37 * info["slots"])
        err, rows[label] = check_rowmax(torch, oc, label, case, timed=True)
        worst = max(worst, err)
    os.makedirs(RESULTS_DIR, exist_ok=True)
    store = os.path.join(RESULTS_DIR, "mesh_1.store")
    if os.path.exists(store):
        os.remove(store)
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{store}",
                            world_size=1, rank=0)
    try:
        ctx = sharded.ShardedContext()
        solver = TorchSolver(catalog, [prov])
        enc = encode_problem(catalog, [prov], list(pods_a),
                             grid=solver.grid(),
                             group_cache=solver._group_cache)
        fields, plan = build_pack_inputs(enc, solver._dev_alloc_t,
                                         solver._dev_tiebreak)
        single = dispatch_pack_inputs(fields, plan, solver.device).cpu()
        ctx.dispatch_flat(fields, plan.slots, enc.grid).cpu()  # uploads
        LAUNCHES.reset()
        sharded.COLLECTIVES.reset()
        t0 = time.perf_counter()
        flat = ctx.dispatch_flat(fields, plan.slots, enc.grid).cpu()
        wall = (time.perf_counter() - t0) * 1000
        launches = {oc.KERNEL: LAUNCHES.get(oc.KERNEL),
                    oc.ROWMAX_KERNEL: LAUNCHES.get(oc.ROWMAX_KERNEL)}
        collectives = sharded.COLLECTIVES.get("all_reduce")
        steps = info_a["steps"]
        check(np.array_equal(flat.numpy(), single.numpy()),
              "mesh_1: the 1 x 1 mesh's flat buffer differs from the card's")
        check(launches[oc.ROWMAX_KERNEL] == steps
              and launches[oc.KERNEL] == steps,
              f"mesh_1: launches {launches} over {steps} steps")
        check(collectives == 3 * steps + 2,
              f"mesh_1: {collectives} all_reduces over {steps} steps")
    finally:
        multihost.shutdown_distributed()
    phase("mesh_1", backend="nccl", world=1, mesh=ctx.describe(),
          flat_bit_equal_card=True, steps=steps,
          rowmax_launches=launches[oc.ROWMAX_KERNEL],
          fill_launches=launches[oc.KERNEL],
          all_reduces_per_solve=collectives, wall_ms=f"{wall:.3f}",
          split_exact=True, max_abs_err=worst)
    return {"launches": launches, "rows": rows, "max_abs_err": worst}


MESH_TIMED = 3


def mesh_rank_main(spec_path, rank):
    """One rank of a mesh_ranks group (`chip_smoke.py --mesh-rank SPEC
    RANK`): ranks share the card over gloo. Rank 0 drives its jobs through
    the process's ShardedContext and writes their results; the other ranks
    follow and write their launch and collective counts. Rank 0 counts
    each mesh run (a solve, a sweep, the stop) from 0 just before it and
    reads the counts just after, before any single-card or one-shot
    comparison runs; the sum of its mesh runs' counts is what each
    follower counts over its whole life."""
    import numpy as np
    import torch

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from karpenter_tpu_torch.device import LAUNCHES
    from karpenter_tpu_torch.entry import stress_problem
    from karpenter_tpu_torch.ops import consolidate, open_claim
    from karpenter_tpu_torch.parallel import multihost, sharded
    from karpenter_tpu_torch.solver import buckets
    from karpenter_tpu_torch.solver.core import NativeSolver, TorchSolver

    with open(spec_path) as f:
        spec = json.load(f)
    world = spec["world"]
    os.environ.update(WORLD_SIZE=str(world), RANK=str(rank),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
    check(multihost.initialize_distributed(f"file://{spec['store']}",
                                           device="cuda"),
          "mesh_ranks: no process group")
    import torch.distributed as dist

    check(dist.get_backend() == "gloo", "mesh_ranks: ranks sharing one card "
                                        "must use gloo")
    ctx = sharded.shared_context("cuda")
    out = {"rank": rank}
    if rank != 0:
        LAUNCHES.reset()
        sharded.COLLECTIVES.reset()
        ctx.follow()
        multihost.shutdown_distributed()
        out.update(launches=LAUNCHES.take(),
                   collectives=sharded.COLLECTIVES.take())
        with open(f"{spec['out']}.{rank}", "w") as f:
            json.dump(out, f)
        return 0
    totals = {"launches": collections.Counter(),
              "collectives": collections.Counter()}

    def counted(fn):
        """fn() with the counts from 0: -> (its result, its launches, its
        collectives), both added to the mesh runs' totals."""
        LAUNCHES.reset()
        sharded.COLLECTIVES.reset()
        result = fn()
        launches, coll = LAUNCHES.take(), sharded.COLLECTIVES.take()
        totals["launches"].update(launches)
        totals["collectives"].update(coll)
        return result, launches, coll

    for job in spec["jobs"]:
        if job in ("config4", "pathB"):
            if job == "config4":
                catalog, provs, pods = stress_problem()
                existing = ()
            else:
                from karpenter_tpu_torch.providers.instancetypes import \
                    generate_fleet_catalog

                catalog = generate_fleet_catalog()
                provs, pods = [provisioner()], mixed_5k_pods()
                existing = existing_nodes(catalog)
            mesh = TorchSolver(catalog, provs, mesh_ctx=ctx,
                               router=buckets.ShapeRouter(
                                   n_devices=ctx.device_count,
                                   crossover_cells=0))
            walls, counts = [], []
            for i in range(1 + MESH_TIMED):
                held = copy_existing(existing)
                t0 = time.perf_counter()
                res, launches, coll = counted(
                    lambda: mesh.solve(list(pods), existing=held))
                walls.append((time.perf_counter() - t0) * 1000)
                counts.append((launches, coll))
            launches, coll = counts[-1]
            check(all(c == counts[-1] for c in counts[1:]),
                  f"mesh_ranks {job}: the timed solves' counts differ: "
                  f"{counts[1:]}")
            info = mesh.last_solve_info
            check(info["routing"] == "cuda-sharded"
                  and info["device_count"] == world,
                  f"mesh_ranks {job}: routed {info['routing']} over "
                  f"{info['device_count']}")
            single, single_walls = TorchSolver(catalog, provs), []
            for i in range(1 + MESH_TIMED):
                t0 = time.perf_counter()
                single_res = single.solve(list(pods),
                                          existing=copy_existing(existing))
                single_walls.append((time.perf_counter() - t0) * 1000)
            check(np.array_equal(mesh.last_flat, single.last_flat),
                  f"mesh_ranks {job}: the mesh's flat buffer differs from "
                  f"the single card's")
            check(res.decisions() == single_res.decisions(),
                  f"mesh_ranks {job}: decisions differ")
            row = {"steps": info["steps"], "bucket": info["bucket"],
                   "nodes": len(res.nodes), "flat_bit_equal_card": True,
                   "median_wall_ms": statistics.median(walls[1:]),
                   "single_card_median_wall_ms":
                       statistics.median(single_walls[1:]),
                   "rowmax_launches_per_solve": launches.get(
                       open_claim.ROWMAX_KERNEL, 0),
                   "fill_launches_per_solve": launches.get(
                       open_claim.KERNEL, 0),
                   "all_reduces_per_solve": coll.get("all_reduce", 0),
                   "broadcasts_per_solve": coll.get("broadcast", 0)}
            check(row["rowmax_launches_per_solve"] == info["steps"]
                  and row["fill_launches_per_solve"] == info["steps"],
                  f"mesh_ranks {job}: {launches} over {info['steps']} "
                  f"steps")
            if job == "config4":
                native = NativeSolver(catalog, provs).solve(list(pods))
                check(res.decisions() == native.decisions(),
                      "mesh_ranks config4: decisions differ from the native "
                      "scan's")
                row["native_equal"] = True
            out[job] = row
        elif job == "config3":
            from karpenter_tpu_torch.providers.instancetypes import \
                generate_fleet_catalog

            catalog = generate_fleet_catalog()
            cluster = config3_cluster(catalog)
            prov = consolidation_provisioner()
            one = consolidate.run_consolidation(cluster, catalog, [prov])
            table = consolidate.last_verdict_table.copy()
            t0 = time.perf_counter()
            got, launches, coll = counted(
                lambda: consolidate.run_consolidation(
                    cluster, catalog, [prov], mesh=ctx.lane_mesh))
            wall = (time.perf_counter() - t0) * 1000
            check(np.array_equal(consolidate.last_verdict_table, table),
                  "mesh_ranks config3: the lane mesh's verdict table "
                  "differs from the one-shot sweep's")
            check(action_key(got) == action_key(one),
                  "mesh_ranks config3: actions differ")
            out[job] = {"lanes": int(table.shape[0]), "action": got.kind,
                        "verdicts_equal": True, "wall_ms": wall,
                        "fill_launches_per_sweep": launches.get(
                            open_claim.KERNEL, 0),
                        "all_reduces_per_sweep": coll.get("all_reduce", 0),
                        "broadcasts_per_sweep": coll.get("broadcast", 0)}
    counted(ctx.close)
    multihost.shutdown_distributed()
    out.update(launches=dict(totals["launches"]),
               collectives=dict(totals["collectives"]))
    with open(f"{spec['out']}.0", "w") as f:
        json.dump(out, f)
    return 0


def _spawn_mesh(world, jobs, label):
    """Run one mesh_ranks group through entry.spawn_ranks (a timeout for
    the group; every rank killed when one fails): -> every rank's result
    dict."""
    from karpenter_tpu_torch.entry import spawn_ranks

    os.makedirs(RESULTS_DIR, exist_ok=True)
    base = os.path.join(RESULTS_DIR, f"mesh_{label}")
    for suffix in [".store", ".json"] + [f".out.{r}" for r in range(world)]:
        if os.path.exists(base + suffix):
            os.remove(base + suffix)
    with open(base + ".json", "w") as f:
        json.dump({"world": world, "store": base + ".store", "jobs": jobs,
                   "out": base + ".out"}, f)
    try:
        spawn_ranks(lambda r: [sys.executable, os.path.abspath(__file__),
                               "--mesh-rank", base + ".json", str(r)],
                    world, lambda r: f"{base}.log.{r}")
    except RuntimeError as e:
        raise SmokeFailure(f"mesh_ranks {label}: {e}") from None
    out = []
    for r in range(world):
        with open(f"{base}.out.{r}") as f:
            out.append(json.load(f))
    return out


def run_serve_distributed(catalog, prov):
    """solver-serve --distributed with 2 ranks sharing the card, launched
    as torchrun launches them (WORLD_SIZE, RANK, LOCAL_RANK,
    LOCAL_WORLD_SIZE; the rendezvous a FileStore under port_results/),
    the shape router's crossover at 0: a Solve over gRPC is routed
    cuda-sharded over 2 devices and decodes to the direct solve's
    decisions; SIGINT stops rank 0, which stops rank 1, both exit 0."""
    import signal

    from karpenter_tpu_torch.solver import solver_pb2 as pb
    from karpenter_tpu_torch.solver import wire
    from karpenter_tpu_torch.solver.client import RemoteSolver
    from karpenter_tpu_torch.solver.core import TorchSolver

    root = os.path.dirname(os.path.abspath(__file__))
    store = os.path.join(RESULTS_DIR, "serve_distributed.store")
    if os.path.exists(store):
        os.remove(store)
    port = free_port()
    env = dict(os.environ, WORLD_SIZE="2", LOCAL_WORLD_SIZE="2",
               KARPENTER_TPU_SHARD_CROSSOVER_CELLS="0")
    logs = [open(os.path.join(RESULTS_DIR, f"serve_distributed.log.{r}"),
                 "w") for r in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, "-m", "karpenter_tpu_torch", "solver-serve",
         "--distributed", "--port", str(port), "--coordinator",
         f"file://{store}"], cwd=root,
        env=dict(env, RANK=str(r), LOCAL_RANK=str(r)), stdout=logs[r],
        stderr=subprocess.STDOUT) for r in range(2)]
    try:
        pods = mixed_workload(1000)
        client = RemoteSolver(catalog, [prov], target=f"127.0.0.1:{port}",
                              timeout=120.0)
        t0 = time.perf_counter()
        while True:
            check(all(p.poll() is None for p in procs),
                  "serve_distributed: a rank exited before serving")
            try:
                client.sync()
                break
            except Exception:  # noqa: BLE001 — not serving yet
                check(time.perf_counter() - t0 < 120,
                      "serve_distributed: no Sync in 120 s")
                time.sleep(0.5)
        boot_s = time.perf_counter() - t0
        resp = client._call("Solve", pb.SolveRequest(
            catalog_seqnum=catalog.seqnum,
            catalog_hash=client.catalog_content_hash(),
            provisioner_hash=client._prov_hash,
            pods=[wire.pod_to_wire(p) for p in pods]))
        check(resp.routing == "cuda-sharded" and resp.device_count == 2,
              f"serve_distributed: routed {resp.routing} over "
              f"{resp.device_count}")
        got = client._decode(resp, pods).decisions()
        want = TorchSolver(catalog, [prov]).solve(list(pods)).decisions()
        check(got == want, "serve_distributed: decisions differ from the "
                           "direct solve")
        procs[0].send_signal(signal.SIGINT)
        rcs = [p.wait(timeout=60) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    with open(os.path.join(RESULTS_DIR, "serve_distributed.log.0")) as f:
        desc = [line for line in f if line.startswith("distributed: ")]
    check(rcs == [0, 0] and desc, f"serve_distributed: exit codes {rcs}")
    return {"routing": resp.routing, "device_count": resp.device_count,
            "boot_to_sync_s": boot_s, "solve_ms": resp.solve_ms,
            "pods": len(pods), "decisions_equal": True,
            "description": desc[0].strip()[len("distributed: "):]}


def run_mesh_ranks(catalog, prov):
    """mesh_ranks: separate processes share the card over gloo (parity,
    not speed). A 2-rank mesh (nodes=1 x types=2) runs config 4 and config
    3's lanes on its 2-rank lane mesh; a 4-rank mesh (2 x 2) runs config 4
    and path B; then solver-serve --distributed with 2 ranks. Every rank
    counts the same launches and collectives over the mesh runs. -> the
    fill launches summed over every rank, by kernel, and rank 0's rows."""
    import importlib.util

    from karpenter_tpu_torch.ops import open_claim as oc

    launches = collections.Counter()
    rows = {}
    for world, jobs in ((2, ["config4", "config3"]),
                        (4, ["config4", "pathB"])):
        t0 = time.perf_counter()
        ranks = _spawn_mesh(world, jobs, f"{world}ranks")
        wall = time.perf_counter() - t0
        for r in ranks:
            launches.update(r["launches"])
        per_rank = [r["launches"].get(oc.ROWMAX_KERNEL, 0) for r in ranks]
        fill_per_rank = [r["launches"].get(oc.KERNEL, 0) for r in ranks]
        check(min(per_rank) > 0, f"mesh_ranks {world}: a rank never "
                                 f"launched the row-max mode")
        head = ranks[0]
        for r in ranks[1:]:
            check(r["launches"] == head["launches"]
                  and r["collectives"] == head["collectives"],
                  f"mesh_ranks {world}: rank {r['rank']} counted "
                  f"{r['launches']} {r['collectives']}, rank 0's mesh runs "
                  f"{head['launches']} {head['collectives']}")
        rows[world] = head
        for job in jobs:
            phase(f"mesh_ranks_{world}_{job}", label="ranks_sharing_one_card:"
                  "_parity,_not_speed", world=world,
                  **{k: (f"{v:.3f}" if isinstance(v, float) else v)
                     for k, v in head[job].items()})
        phase(f"mesh_ranks_{world}", ranks=world, group_seconds=f"{wall:.1f}",
              rowmax_launches_per_rank=per_rank,
              fill_launches_per_rank=fill_per_rank,
              collectives_rank0=json.dumps(head["collectives"]).replace(
                  " ", ""))
    serve = {"skipped": "grpcio missing"}
    if importlib.util.find_spec("grpc") is not None:
        serve = run_serve_distributed(catalog, prov)
    phase("mesh_ranks_serve_distributed",
          **{k: (f"{v:.3f}" if isinstance(v, float) else
                 str(v).replace(" ", "")) for k, v in serve.items()})
    return {"launches": dict(launches), "rows": rows, "serve": serve}


ENTRY_TIMED = 5
DRYRUN_RANKS = 8


def run_entry(torch, LAUNCHES):
    """entry: the driver's single-card callable on the card, its PackResult
    equal field for field to entry(device="cpu")'s. Counts from 0 just
    before the first call and read just after it. -> its launches."""
    from karpenter_tpu_torch.entry import entry
    from karpenter_tpu_torch.ops import open_claim, quotient
    from karpenter_tpu_torch.ops.packer import n_eff_of

    fn, args = entry()
    steps = n_eff_of(args[0].group_count.cpu().numpy())
    LAUNCHES.reset()
    got = fn(*args)
    torch.cuda.synchronize()
    launches = LAUNCHES.take()
    fn_cpu, args_cpu = entry(device="cpu")
    want = fn_cpu(*args_cpu)
    for field in got._fields:
        check(torch.equal(getattr(got, field).cpu(), getattr(want, field)),
              f"entry: {field} on the card differs from device='cpu'")
    check(launches.get(open_claim.KERNEL, 0) == 2 * steps
          and launches.get(quotient.KERNEL, 0) == 0,
          f"entry: {launches} over {steps} steps")
    walls = []
    for _ in range(ENTRY_TIMED):
        t0 = time.perf_counter()
        fn(*args)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1000)
    phase("entry", assign_sum=int(got.assign.sum()), steps=steps,
          fill_launches=launches.get(open_claim.KERNEL, 0),
          bit_equal_cpu=True,
          median_wall_ms=f"{statistics.median(walls):.3f}")
    return launches


def run_dryrun(world=DRYRUN_RANKS):
    """dryrun_multichip_8: karpenter_tpu_torch.entry.dryrun_multichip over
    `world` ranks sharing the card (parity, not speed); its four checks run
    on rank 0, and a failing one raises. Then, here, the mesh's PackResult
    against the plain fill's (the single-device pack on the CPU) of the
    same padded problem, field for field; both launches of the split fill
    against their plain halves at one rank's slice of config 4; and the
    lane fill against its plain version at one rank's lanes of the sweep.
    -> its result dict, with those checks' max |diff|."""
    import numpy as np
    import torch

    from karpenter_tpu_torch.apis import wellknown as wk
    from karpenter_tpu_torch.entry import (_pack_one, dryrun_multichip,
                                           pad_inputs, stress_problem)
    from karpenter_tpu_torch.models.encode import encode_problem
    from karpenter_tpu_torch.ops import consolidate, quotient
    from karpenter_tpu_torch.ops import open_claim as oc
    from karpenter_tpu_torch.ops.packer import (PackResult, n_eff_of,
                                                pack_inputs_from_numpy)

    d = dryrun_multichip(world)
    check(d["device"] == "cuda", f"dryrun ran on {d['device']}")
    check(d["placed"] == d["pods_total"] == 50_000 and d["unsched"] == 0,
          f"dryrun placed {d['placed']} of {d['pods_total']}")
    check(d["candidates"] == 4 * world + 1,
          f"dryrun swept {d['candidates']} candidates")
    # each rank's launches over its mesh runs (the pack and the lane sweep)
    counts = [dict(collections.Counter(r["pack"]) + collections.Counter(
        r["lanes"])) for r in d["launches_per_rank"]]
    check(all(c == counts[0] for c in counts)
          and counts[0].get(oc.ROWMAX_KERNEL, 0) > 0
          and counts[0].get(oc.KERNEL, 0) > 0
          and counts[0].get(quotient.KERNEL, 0) == 0
          and set(counts[0]) == {oc.ROWMAX_KERNEL, oc.KERNEL},
          f"dryrun launches per rank: {counts}")
    catalog, provisioners, pods = stress_problem(d["pods_total"])
    enc = encode_problem(catalog, provisioners, pods, grid=None)
    inputs, n_slots = pad_inputs(enc)
    t0 = time.perf_counter()
    plain = _pack_one(pack_inputs_from_numpy(inputs._asdict(),
                                             torch.device("cpu")),
                      n_slots, n_eff_of(inputs.group_count))
    plain_ms = (time.perf_counter() - t0) * 1e3
    for field in PackResult._fields:
        a, b = d["result"][field], getattr(plain, field).numpy()
        check(a.shape == b.shape and np.array_equal(a, b),
              f"dryrun: the mesh's {field} differs from the plain fill's "
              f"single-device pack on the CPU")
    # one rank's slice: its nodes' share of the slots, its types' share of
    # the type-padded catalog; every provisioner plane, no pods cap
    T, R = enc.alloc_t.shape
    _, Pv, _, S = enc.group_feas.shape
    nodes, types = d["axes"]["nodes"], d["axes"]["types"]
    N_rank, T_rank = n_slots // nodes, -(-T // types)
    rowmax_err, _ = check_rowmax(torch, oc, "dryrun_rank", open_claim_case(
        torch, N_rank, T_rank, S, R, Pv, False, seed=N_rank + T_rank,
        rem=37 * N_rank))
    # one rank's lanes of the sweep: the candidates padded to the ranks,
    # consolidate.N_SLOTS slots a lane, one alloc shared by every lane
    L_rank = -(-d["candidates"] // world)
    case = lane_case(torch, L_rank, consolidate.N_SLOTS, T, S,
                     wk.NUM_RESOURCES, len(provisioners), True, False,
                     seed=L_rank)
    lane_err = 0
    for name, g, w in zip(("m", "optmask", "used", "rem"),
                          run_open_claim_kernel(torch, oc, case),
                          oc.open_claim_fill_reference(**case)):
        lane_err = max(lane_err, int((g.long() - w.long()).abs().max()))
        check(torch.equal(g, w), f"dryrun: the lane fill's {name} differs "
                                 f"from its plain version at L={L_rank}")
    phase("dryrun_multichip_8", label="ranks_sharing_one_card:"
          "_parity,_not_speed", ranks=world,
          mesh=json.dumps(d["axes"]).replace(" ", ""),
          placed=f"{d['placed']}/{d['pods_total']}", nodes=d["nodes"],
          bit_equal_single_card=True, bit_equal_plain_cpu=True,
          plain_cpu_pack_ms=f"{plain_ms:.3f}",
          rank_fill_shape=f"N{N_rank}xT{T_rank}xS{S}xR{R}xPv{Pv}",
          rank_split_max_abs_err=rowmax_err,
          rank_lane_shape=f"L{L_rank}xN{consolidate.N_SLOTS}xT{T}xS{S}"
                          f"xR{wk.NUM_RESOURCES}xPv{len(provisioners)}",
          rank_lane_max_abs_err=lane_err,
          native_decisions=d["native_decisions"],
          oracle_pods=d["oracle_pods"],
          oracle_decisions=d["oracle_decisions"],
          candidates=d["candidates"], action=d["action"],
          rank0_pack_wall_ms=f"{d['wall_ms']:.3f}",
          rank0_lanes_wall_ms=f"{d['lanes_wall_ms']:.3f}",
          **{f"rank0_{k}_ms": f"{v:.3f}" for k, v in d["check_ms"].items()},
          group_seconds=f"{d['group_s']:.1f}",
          rowmax_launches_per_rank=json.dumps(
              [c[oc.ROWMAX_KERNEL] for c in counts]).replace(" ", ""),
          fill_launches_per_rank=json.dumps(
              [c[oc.KERNEL] for c in counts]).replace(" ", ""),
          pack_launches_rank0=json.dumps(
              d["launches_per_rank"][0]["pack"]).replace(" ", ""),
          lanes_launches_rank0=json.dumps(
              d["launches_per_rank"][0]["lanes"]).replace(" ", ""),
          collectives_rank0=json.dumps(d["collectives_rank0"]).replace(
              " ", ""))
    d.update(counts=counts, rowmax_err=rowmax_err, lane_err=lane_err)
    return d


AB_PATH_A_RUNS = 3
_AB_PATH_A = f"""
import os, sys
sys.path.insert(0, os.getcwd())
import chip_smoke as smoke
from karpenter_tpu_torch.device import LAUNCHES
from karpenter_tpu_torch.ops import _build, open_claim, quotient
from karpenter_tpu_torch.providers.instancetypes import generate_fleet_catalog
from karpenter_tpu_torch.solver.core import TorchSolver
_build.build()
catalog = generate_fleet_catalog()
for _ in range({AB_PATH_A_RUNS}):
    smoke.run_path("pathA", catalog, smoke.provisioner(),
                   smoke.mixed_workload(10_000), (), LAUNCHES, TorchSolver,
                   open_claim.KERNEL, quotient.KERNEL)
"""


def run_ab_path_a(dirs) -> int:
    """`--ab-path-a DIR...`: path A in each checkout, in the order given,
    each in a process of its own. -> the first non-zero exit code, or 0."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 2
    print(nvidia_smi_line(), flush=True)
    for d in dirs:
        print(d, flush=True)
        r = subprocess.run([sys.executable, "-c", _AB_PATH_A], cwd=d,
                           capture_output=True, text=True, timeout=900)
        for line in r.stdout.splitlines():
            if line.startswith("[pathA]"):
                print(line, flush=True)
        if r.returncode:
            print(r.stderr[-3000:], file=sys.stderr)
            return r.returncode
    return 0


def run_slice(torch, LAUNCHES, TorchSolver) -> int:
    """`--slice`: paths A and B, A's profile and the profiler and mesh
    phases only, for a short check of the newest phases. Prints no result
    line: only a run without arguments is the smoke."""
    from karpenter_tpu_torch.providers.instancetypes import generate_fleet_catalog

    catalog = generate_fleet_catalog()
    prov = provisioner()
    pods_a = mixed_workload(10_000)
    info = {}
    for label, pods, ex in (("pathA", pods_a, ()),
                            ("pathB", mixed_5k_pods(),
                             existing_nodes(catalog))):
        solver = TorchSolver(catalog, [prov])
        solver.solve(list(pods), existing=copy_existing(ex))
        info[label] = solver.last_solve_info
    prof_a = profile_solve(torch, "A", catalog, prov, pods_a, (), TorchSolver)
    check(prof_a is not None, "profile A recorded no device events")
    run_profiler(torch, catalog, prov, pods_a, prof_a["device_busy_ms"])
    run_mesh_1(torch, catalog, prov, pods_a, info["pathA"], info["pathB"],
               LAUNCHES)
    run_mesh_ranks(catalog, prov)
    run_entry(torch, LAUNCHES)
    run_dryrun()
    phase("slice", ok=True)
    return 0


def main(argv=()) -> int:
    quick = "--slice" in argv
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from karpenter_tpu_torch.device import LAUNCHES
        from karpenter_tpu_torch.ops import _build, consolidate, open_claim, quotient
        from karpenter_tpu_torch.oracle.scheduler import Scheduler
        from karpenter_tpu_torch.providers.instancetypes import generate_fleet_catalog
        from karpenter_tpu_torch.solver.core import NativeSolver, TorchSolver
    except ImportError as e:
        print(f"chip_smoke: karpenter_tpu_torch is not importable here: {e}",
              file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    try:
        smi = nvidia_smi_line()
        kind = torch.cuda.get_device_name(0)
        print(smi, flush=True)
        phase("device", torch_name=repr(kind),
              count=torch.cuda.device_count(), torch=torch.__version__,
              cuda=torch.version.cuda)

        secs = _build.build()
        phase("build", seconds=f"{secs:.2f}",
              kernels=",".join(sorted(_build.BUILD_LOGS)) or "cached")
        for name, log in sorted(_build.BUILD_LOGS.items()):
            regs = [int(w.split()[0]) for w in log.split("Used ")[1:]]
            spills = sum(" 0 bytes spill stores" not in line
                         for line in log.splitlines() if "spill stores" in line)
            phase("ptxas", kernel=name, instantiations=len(regs),
                  registers=f"{min(regs, default=0)}-{max(regs, default=0)}",
                  spilling_instantiations=spills)

        if quick:
            return run_slice(torch, LAUNCHES, TorchSolver)
        if "--pack-graph" in argv:
            run_pack_graph(torch, LAUNCHES, open_claim.KERNEL)
            phase("pack_graph_only", ok=True)
            return 0
        k1_rows, k1_err = run_k1(torch, quotient)
        oc_err = run_open_claim(torch, open_claim)

        catalog = generate_fleet_catalog()
        check(len(catalog.types) == 603, "fleet catalog must hold 603 types")
        prov = provisioner()
        pods_a = mixed_workload(10_000)
        pods_b = mixed_5k_pods()
        ex_b = existing_nodes(catalog)
        OC, K1 = open_claim.KERNEL, quotient.KERNEL

        # the main path: each path's launch counts from 0 just before it
        path_launches = {}
        # each path's packs by way, taken after it (pack_graph_ways)
        ways = [("start", pack_graph_ways())]
        LAUNCHES.reset()
        info_a = run_path("pathA", catalog, prov, pods_a, (), LAUNCHES,
                          TorchSolver, OC, K1)
        path_launches["A"] = {k: LAUNCHES.get(k) for k in (OC, K1)}
        ways.append(("pathA", pack_graph_ways()))
        LAUNCHES.reset()
        info_b = run_path("pathB", catalog, prov, pods_b, ex_b, LAUNCHES,
                          TorchSolver, OC, K1)
        path_launches["B"] = {k: LAUNCHES.get(k) for k in (OC, K1)}
        ways.append(("pathB", pack_graph_ways()))
        info_c, path_launches["C"], problems_c = run_path_c(
            catalog, prov, LAUNCHES, TorchSolver, OC, K1)
        info_d, path_launches["D"], cluster_d, prov_d = run_path_d(
            catalog, LAUNCHES, consolidate, OC, K1)
        config5_launches = run_config5(LAUNCHES, consolidate, OC)
        ways.append(("paths_c_d_config5", pack_graph_ways()))
        for path, counts in path_launches.items():
            check(counts[OC] > 0, f"the open-claim kernel was never launched "
                                  f"on path {path}")
            check(counts[K1] == 0, f"path {path} launched the standalone K1")
        # the controllers: each reconcile's counts start at 0 just before it
        ctrl_row, ctrl_med = run_ctrl_provision(
            catalog, lambda: mixed_workload(10_000), LAUNCHES, OC, K1)
        path_launches["ctrl_provision"] = {OC: ctrl_row["launches"], K1: 0}
        ways.append(("ctrl_provision", pack_graph_ways()))
        cons_launches, _ = run_ctrl_consolidate(torch, LAUNCHES, OC, K1,
                                                consolidate)
        path_launches["ctrl_consolidate"] = {OC: cons_launches, K1: 0}
        ways.append(("ctrl_consolidate", pack_graph_ways()))
        inc = run_ctrl_incremental(catalog, LAUNCHES, OC, K1)
        path_launches["ctrl_incremental"] = {OC: sum(inc["launches"]), K1: 0}
        ways.append(("ctrl_incremental", pack_graph_ways()))
        op_row, _, op_inter_launches, op_machines = run_ctrl_operator(
            catalog, lambda: mixed_workload(10_000), LAUNCHES, OC, K1)
        path_launches["ctrl_operator"] = {OC: op_row["launches"], K1: 0}
        ways.append(("ctrl_operator", pack_graph_ways()))
        storm_row, _ = run_ctrl_spot_storm(
            catalog, lambda: mixed_workload(10_000), op_machines, LAUNCHES,
            OC)
        path_launches["ctrl_spot_storm"] = {OC: storm_row["launches"], K1: 0}
        ways.append(("ctrl_spot_storm", pack_graph_ways()))
        served_row = run_ctrl_served(
            catalog, lambda: mixed_workload(10_000), LAUNCHES, OC, K1)
        path_launches["ctrl_served"] = {OC: served_row["launches"], K1: 0}
        ways.append(("ctrl_served", pack_graph_ways()))
        LAUNCHES.reset()
        svc_row = run_service(torch, catalog, prov, pods_a, LAUNCHES, OC,
                              K1, TorchSolver)
        path_launches["service"] = {
            OC: svc_row["solves"] + svc_row["consolidate"]
            + svc_row["wire"]["solves"] + svc_row["wire"]["consolidate"],
            K1: 0}
        ways.append(("service", pack_graph_ways()))
        run_cli_boot()
        run_pack_graph(torch, LAUNCHES, OC)
        ways.append(("pack_graph", pack_graph_ways()))
        # the fleet and the chaos drills: counts from 0 just before each
        LAUNCHES.reset()
        fleet_row = run_fleet(torch, catalog, prov, problems_c,
                              info_c["open_claim_launches"], LAUNCHES, OC,
                              K1, TorchSolver)
        path_launches["fleet"] = {OC: fleet_row["total"], K1: LAUNCHES.get(K1)}
        ways.append(("fleet", pack_graph_ways()))
        fleet_want = TorchSolver(catalog, [prov]).solve_many(problems_c)
        LAUNCHES.reset()
        wire_row = run_fleet_wire(catalog, prov, problems_c, fleet_want,
                                  LAUNCHES, OC)
        path_launches["fleet_wire"] = {OC: wire_row["solves"],
                                       K1: LAUNCHES.get(K1)}
        ways.append(("fleet_wire", pack_graph_ways()))
        replicas_row = run_fleet_replicas(LAUNCHES, OC)
        path_launches["fleet_replicas"] = {
            OC: replicas_row["launches"].get(OC, 0),
            K1: replicas_row["launches"].get(K1, 0)}
        chaos_row = run_chaos(LAUNCHES, OC)
        path_launches["chaos"] = {OC: sum(chaos_row.values()),
                                  K1: LAUNCHES.get(K1)}
        ways.append(("chaos", pack_graph_ways()))
        storm_launches = run_chaos_spot_storm(LAUNCHES, OC)
        path_launches["chaos_spot_storm"] = {OC: storm_launches,
                                             K1: LAUNCHES.get(K1)}
        ways.append(("chaos_spot_storm", pack_graph_ways()))
        report_pack_graph_ways(ways)
        wire_paths = (("fleet_wire", "fleet_replicas")
                      if wire_row["solves"] else ())
        for path in ("ctrl_provision", "ctrl_consolidate", "ctrl_incremental",
                     "ctrl_operator", "ctrl_spot_storm", "ctrl_served",
                     "service", "fleet", "chaos", "chaos_spot_storm",
                     *wire_paths):
            check(path_launches[path][OC] > 0,
                  f"the open-claim kernel was never launched on {path}")
            check(path_launches[path][K1] == 0,
                  f"{path} launched the standalone K1")
        run_native_vs_card(catalog, prov, TorchSolver, NativeSolver)
        # after the paths: its 996-lane cases churn about a gigabyte of
        # device memory, which paths A and B are timed without
        lanes_err = run_open_claim_lanes(torch, open_claim)

        prof_a = profile_solve(torch, "A", catalog, prov, pods_a, (),
                               TorchSolver)
        profile_solve(torch, "B", catalog, prov, pods_b, ex_b, TorchSolver)
        wave_solver = TorchSolver(catalog, [prov])
        profile_run(torch, "C", lambda: wave_solver.solve_many(problems_c))
        profile_run(torch, "D", lambda: consolidate.run_consolidation(
            cluster_d, catalog, [prov_d]))

        # K1 at path A's own shape: its claim-slot bucket and resource width
        slots_a, fields_w = info_a["slots"], info_a["res_width"]
        a_np, u_np, v_np = k1_inputs(slots_a, 603, fields_w, seed=1)
        dev = torch.device("cuda")
        alloc = quotient.type_major(torch.from_numpy(a_np).to(dev))
        used = torch.from_numpy(u_np).to(dev)
        vec = torch.from_numpy(v_np).to(dev)
        check(torch.equal(quotient.quotient_nt(alloc, used, vec),
                          quotient.quotient_nt_reference(alloc, used, vec)),
              "K1 differs from its plain version at path A's shape")
        k1_ms = device_ms(lambda: quotient.quotient_nt(alloc, used, vec))
        k1_plain = device_ms(
            lambda: quotient.quotient_nt_reference(alloc, used, vec))
        k1_bound, k1_by = k1_bound_ms(slots_a, 603, fields_w)
        phase("k1_pathA_shape", N=slots_a, T=603, R=fields_w,
              ms=f"{k1_ms:.5f}", plain_ms=f"{k1_plain:.5f}",
              bound_ms=f"{k1_bound:.6f}", bound_by=k1_by, library_ms="null",
              library_note="no_single_pytorch_call_computes_this_min_of_"
                           "floored_quotients_with_its_zero_demand_and_"
                           "negative_availability_rules")
        oc_rows = [time_open_claim(
            torch, open_claim, quotient, label,
            open_claim_case(torch, info["slots"], 603, 6, info["res_width"],
                            1, False, seed=info["slots"] + info["res_width"],
                            rem=37 * info["slots"]))
            for label, info in (("pathA", info_a), ("pathB", info_b))]
        wave_c = info_c["waves"][0]
        slots_c = int(wave_c["bucket"].split("n")[1].split("e")[0])
        # the lane fill at D's shape (996 lanes x N_SLOTS, full width, one
        # shared catalog) and C's (16 lanes x the wave's slots, compressed
        # width, each lane its own catalog columns), on synthetic states with
        # most rows' claims open; path D itself never reaches such a state
        # (its one pack step fills before it opens a claim), so D's shape is
        # also timed on the state it does reach, every row inactive
        case_d = lane_case(torch, info_d["lanes"], consolidate.N_SLOTS, 603,
                           6, 11, 1, True, False, seed=901)
        oc_rows.append(time_open_claim(torch, open_claim, quotient, "pathD",
                                       case_d))
        oc_rows.append(time_open_claim(
            torch, open_claim, quotient, "pathD_reached",
            dict(case_d, active=torch.zeros_like(case_d["active"]))))
        oc_rows.append(time_open_claim(
            torch, open_claim, quotient, "pathC",
            lane_case(torch, wave_c["lanes"], slots_c, 603, 6,
                      wave_c["res_width"], 1, False, False, seed=902)))

        # the continuous profiler and the mesh: counts from 0 just before
        # each mesh run and read just after (mesh_1's solve in this
        # process; in mesh_ranks each run of rank 0, whose sum every
        # follower's whole count equals, summed over the ranks)
        check(prof_a is not None, "profile A recorded no device events")
        run_profiler(torch, catalog, prov, pods_a, prof_a["device_busy_ms"])
        mesh1 = run_mesh_1(torch, catalog, prov, pods_a, info_a, info_b,
                           LAUNCHES)
        ranks = run_mesh_ranks(catalog, prov)
        # the driver's entry points: entry()'s counts from 0 just before
        # its first call; the dry run's per rank, each mesh run from 0
        entry_launches = run_entry(torch, LAUNCHES)
        dry = run_dryrun()
        RM = open_claim.ROWMAX_KERNEL
        path_launches["mesh_1"] = {OC: mesh1["launches"][OC], K1: 0}
        path_launches["mesh_ranks"] = {OC: ranks["launches"].get(OC, 0),
                                       K1: ranks["launches"].get(K1, 0)}
        path_launches["entry"] = {OC: entry_launches.get(OC, 0),
                                  K1: entry_launches.get(K1, 0)}
        path_launches["dryrun_multichip_8"] = {
            k: sum(c.get(k, 0) for c in dry["counts"]) for k in (OC, K1)}
        rowmax_launches = {"mesh_1": mesh1["launches"][RM],
                           "mesh_ranks": ranks["launches"].get(RM, 0),
                           "dryrun_multichip_8": sum(
                               c[RM] for c in dry["counts"])}

        def per_rank(job, key):
            """One rank's count in one mesh run of `job`, by rank count."""
            return {f"{w}ranks": row[job][key]
                    for w, row in ranks["rows"].items() if job in row}
        for path in ("mesh_1", "mesh_ranks", "dryrun_multichip_8"):
            check(path_launches[path][OC] > 0 and rowmax_launches[path] > 0,
                  f"the split fill was never launched on {path}")
            check(path_launches[path][K1] == 0,
                  f"{path} launched the standalone K1")
        check(path_launches["entry"][OC] > 0
              and path_launches["entry"][K1] == 0,
              f"entry launched {entry_launches}")

        inflate_catalog = generate_fleet_catalog(max_types=20)
        from karpenter_tpu_torch.apis.provisioner import Provisioner
        from karpenter_tpu_torch.models.pod import make_pod

        p0 = Provisioner(name="default")
        p0.set_defaults()
        inflate = [make_pod(f"inflate-{i}", cpu="1", memory="1536Mi")
                   for i in range(100)]
        got = TorchSolver(inflate_catalog, [p0]).solve(inflate).decisions()
        sched = Scheduler(inflate_catalog, [p0])
        want = sched.schedule(inflate).node_decisions(sched.options)
        check(got == want, f"inflate decisions differ from the oracle: "
                           f"{got} vs {want}")
        phase("parity", case="inflate-100x20types", nodes=len(got),
              oracle_equal=True)

        oc_a = oc_rows[0]
        record = {"kernels": [{
            "name": "open_claim_fill",
            "route": "cuda",
            "source": "karpenter_tpu_torch/csrc/open_claim.cu",
            "replaces": "karpenter_tpu/ops/pallas_kernels.py:101",
            "launches": sum(c[OC] for c in path_launches.values()),
            "launches_by_path": {k: c[OC] for k, c in path_launches.items()},
            "launches_path_a_per_solve": info_a["open_claim_launches"],
            "launches_path_b_per_solve": info_b["open_claim_launches"],
            "launches_path_c_per_wave": info_c["open_claim_launches"],
            "launches_path_d_per_sweep": info_d["open_claim_launches"],
            "launches_config5_sweep": config5_launches,
            "launches_ctrl_provision_per_reconcile": ctrl_row["launches"],
            "launches_ctrl_consolidate_per_pass": cons_launches,
            "launches_ctrl_incremental_per_cycle": inc["launches"],
            "launches_ctrl_operator_per_pass": op_row["launches"],
            "launches_ctrl_operator_interruption_passes": op_inter_launches,
            "launches_ctrl_spot_storm_per_reconcile": storm_row["launches"],
            "ctrl_spot_storm_routed_solves": len(storm_row["solves"]),
            "launches_ctrl_served_per_pass": served_row["launches"],
            "launches_service_per_solve": svc_row["solve_launches"],
            "launches_service_consolidate": svc_row["consolidate"],
            "launches_service_wire_solves": svc_row["wire"]["solves"],
            "launches_fleet_per_mega_solve": fleet_row["per_mega_solve"],
            "launches_fleet_64_tenants": fleet_row["tenants64"],
            "launches_fleet_wire": wire_row["solves"],
            "launches_fleet_replicas_survivor_window":
                path_launches["fleet_replicas"][OC],
            "launches_chaos_sweep": chaos_row["sweep"],
            "launches_chaos_crash": chaos_row["crash"],
            "launches_chaos_spot_storm": storm_launches,
            "launches_mesh_1_per_solve": mesh1["launches"][OC],
            "launches_mesh_ranks_config4_per_solve_per_rank": per_rank(
                "config4", "fill_launches_per_solve"),
            "launches_mesh_ranks_pathB_per_solve_per_rank": per_rank(
                "pathB", "fill_launches_per_solve"),
            "launches_mesh_ranks_config3_per_sweep_per_rank": per_rank(
                "config3", "fill_launches_per_sweep"),
            "launches_entry": path_launches["entry"][OC],
            "launches_dryrun_per_rank": [c[OC] for c in dry["counts"]],
            "max_abs_err": max(oc_err, lanes_err, dry["rowmax_err"],
                               dry["lane_err"]),
            "ms": oc_a["ms"],
            "plain_ms": oc_a["plain_ms"],
            "bound_ms": oc_a["bound_ms"],
            "bound_by": oc_a["bound_by"],
            "library_ms": None,
            "k1_sequence_ms": oc_a["k1_sequence_ms"],
            "shapes": oc_rows,
        }, {
            "name": "open_claim_rowmax",
            "route": "cuda",
            "source": "karpenter_tpu_torch/csrc/open_claim.cu",
            "replaces": "karpenter_tpu/ops/pallas_kernels.py:101",
            "launches": sum(rowmax_launches.values()),
            "launches_by_path": rowmax_launches,
            "launches_mesh_1_per_solve": mesh1["launches"][RM],
            "launches_mesh_ranks_config4_per_solve_per_rank": per_rank(
                "config4", "rowmax_launches_per_solve"),
            "launches_mesh_ranks_pathB_per_solve_per_rank": per_rank(
                "pathB", "rowmax_launches_per_solve"),
            "launches_entry": entry_launches.get(RM, 0),
            "launches_dryrun_per_rank": [c[RM] for c in dry["counts"]],
            "max_abs_err": max(mesh1["max_abs_err"], dry["rowmax_err"]),
            "ms": mesh1["rows"]["pathA"]["ms"],
            "plain_ms": mesh1["rows"]["pathA"]["plain_ms"],
            "bound_ms": mesh1["rows"]["pathA"]["bound_ms"],
            "bound_by": mesh1["rows"]["pathA"]["bound_by"],
            "library_ms": None,
            "shapes": mesh1["rows"],
        }, {
            "name": "quotient_nt",
            "route": "cuda",
            "source": "karpenter_tpu_torch/csrc/quotient.cu",
            "replaces": "karpenter_tpu/ops/pallas_kernels.py:101",
            "launches": sum(c[K1] for c in path_launches.values()),
            "launches_path_a_per_solve": 0,
            "launches_path_b_per_solve": 0,
            "launches_path_c_per_wave": 0,
            "launches_path_d_per_sweep": 0,
            "launches_ctrl_provision_per_reconcile": 0,
            "launches_ctrl_consolidate_per_pass": 0,
            "launches_ctrl_incremental_per_cycle": 0,
            "launches_ctrl_operator_per_pass": 0,
            "launches_ctrl_spot_storm_per_reconcile": 0,
            "launches_ctrl_served_per_pass": 0,
            "launches_service_per_solve": 0,
            "launches_fleet_per_mega_solve": 0,
            "launches_chaos_spot_storm": 0,
            "launches_entry": path_launches["entry"][K1],
            "launches_dryrun_per_rank": [c.get(K1, 0)
                                         for c in dry["counts"]],
            "max_abs_err": k1_err,
            "ms": k1_ms,
            "plain_ms": k1_plain,
            "bound_ms": k1_bound,
            "bound_by": k1_by,
            "library_ms": None,
            "shape": {"N": slots_a, "T": 603, "R": fields_w},
            "shapes": k1_rows,
        }]}
        phase("done", seconds=f"{time.perf_counter() - t_start:.1f}")
        print(smi, flush=True)
        print(json.dumps(record), flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind,
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    except Exception as e:  # noqa: BLE001 — report any phase's failure
        traceback.print_exc()
        print(f"chip_smoke: FAILED: {type(e).__name__}: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    if len(sys.argv) == 4 and sys.argv[1] == "--mesh-rank":
        sys.exit(mesh_rank_main(sys.argv[2], int(sys.argv[3])))
    if len(sys.argv) > 2 and sys.argv[1] == "--ab-path-a":
        sys.exit(run_ab_path_a(sys.argv[2:]))
    sys.exit(main(sys.argv[1:]))
