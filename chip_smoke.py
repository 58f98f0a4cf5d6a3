#!/usr/bin/env python3
"""Drive the PyTorch port's provisioning solve on one CUDA card.

    python3 chip_smoke.py

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
             widths;
5. path A  — the north-star solve: the real 603-type catalog, 10k pending
             pods in the 8-deployment headline mix, one spot+on-demand
             provisioner; one warm-up solve, then 5 timed solves;
6. path B  — 5k mixed pods with hostname anti-affinity and zone spread over
             3 zones, plus 64 partly used existing nodes of catalog types;
7. profile — one solve of each path under torch.profiler: kernels per
             solve, device busy time and idle share;
8. timing  — K1 and the open-claim fill at path A's and path B's shapes:
             each launch's device ms, their sum, the byte bound, the plain
             version and the sequence the fill replaced (K1 plus the step-2
             tensor code), all as medians of CUDA-graph replays; and the
             host time per call (enqueue) of the fill and of that sequence;
9. parity  — decisions equal the scalar oracle on the 100-pod inflate case
             over 20 catalog types.

Paths A and B check that every node's used vector fits its decided type,
that packed plus unschedulable equals the input pods, that the open-claim
kernel's launch count rose by at least twice the solve's pack steps while
the standalone K1 was not launched, and that the flat result buffer equals
the same solve run with device="cpu", bit for bit.

The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}. Any failure exits non-zero without that
line, as does a machine with no CUDA device.
"""

from __future__ import annotations

import itertools
import json
import os
import statistics
import subprocess
import sys
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


def mixed_workload(n: int) -> list:
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
            pods.append(make_pod(f"{name}-{i}", cpu=cpu, memory=mem,
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
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
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
    made from `seed`: a fifth of the rows inactive with stale masks, an
    active row with no feasible option, rows landing exactly on and one
    below a multiple of the demand, a row with negative availability, a
    row whose alloc - used wraps in int32, capacities and usage from 1 up
    to INT_BIG, and pods column 0 (the compressed layout's)."""
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
        "alloc_t": quotient.type_major(torch.from_numpy(alloc)),
        "vec": torch.from_numpy(vec),
        "cap": torch.tensor(INT_BIG if seed % 2 else 97, dtype=torch.int32),
        "feas": torch.from_numpy(rng.random((Pv, T, S)) < 0.6),
        "og": torch.tensor([1], dtype=torch.int64),
        "claim_placed": torch.from_numpy(
            rng.integers(0, 4, size=(3, N)).astype(np.int32)),
        "prov_pods_cap": (torch.from_numpy(
            rng.integers(0, 250, size=(Pv, T)).astype(np.int32))
            if pods_cap else None),
        "pods_i": 0,
        "used": torch.from_numpy(used.astype(np.int32)),
        "optmask": torch.from_numpy(optmask),
        "nprov": torch.from_numpy(nprov.astype(np.int32)),
        "active": torch.from_numpy(active),
        "rem": torch.tensor(rem, dtype=torch.int32),
    }
    dev = torch.device("cuda")
    return {k: v.to(dev) if isinstance(v, torch.Tensor) else v
            for k, v in case.items()}


def run_open_claim_kernel(torch, oc, case):
    """Both launches on copies of the case's state, with a fresh workspace
    that must come back zeroed: -> (m, optmask, used, rem)."""
    used, optmask = case["used"].clone(), case["optmask"].clone()
    N = used.shape[0]
    ws = oc.open_claim_workspace(N, used.device)
    m = torch.empty((N,), dtype=torch.int32, device=used.device)
    rem_out = torch.empty((), dtype=torch.int32, device=used.device)
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
                left_over += int(want[3]) > 0
    torch.cuda.synchronize()
    check(left_over > 0, "no case had rem above the total fill")
    phase("open_claim", cases=cases, shapes=len(OPEN_CLAIM_SHAPES),
          rem_above_fill_cases=left_over, exact=True, max_abs_err=worst)
    return worst


def open_claim_bound_ms(case, m):
    """The larger of the fill's bytes over the memory rate and its
    divisions over the CUDA-core rate, counting what this state needs. An
    inactive row's outputs (m = 0, used and mask unchanged) depend on its
    `active` byte alone, so only active rows' mask, used, nprov and
    claim_placed entries are read, with the feasibility and pods-cap planes
    that active rows use and the alloc columns of demanded resources; one
    division per demanded resource for each active (n, t) with a feasible
    option; m and rem written, and placed rows' mask and demanded used
    entries."""
    N, R = case["used"].shape
    _, T, S = case["optmask"].shape
    active, vec = case["active"], case["vec"]
    Pv = case["feas"].shape[0]
    pods_cap = case["prov_pods_cap"] is not None \
        and int(vec[case["pods_i"]]) > 0
    n_act = int(active.sum())
    demanded = int((vec > 0).sum())
    placed = int((m > 0).sum())
    nprov0 = case["nprov"].clamp(min=0).long()
    planes = 1 if Pv == 1 else int(nprov0[active].unique().numel())
    feas_n = case["feas"][0][None] if Pv == 1 else case["feas"][nprov0]
    pairs = int((case["optmask"] & feas_n & active[:, None, None])
                .any(dim=-1).sum())
    nbytes = (T * demanded * 4                         # alloc columns
              + R * 4 + 4 + 8 + 4 + N                  # vec cap og rem active
              + n_act * (T * S + demanded * 4 + 4)     # mask used claim_placed
              + (n_act * 4 if Pv > 1 or pods_cap else 0)        # nprov
              + (planes * T * S if n_act else 0)                # feas
              + (planes * T * 4 if pods_cap and n_act else 0)   # pods cap
              + N * 4 + 4 + placed * (T * S + demanded * 4))    # written
    b = nbytes / HBM_BYTES_PER_S * 1e3
    o = pairs * (demanded + pods_cap) / CUDA_CORE_OPS_PER_S * 1e3
    return max(b, o), ("bytes" if b >= o else "operations")


def time_open_claim(torch, oc, quotient, label, N, R):
    """The open-claim fill at a path's shape (T = 603, S = 6, Pv = 1, no
    pods cap, as on paths A and B): each launch's device time, their sum,
    the bound, the plain version, the sequence the fill replaced (K1 plus
    the step-2 tensor code), and the host time per call of the wrapper and
    of that sequence. Each timed call of launch 1 runs on its own copy of
    the checked state's used rows, restored before every replay, so it
    does the checked call's work and must give its outputs. Launch 2 is
    timed on the state the checked call left, with its m: its shrink is
    idempotent and its work does not depend on the mask's values, so every
    call rewrites the same words as the checked call."""
    case = open_claim_case(torch, N, 603, 6, R, 1, False, seed=N + R,
                           rem=37 * N)
    want = oc.open_claim_fill_reference(**case)
    used, optmask = case["used"].clone(), case["optmask"].clone()
    ws = oc.open_claim_workspace(N, used.device)
    m = torch.empty((N,), dtype=torch.int32, device=used.device)
    rem_out = torch.empty((), dtype=torch.int32, device=used.device)
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
    k1_seq = device_ms(lambda: oc.open_claim_fill_reference(
        **case, quotient=quotient.quotient_nt))
    host = host_us(lambda: oc.open_claim_fill(**state, workspace=ws))
    k1_seq_host = host_us(lambda: oc.open_claim_fill_reference(
        **case, quotient=quotient.quotient_nt))
    bound, by = open_claim_bound_ms(case, placed_m)
    row = {"N": N, "T": 603, "S": 6, "R": R, "Pv": 1,
           "active_rows": int(case["active"].sum()),
           "placed_rows": int((placed_m > 0).sum()),
           "launch1_ms": l1, "launch2_ms": l2, "ms": l1 + l2,
           "plain_ms": plain, "k1_sequence_ms": k1_seq,
           "host_us": host, "k1_sequence_host_us": k1_seq_host,
           "bound_ms": bound, "bound_by": by}
    phase(f"open_claim_{label}_shape",
          **{k: (f"{v:.5f}" if isinstance(v, float) else v)
             for k, v in row.items()})
    return row


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


def profile_solve(torch, label, catalog, prov, pods, existing, TorchSolver):
    """One solve of a path under torch.profiler (after a warm-up solve):
    the device's busy time (union of kernel intervals), its idle share of
    the profiled solve's wall time, and the kernels that took the most
    device time. Profiling slows the host, so the wall time here is not
    the path's; the device numbers are."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    solver = TorchSolver(catalog, [prov])
    solver.solve(list(pods), existing=copy_existing(existing))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        solver.solve(list(pods), existing=copy_existing(existing))
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


def main() -> int:
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
        from karpenter_tpu_torch.ops import _build, open_claim, quotient
        from karpenter_tpu_torch.oracle.scheduler import Scheduler
        from karpenter_tpu_torch.providers.instancetypes import generate_fleet_catalog
        from karpenter_tpu_torch.solver.core import TorchSolver
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

        k1_rows, k1_err = run_k1(torch, quotient)
        oc_err = run_open_claim(torch, open_claim)

        catalog = generate_fleet_catalog()
        check(len(catalog.types) == 603, "fleet catalog must hold 603 types")
        prov = provisioner()
        pods_a = mixed_workload(10_000)
        pods_b = mixed_5k_pods()
        ex_b = existing_nodes(catalog)
        LAUNCHES.reset()
        info_a = run_path("pathA", catalog, prov, pods_a, (), LAUNCHES,
                          TorchSolver, open_claim.KERNEL, quotient.KERNEL)
        info_b = run_path("pathB", catalog, prov, pods_b, ex_b, LAUNCHES,
                          TorchSolver, open_claim.KERNEL, quotient.KERNEL)
        launches = {k: LAUNCHES.get(k)
                    for k in (open_claim.KERNEL, quotient.KERNEL)}
        check(launches[open_claim.KERNEL] > 0,
              "the open-claim kernel was never launched on the main path")
        check(launches[quotient.KERNEL] == 0,
              "the main path launched the standalone K1")
        profile_solve(torch, "A", catalog, prov, pods_a, (), TorchSolver)
        profile_solve(torch, "B", catalog, prov, pods_b, ex_b, TorchSolver)

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
        oc_rows = [time_open_claim(torch, open_claim, quotient, label,
                                   info["slots"], info["res_width"])
                   for label, info in (("pathA", info_a), ("pathB", info_b))]

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
            "launches": launches[open_claim.KERNEL],
            "launches_path_a_per_solve": info_a["open_claim_launches"],
            "launches_path_b_per_solve": info_b["open_claim_launches"],
            "max_abs_err": oc_err,
            "ms": oc_a["ms"],
            "plain_ms": oc_a["plain_ms"],
            "bound_ms": oc_a["bound_ms"],
            "bound_by": oc_a["bound_by"],
            "library_ms": None,
            "k1_sequence_ms": oc_a["k1_sequence_ms"],
            "shapes": oc_rows,
        }, {
            "name": "quotient_nt",
            "route": "cuda",
            "source": "karpenter_tpu_torch/csrc/quotient.cu",
            "replaces": "karpenter_tpu/ops/pallas_kernels.py:101",
            "launches": launches[quotient.KERNEL],
            "launches_path_a_per_solve": 0,
            "launches_path_b_per_solve": 0,
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
    sys.exit(main())
