"""The port's copies of JAX-package modules cannot drift unseen.

A copy is the original with one header paragraph added (in the module
docstring, or as a comment block where the docstring has one paragraph or
the file is C++) that names the original, and with the absolute path of the
reference checkout written as "upstream ". Each case strips the header,
writes the original's reference paths the same way, and asserts that the
two files are equal byte for byte.

Where the port had to edit a module, its case checks instead that the port
defines the same public names as the original (module level, and the public
methods of each class) for the parts it carries, under the port's name
where it renames one (RENAMED), plus the names it adds (ADDED), and that the
rest of the file differs from the original by no more than the lines named
here.
"""

from __future__ import annotations

import ast
import difflib
import re
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
JAX, PORT = REPO / "karpenter_tpu", REPO / "karpenter_tpu_torch"
# the reference checkout's absolute prefix, as the originals cite it
REF = re.compile(r"/[a-z]+/reference/")

COPIES = [
    "apis/nodetemplate.py", "apis/settings.py", "apis/yaml_compat.py",
    "batcher/__init__.py", "batcher/fleet.py",
    "cache/__init__.py", "chaos/__init__.py", "cloudbackend/server.py",
    "cloudprovider.py",
    "controllers/__init__.py", "controllers/counters.py",
    "controllers/garbagecollection.py",
    "controllers/interruption/__init__.py",
    "controllers/interruption/queues.py",
    "controllers/machinehydration.py", "controllers/machinelifecycle.py",
    "controllers/nodetemplate.py", "controllers/settingswatch.py",
    "controllers/termination.py",
    "coordination/__init__.py", "coordination/protocol.py",
    "coordination/serde.py", "coordination/sync.py",
    "events/__init__.py",
    "explain/attribution.py", "explain/reasons.py",
    "explain/records.py", "explain/state.py",
    "fake/__init__.py", "fake/apiserver.py", "fake/cloud.py", "fake/kube.py",
    "fake/mocks.py",
    "fleet/__init__.py", "fleet/failover.py", "fleet/membership.py",
    "fleet/metrics.py", "fleet/router.py",
    "incremental/__init__.py", "incremental/extract.py",
    "incremental/resident.py", "incremental/solver.py",
    "incremental/state.py",
    "introspect/fleetview.py", "introspect/flightrecorder.py",
    "introspect/statusz.py", "introspect/watchdog.py",
    "leaderelection.py",
    "metrics/__init__.py", "metrics/cardinality.py", "models/machine.py",
    "native/ktpack.cc",
    "overload/__init__.py", "overload/eviction.py", "overload/guard.py",
    "overload/metrics.py", "overload/state.py",
    "profiling/state.py",
    "providers/images.py", "providers/instance.py",
    "providers/instancetypes.py", "providers/launchtemplate.py",
    "providers/pricing.py", "providers/securitygroup.py",
    "providers/subnet.py",
    "recovery/__init__.py", "recovery/crashpoints.py", "recovery/journal.py",
    "resilience/breaker.py", "resilience/deadline.py",
    "resilience/degrade.py",
    "solver/solver_pb2.py",
    "spot/forecaster.py", "spot/rebalance.py", "spot/state.py",
    "parallel/__init__.py",
    "utils/clock.py", "utils/errors.py",
    "utils/logring.py",
    "webhooks/__init__.py",
]

# edited ports: the most lines (either side of a diff) that may differ from
# the original once the header is stripped, or None where the port is a
# rewrite that carries only part of the original's names
EDITED = {
    # rung 0 named "cuda" in the hub's chains; wording of two comments
    "resilience/__init__.py": 8,
    "resilience/policy.py": 2,
    # diagnose_unschedulable restored; three comments reworded earlier;
    # encode_problem's `marks`: the solver's span boundaries (before and
    # after prepare_groups, after the fold and the bounds) and the group
    # cache's misses
    "models/encode.py": 23,
    # record_span takes a span's start on the shared clock, so a solve's
    # phases, filed after the last one ends, are drawn where they ran; the
    # registry names the solve's inner phases (split, encode's groups,
    # fold and bounds, dispatch's inputs and enqueue) and runtime.gc; ids
    # come from a generator of the tracer's own, not a system call a span
    "tracing/__init__.py": 47,
    # one docstring sentence names no PR numbers (two lines either side)
    "introspect/__init__.py": 4,
    # a heading names no issue number
    "spot/__init__.py": 2,
    "introspect/slo.py": 2,
    # a docstring names no issue number, another is reworded; the
    # DecisionRecord's risk weight is read from the port's forecaster (the
    # original names its own package in an __import__ string)
    "spot/objective.py": 6,
    # `device` taken and given to the provisioning and deprovisioning
    # controllers; solver_target first checks that grpcio imports; one
    # comment cites no review round
    "operator.py": 19,
    # three comment lines cite no review round; a relist keeps an object
    # written after its LIST's snapshot (the race the original keeps)
    "coordination/httpkube.py": 13,
    # the title and two docstring lines call the package a client and
    # cite no review round
    "cloudbackend/__init__.py": 6,
    # two comments reworded
    "serving.py": 4,
    # --device for `controller`, `solver-serve`, `fleet-replica` and
    # `chaos`; solver-serve and controller --solver exit 2 naming grpcio
    # where it is missing, and solver-serve --readback callback exits 2 (no
    # callback transport); solver-serve --distributed joins the process
    # group (rank 0 serves, the other ranks follow the mesh), and each
    # rank tears its group down on the way out; chaos writes its artifact
    # under port_results/ (git-ignored), not benchmarks/, and its two
    # perf-ledger helpers (_ledger_partition,
    # _ledger_spotstorm, which append to benchmarks/results/ledger.jsonl)
    # are left out; the usage text, prog name and help strings name the
    # port
    "__main__.py": 170,
    # comments cite no issue or PR numbers of the JAX package's history
    "chaos/plan.py": 4,
    "chaos/invariants.py": 4,
    # the solver client is imported where the crashing solver raises
    # SolverUnavailable (it imports grpc); the degrade chain reads cuda;
    # one comment cites no PR number
    "chaos/inject.py": 9,
    # `device` given to every Operator the drills build; the artifacts'
    # tool names the port's package; the title calls it a runner
    "chaos/runner.py": 21,
    # register syncs through the service's protobuf-free core under the
    # wire's content key; FleetService aborts through solver/edge.py; two
    # comments cite no issue or PR numbers
    "fleet/frontend.py": 22,
    # `device` for the runtime and spawn_replica (kernels built before the
    # replica registers), `fleet-replica --device` on the port's CLI, the
    # replica environment without XLA settings (threads capped on the
    # CPU), the gRPC stubs and status codes through solver/edge.py, the
    # replica's kernel launch counts printed on SIGUSR1 (then counted from
    # 0 again) and when it stops
    "fleet/replica.py": 95,
    "controllers/provisioning.py": None,
    "controllers/deprovisioning.py": None,
    # a "cuda" row (the H100 data sheet: PCIe Gen5 x16, float32) in place
    # of the tpu and gpu rows of PEAKS, and its comment; one heading names
    # no issue number; the measured snapshot says its source is
    # unavailable (no compiler cost analysis on any torch backend)
    "profiling/roofline.py": 16,
    # the device-event feed records a solve's CUDA-event span where the
    # solver filed one (note_device_event, the record's slot), labelled
    # cuda-events, else the device_exec phase, labelled cpu-synthetic; two
    # docstring lines reworded (an issue number, the two-round solve's
    # name)
    "profiling/gapledger.py": 27,
    # the device ladder's rungs: cuda-events (CudaEventSpan) for tpu-sync,
    # torch.profiler for jax.profiler, each event's mode given by its
    # caller (MODES), detect_backend the solver's device type; the device
    # half of the docstring says so; a sweep reads the switch again under
    # the lock it appends under, and counts() reads both host counts under
    # it (the strict-noop race the original keeps)
    "profiling/continuous.py": 127,
    # three docstring and comment lines reworded (an issue number, the
    # pipelining change's and the wave loop's names)
    "profiling/critical.py": 6,
    "explain/__init__.py": 2,
    "profiling/__init__.py": None,
    # torch uploads (`device`, no sharding) in tracked_device_put/
    # tracked_tree_put, and the counters' help texts and two comments say
    # what a compile-cache hit, miss and warmup mean on the card
    "solver/buckets.py": 83,
    "solver/core.py": None,
    # the core/edge split: RPC methods over the protobuf-free core, grpc
    # moved to solver/edge.py, torch.profiler for jax.profiler, the device
    # type in Health, the process's shared mesh context, which raises where
    # the JAX package would serve single-chip; the live heap frozen after
    # each Sync that installed or evicted (solver/heap.py), its counts in
    # eviction_stats()
    "solver/service.py": 722,
    # the method table names message classes; docstrings name the port
    "solver/client.py": 6,
    # torch.distributed for GSPMD: one process per rank, the collectives
    # written out (parallel/sharded.py's docstring); the process group's
    # bootstrap from torchrun's environment
    "parallel/sharded.py": None,
    "parallel/multihost.py": None,
}

# names an edited port defines under another name
RENAMED = {"solver/core.py": {"TPUSolver": "TorchSolver"}}

# names an edited port adds ("Class.method" for a method): the service's
# protobuf-free core and its failures
ADDED = {
    "parallel/sharded.py": {
        "COLLECTIVES", "Mesh", "world_size", "shared_context",
        "forget_contexts", "ShardedContext.follow", "ShardedContext.close",
        "ShardedContext.driving"},
    "parallel/multihost.py": {"TIMEOUT", "local_world_size",
                              "shutdown_distributed"},
    "solver/service.py": {
    "NotSynced", "Shed", "SolverService.sync", "SolverService.solve",
    "SolverService.consolidate", "SolverService.health"},
    "profiling/continuous.py": {"CudaEventSpan", "MODES",
                                "HostSampler.counts"},
    "profiling/gapledger.py": {"GapLedger.note_device_event"}}

# names the port leaves out, each with the slice that brings it
OMITTED = {
    # GSPMD's shardings: the port's ranks slice their own inputs; and the
    # mesh's compiled-program count: the solver's compile_cache key
    # carries the route, the mesh's included (solver/core.py)
    "parallel/sharded.py": {"input_shardings", "delta_shardings",
                            "sharded_flat_cache_size"},
    # no caller: the solve times its one read (host_fetch) apart from the
    # unflatten
    "solver/core.py": {"fetch_pack"},
}


# uses of an OMITTED name the port knows of: (module, name) -> the slice
# that brings the name. None since the continuous profiler came.
KNOWN_GAPS: "dict[tuple[str, str], str]" = {}


def strip_header(text: str) -> str:
    """The copy without its header paragraph: the lines from the one that
    starts "Copy of karpenter_tpu/" through the next blank line."""
    lines = text.split("\n")
    for i, line in enumerate(lines):
        if line.lstrip("#/ ").startswith("Copy of karpenter_tpu/"):
            j = i
            while lines[j].strip() not in ("", "#", "//"):
                j += 1
            return "\n".join(lines[:i] + lines[j + 1:])
    raise AssertionError("no copy header")


def original(rel: str) -> str:
    return REF.sub("upstream ", (JAX / rel).read_text())


@pytest.mark.parametrize("rel", COPIES)
def test_copy_equals_its_original(rel):
    src = (JAX / rel).read_text()
    port = (PORT / rel).read_text()
    if not src:
        assert port == ""
        return
    assert f"Copy of karpenter_tpu/{rel} " in port.replace("\n# ", " ") \
        .replace("\n// ", " ").replace("\n", " ")
    assert strip_header(port) == original(rel)


def public_names(path: Path) -> "dict[str, set]":
    """Module-level public names defined in the file (not imported ones),
    and each public class's public methods."""
    tree = ast.parse(path.read_text())
    out: "dict[str, set]" = {"": set()}
    for node in tree.body:
        names = []
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names = [node.name]
        elif isinstance(node, ast.Assign):
            names = [t.id for t in node.targets if isinstance(t, ast.Name)]
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                           ast.Name):
            names = [node.target.id]
        elif isinstance(node, ast.ImportFrom) and path.name == "__init__.py":
            names = [a.asname or a.name for a in node.names]
        for n in names:
            if not n.startswith("_"):
                out[""].add(n)
        if isinstance(node, ast.ClassDef) and not node.name.startswith("_"):
            out[node.name] = {b.name for b in node.body
                              if isinstance(b, ast.FunctionDef)
                              and not b.name.startswith("_")}
    return out


def changed_lines(a: str, b: str) -> int:
    return sum(1 for d in difflib.ndiff(a.split("\n"), b.split("\n"))
               if d[:2] in ("- ", "+ "))


@pytest.mark.parametrize("rel", sorted(EDITED))
def test_edited_port_keeps_the_original_names(rel):
    want = public_names(JAX / rel)
    got = public_names(PORT / rel)
    omitted = OMITTED.get(rel, set())
    renamed = RENAMED.get(rel, {})
    added = ADDED.get(rel, set())
    assert got[""] == {renamed.get(n, n) for n in want[""] - omitted} | {
        n for n in added if "." not in n}, rel
    for cls, methods in want.items():
        if cls and cls not in omitted:
            left_out = {m.split(".", 1)[1] for m in omitted
                        if m.startswith(cls + ".")}
            name = renamed.get(cls, cls)
            extra = {m.split(".", 1)[1] for m in added
                     if m.startswith(name + ".")}
            assert got.get(name) == (methods - left_out) | extra, (rel, cls)
    budget = EDITED[rel]
    if budget is not None:
        port = (PORT / rel).read_text()
        assert changed_lines(original(rel), strip_header(port)) <= budget


def test_every_port_module_of_this_slice_is_pinned():
    """Each module this slice added is a copy or an edited port here, or one
    of the port's own modules (native loader, wire, capture, the driver
    entry points, the card probe, the collector's pause ring and the
    service's heap freeze)."""
    own = {"native/__init__.py", "solver/__init__.py", "solver/edge.py",
           "solver/wire.py", "utils/capture.py", "entry.py",
           "utils/cudaenv.py", "profiling/gcpause.py", "solver/heap.py"}
    slice_dirs = ("batcher", "cache", "chaos", "cloudbackend", "controllers",
                  "coordination", "events", "explain",
                  "fake", "fleet", "incremental", "introspect", "metrics",
                  "native",
                  "overload", "parallel", "profiling", "recovery",
                  "resilience", "solver", "spot", "tracing", "webhooks")
    found = {str(p.relative_to(PORT)) for d in slice_dirs
             for p in (PORT / d).rglob("*") if p.suffix in (".py", ".cc")}
    found |= {"leaderelection.py", "operator.py", "utils/logring.py",
              "serving.py", "__main__.py", "entry.py", "utils/cudaenv.py"}
    assert all((PORT / rel).is_file() for rel in found)
    assert found <= set(COPIES) | set(EDITED) | own, \
        sorted(found - set(COPIES) - set(EDITED) - own)


def omitted_uses(path: Path) -> "set[str]":
    """The OMITTED names the file imports, and the omitted methods it calls
    on a module-level instance of the edited port (HBM.pressure())."""
    instances = {}  # instance name -> its class, per edited module
    for rel in OMITTED:
        for node in ast.parse((PORT / rel).read_text()).body:
            if isinstance(node, ast.Assign) and isinstance(
                    node.value, ast.Call) and isinstance(node.value.func,
                                                         ast.Name):
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        instances[t.id] = (rel, node.value.func.id)
    found = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.ImportFrom):
            stem = (node.module or "").replace(".", "/")
            for rel, names in OMITTED.items():
                if rel[:-3].removesuffix("/__init__").endswith(stem) and stem:
                    found |= {a.name for a in node.names} & names
        elif isinstance(node, ast.Attribute) and isinstance(node.value,
                                                             ast.Name):
            rel, cls = instances.get(node.value.id, (None, None))
            if rel and f"{cls}.{node.attr}" in OMITTED[rel]:
                found.add(f"{node.value.id}.{node.attr}")
    return found


def test_no_port_module_uses_a_name_the_port_left_out():
    """A copy that calls a name an edited port leaves out fails only when
    that line runs, and a broad except may swallow it (a guard that reads
    HBM.pressure() under `except Exception` would read 0.0 for ever). So no
    module of the port uses an OMITTED name, apart from the KNOWN_GAPS."""
    bad = []
    for path in sorted(PORT.rglob("*.py")):
        rel = str(path.relative_to(PORT))
        for name in sorted(omitted_uses(path)):
            if (rel, name) not in KNOWN_GAPS:
                bad.append(f"{rel}: {name}")
    assert not bad, bad


def test_omitted_uses_sees_a_call_on_the_ledger(tmp_path, monkeypatch):
    """The scan above catches both forms: an import of a left-out name and
    a left-out method called on the module's ledger. (The buckets module
    leaves nothing out since the solver service came; the probe declares
    two of its names left out, as they were before.)"""
    monkeypatch.setitem(OMITTED, "solver/buckets.py",
                        {"ShapeRouter", "HbmLedger.pressure"})
    probe = tmp_path / "probe.py"
    probe.write_text("def f():\n"
                     "    from ..solver.buckets import HBM, ShapeRouter\n"
                     "    return HBM.pressure(), HBM.snapshot()\n")
    assert omitted_uses(probe) == {"ShapeRouter", "HBM.pressure"}
