"""The port's Operator against the JAX package's, on the CPU.

Two parts:

* The JAX package's operator-level test files run again against the port:
  `retarget` loads a file's source with every import of `karpenter_tpu`
  pointed at `karpenter_tpu_torch` (its string literals, such as the
  statusz `tool` name both packages report, stay as they are) and each
  `Operator(` built with device="cpu", and this module collects the
  file's tests under its own names (``<file tag>__<test>`` for functions,
  ``Test<Tag>_<Class>`` for classes). No assertion is dropped or changed.
  A case that needs a part of the JAX package the port does not carry yet
  is skipped with a reason that names the ROADMAP item that brings it
  (SOURCES).
* A lockstep `OperatorPair`: one JAX and one port Operator over the same
  fake cloud, driven through `reconcile_all_once` with every plane at its
  default (spot, incremental and explain on, flipped together in both
  packages). After each pass it compares the machines, bindings, events
  (without their uuid-suffixed Event names), the DecisionRecords (without
  trace ids and timestamps), the spot and incremental counter deltas, and
  statusz section by section (see STATUSZ_VALUES).
"""

from __future__ import annotations

import ast
import importlib
import json
import re
import sys
import types
from pathlib import Path

import pytest

from tests.test_torch_controllers import (CATALOG, JAX, PORT, TPU, Stack,
                                          decision_records)

TESTS = Path(__file__).resolve().parent


def _cpu_operator(cls):
    """`cls` built with device="cpu" unless the caller names a device."""
    def build(*args, **kw):
        kw.setdefault("device", "cpu")
        return cls(*args, **kw)

    return build


_CPU_CLASSES: dict = {}


def _on_cpu(obj):
    """A port class or function that takes `device`, defaulting it to "cpu":
    a class becomes a subclass of the same name (so a test may subclass it
    in turn), a function a wrapper."""
    if not isinstance(obj, type):
        return _cpu_operator(obj)
    if obj not in _CPU_CLASSES:
        def __init__(self, *args, **kw):
            kw.setdefault("device", "cpu")
            obj.__init__(self, *args, **kw)

        _CPU_CLASSES[obj] = type(obj.__name__, (obj,), {
            "__init__": __init__, "__qualname__": obj.__qualname__,
            "__module__": obj.__module__})
    return _CPU_CLASSES[obj]


# port names (after TPUSolver -> TorchSolver) whose imports the retarget
# rebinds through _on_cpu, under the name each import binds
_ON_CPU = {"SolverService", "serve", "TorchSolver", "NativeSolver",
           "run_consolidation", "ChaosRunner", "spawn_replica",
           "ShardedContext"}
# the port modules those names are imported from
_ON_CPU_MODULES = (r"solver\.core|solver\.service|ops\.consolidate|chaos|"
                   r"chaos\.runner|fleet|fleet\.replica|parallel\.sharded")


def _cpu_rebind(m: "re.Match") -> str:
    """An import statement of one of _ON_CPU_MODULES (on one line, or a
    parenthesised list over several), followed by a line that rebinds each
    name of _ON_CPU it imports through _on_cpu."""
    indent, names = m.group(1), m.group(3)
    bound = []
    for part in names.strip().strip("()").split(","):
        name, _, alias = part.strip().partition(" as ")
        if name.strip() in _ON_CPU:
            bound.append((alias or name).strip())
    if not bound:
        return m.group(0)
    return (m.group(0) + "\n" + indent + ", ".join(bound) + " = "
            + ", ".join(f"_on_cpu({b})" for b in bound))


_BENCH = re.compile(r"^([ \t]*)from benchmarks(?:\.(\w+) import| import (\w+)"
                    r"( as \w+)?)", re.M)


def _bench_module(name: str) -> str:
    """benchmarks/<name>.py loaded by `retarget` (read from disk, the file
    left as it is) under a module name of its own; returns that name."""
    modname = f"{__name__}_bench_{name}"
    if modname not in sys.modules:
        retarget(name, modname, path=TESTS.parent / "benchmarks" /
                 f"{name}.py")
    return modname


def _bench_import(m: "re.Match") -> str:
    """An import of a drill module of benchmarks/, pointed at its
    retargeted copy (_bench_module)."""
    indent, from_name, mod_name, alias = m.groups()
    if from_name:
        return f"{indent}from {_bench_module(from_name)} import"
    return f"{indent}import {_bench_module(mod_name)}{alias or ' as ' + mod_name}"


def retarget(name: str, modname: str, unported=(),
             labels=(), path: "Path | None" = None) -> types.ModuleType:
    """tests/<name>.py (or the file at `path`) with karpenter_tpu imports
    pointed at the port, loaded as module `modname`; the source's own
    imports of other retargeted files name their modules, and its imports
    of a drill module of benchmarks/ name that module retargeted the same
    way (the benchmark file itself is only read). The port's own names and
    devices replace the JAX package's:

    * `TPUSolver` reads `TorchSolver`;
    * every `Operator(` is built with device="cpu", and each import of
      `SolverService`, `serve` (whose default builds a service),
      `TorchSolver`, `NativeSolver`, `run_consolidation`, `ChaosRunner`,
      `spawn_replica` or `ShardedContext` binds a version whose `device`
      defaults to "cpu";
    * each (old, new) pair of `labels`, a line of the source that names a
      JAX accelerator label, is rewritten once with the port's label (the
      device type, or the rung name "cuda").

    Each line of `unported` (a module-level import of a part the port does
    not carry yet) is left out; the cases that use it must be skipped."""
    path = path or TESTS / f"{name}.py"
    src = path.read_text()
    for line in unported:
        assert src.count(line + "\n") == 1, line
        src = src.replace(line + "\n", "")
    for old, new in labels:
        assert src.count(old) == 1, old
        src = src.replace(old, new)
    src = re.sub(r"^(\s*)(from|import) karpenter_tpu\b", rf"\1\2 {PORT}",
                 src, flags=re.M)
    src = re.sub(r"\bTPUSolver\b", "TorchSolver", src)
    src = re.sub(r"\bOperator\(", "_cpu_operator(Operator)(", src)
    src = re.sub(rf"^([ \t]*)from {PORT}\.({_ON_CPU_MODULES}) import "
                 r"(\([^)]*\)|.*$)", _cpu_rebind, src, flags=re.M)
    src = _BENCH.sub(_bench_import, src)
    src = src.replace("from tests.test_e2e_scenarios import",
                      f"from {__name__}_e2e_scenarios import")
    mod = types.ModuleType(modname)
    mod.__file__ = str(path)
    mod._cpu_operator = _cpu_operator
    mod._on_cpu = _on_cpu
    sys.modules[modname] = mod
    exec(compile(src, str(path), "exec"), mod.__dict__)
    return mod


def collect(mod: types.ModuleType, tag: str, skips: dict, into: dict,
            exclude=()) -> list:
    """Put the module's tests and fixtures into `into` under this module's
    names, each case named in `skips` marked skip with its reason, the
    tests named in `exclude` left out, and the source's module-level marks
    (`pytestmark`) put on each test, which would not follow the tests out
    of their module on their own. Returns the names it added."""
    marks = getattr(mod, "pytestmark", [])
    marks = marks if isinstance(marks, list) else [marks]
    added = []
    for key, obj in list(vars(mod).items()):
        if key in exclude:
            continue
        if key.startswith("test_") and callable(obj):
            new = f"test_{tag}__{key[5:]}"
        elif key.startswith("Test") and isinstance(obj, type):
            new = f"Test{tag.title().replace('_', '')}_{key[4:]}"
        elif hasattr(obj, "_fixture_function_marker") or \
                type(obj).__name__ == "FixtureFunctionDefinition":
            new = key
        else:
            continue
        assert into.get(new, obj) is obj, new  # a fixture may be re-imported
        if new != key:  # a test (fixtures keep their names)
            for mark in marks:
                mark(obj)  # stored on the function or class itself
        into[new] = obj
        added.append(new)
    for case, reason in skips.items():
        cls, _, meth = case.rpartition(".")
        # a mark is stored on the function object itself
        pytest.mark.skip(reason=reason)(
            getattr(getattr(mod, cls) if cls else mod, meth))
    return added


def cases_except(name: str, keep) -> tuple:
    """The module-level tests and test classes of tests/<name>.py other
    than those named in `keep` (an `exclude` for collect)."""
    tree = ast.parse((TESTS / f"{name}.py").read_text())
    return tuple(node.name for node in tree.body
                 if isinstance(node, (ast.FunctionDef, ast.ClassDef))
                 and node.name.startswith(("test_", "Test"))
                 and node.name not in keep)


# -- the JAX package's operator-level tests, against the port -------------------

SOURCES = [
    # (file, tag, {case: reason to skip})
    ("test_e2e_scenarios", "scenarios", {}),
    ("test_e2e_lifecycle", "lifecycle", {}),
    ("test_webhooks", "webhooks", {}),
    ("test_leaderelection", "leaderelection", {}),
    ("test_machinehydration", "machinehydration", {}),
    ("test_queue_provider", "queue_provider", {}),
]

COLLECTED: "dict[str, list]" = {}
for _file, _tag, _skips in SOURCES:
    _mod = retarget(_file, f"{__name__}_{_file[5:]}")
    COLLECTED[_file] = collect(_mod, _tag, _skips, globals())


# -- a lockstep pair of operators, every plane at its default -------------------

PLANES = ("incremental", "explain", "spot")
QUEUE = "parity-queue"
# statusz, section by section. By value: what belongs to the operator;
# the spot and incremental sections without their counters, which are
# process-wide (the pair compares their deltas instead). By nested keys:
# controllers and caches, which carry wall-clock cycle times. By top-level
# keys: the sections that read process-wide rings and registries, which
# other tests in this process also feed (the pair compares the records
# filed since it began instead); the fleet section lists the live
# frontends of this process and the overload section's counters are
# process-wide, so the overload section is compared by its switch and its
# counter names. Left
# out: metrics (which families hold series depends on what else this
# process ran) and pid.
STATUSZ_VALUES = ("tool", "schema", "version", "ts", "serving", "cluster",
                  "queues", "events", "resilience", "recovery",
                  "incremental", "spot")
STATUSZ_KEYS = ("controllers", "caches")
STATUSZ_SKIP = ("pid", "metrics")


def keys_of(x):
    """The nested key structure of a JSON-like value."""
    if isinstance(x, dict):
        return {k: keys_of(v) for k, v in x.items()}
    if isinstance(x, list):
        return [keys_of(v) for v in x[:1]]
    return None


def without_counters(x):
    """x without its "counters" entries, at every depth."""
    if isinstance(x, dict):
        return {k: without_counters(v) for k, v in x.items()
                if k != "counters"}
    return x


def set_all_planes(on: bool) -> list:
    prev = []
    for pkg in (JAX, PORT):
        for plane in PLANES:
            mod = importlib.import_module(f"{pkg}.{plane}")
            prev.append((mod, mod.enabled()))
            mod.set_enabled(on)
    return prev


class OperatorStack(Stack):
    """One package's Operator over a fake cloud, with the scenario helpers
    and `snapshot` of the controller Stack. The cloud batchers' windows are
    0 on the FakeClock, one launch worker and a fixed machine-name suffix
    make machine names equal across the packages, and the interruption
    queue is configured, so every controller the operator can build runs
    in each reconcile_all_once."""

    def __init__(self, pkg: str, catalog_spec, **settings_kw):
        from concurrent.futures import ThreadPoolExecutor

        self.pkg = pkg
        m = self.m
        self.clock = m("utils.clock").FakeClock()
        self.catalog = self.make_catalog(catalog_spec)
        self.cloud = m("fake.cloud").FakeCloud(catalog=self.catalog,
                                              clock=self.clock)
        self.settings = m("apis.settings").Settings(
            cluster_name="parity", cluster_endpoint="https://k.example",
            batch_idle_duration=0.0, batch_max_duration=0.0,
            interruption_queue_name=QUEUE, **settings_kw)
        dev = {} if pkg == JAX else {"device": "cpu"}
        self.op = op = m("operator").Operator(self.cloud, self.settings,
                                              self.catalog, clock=self.clock,
                                              **dev, **self.operator_kwargs())
        self.kube, self.cluster, self.recorder = op.kube, op.cluster, \
            op.recorder
        self.cp = op.cloudprovider
        fleet = m("batcher.fleet")
        inst = self.cp.instances
        for attr, cls in (("fleet", fleet.CreateFleetBatcher),
                          ("describe", fleet.DescribeInstancesBatcher),
                          ("terminate", fleet.TerminateInstancesBatcher)):
            getattr(inst, attr).stop()
            setattr(inst, attr, cls(self.cloud, clock=self.clock, idle=0.0,
                                    max_wait=0.0))
        self.provisioning = op.provisioning
        self.provisioning._pool.shutdown(wait=False)
        self.provisioning._pool = ThreadPoolExecutor(max_workers=1)
        self.provisioning._name_suffix = "p0000"
        self.termination = op.termination
        self.deprovisioning = op.deprovisioning
        self.lifecycle = op.machinelifecycle
        tmpl = m("apis.nodetemplate").NodeTemplate(
            name="default",
            subnet_selector={"id": "subnet-zone-1a,subnet-zone-1b,"
                             "subnet-zone-1c"},
            security_group_selector={"id": "sg-default"})
        self.kube.create("nodetemplates", "default", tmpl)
        self.cp.register_nodetemplate(self.kube.get("nodetemplates",
                                                    "default"))

    def operator_kwargs(self) -> dict:
        """More Operator arguments (a subclass's store and listeners)."""
        return {}

    def close(self):
        self.op.stop()
        super().close()

    def statusz_doc(self) -> dict:
        return self.m("introspect").snapshot(self.op)

    def statusz(self) -> dict:
        snap = self.statusz_doc()
        out = {}
        for k, v in snap.items():
            if k in STATUSZ_SKIP:
                continue
            v = json.loads(TPU.sub("cuda", json.dumps(v, default=str,
                                                      sort_keys=True)))
            if k in ("spot", "incremental"):
                v = without_counters(v)
            if k == "overload":
                out[k] = {"enabled": v["enabled"],
                          "counters": sorted(v["counters"]),
                          "frontends": type(v["frontends"]).__name__}
            elif k in STATUSZ_VALUES:
                out[k] = v
            elif k in STATUSZ_KEYS:
                out[k] = keys_of(v)
            else:
                out[k] = sorted(v)
        return out

    def interrupt(self, node_name: str) -> str:
        """A spot interruption warning for the node's instance on the
        operator's queue; returns the instance id."""
        node = self.cluster.nodes[node_name]
        _, iid = self.m("models.machine").parse_provider_id(node.provider_id)
        self.op.queue.send(json.dumps({
            "source": "cloud.spot",
            "detail-type": "Spot Instance Interruption Warning",
            "detail": {"instance-id": iid}}))
        return iid


def activity(pkg: str, plane: str) -> dict:
    return importlib.import_module(f"{pkg}.{plane}").activity()


class OperatorPair:
    """The same scenario on a JAX and a port Operator, compared after every
    reconcile_all_once pass. Both DecisionRings continue from one id, so
    record ids and event citations line up."""

    def __init__(self, catalog=CATALOG, stack=OperatorStack, **settings_kw):
        self.jax = stack(JAX, catalog, **settings_kw)
        self.port = stack(PORT, catalog, **settings_kw)
        jring = importlib.import_module(f"{JAX}.explain").DECISIONS
        pring = importlib.import_module(f"{PORT}.explain").DECISIONS
        # both rings continue from the same id, past every record either
        # holds already
        jring._next_id = pring._next_id = self.first_id = max(
            jring._next_id, pring._next_id)
        self.act0 = {(pkg, plane): activity(pkg, plane)
                     for pkg in (JAX, PORT) for plane in ("spot",
                                                          "incremental")}
        self.passes = 0

    def both(self, fn):
        return fn(self.jax), fn(self.port)

    def run(self, n: int = 1) -> None:
        """n passes of reconcile_all_once on both, compared after each."""
        for _ in range(n):
            self.both(lambda s: s.op.reconcile_all_once())
            self.passes += 1
            self.compare()

    def compare(self) -> None:
        sj, sp = self.jax.snapshot(), self.port.snapshot()
        for k in sj:
            assert sp[k] == sj[k], (self.passes, k)
        assert decision_records(PORT, self.first_id) == \
            decision_records(JAX, self.first_id)
        for plane in ("spot", "incremental"):
            assert self.deltas(PORT, plane) == self.deltas(JAX, plane), \
                (self.passes, plane)
        zj, zp = self.jax.statusz(), self.port.statusz()
        assert set(zp) == set(zj)
        for k in zj:
            assert zp[k] == zj[k], (self.passes, "statusz", k)

    def deltas(self, pkg: str, plane: str = "spot") -> dict:
        """The plane's activity counters since the pair was built."""
        return {k: v - self.act0[pkg, plane][k]
                for k, v in activity(pkg, plane).items()}

    def close(self):
        self.jax.close()
        self.port.close()


@pytest.fixture
def default_planes(monkeypatch):
    """Every plane on in both packages (their default), the card's rung
    first at every size; restored afterwards."""
    prev = set_all_planes(True)
    monkeypatch.setenv("KARPENTER_TPU_ROUTE_CROSSOVER", "0")
    yield
    for mod, was in prev:
        mod.set_enabled(was)


@pytest.fixture
def opair(default_planes):
    p = OperatorPair()
    yield p
    p.close()


def _spot_od(s):
    return s.add_provisioner(requirements=(
        ("karpenter.sh/capacity-type", "In", ["spot", "on-demand"]),))


def op_mixed_pods(p):
    p.both(_spot_od)
    for i in range(12):
        p.both(lambda s: s.add_pod(f"web-{i}", cpu="500m", memory="1Gi"))
    for i in range(6):
        p.both(lambda s: s.add_pod(f"cache-{i}", cpu="2", memory="8Gi"))
    for i in range(4):
        p.both(lambda s: s.add_pod(
            f"zone-{i}", cpu="1", memory="1Gi",
            node_selector={"topology.kubernetes.io/zone": "zone-1b"}))
    p.run(3)
    snap = p.port.snapshot()
    assert snap["machines"] and not snap["pending"]
    assert snap["solver_kind"] == "cuda"


def op_zone_spread_with_a_second_affinity_round(p):
    p.both(lambda s: s.add_provisioner())
    for i in range(9):
        p.both(lambda s: s.add_pod(f"spread-{i}", cpu="1", memory="1Gi",
                                   zone_spread=True,
                                   labels=(("app", "spread"),)))
    for i in range(3):
        for s in (p.jax, p.port):
            mod = s.m("models.pod")
            s.add_pod(f"follow-{i}", cpu="500m", memory="512Mi",
                      pod_affinity=(mod.PodAffinityTerm(
                          match_labels=(("app", "spread"),),
                          topology_key="topology.kubernetes.io/zone"),))
    p.run(2)
    snap = p.port.snapshot()
    assert not snap["pending"]
    assert len({m[2] for m in snap["machines"]}) == 3


def op_pods_fill_existing_nodes_before_any_launch(p):
    p.both(lambda s: s.add_provisioner())
    for i in range(3):
        p.both(lambda s: s.add_pod(f"big-{i}", cpu="3", memory="4Gi"))
    p.run(2)
    n = len(p.port.snapshot()["machines"])
    for i in range(4):
        p.both(lambda s: s.add_pod(f"small-{i}", cpu="250m", memory="256Mi"))
    p.run(1)
    snap = p.port.snapshot()
    assert len(snap["machines"]) == n and not snap["pending"]


def op_oversized_pod_gives_failed_scheduling(p):
    p.both(lambda s: s.add_provisioner())
    p.both(lambda s: s.add_pod("fits", cpu="1", memory="1Gi"))
    p.both(lambda s: s.add_pod("huge", cpu="64", memory="1Gi"))
    p.run(2)
    assert p.port.snapshot()["pending"] == ["huge"]
    assert any(e.object_ref == "pod/huge"
               for e in p.port.recorder.by_reason("FailedScheduling"))


def op_emptiness_after_its_ttl(p):
    p.both(lambda s: s.add_provisioner(ttl_seconds_after_empty=30))
    for i in range(3):
        p.both(lambda s: s.add_pod(f"p-{i}", cpu="1", memory="1Gi"))
    p.run(2)
    for i in range(3):
        p.both(lambda s: s.delete_pod(f"p-{i}"))
    p.run(1)
    p.both(lambda s: s.clock.step(31))
    p.run(2)
    assert p.port.recorder.by_reason("EmptinessTTLExpired")
    assert not p.port.snapshot()["machines"]


def op_consolidation_delete(p):
    p.both(lambda s: s.add_provisioner(consolidation_enabled=True))
    p.both(lambda s: s.add_pod("keep", cpu="1", memory="1Gi",
                               do_not_evict=True))
    p.both(lambda s: s.add_pod("a-0", cpu="1", memory="1Gi"))
    p.run(2)
    for i in range(4):
        p.both(lambda s: s.add_pod(f"b-{i}", cpu="1", memory="1Gi"))
    p.run(2)
    assert len(p.port.snapshot()["machines"]) == 2
    p.both(lambda s: s.delete_pod("a-0"))
    p.both(lambda s: s.delete_pod("b-3"))
    p.both(lambda s: s.clock.step(400))
    p.run(3)
    assert len(p.port.snapshot()["machines"]) == 1


def op_consolidation_pair_replace(p):
    p.both(lambda s: s.add_provisioner(consolidation_enabled=True,
                                       requirements=(
        ("node.kubernetes.io/instance-type", "In", ["c.2xlarge"]),)))
    for i in range(28):
        p.both(lambda s: s.add_pod(f"p-{i}", cpu="1", memory="1Gi"))
    p.run(2)
    before = len(p.port.snapshot()["machines"])
    # open the bulk type to the provisioner in place (a delete would
    # terminate the nodes it owns through the operator's watch)
    for s in (p.jax, p.port):
        prov = s.m("apis.provisioner").Provisioner(
            name="default", provider_ref="default", consolidation_enabled=True)
        prov.set_defaults()
        prov.validate()
        s.kube.update("provisioners", "default", prov)
    p.both(lambda s: s.clock.step(400))
    p.run(4)
    snap = p.port.snapshot()
    assert p.port.recorder.by_reason("ConsolidationReplace")
    assert any(m[1] == "bulk.8xlarge" for m in snap["machines"])
    assert len(snap["machines"]) < before and not snap["pending"]


def op_expiration(p):
    p.both(lambda s: s.add_provisioner(ttl_seconds_until_expired=600))
    for i in range(4):
        p.both(lambda s: s.add_pod(f"p-{i}", cpu="1", memory="1Gi"))
    p.run(2)
    p.both(lambda s: s.clock.step(601))
    p.run(3)
    assert p.port.recorder.by_reason("Expired")
    assert not p.port.snapshot()["pending"]


def op_termination_drain(p):
    p.both(lambda s: s.add_provisioner())
    for i in range(5):
        p.both(lambda s: s.add_pod(f"p-{i}", cpu="1", memory="1Gi"))
    p.run(2)
    victim = sorted(p.port.cluster.nodes)[0]
    marked = p.both(lambda s: s.termination.request_deletion(victim))
    assert marked[0] == marked[1] and marked[1]
    p.run(2)
    assert victim not in p.port.snapshot()["nodes"]
    assert p.port.recorder.by_reason("Evicted")
    assert not p.port.snapshot()["pending"]


def op_failing_solver_degrades_to_native_and_recovers(p):
    broken = {"solver": True}
    for s in (p.jax, p.port):
        def factory(cat, provs, real=s.provisioning._solver_factory):
            if broken["solver"]:
                raise RuntimeError("solver down")
            return real(cat, provs)

        s.provisioning._solver_factory = factory
    p.both(lambda s: s.add_provisioner())
    for i in range(3):
        p.both(lambda s: s.add_pod(f"a-{i}", cpu="1", memory="1Gi"))
    p.run(1)
    assert p.port.snapshot()["solver_kind"] == "native"
    broken["solver"] = False
    for k in range(4):
        p.both(lambda s: s.clock.step(600))
        p.both(lambda s: s.add_pod(f"c{k}", cpu="1", memory="1Gi"))
        p.run(1)
        if p.port.provisioning.solve_ladder.rung() == 0:
            break
    assert p.port.snapshot()["solver_kind"] == "cuda"


CONSOLIDATION_CATALOGS = {
    "op_consolidation_delete": [
        ("m.large", dict(cpu=4, memory="16Gi", od_price=0.20))],
    "op_consolidation_pair_replace": [
        ("c.2xlarge", dict(cpu=8, memory="32Gi", od_price=0.34)),
        ("bulk.8xlarge", dict(cpu=32, memory="128Gi", od_price=0.578))],
}

OP_SCENARIOS = [
    op_mixed_pods,
    op_zone_spread_with_a_second_affinity_round,
    op_pods_fill_existing_nodes_before_any_launch,
    op_oversized_pod_gives_failed_scheduling,
    op_emptiness_after_its_ttl,
    op_consolidation_delete,
    op_consolidation_pair_replace,
    op_expiration,
    op_termination_drain,
    op_failing_solver_degrades_to_native_and_recovers,
]


@pytest.mark.parametrize("scenario", OP_SCENARIOS,
                         ids=[f.__name__[3:] for f in OP_SCENARIOS])
def test_operator_pair_scenario(scenario, default_planes):
    """The ten controller scenarios through both Operators'
    reconcile_all_once, every plane on: equal outcomes after every pass."""
    p = OperatorPair(CONSOLIDATION_CATALOGS.get(scenario.__name__, CATALOG))
    try:
        scenario(p)
        assert p.passes >= 2
    finally:
        p.close()


def hot_pools(s, zone: str) -> dict:
    """Rates above the rebalance threshold on every spot pool of the
    catalog's two cheapest types in `zone`."""
    rate = s.m("spot.forecaster").REBALANCE_RATE_THRESHOLD + 0.2
    cheap = sorted(s.catalog.types, key=lambda t: min(
        o.price for o in t.offerings))[:2]
    return {(t.name, zone, "spot"): rate for t in cheap}


def test_operator_pair_spot_storm(opair):
    """A hot forecast on the cheap spot pools of one zone: the provisioning
    solve goes through both RiskObjectives and the rebalance controller
    acts on both, with equal outcomes, spot counter deltas and
    DecisionRecords. One workload is pinned to the hot zone, so the
    spread phase cannot split it and the bar phase re-solves with an
    `option_mask` on the port's card rung."""
    p = opair
    p.both(_spot_od)
    for w in range(3):
        sel = {"topology.kubernetes.io/zone": "zone-1a"} if w == 0 else {}
        for i in range(8):
            p.both(lambda s: s.add_pod(f"w{w}-{i}", cpu="500m",
                                       memory="1Gi", node_selector=sel))
    for s in (p.jax, p.port):
        s.op.spotforecaster.set_live_source(
            lambda h=hot_pools(s, "zone-1a"): h)
        s.op.spotforecaster.refresh()
        assert s.op.spotobjective.active()
    solves = []
    prov = p.port.provisioning
    routed = prov._routed_solve

    def recorded(*args, option_mask=None, barred=None):
        result, kind = routed(*args, option_mask=option_mask, barred=barred)
        solves.append((kind, option_mask is not None))
        return result, kind

    prov._routed_solve = recorded
    p.run(3)
    d = p.deltas(PORT)
    assert d == p.deltas(JAX)
    assert d["spot_objective_solves"] >= 1
    assert d["spot_bars_rolled_back"] + d["spot_pools_barred"] >= 1
    assert ("cuda", True) in solves
    assert {kind for kind, _ in solves} == {"cuda"}
    recs = [r for r in decision_records(PORT, p.first_id)
            if r["kind"] == "spot-objective"]
    assert recs and (recs[0]["barred_pools"]
                     or recs[0]["accepted_concentrations"])
    assert not p.port.snapshot()["pending"]


def test_operator_pair_interruption_message(opair):
    """One spot interruption warning for a launched node: both operators
    cordon and drain it, terminate it and place its pods again, with equal
    outcomes after every pass."""
    p = opair
    p.both(_spot_od)
    for i in range(10):
        p.both(lambda s: s.add_pod(f"p-{i}", cpu="1", memory="1Gi"))
    p.run(2)
    victim = sorted(p.port.cluster.nodes)[0]
    assert victim == sorted(p.jax.cluster.nodes)[0]
    iids = p.both(lambda s: s.interrupt(victim))
    assert iids[0] == iids[1]
    p.run(3)
    snap = p.port.snapshot()
    assert victim not in snap["nodes"]
    assert not snap["pending"]
    assert p.port.op.cloudprovider.cloud.instances[iids[1]].state == \
        "terminated"
