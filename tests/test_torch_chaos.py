"""The port's chaos runner (plan, injector, invariants and every drill)
against the JAX package's, on the CPU.

Two parts:

* The JAX package's chaos test files run again against the port, loaded
  by `tests.test_torch_operator.retarget` (karpenter_tpu imports pointed
  at karpenter_tpu_torch, every ChaosRunner and Operator built with
  device="cpu") and collected here under their own names: test_chaos,
  test_recovery and the resilience-plane cases of test_resilience (its
  three solver-wire classes run in tests/test_torch_service.py). Cases
  marked slow stay out, as in the JAX package.
* Lockstep: a JAX ChaosRunner and a port ChaosRunner(device="cpu") run
  seeds 0-2 of the default sweep and of the crash, storm and partition
  drills, and the spot storm at 500 nodes; the two artifacts must be
  equal once durations, timestamps and paths are stripped, the `tool`
  name is read as each package's own, and the solve rung's label is
  mapped (the JAX package's "tpu" is the port's "cuda"). Every other field
  is compared: fired faults, invariant verdicts, final nodes,
  consolidation actions, replay ledgers and key numbers, the profiling
  deltas of the continuous profiler's four counters among them. The spot
  plane's counters are process-wide and the
  spot-storm artifact embeds their absolute values, so they start at zero
  for each run in both packages.
"""

from __future__ import annotations

import importlib
import json
import re
from pathlib import Path

import pytest
import torch

from tests.test_torch_controllers import JAX, PORT
from tests.test_torch_operator import cases_except, collect, retarget

REPO = Path(__file__).resolve().parent.parent
RESILIENCE_WIRE = ("TestSolverDeadlineWire", "TestSolverBreakerFeedback",
                   "TestServiceSheds")

SOURCES = [
    # (file, tag, {case: reason to skip}, tests left out)
    ("test_chaos", "chaos", {}, ()),
    ("test_recovery", "recovery", {}, ()),
    # its solver-wire classes are collected in tests/test_torch_service.py
    ("test_resilience", "resilience", {}, RESILIENCE_WIRE),
]

COLLECTED: "dict[str, list]" = {}
for _file, _tag, _skips, _exclude in SOURCES:
    _mod = retarget(_file, f"{__name__}_{_file[5:]}")
    COLLECTED[_file] = collect(_mod, _tag, _skips, globals(), _exclude)


@pytest.fixture(autouse=True)
def quiet_host_samplers():
    """Both packages' host samplers stopped and joined before each case.
    The sweep, burst and storm drills disable profiling and read
    profiling.activity() at once for their strict-noop check, and a sampler
    that earlier cases started through solves may be mid-sweep then. The
    port's sampler reads its switch under the lock that activity() reads
    under; the JAX package's reads it outside, so a sweep begun before the
    switch can land after the "before" read and fail the check. A case that
    needs the sampler starts it again through ensure_started, as it does
    on its own."""
    for pkg in (JAX, PORT):
        importlib.import_module(f"{pkg}.profiling").PROFILER.stop()


@pytest.mark.parametrize("source", [s[0] for s in SOURCES])
def test_every_case_of_the_source_is_collected_or_left_out_on_purpose(
        source):
    """Each module-level test and test class of the source is collected
    here, but for the ones SOURCES leaves out."""
    exclude = next(s[3] for s in SOURCES if s[0] == source)
    got = sorted(n for n in COLLECTED[source]
                 if n.startswith(("test_", "Test")))
    want = [n for n in cases_except(source, ()) if n not in exclude]
    assert len(got) == len(want) > 0


# -- lockstep: both packages' runners, artifact for artifact -------------------

VOLATILE = ("duration_s", "artifact_path", "bundles")


def comparable(x, pkg: str):
    """An artifact without its volatile fields (wall durations, paths), its
    tool read as the package's own and the rung label "tpu" read as
    "cuda"."""
    if isinstance(x, dict):
        out = {}
        for k, v in x.items():
            if k in VOLATILE:
                continue
            if k == "tool":
                assert v == f"{pkg}.chaos", v
                continue
            out[k] = comparable(v, pkg)
        return out
    if isinstance(x, list):
        return [comparable(v, pkg) for v in x]
    if isinstance(x, str):
        return re.sub(r"\btpu\b", "cuda", x)
    return x


SPOT_COUNTER_MODULES = ("spot.forecaster", "spot.objective",
                        "spot.rebalance")


class fresh_spot_counters:
    """The spot plane's counters are process-wide, and the spot-storm
    artifact embeds the forecaster's absolute values: they start at zero
    for the run in both packages (what a drill in a process of its own
    sees), and the counts from before are added back afterwards."""

    def __init__(self, pkg: str):
        self.mods = [importlib.import_module(f"{pkg}.{m}")
                     for m in SPOT_COUNTER_MODULES]

    def __enter__(self):
        self.saved = [dict(mod._COUNTERS) for mod in self.mods]
        for mod in self.mods:
            mod._COUNTERS.update(dict.fromkeys(mod._COUNTERS, 0))

    def __exit__(self, *exc):
        for mod, saved in zip(self.mods, self.saved):
            for k, v in saved.items():
                mod._COUNTERS[k] = mod._COUNTERS.get(k, 0) + v


def first_difference(a, b, path="") -> "str | None":
    """The path of the first value where `a` and `b` differ, with both."""
    if isinstance(a, dict) and isinstance(b, dict):
        for k in sorted(set(a) | set(b), key=str):
            if k not in a or k not in b:
                return f"{path}.{k}: only in {'b' if k in b else 'a'}"
            d = first_difference(a[k], b[k], f"{path}.{k}")
            if d:
                return d
        return None
    if isinstance(a, list) and isinstance(b, list) and len(a) == len(b):
        for i, (x, y) in enumerate(zip(a, b)):
            d = first_difference(x, y, f"{path}[{i}]")
            if d:
                return d
        return None
    return None if a == b else f"{path}: {a!r:.300} != {b!r:.300}"


RUNS = [(f"{name}-seed{seed}", dict(kw, seed=seed))
        for seed in (0, 1, 2)
        for name, kw in (("sweep", {}), ("crash", {"crash": True}),
                         ("storm", {"storm": True}),
                         ("partition", {"partition": True}))] + [
    ("spot-storm-500", {"seed": 0, "spot_storm": True,
                        "spot_storm_nodes": 500,
                        "spot_storm_reclaims": 100})]


@pytest.mark.parametrize("kw", [kw for _, kw in RUNS],
                         ids=[name for name, _ in RUNS])
def test_lockstep_runners_write_the_same_artifact(kw, tmp_path):
    """The same drill in both packages, the port's on the CPU: equal
    artifacts, every scenario passing."""
    arts = {}
    for pkg in (JAX, PORT):
        runner = importlib.import_module(f"{pkg}.chaos").ChaosRunner
        dev = {"device": "cpu"} if pkg == PORT else {}
        with fresh_spot_counters(pkg):
            arts[pkg] = runner(out_dir=str(tmp_path / pkg), **kw,
                               **dev).run()
    assert arts[PORT]["passed"] and arts[JAX]["passed"]
    want = json.loads(json.dumps(comparable(arts[JAX], JAX), default=str))
    got = json.loads(json.dumps(comparable(arts[PORT], PORT), default=str))
    assert got == want, first_difference(want, got)


# -- the CLI ------------------------------------------------------------------------


def _tree_state(root: Path) -> dict:
    return {str(p): p.stat().st_mtime_ns for p in root.rglob("*")
            if p.is_file()}


@pytest.mark.parametrize("argv,drill", [
    ([], "sweep"), (["--partition"], "partition"),
    (["--spot-storm", "--spot-nodes", "120", "--spot-reclaims", "30"],
     "spot-storm")], ids=["sweep", "partition", "spot-storm"])
def test_cli_chaos_on_the_cpu_writes_only_its_out_dir(argv, drill, tmp_path,
                                                      capsys):
    """`chaos --seed 0 --device cpu --out-dir DIR` exits 0 with its
    artifact in DIR (tool karpenter_tpu_torch.chaos) and writes nothing
    under benchmarks/: the partition and spot-storm drills, which the JAX
    CLI records into benchmarks/results/ledger.jsonl, record nothing."""
    from karpenter_tpu_torch.__main__ import main

    before = _tree_state(REPO / "benchmarks")
    assert main(["chaos", "--seed", "0", "--device", "cpu", "--out-dir",
                 str(tmp_path), *argv]) == 0
    out = capsys.readouterr().out
    assert "PASS" in out and "FAIL" not in out
    (art,) = [p for p in tmp_path.iterdir() if p.suffix == ".json"
              and "bundle" not in p.name]
    doc = json.loads(art.read_text())
    assert doc["tool"] == "karpenter_tpu_torch.chaos" and doc["passed"]
    assert _tree_state(REPO / "benchmarks") == before


def test_cli_chaos_out_dir_default_is_git_ignored():
    """The default --out-dir lies under a directory .gitignore lists, not
    under benchmarks/."""
    from karpenter_tpu_torch import __main__ as cli

    src = Path(cli.__file__).read_text()
    default = re.search(r'"--out-dir", default="([^"]+)"', src).group(1)
    top = default.split("/")[0] + "/"
    assert not default.startswith("benchmarks")
    assert top in (REPO / ".gitignore").read_text().split()


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="a CUDA device is present: the drill would run")
def test_chaos_without_a_card_raises_naming_cuda(tmp_path):
    """Without a card and without --device cpu, `chaos` raises naming
    CUDA before any scenario runs (ChaosRunner resolves its device when it
    is built); nothing falls back to the CPU."""
    from karpenter_tpu_torch.__main__ import main
    from karpenter_tpu_torch.chaos import ChaosRunner

    with pytest.raises(RuntimeError, match="CUDA"):
        main(["chaos", "--seed", "0", "--out-dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="CUDA"):
        ChaosRunner(seed=0)
    assert not list(tmp_path.iterdir())
