"""The runner: its contract with BENCHMARK.json, its last line, its refusal
without a card, and the check that decides `correct`, which the control
and each planted fault must fail."""

import dataclasses
import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from portbench.control import control_wrong
from portbench.generator import ROOT, load_json
from portbench.run import cell_spec, run_cell
from portbench.tests.test_portbench_generator import SCALE5

BENCH = load_json("BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_names_files_that_exist():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    names = {}
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[group]:
            assert NAME.match(entry["name"]), entry["name"]
            assert entry["name"] not in names
            names[entry["name"]] = group
    for c in BENCH["configs"]:
        assert c["file"].startswith("portbench/")
        assert os.path.isfile(os.path.join(ROOT, c["file"]))
        assert load_json(c["file"])["reduced"] == c["reduced"]
    for w in BENCH["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert os.path.isfile(
            os.path.join(ROOT, "portbench/traffic", w["traffic"] + ".json"))
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for group, d in (("end_to_end", BENCH["end_to_end"]),
                     ("layers", BENCH["per_layer"])):
        for m in d:
            assert UNIT.match(m["unit"]) and m["better"] in ("lower",
                                                              "higher")
            assert os.path.isfile(
                os.path.join(ROOT, "portbench", group, m["name"] + ".py"))
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        for w in m["workloads"]:
            assert "workloads" not in e2e[m["moves"]] or \
                w in e2e[m["moves"]]["workloads"]
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25


def cpu_run(workload, seconds=0.5, seed=11, trace=False, system=None):
    cell, config, traffic = cell_spec(BENCH, workload)
    return run_cell(BENCH, cell, config, traffic, seed, seconds, trace,
                    device="cpu", system=system)


def test_the_last_line_holds_the_contracts_keys_with_the_checks_last():
    res = cpu_run("inflate.burst")
    assert list(res) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    assert res["correct"] is True and res["attempted"] > 0
    assert set(res["metrics"]) == {"solve_p95_ms", "pods_per_s", "setup_s"}
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert set(res["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    assert res["checks"] == {"wrong_answers": {"value": 0, "limit": 0}}
    json.dumps(res)


def run_module(cwd, env=None):
    return subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         "inflate.burst", "--seed", "3", "--seconds", "1",
         "--trace", "0"], cwd=cwd, env=env, capture_output=True, text=True,
        timeout=600)


def test_without_a_card_it_prints_no_result_and_fails():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = run_module(ROOT, env)
    assert out.returncode == 2 and out.stdout.strip() == ""
    assert "CUDA card" in out.stderr


def test_with_only_the_benchmarks_files_it_fails(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    out = run_module(tmp_path)
    assert out.returncode != 0 and "{" not in out.stdout


@pytest.mark.parametrize("traffic,requests", [("burst", 2), (SCALE5, 40)])
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_the_control_fails_the_check(traffic, requests, seed):
    _cell, config, burst = cell_spec(BENCH, "inflate.burst")
    t = burst if traffic == "burst" else traffic
    assert control_wrong(config, t, seed, requests) == requests


# -- faults planted in the program, where it produces its answer ------------

def _half_of_the_pods(monkeypatch):
    from karpenter_tpu_torch.solver import core

    orig = core.TorchSolver._solve_once

    def solve_once(self, pods, *a, **k):
        return orig(self, pods[: len(pods) // 2], *a, **k)
    monkeypatch.setattr(core.TorchSolver, "_solve_once", solve_once)


def _a_decision_altered(monkeypatch):
    from karpenter_tpu_torch.solver import core

    orig = core.decode

    def decode(*a, **k):
        res = orig(*a, **k)
        if res.nodes:
            n = res.nodes[0]
            n.option = dataclasses.replace(
                n.option, zone="zone-1c" if n.option.zone != "zone-1c"
                else "zone-1a")
        return res
    monkeypatch.setattr(core, "decode", decode)


def _a_step_keeps_its_state(monkeypatch):
    from karpenter_tpu_torch.ops import packer

    orig = packer._step

    def step(inputs, loop, state, *a, **k):
        kept = packer.PackState(*(t.clone() for t in state))
        _new, rows = orig(inputs, loop, state, *a, **k)
        return kept, rows
    monkeypatch.setattr(packer, "_step", step)


@pytest.mark.parametrize("workload,fault", [
    ("inflate.burst", _half_of_the_pods),
    ("inflate.burst", _a_decision_altered),
    ("inflate.burst", _a_step_keeps_its_state),
])
def test_a_fault_in_the_timed_path_makes_the_run_not_correct(
        workload, fault, monkeypatch):
    fault(monkeypatch)
    res = cpu_run(workload, seconds=0.3)
    assert res["correct"] is False
    assert res["checks"]["wrong_answers"]["value"] >= 1


@pytest.mark.card
@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_a_cell_runs_correct_on_the_card(card, workload):
    for trace in (0, 1):
        out = subprocess.run(
            [sys.executable, "-m", "portbench.run", "--workload", workload,
             "--seed", str(2**31 + 17), "--seconds", "3", "--trace",
             str(trace)], cwd=ROOT, capture_output=True, text=True,
            timeout=360)
        assert out.returncode == 0, out.stderr[-3000:]
        res = json.loads(out.stdout.strip().splitlines()[-1])
        assert res["correct"] is True and res["failed"] == 0
        assert res["device"]["platform"] == "gpu"
        assert res["device"]["kind"] == card
        if trace:
            assert 0 < res["device"]["busy_s"] < res["device"]["window_s"]
