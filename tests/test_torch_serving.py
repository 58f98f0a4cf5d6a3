"""The port's serving plane, CLI and cloud-backend edge against the JAX
package's, on the CPU.

Three parts:

* The JAX package's test files for these parts run again against the
  port, loaded by `tests.test_torch_operator.retarget` (karpenter_tpu
  imports pointed at karpenter_tpu_torch, every `Operator(` built with
  device="cpu") and collected here under their own names: test_serving,
  test_tooling and test_cloudbackend whole, and the serving and CLI cases
  of test_explain, and test_deployed_topology, whose controller solves and
  consolidates through the port's gRPC solver sidecar (its rung name
  `last_solver_kind == "tpu"` read as the port's, "cuda"). No other
  assertion is dropped or changed.
* A served lockstep pair: a JAX and a port Operator, each over its own
  package's mini apiserver through an HttpKubeStore and each serving its
  listeners, run each of the ten controller scenarios of
  tests/test_torch_operator.py, every plane on. After every pass the pair compares
  what OperatorPair compares, with the stored objects read back over HTTP
  by a second client, statusz fetched from /debug/statusz, and the
  DecisionRecords fetched from /debug/decisions.
* The port's CLI: `python -m karpenter_tpu_torch controller --simulate
  --device cpu` boots in a subprocess, serves, and exits 0 on SIGINT.
  (`solver-serve` boots: tests/test_torch_service.py runs it, and
  tests/test_torch_multiprocess.py runs `solver-serve --distributed`.)
"""

from __future__ import annotations

import importlib
import json
import signal
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.request
from pathlib import Path

import pytest
import torch

from tests.test_torch_controllers import CATALOG, PORT, TPU
from tests.test_torch_operator import (CONSOLIDATION_CATALOGS, OP_SCENARIOS,
                                       OperatorPair, OperatorStack, collect,
                                       default_planes, retarget, cases_except)

REPO = Path(__file__).resolve().parent.parent


SOURCES = [
    # (file, tag, {case: reason to skip}, tests left out, label
    #  substitutions)
    ("test_serving", "serving", {}, (), ()),
    ("test_tooling", "tooling", {}, (), ()),
    ("test_cloudbackend", "cloudbackend", {}, (), ()),
    # the decisions endpoint and the explain CLI; the rest of the file is
    # the explain plane, which tests/test_torch_explain.py holds to JAX
    ("test_explain", "explain", {}, cases_except("test_explain", (
        "TestDebugDecisionsEndpoint", "TestExplainCLI")), ()),
    ("test_deployed_topology", "deployed", {}, (), ((
        'assert op.provisioning.last_solver_kind == "tpu"',
        'assert op.provisioning.last_solver_kind == "cuda"'),)),
]

COLLECTED: "dict[str, list]" = {}
for _file, _tag, _skips, _exclude, _labels in SOURCES:
    _mod = retarget(_file, f"{__name__}_{_file[5:]}", labels=_labels)
    COLLECTED[_file] = collect(_mod, _tag, _skips, globals(), _exclude)


# -- a served lockstep pair -----------------------------------------------------


def _get_json(url: str):
    with urllib.request.urlopen(url, timeout=10) as r:
        return json.loads(r.read())


class ServedStack(OperatorStack):
    """An OperatorStack whose Operator stores through an HttpKubeStore over
    its own package's mini apiserver and serves its metrics and health
    listeners on ephemeral ports (the webhook listener off)."""

    def __init__(self, pkg: str, catalog_spec, **settings_kw):
        serve = importlib.import_module(f"{pkg}.fake.apiserver").serve
        self.api, port, _ = serve()
        self.url = f"http://127.0.0.1:{port}"
        self.store = importlib.import_module(
            f"{pkg}.coordination.httpkube").HttpKubeStore(server=self.url)
        self.store.start()
        super().__init__(pkg, catalog_spec, **settings_kw)
        self.ports = self.op.serving.start()
        self.base = f"http://127.0.0.1:{self.ports['metrics']}"

    def operator_kwargs(self) -> dict:
        return dict(kube=self.store, serve_http=True, metrics_port=0,
                    health_port=0, webhook_port=-1)

    def snapshot(self, kube=None) -> dict:
        """The stored objects as a second client reads them over HTTP."""
        if kube is None:
            kube = self.m("coordination.httpkube").HttpKubeStore(
                server=self.url)
            for kind in ("pods", "machines"):
                kube._relist(kind)
        return super().snapshot(kube)

    def statusz_doc(self) -> dict:
        """/debug/statusz, with the listeners' bound ports (ephemeral, so
        different in each stack) read as their names."""
        doc = _get_json(f"{self.base}/debug/statusz")
        doc["serving"]["bound"] = sorted(doc["serving"]["bound"])
        return doc

    def served_decisions(self, since: int) -> dict:
        """/debug/decisions: the index head and each record filed from
        d-`since` on, fetched by id, without trace ids and timestamps and
        with the rung name in `routing` read as cuda."""
        index = _get_json(f"{self.base}/debug/decisions?limit=256")
        records = []
        for entry in index["decisions"]:
            if int(entry["id"][2:]) < since:
                continue
            rec = _get_json(f"{self.base}/debug/decisions?id={entry['id']}")
            rec = {k: v for k, v in rec.items() if k not in ("trace_id",
                                                            "ts")}
            if isinstance(rec.get("routing"), str):
                rec["routing"] = TPU.sub("cuda", rec["routing"])
            records.append((entry["kind"], rec))
        return {"enabled": index["enabled"], "schema": index["schema"],
                "records": records}

    def close(self):
        super().close()
        self.store.stop()
        self.api.shutdown()
        self.api.server_close()


class ServedPair(OperatorPair):
    def __init__(self, catalog):
        super().__init__(catalog, stack=ServedStack)

    def compare(self) -> None:
        super().compare()
        dj = self.jax.served_decisions(self.first_id)
        dp = self.port.served_decisions(self.first_id)
        assert dp == dj, self.passes
        assert dp["enabled"] and dp["records"]


@pytest.mark.parametrize("scenario", OP_SCENARIOS,
                         ids=[f.__name__[3:] for f in OP_SCENARIOS])
def test_served_operator_pair_scenario(scenario, default_planes):
    """Controller scenarios through two served Operators, each over its own
    package's mini apiserver: equal objects over HTTP, statusz sections
    and DecisionRecords after every pass."""
    p = ServedPair(CONSOLIDATION_CATALOGS.get(scenario.__name__, CATALOG))
    try:
        scenario(p)
        assert p.passes >= 2
    finally:
        p.close()


# -- the port's CLI -------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _status(url: str) -> int:
    try:
        with urllib.request.urlopen(url, timeout=5) as r:
            return r.status
    except urllib.error.HTTPError as e:
        return e.code
    except OSError:
        return 0


def test_cli_controller_boots_serves_and_stops_on_sigint(tmp_path):
    """`controller --simulate --device cpu` boots in its own process,
    answers /readyz, /metrics and /debug/statusz, names its device, and
    on SIGINT stops with exit code 0 and writes its state file."""
    metrics, health = _free_port(), _free_port()
    state = tmp_path / "account.json"
    proc = subprocess.Popen(
        [sys.executable, "-m", PORT, "controller", "--simulate",
         "--device", "cpu", "--metrics-port", str(metrics),
         "--health-port", str(health), "--webhook-port", "-1",
         "--state", str(state)],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    try:
        deadline = time.monotonic() + 60
        while _status(f"http://127.0.0.1:{health}/readyz") != 200:
            assert proc.poll() is None, proc.stdout.read()
            assert time.monotonic() < deadline, "no /readyz 200 in 60 s"
            time.sleep(0.2)
        with urllib.request.urlopen(
                f"http://127.0.0.1:{metrics}/metrics", timeout=5) as r:
            assert b"karpenter_" in r.read()
        snap = _get_json(f"http://127.0.0.1:{metrics}/debug/statusz")
        assert snap["tool"] == "karpenter_tpu.statusz"
        assert snap["serving"]["bound"] == {"metrics": metrics,
                                            "health": health}
        proc.send_signal(signal.SIGINT)
        out, _ = proc.communicate(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, out
    assert "controller running" in out and "device=cpu" in out
    assert state.is_file() and "saved simulated account" in out


def test_cli_version(capsys):
    from karpenter_tpu_torch import __version__
    from karpenter_tpu_torch.__main__ import main

    assert main(["version"]) == 0
    assert capsys.readouterr().out.strip() == __version__


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="a CUDA device is present: boot would succeed")
def test_cli_controller_without_a_card_raises():
    """Without a card and without --device cpu, boot raises as the
    Operator's device resolution does; nothing falls back to the CPU."""
    from karpenter_tpu_torch.__main__ import main

    with pytest.raises(RuntimeError, match="CUDA"):
        main(["controller", "--simulate", "--metrics-port", "-1",
              "--health-port", "-1", "--webhook-port", "-1"])


def test_fleetz_answers_200_with_the_operators_fleet_view(served_op):
    """/debug/fleetz serves the operator's FleetView: the schema-versioned
    cross-replica document with the operator's own replica row."""
    op, ports = served_op
    doc = _get_json(f"http://127.0.0.1:{ports['metrics']}/debug/fleetz")
    assert doc["tool"] == "karpenter-tpu-fleetz"
    assert doc["schema"] == op.fleetview.fleetz()["schema"]
    assert list(doc["replicas"]) == [op.fleetview.name]
    assert doc["replicas"][op.fleetview.name]["healthy"] is True
