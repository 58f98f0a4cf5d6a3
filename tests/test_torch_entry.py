"""The port's driver entry points (karpenter_tpu_torch/entry.py) and its
card probe (karpenter_tpu_torch/utils/cudaenv.py) against the JAX
package's __graft_entry__.py, on the CPU.

* example_problem/pad_inputs and stress_problem, encoded and padded, equal
  __graft_entry__'s _example_problem/_pad_inputs and _stress_problem in
  every PackInputs array and the slot bucket;
* entry(device="cpu")'s fn equals jax.jit of JAX's entry() fn in every
  PackResult field, exactly;
* dryrun_multichip on 2 gloo ranks at 1k pods passes its four checks and
  its mesh result equals JAX's pack_impl of the same padded problem; the
  8-rank run at 50k pods is in the slow tier, as JAX's
  test_full_stress_parity_50k is;
* `python -m karpenter_tpu_torch.entry 2 --device cpu` runs entry() and the
  2-rank dry run at 50k pods with JAX blocked; without --device it
  probes the card and, with none here, exits non-zero;
* without a card the entry points raise, and probe_card reports
  (False, note) within its timeout.
"""

from __future__ import annotations

import importlib.util
import subprocess
import sys
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from karpenter_tpu.ops.packer import pack_impl
from karpenter_tpu.parallel import sharded as jax_sharded
from karpenter_tpu_torch import entry as port
from karpenter_tpu_torch.models.encode import encode_problem
from karpenter_tpu_torch.ops.packer import PackInputs, PackResult
from tests.test_torch_boundary import _BLOCKER, _clean_env

REPO = Path(__file__).resolve().parent.parent
_GRAFT = {}


def graft():
    """__graft_entry__.py, loaded once as a module."""
    if "mod" not in _GRAFT:
        spec = importlib.util.spec_from_file_location(
            "graft_entry", REPO / "__graft_entry__.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _GRAFT["mod"] = mod
    return _GRAFT["mod"]


def assert_inputs_equal(got, want):
    """Two (PackInputs, n_slots): every leaf equal in shape, dtype and value
    (or None in both), and the same slot bucket."""
    (gi, gn), (wi, wn) = got, want
    assert gn == wn
    for name in PackInputs._fields:
        g, w = getattr(gi, name), getattr(wi, name)
        assert (g is None) == (w is None), name
        if w is not None:
            g, w = np.asarray(g), np.asarray(w)
            assert g.dtype == w.dtype and g.shape == w.shape, name
            np.testing.assert_array_equal(g, w, err_msg=name)


def jax_pack(inputs, n_slots: int) -> dict:
    """JAX's pack_impl of the padded problem, jitted: -> {field: numpy}."""
    r = jax.jit(pack_impl, static_argnames=("n_slots",))(inputs,
                                                          n_slots=n_slots)
    return {f: np.asarray(getattr(r, f)) for f in PackResult._fields}


@pytest.mark.parametrize("n_pods,n_types", [(64, 16), (32, 8), (7, 3)])
def test_example_problem_and_pad_inputs_equal_jax(n_pods, n_types):
    ge = graft()
    assert_inputs_equal(
        port.pad_inputs(port.example_problem(n_pods, n_types)),
        ge._pad_inputs(ge._example_problem(n_pods=n_pods, n_types=n_types)))


def test_entry_on_the_cpu_equals_jax_entry():
    fn, args = port.entry(device="cpu")
    got = fn(*args)
    assert isinstance(got, PackResult)
    assert all(v.device.type == "cpu" for v in got)
    jfn, jargs = graft().entry()
    want = jax.jit(jfn)(*jargs)
    for f in PackResult._fields:
        g, w = got._asdict()[f].numpy(), np.asarray(getattr(want, f))
        assert g.shape == w.shape, f
        np.testing.assert_array_equal(g, w, err_msg=f)
    assert int(got.assign.sum()) == 64


def test_stress_problem_encoded_and_padded_equals_jax():
    catalog, provs, pods = port.stress_problem(1000)
    assert (len(catalog.types), len(provs), len(pods)) == (603, 8, 1000)
    enc, *_ = graft()._stress_problem(1000)
    assert_inputs_equal(
        port.pad_inputs(encode_problem(catalog, provs, pods, grid=None)),
        graft()._pad_inputs(enc))


def test_dryrun_on_two_ranks_passes_its_checks_and_equals_jax(capsys):
    """Two gloo ranks at 1k pods: the four checks pass on rank 0 (a failing
    one raises), every pod is placed, and the mesh's PackResult equals
    JAX's pack_impl of the same padded problem."""
    t0 = time.perf_counter()
    d = port.dryrun_multichip(2, n_pods=1000, device="cpu")
    assert time.perf_counter() - t0 < 60
    line = capsys.readouterr().out
    assert line.startswith("dryrun_multichip OK: 2 devices, mesh "
                           "{'nodes': 1, 'types': 2}")
    jmesh = jax_sharded.make_mesh(2)
    assert d["axes"] == dict(zip(jmesh.axis_names, jmesh.devices.shape))
    assert d["placed"] == d["pods_total"] == 1000 and d["unsched"] == 0
    assert d["oracle_pods"] == 1000 and d["candidates"] == 9
    assert d["native_decisions"] == d["nodes"] > 0
    assert len(d["launches_per_rank"]) == 2
    inputs, n_slots = graft()._pad_inputs(graft()._stress_problem(1000)[0])
    want = jax_pack(inputs, n_slots)
    for f in PackResult._fields:
        np.testing.assert_array_equal(d["result"][f], want[f], err_msg=f)


@pytest.mark.slow
def test_dryrun_on_eight_ranks_at_50k_equals_jax():
    """BASELINE config 4 at full size over 8 ranks (mesh nodes 4 x types
    2): 50000 of 50000 pods on the 83 nodes MULTICHIP_r05.json records for
    JAX's 8-device run, the oracle at 2k, 33 consolidation candidates, and
    the mesh result equal to JAX's pack_impl."""
    d = port.dryrun_multichip(8, device="cpu")
    assert d["axes"] == {"nodes": 4, "types": 2}
    assert d["placed"] == d["pods_total"] == 50_000
    assert d["nodes"] == 83 and d["oracle_pods"] == 2000
    assert d["candidates"] == 33
    inputs, n_slots = graft()._pad_inputs(graft()._stress_problem()[0])
    want = jax_pack(inputs, n_slots)
    for f in PackResult._fields:
        np.testing.assert_array_equal(d["result"][f], want[f], err_msg=f)


_RUN_MAIN = _BLOCKER + """
sys.meta_path.insert(0, Blocker())
from karpenter_tpu_torch.entry import main
rc = main(sys.argv[1:])
leaked = sorted(m for m in sys.modules if blocked(m))
assert not leaked, leaked
sys.exit(rc)
"""


def test_module_on_the_cpu_runs_entry_and_the_dry_run_without_jax():
    """`python -m karpenter_tpu_torch.entry 2 --device cpu`, with jax,
    triton and the reference package blocked in the driver (its ranks are
    plain interpreters of the port): entry() places its 64 pods, then the
    2-rank dry run places config 4's 50000 pods on 83 nodes."""
    out = subprocess.run([sys.executable, "-c", _RUN_MAIN, "2", "--device",
                          "cpu"], cwd=REPO, env=_clean_env(),
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-3000:]
    lines = out.stdout.splitlines()
    assert "entry OK on cpu: 64" in lines
    assert any(line.startswith("dryrun_multichip OK: 2 devices")
               and "-> 50000/50000 pods on 83 nodes" in line
               and "oracle at 2k" in line for line in lines), out.stdout


def test_module_without_a_card_exits_nonzero():
    """With no card and no --device, the module probes the card and exits
    non-zero with the probe's note; nothing runs on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the module would run")
    out = subprocess.run([sys.executable, "-m", "karpenter_tpu_torch.entry",
                          "2"], cwd=REPO, env=_clean_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert "entry OK" not in out.stdout and "dryrun" not in out.stdout
    assert "no usable CUDA card (rc=" in out.stderr


def test_entry_points_without_cuda_raise(monkeypatch):
    """Given no device and no card, entry() and dryrun_multichip raise
    naming CUDA before they build or spawn anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spawned = []
    monkeypatch.setattr(port, "spawn_ranks",
                        lambda *a: spawned.append(a))
    with pytest.raises(RuntimeError, match="CUDA"):
        port.entry()
    with pytest.raises(RuntimeError, match="CUDA"):
        port.entry(device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        port.dryrun_multichip(2, n_pods=1000)
    assert not spawned


def test_probe_card_reports_no_card_within_its_timeout():
    """Here there is no card: the probe's subprocess fails to initialize
    CUDA, and the probe comes back as (False, note) with the failure, well
    inside its timeout."""
    from karpenter_tpu_torch.utils.cudaenv import probe_card

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the probe would succeed")
    t0 = time.perf_counter()
    ok, note = probe_card(timeout_s=60)
    assert time.perf_counter() - t0 < 60
    assert not ok
    assert note.startswith("rc=") and "CUDA" in note
