"""The boundary: nothing the benchmark runs imports JAX, the JAX package or
its bench, and the reference imports nothing of the program."""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
FORBIDDEN = {"jax", "jaxlib", "flax", "karpenter_tpu", "benchmarks", "bench",
             "chip_smoke"}


def top_level_modules(code: str) -> "set[str]":
    env = {k: v for k, v in os.environ.items() if not k.startswith("JAX")}
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({m.split('.', 1)[0] for m in sys.modules})))"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_cpu_rehearsal_of_the_runner_loads_no_jax():
    mods = top_level_modules(
        "from portbench.run import cell_spec, run_cell\n"
        "from portbench.generator import load_json\n"
        "from portbench import control\n"
        "b = load_json('BENCHMARK.json')\n"
        "for w in ('inflate.burst',):\n"
        "    c, cfg, t = cell_spec(b, w)\n"
        "    r = run_cell(b, c, cfg, t, 5, 0.3, False, device='cpu')\n"
        "    assert r['correct'], r\n")
    assert "karpenter_tpu_torch" in mods
    assert not mods & FORBIDDEN, mods & FORBIDDEN


def test_the_reference_imports_nothing_of_the_program():
    mods = top_level_modules(
        "import portbench.reference.answer, portbench.reference.catalog\n"
        "import portbench.reference.scheduler, portbench.generator\n"
        "import portbench.stats\n")
    assert not mods & (FORBIDDEN | {"karpenter_tpu_torch", "torch"}), mods
