"""A run needs a card and the repository; nothing it imports is JAX or the
JAX package, and the reference imports nothing of the program."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
FORBIDDEN = {"jax", "jaxlib", "flax", "psvi_tpu"}


def _python(code, cwd=ROOT, env=None):
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, capture_output=True, text=True,
                          timeout=600, env=env)


def _no_card_env():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("JAX_PLATFORMS", None)
    return env


def test_a_run_without_a_card_fails_and_prints_no_result():
    p = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", "lenet_m100",
                        "--seed", "1", "--seconds", "1"], cwd=ROOT, capture_output=True,
                       text=True, timeout=600, env=_no_card_env())
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "CUDA" in p.stderr


def test_a_run_with_only_the_benchmark_files_fails(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", "lenet_m100",
                        "--seed", "1", "--seconds", "1"], cwd=tmp_path, capture_output=True,
                       text=True, timeout=600, env=_no_card_env())
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_the_run_imports_no_jax():
    code = (
        "import sys, time, json\n"
        "sys.path.insert(0, 'portbench/tests')\n"
        "from conftest import toy\n"
        "from portbench import harness as H\n"
        "import portbench.run\n"
        "c = toy('lenet_m100'); c.limits = {'loss': 1.0}\n"
        "H.run_cell(c, 3, 1.0, False, time.perf_counter(), device='cpu')\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    p = _python(code, env=_no_card_env())
    assert p.returncode == 0, p.stderr[-2000:]
    loaded = set(json.loads(p.stdout.strip().splitlines()[-1]))
    assert "psvi_torch" in loaded and not loaded & FORBIDDEN


def test_the_reference_imports_nothing_of_the_program():
    code = (
        "import sys, json\n"
        "import portbench.reference.common, portbench.reference.lenet\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    p = _python(code)
    assert p.returncode == 0, p.stderr[-2000:]
    loaded = set(json.loads(p.stdout.strip().splitlines()[-1]))
    assert not loaded & (FORBIDDEN | {"psvi_torch"})
