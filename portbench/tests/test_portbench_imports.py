"""Nothing a run loads is JAX or the JAX package, and the reference loads
nothing of the program."""

import ast
import json
import os
import subprocess
import sys

import pytest

from portbench.harness import loader, runner

SCRIPT = """
import json, sys
sys.path.insert(0, {root!r})
import runpy
runpy.run_path({run!r}, run_name="portbench_run")  # run.py's own imports
from portbench.harness import runner
for cell in {cells!r}:
    runner.run(cell, 5, 0.01, True, device="cpu", max_jobs=1,
               scale={{"num_leaves": 8, "batch": 4, "check_jobs": 1, "trace_jobs": 1}})
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _clean_env():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return env


def test_a_run_loads_no_jax():
    cells = [w["name"] for w in json.loads((loader.ROOT / "BENCHMARK.json").read_text())["workloads"]]
    code = SCRIPT.format(root=str(loader.ROOT), run=str(loader.BENCH / "run.py"), cells=cells)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=_clean_env(),
                         cwd=loader.ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    top = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "crypto_primitives_tpu_torch" in top  # the program did run
    assert not top & set(runner.BANNED)  # compared whole: the port's name begins with the JAX package's


@pytest.mark.parametrize("path", sorted(str(p.relative_to(loader.BENCH)) for p in (loader.BENCH / "reference").glob("*.py")))
def test_reference_imports_nothing_of_the_program(path):
    tree = ast.parse((loader.BENCH / path).read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split(".")[0])
    assert not names & (set(runner.BANNED) | {"crypto_primitives_tpu_torch"})


def test_run_without_a_card_prints_no_result():
    out = subprocess.run([sys.executable, str(loader.BENCH / "run.py"), "--workload", "sha256_tree.commit",
                          "--seed", str(2**31 + 3), "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=loader.ROOT, env=_clean_env(), timeout=300)
    if "found 0" not in out.stderr:
        pytest.skip("a card is present")
    assert out.returncode == 2 and out.stdout == ""
