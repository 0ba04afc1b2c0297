"""The import rule, by the abstract syntax tree of every file under
``benchmark/``: the JAX stack and the JAX package are refused everywhere,
compared by whole top-level name (the port's name begins with the JAX
package's); the reference also refuses the port.  And at run time: a run
without a card fails without a result line, and so does a run in a
directory that holds only the benchmark."""
import ast
import os
import shutil
import subprocess
import sys

import pytest

from benchmark import harness

REFERENCE_ALSO = (harness.PORT,)


def python_files():
    for base, dirs, files in os.walk(harness.HERE):
        dirs[:] = [d for d in dirs if not d.startswith((".", "__"))]
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.join(base, f)


def imported_top_levels(path):
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", None) == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


FILES = list(python_files())


@pytest.mark.parametrize("path", FILES,
                         ids=[os.path.relpath(p, harness.HERE) for p in FILES])
def test_no_forbidden_import(path):
    names = set(imported_top_levels(path))
    assert not names & set(harness.FORBIDDEN), path
    if os.sep + "reference" + os.sep in path:
        assert not names & set(REFERENCE_ALSO), path
        assert "benchmark" not in names, path


def test_whole_name_comparison():
    """The port's module is not taken for the JAX package's."""
    before = dict(sys.modules)
    try:
        sys.modules.pop("tacotron_wavenet_vocoder_korean_tpu", None)
        sys.modules.setdefault(harness.PORT, sys)
        assert harness.forbidden_modules() == []
        sys.modules["tacotron_wavenet_vocoder_korean_tpu.x"] = sys
        assert harness.forbidden_modules() == [
            "tacotron_wavenet_vocoder_korean_tpu"]
    finally:
        sys.modules.clear()
        sys.modules.update(before)


def run_bench(cwd):
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "wn_moon.vocode_b8", "--seed", "5", "--seconds", "1"],
        cwd=cwd, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))


def test_no_card_no_result():
    proc = run_bench(harness.ROOT)
    assert proc.returncode != 0
    assert '"correct"' not in proc.stdout


def test_benchmark_alone_no_result(tmp_path):
    shutil.copy(harness.MANIFEST, tmp_path / "BENCHMARK.json")
    shutil.copytree(harness.HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = run_bench(tmp_path)
    assert proc.returncode != 0
    assert '"correct"' not in proc.stdout
