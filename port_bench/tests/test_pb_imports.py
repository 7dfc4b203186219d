"""What the benchmark loads: nothing of JAX or of the JAX package,
compared by whole top-level names (the port's name begins with the JAX
package's), and the reference nothing of the port either."""

import ast
import shutil
import subprocess
import sys

from pbench import runner

from conftest import BENCH, REPO

FORBIDDEN = {"jax", "jaxlib", "flax", "attpc_engine_tpu"}


def imported(path) -> set[str]:
    """Top-level names of the modules a source file imports (absolute
    imports only; relative ones stay inside its package)."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_source_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        assert not imported(path) & FORBIDDEN, path


def test_the_reference_imports_nothing_of_the_port():
    for path in (BENCH / "benchref").rglob("*.py"):
        assert "attpc_engine_tpu_torch" not in imported(path), path
        assert "pbench" not in imported(path), path


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "attpc_engine_tpu_torch_like", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping", sys)
    for name in FORBIDDEN:
        monkeypatch.delitem(sys.modules, name, raising=False)
    assert runner.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "attpc_engine_tpu.detector", sys)
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert runner.forbidden_modules() == ["attpc_engine_tpu", "jax"]


def run_py(cwd):
    return subprocess.run(
        [sys.executable, "port_bench/run.py", "--workload", "c16dd.keep",
         "--seed", "3", "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=300)


def test_without_a_card_no_result(tmp_path):
    """Here torch finds no card: the run exits with another code than 0
    and prints no result."""
    import torch

    if torch.cuda.is_available():
        return
    done = run_py(REPO)
    assert done.returncode != 0 and done.stdout == ""


def test_without_the_port_no_result(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's folder."""
    shutil.copytree(BENCH, tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    done = run_py(tmp_path)
    assert done.returncode != 0 and done.stdout == ""
