"""Nothing of the benchmark imports JAX or the JAX package, and the plain
reference imports nothing of the program (top-level names compared
whole: the program's name begins with the JAX package's)."""

import ast
import subprocess
import sys

import pytest

from _setup import BENCH, ROOT

JAX_SIDE = {"jax", "jaxlib", "flax", "kmer_spans_tpu"}
PROGRAM = "kmer_spans_tpu_torch"


def top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


FILES = sorted(BENCH.rglob("*.py"))


def test_there_are_files():
    assert len(FILES) > 20 and BENCH / "run.py" in FILES


@pytest.mark.parametrize("path", FILES,
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_side_import(path):
    names = top_level_imports(path)
    assert not names & JAX_SIDE
    if "reference" in path.relative_to(BENCH).parts:
        assert PROGRAM not in names


def test_the_run_names_what_it_finds_loaded(monkeypatch):
    sys.path.insert(0, str(BENCH))
    import run
    monkeypatch.setitem(sys.modules, "kmer_spans_tpu_torch.fake", object())
    assert run._forbidden_loaded() == [] or "jax" in sys.modules
    monkeypatch.setitem(sys.modules, "kmer_spans_tpu.fake", object())
    assert "kmer_spans_tpu" in run._forbidden_loaded()


def test_no_card_no_result(tmp_path):
    """Without a card the command exits non-zero and prints no result."""
    res = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "lowcomp_k8.chromosome", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=120)
    assert res.returncode != 0 and res.stdout.strip() == ""


def test_benchmark_alone_gives_no_result(tmp_path):
    """A checkout with only BENCHMARK.json and the benchmark's folder:
    the run cannot import the program, so it fails and prints nothing."""
    import shutil
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys; sys.path[:0] = ['.', 'portbench'];"
            "from pathlib import Path; from benchlib import runner;"
            "print(runner.run_cell(Path('.'), 'lowcomp_k8.chromosome', 1, 1,"
            " False, 'cpu'))")
    res = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0 and res.stdout.strip() == ""
    assert "kmer_spans_tpu_torch" in res.stderr
