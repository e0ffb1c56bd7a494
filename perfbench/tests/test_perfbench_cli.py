"""``perfbench/run.py`` refuses to print a result where it cannot measure
the port: without a card, and in a checkout that holds only the
benchmark's own files."""

import shutil
import subprocess
import sys

import pytest
from conftest import ROOT

ARGS = ["--workload", "granite-8b.prefill-grouped", "--seed", "2147483999",
        "--seconds", "1", "--trace", "0"]


def run(cwd):
    return subprocess.run([sys.executable, "perfbench/run.py", *ARGS],
                          cwd=str(cwd), capture_output=True, text=True,
                          timeout=300)


def test_without_a_card_no_result():
    torch = pytest.importorskip("torch")
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = run(ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "no CUDA device" in out.stderr


def test_with_only_the_benchmark_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = run(tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "src/repro_torch" in out.stderr
