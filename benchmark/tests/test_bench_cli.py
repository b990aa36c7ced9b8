"""The command: with no CUDA card it exits with a code other than 0 and
prints no result; so it does in a directory that holds only the
benchmark's own files.  The cells on the card (marked ``cuda``)."""

import json
import shutil
import subprocess
import sys

import pytest

from benchmark import harness

CELLS = [w["name"] for w in json.loads((harness.ROOT / "BENCHMARK.json").read_text())["workloads"]]


def _run(cwd, cell, seconds="1", trace="0"):
    return subprocess.run([sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
                           str(2**31 + 1), "--seconds", seconds, "--trace", trace],
                          cwd=cwd, capture_output=True, text=True, timeout=600)


def test_no_card_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    out = _run(harness.ROOT, CELLS[0])
    assert out.returncode != 0 and out.stdout == ""


def test_the_benchmark_alone_gives_no_result(tmp_path):
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    out = _run(tmp_path, CELLS[0])
    assert out.returncode != 0 and out.stdout == ""


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(cuda, cell):
    for trace in ("0", "1"):
        out = _run(harness.ROOT, cell, seconds="2", trace=trace)
        assert out.returncode == 0, out.stderr[-4000:]
        result = json.loads(out.stdout.strip().splitlines()[-1])
        assert result["correct"] is True, result["checks"]
        assert result["device"]["platform"] == "gpu"
        assert list(result)[-1] == "checks"
