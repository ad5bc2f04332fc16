"""A run of a cell on the card (``cuda``: skips without one), and a run in
a directory that holds only the benchmark's files, which must fail."""

import json
import shutil
import subprocess
import sys

import pytest

from rgcn_bench import spec


def _card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
def test_a_short_run_on_the_card_is_correct():
    _card()
    out = subprocess.run(
        [sys.executable, "-m", "rgcn_bench.run", "--workload",
         "am_baseline_uniform", "--seed", str(2**31 + 5), "--seconds", "3",
         "--trace", "0"], cwd=spec.ROOT, capture_output=True, text=True,
        timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"


@pytest.mark.cuda
def test_the_benchmark_alone_fails(tmp_path):
    _card()
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec.BENCH_DIR, tmp_path / "rgcn_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "-m", "rgcn_bench.run", "--workload",
         "am_baseline_uniform", "--seed", "1", "--seconds", "1"],
        cwd=tmp_path, capture_output=True, text=True, timeout=600)
    assert out.returncode != 0 and out.stdout.strip() == ""
