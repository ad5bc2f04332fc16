"""Port CLI on the CPU, its refusals, and the port's import hygiene."""

import glob
import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from scaling_rgcn_training_tpu import main as jmain
from scaling_rgcn_training_tpu_torch import main as tmain

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _args(tmp_path, exp):
    return ["-dataset", "SYNTH", "-exp", exp, "-epochs", "3", "-i", "1",
            "-emb", "12", "-hl", "8", "-synth_entities", "300",
            "-data_root", str(tmp_path / "data"),
            "-results_root", str(tmp_path / "results")]


@pytest.mark.parametrize("exp", ["summation", "baseline"])
def test_cli_runs_on_cpu_with_jax_result_keys(tmp_path, exp, capsys):
    """Summary pre-training, transfer and fine-tuning on the CPU; the
    results JSON carry the JAX CLI's keys (its configs, the per-experiment
    series and the test metrics) plus ``device``."""
    args = _args(tmp_path, exp)
    tmain.main(args + ["-device", "cpu"])
    assert "ACC ON TEST SET" in capsys.readouterr().out
    (report,) = glob.glob(str(tmp_path / "results" / "*" / "report_*.json"))
    (series,) = glob.glob(str(tmp_path / "results" / "*" / "run_results_*.json"))
    report, series = json.load(open(report)), json.load(open(series))

    jax_configs = vars(jmain.build_parser().parse_args(args))
    expected = set(jax_configs) | {"num_sums", "sum files", exp,
                                   f"Test acc {exp}", f"Test F1 weighted {exp}",
                                   f"Test F1 macro {exp}"}
    assert set(report) == expected | {"device"}
    assert set(report[exp]) == {"accuracy", "loss", "f1 weighted", "f1 macro"}
    assert set(series) == {exp}
    for metric, bands in series[exp].items():
        assert len(bands) == 3 and all(len(b) == 3 for b in bands), metric
    assert 0.0 <= report[f"Test acc {exp}"]["mean"] <= 100.0


@pytest.mark.parametrize("flags", [
    ["-exp", "mlp"], ["-exp", "attention"], [], ["-aggr", "attention"],
    ["-devices", "2"], ["-ckpt_dir", "ck"], ["-ckpt_every", "2"],
    ["-plan_cache", "pc"], ["-backend", "gather"], ["-e_viz", "true"],
])
def test_unported_flags_raise(tmp_path, flags):
    base = ["-exp", "summation"] if "-exp" not in flags and flags else []
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        tmain.main(base + flags + ["-device", "cpu",
                                   "-data_root", str(tmp_path)])
    assert not os.listdir(tmp_path)


def test_cuda_device_without_cuda_raises(tmp_path, monkeypatch):
    """No fallback to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmain.main(_args(tmp_path, "summation"))


def test_port_imports_no_jax_optax_or_sklearn():
    code = (
        "import sys\n"
        "import scaling_rgcn_training_tpu_torch.main\n"
        "import scaling_rgcn_training_tpu_torch.ops.span_kernels\n"
        "import scaling_rgcn_training_tpu_torch.train.trainer\n"
        "import scaling_rgcn_training_tpu_torch.graphs.synthetic\n"
        "import scaling_rgcn_training_tpu.utils.results\n"
        "import scaling_rgcn_training_tpu.utils.timing\n"
        "import scaling_rgcn_training_tpu.utils.checks\n"
        "bad = [m for m in ('jax', 'jaxlib', 'optax', 'sklearn') if m in sys.modules]\n"
        "assert not bad, bad\n"
        "assert 'scaling_rgcn_training_tpu.graphs' not in sys.modules\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_chip_smoke_refuses_without_a_gpu_or_the_package(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this card would run the smoke test")
    for cwd in (ROOT, str(tmp_path)):
        script = shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path) \
            if cwd != ROOT else os.path.join(ROOT, "chip_smoke.py")
        res = subprocess.run([sys.executable, script], cwd=cwd,
                             capture_output=True, text=True, timeout=120)
        assert res.returncode != 0
        assert '"ok"' not in res.stdout
