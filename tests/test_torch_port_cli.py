"""Port CLI on the CPU, its refusals, and the port's import hygiene."""

import ast
import glob
import json
import os
import shutil
import subprocess
import sys

import numpy as np
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


@pytest.mark.parametrize("exp", ["summation", "baseline", "mlp", "attention"])
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


@pytest.mark.parametrize("flags", [["-aggr", "attention"],
                                   ["-backend", "gather"]])
def test_cli_runs_non_fused_flags_on_cpu(tmp_path, flags, capsys):
    """``-aggr attention`` and ``-backend`` run end to end; the report
    carries the flag and the JAX CLI's result keys."""
    args = _args(tmp_path, "summation") + flags
    tmain.main(args + ["-device", "cpu"])
    assert "ACC ON TEST SET" in capsys.readouterr().out
    (report,) = glob.glob(str(tmp_path / "results" / "*" / "report_*.json"))
    report = json.load(open(report))
    jax_configs = vars(jmain.build_parser().parse_args(args))
    assert set(jax_configs) <= set(report)
    assert report[flags[0][1:]] == flags[1]
    assert set(report["summation"]) == {"accuracy", "loss", "f1 weighted",
                                        "f1 macro"}
    assert 0.0 <= report["Test acc summation"]["mean"] <= 100.0


def test_cli_without_exp_runs_every_head(tmp_path, capsys):
    """No ``-exp``: summation, MLP and attention, as the JAX CLI runs
    them, into one report."""
    args = [a for a in _args(tmp_path, "summation")
            if a not in ("-exp", "summation")]
    tmain.main(args + ["-device", "cpu"])
    out = capsys.readouterr().out
    assert out.count("ACC ON TEST SET") == 3
    (report,) = glob.glob(str(tmp_path / "results" / "*" / "report_*.json"))
    (series,) = glob.glob(str(tmp_path / "results" / "*" / "run_results_*.json"))
    report, series = json.load(open(report)), json.load(open(series))
    exps = ("summation", "mlp", "attention")
    assert set(series) == set(exps)
    for exp in exps:
        assert set(report[exp]) == {"accuracy", "loss", "f1 weighted",
                                    "f1 macro"}
        assert 0.0 <= report[f"Test acc {exp}"]["mean"] <= 100.0
    assert report["exp"] is None


def test_cli_attention_over_two_shards(tmp_path, capsys):
    """``-exp attention -devices 2``: the stacked ``[K, N, d]`` embedding
    laid out over a halo partition of 2 virtual CPU shards."""
    args = _args(tmp_path, "attention") + ["-devices", "2"]
    tmain.main(args + ["-device", "cpu"])
    assert "ACC ON TEST SET" in capsys.readouterr().out
    (report,) = glob.glob(str(tmp_path / "results" / "*" / "report_*.json"))
    report = json.load(open(report))
    assert report["devices"] == 2 and report["partition"] == "halo"
    assert set(report["attention"]) == {"accuracy", "loss", "f1 weighted",
                                        "f1 macro"}
    assert 0.0 <= report["Test acc attention"]["mean"] <= 100.0


@pytest.mark.parametrize("flags", [
    ["-ckpt_dir", "ck"], ["-ckpt_every", "2"], ["-plan_cache", "pc"],
    ["-e_viz", "true"],
])
def test_flags_run_on_cpu_and_write(tmp_path, flags, capsys):
    """The JAX CLI's checkpoint, plan-cache and embedding flags run on the
    CPU and write what they promise: ``-ckpt_dir`` the summary
    pre-training (and the plan cache under it), ``-ckpt_every`` alone
    nothing (as in the JAX CLI), ``-plan_cache`` one entry per graph,
    ``-e_viz`` the summation head's starting embedding."""
    flags = [flags[0], str(tmp_path / flags[1])] \
        if flags[0] in ("-ckpt_dir", "-plan_cache") else flags
    tmain.main(_args(tmp_path, "summation") + flags + ["-device", "cpu"])
    assert "ACC ON TEST SET" in capsys.readouterr().out
    written = sorted(os.path.relpath(os.path.join(d, f), tmp_path)
                     for d, _, fs in os.walk(tmp_path) for f in fs
                     if not d.startswith(str(tmp_path / "data"))
                     and not d.startswith(str(tmp_path / "results")))
    if flags[0] == "-ckpt_dir":
        assert "ck/transfer_SYNTH_0.npz" in written
        assert [w for w in written if w.startswith("ck/plans/reledges-")]
        assert not [w for w in written if "fit_" in w]
    elif flags[0] == "-plan_cache":
        # the original graph and its three attribute summaries
        assert len([w for w in written if w.startswith("pc/reledges-")]) == 4
    elif flags[0] == "-e_viz":
        emb = np.load(tmp_path / "results" / "embeddings"
                      / "SYNTH_attr_embedding.npy")
        assert emb.shape[1] == 12 and emb.dtype == np.float32
    assert written == [] or flags[0] in ("-ckpt_dir", "-plan_cache")


def test_cuda_device_without_cuda_raises(tmp_path, monkeypatch):
    """No fallback to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmain.main(_args(tmp_path, "summation"))


def test_port_imports_no_jax_optax_or_sklearn():
    """Every module of the port imported: neither the JAX package nor jax,
    optax or sklearn is loaded; chip_smoke.py imports none of them."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import scaling_rgcn_training_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "for m in ('ops.sddmm', 'parallel.mesh', 'parallel.reorder',\n"
        "          'parallel.ring_halo', 'parallel.fused_halo',\n"
        "          'parallel.halo', 'parallel.spmd', 'parallel.ipc',\n"
        "          'multihost_sim', 'rehearse_am', 'rehearse_am_dist',\n"
        "          'bench', 'bench_scaling', 'utils.tracing',\n"
        "          'measure_overlap'):\n"
        "    assert 'scaling_rgcn_training_tpu_torch.' + m in sys.modules, m\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('scaling_rgcn_training_tpu', 'jax', 'jaxlib', 'optax', 'sklearn')]\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    tree = ast.parse(open(os.path.join(ROOT, "chip_smoke.py")).read())
    names = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names}
    names |= {n.module for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.module}
    assert any(n.startswith("scaling_rgcn_training_tpu_torch") for n in names)
    assert not {n.split(".")[0] for n in names} & {
        "scaling_rgcn_training_tpu", "jax", "jaxlib", "optax", "sklearn"}


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
