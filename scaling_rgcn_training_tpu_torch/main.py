"""Experiment CLI — same surface as the JAX package's ``main.py``
(reference main.py:74-103), plus ``-device`` (default ``cuda``).

Runs the summary-graph experiments: pre-train on summary graphs, transfer
embeddings + R-GCN weights into a new model (summation, MLP or attention
head), and fine-tune on the full original graph, reporting per-epoch
metrics and test-set results over ``-i`` iterations. With no ``-exp`` it
runs summation, MLP and attention.

Every flag of the JAX CLI works. The CLI never falls back to the CPU:
``-device cuda`` without a CUDA device is an error. ``-devices S`` trains
over a mesh of S shards (``-partition``, ``-reorder``): with ``-device
cuda``, S cards (fewer is an error); with ``-device cpu``, S virtual
shards on the CPU. ``-ckpt_dir D`` keeps the summary pre-training of
iteration j in ``D/transfer_{dataset}_{j}.npz`` and resumes from it; with
``-ckpt_every K`` the fine-tuning also checkpoints every K epochs and
resumes where a crashed run stopped. ``-plan_cache P`` (by default
``D/plans`` with ``-ckpt_dir``) keeps the host-built edge plans. ``-e_viz``
saves the summation head's starting embedding (``utils/viz.py``).
``-sum dummy`` and ``-sum bisim`` read summaries made by
``graphs/summarize/dummy.py`` and ``bisim.py``.
"""

from __future__ import annotations

import argparse
import os
from typing import Any, Dict

import torch

from scaling_rgcn_training_tpu_torch.graphs.dataset import Dataset
from scaling_rgcn_training_tpu_torch.graphs.summarize.attribute import create_sum_map
from scaling_rgcn_training_tpu_torch.train.trainer import Trainer, count_trainable_parameters
from scaling_rgcn_training_tpu_torch.utils import timing
from scaling_rgcn_training_tpu_torch.utils.checks import do_checks
from scaling_rgcn_training_tpu_torch.utils.results import Results
from scaling_rgcn_training_tpu_torch.utils.viz import save_and_viz_embedding


def strtobool(x: str) -> bool:
    v = x.lower()
    if v in ("y", "yes", "t", "true", "on", "1"):
        return True
    if v in ("n", "no", "f", "false", "off", "0"):
        return False
    raise ValueError(f"invalid truth value {x!r}")


def resolve_device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"-device {name}: no CUDA device is available "
                           "(pass -device cpu to run on the CPU)")
    return device


def resolve_paths(configs: Dict[str, Any]) -> Dict[str, str]:
    """Reference path layout: graphs/{ds}/{ds}_complete.nt + {ds}/{sum}/{sum,map}/."""
    ds, sum_name = configs["dataset"], configs["sum"]
    root = configs.get("data_root") or "graphs"
    ds_dir = os.path.join(root, ds)
    if ds == "SYNTH" and not os.path.exists(os.path.join(ds_dir, f"{ds}_complete.nt")):
        from scaling_rgcn_training_tpu_torch.graphs.synthetic import ensure_synthetic_dataset

        ensure_synthetic_dataset(
            root, name="SYNTH",
            num_entities=configs.get("synth_entities", 2000),
            num_relations=configs.get("synth_relations", 12),
            num_classes=configs.get("synth_classes", 4),
            avg_degree=configs.get("synth_degree", 4.0),
            seed=configs.get("seed", 0))
    return {
        "org": os.path.join(ds_dir, f"{ds}_complete.nt"),
        "sum": os.path.join(ds_dir, sum_name, "sum"),
        "map": os.path.join(ds_dir, sum_name, "map"),
    }


def run_experiments(configs: Dict[str, Any], org_path: str, sum_path: str,
                    map_path: str) -> Results:
    """Iteration loop (reference main.py:23-70)."""
    device = resolve_device(configs["device"])
    configs, sum_files = do_checks(configs, sum_path, map_path)
    results = Results()
    experiment_names = [configs["exp"]] if configs.get("exp") else [
        "summation", "mlp", "attention"]

    if configs.get("create_attr_sum"):
        timing.log("Creating graph summaries...")
        create_sum_map(org_path, sum_path, map_path, configs["dataset"])
        timing.log("Attribute summaries done")

    timing.log("Making Graph data...")
    data = Dataset(org_path, sum_path, map_path).init_dataset()

    # reference parity (main.py:53): train_summaries runs even when only
    # the baseline experiment is requested; RGCN_SKIP_UNUSED_SUMMARIES=1
    # skips that output-irrelevant pre-training
    needs_summaries = (any(e != "baseline" for e in experiment_names)
                       or not os.environ.get("RGCN_SKIP_UNUSED_SUMMARIES"))

    for j in range(configs["i"]):
        trainer = Trainer(
            data, configs["hl"], configs["epochs"], configs["emb"], configs["lr"],
            weight_d=0.00005, seed=configs.get("seed", 0) * 1000 + j,
            device=device, num_bases=configs.get("num_bases"),
            num_blocks=configs.get("num_blocks"),
            compute_dtype=configs.get("compute_dtype"),
            backend=configs.get("backend"),
            aggr=configs.get("aggr") or "mean",
            devices=configs.get("devices"),
            partition=configs.get("partition") or "halo",
            reorder=bool(configs.get("reorder")),
            ckpt_dir=configs.get("ckpt_dir"),
            ckpt_every=configs.get("ckpt_every") or 0,
            plan_cache=configs.get("plan_cache") or (
                os.path.join(configs["ckpt_dir"], "plans")
                if configs.get("ckpt_dir") else None))
        trainer.ckpt_tag = j
        if needs_summaries:
            ckpt = configs.get("ckpt_dir")
            path = ckpt and os.path.join(
                ckpt, f"transfer_{configs['dataset']}_{j}.npz")
            if path and os.path.exists(path):
                timing.log(f"Resuming summary pre-training from {path}")
                trainer.load_summaries(path)
            else:
                trainer.train_summaries(configs, save_path=path)
        for exp in experiment_names:
            results.add_key(exp)
            timing.log(f"Start {exp} Experiment")
            head = "summation" if exp == "baseline" else exp
            res = trainer.train_original(head, configs, exp)
            for metric in ["accuracy", "loss", "f1 weighted", "f1 macro"]:
                results.update_run_results({metric: res[metric]}, exp)
            results.add_test_results(
                exp, res["test_acc"], res["test_f1_weighted"], res["test_f1_macro"])
            timing.log(f"{exp} experiment done")
            n = count_trainable_parameters(
                res["model"], res["frozen"],
                data.sumGraphs if exp != "baseline" else None)
            print(f"number of trainable parameters for {exp.upper()} model: {n}")
            if exp != "baseline" and configs.get("e_viz") and head == "summation":
                out = save_and_viz_embedding(configs, res["embedding"])
                print(f"embedding saved to {out}")

    configs["sum files"] = sum_files
    out = results.process_results(
        configs, results_root=configs.get("results_root", "./results"))
    print(f"results written to {out}")
    return results


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="experiment arguments")
    parser.add_argument("-dataset", type=str,
                        choices=["AIFB", "BGS", "MUTAG", "AM", "TEST", "SYNTH"],
                        default="AIFB", help="indicate dataset name")
    parser.add_argument("-sum", type=str,
                        choices=["attr", "bisim", "mix", "dummy", "one"],
                        default="attr", help="summarization technique")
    parser.add_argument("-exp", type=str,
                        choices=["summation", "mlp", "attention", "baseline"],
                        help="select experiment")
    parser.add_argument("-epochs", type=int, default=51)
    parser.add_argument("-emb", type=int, default=63)
    parser.add_argument("-i", type=int, default=1, help="experiment iterations")
    parser.add_argument("-lr", type=float, default=0.01)
    parser.add_argument("-hl", type=int, default=16, help="hidden layer size")
    parser.add_argument("-e_trans", type=strtobool, default=True)
    parser.add_argument("-e_freeze", type=strtobool, default=True)
    parser.add_argument("-w_trans", type=strtobool, default=True)
    parser.add_argument("-w_grad", type=strtobool, default=True)
    parser.add_argument("-e_viz", type=strtobool, default=False,
                        help="save the summation head's starting embedding "
                             "(.npy; a t-SNE PDF where matplotlib and "
                             "scikit-learn import)")
    parser.add_argument("-create_attr_sum", type=strtobool, default=False)
    # extras of the JAX CLI
    parser.add_argument("-data_root", type=str, default=None)
    parser.add_argument("-ckpt_dir", type=str, default=None,
                        help="save/resume summary pre-training state here")
    parser.add_argument("-ckpt_every", type=int, default=0,
                        help="checkpoint the fine-tune loop every K epochs "
                             "(with -ckpt_dir); crashed runs resume exactly")
    parser.add_argument("-plan_cache", type=str, default=None,
                        help="cache host-built edge plans here (defaults to "
                             "<ckpt_dir>/plans when -ckpt_dir is set); a "
                             "repeat run over the same graph skips the "
                             "plan build")
    parser.add_argument("-results_root", type=str, default="./results")
    parser.add_argument("-seed", type=int, default=0)
    parser.add_argument("-backend", type=str, default=None,
                        choices=["ragged", "gather", "pallas"],
                        help="grouped matmul of the non-fused conv: ragged "
                             "(torch.matmul per relation, the default), "
                             "gather (plain version) or pallas (the CUDA "
                             "kernels)")
    parser.add_argument("-compute_dtype", type=str, default=None,
                        choices=["bfloat16"],
                        help="mixed precision for the conv's edge streams")
    parser.add_argument("-devices", type=int, default=None,
                        help="shards of the mesh: CUDA devices with -device "
                             "cuda, virtual shards with -device cpu")
    parser.add_argument("-partition", type=str, default="halo",
                        choices=["edge", "halo"],
                        help="multi-device partition (with -devices > 1)")
    parser.add_argument("-reorder", action="store_true",
                        help="multi-device locality relabeling (with "
                             "-devices > 1)")
    parser.add_argument("-aggr", type=str, default="mean",
                        choices=["mean", "attention"],
                        help="conv aggregation: mean (reference parity) or "
                             "attention")
    parser.add_argument("-num_bases", type=int, default=None)
    parser.add_argument("-num_blocks", type=int, default=None)
    parser.add_argument("-synth_entities", type=int, default=2000)
    parser.add_argument("-synth_relations", type=int, default=12)
    parser.add_argument("-synth_classes", type=int, default=4)
    parser.add_argument("-synth_degree", type=float, default=4.0)
    # port extra
    parser.add_argument("-device", type=str, default="cuda",
                        help="torch device to train on (cuda, cuda:1, cpu)")
    return parser


def main(argv=None) -> None:
    timing.enable_program_banner()
    configs = vars(build_parser().parse_args(argv))
    resolve_device(configs["device"])
    paths = resolve_paths(configs)
    run_experiments(configs, paths["org"], paths["sum"], paths["map"])


if __name__ == "__main__":
    main()
