"""``BENCHMARK.json`` and the files its names lead to.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix; each lives in a file of its own: the configuration where its entry's
``file`` says, the mix in ``traffic/<name>.json`` (whose ``generator``
names a module of ``rgcn_bench/traffic``), the limits of its correctness
check in ``limits/<cell>.json``, each per-layer metric's reader in
``metrics/<metric>.py`` and each layer's kernel names in
``kernel_layers/<layer>.json``. Adding a cell, a mix, a metric or a
kernel table is adding files; no file here changes.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent

NAME_RE = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}\Z")
UNIT_RE = re.compile(r"[A-Za-z0-9_/%.-]{1,16}\Z")


@dataclasses.dataclass
class Cell:
    """One workload: its entry, its configuration and traffic data, and
    the metrics it reports (``end_to_end`` with ``--trace 0``,
    ``per_layer`` with ``--trace 1``)."""

    name: str
    chips: int
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]
    limits: Dict[str, float]


def load_benchmark(path: Optional[Path] = None) -> Dict[str, Any]:
    with open(path or ROOT / "BENCHMARK.json") as fh:
        return json.load(fh)


def _by_name(entries: List[Dict[str, Any]], name: str, what: str):
    for entry in entries:
        if entry["name"] == name:
            return entry
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def _applies(metric: Dict[str, Any], cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def read_json(path: Path) -> Dict[str, Any]:
    with open(path) as fh:
        return json.load(fh)


def load_cell(name: str, bench: Optional[Dict[str, Any]] = None) -> Cell:
    """The cell ``name`` with every file it names read."""
    bench = bench if bench is not None else load_benchmark()
    work = _by_name(bench["workloads"], name, "workload")
    conf = _by_name(bench["configs"], work["config"], "config")
    return Cell(
        name=name, chips=int(work["chips"]),
        config=read_json(ROOT / conf["file"]),
        traffic=read_json(BENCH_DIR / "traffic" / f"{work['traffic']}.json"),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)],
        limits=read_json(BENCH_DIR / "limits" / f"{name}.json"))


def traffic_generator(traffic: Dict[str, Any]) -> ModuleType:
    """The module of ``rgcn_bench/traffic`` that draws this mix."""
    return importlib.import_module(f"rgcn_bench.traffic.{traffic['generator']}")


def metric_reader(name: str) -> ModuleType:
    """``metrics/<name>.py``, loaded by path (a name may hold a dot)."""
    path = BENCH_DIR / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"rgcn_bench.metrics.{name.replace('.', '_')}", path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(f"no reader {path} for metric {name!r}")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def kernel_layers() -> Dict[str, List[str]]:
    """Layer name -> the kernel-name fragments of its table, from every
    ``kernel_layers/*.json``."""
    out: Dict[str, List[str]] = {}
    for path in sorted((BENCH_DIR / "kernel_layers").glob("*.json")):
        table = read_json(path)
        out.setdefault(table["layer"], []).extend(table["kernels"])
    return out


def check_names(bench: Dict[str, Any]) -> List[str]:
    """The names and units of ``bench`` that break the allowed characters
    (empty when all are fine)."""
    bad = []
    names = [e["name"] for key in ("configs", "workloads", "end_to_end",
                                   "per_layer") for e in bench[key]]
    names += [w[k] for w in bench["workloads"] for k in ("config", "traffic")]
    names += [k for c in bench["configs"] for k in c["reduced"]]
    bad += [f"name {n!r}" for n in names if not NAME_RE.match(n)]
    bad += [f"unit {m['unit']!r}" for key in ("end_to_end", "per_layer")
            for m in bench[key] if not UNIT_RE.match(m["unit"])]
    return bad
