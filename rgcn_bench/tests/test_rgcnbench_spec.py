"""``BENCHMARK.json`` against the contract's form, and every name it holds
resolving to its files."""

import json

import pytest

from rgcn_bench import compare, spec
from rgcn_bench.tests.tiny import CELLS

BENCH = spec.load_benchmark()
KEYS = {"configs": {"name", "source", "file", "reduced", "why"},
        "workloads": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source"},
        "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", *KEYS}
    assert BENCH["paths"] == ["rgcn_bench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(BENCH["command"]) <= 32
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("section", sorted(KEYS))
def test_entries_have_the_contract_keys(section):
    for entry in BENCH[section]:
        extra = set(entry) - KEYS[section]
        assert set(entry) >= KEYS[section] and extra <= {"workloads"}, entry


def test_names_and_units_are_allowed():
    assert spec.check_names(BENCH) == []
    for entry in BENCH["configs"] + BENCH["workloads"]:
        assert 1 <= len(entry["why"]) <= 200 and "\n" not in entry["why"]
    for entry in BENCH["configs"]:
        assert 1 <= len(entry["source"]) <= 200


def test_bounds_and_metrics():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert set(e2e) == {"step_ms", "step_p95_ms", "peak_reserved_mib",
                        "setup_s"}
    assert all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    assert all(m["source"] in ("host_clock", "device_trace")
               for m in e2e.values())
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert all(w in CELLS for w in m.get("workloads", CELLS))


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves_every_file(name):
    cell = spec.load_cell(name)
    assert cell.chips == 1
    assert cell.config["name"] in {c["name"] for c in BENCH["configs"]}
    assert spec.traffic_generator(cell.traffic).triples
    assert set(cell.limits) == set(compare.NUMBERS)
    for m in cell.per_layer:
        assert callable(spec.metric_reader(m["name"]).read)
    assert {"conv", "optimizer"} <= set(spec.kernel_layers())


def test_config_files_lie_under_paths():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)
    assert all(f.startswith("rgcn_bench/configs/") for f in files)
    for c in BENCH["configs"]:
        assert spec.read_json(spec.ROOT / c["file"])["name"] == c["name"]
