"""The port's dummy and bisimulation summary writers against the JAX
package's, byte for byte, and ``-sum dummy`` / ``-sum bisim`` on the CPU."""

import glob
import json
import os

import pytest

from scaling_rgcn_training_tpu.graphs.summarize import bisim as jbisim
from scaling_rgcn_training_tpu.graphs.summarize import dummy as jdummy
from scaling_rgcn_training_tpu_torch import main as tmain
from scaling_rgcn_training_tpu_torch.graphs.dataset import Dataset
from scaling_rgcn_training_tpu_torch.graphs.summarize import bisim, dummy
from scaling_rgcn_training_tpu_torch.graphs.synthetic import (
    generate_synthetic_nt, write_bisim_output)


@pytest.fixture(scope="module")
def org(tmp_path_factory):
    return generate_synthetic_nt(
        str(tmp_path_factory.mktemp("g") / "SYNTH" / "SYNTH_complete.nt"),
        num_entities=300, num_relations=6, num_classes=3, seed=2)


def _files(root):
    return {os.path.relpath(p, root): open(p, "rb").read()
            for p in glob.glob(os.path.join(root, "**", "*"), recursive=True)
            if os.path.isfile(p)}


@pytest.mark.parametrize("n_sum,seed", [(3, 7), (40, 0)])
def test_dummy_summaries_byte_equal_jax(tmp_path, org, n_sum, seed):
    for pkg, name in ((dummy, "port"), (jdummy, "jax")):
        pkg.create_dummy_sum_map(org, str(tmp_path / name / "sum"),
                                 str(tmp_path / name / "map"), "SYNTH",
                                 n_sum_nodes=n_sum, seed=seed)
    port, jax_ = _files(tmp_path / "port"), _files(tmp_path / "jax")
    assert sorted(port) == [f"map/SYNTH_map_random{n_sum}.nt",
                            f"sum/SYNTH_sum_random{n_sum}.nt"]
    assert port == jax_


@pytest.mark.parametrize("node,dataset", [
    ('"5"^^http://www.w3.org/2001/xmlschema#integer', "AIFB"),
    ("http://informatik.uni-kiel.de/fluid#b1", "AIFB"),
    ("http://x.org/a", "AIFB"),
    ("some literal", "AM"),
    ("http://informatik.uni-kiel.de/fluid#b9", "AM"),
    ("http://x.org/a", "AM"),
    ("x^^http://www.w3.org/2001/xmlschema#string^^y", "MUTAG"),
    ("http://x.org/a", "BGS"),
])
def test_bisim_reformat_as_jax(node, dataset):
    expected = {
        ('"5"^^http://www.w3.org/2001/xmlschema#integer', "AIFB"):
            '"5"^^<http://www.w3.org/2001/xmlschema#integer>',
        ("http://informatik.uni-kiel.de/fluid#b1", "AIFB"): "_:b1",
        ("http://x.org/a", "AIFB"): "<http://x.org/a>",
        ("some literal", "AM"): "some literal",
    }
    got = bisim.reformat(node, dataset)
    assert got == jbisim.reformat(node, dataset)
    if (node, dataset) in expected:
        assert got == expected[(node, dataset)]


def test_csv_to_mapping_keeps_commas_inside_nodes(tmp_path):
    path = tmp_path / "orgNode_to_orgHash.csv"
    path.write_text('orgNode,orgHash\nhttp://x.org/a,b,h1\n'
                    '"lit, with comma"^^http://www.w3.org/2001/xmlschema#string,h2\n'
                    'http://x.org/c,h1\n')
    for org_side in (True, False):
        got = bisim.csv_to_mapping(str(path), "AIFB", org=org_side)
        assert got == jbisim.csv_to_mapping(str(path), "AIFB", org=org_side)
    assert bisim.csv_to_mapping(str(path), "AIFB")["h1"] == [
        "<http://x.org/a,b>", "<http://x.org/c>"]


def test_bisim_maps_byte_equal_jax(tmp_path, org):
    """A FLUID-format folder of the synthetic graph's (k)-forward
    bisimulation gives the same map files, and the same unmatched-node
    count, through both packages."""
    out = write_bisim_output(org, str(tmp_path / "bisimOutput"),
                             str(tmp_path / "sum"), "SYNTH", ks=(1, 2))
    assert sorted(os.listdir(out)) == ["bisim_1", "bisim_2"]
    for pkg, name in ((bisim, "port"), (jbisim, "jax")):
        os.makedirs(tmp_path / name)
        written = pkg.create_bisim_map_nt(
            out, str(tmp_path / name / "SYNTH_map_"), "SYNTH", org)
        assert [os.path.basename(w) for w in written] == [
            "SYNTH_map_1.nt", "SYNTH_map_2.nt"]
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")
    for k in (1, 2):
        folder = os.path.join(out, f"bisim_{k}")
        o2h = bisim.csv_to_mapping(os.path.join(folder, "orgNode_to_orgHash.csv"),
                                   "SYNTH")
        got = bisim.count_unmatched_nodes(o2h, org)
        assert got == jbisim.count_unmatched_nodes(o2h, org)
        assert got[0] == 0 and got[1] > 300
    lines = open(tmp_path / "port" / "SYNTH_map_2.nt").read().splitlines()
    assert all(" <isSummaryOf> " in line for line in lines)


def _write_summaries(root, kind):
    """The synthetic dataset's ``{kind}/sum`` and ``{kind}/map``."""
    ds = os.path.join(root, "SYNTH")
    org = generate_synthetic_nt(os.path.join(ds, "SYNTH_complete.nt"),
                                num_entities=300, seed=0)
    sum_dir, map_dir = (os.path.join(ds, kind, d) for d in ("sum", "map"))
    if kind == "dummy":
        dummy.create_dummy_sum_map(org, sum_dir, map_dir, "SYNTH",
                                   n_sum_nodes=30, seed=1)
    else:
        out = write_bisim_output(org, os.path.join(ds, kind, "bisimOutput"),
                                 sum_dir, "SYNTH", ks=(1, 2))
        os.makedirs(map_dir)
        bisim.create_bisim_map_nt(out, os.path.join(map_dir, "SYNTH_map_"),
                                  "SYNTH", org)
    return org, sum_dir, map_dir


@pytest.mark.parametrize("kind", ["dummy", "bisim"])
def test_summaries_load_and_train_through_the_cli(tmp_path, kind, capsys):
    org, sum_dir, map_dir = _write_summaries(str(tmp_path / "data"), kind)
    data = Dataset(org, sum_dir, map_dir).init_dataset(verbose=False)
    assert len(data.sumGraphs) == (1 if kind == "dummy" else 2)
    for sg in data.sumGraphs:
        assert sg.num_relations == data.orgGraph.num_relations
        assert 0 < sg.num_nodes < data.orgGraph.num_nodes
        assert len(sg.x_train) > 0
    tmain.main(["-dataset", "SYNTH", "-sum", kind, "-exp", "summation",
                "-epochs", "3", "-emb", "12", "-hl", "8", "-device", "cpu",
                "-data_root", str(tmp_path / "data"),
                "-results_root", str(tmp_path / "results")])
    assert "ACC ON TEST SET" in capsys.readouterr().out
    (report,) = glob.glob(str(tmp_path / "results" / "*" / "report_*.json"))
    report = json.load(open(report))
    assert report["sum"] == kind
    assert report["sum files"] == sorted(os.listdir(sum_dir))
    assert 0.0 <= report["Test acc summation"]["mean"] <= 100.0
