"""The traffic generator: the configuration's exact counts, the same
triples for the same seed and others for another, and the labelled rows."""

import numpy as np
import pytest

from rgcn_bench import inputs, spec
from rgcn_bench.traffic import kg_triples

SEEDS = (3, 2**31 + 11)


def _draw(cell_name, seed, **over):
    cell = spec.load_cell(cell_name)
    cell.config = dict(cell.config, **over)
    return cell, kg_triples.triples(cell.traffic, cell.config, seed)


@pytest.mark.parametrize("cell_name", ["am_baseline_uniform",
                                       "am_attention_uniform"])
def test_published_counts(cell_name):
    cell, (subj, rel, obj) = _draw(cell_name, SEEDS[1])
    n, r = cell.config["num_entities"], cell.config["num_relations"]
    assert subj.shape == rel.shape == obj.shape == (5_988_321,)
    assert n == 1_666_764 and r == 133
    assert min(subj.min(), obj.min(), rel.min()) >= 0
    assert max(subj.max(), obj.max()) < n and rel.max() < r
    src, dst, typ = inputs.program_edges((subj, rel, obj))
    assert src.size == 11_976_642 and typ.max() < 2 * r + 1


def test_uniform_draws_differ_and_repeat():
    a = _draw("am_baseline_uniform", 5, num_entities=1000, num_triples=5000)[1]
    b = _draw("am_baseline_uniform", 5, num_entities=1000, num_triples=5000)[1]
    c = _draw("am_baseline_uniform", 6, num_entities=1000, num_triples=5000)[1]
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(a[0], c[0])


def test_unknown_draw_is_refused():
    cell = spec.load_cell("am_baseline_uniform")
    mix = dict(cell.traffic, endpoints={"draw": "rank_law"})
    with pytest.raises(ValueError):
        kg_triples.triples(mix, dict(cell.config, num_entities=10,
                                     num_triples=20), 1)


def test_labels_split_and_repeat():
    cell = spec.load_cell("am_baseline_uniform")
    a, b = (inputs.labels(cell.config, 2**33 + 1) for _ in range(2))
    assert a["x_train"].size == 802 and a["x_val"].size == 198
    rows = np.concatenate([a["x_train"], a["x_val"]])
    assert np.unique(rows).size == 1000
    assert all(np.array_equal(a[k], b[k]) for k in a)
