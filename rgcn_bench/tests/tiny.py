"""A cell of the benchmark cut to a size the CPU tests can run: AM's
shape (published widths, inverse edges, 2R + 1 slots, 11 classes) over a
few hundred entities."""

from rgcn_bench import spec

TINY = dict(num_entities=600, num_relations=6, num_triples=3000,
            num_train=80, num_val=40)
CELLS = ("am_baseline_uniform", "am_attention_uniform")


def tiny_cell(name: str, **over) -> spec.Cell:
    cell = spec.load_cell(name)
    cell.config = dict(cell.config, **dict(TINY, **over))
    return cell
