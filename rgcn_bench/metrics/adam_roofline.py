"""Per cent of Adam's roofline: the least time of one update
(``cost.adam_bound_s``, bytes over the HBM peak) over the optimizer
table's device time an epoch."""

from rgcn_bench import cost


def read(record):
    ms = record.layer_ms("optimizer")
    if not ms:
        return None
    return 100.0 * cost.adam_bound_s(record.config, record.shapes) / (ms / 1e3)
