"""Per cent of the conv's roofline: the least time of an epoch's span
kernel calls (``cost.conv_bound_s``: each call the larger of its bytes
over the HBM peak and its operations over the peak of their arithmetic)
over the conv table's device time an epoch."""

from rgcn_bench import cost


def read(record):
    ms = record.layer_ms("conv")
    if not ms:
        return None
    return 100.0 * cost.conv_bound_s(record.config, record.shapes) / (ms / 1e3)
