"""Per cent of the basis layer's roofline: the least time of an epoch's
basis kernel calls (the trunk's ``basis_calls``: each call the larger of
its bytes over the HBM peak and its operations over the peak of their
arithmetic) over the basis table's device time an epoch. None for a trunk
without ``basis_calls``."""

from rgcn_bench import cost
from rgcn_bench.reference import rgcn


def read(record):
    ms = record.layer_ms("basis")
    calls = getattr(rgcn.trunk_module(record.config), "basis_calls", None)
    if not ms or calls is None:
        return None
    bound_s = sum(max(n_bytes / cost.PEAKS["hbm_bytes_per_s"],
                      ops / cost.PEAKS[unit])
                  for n_bytes, ops, unit in calls(record.config,
                                                  record.shapes))
    return 100.0 * bound_s / (ms / 1e3)
