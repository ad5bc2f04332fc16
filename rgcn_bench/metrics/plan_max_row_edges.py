"""Edges in the longest row of the process's plan, forward (dst) or
backward (src) CSR: the program's counter ``plan.max_row_edges``, read
from the plan's row pointers (on a plan-cache hit too). One warp of the
span kernels' sums walks such a row."""

from rgcn_bench.program_trace import recorder


def read(record):
    tracing = recorder()
    if tracing is None:
        return None
    return tracing.counters().get("plan.max_row_edges")
