"""Device ms an epoch of the optimizer by the step's own marks: the median
over every replayed epoch of every fit in the process of ``backward`` to
``optimizer`` (Adam's step)."""

from rgcn_bench.program_trace import replay_median_ms


def read(record):
    return replay_median_ms("adam")
