"""Device ms an epoch of the heads and torch ops by the step's own marks:
the median over every replayed epoch of every fit in the process of
``step.start`` to ``backward`` less the conv's intervals, plus
``optimizer`` to ``step.end`` (the front-end, validation metrics, loss,
the head's backward, the step's output row)."""

from rgcn_bench.program_trace import replay_median_ms


def read(record):
    return replay_median_ms("head")
