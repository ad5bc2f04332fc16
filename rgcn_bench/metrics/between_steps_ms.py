"""Device ms between two replayed steps of a fit: the median over every
fit in the process of one replay's ``step.end`` mark to the next epoch's
``step.start`` (the cursor's increment, the caller's event, the graph's
launch, and any wait for the host)."""

from rgcn_bench.program_trace import replay_median_ms


def read(record):
    return replay_median_ms("between")
