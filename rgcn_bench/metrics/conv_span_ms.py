"""Device ms an epoch of the conv by the step's own marks: the median over
every replayed epoch of every fit in the process of ``trunk.in`` to
``trunk.out`` (the validation and the training forward) plus ``loss`` to
``trunk.grad`` (the conv's backward, the loss's small backward ahead of
it). The conv's torch ops (root products, ReLU, gathers) count here, not
by kernel names."""

from rgcn_bench.program_trace import replay_median_ms


def read(record):
    return replay_median_ms("conv")
