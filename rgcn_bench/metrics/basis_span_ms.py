"""Device ms an epoch of the basis layer by the step's own marks: the
median over every replayed epoch of every fit in the process of
``trunk.in`` to ``basis.out`` (both forwards) plus ``basis.grad`` to
``trunk.grad`` (its backward). None where the program keeps no such
marks."""

from rgcn_bench.program_trace import median_ms, recorder


def read(record):
    tracing = recorder()
    if tracing is None:
        return None
    return median_ms(tracing.replay_layers().get("basis", []))
