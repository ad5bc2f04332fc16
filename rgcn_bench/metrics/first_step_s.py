"""Host seconds of the process's first eager step: its first
``fit.warmup`` span (the kernels' builds and loads, Adam's state, cuBLAS's
set-up), part of ``setup_s``."""

from rgcn_bench.program_trace import recorder


def read(record):
    tracing = recorder()
    if tracing is None:
        return None
    first = next((r for r in tracing.spans() if r["name"] == "fit.warmup"),
                 None)
    return None if first is None else \
        (first["end_ns"] - first["start_ns"]) / 1e9
