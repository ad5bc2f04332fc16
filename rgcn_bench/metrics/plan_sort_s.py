"""Host seconds of the process's plan's sorting: its ``plan.norm`` (the
mean coefficients' ``np.unique``) and ``plan.sort`` (``plan_span``'s two
CSR sorts and relation order) spans, summed; part of ``setup_s``."""

from rgcn_bench.program_trace import span_s


def read(record):
    return span_s(["plan.norm", "plan.sort"])
