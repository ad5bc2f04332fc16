"""Per cent of the card's peak in the configuration's stream dtype that
the whole epoch's model FLOPs (``cost.model_flops``) use over the traced
stretch's time an epoch."""

from rgcn_bench import cost


def read(record):
    s = record.stretch
    if s is None:
        return None
    flops = cost.model_flops(record.config, record.shapes)
    peak = cost.PEAKS[record.config["compute_dtype"]]
    return 100.0 * flops / (s.window_s / s.epochs * peak)
