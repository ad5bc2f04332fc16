"""Device ms an epoch of the kernels in no table of
``kernel_layers/`` (the heads, the loss, the metrics, gathers, the root
products, copies and fills), over the traced stretch."""

from rgcn_bench.trace import TORCH_OPS


def read(record):
    return record.layer_ms(TORCH_OPS)
