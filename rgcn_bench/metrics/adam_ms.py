"""Device ms an epoch of the kernels in the optimizer table
(``kernel_layers/optimizer.json``), over the traced stretch."""


def read(record):
    return record.layer_ms("optimizer")
