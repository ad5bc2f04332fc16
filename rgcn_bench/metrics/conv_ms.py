"""Device ms an epoch of the kernels in the conv table
(``kernel_layers/conv.json``), over the traced stretch."""


def read(record):
    return record.layer_ms("conv")
