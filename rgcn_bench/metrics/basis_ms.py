"""Device ms an epoch of the kernels in the basis table
(``kernel_layers/basis.json``), over the traced stretch."""


def read(record):
    return record.layer_ms("basis")
