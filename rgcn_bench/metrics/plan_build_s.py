"""Seconds of the host plan and its placement (``build_device_graph``),
by the host clock around the harness's call."""


def read(record):
    return record.plan_build_s
