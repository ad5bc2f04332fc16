"""Per cent of the traced stretch in which no device op ran: one minus
the union of the ops' intervals over the stretch."""


def read(record):
    s = record.stretch
    if s is None:
        return None
    return 100.0 * (1.0 - s.busy_s / s.window_s)
