"""``step_mfu``'s reading (``metrics/step_mfu.py``: the whole epoch's model
FLOPs over the traced stretch's time an epoch at the card's peak) in the
basis cell, which ``step_mfu``'s entry does not list."""

from rgcn_bench import spec

read = spec.metric_reader("step_mfu").read
