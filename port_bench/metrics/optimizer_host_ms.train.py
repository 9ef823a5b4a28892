"""Host ms a train step in the optimizer (``train.optimizer``: the clip by
global norm and the AdamSPD update), in the traced slice."""

from port_bench import program_spans

UNIT = "ms"


def read(ctx):
    return program_spans.host_ms_per_step(ctx, "train.optimizer")
