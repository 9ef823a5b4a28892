"""Host ms a train step in the towers' forward and the loss
(``train.forward``, once a microbatch), in the traced slice."""

from port_bench import program_spans

UNIT = "ms"


def read(ctx):
    return program_spans.host_ms_per_step(ctx, "train.forward")
