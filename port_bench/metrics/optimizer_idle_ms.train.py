"""Device-idle ms a train step inside the optimizer's host spans
(``train.optimizer``): the time in them that no kernel, copy or memset of
the traced slice covers."""

from port_bench import program_spans

UNIT = "ms"


def read(ctx):
    got = program_spans.phase(ctx, "train.optimizer")
    if not got:
        return None
    busy = ctx["trace"]["busy"]
    idle = sum(program_spans.idle_ns(busy, s.start_ns, s.end_ns)
               for s in got)
    return idle / 1e6 / ctx["units"]
