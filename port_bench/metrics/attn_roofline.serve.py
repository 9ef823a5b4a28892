"""The attention forward kernel's share of its roofline in the serving
slice."""

from port_bench import readers

UNIT = "%"


def read(ctx):
    if ctx.get("kind") != "serve":
        return None
    return readers.roofline(ctx, ("attention_fwd",))
