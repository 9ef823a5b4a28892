"""The share of the serving slice in which no kernel, copy or memset ran."""

from port_bench import readers

UNIT = "%"


def read(ctx):
    return readers.idle_share(ctx) if ctx.get("kind") == "serve" else None
