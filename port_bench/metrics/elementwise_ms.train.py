"""Device ms a train step in the elementwise, reduction and LayerNorm
kernels: the towers and losses as PyTorch ops."""

from port_bench import readers

UNIT = "ms"


def read(ctx):
    if ctx.get("kind") != "train" or not ctx.get("units"):
        return None
    s = readers.class_seconds(ctx, readers.ELEMENTWISE)
    return 1e3 * s / ctx["units"] if s > 0 else None
