"""The SPARC pooling kernels' (forward and backward) share of their
roofline in the train step's slice."""

from port_bench import readers

UNIT = "%"


def read(ctx):
    if ctx.get("kind") != "train":
        return None
    return readers.roofline(ctx, ("sparc_fwd", "sparc_bwd"))
