"""Kernels launched on the device a train step in the profiled slice
(copies and memsets left out): the host's dispatch of the step."""

from port_bench import readers

UNIT = "launches"


def read(ctx):
    if ctx.get("kind") != "train" or not ctx.get("units"):
        return None
    n = readers.launches(ctx)
    return n / ctx["units"] if n else None
