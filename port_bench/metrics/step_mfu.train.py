"""The train step's model FLOPs (``flops.py``) over the window's seconds,
as a share of the card's bf16 peak: the steps the traced run times outside
its profiled slice."""

from port_bench.flops import MODEL_PEAK

UNIT = "%"


def read(ctx):
    if ctx.get("kind") != "train" or not ctx.get("window_s"):
        return None
    return 100.0 * ctx["window_flops"] / ctx["window_s"] / MODEL_PEAK
