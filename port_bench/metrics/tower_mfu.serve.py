"""The served images' model FLOPs in the slice (padding not counted) over
the card's busy seconds there, as a share of the bf16 peak. The slice's
device batches are its attention calls over the calls a batch makes; the
images a batch, the batcher's count over the slice."""

from port_bench import trace
from port_bench.flops import MODEL_PEAK

UNIT = "%"


def read(ctx):
    if ctx.get("kind") != "serve" or not ctx.get("slice_fill"):
        return None
    seen = trace.roles_in(ctx["trace"], {
        "attention_fwd": ctx["kernels"].get("attention_fwd", [])})
    busy = ctx["trace"]["busy_s"]
    if "attention_fwd" not in seen or busy <= 0:
        return None
    batches = seen["attention_fwd"]["calls"] \
        / len(ctx["calls_per_unit"]["attention_fwd"])
    images = batches * ctx["slice_fill"]
    return 100.0 * images * ctx["image_flops"] / busy / MODEL_PEAK
