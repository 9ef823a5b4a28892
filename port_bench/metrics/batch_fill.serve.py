"""Images a device batch over the window, from the batcher's ``items`` and
``batches`` counters (``cli/serve.py::DynamicBatcher.stats``)."""

UNIT = "items"


def read(ctx):
    if ctx.get("kind") != "serve" or not ctx.get("window_batches"):
        return None
    return ctx["window_items"] / ctx["window_batches"]
