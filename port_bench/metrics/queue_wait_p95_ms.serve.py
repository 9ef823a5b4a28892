"""The 95th percentile of the serving slice's requests' waits in the
batcher's queue (``serve.queue``: enqueue to the moment the request's last
image is taken into a device batch)."""

from port_bench import program_spans

UNIT = "ms"


def read(ctx):
    got = program_spans.in_slice(ctx, "serve.queue")
    return program_spans.p((s.ms for s in got), 0.95) if got else None
