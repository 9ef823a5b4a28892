"""The median ms of the serving slice's device-batch dispatches
(``serve.dispatch``: the stack, the pad to the bucket, the upload and the
enqueue of the forward)."""

from port_bench import program_spans

UNIT = "ms"


def read(ctx):
    got = program_spans.in_slice(ctx, "serve.dispatch")
    return program_spans.median(s.ms for s in got) if got else None
