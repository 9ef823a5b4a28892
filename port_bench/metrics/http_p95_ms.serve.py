"""The 95th percentile over the serving slice's requests of the HTTP
handler's own ms: ``serve.request`` less its ``serve.submit`` (the body's
read, the parse, the reply and the handler's own work)."""

from port_bench import program_spans

UNIT = "ms"


def read(ctx):
    got = program_spans.in_slice(ctx, "serve.request")
    if not got:
        return None
    ids = {s.span_id for s in got}
    inner = {}
    for s in program_spans.named("serve.submit"):
        if s.parent_id in ids:
            inner[s.parent_id] = inner.get(s.parent_id, 0.0) + s.ms
    return program_spans.p((s.ms - inner.get(s.span_id, 0.0) for s in got),
                           0.95)
