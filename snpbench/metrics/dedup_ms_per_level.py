"""``dedup_ms_per_level``: device milliseconds a level of the dedup
kernels (kernel group ``dedup``: H1 and H2; under sort dedup H1's hash
body alone, the sorts being bookkeeping)."""


def read(ctx):
    spans = ctx.loop_spans()
    levels = sum(x.steps for _, _, x in spans)
    us = sum(d.end - d.start for d in ctx.loop_events()
             if ctx.group_of(d.name) == "dedup")
    if not levels or us <= 0:
        return None
    return us / 1e3 / levels
