"""``level_device_ms``: device milliseconds a BFS level, from the level
loop's first kernel to its last in each explore (the first step kernel
to the last kernel before the counts' read), over the levels run; gaps
inside the loop count (``core/graph_loop.py``: the eager first level,
the capture and the graph's levels)."""


def read(ctx):
    spans = ctx.loop_spans()
    levels = sum(x.steps for _, _, x in spans)
    if not levels:
        return None
    return sum(e - s for s, e, _ in spans) / 1e3 / levels
