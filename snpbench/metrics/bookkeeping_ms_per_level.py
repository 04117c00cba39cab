"""``bookkeeping_ms_per_level``: device milliseconds a level of every
kernel and fill of the level loop outside the step and dedup groups (the
level's PyTorch ops in ``core/engine.py::_explore_level``: scans, sorts,
gathers, fills, elementwise, and the loop's condition kernel)."""


def read(ctx):
    spans = ctx.loop_spans()
    levels = sum(x.steps for _, _, x in spans)
    us = sum(d.end - d.start for d in ctx.loop_events()
             if ctx.group_of(d.name) not in ("step", "dedup"))
    if not levels or us <= 0:
        return None
    return us / 1e3 / levels
