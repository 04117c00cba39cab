"""``step_roofline``: the step kernels' share of their bytes bound, in %:
the least time of the levels' steps at HBM bandwidth
(:func:`snpb.counts.step_bytes`, counted from the system's sizes and the
traffic's ``F`` and ``T``) over the step kernels' device time in the
level loops (kernel group ``step``)."""

from snpb.counts import HBM_BYTES_PER_S, step_bytes


def read(ctx):
    spans = ctx.loop_spans()
    levels = sum(x.steps for _, _, x in spans)
    us = sum(d.end - d.start for d in ctx.loop_events()
             if ctx.group_of(d.name) == "step")
    if not levels or us <= 0:
        return None
    t = ctx.traffic
    least_s = levels * step_bytes(ctx.sizes, t["frontier_cap"],
                                  t["max_branches"]) / HBM_BYTES_PER_S
    return 100.0 * least_s / (us / 1e6)
