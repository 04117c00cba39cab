"""``level_mfu``: the least time the window's work needs over the
window's time, in %.  An explore's least time is the larger of its device
inputs and outputs at HBM bandwidth and its archive over the host link
(:func:`snpb.counts.explore_least_s`, counted from the system's sizes,
the rows it archived and the levels it ran), whatever implements it."""

from snpb.counts import explore_least_s


def read(ctx):
    if not ctx.explores or ctx.window_us <= 0:
        return None
    F = ctx.traffic["frontier_cap"]
    least = sum(explore_least_s(ctx.sizes, F, x.rows, x.steps)
                for x in ctx.explores)
    return 100.0 * least / (ctx.window_us / 1e6)
