"""``idle_share``: the share of the window, in %, with neither a kernel
nor a copy nor a fill on the card (the profiler's device intervals)."""


def read(ctx):
    busy = ctx.busy_us()
    if busy <= 0 or ctx.window_us <= 0:
        return None
    return 100.0 * (1.0 - busy / ctx.window_us)
