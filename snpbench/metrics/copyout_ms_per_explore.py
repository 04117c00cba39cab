"""``copyout_ms_per_explore``: device milliseconds of copies to the host
per explore (the profiler's ``Memcpy DtoH`` intervals in the window: the
archive's copy-out by ``core/device.py::host_copy`` and the counts' read)."""


def read(ctx):
    if not ctx.explores:
        return None
    us = sum(d.end - d.start for d in ctx.device if d.kind == "dtoh")
    return us / 1e3 / len(ctx.explores) if us > 0 else None
