"""host_cpu_ms_per_mpix: the process's CPU time over the window (user and
system, every thread: ``time.process_time``), in ms, over the megapixels
delivered with ``ok`` True in it."""


def read(ctx):
    return ctx.win.cpu_s * 1e3 / ctx.ok_mpix if ctx.ok_mpix else None
