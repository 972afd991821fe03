"""Host kernel-launch calls in the traced train window per patient trained
in it (benchlib/trace.py's LAUNCH_CALLS)."""


def read(r):
    return r.trace["launches"] / r.work if r.work else None
