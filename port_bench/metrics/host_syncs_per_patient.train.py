"""Host calls that wait for the device in the traced train window per
patient trained in it (benchlib/trace.py's SYNC_CALLS)."""


def read(r):
    return r.trace["syncs"] / r.work if r.work else None
