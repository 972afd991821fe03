"""Host calls that wait for the device in the traced test window per
patient imputed in it: benchlib/trace.py's SYNC_CALLS over the `batch` of
the program's `test` records."""


def read(r):
    n = sum(x["batch"] for x in r.records if x.get("stage") == "test")
    return r.trace["syncs"] / n if n else None
