"""SCG's own share of the traced train window's buckets: its line search's
bookkeeping outside the objective's calls, Σ `self_s.medgp.scg` over Σ
`span_s.medgp.train.bucket` of the window's `train` records (the
program's spans, written while the profiler is on)."""

from benchlib import records


def read(r):
    recs = records.stage(r, "train")
    return records.share(records.total(recs, "self_s.medgp.scg"),
                         records.total(recs, "span_s.medgp.train.bucket"))
