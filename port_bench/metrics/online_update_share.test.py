"""The hyper updates' share of the traced test window's buckets: Σ
`span_s.medgp.online.update` over Σ `span_s.medgp.test.bucket` of the
window's `test` records (the program's spans, written while the profiler
is on)."""

from benchlib import records


def read(r):
    recs = records.stage(r, "test")
    return records.share(records.total(recs, "span_s.medgp.online.update"),
                         records.total(recs, "span_s.medgp.test.bucket"))
