"""The blocked objective's share of the large patients' training in the
traced window: Σ `span_s.medgp.large.objective` (each value+gradient call,
its factorization and blocked gradient included) over Σ
`span_s.medgp.train.large` of the window's `train_large` records (the
program's spans, written while the profiler is on). The rest is the
restart screen, SCG's line search and varEM's bookkeeping."""

from benchlib import records


def read(r):
    recs = records.stage(r, "train_large")
    return records.share(records.total(recs, "span_s.medgp.large.objective"),
                         records.total(recs, "span_s.medgp.train.large"))
