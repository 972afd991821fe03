"""Mean patients per bucket of the traced train window: the `batch` of the
program's `train` records in log/metrics.jsonl (parallel/runner.py)."""


def read(r):
    b = [x["batch"] for x in r.records if x.get("stage") == "train"]
    return sum(b) / len(b) if b else None
