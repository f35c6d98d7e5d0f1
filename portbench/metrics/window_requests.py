"""Requests per batcher window over the measured window
(``sidecar/batcher.py`` ``BatcherStats``: requests / batches, the
difference across the window)."""


def read(run):
    batches = run.c1["batches"] - run.c0["batches"]
    if batches <= 0:
        return None
    return (run.c1["requests"] - run.c0["requests"]) / batches
