"""Approximate prefilter hits the confirm had to check, per request
(``WafEngine.prefilter_stats["hits"]`` over the batcher's requests, the
differences across the window)."""


def read(run):
    reqs = run.c1["requests"] - run.c0["requests"]
    p0, p1 = run.c0["prefilter"], run.c1["prefilter"]
    if reqs <= 0 or "hits" not in p1:
        return None
    return (p1["hits"] - p0["hits"]) / reqs
