"""Share of stage calls that replayed a captured CUDA graph
(``EXEC_CACHE.stats()``: hits over hits, misses and bypasses, the
differences across the window)."""


def read(run):
    d = {k: run.c1[k] - run.c0[k] for k in ("graph_hits", "graph_misses", "graph_bypasses")}
    total = sum(d.values())
    return 100.0 * d["graph_hits"] / total if total else None
