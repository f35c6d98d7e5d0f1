"""Share of ``[c0.t, c1.t)`` in which the card ran no stage of any window:
100 x (1 - the union of the device intervals of the windows closed in it,
clipped to it, / its length), from the program's window log
(``observability/tracing.py::WINDOWS``; the intervals are CUDA events
around each stage, on the host clock). In a traced run that is the part of
the window before the device trace. None off the card, without the window
log or a record with device intervals."""


def records(run):
    """The window log's records of windows closed in ``[c0.t, c1.t)``, or
    None without the window log."""
    try:
        from coraza_kubernetes_operator_tpu_torch.observability.tracing import WINDOWS
    except ImportError:
        return None
    return WINDOWS.records(run.c0["t"], run.c1["t"])


def union(intervals, lo, hi):
    """Sorted disjoint intervals covering ``intervals`` clipped to [lo, hi]."""
    out = []
    for t0, t1 in sorted((max(lo, a), min(hi, b)) for a, b in intervals):
        if t1 <= t0:
            continue
        if out and t0 <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t1)
        else:
            out.append([t0, t1])
    return out


def busy(run):
    """(device busy union, lo, hi, records), or None where no record has
    device intervals."""
    recs = records(run)
    if not recs or not any(r.device for r in recs):
        return None
    lo, hi = run.c0["t"], run.c1["t"]
    return union([(t0, t1) for r in recs for _s, t0, t1 in r.device], lo, hi), lo, hi, recs


def read(run):
    got = busy(run)
    if got is None or got[2] <= got[1]:
        return None
    ivs, lo, hi, _recs = got
    return 100.0 * (1.0 - sum(b - a for a, b in ivs) / (hi - lo))
