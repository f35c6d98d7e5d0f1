"""Mean milliseconds per window of the prefilter confirm's exact search
(``engine/waf.py::_confirm_prefilter``: its ``confirm_search`` spans,
without the read-back of the match stages' rows), over the windows the
engine ran (those with spans) on the program's window log
(``observability/tracing.py::WINDOWS``) closed in ``[c0.t, c1.t)``. A
ruleset with no prefiltered group reads 0. None without the window log or
a record."""


def read(run):
    try:
        from coraza_kubernetes_operator_tpu_torch.observability.tracing import WINDOWS
    except ImportError:
        return None
    recs = [r for r in WINDOWS.records(run.c0["t"], run.c1["t"]) if r.spans]
    if not recs:
        return None
    total = sum(t1 - t0 for r in recs for name, t0, t1 in r.spans if name == "confirm_search")
    return total / len(recs) * 1e3
