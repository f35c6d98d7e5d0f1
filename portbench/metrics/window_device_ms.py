"""Mean milliseconds per window of device time on the card: the sum of its
stages' intervals (``engine/waf.py``: CUDA events around each stage
executable's device work), over the windows with device intervals on the
program's window log (``observability/tracing.py::WINDOWS``) closed in
``[c0.t, c1.t)``. None off the card, without the window log or a record."""


def read(run):
    try:
        from coraza_kubernetes_operator_tpu_torch.observability.tracing import WINDOWS
    except ImportError:
        return None
    recs = [r for r in WINDOWS.records(run.c0["t"], run.c1["t"]) if r.device]
    if not recs:
        return None
    return sum(t1 - t0 for r in recs for _s, t0, t1 in r.device) / len(recs) * 1e3
