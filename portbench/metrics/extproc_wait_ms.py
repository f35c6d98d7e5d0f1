"""Mean milliseconds a request's ext_proc messages waited for a frontend
worker (``sidecar/extproc.py``: from a message's hand-off to the worker pool
to a worker starting on it, summed over the request's messages), from the
program's window log (``observability/tracing.py::WINDOWS``) over the
windows closed in ``[c0.t, c1.t)``: in a traced run, the part of the window
before the device trace. None without the window log or a record."""


def read(run):
    try:
        from coraza_kubernetes_operator_tpu_torch.observability.tracing import WINDOWS
    except ImportError:
        return None
    recs = WINDOWS.records(run.c0["t"], run.c1["t"])
    n = sum(r.n_requests for r in recs)
    return sum(r.extproc_wait_s for r in recs) / n * 1e3 if n else None
