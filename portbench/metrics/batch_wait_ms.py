"""Mean milliseconds from a request's ``MicroBatcher.submit`` to the close of
the window it rode (``sidecar/batcher.py``: the batch delay, the wait for a
pipeline slot), from the program's window log
(``observability/tracing.py::WINDOWS``) over the windows closed in
``[c0.t, c1.t)``. None without the window log or a record."""


def read(run):
    try:
        from coraza_kubernetes_operator_tpu_torch.observability.tracing import WINDOWS
    except ImportError:
        return None
    recs = WINDOWS.records(run.c0["t"], run.c1["t"])
    n = sum(r.n_requests for r in recs)
    return sum(r.batch_wait_s for r in recs) / n * 1e3 if n else None
