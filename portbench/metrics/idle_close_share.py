"""Share, in %, of the batcher windows closed in ``[c0.t, c1.t)`` that
closed because their lane had no window in flight (``sidecar/batcher.py``:
``close`` ``idle`` on the program's window log,
``observability/tracing.py::WINDOWS``), rather than at the batch delay, at
``max_batch_size`` or as a blob window. None without the window log, a
record, or a close reason on its records."""


def read(run):
    try:
        from coraza_kubernetes_operator_tpu_torch.observability.tracing import WINDOWS
    except ImportError:
        return None
    closes = [getattr(r, "close", None) for r in WINDOWS.records(run.c0["t"], run.c1["t"])]
    closes = [c for c in closes if c is not None]
    return 100.0 * closes.count("idle") / len(closes) if closes else None
