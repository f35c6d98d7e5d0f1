"""Segment conv columns per matcher row: the mean, over the windows closed in
``[c0.t, c1.t)`` on the program's window log
(``observability/tracing.py::WINDOWS``) that matched rows, of each window's
sum over conv-segment blocks of rows convolved x the block's columns,
divided by its rows (``WindowRecord.seg_cols_per_row``, counted on the host
from the tiers' partition masks at dispatch). None without the window log,
without that counter (a program that has none), or without such a window."""


def read(run):
    try:
        from coraza_kubernetes_operator_tpu_torch.observability.tracing import WINDOWS
    except ImportError:
        return None
    vals = [getattr(r, "seg_cols_per_row", None) for r in WINDOWS.records(run.c0["t"], run.c1["t"])]
    vals = [v for v in vals if v is not None]
    return sum(vals) / len(vals) if vals else None
