"""Mean host assemble time per window (``InFlightBatch.assemble_s``: blob to
dispatch-ready tensors, ``engine/waf.py::prepare_blob``), over the windows
collected in the measured window."""


def read(run):
    ws = run.windows
    return sum(w[2] for w in ws) / len(ws) * 1e3 if ws else None
