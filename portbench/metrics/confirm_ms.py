"""Mean prefilter-confirm time per window (``InFlightBatch.stage_s
["confirm"]``, ``engine/waf.py::_confirm_prefilter``). It holds the match
stages' device time too: the confirm reads their rows back."""


def read(run):
    ws = run.windows
    return sum(w[3] for w in ws) / len(ws) * 1e3 if ws else None
