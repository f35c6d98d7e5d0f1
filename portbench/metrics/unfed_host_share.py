"""Of the time ``[c0.t, c1.t)`` in which the card ran no stage (see
``device_unfed_share``), the share in which some window was in a host stage:
its assemble, copy-in, match and post dispatches, the confirm's exact
search, or its decode (spans of the program's window log,
``observability/tracing.py::WINDOWS``). The rest of the unfed time no
window was in the host's hands: the card waited on the batcher or the
frontend. None off the card, without the window log, or with no unfed time."""

from portbench.metrics.device_unfed_share import busy, union

HOST_STAGES = ("assemble", "copy_in", "match_dispatch", "confirm_search", "post_dispatch", "decode")


def _overlap(a, b):
    """Length of the intersection of two sorted disjoint interval lists."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        total += max(0.0, min(a[i][1], b[j][1]) - max(a[i][0], b[j][0]))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def read(run):
    got = busy(run)
    if got is None:
        return None
    device, lo, hi, recs = got
    unfed = (hi - lo) - sum(b - a for a, b in device)
    if unfed <= 0:
        return None
    host = union([(t0, t1) for r in recs for name, t0, t1 in r.spans if name in HOST_STAGES],
                 lo, hi)
    host_unfed = sum(b - a for a, b in host) - _overlap(host, device)
    return 100.0 * host_unfed / unfed
