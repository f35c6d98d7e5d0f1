"""Percentiles and rates over all requests of a window."""

from __future__ import annotations

# Replies that refuse a request instead of judging it: a stream past its
# header or body deadline (408), shed (429), refused or failed (5xx).
REFUSED = {408, 429, 500, 502, 503, 504}


def percentile(values, q: float) -> float:
    """The q-th percentile (0-100), linear between closest ranks, of every
    value given (``statistics.quantiles``' inclusive method)."""
    xs = sorted(values)
    pos = (len(xs) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def window_numbers(load: dict, closed: bool, seconds: float) -> dict:
    """Rate, latencies, attempted and failed over the window: closed loop,
    requests sent in it; open loop, requests due in it, timed from their
    due time. The rate counts the verdicts received in the window: a reply
    that refuses or sheds a request (408, 429, 5xx) is no verdict. A
    request with no verdict, or one refused or shed, is failed; one with
    no reply counts in the latencies at the end of the drain. The first
    five failed are named: index, seconds into the window, status."""
    t0, t1 = load["window"]
    drain_end = max([r[3] for r in load["records"] if r[3] is not None] + [t1])
    answered, lat, attempted, failed, in_window, first_failed = {}, [], 0, 0, 0, []
    for i, due, sent, done, status, action, rule in load["records"]:
        if done is not None and t0 <= done < t1 and status not in REFUSED:
            in_window += 1
        if not t0 <= (sent if closed else due) < t1:
            continue
        attempted += 1
        lat.append(((done if done is not None else drain_end) - due) * 1e3)
        if done is None or status in REFUSED:
            failed += 1
            if len(first_failed) < 5:
                first_failed.append([i, (sent if closed else due) - t0, status])
        if done is not None and status not in REFUSED:
            answered[i] = (status, action, rule)
    return {"attempted": attempted, "failed": failed, "first_failed": first_failed,
            "answered": answered, "latencies_ms": lat,
            "req_per_s": in_window / seconds, "late_p50_ms": load["late_p50_ms"],
            "late_max_ms": load["late_max_ms"]}
