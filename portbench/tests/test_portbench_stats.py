"""Rates and percentiles are taken over every request of the window, and
an open loop's latency counts from the due time, so a stall shows."""

from portbench.stats import percentile, window_numbers


def _load(records, window=(10.0, 20.0)):
    return {"window": list(window), "records": records, "late_p50_ms": 0.0, "late_max_ms": 0.0}


def test_percentile_over_all_values():
    xs = list(range(1, 101))
    assert percentile(xs, 50) == 50.5
    assert abs(percentile(xs, 99) - 99.01) < 1e-9


def test_open_loop_stall_counts_from_due_time():
    # 100 requests due every 0.1 s; the server stalls 2 s from t=12 and then
    # answers the backlog: latencies from the due time include the wait.
    recs = []
    for i in range(100):
        due = 10.0 + i * 0.1
        done = due + 0.05 if not 12.0 <= due < 14.0 else 14.0 + 0.01 * (i - 20)
        recs.append([i, due, due, done, 200, "allow", None])
    w = window_numbers(_load(recs), closed=False, seconds=10.0)
    assert w["attempted"] == 100 and w["failed"] == 0
    assert percentile(w["latencies_ms"], 50) == 50.0 or percentile(w["latencies_ms"], 50) > 49
    assert percentile(w["latencies_ms"], 99) > 1500
    assert w["req_per_s"] == 10.0


def test_closed_loop_rate_and_failures():
    recs = [[i, 10.0 + i * 0.01, 10.0 + i * 0.01, 10.0 + i * 0.01 + 0.2, 200, "allow", None]
            for i in range(900)]
    recs.append([900, 19.5, 19.5, None, None, None, None])
    recs.append([901, 19.6, 19.6, 19.7, 503, None, None])
    w = window_numbers(_load(recs), closed=True, seconds=10.0)
    assert w["attempted"] == 902 and w["failed"] == 2
    assert 900 not in w["answered"] and 901 not in w["answered"]
    assert w["req_per_s"] == 900 / 10.0


def test_shed_replies_are_failed_and_not_rate():
    # A server that sheds most streams at once (429 / 503 in 1 ms) answers
    # far more replies in the window than it judges: the rate counts only
    # the verdicts, and every shed request is failed.
    recs = [[i, 10.0 + i * 0.001, 10.0 + i * 0.001, 10.0 + i * 0.001 + 0.001,
             429 if i % 3 else 503, None, None] for i in range(9000)]
    recs += [[9000 + i, 10.0 + i * 0.1, 10.0 + i * 0.1, 10.0 + i * 0.1 + 0.2, 403, "deny", "942100"]
             for i in range(90)]
    w = window_numbers(_load(recs), closed=True, seconds=10.0)
    assert w["attempted"] == 9090 and w["failed"] == 9000
    assert sorted(w["answered"]) == list(range(9000, 9090))
    assert w["req_per_s"] == 90 / 10.0  # 9,090 replies, 90 of them verdicts
    assert [f[0] for f in w["first_failed"]] == [0, 1, 2, 3, 4]
    assert [f[2] for f in w["first_failed"]] == [503, 429, 429, 503, 429]
