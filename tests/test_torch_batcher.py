"""When the port's micro-batcher closes a window (``sidecar/batcher.py``).

A lane's open window closes at the earliest of: ``max_batch_size``
requests, the lane's delay since its first request (the cap), and the
lane having no window in flight. On a stub engine with the two-stage API
(a request's verdict is its uri), each case submits its requests, with the
lane idle or held busy by an in-flight window whose read-back waits
(``torch_hold.lanes_held``), and checks the windows on the window log
(their sizes and ``close`` reasons), ``BatcherStats.closes``, that every
verdict resolves in submit order (FIFO per lane), and how long it took.

The window deadline counts only time in which the process ran: a
readback wait that wakes late because the whole process stalled extends
its budget, and a readback that hangs while the process runs is abandoned
on time.
"""

from __future__ import annotations

import collections
import sys
import threading
import time
from types import SimpleNamespace

import pytest

from coraza_kubernetes_operator_tpu_torch.engine import HttpRequest
from coraza_kubernetes_operator_tpu_torch.observability.tracing import WindowLog
from coraza_kubernetes_operator_tpu_torch.sidecar import batcher as batcher_mod
from coraza_kubernetes_operator_tpu_torch.sidecar.batcher import LANE_BULK, MicroBatcher
from torch_hold import lanes_held


def _inflight(verdicts):
    return SimpleNamespace(verdicts=verdicts, spans=[], device=[], seg_rows=0, seg_col_rows=0,
                           slack_s=None, host_s=0.0, device_s=None, readback_s=0.0, decode_s=0.0)


class _Engine:
    """The two-stage engine API the batcher drives, on no device; each
    read-back takes ``readback_s``."""

    readback_s = 0.0

    def prepare(self, reqs):
        return _inflight([r.uri for r in reqs])

    def prepare_blob(self, blob, n_req):
        return _inflight([f"{blob.decode()}:{i}" for i in range(n_req)])

    def collect(self, inflight):
        time.sleep(self.readback_s)
        return inflight.verdicts


BLOB = object()  # a pre-assembled blob window of two requests

# name: (max_batch_size, delay_ms, lane held, submits, windows in close
# order as (requests, close), the bounds on the seconds from the first
# submit to the last verdict)
CASES = {
    # a lone request on an idle lane does not wait out its 5 s delay
    "idle-lane": (64, 5000, False, ["a"], [(1, "idle")], (0.0, 0.5)),
    # requests that arrive while the lane's window is in flight share one
    # window, which closes when the held one is collected, before its cap
    "in-flight": (64, 5000, True, ["a", "b", "c"], [(1, "idle"), (3, "idle")], (0.0, 0.5)),
    # a lane that stays busy closes its window at the delay, the cap
    "delay-cap": (64, 200, True, ["a", "b"], [(1, "idle"), (2, "delay")], (0.2, 2.0)),
    # ... and at max_batch_size; the rest waits for the lane to empty
    "size-cap": (2, 5000, True, ["a", "b", "c"], [(1, "idle"), (2, "size"), (1, "idle")],
                 (0.0, 0.5)),
    # a blob window dispatches as it is, and closes the window before it
    "blob": (64, 5000, True, ["a", BLOB, "b"],
             [(1, "idle"), (1, "blob"), (2, "blob"), (1, "idle")], (0.0, 0.5)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_window_closes(monkeypatch, case):
    size, delay_ms, held, submits, windows, (t_min, t_max) = CASES[case]
    log = WindowLog()
    monkeypatch.setattr(batcher_mod, "WINDOWS", log)
    engine = _Engine()
    batcher = MicroBatcher(lambda: engine, max_batch_size=size, max_batch_delay_ms=delay_ms)
    batcher.start()
    resolved = []

    def submit_all():
        futs = []
        for name in submits:
            if name is BLOB:
                fut = batcher.submit_window(b"blob", 2, lane=LANE_BULK)
            else:
                fut = batcher.submit(HttpRequest(uri=name), lane=LANE_BULK)
            fut.add_done_callback(lambda _f, name=name: resolved.append(name))
            futs.append(fut)
        return futs

    try:
        t0 = time.monotonic()
        if held:
            with lanes_held(batcher, engine, lanes=(LANE_BULK,)):
                t0 = time.monotonic()
                futs = submit_all()
                if any(close == "delay" for _n, close in windows):
                    # the window closes at its cap while the lane is held
                    end = time.monotonic() + 5
                    while batcher.stats.closes["delay"] < 1 and time.monotonic() < end:
                        time.sleep(0.005)
        else:
            futs = submit_all()
        got = [f.result(timeout=10) for f in futs]
        took = time.monotonic() - t0
    finally:
        batcher.stop()
    want = [["blob:0", "blob:1"] if name is BLOB else name for name in submits]
    assert got == want
    assert resolved == submits  # FIFO: verdicts resolve in submit order
    assert t_min <= took < t_max
    assert [(r.n_requests, r.close) for r in log.records()] == windows
    closes = collections.Counter(close for _n, close in windows)
    assert batcher.stats.snapshot()["closes"] == {c: closes[c] for c in ("idle", "delay", "size", "blob")}


def test_no_wake_up_is_lost_under_contention(monkeypatch):
    """Many submitters against one lane, with the interpreter switching
    threads every microsecond: every verdict lands, in each submitter's own
    order, and no window waits out the 5 s cap, which a wake-up lost between
    the collector's release and the dispatch thread's wait would force."""
    monkeypatch.setattr(batcher_mod, "WINDOWS", WindowLog())
    engine = _Engine()
    engine.readback_s = 0.002  # so windows fill behind in-flight ones
    batcher = MicroBatcher(lambda: engine, max_batch_size=7, max_batch_delay_ms=5000)
    batcher.start()
    resolved = collections.defaultdict(list)
    futs = collections.defaultdict(list)

    def submitter(k):
        for i in range(40):
            fut = batcher.submit(HttpRequest(uri=f"/{k}/{i}"), lane=LANE_BULK)
            fut.add_done_callback(lambda _f, k=k, i=i: resolved[k].append(i))
            futs[k].append(fut)

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        t0 = time.monotonic()
        threads = [threading.Thread(target=submitter, args=(k,)) for k in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(10)
        assert not any(t.is_alive() for t in threads)
        got = {k: [f.result(timeout=10) for f in fs] for k, fs in futs.items()}
        took = time.monotonic() - t0
    finally:
        sys.setswitchinterval(switch)
        batcher.stop()
    assert got == {k: [f"/{k}/{i}" for i in range(40)] for k in range(16)}
    assert all(resolved[k] == list(range(40)) for k in range(16))
    closes = batcher.stats.snapshot()["closes"]
    assert closes["delay"] == 0 and took < 4.0
    assert sum(closes.values()) == batcher.stats.batches
    assert batcher.stats.requests == 16 * 40


class _StalledEvent:
    """A readback's ``done`` whose first wait wakes ``stall_s`` late, as
    when no thread of the process could run, and that is set from then on."""

    def __init__(self, stall_s):
        self.stall_s, self.waits = stall_s, 0

    def wait(self, timeout=None):
        self.waits += 1
        if self.waits == 1:
            time.sleep(timeout + self.stall_s)
            return False
        return True

    def is_set(self):
        return self.waits > 1


# name: (done, budget s, whether the wait sees the readback, bounds on its seconds)
WAITS = {
    # the process stalls past the budget while the readback is done
    "host-stall": (lambda: _StalledEvent(0.6), 0.3, True, (0.6, 1.2)),
    # the device hangs while the process runs: the deadline holds
    "device-hang": (threading.Event, 0.3, False, (0.3, 0.5)),
    # an answer within the budget returns at once
    "answered": (lambda: _set(threading.Event()), 0.3, True, (0.0, 0.1)),
}


def _set(event):
    event.set()
    return event


@pytest.mark.parametrize("case", sorted(WAITS))
def test_readback_deadline_counts_running_time(case):
    make, budget, want, (t_min, t_max) = WAITS[case]
    t0 = time.monotonic()
    assert batcher_mod._wait_running(make(), budget) is want
    assert t_min <= time.monotonic() - t0 < t_max


def test_a_hung_readback_is_still_abandoned(monkeypatch):
    """Through the batcher: a warmed engine whose readback outlasts the
    window deadline while the process runs has its window abandoned."""
    monkeypatch.setattr(batcher_mod, "WINDOWS", WindowLog())
    engine = _Engine()
    engine.warmed = True
    engine.readback_s = 1.0
    batcher = MicroBatcher(lambda: engine, max_batch_size=8, max_batch_delay_ms=5000)
    batcher.window_deadline_s = 0.3
    batcher.start()
    try:
        t0 = time.monotonic()
        fut = batcher.submit(HttpRequest(uri="a"), lane=LANE_BULK)
        with pytest.raises(batcher_mod.WindowAbandoned):
            fut.result(timeout=5)
        assert time.monotonic() - t0 < 0.9
        assert batcher.windows_abandoned == 1
    finally:
        batcher.stop()
