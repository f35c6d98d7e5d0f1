"""Holding a lane of the port's micro-batcher busy, for tests.

A lane with no window in flight closes its open window at once
(``sidecar/batcher.py``). A test that wants requests to share a window, or
a verdict to stay pending, holds the lane busy instead: one window of it
stays in flight, its read-back waiting, while the test's requests arrive.
"""

from __future__ import annotations

import contextlib
import threading
import time

from coraza_kubernetes_operator_tpu_torch.engine import HttpRequest
from coraza_kubernetes_operator_tpu_torch.sidecar.batcher import LANE_INTERACTIVE, MicroBatcher


@contextlib.contextmanager
def lanes_held(batcher, engine, lanes=(LANE_INTERACTIVE,), until=None, timeout_s=30.0):
    """Hold each of ``lanes`` busy with one in-flight window of ``engine``
    until the block exits or, given ``until``, until a watcher thread sees
    it return true, whichever comes first. The first read-back on
    ``engine`` after entry waits for that; the windows dispatched behind it
    wait in the collector's FIFO. The batcher's watchdog is off meanwhile,
    so that it does not abandon the held window."""
    release, entered = threading.Event(), threading.Event()
    own = vars(engine).get("collect")
    collect = engine.collect

    def held_collect(inflight):
        if not entered.is_set():
            entered.set()
            release.wait(timeout_s)
        return collect(inflight)

    engine.collect = held_collect
    watchdog, batcher.window_deadline_s = batcher.window_deadline_s, 0
    futs = []
    try:
        # Past any recording patch on the instance, and past the verdict
        # cache, which would answer a repeated holder at assembly.
        futs = [MicroBatcher.submit(batcher, HttpRequest(uri="/held"), lane=lane, no_cache=True)
                for lane in lanes]
        end = time.monotonic() + timeout_s
        while not (entered.is_set() and batcher.inflight_windows() >= len(lanes)):
            assert time.monotonic() < end, "the held windows never went in flight"
            time.sleep(0.002)
        if until is not None:
            def watch():
                while not release.is_set() and not until() and time.monotonic() < end:
                    time.sleep(0.002)
                release.set()

            threading.Thread(target=watch, name="lanes-held-watch", daemon=True).start()
        yield release
    finally:
        release.set()
        for fut in futs:
            fut.result(timeout_s)
        if own is None:
            del engine.collect
        else:
            engine.collect = own
        batcher.window_deadline_s = watchdog
