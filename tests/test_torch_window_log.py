"""The port's window log (``observability/tracing.py::WINDOWS``) on the CPU.

- the ring keeps records in commit order, bounded, and its Chrome export
  names each span's window;
- ``WafEngine._device_intervals`` puts a window's stage events on the host
  clock between its two bounds;
- the seven readers of ``portbench/metrics/`` that read the log, on a
  synthetic log: their values, the ``[c0.t, c1.t)`` filter, None on an
  empty log;
- the flight recorder's pipeline chain of a traced request is copied from
  its window's measured spans and names the window.
"""

from __future__ import annotations

import importlib
import time
from types import SimpleNamespace

import pytest

from coraza_kubernetes_operator_tpu_torch.engine import HttpRequest
from coraza_kubernetes_operator_tpu_torch.engine import WafEngine
from coraza_kubernetes_operator_tpu_torch.engine import waf
from coraza_kubernetes_operator_tpu_torch.engine.waf import InFlightBatch
from coraza_kubernetes_operator_tpu_torch.observability import tracing
from coraza_kubernetes_operator_tpu_torch.observability.tracing import (
    PIPELINE_CHAIN,
    TRACKS,
    TraceRecorder,
    WindowLog,
)
from coraza_kubernetes_operator_tpu_torch.sidecar.batcher import MicroBatcher
from torch_hold import lanes_held
from torch_rules import SMALL_RULES

PREFILTERED = 'SecRule ARGS "@rx (a|bc)*a(a|bc){7}d" "id:2002,phase:2,deny,status:403,t:none"\n'


def test_window_log_order_parent_ids_and_ring_bound():
    log = WindowLog(capacity=3)
    recs = []
    for i in range(5):
        rec = log.open(100.0 + i, n_requests=i + 1)
        rec.spans.append(("assemble", rec.t, rec.t + 0.01))
        rec.device.append(("post", rec.t + 0.02, rec.t + 0.03))
        rec.t_done = rec.t + 0.05
        rec.slack_s = 0.002 if i == 4 else None
        log.commit(rec)
        recs.append(rec)
    kept = log.records()
    assert kept == recs[2:]  # oldest evicted first, commit order kept
    assert [r.id for r in kept] == sorted(r.id for r in kept)
    assert len({r.id for r in recs}) == 5
    assert log.records(103.0, 104.0) == [recs[3]]
    events = log.chrome_events(mono0=100.0)
    assert {e["args"]["window"] for e in events} == {r.id for r in kept}
    tracks = {e["name"]: e["tid"] for e in events}
    assert (tracks["window"], tracks["assemble"], tracks["post"]) == (
        TRACKS["window"], TRACKS["window"], TRACKS["card"])
    only = log.chrome_events(mono0=100.0, ids={recs[4].id})
    assert [e["name"] for e in only] == ["window", "assemble", "post"]
    assert only[0]["ts"] == pytest.approx(4e6) and only[0]["dur"] == pytest.approx(5e4)
    # a window's placement slack on the card rides in its args; off the card none
    assert only[0]["args"]["device_slack_ms"] == pytest.approx(2.0)
    assert all("device_slack_ms" not in e["args"] for e in events if e["args"]["window"] != recs[4].id)


class _Ran:
    """Stands in for libcuda's events: an event is the device time (s)
    at which it ran."""

    def __init__(self):
        self.released = []

    @staticmethod
    def elapsed_s(start, end):
        return end - start

    def release(self, events):
        self.released += events


@pytest.fixture(scope="module")
def engine():
    eng = WafEngine(SMALL_RULES + PREFILTERED, device="cpu")
    assert eng.model.prefilter_cols
    return eng


@pytest.mark.parametrize(
    "recorded,t_rb,offset,slack",
    [
        # the card idle at the post stage's record: its start ran then
        ((5.0000, 5.0005, 5.0040), 5.0100, 5.0040 - 0.0040, 0.0050),
        # the read-back returned before the record times allow (clock noise)
        ((5.0000, 5.0005, 5.0040), 5.0040, 5.0040 - 0.0050, -0.0010),
    ],
    ids=["record-bound", "read-back-bound"],
)
def test_device_intervals_sit_between_their_bounds(
        engine, monkeypatch, recorded, t_rb, offset, slack):
    ran = _Ran()
    monkeypatch.setattr(waf, "STAGE_EVENTS", ran)
    # device times relative to the first event: two tiers 0-1 and 1-3 ms, post 4-5
    events = [("match:0", 7.0, 7.001, recorded[0]),
              ("match:1", 7.001, 7.003, recorded[1]),
              ("post", 7.004, 7.005, recorded[2])]
    inflight = InFlightBatch(out=None, n_live=0, n_requests=0, rejected={}, miss_keys=None,
                             cache_pop=False, events=events)
    engine._device_intervals(inflight, t_rb)
    assert inflight.events is None and len(ran.released) == 6  # back to the pool
    assert [s for s, _, _ in inflight.device] == [e[0] for e in events]
    assert inflight.device[0][1] == pytest.approx(offset)
    assert inflight.device[2][2] == pytest.approx(offset + 0.005)
    assert inflight.device[2][2] <= t_rb + 1e-9
    assert all(t0 >= rec - 1e-9 or slack < 0 for (_, t0, _), rec in zip(inflight.device, recorded))
    assert inflight.slack_s == pytest.approx(slack)
    assert inflight.device_s == pytest.approx(0.004)
    timing = engine.automata_summary()["tier_p50_ms"]
    assert timing == pytest.approx({"match:0": 1.0, "match:1": 2.0, "post": 1.0})


def _synthetic_log():
    log = WindowLog()
    a = log.open(10.0, n_requests=2, extproc_wait_s=0.004, batch_wait_s=0.1, close="idle")
    a.spans += [("assemble", 10.0, 10.01), ("confirm_wait", 10.01, 10.02),
                ("confirm_search", 10.02, 10.03), ("decode", 10.035, 10.06)]
    a.device += [("post", 10.03, 10.04)]
    b = log.open(10.5, n_requests=4, extproc_wait_s=0.0, batch_wait_s=0.2, close="delay")
    b.spans += [("assemble", 10.5, 10.52)]
    b.device += [("post", 10.52, 10.56)]
    late = log.open(11.0, n_requests=8, extproc_wait_s=9.0, batch_wait_s=9.0, close="idle")
    late.spans += [("confirm_search", 11.0, 12.0)]
    late.device += [("post", 11.0, 11.5)]
    for rec in (a, b, late):
        log.commit(rec)
    return log


READINGS = {
    "extproc_wait_ms": 0.004 / 6 * 1e3,
    "batch_wait_ms": 0.3 / 6 * 1e3,
    "confirm_search_ms": 0.01 / 2 * 1e3,
    "window_device_ms": 0.05 / 2 * 1e3,
    "device_unfed_share": 100.0 * (1 - 0.05),
    # host stages 0.065 s, 0.005 of it while the card ran: 0.06 of 0.95 unfed
    "unfed_host_share": 100.0 * 0.06 / 0.95,
    # one of the two windows closed because its lane had nothing in flight
    "idle_close_share": 100.0 * 1 / 2,
}


@pytest.mark.parametrize("family", sorted(READINGS))
def test_window_log_readers(monkeypatch, family):
    read = importlib.import_module(f"portbench.metrics.{family}").read
    run = SimpleNamespace(c0={"t": 10.0}, c1={"t": 11.0})
    monkeypatch.setattr(tracing, "WINDOWS", WindowLog())
    assert read(run) is None
    monkeypatch.setattr(tracing, "WINDOWS", _synthetic_log())
    assert read(run) == pytest.approx(READINGS[family])
    if family not in ("extproc_wait_ms", "batch_wait_ms", "confirm_search_ms", "idle_close_share"):
        for rec in tracing.WINDOWS.records():
            rec.device.clear()  # off the card
        assert read(run) is None


def test_pipeline_chain_copied_from_the_window_spans(engine):
    recorder = TraceRecorder(sample_rate=1.0)
    batcher = MicroBatcher(lambda: engine, max_batch_delay_ms=5000)
    batcher.start()
    try:
        # The lane held busy, the two requests share a window, which closes
        # once the held one is collected.
        with lanes_held(batcher, engine):
            t0 = time.monotonic()
            ctx = recorder.start(None)
            futs = [batcher.submit(HttpRequest(uri="/?q=aaaaaaaad"), span=ctx, extproc_wait_s=0.002),
                    batcher.submit(HttpRequest(uri="/?q=bcbcbcbcd"))]
        assert [f.result(timeout=60).rule_id for f in futs] == [2002, None]
        deadline = time.monotonic() + 10
        while not tracing.WINDOWS.records(t0) and time.monotonic() < deadline:
            time.sleep(0.01)
    finally:
        batcher.stop()
    (rec,) = [r for r in tracing.WINDOWS.records(t0) if r.n_requests == 2]
    assert rec.extproc_wait_s == pytest.approx(0.002)
    assert 0 < rec.batch_wait_s and rec.t < rec.t_done
    names = [n for n, _, _ in rec.spans]
    assert names == ["assemble", "copy_in", "match_dispatch", "confirm_wait", "confirm_search",
                     "post_dispatch", "readback_wait", "decode"]
    assert rec.device == []  # no device intervals on the CPU
    got = {name: (t0, t1, args) for name, t0, t1, _track, args in ctx.events}
    assert [e[0] for e in ctx.events] == list(PIPELINE_CHAIN[2:7])
    assert all(args["window"] == rec.id for _t0, _t1, args in got.values())
    spans = {name: (t0, t1) for name, t0, t1 in rec.spans}
    assert got["queue"][1] == rec.t
    assert got["assemble"][:2] == spans["assemble"]
    assert got["dispatch"][:2] == (spans["copy_in"][0], spans["post_dispatch"][1])
    assert got["readback"][:2] == spans["readback_wait"]
    assert got["decode"][:2] == spans["decode"]
    recorder.commit(ctx)
    exported = recorder.chrome_trace(ctx.trace_id)["traceEvents"]
    assert {e["args"]["window"] for e in exported
            if e["ph"] == "X" and e["tid"] == TRACKS["window"]} == {rec.id}
