"""A whole run on the CPU (the harness's look for a card skipped) with the
timed path broken underneath: ``correct`` has to come out false for each
fault a serving cell can have, and true with none.

The faults are planted in ``WafEngine.collect``, where a window's verdicts
are produced: one answer altered, and half of the window left out (its
requests answered as allowed); and in the sidecar's degraded mode, which
answers every window from the host fallback (right answers, off the card).
The cell is the sample RuleSet under the attack-dense ftw replay, at a size
the CPU holds."""

import pytest

from portbench import harness, run

SEED = 2**31 + 101


def _cell():
    cell = run.load_cell("sample.browse.c64")
    cell.traffic = {"mix": "ftw-replay", "load": {"loop": "closed", "connections": 2, "streams": 4},
                    "warm_requests": 48}
    return cell


def _altered(real):
    def collect(engine, inflight):
        out = real(engine, inflight)
        if out:
            v = out[0]
            out[0] = type(v)(interrupted=not v.interrupted, status=200 if v.interrupted else 403,
                             rule_id=None if v.interrupted else 1, matched_ids=[], scores=v.scores)
        return out
    return collect


def _half_left_out(real):
    def collect(engine, inflight):
        out = real(engine, inflight)
        keep = (len(out) + 1) // 2
        return out[:keep] + [type(v)(interrupted=False, status=200, rule_id=None, matched_ids=[],
                                     scores=v.scores) for v in out[keep:]]
    return collect


def _host_fallback(monkeypatch):
    from coraza_kubernetes_operator_tpu_torch.sidecar.degraded import DegradedModeManager

    real_route, real_drive = DegradedModeManager.route, harness.Serving.drive
    armed = []

    def route(ctl, engine):
        return "fallback" if armed else real_route(ctl, engine)

    def drive(serving, *a, **kw):
        # Armed once the sidecar is promoted: the warm-up and the window
        # are served from the host fallback, as after the breaker opens.
        armed.append(True)
        return real_drive(serving, *a, **kw)

    monkeypatch.setattr(DegradedModeManager, "route", route)
    monkeypatch.setattr(harness.Serving, "drive", drive)


@pytest.mark.parametrize("fault", [None, _altered, _half_left_out, _host_fallback],
                         ids=["clean", "answer-altered", "half-left-out", "host-fallback"])
def test_fault_makes_the_run_incorrect(monkeypatch, fault):
    from coraza_kubernetes_operator_tpu_torch.engine.waf import WafEngine

    if fault is _host_fallback:
        fault(monkeypatch)
    elif fault is not None:
        monkeypatch.setattr(WafEngine, "collect", fault(WafEngine.collect))
    res = run.run_cell(_cell(), SEED, 3.0, False, device="cpu")
    assert res["check_details"]["compared"] > 50
    assert res["correct"] is (fault is None), res["checks"]
