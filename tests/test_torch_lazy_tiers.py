"""PyTorch port parity: the reference's lazy tiers have no counterpart.

The JAX package answers stages whose executable is not compiled yet
through the host twins while a pool compiles them (``CKO_LAZY_TIERS=1``,
the default of its ``tpu-engine``). PyTorch compiles nothing, so the port
runs every stage on its device at once; on the CPU:

- with ``CKO_LAZY_TIERS=1`` set, the port never calls a host twin, and its
  verdicts equal its own without the setting, the JAX engine's eager
  verdicts and the JAX engine's lazy ones;
- a window at shapes this process has not run is counted as a miss and
  still runs on the device; the same shapes again count a hit;
- ``automata_summary`` equals the JAX engine's; ``CKO_TIER_TIMING=1``
  adds per-stage p50s.
"""

from __future__ import annotations

import pytest

from coraza_kubernetes_operator_tpu.engine import HttpRequest as JRequest
from coraza_kubernetes_operator_tpu.engine import WafEngine as JEngine
from coraza_kubernetes_operator_tpu_torch import corpus as tcorpus
from coraza_kubernetes_operator_tpu_torch.engine import HttpRequest as TRequest
from coraza_kubernetes_operator_tpu_torch.engine import WafEngine as TEngine
from coraza_kubernetes_operator_tpu_torch.engine.compile_cache import EXEC_CACHE
from torch_rules import REQUESTS, SMALL_RULES

THREE_TIER = r'''
SecRule ARGS "@rx (e|fg)+h" "id:2001,phase:2,deny,status:403,t:none"
SecRule ARGS "@rx (a|bc)*a(a|bc){7}d" "id:2002,phase:2,deny,status:403,t:none"
SecRule ARGS "@contains evilpanda" "id:2003,phase:2,deny,status:403,t:none"
'''
RULES = SMALL_RULES + THREE_TIER
EXTRA = [("GET", "/?q=fgfgeh", [], b""), ("GET", "/?q=aaaaaaaad", [], b""),
         ("GET", "/?q=bcbcbcbcd", [], b""), ("GET", "/?pet=evilpanda", [], b"")]


def _requests(cls):
    reqs = [cls(method=m, uri=u, headers=h, body=b) for m, u, h, b in REQUESTS + EXTRA]
    for r in tcorpus.synthetic_requests(48, attack_ratio=0.4, seed=11):
        reqs.append(cls(method=r.method, uri=r.uri, headers=list(r.headers), body=r.body))
    # Enough short and long values that the window keeps two length tiers
    # (a tier under 256 rows merges into its neighbour).
    reqs += [cls(uri=f"/?a=short-{i}") for i in range(260)]
    reqs += [cls(uri=f"/?b={i}-" + "A" * 700) for i in range(260)]
    return reqs


def _vt(v):
    return (v.interrupted, v.status, v.rule_id, v.matched_ids, v.scores)


@pytest.fixture(scope="module")
def jax_verdicts():
    eng = JEngine(RULES)
    reqs = _requests(JRequest)
    return [_vt(v) for v in eng.evaluate(reqs)], [_vt(v) for v in eng.evaluate(reqs)]


def _count_host_twins(monkeypatch):
    calls = {"tier": 0, "post": 0}
    real_tier, real_post = TEngine._host_tier_hits, TEngine._host_post

    def tier(self, *a, **k):
        calls["tier"] += 1
        return real_tier(self, *a, **k)

    def post(self, *a, **k):
        calls["post"] += 1
        return real_post(self, *a, **k)

    monkeypatch.setattr(TEngine, "_host_tier_hits", tier)
    monkeypatch.setattr(TEngine, "_host_post", post)
    return calls


def test_lazy_setting_runs_every_stage_on_the_device_and_equals_jax(monkeypatch, jax_verdicts):
    want_first, want_second = jax_verdicts
    reqs = _requests(TRequest)
    eager = TEngine(RULES, device="cpu")
    assert [_vt(v) for v in eager.evaluate(reqs)] == want_first
    assert [_vt(v) for v in eager.evaluate(reqs)] == want_second  # value-cache rows

    monkeypatch.setenv("CKO_LAZY_TIERS", "1")
    jlazy = JEngine(RULES)
    assert [_vt(v) for v in jlazy.evaluate(_requests(JRequest))] == want_first
    calls = _count_host_twins(monkeypatch)
    lazy = TEngine(RULES, device="cpu")
    assert not lazy.warmed
    assert len(lazy.batch_signature(reqs)[1]) >= 2, "expected a window of more than one tier"
    assert [_vt(v) for v in lazy.evaluate(reqs)] == want_first and lazy.warmed
    assert [_vt(v) for v in lazy.evaluate(reqs)] == want_second
    assert calls == {"tier": 0, "post": 0}


def test_first_window_at_new_shapes_is_a_miss_on_the_device(monkeypatch, jax_verdicts):
    monkeypatch.setenv("CKO_LAZY_TIERS", "1")
    monkeypatch.setenv("CKO_VALUE_CACHE_MB", "0")  # one signature per batch
    calls = _count_host_twins(monkeypatch)
    EXEC_CACHE.clear()
    eng = TEngine(RULES, device="cpu")
    reqs = _requests(TRequest)
    n = len(eng.batch_signature(reqs))  # stages: one matcher per tier, then post
    h0, m0, _ = EXEC_CACHE.snapshot()
    assert [_vt(v) for v in eng.evaluate(reqs)] == jax_verdicts[0]
    h1, m1, _ = EXEC_CACHE.snapshot()
    assert (h1 - h0, m1 - m0) == (0, n)
    assert [_vt(v) for v in eng.evaluate(reqs)] == jax_verdicts[0]  # captures
    assert EXEC_CACHE.snapshot()[:2] == (h1, m1 + n)
    assert [_vt(v) for v in eng.evaluate(reqs)] == jax_verdicts[0]  # replays
    assert EXEC_CACHE.snapshot()[:2] == (h1 + n, m1 + n)
    assert calls == {"tier": 0, "post": 0}


def test_automata_summary_equals_jax_and_tier_timing(monkeypatch):
    reqs_t, reqs_j = _requests(TRequest), _requests(JRequest)
    jeng = JEngine(RULES)
    jeng.evaluate(reqs_j)
    monkeypatch.setenv("CKO_TIER_TIMING", "1")
    teng = TEngine(RULES, device="cpu")
    teng.evaluate(reqs_t)
    got, want = teng.automata_summary(), jeng.automata_summary()
    timing = got.pop("tier_p50_ms")
    want.pop("tier_p50_ms", None)
    assert got == want
    assert "post" in timing and any(k.startswith("match:") for k in timing)
    assert all(ms > 0 for ms in timing.values())
