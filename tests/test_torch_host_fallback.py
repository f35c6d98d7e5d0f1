"""PyTorch port parity: the host twins and the remaining entry points.

On the CPU, against the JAX package:

- ``HostFallbackEvaluator`` (scalar DFA walk + NumPy post-match, no
  device) gives the JAX package's evaluator's verdicts and the engines';
- ``WafEngine._host_tier_hits`` and ``_host_post`` are byte-equal to the
  device stages they stand in for (``match_tier_packed`` after the
  prefilter confirm, ``eval_post_tiered``) and to the JAX package's twins;
- ``evaluate_phased``, ``evaluate_response`` and ``evaluate_bulk_json``
  give the JAX engine's verdicts (the JAX package's bulk path loads the
  library the port built from the same source);
- ``prewarm`` captures a batch's stage graphs (``EXEC_CACHE``) without
  serving it, and ``reinit_device`` rebuilds the model, dropping the old
  one's graphs, without changing a verdict.
"""

import json

import numpy as np
import pytest
import torch

from coraza_kubernetes_operator_tpu import corpus as jcorpus
from coraza_kubernetes_operator_tpu import native as jnative
from coraza_kubernetes_operator_tpu.engine import HttpRequest as JRequest
from coraza_kubernetes_operator_tpu.engine import WafEngine as JEngine
from coraza_kubernetes_operator_tpu.engine.host_fallback import HostFallbackEvaluator as JHost
from coraza_kubernetes_operator_tpu.engine.request import HttpResponse as JResponse
from coraza_kubernetes_operator_tpu_torch import corpus as tcorpus
from coraza_kubernetes_operator_tpu_torch import native as tnative
from coraza_kubernetes_operator_tpu_torch.engine import HttpRequest as TRequest
from coraza_kubernetes_operator_tpu_torch.engine import WafEngine as TEngine
from coraza_kubernetes_operator_tpu_torch.engine.host_fallback import HostFallbackEvaluator as THost
from coraza_kubernetes_operator_tpu_torch.engine.request import HttpResponse as TResponse
from coraza_kubernetes_operator_tpu_torch.models.waf_model import eval_post_tiered, match_tier_packed
from torch_rules import OVER_LIMIT, REJECT_RULES, REQUESTS

RESPONSE_RULES = """
SecRuleEngine On
SecResponseBodyAccess On
SecRule REQUEST_URI "@contains /blocked-path" "id:101,phase:1,deny,status:403"
SecRule RESPONSE_STATUS "@streq 500" "id:301,phase:3,deny,status:403"
SecRule RESPONSE_HEADERS:X-Debug "@contains stacktrace" "id:302,phase:3,deny,status:403,t:none,t:lowercase"
SecRule RESPONSE_BODY "@contains secret-leak" "id:404,phase:4,deny,status:403"
"""
RESPONSES = [
    ("/x", 500, [], b""),
    ("/x", 200, [("X-Debug", "StackTrace follows")], b""),
    ("/x", 200, [], b"... secret-leak ..."),
    ("/x", 200, [], b"all fine"),
    ("/blocked-path", 200, [], b"all fine"),
]


def _requests(cls, pkg_corpus, n=40):
    reqs = [cls(method=m, uri=u, headers=h, body=b) for m, u, h, b in REQUESTS + OVER_LIMIT]
    return reqs + pkg_corpus.synthetic_requests(n, attack_ratio=0.4, seed=13)


def verdict_key(v):
    return (v.interrupted, v.status, v.rule_id, list(v.matched_ids), dict(v.scores))


def keys(vs):
    return [verdict_key(v) for v in vs]


@pytest.fixture(scope="module")
def engines():
    return JEngine(REJECT_RULES), TEngine(REJECT_RULES, device="cpu")


def test_host_fallback_evaluator_matches_jax(engines):
    jeng, teng = engines
    treqs, jreqs = _requests(TRequest, tcorpus), _requests(JRequest, jcorpus)
    want = keys(jeng.evaluate(jreqs))
    assert keys(JHost(jeng.compiled).evaluate(jreqs)) == want
    host = THost(teng.compiled)
    assert keys(host.evaluate(treqs)) == want
    assert keys(teng.host_fallback.evaluate(treqs)) == want
    assert keys(host.evaluate_phased(treqs)) == keys(JHost(jeng.compiled).evaluate_phased(jreqs))
    assert any(s == 413 for _, s, *_ in want) and any(s == 403 for _, s, *_ in want)


def test_host_tier_hits_and_post_byte_equal_device_stages(engines):
    jeng, teng = engines
    treqs = _requests(TRequest, tcorpus, n=60)
    tiers, numvals, masks, cached, _mkeys, lease = teng._batch_tensors(treqs)
    try:
        model = teng.model
        assert model.prefilter_cols  # the confirm step is exercised
        dev_hits = tuple(
            match_tier_packed(model, *(torch.as_tensor(t[i]) for i in (0, 1, 6, 7)), mask=m)
            for t, m in zip(tiers, masks)
        )
        dev_hits = teng._confirm_prefilter(dev_hits, tiers, (True,) * len(tiers))
        host_hits = tuple(teng._host_tier_hits(t, m) for t, m in zip(tiers, masks))
        for d, h, t, m in zip(dev_hits, host_hits, tiers, masks):
            assert h.dtype == np.uint8
            np.testing.assert_array_equal(h, d.numpy())
            np.testing.assert_array_equal(h, jeng._host_tier_hits(t, m))
        pairs = tuple(tuple(t[i] for i in (2, 3, 4, 5, 8)) for t in tiers)
        dev_packed = eval_post_tiered(
            model, dev_hits, tuple(tuple(torch.as_tensor(a) for a in p) for p in pairs),
            torch.as_tensor(numvals), max_phase=2,
            cached=None if cached is None else tuple(torch.as_tensor(c) for c in cached),
        ).numpy()
        host_packed = teng._host_post(host_hits, pairs, numvals, 2, cached)
        assert host_packed.dtype == np.int32
        np.testing.assert_array_equal(host_packed, dev_packed)
        np.testing.assert_array_equal(host_packed, jeng._host_post(host_hits, pairs, numvals, 2, cached))
    finally:
        if lease is not None:
            lease.release()


def test_evaluate_phased_matches_jax(engines):
    jeng, teng = engines
    treqs, jreqs = _requests(TRequest, tcorpus), _requests(JRequest, jcorpus)
    want = keys(jeng.evaluate_phased(jreqs))
    assert keys(teng.evaluate_phased(treqs)) == want
    assert keys(teng.host_fallback.evaluate_phased(treqs)) == want


def test_evaluate_response_matches_jax():
    jeng, teng = JEngine(RESPONSE_RULES), TEngine(RESPONSE_RULES, device="cpu")
    got = []
    for uri, status, headers, body in RESPONSES:
        want = jeng.evaluate_response(JRequest(uri=uri), JResponse(status=status, headers=headers, body=body))
        t = teng.evaluate_response(TRequest(uri=uri), TResponse(status=status, headers=headers, body=body))
        h = teng.host_fallback.evaluate_response(TRequest(uri=uri), TResponse(status=status, headers=headers, body=body))
        assert verdict_key(t) == verdict_key(h) == verdict_key(want)
        got.append(t.rule_id)
    assert got == [301, 302, 404, None, 101]


def test_evaluate_bulk_json_matches_jax(engines, monkeypatch):
    _, teng = engines
    # The JAX package loads the library the port built from the same source.
    monkeypatch.setenv("CKO_NATIVE_LIB", str(tnative.build_library()))
    monkeypatch.setattr(jnative, "_lib", None)
    jeng = JEngine(REJECT_RULES)
    assert jeng.native_enabled
    payload = json.dumps(
        {"requests": [
            {"method": m, "uri": u, "headers": [list(kv) for kv in h], "body": b.decode("latin-1")}
            for m, u, h, b in REQUESTS + OVER_LIMIT
        ]}
    ).encode()
    want_v, want_blob = jeng.evaluate_bulk_json(payload)
    got_v, got_blob = teng.evaluate_bulk_json(payload)
    assert got_blob == want_blob
    assert keys(got_v) == keys(want_v)
    assert [v.status for v in got_v[-3:]] == [413, 403, 413]
    assert teng.evaluate_bulk_json(b'{"requests": [') is None


def test_prewarm_records_signatures_and_reinit_keeps_verdicts(monkeypatch):
    monkeypatch.setenv("CKO_VALUE_CACHE_MB", "0")  # signatures stay put
    from coraza_kubernetes_operator_tpu_torch.engine.compile_cache import EXEC_CACHE

    EXEC_CACHE.clear()  # process-wide: another test may have run these shapes
    teng = TEngine(REJECT_RULES, device="cpu")
    reqs = _requests(TRequest, tcorpus, n=8)
    assert not teng.warmed
    first = teng.prewarm()
    assert first["compiled"] and first["wall_s"] > 0 and not teng.warmed  # nothing served
    assert not teng.prewarm()["compiled"]
    sig = teng.batch_signature(reqs)
    assert not EXEC_CACHE.resident(teng.model, sig)
    assert teng.prewarm(reqs)["compiled"] and EXEC_CACHE.resident(teng.model, sig)
    want = keys(teng.evaluate(reqs))
    old = teng.model
    teng.reinit_device()
    assert teng.model is not old and not teng.warmed
    assert not EXEC_CACHE.resident(old, sig)  # the old model's graphs went with it
    assert keys(teng.evaluate(reqs)) == want and teng.warmed
