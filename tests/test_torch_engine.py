"""PyTorch port parity: ``WafEngine.evaluate`` vs the JAX package's.

The port's engine runs on the CPU (``device="cpu"``) and the reference on
JAX's CPU backend, on the same Seclang text and the same requests. Every
verdict field (interrupted, status, rule id, matched ids, anomaly scores)
must be equal. The rules are config 2's (crs-lite ``crs-setup.conf``,
REQUEST-942 and REQUEST-949) plus the sample rules, with the automata
plan on (``tests/test_torch_engine_automata_off.py`` runs it with
``CKO_AUTOMATA=0``), and a small ruleset that reaches every matcher kind
on hand-made requests. A second evaluation of the same window is served
partly from the value cache and must not change a verdict.
"""

import pytest

from coraza_kubernetes_operator_tpu import corpus as jcorpus
from coraza_kubernetes_operator_tpu.engine import HttpRequest as JRequest
from coraza_kubernetes_operator_tpu.engine import WafEngine as JEngine
from coraza_kubernetes_operator_tpu_torch import corpus as tcorpus
from coraza_kubernetes_operator_tpu_torch.engine import HttpRequest as TRequest
from coraza_kubernetes_operator_tpu_torch.engine import WafEngine as TEngine
from coraza_kubernetes_operator_tpu_torch.ftw.corpus import CRS_LITE_DIR
from torch_rules import REQUESTS, SMALL_RULES


def config2_rules() -> str:
    root = CRS_LITE_DIR
    parts = [f"SecDataDir {root / 'data'}"]
    for name in ("crs-setup.conf", "REQUEST-942-APPLICATION-ATTACK-SQLI.conf",
                 "REQUEST-949-BLOCKING-EVALUATION.conf"):
        parts.append((root / name).read_text())
    return "\n".join(parts) + tcorpus.sample_rules()


def verdict_key(v):
    return (v.interrupted, v.status, v.rule_id, list(v.matched_ids), dict(v.scores))


def assert_same_verdicts(got, want):
    assert len(got) == len(want)
    bad = [i for i, (g, w) in enumerate(zip(got, want)) if verdict_key(g) != verdict_key(w)]
    assert not bad, [(verdict_key(got[i]), verdict_key(want[i])) for i in bad[:3]]


def run_config2_parity(n_requests: int = 64, seed: int = 5):
    rules = config2_rules()
    jreqs = jcorpus.synthetic_requests(n_requests, attack_ratio=0.3, seed=seed)
    treqs = tcorpus.synthetic_requests(n_requests, attack_ratio=0.3, seed=seed)
    want = JEngine(rules).evaluate(jreqs)
    eng = TEngine(rules, device="cpu")
    got = eng.evaluate(treqs)
    assert_same_verdicts(got, want)
    assert any(v.interrupted for v in got)
    assert any(not v.interrupted for v in got)
    assert_same_verdicts(eng.evaluate(treqs), want)  # value-cache hits
    return eng


def test_config2_window_matches_jax_automata_on(monkeypatch):
    monkeypatch.delenv("CKO_AUTOMATA", raising=False)
    eng = run_config2_parity()
    m = eng.model
    assert m.flat_banks and m.gather_banks and m.pre_banks


@pytest.mark.parametrize("automata", ["1", "0"])
def test_small_rules_every_matcher_kind_matches_jax(monkeypatch, automata):
    monkeypatch.setenv("CKO_AUTOMATA", automata)
    jreqs = [JRequest(method=m, uri=u, headers=h, body=b) for m, u, h, b in REQUESTS]
    treqs = [TRequest(method=m, uri=u, headers=h, body=b) for m, u, h, b in REQUESTS]
    jeng, teng = JEngine(SMALL_RULES), TEngine(SMALL_RULES, device="cpu")
    want = jeng.evaluate(jreqs)
    got = teng.evaluate(treqs)
    assert_same_verdicts(got, want)
    assert {v.status for v in got} >= {200, 403, 405, 406, 413}
    assert teng.prefilter_stats == jeng.prefilter_stats
    assert verdict_key(teng.evaluate_one(treqs[1])) == verdict_key(want[1])


def test_confirm_split_tiles_the_confirm():
    """A window's prefilter confirm is logged as a read-back wait and an
    exact search per device tier, end to end: together they are the old
    ``stage_s["confirm"]``, from the match stages' dispatch to the post
    stage's."""
    rules = SMALL_RULES + 'SecRule ARGS "@rx (a|bc)*a(a|bc){7}d" "id:2002,phase:2,deny,status:403,t:none"\n'
    eng = TEngine(rules, device="cpu")
    reqs = [TRequest(uri="/?q=aaaaaaaad"), TRequest(uri="/?q=bcbcbcbcd")]
    reqs += [TRequest(uri=f"/?a=short-{i}") for i in range(260)]
    reqs += [TRequest(uri=f"/?b={i}-" + "A" * 700) for i in range(260)]
    inflight = eng.prepare(reqs)
    verdicts = eng.collect(inflight)
    assert [v.rule_id for v in verdicts[:2]] == [2002, None]
    assert eng.prefilter_stats["hits"] > eng.prefilter_stats["confirms"] > 0
    spans = inflight.spans
    names = [n for n, _t0, _t1 in spans]
    pieces = [s for s in spans if s[0] in ("confirm_wait", "confirm_search")]
    assert [s[0] for s in pieces] == ["confirm_wait", "confirm_search"] * (len(pieces) // 2)
    assert len(pieces) >= 4, "expected two device tiers"
    for (name, _a, b), (_next, c, _d) in zip(spans, spans[1:]):
        if name in ("copy_in", "match_dispatch", "confirm_wait", "confirm_search"):
            assert b == c  # each piece ends where the next begins
    match_end = spans[names.index("match_dispatch")][2]
    post_start = spans[names.index("post_dispatch")][1]
    wait = inflight.span_s("confirm_wait")
    search = inflight.span_s("confirm_search")
    assert wait + search == pytest.approx(post_start - match_end, abs=1e-9)
    assert inflight.stage_s["confirm"] == pytest.approx(wait + search, abs=1e-12)
