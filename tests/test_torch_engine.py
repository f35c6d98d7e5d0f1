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
