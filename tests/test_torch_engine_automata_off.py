"""PyTorch port parity: ``WafEngine.evaluate`` vs the JAX package's with
the two-level automata plan off (``CKO_AUTOMATA=0``): every non-segment
group stays on the generic DFA banks, fused into flat bins. Same rules
and requests as ``tests/test_torch_engine.py``; kept in its own file so
the two reference engines compile on two test workers.
"""

from test_torch_engine import run_config2_parity


def test_config2_window_matches_jax_automata_off(monkeypatch):
    monkeypatch.setenv("CKO_AUTOMATA", "0")
    eng = run_config2_parity()
    m = eng.model
    assert m.flat_banks and not m.gather_banks and not m.pre_banks
