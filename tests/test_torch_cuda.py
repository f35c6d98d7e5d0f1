"""Card-only checks of the port's CUDA kernels (marker ``cuda``).

Each scan kernel is held bit for bit against its plain PyTorch version on
the card, on edge cases the main path rarely shows: empty rows, lengths
past the buffer, f32-class tables, a table too large for shared memory
(read from global memory by the same kernel), and a multi-pipeline flat
bin. Then a small engine window on the card must give the CPU engine's
verdicts. Every test skips where there is no card. This file imports no
JAX, so it also runs on the card's machine, without the JAX package's
conftest::

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from coraza_kubernetes_operator_tpu_torch.compiler import re_dfa
from coraza_kubernetes_operator_tpu_torch.engine import HttpRequest, WafEngine
from coraza_kubernetes_operator_tpu_torch.ops import dfa, dfa_flat, dfa_gather
from torch_rules import REQUESTS, SMALL_RULES

pytestmark = pytest.mark.cuda

SMALL = [
    re_dfa.compile_regex_dfa(r"(?i:<script[^>]*>)"),
    re_dfa.compile_regex_dfa("^/admin"),
    re_dfa.compile_regex_dfa("passwd$"),
    re_dfa.compile_regex_dfa("a*"),  # always-match
    re_dfa.literal_dfa(b"evilmonkey"),
    re_dfa.pm_dfa([b"sleep", b"benchmark", b"waitfor"]),
]
MID = [re_dfa.literal_dfa(b"abcdefghij" * 8)]  # S in (64, 128]: f32-class tables
HUGE = [re_dfa.literal_dfa(b"0123456789abcdef" * 32)]  # [256, S] int16 > smem cap


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def _rows(n, length, seed):
    rng = np.random.default_rng(seed)
    alphabet = np.frombuffer(b"abcdefghij0123456789<>script/admin passwd evilmonkey", np.uint8)
    data = alphabet[rng.integers(0, alphabet.size, size=(n, length))]
    tokens = [b"<script>", b"/admin", b"passwd", b"evilmonkey", b"benchmark", b"abcdefghij" * 3]
    for r in rng.choice(n, size=n // 2, replace=False):
        tok = np.frombuffer(tokens[rng.integers(len(tokens))], np.uint8)
        at = rng.integers(0, length - tok.size)
        data[r, at : at + tok.size] = tok
    lens = rng.integers(length // 2, length + 1, size=n).astype(np.int32)
    lens[1] = 0
    lens[2] = length + 7  # past the buffer
    data[np.arange(length)[None, :] >= lens[:, None]] = 0
    return data, lens


def _on(card, *arrays):
    return [torch.as_tensor(a, device=card) for a in arrays]


@pytest.mark.parametrize("dfas", [SMALL, SMALL + MID], ids=["int8", "f32"])
def test_dense_kernel_equals_plain(card, dfas):
    bank = dfa.stack_dfas(dfas, device=card)
    data, lens = _on(card, *_rows(3000, 48, seed=1))
    before = dfa.LAUNCHES
    got = dfa.scan_dfa_bank(bank, data, lens)
    torch.cuda.synchronize()
    assert dfa.LAUNCHES == before + 1
    assert torch.equal(got, dfa.scan_dfa_bank_take(bank, data, lens))


@pytest.mark.parametrize("dfas", [SMALL, SMALL + MID], ids=["int8", "f32"])
def test_gather_kernel_equals_plain(card, dfas):
    bank = dfa_gather.stack_gather_bank(dfas, device=card)
    data, lens = _on(card, *_rows(3000, 48, seed=2))
    before = dfa_gather.LAUNCHES
    got = dfa_gather.scan_gather_bank(bank, data, lens)
    torch.cuda.synchronize()
    assert dfa_gather.LAUNCHES == before + 1
    assert torch.equal(got, dfa_gather.scan_gather_bank_jnp(bank, data, lens))


def test_flat_kernel_equals_plain_with_global_memory_table(card):
    bins, rejected = dfa_flat.plan_flat_bins(
        [(0, 0, SMALL), (1, 3, SMALL[:3] + MID), (2, 3, HUGE)], max_slots=100000
    )
    assert not rejected and len(bins) == 1
    flat = dfa_flat.build_flat_bank(bins[0], device=card)
    assert flat.kt.smem_bytes < 2 * 256 * HUGE[0].n_states  # HUGE reads from L2
    d0, l0 = _rows(2000, 40, seed=3)
    d3, l3 = _rows(2000, 40, seed=4)
    by_pipe = {0: tuple(_on(card, d0, l0)), 3: tuple(_on(card, d3, l3))}
    before = dfa_flat.LAUNCHES
    got = dfa_flat.scan_flat_bank(flat, by_pipe)
    torch.cuda.synchronize()
    assert dfa_flat.LAUNCHES == before + 1
    assert torch.equal(got, dfa_flat.scan_flat_xla(flat, by_pipe))


def test_engine_window_on_card_equals_cpu(card):
    reqs = [HttpRequest(method=m, uri=u, headers=h, body=b) for m, u, h, b in REQUESTS]
    on_card = WafEngine(SMALL_RULES).evaluate(reqs)
    on_cpu = WafEngine(SMALL_RULES, device="cpu").evaluate(reqs)

    def key(v):
        return (v.interrupted, v.status, v.rule_id, v.matched_ids, v.scores)

    assert [key(v) for v in on_card] == [key(v) for v in on_cpu]
    assert any(v.interrupted for v in on_card)
