"""Card-only checks of the port's CUDA kernels (marker ``cuda``).

Each scan kernel is held bit for bit against its plain PyTorch version on
the card, on edge cases the main path rarely shows: empty rows, lengths
past the buffer, f32-class tables, a table too large for shared memory
(read from global memory by the same kernel), and a multi-pipeline flat
bin. The fused dense and gather tiers (several banks over distinct
pipelines, under kind masks), the flat kernel and the finals kernel are
held against their plain versions at the main path's shapes (12288 x 64,
1024 x 2048 rows, and 4096 x 64); the tiers and a flat bin over nine
pipelines run as two launches;
the finals kernel also at a crs-lite block's widths, with two embed words
per position, with no channel and at one row and column. Then small
engine windows on the card (the
request path, and the blob path with the finals tier on and the body
limit rejecting) must give the CPU engine's verdicts. Every test skips
where there is no card. This file imports no
JAX, so it also runs on the card's machine, without the JAX package's
conftest::

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from coraza_kubernetes_operator_tpu_torch.compiler import re_dfa
from coraza_kubernetes_operator_tpu_torch.engine import HttpRequest, WafEngine
from coraza_kubernetes_operator_tpu_torch.native import serialize_requests
from coraza_kubernetes_operator_tpu_torch.ops import dfa, dfa_flat, dfa_gather, segment_finals
from torch_rules import OVER_LIMIT, REJECT_RULES, REQUESTS, SMALL_RULES

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


SHAPES = [(12288, 64), (1024, 2048), (4096, 64), (777, 40)]
SHAPE_IDS = ["12288x64", "1024x2048", "4096x64", "unaligned"]
TIERS = {  # kind: (stack a bank, build a tier, fused scan, plain tier, module)
    "dense": (dfa.stack_dfas, dfa.build_dense_tier, dfa.scan_dense_tier, dfa.scan_dense_tier_plain, dfa),
    "gather": (dfa_gather.stack_gather_bank, dfa_gather.build_gather_tier,
               dfa_gather.scan_gather_tier, dfa_gather.scan_gather_tier_plain, dfa_gather),
}


@pytest.mark.parametrize("b,length", SHAPES, ids=SHAPE_IDS)
@pytest.mark.parametrize("on", [(True,) * 4, (False, True, False, True)], ids=["all", "masked"])
@pytest.mark.parametrize("kind", ["dense", "gather"])
def test_tier_kernel_equals_plain(card, kind, b, length, on):
    stack, build, scan, plain, mod = TIERS[kind]
    banks = [stack(d, device=card) for d in (SMALL[:3], SMALL[3:], SMALL + MID, SMALL[:1])]
    tier = build(banks, [0, 3, 0, 5])
    inputs = [tuple(_on(card, *_rows(b, length, seed=10 + k))) for k in range(3)]
    before = mod.LAUNCHES
    got = scan(tier, inputs, on)
    torch.cuda.synchronize()
    assert mod.LAUNCHES == before + 1
    assert torch.equal(got, plain(tier, inputs, on))


@pytest.mark.parametrize("kind", ["dense", "gather"])
def test_tier_over_nine_pipelines_kernel_equals_plain(card, kind):
    """Banks over nine pipelines: two launches (slots 0-7, then 8), one
    output."""
    stack, build, scan, plain, mod = TIERS[kind]
    banks = [stack(SMALL[i % 6 : i % 6 + 2], device=card) for i in range(9)]
    tier = build(banks, list(range(9)))
    assert len(tier.launches) == 2
    inputs = [tuple(_on(card, *_rows(3000, 48, seed=30 + k))) for k in range(9)]
    on = (True,) * 9
    before = mod.LAUNCHES
    got = scan(tier, inputs, on)
    torch.cuda.synchronize()
    assert mod.LAUNCHES == before + 2
    assert torch.equal(got, plain(tier, inputs, on))


# crs-lite's flat bin has groups of 68 to 118 states over four pipelines.
FLAT_GROUPS = [
    (0, SMALL + MID), (2, [re_dfa.literal_dfa(b"0123456789abcdef" * 7)]),
    (5, [re_dfa.literal_dfa(b"abcdefghijklmnopq" * 4)] + SMALL[:2]), (6, MID + SMALL[4:]),
]


@pytest.mark.parametrize("b,length", SHAPES, ids=SHAPE_IDS)
def test_flat_kernel_equals_plain(card, b, length):
    bins, rejected = dfa_flat.plan_flat_bins(
        [(i, pid, d) for i, (pid, d) in enumerate(FLAT_GROUPS)], max_slots=100000
    )
    assert not rejected and len(bins) == 1
    flat = dfa_flat.build_flat_bank(bins[0], device=card)
    assert flat.pipeline_ids == [0, 2, 5, 6]
    by_pipe = {p: tuple(_on(card, *_rows(b, length, seed=40 + p))) for p in flat.pipeline_ids}
    before = dfa_flat.LAUNCHES
    got = dfa_flat.scan_flat_bank(flat, by_pipe)
    torch.cuda.synchronize()
    assert dfa_flat.LAUNCHES == before + 1
    want = dfa_flat.scan_flat_xla(flat, by_pipe)
    assert torch.equal(got, want)
    assert want.any() and not want.all()


def test_flat_over_nine_pipelines_kernel_equals_plain(card):
    bins, _rejected = dfa_flat.plan_flat_bins(
        [(i, i, SMALL[i % 6 : i % 6 + 2]) for i in range(9)], max_slots=100000, length_hint=16
    )
    assert len(bins) == 1
    flat = dfa_flat.build_flat_bank(bins[0], device=card)
    assert len(flat.layout.launches) == 2
    by_pipe = {p: tuple(_on(card, *_rows(3000, 48, seed=50 + p))) for p in flat.pipeline_ids}
    before = dfa_flat.LAUNCHES
    got = dfa_flat.scan_flat_bank(flat, by_pipe)
    torch.cuda.synchronize()
    assert dfa_flat.LAUNCHES == before + 2
    assert torch.equal(got, dfa_flat.scan_flat_xla(flat, by_pipe))


def test_flat_kernel_equals_plain_with_global_memory_table(card):
    bins, rejected = dfa_flat.plan_flat_bins(
        [(0, 0, SMALL), (1, 3, SMALL[:3] + MID), (2, 3, HUGE)], max_slots=100000
    )
    assert not rejected and len(bins) == 1
    flat = dfa_flat.build_flat_bank(bins[0], device=card)
    _rpt, _cols, tab_smem, _smem = dfa_flat.flat_launch_shape(flat.layout, 2000, 40, 132)
    assert tab_smem < 2 * 256 * HUGE[0].n_states  # HUGE reads from L2
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


def _finals_operands(card, t, length, c, w, nf, gf, seed, suffix_density):
    """Seeded finals operands on the card: embed, suffix, lengths, and the
    block tables (weights, descriptors with zero and positive n_lead and
    anchored groups, column groups)."""
    rng = np.random.default_rng(seed)
    q = length + 2
    ns = max(1, 2 * gf // 3)
    embed = torch.as_tensor(rng.random((t, q + w - 1, c)) < 0.9, device=card)
    # Segment-shaped columns: each window position adds 1 on two channels
    # (2 on one), so a window reaches 2W only where all of them are set.
    wk = np.zeros((w, c, nf), dtype=np.int64)
    if c:
        for ch in rng.integers(0, c, size=(2, w, nf)):
            np.add.at(wk, (np.arange(w)[:, None], ch, np.arange(nf)[None, :]), 1)
    weights = torch.as_tensor(wk.reshape(w * c, nf), device=card).to(torch.bfloat16)
    suffix = torch.as_tensor(rng.random((t, q, ns)) < suffix_density, device=card)
    lens = torch.as_tensor(rng.integers(0, length + 1, size=t).astype(np.int32), device=card)
    desc = np.stack([rng.integers(0, ns, gf), rng.choice([0, 0, 1, 2], gf), rng.integers(1, 5, gf),
                     (rng.random(gf) < 0.2).astype(np.int64)], axis=1)
    desc[0, 1:] = (1, 2, 1)
    tables = segment_finals.finals_tables(weights, desc, rng.integers(0, gf, size=nf), w=w)
    return embed, suffix, lens, tables, q


@pytest.mark.parametrize(
    "t,length,c,w,nf,gf,sd",
    [(300, 60, 36, 26, 361, 307, 0.05), (64, 200, 70, 5, 33, 6, 0.05), (17, 9, 0, 3, 40, 5, 0.3),
     (1, 4, 5, 1, 1, 1, 0.5), (12288, 64, 41, 23, 117, 98, 0.002), (1024, 2048, 36, 26, 361, 307, 0.0005),
     (4096, 64, 27, 19, 128, 118, 0.002)],
    ids=["crs-block", "two-words", "no-channel", "single", "12288x64", "1024x2048", "4096x64"],
)
def test_finals_kernel_equals_plain(card, t, length, c, w, nf, gf, sd):
    embed, suffix, lens, tables, q = _finals_operands(
        card, t, length, c, w, nf, gf, seed=c + w, suffix_density=sd
    )
    before = segment_finals.LAUNCHES
    got = segment_finals.finals_match(embed, suffix, lens, tables, q=q)
    torch.cuda.synchronize()
    assert segment_finals.LAUNCHES == before + 1
    want = segment_finals.finals_match_plain(embed, suffix, lens, tables, q=q)
    assert torch.equal(got, want)
    if t >= 64 and c:
        assert want.any() and not want.all()


def test_blob_window_on_card_with_finals_equals_cpu(card, monkeypatch):
    monkeypatch.setenv("CKO_PALLAS_FINALS", "1")
    reqs = [HttpRequest(method=m, uri=u, headers=h, body=b) for m, u, h, b in REQUESTS + OVER_LIMIT]
    blob = serialize_requests(reqs)
    eng = WafEngine(REJECT_RULES)
    assert eng.native_enabled

    def key(v):
        return (v.interrupted, v.status, v.rule_id, v.matched_ids, v.scores)

    before = segment_finals.LAUNCHES
    got = [key(v) for v in eng.collect(eng.prepare_blob(blob, len(reqs)))]
    assert segment_finals.LAUNCHES > before
    want = [key(v) for v in WafEngine(REJECT_RULES, device="cpu").evaluate(reqs)]
    assert got == want
    assert [key(v) for v in eng.host_fallback.evaluate(reqs)] == want
    assert eng.native_stats()["arena"]["buffers"] == 1
