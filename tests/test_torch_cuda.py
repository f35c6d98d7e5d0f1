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
limit rejecting) must give the CPU engine's verdicts. Four host threads
launching all four kernels at rising shared-memory sizes (in a fresh
process) must each get their plain version's bits, and every launch
counter must count exactly; so must each kernel launched, on each card,
from a thread whose current card was set to another one. The stage
graphs (``engine/compile_cache.py``): crs-lite's matcher and post stages
replay the eager bits and launch counts at the three main-path shapes,
finals off and on; a capture runs while another thread serves windows; a
stage that cannot be captured is a bypass and leaves the card serving
right; windows prepared by two lanes on one engine and collected by
two more threads keep their bits while another thread captures;
``reinit_device`` releases the old
model's graphs. Every test skips
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


THREADED_LAUNCHES = r"""
import sys, threading
import torch
sys.path.insert(0, sys.argv[1])
import test_torch_cuda as T
from coraza_kubernetes_operator_tpu_torch.ops import dfa, dfa_flat, dfa_gather, segment_finals

card = torch.device("cuda")
LENGTHS, REPS, THREADS = (40, 64, 256, 1024, 2048), 2, 4
banks = (T.SMALL[:3], T.SMALL + T.MID)
dense = dfa.build_dense_tier([dfa.stack_dfas(d, device=card) for d in banks], [0, 1])
gather = dfa_gather.build_gather_tier([dfa_gather.stack_gather_bank(d, device=card) for d in banks], [0, 1])
bins, _ = dfa_flat.plan_flat_bins([(i, p, d) for i, (p, d) in enumerate(T.FLAT_GROUPS)], max_slots=100000)
flat = dfa_flat.build_flat_bank(bins[0], device=card)


def scan(kind, length, seed):
    if kind == "finals":
        # 600 groups: the kernel's shared memory passes 48 KB from 1024 bytes on.
        e, s, l, tables, q = T._finals_operands(card, 128, length, 36, 26, 700, 600, seed, 0.05)
        return (segment_finals.finals_match(e, s, l, tables, q=q),
                segment_finals.finals_match_plain(e, s, l, tables, q=q), 1)
    if kind == "flat":
        x = {p: tuple(T._on(card, *T._rows(2048, length, seed + p))) for p in flat.pipeline_ids}
        return dfa_flat.scan_flat_bank(flat, x), dfa_flat.scan_flat_xla(flat, x), len(flat.layout.launches)
    tier, fn, plain = ((dense, dfa.scan_dense_tier, dfa.scan_dense_tier_plain) if kind == "dense"
                       else (gather, dfa_gather.scan_gather_tier, dfa_gather.scan_gather_tier_plain))
    x = [tuple(T._on(card, *T._rows(2048, length, seed + k))) for k in range(2)]
    return fn(tier, x, (True, True)), plain(tier, x, (True, True)), len(tier.launches)


MODS = {"dense": dfa, "gather": dfa_gather, "flat": dfa_flat, "finals": segment_finals}
expected = {k: 0 for k in MODS}
lock, errors, start = threading.Lock(), [], threading.Barrier(THREADS)


def work(t):
    kinds = list(MODS)[t:] + list(MODS)[:t]
    start.wait()
    try:
        for length in LENGTHS:  # rising shared-memory sizes, raced from every thread
            for r in range(REPS):
                for kind in kinds:
                    got, want, n = scan(kind, length, 1000 * t + 10 * r)
                    torch.cuda.synchronize()
                    if not torch.equal(got, want):
                        raise AssertionError(f"{kind} L={length} thread {t}: differs from plain")
                    with lock:
                        expected[kind] += n
    except BaseException as err:
        errors.append(err)


for mod in MODS.values():
    mod.LAUNCHES = 0
threads = [threading.Thread(target=work, args=(t,)) for t in range(THREADS)]
for th in threads:
    th.start()
for th in threads:
    th.join()
if errors:
    raise errors[0]
got = {k: mod.LAUNCHES for k, mod in MODS.items()}
assert got == expected, (got, expected)
print("ok", got)
"""


def test_threads_launch_every_kernel_at_rising_smem(card):
    """Four host threads launch all four kernels at rising shared-memory
    sizes, in a fresh process so every attribute raise happens under the
    race (the shared-memory caches are process-wide). Every output equals
    its plain version, and each LAUNCHES counter counts exactly."""
    import subprocess
    import sys
    from pathlib import Path

    tests = Path(__file__).resolve().parent
    out = subprocess.run(
        [sys.executable, "-c", THREADED_LAUNCHES, str(tests)], cwd=tests.parent,
        capture_output=True, text=True, timeout=600,
    )
    assert out.returncode == 0, out.stderr[-4000:]
    assert out.stdout.startswith("ok"), out.stdout


def test_launch_runs_on_the_tensors_card_not_the_threads(card):
    """For each card, a thread whose current card was set explicitly to
    another one (the same one where the machine has a single card) launches
    all four kernels on tensors of that card, at sizes past the default
    shared memory: each equals its plain version, each launch counts, and
    the thread's current card is the one it set, after every launch."""
    import threading

    n_cards = torch.cuda.device_count()
    errors = []

    def kernels_on(dev, length, seed):
        """(kind, kernel output, plain output, launches) on ``dev``."""
        banks = (SMALL[:3], SMALL + MID)
        dense = dfa.build_dense_tier([dfa.stack_dfas(d, device=dev) for d in banks], [0, 1])
        gather = dfa_gather.build_gather_tier(
            [dfa_gather.stack_gather_bank(d, device=dev) for d in banks], [0, 1])
        bins, _ = dfa_flat.plan_flat_bins([(i, p, d) for i, (p, d) in enumerate(FLAT_GROUPS)],
                                          max_slots=100000)
        flat = dfa_flat.build_flat_bank(bins[0], device=dev)
        x = [tuple(_on(dev, *_rows(2048, length, seed + k))) for k in range(2)]
        by_pipe = {p: tuple(_on(dev, *_rows(2048, length, seed + p))) for p in flat.pipeline_ids}
        e, s, l, tables, q = _finals_operands(dev, 128, length, 36, 26, 700, 600, seed, 0.05)
        yield ("dense", lambda: dfa.scan_dense_tier(dense, x, (True, True)),
               dfa.scan_dense_tier_plain(dense, x, (True, True)), len(dense.launches), dfa)
        yield ("gather", lambda: dfa_gather.scan_gather_tier(gather, x, (True, True)),
               dfa_gather.scan_gather_tier_plain(gather, x, (True, True)), len(gather.launches),
               dfa_gather)
        yield ("flat", lambda: dfa_flat.scan_flat_bank(flat, by_pipe),
               dfa_flat.scan_flat_xla(flat, by_pipe), len(flat.layout.launches), dfa_flat)
        yield ("finals", lambda: segment_finals.finals_match(e, s, l, tables, q=q),
               segment_finals.finals_match_plain(e, s, l, tables, q=q), 1, segment_finals)

    def work(d):
        try:
            other = (d + 1) % n_cards
            torch.cuda.set_device(other)
            dev = torch.device("cuda", d)
            for kind, launch, want, n, mod in kernels_on(dev, 1024, 70 + d):
                before = mod.LAUNCHES
                got = launch()
                torch.cuda.synchronize(dev)
                assert got.device == dev, (kind, got.device)
                assert torch.cuda.current_device() == other, (kind, torch.cuda.current_device())
                assert mod.LAUNCHES == before + n, (kind, mod.LAUNCHES, before, n)
                assert torch.equal(got, want), f"{kind} on card {d} from a thread on card {other}"
        except BaseException as err:
            errors.append(err)

    for d in range(n_cards):
        th = threading.Thread(target=work, args=(d,))
        th.start()
        th.join(timeout=600)
        assert not th.is_alive(), f"card {d}: the launching thread did not finish"
    if errors:
        raise errors[0]


def test_sharded_engine_over_nccl_at_1x1_equals_single(card):
    """The sharded engine on a one-rank NCCL group (mesh (1, 1)): its
    verdicts equal the single engine's on the card, and its DFA buckets
    launch ``cko_scan_dense``. The multi-rank layouts run on the CPU over
    gloo (tests/test_torch_parallel.py)."""
    import datetime
    import socket

    import torch.distributed as dist

    from coraza_kubernetes_operator_tpu_torch.compiler.ruleset import compile_rules
    from coraza_kubernetes_operator_tpu_torch.parallel import ShardedWafEngine, make_mesh

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=60))
    try:
        reqs = [HttpRequest(method=m, uri=u, headers=h, body=b) for m, u, h, b in REQUESTS]
        compiled = compile_rules(SMALL_RULES)
        sharded = ShardedWafEngine(compiled=compiled, mesh=make_mesh(1, 1))
        assert sharded.model.banks and sharded.device.type == "cuda"
        before = dfa.LAUNCHES
        got = sharded.evaluate(reqs)
        torch.cuda.synchronize()
        assert dfa.LAUNCHES > before
    finally:
        dist.destroy_process_group()
    want = WafEngine(compiled).evaluate(reqs)
    assert [(v.interrupted, v.status, v.rule_id) for v in got] == [
        (v.interrupted, v.status, v.rule_id) for v in want]
    assert any(v.interrupted for v in got)


def test_abi_typed_launchers_equal_plain(card):
    """Every launcher is bound from ``ops/kernels.py::_ABI``: at one shape
    each kernel gives its plain version's bits, the bound types are the
    table's, ``cko_error_string`` returns text, and a value the table does
    not allow raises ``ctypes.ArgumentError`` before any launch."""
    import ctypes

    from coraza_kubernetes_operator_tpu_torch.ops import kernels

    banks = (SMALL[:3], SMALL + MID)
    dense = dfa.build_dense_tier([dfa.stack_dfas(d, device=card) for d in banks], [0, 1])
    gather = dfa_gather.build_gather_tier(
        [dfa_gather.stack_gather_bank(d, device=card) for d in banks], [0, 1])
    bins, _ = dfa_flat.plan_flat_bins([(i, p, d) for i, (p, d) in enumerate(FLAT_GROUPS)],
                                      max_slots=100000)
    flat = dfa_flat.build_flat_bank(bins[0], device=card)
    x = [tuple(_on(card, *_rows(4096, 64, 90 + k))) for k in range(2)]
    by_pipe = {p: tuple(_on(card, *_rows(4096, 64, 90 + p))) for p in flat.pipeline_ids}
    e, s, lens, tables, q = _finals_operands(card, 4096, 64, 36, 26, 700, 600, 91, 0.05)
    pairs = [
        (dfa.scan_dense_tier(dense, x, (True, True)), dfa.scan_dense_tier_plain(dense, x, (True, True))),
        (dfa_gather.scan_gather_tier(gather, x, (True, True)),
         dfa_gather.scan_gather_tier_plain(gather, x, (True, True))),
        (dfa_flat.scan_flat_bank(flat, by_pipe), dfa_flat.scan_flat_xla(flat, by_pipe)),
        (segment_finals.finals_match(e, s, lens, tables, q=q),
         segment_finals.finals_match_plain(e, s, lens, tables, q=q)),
    ]
    torch.cuda.synchronize()
    for got, want in pairs:
        assert torch.equal(got, want)
    for name in ("cko_scan_dense", "cko_scan_gather", "cko_scan_flat", "cko_finals_match"):
        fn = kernels._FUNCS[name]
        assert fn.argtypes == [kernels._CTYPES[t] for t in kernels._ABI[name]["args"]], name
        assert fn.restype is ctypes.c_int
    for stem in ("dfa_scan", "segment_finals"):
        assert kernels._LIBS[stem].cko_error_string(0) == b"no error"
    finals = kernels._FUNCS["cko_finals_match"]
    with pytest.raises(ctypes.ArgumentError):
        finals(*[ctypes.c_int(0)] * len(finals.argtypes))  # an int where a pointer goes


# -- stage graphs (engine/compile_cache.py) -----------------------------------

@pytest.fixture(scope="module")
def crs_lite():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from coraza_kubernetes_operator_tpu_torch.ftw.corpus import load_ruleset_text

    return WafEngine(load_ruleset_text())


_LAUNCH_MODS = (dfa, dfa_gather, dfa_flat, segment_finals)


def _counted(fn):
    """(fn(), launches it booked per counter)."""
    before = [m.LAUNCHES for m in _LAUNCH_MODS]
    out = fn()
    return out, [m.LAUNCHES - b for m, b in zip(_LAUNCH_MODS, before)]


def _stage_inputs(card, eng, b, length, seed):
    """A matcher tier's arguments and the post stage's pairs and numvals
    for ``b`` seeded rows of width ``length``."""
    rng = np.random.default_rng(seed)
    data, lens = _rows(b, length, seed)
    h = max(1, len(eng._rows.host_pipelines))
    vd = np.broadcast_to(data, (h, b, length)).copy()
    vl = np.broadcast_to(np.minimum(lens, length), (h, b)).copy()
    n_req, n_kinds = 1024, eng.compiled.vocab.n_kinds
    kinds = [rng.integers(0, n_kinds + 1, b).astype(np.int32) for _ in range(3)]
    rid = rng.integers(0, n_req + 1, b).astype(np.int32)
    uid = rng.integers(0, b, b).astype(np.int32)
    numvals = np.zeros((n_req, eng.compiled.numvars.n_vars), dtype=np.int32)
    return ((eng.model, *_on(card, data, lens, vd, vl)), tuple(_on(card, *kinds, rid, uid)),
            _on(card, numvals)[0])


@pytest.mark.parametrize("finals", ["0", "1"], ids=["finals-off", "finals-on"])
@pytest.mark.parametrize("b,length", SHAPES[:3], ids=SHAPE_IDS[:3])
def test_stage_graphs_replay_the_eager_bits(card, crs_lite, monkeypatch, b, length, finals):
    """crs-lite's matcher and post stages through a stage cache: the eager
    first sight, the capture (served by its side-stream run) and a replay
    each give the eager call's bits on the same inputs and book the same
    kernel launches."""
    from coraza_kubernetes_operator_tpu_torch.engine.compile_cache import ExecutableCache
    from coraza_kubernetes_operator_tpu_torch.models.waf_model import (
        eval_post_tiered,
        match_tier_packed,
    )

    monkeypatch.setenv("CKO_PALLAS_FINALS", finals)
    cache = ExecutableCache()
    for seed in (1, 2, 3):
        args, pairs, numvals = _stage_inputs(card, crs_lite, b, length, seed)
        got, n_got = _counted(lambda: cache.call(match_tier_packed, args, {"mask": None}, {}))
        want, n_want = _counted(lambda: match_tier_packed(*args, mask=None))
        torch.cuda.synchronize()
        assert torch.equal(got, want) and n_got == n_want, (seed, n_got, n_want)
        assert n_want[0] + n_want[1] + n_want[2] > 0 and (n_want[3] > 0) == (finals == "1")
        post = (crs_lite.model, (want,), (pairs,), numvals)
        got = cache.call(eval_post_tiered, post, {"max_phase": 2}, {"cached": None})
        want = eval_post_tiered(*post, max_phase=2, cached=None)
        torch.cuda.synchronize()
        assert torch.equal(got, want), seed
    stats = cache.stats()
    assert (stats["captures"], stats["hits"], stats["bypasses"]) == (2, 2, 0), stats
    assert stats["compile_s"] > 0 and stats["trace_s"] > 0


def test_capture_while_another_thread_serves_windows(card):
    """One thread captures a model's stage graphs (prewarm) while another
    serves windows of another engine through its own graphs: every window
    equals the CPU engine's, and the captured graphs replay right after."""
    import threading

    reqs = [HttpRequest(method=m, uri=u, headers=h, body=b) for m, u, h, b in REQUESTS]
    want = [(v.interrupted, v.status, v.rule_id, v.matched_ids, v.scores)
            for v in WafEngine(SMALL_RULES, device="cpu").evaluate(reqs)]
    server, warmer = WafEngine(SMALL_RULES), WafEngine(REJECT_RULES)
    server.evaluate(reqs)
    got, errors, stop = [], [], threading.Event()

    def serve():
        try:
            while not stop.is_set() or len(got) < 6:
                got.append([(v.interrupted, v.status, v.rule_id, v.matched_ids, v.scores)
                            for v in server.evaluate(reqs)])
        except BaseException as err:
            errors.append(err)

    th = threading.Thread(target=serve)
    th.start()
    try:
        for n in (1, 4, 16):  # three signatures, each one eager run and one capture per stage
            assert warmer.prewarm(reqs[:n])["compiled"]
    finally:
        stop.set()
        th.join(timeout=600)
    assert not th.is_alive() and not errors, errors
    assert got and all(g == want for g in got)
    from coraza_kubernetes_operator_tpu_torch.engine.compile_cache import EXEC_CACHE

    assert EXEC_CACHE.resident(warmer.model, warmer.batch_signature(reqs[:16]))
    on_cpu = WafEngine(REJECT_RULES, device="cpu").evaluate(reqs[:16])
    assert [(v.interrupted, v.status, v.rule_id) for v in warmer.evaluate(reqs[:16])] == [
        (v.interrupted, v.status, v.rule_id) for v in on_cpu]


def test_pipelined_windows_beside_captures_keep_their_bits(card, crs_lite):
    """The sidecar's shape of concurrency: two lanes each prepare windows
    on one engine (their stages run eager, captured or replayed, the value
    cache on, so the model's graphs replay from both threads at once) while
    a collector per lane reads them back, two in flight, and another
    thread captures a second model's graphs meanwhile. Every window
    equals the card's eager verdicts on the same requests."""
    import queue
    import threading

    from coraza_kubernetes_operator_tpu_torch.corpus import synthetic_requests
    from coraza_kubernetes_operator_tpu_torch.engine.compile_cache import EXEC_CACHE

    def vkey(v):
        return (v.interrupted, v.status, v.rule_id, v.matched_ids, v.scores)

    windows = [synthetic_requests(128, attack_ratio=0.3, seed=500 + i) for i in range(6)]
    ref = WafEngine(crs_lite.compiled)
    ref.value_cache = None
    EXEC_CACHE.call = lambda fn, args, statics, dyn: fn(*args, **statics, **dyn)
    try:
        want = [[vkey(v) for v in ref.evaluate(w)] for w in windows]
    finally:
        del EXEC_CACHE.call
    server = WafEngine(crs_lite.compiled)
    orders = [[i for _ in range(4) for i in range(len(windows))],
              [i for _ in range(4) for i in reversed(range(len(windows)))]]
    got, errors = [], []

    def lane(order):
        inflight = queue.Queue(maxsize=2)

        def prepare():
            try:
                for i in order:
                    inflight.put((i, server.prepare(windows[i])))
            except BaseException as err:
                errors.append(err)
            finally:
                inflight.put(None)

        def collect():
            try:
                while (item := inflight.get()) is not None:
                    i, batch = item
                    got.append((i, [vkey(v) for v in server.collect(batch)]))
            except BaseException as err:
                errors.append(err)

        return [threading.Thread(target=prepare), threading.Thread(target=collect)]

    threads = [th for order in orders for th in lane(order)]
    h0 = EXEC_CACHE.snapshot()[0]
    for th in threads:
        th.start()
    for n in (64, 256, 1024):  # captures on another model, meanwhile
        crs_lite.prewarm(synthetic_requests(n, attack_ratio=0.3, seed=n))
    for th in threads:
        th.join(timeout=900)
    assert not any(th.is_alive() for th in threads) and not errors, errors
    assert len(got) == sum(map(len, orders)) and EXEC_CACHE.snapshot()[0] > h0
    bad = [i for i, v in got if v != want[i]]
    assert not bad, f"windows {bad} differ from the eager verdicts"


def test_a_stage_that_cannot_be_captured_is_a_bypass_and_the_next_window_is_right(card):
    """A stage that notes a host sync stays eager; one that reads a value
    back unnoted fails its capture, which ends cleanly: both are counted
    as bypasses with their bits right, and an engine window after them
    equals the CPU engine's."""
    from coraza_kubernetes_operator_tpu_torch.engine.compile_cache import ExecutableCache
    from coraza_kubernetes_operator_tpu_torch.ops import kernels

    class Owner:
        pass

    def noted(owner, x):
        kernels.note_host_sync("reads a count back")
        return x + int(x.sum().item() > -1)

    def unnoted(owner, x):
        return x * 2 + int(x.max().item() >= 0)

    cache, owner = ExecutableCache(), Owner()
    x = torch.arange(1024, device=card)
    for fn, want in ((noted, x + 1), (unnoted, x * 2 + 1)):
        for _ in range(3):
            assert torch.equal(cache.call(fn, (owner, x), {}, {}), want)
    stats = cache.stats()
    assert (stats["captures"], stats["hits"], stats["bypasses"]) == (0, 0, 4), stats
    reasons = [r for _k, r in cache.bypassed()]
    assert reasons[0] == "reads a count back" and reasons[1].startswith("capture failed"), reasons
    torch.cuda.synchronize()
    reqs = [HttpRequest(method=m, uri=u, headers=h, body=b) for m, u, h, b in REQUESTS]
    eng = WafEngine(SMALL_RULES)
    for _ in range(3):  # eager, captured, replayed
        got = [(v.interrupted, v.status, v.rule_id) for v in eng.evaluate(reqs)]
    on_cpu = WafEngine(SMALL_RULES, device="cpu").evaluate(reqs)
    assert got == [(v.interrupted, v.status, v.rule_id) for v in on_cpu]


def test_reinit_device_releases_the_graphs(card, monkeypatch):
    """After ``reinit_device`` the old model's graphs and their pool are
    gone, and the rebuilt model's windows are right."""
    import gc

    from coraza_kubernetes_operator_tpu_torch.engine.compile_cache import EXEC_CACHE

    monkeypatch.setenv("CKO_VALUE_CACHE_MB", "0")  # one signature for every window
    reqs = [HttpRequest(method=m, uri=u, headers=h, body=b) for m, u, h, b in REQUESTS]
    eng = WafEngine(SMALL_RULES)
    for _ in range(2):
        eng.evaluate(reqs)
    sig = eng.batch_signature(reqs)
    old = eng.model
    assert EXEC_CACHE.resident(old, sig)
    gc.collect()  # earlier tests' engines, so that only this one's graphs go below
    graphs, pool = len(EXEC_CACHE), EXEC_CACHE.pool_bytes()
    assert pool > 0
    eng.reinit_device()
    assert not EXEC_CACHE.resident(old, sig)
    del old
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    assert len(EXEC_CACHE) == graphs - len(sig) and EXEC_CACHE.pool_bytes() < pool
    want = [(v.interrupted, v.status, v.rule_id)
            for v in WafEngine(SMALL_RULES, device="cpu").evaluate(reqs)]
    for _ in range(3):
        assert [(v.interrupted, v.status, v.rule_id) for v in eng.evaluate(reqs)] == want
