"""PyTorch port parity: the three DFA scan modules vs the JAX package.

For each module that holds a CUDA kernel (``ops/dfa.py`` ->
``cko_scan_dense``, ``ops/dfa_gather.py`` -> ``cko_scan_gather``,
``ops/dfa_flat.py`` -> ``cko_scan_flat``) the port's plain PyTorch version
runs on the CPU and is held, bit for bit, against the JAX twin (the XLA
formulation) and the JAX Pallas kernel in ``interpret=True`` mode. The
banks come from one regex corpus, compiled by each package's own copy of
the compiler, and cover every table dtype class (int8, bf16, f32, and
the dense-less S > 128 bank), a multi-pipeline flat bin, and B = 4096
(the batch size where a one-hot matmul inside an XLA scan miscompiles).

The CUDA kernels cannot run here; ``_emulate_kernel`` (dense and flat)
and ``_emulate_gather_tier`` (the fused dfa-hot tier) replay their
algorithms in numpy over the exact arguments the wrappers pass them (the
int16 per-group tables, offsets, pipeline index, class maps and per-group
records), so the kernel-side layout is checked on the CPU too. The fused
tier's plain version is held bank by bank against the JAX package on
several banks over distinct pipelines, under kind masks that skip some.
The kernels themselves are held against the plain versions on the card by
``chip_smoke.py``.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coraza_kubernetes_operator_tpu.compiler import re_dfa as jre
from coraza_kubernetes_operator_tpu.ops import dfa as jdfa
from coraza_kubernetes_operator_tpu.ops import dfa_flat as jflat
from coraza_kubernetes_operator_tpu.ops import dfa_gather as jgather
from coraza_kubernetes_operator_tpu.ops.dfa_gather_pallas import scan_gather_bank_pallas
from coraza_kubernetes_operator_tpu.ops.dfa_pallas import scan_dfa_bank_pallas
from coraza_kubernetes_operator_tpu_torch.compiler import re_dfa as tre
from coraza_kubernetes_operator_tpu_torch.ops import dfa as tdfa
from coraza_kubernetes_operator_tpu_torch.ops import dfa_flat as tflat
from coraza_kubernetes_operator_tpu_torch.ops import dfa_gather as tgather

CPU = torch.device("cpu")

PATTERNS = [
    ("rx", r"(?i:(\b(select|union|insert|update|delete|drop)\b.*\b(from|into|where|table)\b))"),
    ("rx", r"(?i:<script[^>]*>)"),
    ("rx", "^/admin"),
    ("rx", r"\bor\b\s*['\"]?\d+['\"]?\s*=\s*['\"]?\d+"),
    ("rx", "passwd$"),
    ("rx", "a*"),  # always-match
    ("lit", b"evilmonkey"),
    ("pm", [b"sleep", b"benchmark", b"waitfor"]),
]
# S in (64, 128]: f32 dense / gather tables, bf16 flat segment.
MID = [("lit", b"abcdefghij" * 8), ("rx", "x[0-9]{70}y")]
# S > 128: no dense table; f32 flat segment.
WIDE = [("lit", b"0123456789abcdef" * 9)]

CORPUS = [
    b"",
    b"GET /index.html",
    b"/admin/panel",
    b"select * from users",
    b"<script>alert(1)</script>",
    b"benchmark(100)",
    b"evilmonkey was here",
    b"or 1=1",
    b"/etc/passwd",
    b"abcdefghij" * 8,
    b"x" + b"7" * 70 + b"y",
    b"0123456789abcdef" * 9,
    b"a" * 80,
]
_ALPHABET = b"abcdefghijor1=' <>script/untilfwm0123456789xy\x00\xff"


def _compile(pkg, spec):
    kind, arg = spec
    if kind == "rx":
        return pkg.compile_regex_dfa(arg)
    if kind == "lit":
        return pkg.literal_dfa(arg)
    return pkg.pm_dfa(arg)


def _dfas(specs):
    return [_compile(jre, s) for s in specs], [_compile(tre, s) for s in specs]


def _batch(n, max_len, seed):
    """Corpus rows (cut to max_len) then seeded fuzz; ragged, zero padded."""
    rng = random.Random(seed)
    # A full-width row that ends in an end-anchored match (the end check
    # must read the state after the last byte of the buffer), the corpus,
    # then fuzz.
    rows = [(b"/" * max_len + b"passwd")[-max_len:]]
    rows = (rows + [c[:max_len] for c in CORPUS])[:n]
    while len(rows) < n:
        k = rng.randrange(0, max_len + 1)
        rows.append(bytes(rng.choice(_ALPHABET) for _ in range(k)))
    data = np.zeros((n, max_len), dtype=np.uint8)
    lens = np.zeros(n, dtype=np.int32)
    for i, r in enumerate(rows):
        data[i, : len(r)] = np.frombuffer(r, dtype=np.uint8)
        lens[i] = len(r)
    return data, lens


def _emulate_kernel(kt, dataT, lens, g, pipe=None, latch_end=True):
    """numpy replay of ``csrc/dfa_scan.cu::dfa_scan_kernel`` on the wrapper's
    arguments: dataT [P, L, B] uint8, lens [P, B]; returns [B, G] bool."""
    tab_all = kt.tab.numpy().astype(np.int64)
    offs, sizes = kt.tab_off.numpy(), kt.n_states.numpy()
    mend_all, moffs = kt.mend.numpy().astype(bool), kt.mend_off.numpy()
    always = kt.always.numpy().astype(bool)
    _, length, b = dataT.shape
    out = np.zeros((b, g), dtype=bool)
    for gi in range(g):
        s = int(sizes[gi])
        tab = tab_all[offs[gi] : offs[gi] + 256 * s].reshape(256, s)
        p = 0 if pipe is None else int(pipe[gi])
        ln = lens[p].astype(np.int64)
        state = np.zeros(b, dtype=np.int64)
        matched = np.zeros(b, dtype=bool)
        for t in range(length):
            byte = dataT[p, t].astype(np.int64)
            v = tab[byte, state]
            hit = v >= s
            active = t < ln
            matched |= hit & active
            state = np.where(active, v - s * hit, state)
        end_state = np.where(ln > length, 0, state) if latch_end else state
        mend = mend_all[moffs[gi] : moffs[gi] + s]
        out[:, gi] = matched | mend[end_state] | always[gi]
    return out


def _emulate_gather_tier(tier, inputs, on):
    """numpy replay of ``csrc/dfa_scan.cu::gather_tier_kernel`` on the
    tier's layout: per bank its pipeline slot's bytes through the bank's
    class map, then per group a walk of its [C, S] table slice named by
    ``bank_info`` and ``grp_info``; banks that are off give zeros. inputs
    are numpy (data [B, L], lens [B]) per slot; returns [B, G] bool."""
    tab = tier.tab.numpy().astype(np.int64)
    on_g = tier.on_groups(tuple(on)).numpy().astype(bool)
    mend, always = tier.mend.numpy().astype(bool), tier.always.numpy().astype(bool)
    b = next(x for x in inputs if x is not None)[0].shape[0]
    out = np.zeros((b, tier.n_groups), dtype=bool)
    for k, (g0, ng, toff, telems, slot) in enumerate(tier.bank_info.tolist()):
        if not on_g[g0 : g0 + ng].any():
            continue
        data, lens = inputs[slot]
        length = data.shape[1]
        cls = tier.cmaps.numpy()[k][data].astype(np.int64)  # one class per byte
        n = np.minimum(lens, length)
        for g in range(g0, g0 + ng):
            off, s, moff = tier.grp_info[g].tolist()
            c = telems // (ng * s)
            table = tab[toff + off : toff + off + c * s].reshape(c, s)
            state = np.zeros(b, dtype=np.int64)
            matched = np.zeros(b, dtype=bool)
            for t in range(length):
                v = table[cls[:, t], state]
                hit = v >= s
                active = t < n
                matched |= hit & active
                state = np.where(active, v - s * hit, state)
            end_state = np.where(lens > length, 0, state)
            out[:, g] = matched | mend[moff + end_state] | always[g]
    return out


def _t(a):
    return torch.as_tensor(a)


# ---------------------------------------------------------------------------
# ops/dfa.py: dense byte-indexed banks (cko_scan_dense)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("specs", [PATTERNS, PATTERNS + MID, WIDE], ids=["int8", "f32", "no-dense"])
def test_dense_bank_matches_jax(specs):
    jd, td = _dfas(specs)
    jbank, tbank = jdfa.stack_dfas(jd), tdfa.stack_dfas(td, device=CPU)
    for f in ("packed", "classmap", "match_end", "always", "t256"):
        want = np.asarray(getattr(jbank, f))
        got = getattr(tbank, f).numpy()
        assert got.dtype == want.dtype, f
        np.testing.assert_array_equal(got, want, err_msg=f)

    data, lens = _batch(96, 96, seed=7)
    got = tdfa.scan_dfa_bank(tbank, _t(data), _t(lens)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jdfa.scan_dfa_bank_gather(jbank, data, lens)))
    if tbank.t256.numel() == 0:
        assert tbank.kt is None
        return
    np.testing.assert_array_equal(got, np.asarray(jdfa.scan_dfa_bank_take(jbank, data, lens)))
    np.testing.assert_array_equal(
        got, _emulate_kernel(tbank.kt, data.T[None], lens[None], tbank.n_groups)
    )
    # The exact program the TPU runs, through the Pallas interpreter.
    d16, l16 = data[:24, :40], np.minimum(lens[:24], 40)
    pallas = scan_dfa_bank_pallas(
        jbank.t256, jbank.match_end.T, jbank.always, jnp.asarray(d16), jnp.asarray(l16),
        s=jbank.n_states, g=jbank.n_groups, interpret=True,
    )
    np.testing.assert_array_equal(
        tdfa.scan_dfa_bank_take(tbank, _t(d16), _t(l16)).numpy(), np.asarray(pallas)
    )


def test_dense_take_matches_jax_at_b4096():
    jd, td = _dfas(PATTERNS)
    jbank, tbank = jdfa.stack_dfas(jd), tdfa.stack_dfas(td, device=CPU)
    data, lens = _batch(4096, 24, seed=5)
    got = tdfa.scan_dfa_bank_take(tbank, _t(data), _t(lens)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jdfa.scan_dfa_bank_take(jbank, data, lens)))


def test_dense_lengths_past_buffer_latch_start_state():
    """A length beyond the buffer never reaches t == len - 1, so the end
    check reads the start state: the reference and the kernel layout
    agree on that edge."""
    jd, td = _dfas(PATTERNS)
    jbank, tbank = jdfa.stack_dfas(jd), tdfa.stack_dfas(td, device=CPU)
    data, lens = _batch(32, 16, seed=3)
    lens = lens + 20
    got = tdfa.scan_dfa_bank_take(tbank, _t(data), _t(lens)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jdfa.scan_dfa_bank_take(jbank, data, lens)))
    np.testing.assert_array_equal(
        got, _emulate_kernel(tbank.kt, data.T[None], lens[None], tbank.n_groups)
    )


# ---------------------------------------------------------------------------
# ops/dfa_gather.py: joint-byte-class hot-tier banks (cko_scan_gather)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("specs", [PATTERNS, PATTERNS + MID], ids=["int8", "f32"])
def test_gather_bank_matches_jax(specs):
    jd, td = _dfas(specs)
    assert [b for b in tgather.plan_gather_bins(td)] == jgather.plan_gather_bins(jd)
    jbank = jgather.stack_gather_bank(jd)
    tbank = tgather.stack_gather_bank(td, device=CPU)
    for f in ("tC", "classmap", "match_end", "always"):
        want = np.asarray(getattr(jbank, f))
        got = getattr(tbank, f).numpy()
        assert got.dtype == want.dtype, f
        np.testing.assert_array_equal(got, want, err_msg=f)

    data, lens = _batch(96, 96, seed=11)
    got = tgather.scan_gather_bank(tbank, _t(data), _t(lens)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jgather.scan_gather_bank_jnp(jbank, data, lens)))
    np.testing.assert_array_equal(got, _emulate_gather_tier(tbank.tier, [(data, lens)], (True,)))
    d16, l16 = data[:24, :40], np.minimum(lens[:24], 40)
    pallas = scan_gather_bank_pallas(
        jbank.tC, jbank.classmap, jbank.match_end.T, jbank.always,
        jnp.asarray(d16), jnp.asarray(l16),
        s=jbank.n_states, g=jbank.n_groups, c=jbank.n_classes, interpret=True,
    )
    np.testing.assert_array_equal(
        tgather.scan_gather_bank_jnp(tbank, _t(d16), _t(l16)).numpy(), np.asarray(pallas)
    )


def test_gather_matches_jax_at_b4096():
    jd, td = _dfas(PATTERNS)
    jbank = jgather.stack_gather_bank(jd)
    tbank = tgather.stack_gather_bank(td, device=CPU)
    data, lens = _batch(4096, 20, seed=9)
    got = tgather.scan_gather_bank_jnp(tbank, _t(data), _t(lens)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jgather.scan_gather_bank_jnp(jbank, data, lens)))


# Three banks over pipelines 0, 3 and 0, a fourth over pipeline 5: the
# fused tier reads three distinct inputs.
_TIER_BANKS = [(0, PATTERNS[:3]), (3, PATTERNS[3:6]), (0, PATTERNS[6:] + MID[:1]), (5, PATTERNS[:2])]


@pytest.mark.parametrize(
    "on", [(True,) * 4, (True, False, True, False), (False, True, False, True), (False,) * 4],
    ids=["all", "skip-odd", "skip-even", "none"],
)
def test_gather_tier_matches_jax_bank_by_bank(on):
    pipes = {0: _batch(64, 48, seed=21), 3: _batch(64, 48, seed=22), 5: _batch(64, 48, seed=23)}
    banks = [(pid, *_dfas(specs)) for pid, specs in _TIER_BANKS]
    tbanks = [tgather.stack_gather_bank(td, device=CPU) for _, _, td in banks]
    tier = tgather.build_gather_tier(tbanks, [pid for pid, _, _ in banks])
    assert tier.pipelines == (0, 3, 5) and tier.pipe_slot == (0, 1, 0, 2)
    assert tier.n_groups == sum(b.n_groups for b in tbanks)
    # Slots no mask-on bank reads may be None (with every bank off, the
    # inputs only give the batch shape).
    read = {s for f, s in zip(on, tier.pipe_slot) if f} or set(range(len(tier.pipelines)))
    inputs = [(_t(d), _t(ln)) if k in read else None
              for k, (d, ln) in enumerate(pipes[p] for p in tier.pipelines)]
    before = tgather.LAUNCHES
    got = tgather.scan_gather_tier(tier, inputs, on).numpy()
    assert tgather.LAUNCHES == before
    np.testing.assert_array_equal(got, tgather.scan_gather_tier_plain(tier, inputs, on).numpy())
    col = 0
    for (pid, jd, _), tb, flag in zip(banks, tbanks, on):
        piece = got[:, col : col + tb.n_groups]
        col += tb.n_groups
        if not flag:
            assert not piece.any()
            continue
        want = np.asarray(jgather.scan_gather_bank_jnp(jgather.stack_gather_bank(jd), *pipes[pid]))
        np.testing.assert_array_equal(piece, want)
    np_inputs = [None if x is None else (x[0].numpy(), x[1].numpy()) for x in inputs]
    np.testing.assert_array_equal(got, _emulate_gather_tier(tier, np_inputs, on))
    # The per-group on/off flags are built once per mask value.
    assert tier.on_groups(on) is tier.on_groups(tuple(on))


def test_gather_tier_rejects_bad_inputs():
    _, td = _dfas(PATTERNS)
    bank = tgather.stack_gather_bank(td[:3], device=CPU)
    tier = tgather.build_gather_tier([bank, bank], [0, 2])
    d, ln = (_t(a) for a in _batch(8, 16, seed=1))
    with pytest.raises(ValueError, match="inputs"):
        tgather.scan_gather_tier(tier, [(d, ln)], (True, True))
    with pytest.raises(ValueError, match="mask-on bank"):
        tgather.scan_gather_tier(tier, [(d, ln), None], (True, True))
    with pytest.raises(ValueError, match="differ"):
        tgather.scan_gather_tier(tier, [(d, ln), (d[:, :8].contiguous(), ln)], (True, True))
    with pytest.raises(ValueError, match="unsupported device"):
        tgather.scan_gather_tier(tier, [(d.to("meta"), ln.to("meta"))] * 2, (True, True))


# ---------------------------------------------------------------------------
# ops/dfa_flat.py: fused multi-bank flat-slot bins (cko_scan_flat)
# ---------------------------------------------------------------------------


def _flat_inputs(length=64):
    # Two blocks on pipeline 0 (small and mid S), one on pipeline 2 with
    # an S > 128 (f32 segment) DFA: pipelines see DIFFERENT data.
    specs = [(0, 0, PATTERNS[:5]), (1, 0, PATTERNS[5:] + MID), (2, 2, PATTERNS[:3] + WIDE)]
    jbanks = [(b, p, _dfas(s)[0]) for b, p, s in specs]
    tbanks = [(b, p, _dfas(s)[1]) for b, p, s in specs]
    d0, l0 = _batch(80, length, seed=7)
    d2, l2 = _batch(80, length, seed=99)
    return jbanks, tbanks, {0: (d0, l0), 2: (d2, l2)}


def _flat_bins(jbanks, tbanks, **kw):
    jbins, jrej = jflat.plan_flat_bins(jbanks, **kw)
    tbins, trej = tflat.plan_flat_bins(tbanks, **kw)
    strip = lambda bins: [[p[:4] for p in b] for b in bins]  # noqa: E731
    assert strip(tbins) == strip(jbins) and trej == jrej
    return jbins, tbins


def test_flat_bin_matches_jax():
    jbanks, tbanks, data = _flat_inputs()
    jbins, tbins = _flat_bins(jbanks, tbanks, max_slots=100000)
    assert len(tbins) == 1
    jfb = jflat.build_flat_bank(jbins[0])
    tfb = tflat.build_flat_bank(tbins[0], device=CPU)
    assert tfb.pipeline_ids == [0, 2]
    assert {t.dtype for t in tfb.tables} == {torch.bfloat16, torch.float32}
    for f in ("sel", "bcast", "init_sigma", "mend", "base_g", "s_g", "always"):
        np.testing.assert_array_equal(
            getattr(tfb, f).to(torch.float32).numpy(),
            np.asarray(getattr(jfb, f)).astype(np.float32), err_msg=f,
        )
    for tj, tt_ in zip(jfb.tables, tfb.tables):
        np.testing.assert_array_equal(tt_.to(torch.float32).numpy(), np.asarray(tj).astype(np.float32))
    for f in ("seg_pipes", "seg_slots", "group_pipe", "pieces"):
        assert getattr(tfb, f) == tuple(getattr(jfb, f)), f

    tdata = {p: (_t(d), _t(ln)) for p, (d, ln) in data.items()}
    got = tflat.scan_flat_bank(tfb, tdata).numpy()
    np.testing.assert_array_equal(got, np.asarray(jflat.scan_flat_xla(jfb, data)))
    dataT = np.stack([data[p][0].T for p in tfb.pipeline_ids])
    lens = np.stack([data[p][1] for p in tfb.pipeline_ids])
    np.testing.assert_array_equal(
        got,
        _emulate_kernel(tfb.kt, dataT, lens, tfb.n_groups, pipe=tfb.k_pipe.numpy(), latch_end=False),
    )
    small = {p: (d[:24, :40], np.minimum(ln[:24], 40)) for p, (d, ln) in data.items()}
    pallas = jflat.scan_flat_bank(
        jfb, {p: (jnp.asarray(d), jnp.asarray(ln)) for p, (d, ln) in small.items()}, interpret=True
    )
    np.testing.assert_array_equal(
        tflat.scan_flat_xla(tfb, {p: (_t(d), _t(ln)) for p, (d, ln) in small.items()}).numpy(),
        np.asarray(pallas),
    )


def test_flat_split_bins_match_jax():
    """A bank split across bins by group range keeps the reference's
    pieces, so match_tier stitches the same columns."""
    jbanks, tbanks, data = _flat_inputs(length=32)
    max_slots = 140  # forces splits
    jbins, tbins = _flat_bins(jbanks, tbanks, max_slots=max_slots)
    assert len(tbins) >= 2
    for jb, tb in zip(jbins, tbins):
        jfb, tfb = jflat.build_flat_bank(jb), tflat.build_flat_bank(tb, device=CPU)
        sub = {p: data[p] for p in tfb.pipeline_ids}
        got = tflat.scan_flat_bank(tfb, {p: (_t(d), _t(ln)) for p, (d, ln) in sub.items()})
        np.testing.assert_array_equal(got.numpy(), np.asarray(jflat.scan_flat_xla(jfb, sub)))


def test_flat_matches_jax_at_b4096():
    jd, td = _dfas(PATTERNS)
    jbins, tbins = _flat_bins([(0, 0, jd)], [(0, 0, td)])
    jfb, tfb = jflat.build_flat_bank(jbins[0]), tflat.build_flat_bank(tbins[0], device=CPU)
    d, ln = _batch(4096, 16, seed=4)
    got = tflat.scan_flat_xla(tfb, {0: (_t(d), _t(ln))}).numpy()
    np.testing.assert_array_equal(got, np.asarray(jflat.scan_flat_xla(jfb, {0: (d, ln)})))


# ---------------------------------------------------------------------------
# Dispatch: CPU tensors take the plain version and launch nothing.
# ---------------------------------------------------------------------------


def test_cpu_dispatch_takes_plain_version_and_counts_no_launch():
    _, td = _dfas(PATTERNS)
    data, lens = _batch(40, 32, seed=2)
    x, y = _t(data), _t(lens)
    dense = tdfa.stack_dfas(td, device=CPU)
    gather = tgather.stack_gather_bank(td, device=CPU)
    flat = tflat.build_flat_bank(tflat.plan_flat_bins([(0, 0, td)])[0][0], device=CPU)
    before = (tdfa.LAUNCHES, tgather.LAUNCHES, tflat.LAUNCHES)
    assert torch.equal(tdfa.scan_dfa_bank(dense, x, y), tdfa.scan_dfa_bank_take(dense, x, y))
    assert torch.equal(
        tgather.scan_gather_bank(gather, x, y), tgather.scan_gather_bank_jnp(gather, x, y)
    )
    assert torch.equal(
        tgather.scan_gather_tier(gather.tier, [(x, y)], (True,)), tgather.scan_gather_bank_jnp(gather, x, y)
    )
    assert torch.equal(tflat.scan_flat_bank(flat, {0: (x, y)}), tflat.scan_flat_xla(flat, {0: (x, y)}))
    assert (tdfa.LAUNCHES, tgather.LAUNCHES, tflat.LAUNCHES) == before


def test_wrappers_reject_bad_inputs():
    _, td = _dfas(PATTERNS)
    bank = tdfa.stack_dfas(td, device=CPU)
    data, lens = _batch(8, 16, seed=1)
    with pytest.raises(ValueError):
        tdfa.scan_dfa_bank(bank, _t(data).to(torch.int32), _t(lens))
    with pytest.raises(ValueError):
        tdfa.scan_dfa_bank(bank, _t(data), _t(lens[:4]))
    with pytest.raises(ValueError):
        tdfa.scan_dfa_bank(bank, _t(data)[None], _t(lens))
