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

The CUDA kernels cannot run here; ``_emulate_tier`` (the dense and
gather tiers, one body) and ``_emulate_flat`` replay their launches in
numpy over exactly the arguments the wrappers pass them (the int16 tables,
per-record and per-group records, pipeline slots and the launch split by
pipeline), so the kernel-side layout is checked on the CPU too, including
a tier over ten pipelines that takes two launches. The fused tiers' plain
versions are held bank by bank against the JAX package on several banks
over distinct pipelines, under kind masks that skip some. The kernels
themselves are held against the plain versions on the card by
``chip_smoke.py`` and ``tests/test_torch_cuda.py``.
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


def _launch_pipes(launches, n_slots):
    """Each launch reads at most MAX_PIPES consecutive input slots, and
    every slot is read by exactly one launch."""
    bases = [base for base, _ in launches]
    assert bases == list(range(0, n_slots, tdfa.MAX_PIPES))
    for _base, recs in launches:
        assert recs.dtype == torch.int32 and recs.is_contiguous()


def _emulate_tier(tier, inputs, on):
    """numpy replay of ``csrc/dfa_scan.cu::tier_walk`` (``dense_tier_kernel``,
    or ``gather_tier_kernel`` when the tier has class maps) over the tier's
    launches: per launch its MAX_PIPES input slots and its records (first
    group, groups, table offset, elements, launch-local slot, bank); per
    record its slot's bytes (through the bank's class map for gather), then
    per group a walk of its [R, S] table slice named by the record and
    ``grp_info``, the end state latched at len - 1; records whose groups are
    all off give zeros. inputs are numpy (data [B, L], lens [B]) per slot;
    returns [B, G] bool."""
    for t in (tier.tab, tier.grp_info, tier.mend, tier.always):
        assert t.is_contiguous()  # the kernel reads them as flat arrays
    _launch_pipes(tier.launches, len(tier.pipelines))
    tab = tier.tab.numpy().astype(np.int64)
    on_g = tier.on_groups(tuple(on)).numpy().astype(bool)
    mend, always = tier.mend.numpy().astype(bool), tier.always.numpy().astype(bool)
    cmaps = getattr(tier, "cmaps", None)
    b = next(x for x in inputs if x is not None)[0].shape[0]
    out = np.full((b, tier.n_groups), 7, dtype=np.int64)  # unwritten columns show
    for base, recs in tier.launches:
        pipes = inputs[base : base + tdfa.MAX_PIPES]
        for g0, ng, toff, telems, slot, bank in recs.tolist():
            assert toff % 8 == 0  # 16-byte aligned for the kernel's copies
            if not on_g[g0 : g0 + ng].any():
                out[:, g0 : g0 + ng] = 0
                continue
            data, lens = pipes[slot]
            length = data.shape[1]
            sym = data.astype(np.int64) if cmaps is None else cmaps.numpy()[bank][data].astype(np.int64)
            n = np.minimum(lens, length)
            for g in range(g0, g0 + ng):
                off, s, moff = tier.grp_info[g].tolist()
                rows = telems // (ng * s)
                table = tab[toff + off : toff + off + rows * s].reshape(rows, s)
                state = np.zeros(b, dtype=np.int64)
                matched = np.zeros(b, dtype=bool)
                for t in range(length):
                    v = table[sym[:, t], state]
                    hit = v >= s
                    active = t < n
                    matched |= hit & active
                    state = np.where(active, v - s * hit, state)
                end_state = np.where(lens > length, 0, state)
                out[:, g] = (matched | mend[moff + end_state] | always[g]) if on_g[g] else 0
    assert ((out == 0) | (out == 1)).all()
    return out.astype(bool)


def _emulate_flat(flat, data_by_pipe):
    """numpy replay of ``csrc/dfa_scan.cu::flat_kernel`` over the bin's
    launches: per launch its MAX_PIPES pipelines and its records (group,
    launch-local slot); per group a walk of its own [256, S_g] table over
    its pipeline's bytes, the end check on the state after the last step.
    data_by_pipe is numpy; returns [B, G] bool."""
    lay = flat.layout
    for t in (lay.tab, lay.grp_info, lay.mend, lay.always):
        assert t.is_contiguous()
    _launch_pipes(lay.launches, len(flat.pipeline_ids))
    tab = lay.tab.numpy().astype(np.int64)
    mend, always = lay.mend.numpy().astype(bool), lay.always.numpy().astype(bool)
    inputs = [data_by_pipe[p] for p in flat.pipeline_ids]
    b = inputs[0][0].shape[0]
    out = np.full((b, flat.n_groups), 7, dtype=np.int64)
    for base, recs in lay.launches:
        for g, slot in recs.tolist():
            data, lens = inputs[base + slot]
            off, s, moff = lay.grp_info[g].tolist()
            assert off % 8 == 0
            table = tab[off : off + 256 * s].reshape(256, s)
            length = data.shape[1]
            n = np.minimum(lens, length)
            state = np.zeros(b, dtype=np.int64)
            matched = np.zeros(b, dtype=bool)
            for t in range(length):
                v = table[data[:, t].astype(np.int64), state]
                hit = v >= s
                active = t < n
                matched |= hit & active
                state = np.where(active, v - s * hit, state)
            out[:, g] = matched | mend[moff + state] | always[g]
    assert ((out == 0) | (out == 1)).all()
    return out.astype(bool)


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
        with pytest.raises(ValueError, match="no dense table"):
            tbank.tier
        return
    np.testing.assert_array_equal(got, np.asarray(jdfa.scan_dfa_bank_take(jbank, data, lens)))
    np.testing.assert_array_equal(got, _emulate_tier(tbank.tier, [(data, lens)], (True,)))
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
    np.testing.assert_array_equal(got, _emulate_tier(tbank.tier, [(data, lens)], (True,)))


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
    np.testing.assert_array_equal(got, _emulate_tier(tbank.tier, [(data, lens)], (True,)))
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


# ---------------------------------------------------------------------------
# Fused tiers (cko_scan_dense over prefilter banks, cko_scan_gather over
# dfa-hot banks): one device body, one layout, one launcher.
# ---------------------------------------------------------------------------

# Three banks over pipelines 0, 3 and 0, a fourth over pipeline 5: the
# fused tier reads three distinct inputs. Prefilter-shaped: 1-4 groups of a
# few to ~80 states each.
_TIER_BANKS = [(0, PATTERNS[:3]), (3, PATTERNS[3:6]), (0, PATTERNS[6:] + MID[:1]), (5, PATTERNS[:2])]
_TIER = {
    # kind: (stack a bank, build a tier, fused scan, plain tier, module, JAX bank scan)
    "dense": (tdfa.stack_dfas, tdfa.build_dense_tier, tdfa.scan_dense_tier,
              tdfa.scan_dense_tier_plain, tdfa,
              lambda jd, d, ln: jdfa.scan_dfa_bank_take(jdfa.stack_dfas(jd), d, ln)),
    "gather": (tgather.stack_gather_bank, tgather.build_gather_tier, tgather.scan_gather_tier,
               tgather.scan_gather_tier_plain, tgather,
               lambda jd, d, ln: jgather.scan_gather_bank_jnp(jgather.stack_gather_bank(jd), d, ln)),
}


def _tier_inputs(tier, pipes, on):
    """Per slot (data, lens) tensors; slots no mask-on bank reads are None
    (with every bank off, the inputs only give the batch shape)."""
    read = {s for f, s in zip(on, tier.pipe_slot) if f} or set(range(len(tier.pipelines)))
    return [(_t(d), _t(ln)) if k in read else None
            for k, (d, ln) in enumerate(pipes[p] for p in tier.pipelines)]


def _np_inputs(inputs):
    return [None if x is None else (x[0].numpy(), x[1].numpy()) for x in inputs]


@pytest.mark.parametrize("kind", ["dense", "gather"])
@pytest.mark.parametrize(
    "on", [(True,) * 4, (True, False, True, False), (False, True, False, True), (False,) * 4],
    ids=["all", "skip-odd", "skip-even", "none"],
)
def test_tier_matches_jax_bank_by_bank(kind, on):
    stack, build, scan, plain, mod, jax_scan = _TIER[kind]
    pipes = {0: _batch(64, 48, seed=21), 3: _batch(64, 48, seed=22), 5: _batch(64, 48, seed=23)}
    banks = [(pid, *_dfas(specs)) for pid, specs in _TIER_BANKS]
    tbanks = [stack(td, device=CPU) for _, _, td in banks]
    tier = build(tbanks, [pid for pid, _, _ in banks])
    assert tier.pipelines == (0, 3, 5) and tier.pipe_slot == (0, 1, 0, 2)
    assert tier.n_groups == sum(b.n_groups for b in tbanks)
    assert len(tier.launches) == 1
    inputs = _tier_inputs(tier, pipes, on)
    before = mod.LAUNCHES
    got = scan(tier, inputs, on).numpy()
    assert mod.LAUNCHES == before
    np.testing.assert_array_equal(got, plain(tier, inputs, on).numpy())
    col = 0
    for (pid, jd, _), tb, flag in zip(banks, tbanks, on):
        piece = got[:, col : col + tb.n_groups]
        col += tb.n_groups
        if not flag:
            assert not piece.any()
            continue
        np.testing.assert_array_equal(piece, np.asarray(jax_scan(jd, *pipes[pid])))
        if kind == "dense":
            # The exact program the TPU runs, through the Pallas interpreter.
            jbank = jdfa.stack_dfas(jd)
            d16, l16 = pipes[pid][0][:24, :40], np.minimum(pipes[pid][1][:24], 40)
            pallas = scan_dfa_bank_pallas(
                jbank.t256, jbank.match_end.T, jbank.always, jnp.asarray(d16), jnp.asarray(l16),
                s=jbank.n_states, g=jbank.n_groups, interpret=True,
            )
            np.testing.assert_array_equal(
                tdfa.scan_dfa_bank_take(tb, _t(d16), _t(l16)).numpy(), np.asarray(pallas)
            )
    np.testing.assert_array_equal(got, _emulate_tier(tier, _np_inputs(inputs), on))
    # The per-group on/off flags are built once per mask value.
    assert tier.on_groups(on) is tier.on_groups(tuple(on))


@pytest.mark.parametrize("kind", ["dense", "gather"])
@pytest.mark.parametrize("on", [(True,) * 10, (False, True) * 5], ids=["all", "skip-even"])
def test_tier_over_ten_pipelines_splits_into_two_launches(kind, on):
    """A tier whose banks read ten pipelines runs as two launches (slots
    0-7 and 8-9), each writing its own columns of the one output; nothing
    raises. Banks of pipelines 2 and 9 share bank order with the others."""
    stack, build, scan, plain, mod, jax_scan = _TIER[kind]
    pids = [9, 0, 1, 2, 3, 4, 5, 6, 7, 8]
    specs = [PATTERNS[i % 8 : i % 8 + 2] for i in range(10)]
    pipes = {pid: _batch(40, 24, seed=60 + pid) for pid in pids}
    banks = [(pid, *_dfas(sp)) for pid, sp in zip(pids, specs)]
    tier = build([stack(td, device=CPU) for _, _, td in banks], pids)
    assert len(tier.pipelines) == 10 and len(tier.launches) == 2
    assert [int(r.shape[0]) for _base, r in tier.launches] == [8, 2]
    inputs = _tier_inputs(tier, pipes, on)
    before = mod.LAUNCHES
    got = scan(tier, inputs, on).numpy()
    assert mod.LAUNCHES == before
    np.testing.assert_array_equal(got, plain(tier, inputs, on).numpy())
    np.testing.assert_array_equal(got, _emulate_tier(tier, _np_inputs(inputs), on))
    col = 0
    for (pid, jd, td), flag in zip(banks, on):
        piece = got[:, col : col + len(td)]
        col += len(td)
        want = np.asarray(jax_scan(jd, *pipes[pid])) if flag else np.zeros_like(piece)
        np.testing.assert_array_equal(piece, want)


def test_tier_splits_large_banks_into_records():
    """A bank of more than REC_GROUPS groups is walked as several records
    (one block column each); columns and results do not change."""
    _, td = _dfas(PATTERNS)
    many = (td * 9)[: tdfa.REC_GROUPS + 5]
    bank = tdfa.stack_dfas(many, device=CPU)
    tier = bank.tier
    assert [r[:2] for r in tier.launches[0][1].tolist()] == [[0, tdfa.REC_GROUPS], [tdfa.REC_GROUPS, 5]]
    assert tier.max_groups == tdfa.REC_GROUPS
    data, lens = _batch(24, 20, seed=8)
    got = tdfa.scan_dense_tier(tier, [(_t(data), _t(lens))], (True,)).numpy()
    np.testing.assert_array_equal(got, tdfa.scan_dfa_bank_take(bank, _t(data), _t(lens)).numpy())
    np.testing.assert_array_equal(got, _emulate_tier(tier, [(data, lens)], (True,)))


def test_pipe_structs_hold_each_launchs_pipelines():
    """The by-value pipeline structs of a launch split: slot k of launch j
    holds input 8j + k's bases; int64 lengths get an int32 copy that the
    returned tensors keep alive; int32 lengths are passed as they are."""
    ins = [(_t(d), _t(ln)) for d, ln in (_batch(8, 16, seed=s) for s in range(10))]
    ins[3] = None
    ins[9] = (ins[9][0], ins[9][1].to(torch.int64))
    structs, keep = tdfa.pipe_structs(ins)
    assert len(structs) == 2 and len(keep) == 9
    for k, x in enumerate(ins):
        st = structs[k // tdfa.MAX_PIPES]
        if x is None:
            assert st.data[k % 8] is None and st.lens[k % 8] is None
            continue
        assert st.data[k % 8] == x[0].data_ptr()
        if x[1].dtype == torch.int32:
            assert st.lens[k % 8] == x[1].data_ptr()
    converted = keep[-1][1]
    assert converted.dtype == torch.int32 and structs[1].lens[1] == converted.data_ptr()
    assert torch.equal(converted, ins[9][1].to(torch.int32))


def test_flat_launch_shape_serves_each_table_to_many_rows():
    """Rows per thread: the largest of 4, 2, 1 that still gives each of
    132 SMs a block (crs-lite's bin: 11 groups); the row tile stays within
    its budget and the staged table is the largest that fits beside it."""
    _, td = _dfas(PATTERNS + MID)
    flat = tflat.build_flat_bank(tflat.plan_flat_bins([(0, 0, td * 2)], max_slots=100000)[0][0], device=CPU)
    lay = flat.layout
    assert flat.n_groups == 2 * len(td)
    # 20 groups: 12288 rows give 12 tiles of 1024 rows (240 blocks).
    rpt, cols, tab, smem = tflat.flat_launch_shape(lay, 12288, 64, 132)
    assert (rpt, cols, tab) == (4, 64, max(lay.tab_bytes))
    assert smem == tab + 1024 * 68 + 16 <= tdfa.SMEM_CAP
    assert tflat.flat_launch_shape(lay, 1024, 2048, 132)[:2] == (1, 256)
    assert tflat.flat_launch_shape(lay, 777, 40, 132)[:2] == (1, 48)


@pytest.mark.parametrize("kind", ["dense", "gather"])
def test_tier_rejects_bad_inputs(kind):
    stack, build, scan, _plain, _mod, _jax = _TIER[kind]
    _, td = _dfas(PATTERNS)
    bank = stack(td[:3], device=CPU)
    tier = build([bank, bank], [0, 2])
    d, ln = (_t(a) for a in _batch(8, 16, seed=1))
    with pytest.raises(ValueError, match="inputs"):
        scan(tier, [(d, ln)], (True, True))
    with pytest.raises(ValueError, match="mask-on bank"):
        scan(tier, [(d, ln), None], (True, True))
    with pytest.raises(ValueError, match="differ"):
        scan(tier, [(d, ln), (d[:, :8].contiguous(), ln)], (True, True))
    with pytest.raises(ValueError, match="unsupported device"):
        scan(tier, [(d.to("meta"), ln.to("meta"))] * 2, (True, True))


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
    np.testing.assert_array_equal(got, _emulate_flat(tfb, data))
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


def test_flat_bin_over_nine_pipelines_splits_into_two_launches():
    """A bin whose groups read nine pipelines runs as two launches (slots
    0-7 and 8), each writing its own group columns."""
    specs = [(b, b, PATTERNS[b % 8 : b % 8 + 2]) for b in range(9)]
    jbanks = [(b, p, _dfas(s)[0]) for b, p, s in specs]
    tbanks = [(b, p, _dfas(s)[1]) for b, p, s in specs]
    jbins, tbins = _flat_bins(jbanks, tbanks, max_slots=100000, length_hint=16)
    assert len(tbins) == 1
    jfb, tfb = jflat.build_flat_bank(jbins[0]), tflat.build_flat_bank(tbins[0], device=CPU)
    assert len(tfb.pipeline_ids) == 9 and len(tfb.layout.launches) == 2
    data = {p: _batch(40, 24, seed=80 + p) for p in tfb.pipeline_ids}
    got = tflat.scan_flat_bank(tfb, {p: (_t(d), _t(ln)) for p, (d, ln) in data.items()}).numpy()
    np.testing.assert_array_equal(got, np.asarray(jflat.scan_flat_xla(jfb, data)))
    np.testing.assert_array_equal(got, _emulate_flat(tfb, data))


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
    assert torch.equal(
        tdfa.scan_dense_tier(dense.tier, [(x, y)], (True,)), tdfa.scan_dfa_bank_take(dense, x, y)
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
