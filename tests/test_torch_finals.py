"""PyTorch port parity: the conv-segment matcher's finals tier vs the JAX package.

``ops/segment_finals.py`` holds the CUDA kernel ``cko_finals_match`` that
replaces ``ops/segment_pallas.py::_finals_kernel``. On the CPU:

- ``finals_match_plain`` is held against the JAX ``finals_match`` (the
  Pallas kernel in ``interpret=True`` mode) on seeded operands over
  several channel counts, column counts and widths: the port takes the
  suffix buffer and the group descriptors, the reference the ``gj`` and
  one-hot ``sel`` that numpy builds from the same buffer and descriptors
  (positive and zero ``n_lead``, anchored groups, lengths that cut the
  window);
- ``match_segment_block`` with ``CKO_PALLAS_FINALS=1`` is held against
  the JAX block with its Pallas tier forced on and against the knob off,
  including a block whose every conv column is a finals column and one
  with none;
- ``_emulate_kernel`` replays the CUDA kernel's algorithm (suffix column
  masks, reach masks, embed words, the set-bit walk with early exit, the
  window-start tiles) in numpy over the exact operands the wrapper hands
  the kernel; with the tier on the block builds no per-group rows and
  keeps its constant operands. The kernel itself is held
  against the plain version on the card (``chip_smoke.py``,
  ``tests/test_torch_cuda.py``).

Hits are booleans, so parity is exact equality.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coraza_kubernetes_operator_tpu.compiler.re_parser import parse_regex as jparse
from coraza_kubernetes_operator_tpu.compiler.segments import plan_segments as jplan
from coraza_kubernetes_operator_tpu.ops import segment as jseg
from coraza_kubernetes_operator_tpu.ops.segment_pallas import finals_match as jfinals
from coraza_kubernetes_operator_tpu_torch.compiler.re_parser import parse_regex as tparse
from coraza_kubernetes_operator_tpu_torch.compiler.segments import plan_segments as tplan
from coraza_kubernetes_operator_tpu_torch.ops import segment as tseg
from coraza_kubernetes_operator_tpu_torch.ops import segment_chain as tchain
from coraza_kubernetes_operator_tpu_torch.ops import segment_finals as tfin

CPU = torch.device("cpu")

# Seg-first chains over shared suffixes (many finals columns), solo
# segments and gap-first branches beside them.
MIXED = [
    (r"\bunion\s+(all\s+)?select\b", True),
    (r"(select|insert|update|delete)\s+\w+", True),
    (r"<script[^>]*>", True),
    (r"(onerror|onload|onclick)\s*=", True),
    (r"(or|and)\b\s+\d+\s*=\s*\d+", True),
    (r"attack\d+\s*=\s*\d+", False),
    (r"drop\s+table", False),
    (r"eval\s*\(", False),
    (r"^/admin", False),
    (r"\.php$", False),
    (r"select\b[^;]{0,40}\bfrom", True),
]
# Every conv column is a finals column (seg-first chains whose suffix
# holds no segment).
ALL_FINALS = [
    (r"abc\s*$", True),
    (r"foo.{2,5}", False),
    (r"xyz[^;]*$", False),
    (r"abc\d{0,3}", False),
]
# No finals column (single-segment branches only).
NO_FINALS = [(r"evil\b", True), (r"abc", False), (r"^/admin", False), (r"\.php$", False)]
TOKENS = [
    b"union select ", b"union all select", b"select a from b", b"insert into", b"<script src=x>",
    b"onerror =", b"onload=", b" or 1=1", b" and 22 = 22", b"attack12 = 3", b"drop table",
    b"eval (", b"/admin", b".php", b"abc  ", b"foo123", b"xyz", b"abc42", b"evil",
]


def _rows(n, length, seed):
    rng = np.random.default_rng(seed)
    alphabet = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz0123456789 ='\"<>()/;-_.%&+,", np.uint8)
    data = alphabet[rng.integers(0, alphabet.size, size=(n, length))]
    for r in range(n):
        for _ in range(rng.integers(0, 4)):
            tok = np.frombuffer(TOKENS[rng.integers(len(TOKENS))], np.uint8)
            if tok.size < length:
                at = rng.integers(0, length - tok.size)
                data[r, at : at + tok.size] = tok
    lens = rng.integers(0, length + 1, size=n).astype(np.int32)
    lens[:4] = length
    data[np.arange(length)[None, :] >= lens[:, None]] = 0
    return data, lens


def _blocks(patterns):
    jb = jseg.build_segment_block([jplan(jparse(p, case_insensitive=ci)) for p, ci in patterns])
    tb = tseg.build_segment_block(
        [tplan(tparse(p, case_insensitive=ci)) for p, ci in patterns], device=CPU
    )
    return jb, tb


def _torch_hits(tb, data, lens):
    return tseg.match_segment_block(
        tb.kernel, tb.spec, torch.as_tensor(data), torch.as_tensor(lens), cache=tb.finals
    ).numpy()


def _descs(rng, gf, ns):
    """Group descriptors (suffix column, n_lead, n_real, a_start): zero and
    positive n_lead, anchored groups (one reachable at p = 0, one never),
    several groups per suffix column."""
    desc = np.stack(
        [rng.integers(0, ns, gf), rng.choice([0, 0, 1, 2, 3], gf), rng.integers(1, 5, gf),
         (rng.random(gf) < 0.25).astype(np.int64)], axis=1,
    )
    desc[0, 1:] = (0, 1, 0)
    desc[1 % gf, 1:] = (2, 3, 0)
    desc[2 % gf, 1:] = (1, 2, 1)  # anchored: reachable at window start 0 only
    return desc


def _operands(rng, t, length, c, w, nf, gf, density, q=None):
    """Seeded finals operands: embed [T, Lp, C], weights [W*C, Nf], suffix
    [T, Q, NS], descriptors, col_group and lengths that cut the window."""
    q = length + 2 if q is None else q
    ns = max(1, 2 * gf // 3)
    embed = (rng.random((t, q + w - 1 + 2, c)) < 0.5).astype(np.float32)
    weights = rng.choice(3, size=(w * c, nf), p=[1 - density, density / 2, density / 2]).astype(np.float32)
    suffix = (rng.random((t, q, ns)) < 0.3).astype(np.float32)
    col_group = np.concatenate([np.arange(gf), rng.integers(0, gf, size=nf - gf)])
    rng.shuffle(col_group)
    lens = rng.integers(0, length + 1, size=t).astype(np.int32)
    lens[:2] = length
    return embed, weights, suffix, _descs(rng, gf, ns), col_group, lens


def _gj_numpy(suffix, lens, desc, q):
    """gj [T, Q, Gf] from the definition: G(t, r) at r = p + n_lead."""
    t = suffix.shape[0]
    gj = np.zeros((t, q, len(desc)), dtype=bool)
    for k, (col, nl, nr, a) in enumerate(desc):
        for p in range(q):
            r = p + nl
            if r < 1 or r + nr >= q or (a and r != 1):
                continue
            gj[:, p, k] = (r + nr <= 1 + lens) & (suffix[:, r + nr, col] != 0)
    return gj


def _tables(weights, desc, col_group, w):
    return tfin.finals_tables(torch.as_tensor(weights), desc, col_group, w=w)


def _range_bits(lo, hi):
    lo, hi = max(lo, 0), min(hi, 31)
    return 0 if lo > hi else ((1 << (hi + 1)) - 1) & ~((1 << lo) - 1)


def _emulate_kernel(e, s, lens, tables, q, qt):
    """numpy replay of ``csrc/segment_finals.cu::finals_kernel`` on the
    wrapper's operands (e [T, Lp, C] u8, s [T, Q, NS] u8, lens, the
    block's tables) with window-start tile ``qt``: per row and tile the
    suffix column masks, the groups' reach masks (word shifts and valid
    ranges), the embed words, then the set-bit walk with early exit.
    Returns ([T, Nf] bool, rows whose every tile stopped before scoring)."""
    t, lp, c = e.shape
    ns = s.shape[2]
    w, nf, d_max = tables.w, tables.nf, tables.d_max
    desc, cg = tables.desc.tolist(), tables.col_group.tolist()
    kb, thr = tables.kbits.numpy().view(np.uint64), tables.thr.numpy()
    nw, qw, cw = (c + 63) // 64, qt // 32, (qt + d_max + 31) // 32
    out = np.zeros((t, nf), dtype=bool)
    unscored = []
    for r in range(t):
        q_end = min(q, max(0, int(lens[r]) + 2))
        scored = False
        for p0 in range(0, q_end, qt):
            pend = min(q_end, p0 + cw * 32)
            cm = [[0] * cw for _ in range(ns)]
            for pp in range(pend - p0):
                for col in np.flatnonzero(s[r, p0 + pp]):
                    cm[col][pp >> 5] |= 1 << (pp & 31)
            if not any(any(x) for x in cm):
                continue
            gm = [[0] * qw for _ in range(len(desc))]
            for k, (col, nl, nr, a) in enumerate(desc):
                for wd in range(qw):
                    o = wd * 32 + nl + nr
                    lo, sh = o >> 5, o & 31
                    m = 0
                    if lo < cw:
                        m = cm[col][lo] >> sh
                        if sh and lo + 1 < cw:
                            m |= (cm[col][lo + 1] << (32 - sh)) & 0xFFFFFFFF
                    pbase = p0 + wd * 32
                    gm[k][wd] = m & _range_bits(max(0, 1 - nl) - pbase, (1 - nl if a else q - 1) - pbase)
            if not any(any(x) for x in gm):
                continue
            scored = True
            ep = min(lp - p0, qt + w - 1)
            words = np.zeros((ep, nw), dtype=np.uint64)
            for ci in range(c):
                words[:, ci // 64] |= (e[r, p0 : p0 + ep, ci] != 0).astype(np.uint64) << np.uint64(ci % 64)
            for n in range(nf):
                for wd in range(qw):
                    m = gm[cg[n]][wd]
                    while m and not out[r, n]:
                        pl = wd * 32 + (m & -m).bit_length() - 1
                        m &= m - 1
                        acc, j = 0, 0
                        while j < w:
                            ew = words[pl + j]
                            acc += int(np.bitwise_count(ew & kb[n, j, :, 0]).sum())
                            acc += 2 * int(np.bitwise_count(ew & kb[n, j, :, 1]).sum())
                            if acc < thr[n, j]:
                                break
                            j += 1
                        out[r, n] = j == w
        if not scored:
            unscored.append(r)
    return out, unscored


@pytest.mark.parametrize(
    "t,length,c,w,nf,gf",
    [(8, 6, 5, 3, 7, 4), (16, 10, 36, 4, 40, 9), (8, 5, 70, 2, 12, 12), (16, 30, 41, 3, 24, 10)],
    ids=["c5", "c36", "c70", "c41"],
)
def test_plain_matches_jax_pallas_interpret(t, length, c, w, nf, gf):
    rng = np.random.default_rng(c)
    q = length + 2
    embed, weights, suffix, desc, col_group, lens = _operands(rng, t, length, c, w, nf, gf, 0.25)
    # The reference's operands from the same suffix buffer and descriptors:
    # gj [T, Q, Gf] and the one-hot sel [Gf, Nf].
    gj = _gj_numpy(suffix, lens, desc, q)
    assert gj.any() and not gj.all()
    sel = np.zeros((gf, nf), dtype=np.float32)
    sel[col_group, np.arange(nf)] = 1.0
    assert (sel.sum(axis=0) == 1).all()
    np.testing.assert_array_equal(sel.argmax(axis=0), col_group)
    want = np.asarray(
        jfinals(
            jnp.asarray(embed, jnp.bfloat16), jnp.asarray(weights, jnp.bfloat16),
            jnp.asarray(gj, jnp.bfloat16), sel, w=w, q=q, interpret=True,
        )
    )
    tables = _tables(weights, desc, col_group, w)
    args = (torch.as_tensor(embed), torch.as_tensor(suffix), torch.as_tensor(lens))
    np.testing.assert_array_equal(tfin.reach(args[1], args[2], tables, q).numpy(), gj)
    got = tfin.finals_match_plain(*args, tables, q=q).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.any() and not got.all()
    # The CPU dispatch is the plain version and counts no launch.
    before = tfin.LAUNCHES
    np.testing.assert_array_equal(
        tfin.finals_match(args[0].bool(), args[1].bool(), args[2], tables, q=q).numpy(), want
    )
    assert tfin.LAUNCHES == before


@pytest.mark.parametrize(
    "c,length", [(36, 64), (70, 64), (36, 598)], ids=["one-word", "two-words", "two-tiles"]
)
def test_kernel_emulation_matches_plain(c, length):
    """The kernel's algorithm at Q = 66 (one tile) and Q = 600 (two tiles
    of 512), with rows whose suffix bytes are all zero."""
    rng = np.random.default_rng(100 + c + length)
    t, w, nf, gf = 12, 5, 33, 6
    q = length + 2
    embed, weights, suffix, desc, col_group, lens = _operands(rng, t, length, c, w, nf, gf, 2.0 / c)
    suffix[2:4] = 0  # rows with no reachable group
    tables = _tables(weights, desc, col_group, w)
    assert tables.d_max == int((desc[:, 1] + desc[:, 2]).max())
    # The kernel reads the tables' memory as laid out row-major.
    assert all(x.is_contiguous() for x in (tables.kbits, tables.thr, tables.desc, tables.col_group))
    args = (torch.as_tensor(embed), torch.as_tensor(suffix), torch.as_tensor(lens))
    want = tfin.finals_match_plain(*args, tables, q=q).numpy()
    qt = tfin.q_tile(q, tables, suffix.shape[2])
    assert qt == (96 if q <= 96 else tfin.Q_TILE_MAX) and (q > qt) == (length > 500)
    e, s = tfin._bytes(args[0]), tfin._bytes(args[1])
    got, unscored = _emulate_kernel(e.numpy(), s.numpy(), lens, tables, q, qt)
    np.testing.assert_array_equal(got, want)
    assert got.any() and not got.all()
    assert {2, 3} <= set(unscored)
    # A smaller tile gives the same bits (tiles cut the window starts only).
    np.testing.assert_array_equal(_emulate_kernel(e.numpy(), s.numpy(), lens, tables, q, 32)[0], want)


def test_kernel_emulation_on_a_block(monkeypatch):
    """The operands ``match_segment_block`` builds for a real block, run
    through the kernel's algorithm, give the conv path's finals columns."""
    _, tb = _blocks(MIXED)
    data, lens = _rows(24, 48, seed=4)
    embed, suffix, lengths, tables, q = tseg.finals_inputs(
        tb.kernel, tb.spec, torch.as_tensor(data), torch.as_tensor(lens), cache=tb.finals
    )
    w = tb.spec.w
    assert embed.dtype == torch.bool and tuple(embed.shape) == (24, 1 + 48 + w, len(tb.spec.channels))
    assert suffix.dtype == torch.bool and tuple(suffix.shape[:2]) == (24, q)
    assert tables.nf == tseg.finals_cols(tb.spec) and tables.gf <= tables.nf
    assert tables.weights.shape == (w * len(tb.spec.channels), tables.nf)
    want = tfin.finals_match_plain(embed, suffix, lengths, tables, q=q).numpy()
    got, _ = _emulate_kernel(
        tfin._bytes(embed).numpy(), tfin._bytes(suffix).numpy(), lengths.numpy(), tables, q,
        tfin.q_tile(q, tables, suffix.shape[2]),
    )
    np.testing.assert_array_equal(got, want)
    assert want.any()


def test_tier_on_builds_no_group_rows_and_caches_tables(monkeypatch):
    """With the tier on the block's path never calls ``group_reach`` (no
    per-group rows, no [T, Q, Gf] stack): the kernel's operands are the
    suffix buffer and the block's cached tables, built once."""
    _, tb = _blocks(MIXED)
    data, lens = _rows(16, 40, seed=9)
    d, ln = torch.as_tensor(data), torch.as_tensor(lens)
    monkeypatch.delenv("CKO_PALLAS_FINALS", raising=False)
    off = tseg.match_segment_block(tb.kernel, tb.spec, d, ln, cache=tb.finals).numpy()
    assert not tb.finals
    monkeypatch.setenv("CKO_PALLAS_FINALS", "1")
    # The chain (ops/segment_chain.py) is where the tier-off path builds group rows.
    monkeypatch.setattr(tchain, "group_reach", lambda *a: pytest.fail("group rows built with the tier on"))
    built, seen = [], []
    real_tables, real_match = tseg.finals_tables, tseg.finals_match
    monkeypatch.setattr(tseg, "finals_tables", lambda *a, **k: built.append(1) or real_tables(*a, **k))
    monkeypatch.setattr(tseg, "finals_match", lambda *a, **k: seen.append(a) or real_match(*a, **k))
    for _ in range(2):
        on = tseg.match_segment_block(tb.kernel, tb.spec, d, ln, cache=tb.finals).numpy()
        np.testing.assert_array_equal(on, off)
    assert len(built) == 1 and list(tb.finals) == [CPU]
    assert seen[0][3] is seen[1][3] is tb.finals[CPU]
    suffix = seen[0][1]
    assert suffix.shape[2] == int(tb.finals[CPU].desc_np[:, 0].max()) + 1 < tb.finals[CPU].gf


@pytest.mark.parametrize("patterns", [MIXED, ALL_FINALS, NO_FINALS], ids=["mixed", "all-finals", "no-finals"])
def test_block_with_knob_on_matches_jax_and_knob_off(monkeypatch, patterns):
    jb, tb = _blocks(patterns)
    n_finals = tseg.finals_cols(tb.spec)
    if patterns is ALL_FINALS:
        assert n_finals == tseg.conv_n2_cols(tb.spec) > 0
    if patterns is NO_FINALS:
        assert n_finals == 0
    data, lens = _rows(32, 40, seed=len(patterns))
    monkeypatch.delenv("CKO_PALLAS_FINALS", raising=False)
    off = _torch_hits(tb, data, lens)
    monkeypatch.setenv("CKO_PALLAS_FINALS", "1")
    calls = []
    real = tseg.finals_match
    monkeypatch.setattr(tseg, "finals_match", lambda *a, **k: calls.append(1) or real(*a, **k))
    on = _torch_hits(tb, data, lens)
    assert len(calls) == (1 if n_finals else 0)
    np.testing.assert_array_equal(on, off)
    assert on.any() and not on.all()
    # The reference block with its Pallas tier forced on (interpret mode).
    monkeypatch.setattr(jseg, "_use_pallas_finals", lambda *a: True)
    jax.clear_caches()
    try:
        fn = jax.jit(jseg.match_segment_block, static_argnums=(1,))
        want = np.asarray(fn(jb.kernel, jb.spec, jnp.asarray(data), jnp.asarray(lens)))
    finally:
        jax.clear_caches()
    np.testing.assert_array_equal(on, want)
    assert (tseg.finals_inputs(tb.kernel, tb.spec, torch.as_tensor(data), torch.as_tensor(lens),
                               cache=tb.finals) is None) == (
        n_finals == 0
    )


def test_wrapper_rejects_bad_operands():
    rng = np.random.default_rng(0)
    embed, weights, suffix, desc, cg, lens = _operands(rng, 4, 6, 6, 3, 5, 3, 0.3)
    tables = _tables(weights, desc, cg, 3)
    e, s, ln = (torch.as_tensor(a) for a in (embed, suffix, lens))
    with pytest.raises(ValueError, match="W = 3"):
        _tables(weights[:-1], desc, cg, 3)
    with pytest.raises(ValueError, match="channels"):
        tfin.finals_match(e[:, :, :-1], s, ln, tables, q=8)
    with pytest.raises(ValueError, match="Q \\+ W - 1"):
        tfin.finals_match(e[:, :8], s[:, :7], ln, tables, q=7)
    with pytest.raises(ValueError, match="outside"):
        _tables(weights, desc, np.full(5, 3), 3)
    with pytest.raises(ValueError, match="suffix column"):
        tfin.finals_match(e, s[:, :, :1], ln, _tables(weights, np.maximum(desc, [1, 0, 0, 0]), cg, 3), q=8)
    with pytest.raises(ValueError, match="unsupported device"):
        tfin.finals_match(e.to("meta"), s.to("meta"), ln.to("meta"), tables, q=8)
