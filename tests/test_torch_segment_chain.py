"""The conv-segment chain kernel's arithmetic, on the CPU.

``cko_chain_match`` (``csrc/segment_chain.cu``) runs only on the card.
Here ``_Emulation`` replays its walk over the block's packed tables op for
op — the item layout (``ucum``), 64-bit words, word shifts, the log passes
and bit scans of ``gapany``, the sequential class walks of ``gapcls`` with
their run counter, the packed suffix words and the finals kernel's reach
words — and is held bit for bit against ``chain_match_plain``; the hit
columns, mapped to groups, are held against the JAX package's
``match_segment_block`` (jitted, CPU). On crs-lite's eight segment blocks
on the block of hand-picked regex shapes and on a block of hand-made
plans (every gap kind in both directions, lo > 0, both anchors), at Q = 66
here and at Q = 130 and Q > 514 in ``..._q130.py`` and ``..._q600.py``,
with the finals tier off and on; the rows include length 0, full length
and non-zero bytes past a row's length.
The program tables are built deterministically, and a second call of the
matcher builds nothing on the device.

The JAX executables compiled here are not written to the persistent
compilation cache, and their row counts are this file's own, so no cache
entry is read back either (jaxlib's executable serialization crashes on
some large XLA:CPU programs; ``tests/conftest.py`` forks around writes).
"""

import jax
import numpy as np
import pytest
import torch
from jax._src import config as jax_config

from coraza_kubernetes_operator_tpu_torch.ops import segment as tseg
from coraza_kubernetes_operator_tpu_torch.ops import segment_chain as tchain
from coraza_kubernetes_operator_tpu_torch.ops import segment_finals as tfin
from test_torch_segment import PATTERNS, _blocks, _jax_hits, crs_lite_blocks  # noqa: F401
from test_torch_segment import _rows as _token_rows

U64 = np.uint64
ALL = U64(0xFFFFFFFFFFFFFFFF)
NONE = -(1 << 29)  # the kernel's kNone
UNBOUNDED = (1 << 29) - 1  # its kUnbounded
# Q = L + 2: two words (this file), three (``..._q130.py``), and past the
# NCE matmul bound (``..._q600.py``); one file each, so that test workers
# can take them side by side.
LENGTH = 64


def _rows(n, length, seed):
    """Token rows with a row of length 0, rows of full length, and rows
    whose bytes past their length are not zero."""
    data, lens = _token_rows(n, length, seed)
    rng = np.random.default_rng(seed + 1)
    # Bytes outside the usual classes (line breaks, high bytes) cut class gaps.
    breaks = np.frombuffer(b"\n\r\t\x00\xff\xc3", np.uint8)
    at = rng.random(data.shape) < 0.03
    data[at] = breaks[rng.integers(0, breaks.size, size=int(at.sum()))]
    data[np.arange(length)[None, :] >= lens[:, None]] = 0
    lens[0] = 0
    for r in range(4, min(n, 10)):
        lens[r] = rng.integers(0, length)
        tail = np.frombuffer(b"select from <script> aaaab x99y go stop ;/*", np.uint8)
        data[r, lens[r] :] = tail[rng.integers(0, tail.size, size=length - lens[r])]
    return data, lens


def _range_word(w, lo, hi):
    """Bits b of word w with lo <= 64 w + b <= hi, per item."""
    b0 = np.maximum(np.asarray(lo, dtype=np.int64) - 64 * w, 0)
    b1 = np.minimum(np.asarray(hi, dtype=np.int64) - 64 * w, 63)
    m = (ALL >> (U64(63) - np.clip(b1, 0, 63).astype(U64))) & (ALL << np.clip(b0, 0, 63).astype(U64))
    return np.where(b0 <= b1, m, U64(0))


class _Emulation:
    """numpy replay of ``cko_chain_match`` on one block's operands."""

    def __init__(self, out, data, lens, tables, off, tier):
        self.h = tables.host
        self.t, self.l = data.shape
        self.q = self.l + 2
        self.nw = (self.q + 63) // 64
        self.off, self.tier = off, tier
        bits = np.zeros(out.shape[:2] + (self.nw * 64,), dtype=bool)
        bits[:, :, : self.q] = out >= 2 * tables.w
        self.mw = np.packbits(bits.reshape(*out.shape[:2], self.nw, 64), axis=-1,
                              bitorder="little").view("<u8")[..., 0]  # [T, ncol, nw]
        self.dpad = np.zeros((self.t, self.q), dtype=np.int64)
        self.dpad[:, 1 : self.l + 1] = data
        self.len1 = lens.astype(np.int64) + 1
        self.nbc, self.nf, self.ns = tables.n_bucket_cols, tables.nf, tables.ns

    # -- words ---------------------------------------------------------------
    def get(self, e, i):
        return e[:, i] if 0 <= i < self.nw else np.zeros(e.shape[0], dtype=U64)

    def conv_word(self, rows, cols, k):
        if k < 0:
            return np.zeros(rows.shape, dtype=U64)
        return self.mw[rows, cols - self.off, k]

    def shift_up(self, e, k, keep=False):
        if k <= 0:
            return
        ws, bs = k >> 6, U64(k & 63)
        for w in range(self.nw - 1, -1, -1):
            hi, lo = self.get(e, w - ws), self.get(e, w - ws - 1)
            s = (hi << bs) | (lo >> (U64(64) - bs)) if bs else hi
            e[:, w] = e[:, w] | s if keep else s
        e[:, -1] &= _range_word(self.nw - 1, 0, self.q - 1)

    def shift_down(self, e, k, keep=False):
        if k <= 0:
            return
        ws, bs = k >> 6, U64(k & 63)
        for w in range(self.nw):
            lo, hi = self.get(e, w + ws), self.get(e, w + ws + 1)
            s = (lo >> bs) | (hi << (U64(64) - bs)) if bs else lo
            e[:, w] = e[:, w] | s if keep else s

    def fill(self, n, lo, hi):
        hi = np.minimum(hi, self.q - 1)
        return np.stack([_range_word(w, np.broadcast_to(lo, n), np.broadcast_to(hi, n))
                         for w in range(self.nw)], axis=1)

    # -- ops -----------------------------------------------------------------
    def seg(self, e, rows, nl, nr, cols, up, len1):
        if not up:
            self.shift_down(e, nr)
        ws, bs = nl >> 6, U64(nl & 63)
        for w in range(self.nw):
            x = e[:, w] & _range_word(w, 1, len1 - nr)
            hi = self.conv_word(rows, cols, w - ws)
            lo = self.conv_word(rows, cols, w - ws - 1) if bs else U64(0)
            e[:, w] = x & ((hi << bs) | (lo >> (U64(64) - bs)) if bs else hi)
        if up:
            self.shift_up(e, nr)

    def spread(self, e, lo, hi, up):
        if hi < 0:  # the first (up) or last (down) set position
            n = e.shape[0]
            at = np.full(n, NONE, dtype=np.int64)
            for w in range(self.nw):
                x = e[:, w]
                nz = x != 0
                low = np.array([(int(v) & -int(v)).bit_length() - 1 for v in x], dtype=np.int64)
                high = np.array([int(v).bit_length() - 1 for v in x], dtype=np.int64)
                if up:
                    at = np.where(nz & (at == NONE), 64 * w + low, at)
                else:
                    at = np.where(nz, 64 * w + high, at)
            lo_p, hi_p = (at + lo, np.full(n, self.q - 1)) if up else (np.zeros(n), at - lo)
            e[:] = np.where((at != NONE)[:, None], self.fill(n, lo_p, hi_p), e)
            return
        width, span = hi - lo + 1, 1
        shift = self.shift_up if up else self.shift_down
        while span * 2 <= width:
            shift(e, span, True)
            span *= 2
        if span < width:
            shift(e, width - span, True)
        shift(e, lo)

    def walk(self, e, lo, hi, mask, up, rows):
        b = self.dpad[rows]  # [n, Q]
        in_c = (mask[b >> 6] >> (b & 63).astype(U64)) & U64(1) != 0
        hmax = UNBOUNDED if hi < 0 else hi
        n = e.shape[0]
        near, run = np.full(n, NONE, dtype=np.int64), np.zeros(n, dtype=np.int64)
        (self.shift_up if up else self.shift_down)(e, lo)
        for w in (range(self.nw) if up else range(self.nw - 1, -1, -1)):
            x, o = e[:, w].copy(), np.zeros(n, dtype=U64)
            bend = min(64, self.q - 64 * w)
            for bit in (range(bend) if up else range(bend - 1, -1, -1)):
                p = 64 * w + bit
                if up and p > 0:
                    run = np.where(in_c[:, p - 1], run + 1, 0)
                if not up:
                    run = np.where(in_c[:, p], run + 1, 0)
                near = np.where((x >> U64(bit)) & U64(1) != 0, p, near)
                d = lo + p - near if up else lo + near - p
                o |= ((near != NONE) & (d <= hmax) & (d <= run)).astype(U64) << U64(bit)
            e[:, w] = o

    # -- the two kernels -------------------------------------------------------
    def run(self):
        h, t = self.h, self.t
        ldo = self.nbc if self.tier else self.nbc + self.nf
        bh = np.zeros((t, ldo), dtype=bool)
        sfx = np.zeros((t, self.q, self.ns), dtype=bool)
        packed = np.zeros((t, self.ns, self.nw), dtype=U64)
        # Items unit by unit, rows then members: the kernel's search of ucum.
        g = np.arange(t * int(h["ucum"][-1]))
        unit_of = np.searchsorted(t * h["ucum"].astype(np.int64), g, side="right") - 1
        for u, (kind, a_start, a_end, nb, op0, n_ops, oc, sc) in enumerate(h["units"].tolist()):
            local = g[unit_of == u] - t * int(h["ucum"][u])
            rows, j = local // nb, local % nb
            len1 = self.len1[rows]
            n = rows.size
            if kind == tchain.K_SINGLE:
                _, nl, nr, a0 = h["ops"][op0].tolist()
                jlo, jhi = 1 - nl + 0 * len1, len1 - nr - nl
                if a_start:
                    jhi = np.minimum(jhi, 1 - nl)
                if a_end:
                    jlo = np.maximum(jlo, len1 - nr - nl)
                jhi = np.minimum(jhi, self.q - 1)
                hit = np.zeros(n, dtype=bool)
                for w in range(self.nw):
                    hit |= (self.conv_word(rows, a0 + j, w) & _range_word(w, jlo, jhi)) != 0
                bh[rows, oc + j] = hit
                continue
            up = kind == tchain.K_BUCKET
            e = self.fill(n, 1, 1 if a_start else self.q - 1) if up else \
                self.fill(n, len1 if a_end else 0, len1)
            order = range(n_ops) if up else range(n_ops - 1, -1, -1)
            for k in order:
                typ, p1, p2, p3 = h["ops"][op0 + k].tolist()
                if typ == tchain.OP_SEG:
                    self.seg(e, rows, p1, p2, p3 + j, up, len1)
                elif typ == tchain.OP_GAPANY:
                    self.spread(e, p1, p2, up)
                else:
                    self.walk(e, p1, p2, h["cls"][p3], up, rows)
            if up:
                lo = len1 if a_end else np.zeros(n, dtype=np.int64)
                bh[rows, oc + j] = np.any([e[:, w] & _range_word(w, lo, len1) for w in range(self.nw)],
                                          axis=0).astype(bool) if self.nw else False
                continue
            packed[rows, sc + j] = e
            bits = np.unpackbits(e.view(np.uint8).reshape(n, -1), axis=1, bitorder="little")
            sfx[rows, :, sc + j] = bits[:, : self.q].astype(bool)
        if not self.tier:
            self.finals(bh, packed)
        return bh, (sfx if self.tier else None)

    def finals(self, bh, packed):
        t, nf = self.t, self.nf
        rows, f = np.repeat(np.arange(t), nf), np.tile(np.arange(nf), t)
        sc, nl, nr, a_start = (self.h["fin"][f, i].astype(np.int64) for i in range(4))
        len1 = self.len1[rows]
        plo = np.maximum(1 - nl, 0)
        phi = np.minimum(len1 - nr - nl, self.q - 1 - nl - nr)
        phi = np.where(a_start != 0, np.minimum(phi, 1 - nl), phi)
        k = nl + nr
        ws, bs = k >> 6, (k & 63).astype(U64)
        hit = np.zeros(rows.size, dtype=bool)
        for w in range(self.nw):
            lo_i, hi_i = w + ws, w + ws + 1
            lo = np.where(lo_i < self.nw, packed[rows, sc, np.minimum(lo_i, self.nw - 1)], U64(0))
            hi = np.where(hi_i < self.nw, packed[rows, sc, np.minimum(hi_i, self.nw - 1)], U64(0))
            s = np.where(bs != 0, (lo >> bs) | (hi << ((U64(64) - bs) & U64(63))), lo)
            gj = _range_word(w, plo, phi) & s
            hit |= (gj & self.conv_word(rows, f, w)) != 0
        bh[rows, self.nbc + f] = hit


def _hits(tb, bh_all):
    dc = tb.consts[torch.device("cpu")]
    hits = (torch.as_tensor(bh_all).to(torch.float32) @ dc.b2g) > 0
    if dc.always is not None:
        hits = hits | dc.always[None, :]
    return hits.numpy()


def _check_block(jb, tb, data, lens, monkeypatch):
    """Emulation == chain_match_plain, and its hits == the JAX package's,
    with the finals tier off and on; the port's matcher too."""
    with jax_config.persistent_cache_min_compile_time_secs(1e9):  # never written
        want = _jax_hits(jb.kernel, jb.spec, data, lens)
    # Release the executable: a process that keeps two dozen of crs-lite's
    # large XLA:CPU programs loaded crashes in a later compile.
    jax.clear_caches()
    d, l = torch.as_tensor(data), torch.as_tensor(lens)
    for tier in (False, True):
        ins = tseg.chain_inputs(tb.kernel, tb.spec, d, l, consts=tb.consts, finals_tier=tier)
        if ins is None:  # no branch: only the always groups
            continue
        out, d_, l_, tables, off, tier_on = ins
        bh, sfx = tchain.chain_match_plain(out, d_, l_, tables, off=off, tier=tier_on)
        emu_bh, emu_sfx = _Emulation(out.numpy(), data, lens, tables, off, tier_on).run()
        np.testing.assert_array_equal(emu_bh, bh.numpy())
        if tier_on:
            np.testing.assert_array_equal(emu_sfx, sfx.numpy())
            embed, _sfx, lengths, ftab, q = tseg.finals_inputs(tb.kernel, tb.spec, d, l, cache=tb.finals,
                                                               consts=tb.consts)
            fin = tfin.finals_match_plain(embed, torch.as_tensor(emu_sfx), lengths, ftab, q=q).numpy()
            emu_bh = np.concatenate([emu_bh, fin], axis=1)
        np.testing.assert_array_equal(_hits(tb, emu_bh), want)
        monkeypatch.setenv("CKO_PALLAS_FINALS", "1" if tier else "0")
        got = tseg.match_segment_block(tb.kernel, tb.spec, d, l, cache=tb.finals, consts=tb.consts)
        np.testing.assert_array_equal(got.numpy(), want)


def check_crs_lite_block(crs_lite_blocks, monkeypatch, bi, length):
    jsegs, tsegs = crs_lite_blocks
    data, lens = _rows(24 if length <= 128 else 10, length, seed=100 * bi + length)
    _check_block(jsegs[bi], tsegs[bi], data, lens, monkeypatch)


def check_shapes_block(monkeypatch, length):
    jb, tb = _blocks(PATTERNS)
    data, lens = _rows(36, length, seed=length)
    # A match deep in the row, past the words of short rows.
    deep = b"z" * (length - 40) + b"select x from t"
    data[2, :] = 0
    data[2, : len(deep)] = np.frombuffer(deep, np.uint8)
    lens[2] = len(deep)
    # A line break at each end of a class gap, and inside one.
    for r, row in enumerate((b"select\nx from t", b"select x\nfrom t", b"select x \nfrom",
                             b"go\n stop", b"go x\nstop", b"^go\nstop", b"<script\n>", b"q12\n34z",
                             b"/admin\n", b"a.php\n"), start=10):
        data[r] = 0
        data[r, : len(row)] = np.frombuffer(row, np.uint8)
        lens[r] = len(row)
    _check_block(jb, tb, data, lens, monkeypatch)


def _mask(chars: bytes) -> int:
    return sum(1 << b for b in set(chars))


DIGITS, LETTERS, SPACE = _mask(b"0123456789"), _mask(b"abcdefghijklmnopqrstuvwxyz"), _mask(b" \t")
ALL_BYTES = (1 << 256) - 1
NOT_GT = ALL_BYTES & ~_mask(b">")
NON_WORD = ALL_BYTES & ~(DIGITS | LETTERS)


def _seg(text: bytes, lead: int = 0, trail: int = 0, ctx: int = NON_WORD) -> tuple:
    return ("seg", (ctx,) * lead + tuple(_mask(bytes([c])) for c in text) + (ctx,) * trail, lead, trail)


# Hand-made branches (elements, anchored start, anchored end): the crs-lite
# and regex plans only give class and any-byte gaps with lo = 0, and class
# gaps only in suffixes and start-anchored buckets. These add lo > 0, every
# gap kind in both directions, lead and trail context, and both anchors.
HAND = [
    ([("gap", DIGITS, 2, None), _seg(b"ab")], False, False),
    ([("gap", ALL_BYTES, 1, 3), _seg(b"x"), ("gap", LETTERS, 2, 5), _seg(b"y")], False, True),
    ([("gap", LETTERS, 0, 12), _seg(b"q"), ("gap", ALL_BYTES, 3, None), _seg(b"z")], True, False),
    ([("gap", SPACE, 1, 20), _seg(b"go", lead=1)], False, False),
    ([("gap", ALL_BYTES, 2, 14), _seg(b"k", trail=1)], False, False),
    ([_seg(b"sel", lead=1), ("gap", ALL_BYTES, 2, None), _seg(b"fr")], False, False),
    ([_seg(b"un"), ("gap", SPACE, 1, 4), _seg(b"io"), ("gap", LETTERS, 3, None), _seg(b"n")], False, True),
    ([_seg(b"<s"), ("gap", NOT_GT, 2, 30), _seg(b">")], True, False),
    ([_seg(b"a"), ("gap", DIGITS, 1, 2), _seg(b"b", trail=1)], False, False),
    ([_seg(b"o"), ("gap", ALL_BYTES, 70, None), _seg(b"o")], False, False),
    ([_seg(b"e"), ("gap", LETTERS, 0, 100), _seg(b"e")], False, True),
]


def _hand_blocks():
    from coraza_kubernetes_operator_tpu.compiler import segments as js
    from coraza_kubernetes_operator_tpu.ops import segment as jseg
    from coraza_kubernetes_operator_tpu_torch.compiler import segments as ts

    def plans(mod):
        def el(e):
            return mod.Seg(e[1], e[2], e[3]) if e[0] == "seg" else mod.Gap(e[1], e[2], e[3])
        return [mod.SegmentPlan((mod.Branch(tuple(el(e) for e in els), a_st, a_end),))
                for els, a_st, a_end in HAND]

    return jseg.build_segment_block(plans(js)), tseg.build_segment_block(plans(ts), device="cpu")


# Instances and near misses of HAND's branches, planted in the rows.
HAND_TOKENS = [b"12ab", b"1ab", b"-xabcy", b"qxxxz", b"abqz", b"   go", b"ago", b"zzk-", b"k",
               b" sel..fr", b"selfr", b"un  ioabcn", b"unioabn", b"<sab>", b"<s>", b"a12b-", b"a123b",
               b"o" + b"-" * 70 + b"o", b"o" + b"-" * 68 + b"o", b"eabce", b"e1e",
               b"un io1bcn", b"un ioab-n", b"1-ab", b" -x1cy", b"<sa", b"a1-b-"]


def check_hand_block(monkeypatch, length):
    jb, tb = _hand_blocks()
    rng = np.random.default_rng(length)
    alphabet = np.frombuffer(b"abegiknorsuxy<>0123456789 \t\n-", np.uint8)  # q and z come from tokens
    data = alphabet[rng.integers(0, alphabet.size, size=(30, length))]
    lens = rng.integers(length // 2, length + 1, size=30).astype(np.int32)
    for r in range(30):
        for _ in range(rng.integers(1, 5)):
            tok = np.frombuffer(HAND_TOKENS[rng.integers(len(HAND_TOKENS))], np.uint8)
            if tok.size <= lens[r]:
                at = (0, lens[r] - tok.size, rng.integers(0, lens[r] - tok.size + 1))[rng.integers(3)]
                data[r, at : at + tok.size] = tok
    lens[:2] = (0, length)
    data[3:][np.arange(length)[None, :] >= lens[3:, None]] = 0  # rows 1-2 keep bytes past their length
    _check_block(jb, tb, data, lens, monkeypatch)


@pytest.mark.parametrize("bi", range(8))
def test_crs_lite_chain_emulation_plain_and_jax_agree(crs_lite_blocks, monkeypatch, bi):
    check_crs_lite_block(crs_lite_blocks, monkeypatch, bi, LENGTH)


def test_shapes_block_chain_emulation_plain_and_jax_agree(monkeypatch):
    check_shapes_block(monkeypatch, LENGTH)


def test_hand_block_chain_emulation_plain_and_jax_agree(monkeypatch):
    check_hand_block(monkeypatch, LENGTH)


def test_chain_tables_are_deterministic(crs_lite_blocks):
    _, tsegs = crs_lite_blocks
    for tb in tsegs:
        a = tchain.chain_tables(tseg._program(tb.spec), w=tb.spec.w, device="cpu")
        b = tchain.chain_tables(tseg._program(tb.spec), w=tb.spec.w, device="cpu")
        assert a.host.keys() == b.host.keys()
        for k in a.host:
            np.testing.assert_array_equal(a.host[k], b.host[k])
            assert torch.equal(getattr(a, k), torch.as_tensor(
                a.host[k].view(np.int64) if a.host[k].dtype == U64 else a.host[k]))
        assert a.members == sum(len(i) for i in a.prog.buckets.values()) + len(a.prog.suffix_ids)
        assert a.n_bucket_cols + a.nf == len(a.prog.col_groups)


def test_class_masks_hold_their_bytes():
    ivs = ((0, 0), (9, 13), (63, 65), (200, 255))
    m = tchain.class_mask(ivs)
    held = [b for b in range(256) if (int(m[b >> 6]) >> (b & 63)) & 1]
    assert held == [b for lo, hi in ivs for b in range(lo, hi + 1)]


def test_second_call_builds_nothing_on_the_device(monkeypatch):
    _, tb = _blocks(PATTERNS)
    data, lens = _rows(8, 64, seed=3)
    d, l = torch.as_tensor(data), torch.as_tensor(lens)
    monkeypatch.setenv("CKO_PALLAS_FINALS", "1")
    first = tseg.match_segment_block(tb.kernel, tb.spec, d, l, cache=tb.finals, consts=tb.consts)
    dc = tb.consts[torch.device("cpu")]
    built = []
    for name in ("as_tensor", "tensor", "from_numpy"):
        real = getattr(torch, name)
        monkeypatch.setattr(torch, name, lambda *a, _r=real, _n=name, **k: built.append(_n) or _r(*a, **k))
    again = tseg.match_segment_block(tb.kernel, tb.spec, d, l, cache=tb.finals, consts=tb.consts)
    assert built == []
    assert tb.consts[torch.device("cpu")] is dc
    np.testing.assert_array_equal(again.numpy(), first.numpy())
