"""The conv-segment chain kernel's arithmetic, on the CPU.

``cko_chain_match`` (``csrc/segment_chain.cu``) runs only on the card.
Here ``_Emulation`` replays its walk over the block's packed tables op for
op — the items decoded tile by tile through ``chain_plan`` (``ucum``
scaled by the tile's rows, each item exactly once), 64-bit match words
with noise past each row's position len + 1 (which the kernel need not
read), class bitmaps, word shifts, the log passes and bit scans of
``gapany``, the class walks of ``gapcls`` with their run counter and word
skip and the carry flood for unbounded gaps (each asserted equal to the
bit walk), the suffix words and the finals columns' reach words — and is
held bit for bit against ``chain_match_plain``; the hit
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

import dataclasses

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


_BREV8 = np.asarray([int(f"{i:08b}"[::-1], 2) for i in range(256)], dtype=np.uint8)


def _brev(x):
    """``__brevll`` per item."""
    return _BREV8[np.ascontiguousarray(x, dtype=U64).view(np.uint8).reshape(-1, 8)[:, ::-1]].copy().view(U64)[:, 0]


def _run_after(c, bend, run, up):
    """``run_after_up`` / ``run_after_down`` of the kernel, per item."""
    m64 = (1 << 64) - 1
    out = []
    for ci, ri in zip(c.tolist(), run.tolist()):
        if up:
            v = ~((ci << (64 - bend)) & m64) & m64
            ones = 64 - v.bit_length()  # __clzll
        else:
            v = ~ci & m64
            ones = (v & -v).bit_length() - 1 if v else 64  # __ffsll - 1
        out.append(ri + bend if ones >= bend else ones)
    return np.asarray(out, dtype=np.int64)


def _tile_items(plan, units, ucum, t):
    """Per unit (rows, members) of its items, decoded tile by tile as the
    kernel does (a tile of rt rows holds rt * M items, unit by unit: rows,
    then members); checks that every (row, member) comes once."""
    ucum = ucum.astype(np.int64)
    m = int(ucum[-1])
    nb_of = units[:, 3].astype(np.int64)
    seen = np.zeros(t * m, dtype=np.int64)
    per_unit = [([], []) for _ in range(len(units))]
    for t0, rt in plan.tile_rows(t):
        g = np.arange(rt * m)
        u = np.searchsorted(rt * ucum, g, side="right") - 1
        local = g - rt * ucum[u]
        rr, j = local // nb_of[u], local % nb_of[u]
        np.add.at(seen, (t0 + rr) * m + ucum[u] + j, 1)
        for k in np.unique(u):
            per_unit[k][0].append(t0 + rr[u == k])
            per_unit[k][1].append(j[u == k])
    assert np.array_equal(seen, np.ones(t * m)), "an item is missed or run twice"
    return [(np.concatenate(r) if r else np.zeros(0, np.int64), np.concatenate(j) if j else np.zeros(0, np.int64))
            for r, j in per_unit]


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
        # The kernel may skip the conv elements past a row's position
        # len + 1 (no chain reads them): noise there.
        past = np.arange(self.nw * 64)[None, None, :] > lens.astype(np.int64)[:, None, None] + 1
        noise = np.random.default_rng(7).random(past.shape[:1] + (out.shape[1], self.nw * 64)) < 0.5
        bits = np.where(past, noise, bits)
        self.mw = np.packbits(bits.reshape(*out.shape[:2], self.nw, 64), axis=-1,
                              bitorder="little").view("<u8")[..., 0]  # [T, ncol, nw]
        self.dpad = np.zeros((self.t, self.q), dtype=np.int64)
        self.dpad[:, 1 : self.l + 1] = data
        # Class bitmaps [T, ncls, nw]: bit p is dpad[p] in the class (0 past Q).
        cls_bits = np.zeros((self.t, len(self.h["cls"]), self.nw * 64), dtype=bool)
        for c, mask in enumerate(self.h["cls"]):
            b = self.dpad
            cls_bits[:, c, : self.q] = (mask[b >> 6] >> (b & 63).astype(U64)) & U64(1) != 0
        self.cw = np.packbits(cls_bits.reshape(self.t, -1, self.nw, 64), axis=-1,
                              bitorder="little").view("<u8")[..., 0]
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

    def flood(self, e, cls, up, rows):
        """The kernel's word-parallel gapcls for lo = 0 and no bound."""
        cw = self.cw[rows, cls]
        k = np.zeros(e.shape[0], dtype=U64)
        out = np.zeros_like(e)
        with np.errstate(over="ignore"):
            for w in (range(self.nw) if up else range(self.nw - 1, -1, -1)):
                if up:
                    x, m = e[:, w], cw[:, w]
                else:
                    x = _brev(e[:, w])
                    below = cw[:, w - 1] >> U64(63) if w > 0 else np.zeros_like(k)
                    m = (_brev(cw[:, w]) >> U64(1)) | (below << U64(63))
                s1 = (x & m) + m
                s2 = s1 + k
                f = (s2 ^ m) | x | k
                out[:, w] = f if up else _brev(f)
                k = ((s1 < m) | (s2 < s1)).astype(U64)
        if up:
            out[:, -1] &= _range_word(self.nw - 1, 0, self.q - 1)
        return out

    def walk(self, e, lo, hi, cls, up, rows):
        fast = self.flood(e.copy(), cls, up, rows) if lo == 0 and hi < 0 else None
        self.walk_bits(e, lo, hi, cls, up, rows)
        if fast is not None:  # the flood gives the walk's bits
            np.testing.assert_array_equal(fast, e)

    def walk_bits(self, e, lo, hi, cls, up, rows):
        cw = self.cw[rows, cls]  # [n, nw]
        hmax = UNBOUNDED if hi < 0 else hi
        n = e.shape[0]
        near, run = np.full(n, NONE, dtype=np.int64), np.zeros(n, dtype=np.int64)
        dead = np.ones(n, dtype=bool)
        carry = np.zeros(n, dtype=U64)
        (self.shift_up if up else self.shift_down)(e, lo)
        for w in (range(self.nw) if up else range(self.nw - 1, -1, -1)):
            x, o = e[:, w].copy(), np.zeros(n, dtype=U64)
            bend = min(64, self.q - 64 * w)
            c = cw[:, w]
            if up:  # bit b: dpad[64 w + b - 1] in C
                c, carry = (c << U64(1)) | carry, c >> U64(63)
            cbits = (c[:, None] >> np.arange(64, dtype=U64)) & U64(1) != 0  # [n, 64]
            # A word with no set bit after a dead position: only the run moves.
            skip = (x == 0) & dead
            run_skip = _run_after(c, bend, run, up)
            for bit in (range(bend) if up else range(bend - 1, -1, -1)):
                p = 64 * w + bit
                run = np.where(cbits[:, bit], run + 1, 0)
                near = np.where((x >> U64(bit)) & U64(1) != 0, p, near)
                d = lo + p - near if up else lo + near - p
                o |= ((near != NONE) & (d <= hmax) & (d <= run)).astype(U64) << U64(bit)
            d = lo + 64 * w + bend - 1 - near if up else lo + near - 64 * w
            # The skip is exact: the bit walk gives no bit and the same run there.
            assert not o[skip].any() and (run[skip] == run_skip[skip]).all()
            dead = np.where(skip, dead, (near == NONE) | (d > hmax) | (d > run))
            e[:, w] = o

    # -- the two kernels -------------------------------------------------------
    def run(self):
        h, t = self.h, self.t
        ldo = self.nbc if self.tier else self.nbc + self.nf
        bh = np.zeros((t, ldo), dtype=bool)
        sfx = np.zeros((t, self.q, self.ns), dtype=bool)
        packed = np.zeros((t, self.ns, self.nw), dtype=U64)
        items = _tile_items(self.plan(), h["units"], h["ucum"], t)
        for u, (kind, a_start, a_end, nb, op0, n_ops, oc, sc) in enumerate(h["units"].tolist()):
            rows, j = items[u]
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
                    self.walk(e, p1, p2, p3, up, rows)
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

    def plan(self):
        """The kernel's plan, cut to tiles of at most 5 rows so that the
        rows here span several tiles and end inside one."""
        plan = tchain.chain_plan(self.t, self.q, self.mw.shape[1], self.ns, len(self.h["cls"]),
                                 len(self.h["units"]))
        rows = min(5, plan.rows)
        return dataclasses.replace(plan, rows=rows, tiles=-(-self.t // rows))

    def finals(self, bh, packed):
        t, nf = self.t, self.nf
        # Per tile, one item per (row, finals column).
        rows, f = [], []
        for t0, rt in self.plan().tile_rows(t):
            g = np.arange(rt * nf)
            rows.append(t0 + g // nf)
            f.append(g % nf)
        rows, f = np.concatenate(rows), np.concatenate(f)
        assert np.array_equal(np.bincount(rows * nf + f, minlength=t * nf), np.ones(t * nf))
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


def _columns_read(tables, off):
    """Conv columns (after ``off``) that the block's items read: each seg
    op's column per member and, with the finals columns in the launch,
    column f of finals column f."""
    h, cols = tables.host, []
    for kind, _a_st, _a_end, nb, op0, n_ops, _oc, _sc in h["units"].tolist():
        for typ, _p1, _p2, p3 in h["ops"][op0 : op0 + n_ops].tolist():
            if typ == tchain.OP_SEG:
                cols.extend(range(p3 - off, p3 - off + nb))
    if not off:
        cols.extend(range(tables.nf))
    return np.asarray(cols, dtype=np.int64)


@pytest.mark.parametrize("q", [66, 130, 2050, 16386])
def test_chain_plan_fits_and_covers_every_item(crs_lite_blocks, q):
    """Every crs-lite block at every tier width plans within a block's
    shared memory (227 KB) or in a global scratch of at most 64 MiB, stages
    every column its items read, and its tiles run every (row, member) item
    and every (row, finals column) exactly once, the last tile ending
    inside it; up to Q = 130 every block's tile is in shared memory."""
    _, tsegs = crs_lite_blocks
    for tb in tsegs:
        prog = tseg._program(tb.spec)
        tables = tchain.chain_tables(prog, w=tb.spec.w, device="cpu")
        h = tables.host
        for tier in (False, True):
            off = tables.nf if tier else 0
            ncol = len(prog.col_order) - off
            read = _columns_read(tables, off)
            for t in (1, 7, 301, 12288):
                plan = tchain.chain_plan(t, q, ncol, tables.ns, tables.ncls, tables.n_units)
                assert plan.smem <= tchain.SMEM_MAX, (q, t, plan)
                assert plan.cols == ncol and (read.size == 0 or (read.min() >= 0 and read.max() < ncol))
                assert plan.tiles == -(-t // plan.rows) and 1 <= plan.grid <= plan.tiles
                # The kernel indexes each area of the tile by rows, words and
                # columns: the layout gives each that room, in order.
                rw = plan.rows * plan.nw
                at_sfx, at_cls, at_state, words = plan.layout
                assert (at_sfx, at_cls - at_sfx, at_state - at_cls) == (rw * ncol, rw * tables.ns,
                                                                        rw * tables.ncls)
                assert words - at_state == (plan.nw * 256 if plan.nw > tchain.REG_WORDS else 0)
                if plan.scratch_words:
                    assert plan.rows == 1 and plan.scratch_words == words and plan.at_ints == 0
                    assert 8 * plan.scratch_words * plan.grid <= max(tchain.SCRATCH_BYTES, 8 * plan.scratch_words)
                else:
                    assert plan.at_ints == 8 * words
                assert plan.smem == plan.at_ints + 4 * (tables.n_units + 1 + plan.rows)
                assert plan.scratch_words == 0 or q > 130, (q, plan)
                tiles = plan.tile_rows(t)
                assert [r0 for r0, _ in tiles] == list(range(0, t, plan.rows)) and sum(r for _, r in tiles) == t
                if t <= 301:
                    _tile_items(plan, h["units"], h["ucum"], t)
