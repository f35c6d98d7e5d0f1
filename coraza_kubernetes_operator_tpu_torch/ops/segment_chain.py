"""Chain program of the conv-segment matcher (PyTorch + CUDA).

After the conv (``ops/segment.py``), a segment block's gap constraints
run as bitmap algebra over the window starts p < Q = L + 2: the bucket
signatures left to right, the distinct suffixes right to left, and one
AND-any per finals column (``segment.py``'s module docstring has the
position space). The reference (``coraza_kubernetes_operator_tpu/ops/
segment.py::match_segment_block``) writes this as one ``jax.jit`` that XLA
fuses; the port runs it as a hand-written kernel.

- ``chain_match`` — dispatch. On a CUDA tensor it launches
  ``cko_chain_match`` (``csrc/segment_chain.cu``) or raises; on a CPU
  tensor it takes ``chain_match_plain``. It counts its launches in
  ``LAUNCHES``: one per call, the finals columns included.
- ``chain_plan`` — the kernel's tiles: rows per block, the columns staged,
  the tile's layout and the shared bytes (or the global scratch where one
  row does not fit). The kernel takes the layout as it is given.
- ``chain_match_plain`` — the chain as plain PyTorch (log-shift passes,
  the non-class-count tables of the class gaps), the reference's algebra
  op for op.
- ``chain_tables`` — a block's chain program as device tables (units, op
  records, class masks, finals columns), built once per block and device
  (``segment.py`` caches them on the ``SegmentBlock``).

Operands: ``out`` [T, N2 - off, Q] the conv output in ``F.conv1d``'s
layout (bf16 on the card, float32 on the CPU), thresholded at 2W here;
``data`` [T, L] uint8 the block's rows (bytes past a row's length are read
as they are); ``lengths`` [T]. With ``tier`` (``CKO_PALLAS_FINALS=1``) the
finals columns are left to ``segment_finals.finals_match``: the result is
the bucket columns and the suffix bits [T, Q, NS] bool it reads; else the
result is every hit column [T, n_cols] bool in ``prog.col_groups`` order
and None.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from . import kernels
from .segment_finals import group_reach
from .segment_finals import shift as _shift

# Launches of ``cko_chain_match``'s kernels (``kernels.book``).
LAUNCHES = 0

# Above this Q the NCE prefix sum uses cumsum instead of a [Q, Q]
# triangular matmul — the table is O(Q²) and on long-body buckets (up to
# SecRequestBodyLimit) would be a request-triggerable multi-GB allocation.
_NCE_MATMUL_MAX_Q = 512

# The kernel keeps a bitmap of up to this many 64-bit words (Q <= 192) in
# registers; above, in its tile's state area, one column per thread.
REG_WORDS = 3
_THREADS = 256
# A block's dynamic shared memory on the card (227 KB, sm_90), and the part
# of it a tile of several rows takes: a quarter of the SM's 228 KB less the
# 1 KB the card keeps per block, so that four blocks share an SM and their
# conv loads overlap each other's walks. A row that fits only alone takes
# up to SMEM_MAX; one that does not fit at all runs in a global scratch of
# at most SCRATCH_BYTES, one slice per block. Rows are cut into at least
# TILES_PER_SM tiles per SM where there are that many.
SMEM_MAX = 232448
SMEM_TILE = 233472 // 4 - 1024
SCRATCH_BYTES = 64 << 20
TILES_PER_SM = 4
SMS = 132  # the H100's SMs; the wrapper reads the card's own count

# Record layouts shared with csrc/segment_chain.cu.
K_BUCKET, K_SINGLE, K_SUFFIX = 0, 1, 2
OP_SEG, OP_GAPANY, OP_GAPCLS = 0, 1, 2


@dataclass
class ChainTables:
    """A block's chain program on one device, and its host copies."""

    prog: object  # the block's ``segment._Program``
    w: int  # conv kernel width: a window matches at 2W
    units: torch.Tensor  # [U, 8] int32: kind, a_start, a_end, members, op0, n_ops, out col, suffix col
    ucum: torch.Tensor  # [U + 1] int32: members before each unit
    ops: torch.Tensor  # [n_ops, 4] int32: seg (0, n_lead, n_real, a0) | gapany (1, lo, hi, 0) | gapcls (2, lo, hi, class)
    cls: torch.Tensor  # [n_classes, 4] int64: 256-bit byte masks of the class gaps
    fin: torch.Tensor  # [NF, 4] int32 per finals column: suffix column, n_lead, n_real, a_start
    host: dict  # numpy copies of the five tables
    n_bucket_cols: int
    ns: int  # suffix columns
    nf: int  # finals columns

    @property
    def members(self) -> int:
        return int(self.host["ucum"][-1])

    @property
    def n_units(self) -> int:
        return int(self.host["units"].shape[0])

    @property
    def ncls(self) -> int:
        return int(self.host["cls"].shape[0])


def class_mask(ivs: tuple) -> np.ndarray:
    """Inclusive byte intervals -> 256-bit mask as 4 uint64 words (byte b
    is bit b % 64 of word b // 64)."""
    words = [0, 0, 0, 0]
    for lo, hi in ivs:
        for b in range(lo, hi + 1):
            words[b >> 6] |= 1 << (b & 63)
    return np.asarray(words, dtype=np.uint64)


def chain_tables(prog, *, w: int, device) -> ChainTables:
    """Lay out ``prog`` (``segment._program``) for ``cko_chain_match`` on
    ``device`` (one host round trip; callers cache the result)."""
    units: list[tuple] = []
    ops: list[tuple] = []

    def encode(sig_ops, slots) -> tuple[int, int]:
        op0, seg_i = len(ops), 0
        for op in sig_ops:
            if op[0] == "seg":
                ops.append((OP_SEG, op[1], op[2], slots[seg_i][0]))
                seg_i += 1
            elif op[0] == "gapany":
                ops.append((OP_GAPANY, op[1], op[2], 0))
            else:
                ops.append((OP_GAPCLS, op[2], op[3], prog.gap_classes.index(op[1])))
        return op0, len(sig_ops)

    out_col = 0
    for sig, idxs in prog.buckets.items():
        sig_ops, a_start, a_end = sig
        single = len(sig_ops) == 1 and sig_ops[0][0] == "seg"
        op0, n_ops = encode(sig_ops, prog.bucket_alloc[sig])
        units.append((K_SINGLE if single else K_BUCKET, int(a_start), int(a_end), len(idxs),
                      op0, n_ops, out_col, -1))
        out_col += len(idxs)
    sfx_col = 0
    for sig_key, members in prog.struct.items():
        sig_ops, a_end = sig_key
        op0, n_ops = encode(sig_ops, prog.struct_alloc[sig_key])
        units.append((K_SUFFIX, 0, int(a_end), len(members), op0, n_ops, -1, sfx_col))
        sfx_col += len(members)
    fin = np.zeros((prog.n_finals_cols, 4), dtype=np.int32)
    for (sid, nl, nr, a_st), (a0, a1) in prog.final_alloc.items():
        fin[a0:a1] = (prog.sid_col[sid], nl, nr, int(a_st))
    host = {
        "units": np.asarray(units, dtype=np.int32).reshape(-1, 8),
        "ucum": np.concatenate([[0], np.cumsum([u[3] for u in units])]).astype(np.int32),
        "ops": np.asarray(ops, dtype=np.int32).reshape(-1, 4),
        "cls": np.stack([class_mask(ivs) for ivs in prog.gap_classes]).reshape(-1, 4)
        if prog.gap_classes else np.zeros((0, 4), dtype=np.uint64),
        "fin": fin,
    }
    dev = torch.device(device)
    tens = {k: torch.as_tensor(v.view(np.int64) if v.dtype == np.uint64 else v, device=dev)
            for k, v in host.items()}
    return ChainTables(prog=prog, w=w, host=host, n_bucket_cols=out_col, ns=sfx_col,
                       nf=prog.n_finals_cols, **tens)


def _check(out, data, lengths, tables: ChainTables, off: int) -> None:
    if out.dim() != 3 or data.dim() != 2 or lengths.dim() != 1:
        raise ValueError(
            f"chain_match: out [T, N2 - off, Q], data [T, L], lengths [T] expected, got "
            f"{tuple(out.shape)} {tuple(data.shape)} {tuple(lengths.shape)}"
        )
    t, ln = data.shape
    if out.shape[0] != t or out.shape[2] != ln + 2 or lengths.shape[0] != t:
        raise ValueError(f"chain_match: out {tuple(out.shape)} / lengths do not match T={t}, Q={ln + 2}")
    n2 = len(tables.prog.col_order)
    if out.shape[1] != n2 - off:
        raise ValueError(f"chain_match: out has {out.shape[1]} columns, the block {n2} - off {off}")
    if not (out.device == data.device == lengths.device == tables.units.device):
        raise ValueError("chain_match: out, data, lengths and tables on different devices")


# ---------------------------------------------------------------------------
# The plain version
# ---------------------------------------------------------------------------


def _in_class(ivs: tuple, dpad: torch.Tensor) -> torch.Tensor:
    acc = torch.zeros_like(dpad, dtype=torch.bool)
    for lo, hi in ivs:
        acc = acc | ((dpad >= lo) & (dpad <= hi)) if lo != hi else acc | (dpad == lo)
    return acc


def _rshift3(x: torch.Tensor, k: int) -> torch.Tensor:
    """out[:, p] = x[:, p - k], zero fill."""
    return _shift(x, -k, False if x.dtype == torch.bool else 0)


def _lshift3(x: torch.Tensor, k: int) -> torch.Tensor:
    """out[:, p] = x[:, p + k], zero fill."""
    return _shift(x, k, False if x.dtype == torch.bool else 0)


def _spread_or(x: torch.Tensor, lo: int, hi: int, forward: bool) -> torch.Tensor:
    """OR-spread along axis 1: out[p] = ∃d ∈ [lo, hi (or ∞ if hi<0)]:
    x[p + d] (forward) or x[p - d] (backward), by log-shift passes."""
    q = x.shape[1]
    sgn = 1 if forward else -1
    assert hi < 0 or hi >= lo, f"empty gap range [{lo}, {hi}]"
    if hi < 0:
        y = x
        k = 1
        while k < q:
            y = y | _shift(y, sgn * k, False)
            k *= 2
        return _shift(y, sgn * lo, False)
    width = hi - lo + 1
    y = x
    span = 1  # y[p] == OR of x[p .. p + span-1] (direction-adjusted)
    while span * 2 <= width:
        y = y | _shift(y, sgn * span, False)
        span *= 2
    if span < width:
        y = y | _shift(y, sgn * (width - span), False)
    return _shift(y, sgn * lo, False)


def _latch_min(vals: torch.Tensor, big: int, forward: bool) -> torch.Tensor:
    """Running min along axis 1 (suffix-min if forward, prefix-min if
    backward) via log-shift passes."""
    q = vals.shape[1]
    sgn = 1 if forward else -1
    y = vals
    k = 1
    while k < q:
        y = torch.minimum(y, _shift(y, sgn * k, big))
        k *= 2
    return y


def _window_min(vals: torch.Tensor, lo: int, hi: int, big: int, forward: bool) -> torch.Tensor:
    """Windowed min along axis 1: out[p] = min over d ∈ [lo, hi] of
    vals[p + d] (forward) / vals[p - d] (backward)."""
    sgn = 1 if forward else -1
    width = hi - lo + 1
    y = vals
    span = 1
    while span * 2 <= width:
        y = torch.minimum(y, _shift(y, sgn * span, big))
        span *= 2
    if span < width:
        y = torch.minimum(y, _shift(y, sgn * (width - span), big))
    return _shift(y, sgn * lo, big)


def chain_match_plain(out, data, lengths, tables: ChainTables, *, off: int, tier: bool):
    """Plain PyTorch twin of ``cko_chain_match``; operands and result as
    ``chain_match``'s."""
    _check(out, data, lengths, tables, off)
    prog, w = tables.prog, tables.w
    t, ln = data.shape
    dev = data.device
    q = ln + 2
    lengths = lengths.to(torch.int32)
    dpad = F.pad(data.to(torch.int32), (1, 1))  # [T, Q]: the front NUL pad, the row, a NUL
    m_all = (out >= 2.0 * w).permute(0, 2, 1)  # [T, Q, N2 - off]

    def mslice(a0: int, a1: int) -> torch.Tensor:
        """Columns [a0, a1) of the global allocation, off-adjusted."""
        return m_all[:, :, a0 - off : a1 - off]

    iota = torch.arange(q, dtype=torch.int32, device=dev)[None, :]  # [1, Q]
    len1 = 1 + lengths[:, None]  # [T, 1] position just past the last byte
    iota3 = iota[..., None]  # [1, Q, 1]
    len3 = len1[..., None]  # [T, 1, 1]

    # NCE (count of non-class bytes before p) per gap class: a [Q, Q]
    # triangular matmul for small Q (0/1 operands, sums ≤ Q ≤ 512: exact
    # in float32 and in TF32), an exclusive cumsum above _NCE_MATMUL_MAX_Q.
    tri_excl = None
    _tabs_cache: dict[tuple, tuple] = {}
    for ivs in prog.gap_classes:
        in_c = _in_class(ivs, dpad)  # byte at p ∈ class
        if q > _NCE_MATMUL_MAX_Q:
            non_i = (~in_c).to(torch.int32)
            nce = torch.cumsum(non_i, dim=1, dtype=torch.int32) - non_i
        else:
            if tri_excl is None:
                tri_excl = torch.triu(
                    torch.ones((q, q), dtype=torch.float32, device=dev), 1
                )  # [p', p]: p' < p
            nce = ((~in_c).to(torch.float32) @ tri_excl).to(torch.int32)
        _tabs_cache[ivs] = (in_c, nce)

    big = 1 << 20

    def gap_cls(x: torch.Tensor, ivs: tuple, lo: int, hi: int, forward: bool):
        """Class-gap op along axis 1 of [T, Q, NB]. Forward (suffix/RTL):
        out[p] = ∃d ∈ [lo, hi]: bytes [p, p+d) ∈ C ∧ x[p+d]. Backward
        (bucket/LTR): out[p'] = ∃d: bytes [p'-d, p') ∈ C ∧ x[p'-d]."""
        _, nce = _tabs_cache[ivs]
        nce3 = nce[..., None]
        bigt = torch.full_like(nce3, big)

        def clean(d: int) -> torch.Tensor:
            if d == 0:
                return torch.ones((t, q, 1), dtype=torch.bool, device=dev)
            return (_shift(nce3, d, big) - nce3) == 0

        if hi >= 0:
            if hi - lo + 1 <= 8:
                acc = torch.zeros_like(x)
                for d in range(lo, hi + 1):
                    if forward:
                        acc = acc | (_lshift3(x, d) & clean(d))
                    else:
                        acc = acc | _rshift3(x & clean(d), d)
                return acc
            if forward:
                m = _window_min(torch.where(x, nce3, bigt), lo, hi, big, forward=True)
                return m == nce3
            m = -_window_min(torch.where(x, -nce3, bigt), lo, hi, big, forward=False)
            return m == nce3
        if forward:
            x1 = _lshift3(x, lo) & clean(lo) if lo else x
            h = _latch_min(torch.where(x1, nce3, bigt), big, forward=True)
            return h == nce3
        x1 = _rshift3(x & clean(lo), lo) if lo else x
        h = -_latch_min(torch.where(x1, -nce3, bigt), big, forward=False)
        return h == nce3

    def run_bucket(sig: tuple, idxs: list[int]) -> torch.Tensor:
        ops, a_start, a_end = sig
        slots = prog.bucket_alloc[sig]
        nb = len(idxs)

        # Single-seg fast path: evaluate at window starts, no shifts.
        if len(ops) == 1 and ops[0][0] == "seg":
            _, n_lead, n_real = ops[0]
            a0, a1 = slots[0]
            m = mslice(a0, a1)  # [T, Q, NB]
            r = iota3 + n_lead  # real start for window at j
            ok = (r >= 1) & (r + n_real <= len3)
            if a_start:
                ok = ok & (r == 1)
            if a_end:
                ok = ok & (r + n_real == len3)
            return (m & ok).any(dim=1)  # [T, NB]

        e = (iota3 == 1) if a_start else (iota3 >= 1)
        e = e.expand(t, q, nb)
        seg_i = 0
        for op in ops:
            if op[0] == "seg":
                _, n_lead, n_real = op
                a0, a1 = slots[seg_i]
                seg_i += 1
                m = _rshift3(mslice(a0, a1), n_lead)  # [T, Q, NB]
                valid = (iota3 >= 1) & (iota3 + n_real <= len3)
                e = e & m & valid
                e = _rshift3(e, n_real)
            elif op[0] == "gapany":
                _, lo, hi = op
                e = _spread_or(e, lo, hi, forward=False)
            else:  # gapcls
                _, ivs, lo, hi = op
                e = gap_cls(e, ivs, lo, hi, forward=False)
        if a_end:
            return (e & (iota3 == len3)).any(dim=1)
        return (e & (iota3 <= len3)).any(dim=1)

    # --- suffix-deduped tier: right-to-left, batched over distinct suffixes.
    # With the finals tier on, each signature's result also lands in its
    # columns of one [T, Q, NS] buffer, the finals kernel's operand.
    s_store: dict[int, torch.Tensor] = {}
    suffix = torch.empty((t, q, tables.ns), dtype=torch.bool, device=dev) if tier else None
    for sig_key, members in prog.struct.items():
        sig_ops, a_end = sig_key
        ns = len(members)
        s = ((iota3 == len3) if a_end else (iota3 <= len3)).expand(t, q, ns)
        seg_slot = sum(1 for o in sig_ops if o[0] == "seg")
        for op in reversed(sig_ops):
            if op[0] == "seg":
                seg_slot -= 1
                _, n_lead, n_real = op
                a0, a1 = prog.struct_alloc[sig_key][seg_slot]
                m = _rshift3(mslice(a0, a1), n_lead)  # index by real start
                valid = (iota3 >= 1) & (iota3 + n_real <= len3)
                s = m & valid & _lshift3(s, n_real)
            elif op[0] == "gapany":
                _, lo, hi = op
                s = _spread_or(s, lo, hi, forward=True)
            else:  # gapcls
                _, ivs, lo, hi = op
                s = gap_cls(s, ivs, lo, hi, forward=True)
        c0 = prog.sid_col[members[0][1]]
        if tier:
            suffix[:, :, c0 : c0 + ns].copy_(s)
        for i, (_skey, sid) in enumerate(members):
            s_store[sid] = s[:, :, i]

    cols = [run_bucket(sig, idxs) for sig, idxs in prog.buckets.items()]  # [T, len(idxs)] each
    if not tier:
        # Per finals group: where its first segment's window may start.
        for key in prog.finals:
            sid, n_lead, n_real, a_start = key
            gj = group_reach(s_store[sid], n_lead, n_real, a_start, iota, len1)  # [T, Q]
            a0, a1 = prog.final_alloc[key]
            cols.append((mslice(a0, a1) & gj[:, :, None]).any(dim=1))  # [T, NB]
    bh = torch.cat(cols, dim=1) if cols else torch.zeros((t, 0), dtype=torch.bool, device=dev)
    return bh, suffix


# ---------------------------------------------------------------------------
# The kernel
# ---------------------------------------------------------------------------


def chain_match(out, data, lengths, tables: ChainTables, *, off: int, tier: bool):
    """The block's hit columns (and, with ``tier``, its suffix bits) from
    the conv output. CPU tensors take ``chain_match_plain``; CUDA tensors
    launch ``cko_chain_match``; other devices raise."""
    dev = out.device
    if dev.type == "cpu":
        return chain_match_plain(out, data, lengths, tables, off=off, tier=tier)
    if dev.type != "cuda":
        raise ValueError(f"chain_match: unsupported device {dev}")
    _check(out, data, lengths, tables, off)
    if out.dtype != torch.bfloat16:
        raise ValueError(f"chain_match: the conv output on the card is bf16, got {out.dtype}")
    bh, suffix, n = launch_chain(out, data, lengths, tables, off, tier)
    if n:
        kernels.book(__name__, n)
    return bh, suffix


@dataclass(frozen=True)
class ChainPlan:
    """How ``cko_chain_match`` cuts a block's rows into tiles."""

    rows: int  # rows per tile (block)
    tiles: int  # row tiles: ceil(T / rows)
    grid: int  # blocks; each walks tiles grid-stride
    cols: int  # conv columns staged per row: every column the block's items read
    nw: int  # 64-bit words per bitmap: ceil(Q / 64)
    smem: int  # dynamic shared bytes per block
    scratch_words: int  # int64 words of global scratch per block; 0 when the tile is in shared memory
    layout: tuple[int, int, int, int]  # ``tile_layout``: suffix, class and state areas, tile words
    at_ints: int  # shared bytes before the staged ucum and the tile's lengths (int32)

    def tile_rows(self, t: int) -> list[tuple[int, int]]:
        """(first row, rows) of each tile, in order."""
        return [(k * self.rows, min(self.rows, t - k * self.rows)) for k in range(self.tiles)]


def tile_layout(rows: int, nw: int, ncol: int, ns: int, ncls: int) -> tuple[int, int, int, int]:
    """A tile of ``rows`` rows, in int64 words: where its suffix, class and
    state areas start, and its words in all. Match words [rows, nw, ncol]
    come first, then suffix [rows, nw, NS] and class [rows, nw, ncls]
    words, then the state area [nw, threads] of bitmaps past REG_WORDS
    words. ``cko_chain_match`` takes these offsets as they are."""
    at_sfx = rows * nw * ncol
    at_cls = at_sfx + rows * nw * ns
    at_state = at_cls + rows * nw * ncls
    return at_sfx, at_cls, at_state, at_state + (nw * _THREADS if nw > REG_WORDS else 0)


def chain_plan(t: int, q: int, ncol: int, ns: int, ncls: int, n_units: int, *, sms: int = SMS) -> ChainPlan:
    """The tiles of ``cko_chain_match`` for T rows of Q positions, ``ncol``
    conv columns (all of them staged: with the finals tier off the finals
    columns read the first NF, with it on the conv has none of them), NS
    suffix columns, ``ncls`` class gaps and ``n_units`` units.

    As many rows as fit in SMEM_TILE bytes share a block, but no more than
    leave TILES_PER_SM tiles for each of ``sms`` SMs; a row that fits only
    alone takes up to SMEM_MAX; beyond that each block holds one row in
    its slice of a global scratch (at most SCRATCH_BYTES in all) and shared
    memory keeps the staged unit offsets and lengths only."""
    nw = (q + 63) // 64
    ints = 4 * (n_units + 1)  # the staged ucum, then 4 bytes per row's length
    empty = 8 * tile_layout(0, nw, ncol, ns, ncls)[3]
    fixed = empty + ints
    per_row = 8 * tile_layout(1, nw, ncol, ns, ncls)[3] - empty + 4
    t = max(t, 1)
    rows = min(-(-t // (TILES_PER_SM * sms)), max(0, (SMEM_TILE - fixed) // per_row))
    if rows == 0 and fixed + per_row <= SMEM_MAX:
        rows = 1
    if rows:
        tiles = -(-t // rows)
        layout = tile_layout(rows, nw, ncol, ns, ncls)
        return ChainPlan(rows=rows, tiles=tiles, grid=tiles, cols=ncol, nw=nw,
                         smem=8 * layout[3] + ints + 4 * rows, scratch_words=0,
                         layout=layout, at_ints=8 * layout[3])
    layout = tile_layout(1, nw, ncol, ns, ncls)
    grid = min(t, max(1, SCRATCH_BYTES // (8 * layout[3])))
    return ChainPlan(rows=1, tiles=t, grid=grid, cols=ncol, nw=nw, smem=ints + 4,
                     scratch_words=layout[3], layout=layout, at_ints=0)


def launch_chain(out, data, lengths, tables: ChainTables, off: int, tier: bool):
    """Run ``cko_chain_match`` on operands that ``_check`` passed; returns
    (hit columns [T, ldo] bool, suffix bits [T, Q, NS] bool or None, kernel
    launches)."""
    dev = out.device
    t, ln = data.shape
    q = ln + 2
    nbc, nf, ns = tables.n_bucket_cols, tables.nf, tables.ns
    ldo = nbc if tier else nbc + nf
    bh = torch.empty((t, ldo), dtype=torch.bool, device=dev)
    suffix = torch.empty((t, q, ns), dtype=torch.bool, device=dev) if tier else None
    finals = not tier and nf > 0
    if not t or not (tables.members or finals):
        return bh, suffix, 0
    o = out.contiguous()
    if o.data_ptr() % 16:  # the kernel reads the conv output in 16-byte chunks
        o = o.clone()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count if dev.type == "cuda" else SMS
    plan = chain_plan(t, q, o.shape[1], ns, tables.ncls, tables.n_units, sms=sms)
    scratch = (torch.empty(plan.grid * plan.scratch_words, dtype=torch.int64, device=dev)
               if plan.scratch_words else None)
    d8 = (data if data.dtype == torch.uint8 else data.to(torch.uint8)).contiguous()
    lens = lengths.to(torch.int32).contiguous()
    at_sfx, at_cls, at_state, tile_u64 = plan.layout
    p = kernels.ptr
    i = ctypes.c_int
    with kernels.on_device(dev) as stream:
        args = [
            p(o), p(d8), p(lens), p(tables.units), p(tables.ucum), p(tables.ops), p(tables.cls),
            p(tables.fin), i(t), i(ln), i(q), i(o.shape[1]), i(off), i(tables.w),
            i(tables.n_units), i(tables.members), i(ns), i(nf), i(tables.ncls), i(nbc), i(ldo),
            i(int(finals)), i(plan.rows), i(plan.grid), i(plan.smem), i(at_sfx), i(at_cls),
            i(at_state), i(tile_u64), i(plan.at_ints), p(scratch), p(suffix), p(bh), stream,
        ]
        fn = kernels.function("segment_chain", "cko_chain_match")
        kernels.check(fn(*args), "segment_chain", "cko_chain_match")
    return bh, suffix, 1
