"""Fused finals tier of the conv-segment matcher (PyTorch + CUDA).

Counterpart of ``coraza_kubernetes_operator_tpu/ops/segment_pallas.py``
(``_finals_kernel`` and its wrapper ``finals_match``). For each (row t,
finals column n) it reports whether some window start p < Q has a window
score ``sum over j < W, c < C of embed[t, p + j, c] * weights[j*C + c, n]``
that reaches 2W while the column's group is reachable at p, without the
[T, Q, Nf] match bitmap that the conv path materializes for these
columns.

Reachability is not an operand: the reference hands its kernel ``gj``
[T, Q, Gf], one row per finals group, stacked. Here the kernel takes what
``gj`` is made from, the suffix pass's results ``suffix`` [T, Q, NS] (one
column per distinct suffix) and a static descriptor per group, and
computes (``group_reach``, the one definition both paths use):

    G(t, r)     = r >= 1 and r + n_real <= 1 + len[t] and (not a_start or r == 1)
                  and suffix[t, r + n_real, col]
    gj[t, p, k] = G(t, p + n_lead)        (False where an index leaves [0, Q))

- ``finals_match`` — dispatch. On a CUDA tensor it launches the
  hand-written kernel ``cko_finals_match`` (``csrc/segment_finals.cu``)
  or raises; on a CPU tensor it takes ``finals_match_plain``. It counts
  its launches in ``LAUNCHES``.
- ``finals_match_plain`` — the reference's XLA semantics in plain
  PyTorch: ``gj`` from ``group_reach``, ``conv1d`` of the finals columns,
  ``>= 2W``, AND ``gj`` gathered by column group, ``any`` over Q. Rows run
  in chunks so its [rows, Nf, Q] score block stays bounded at long rows.
- ``finals_tables`` — a block's constant operands (weights, descriptors,
  column groups, and the kernel's weight bitplanes and early-exit
  thresholds), built once per block and device (``ops/segment.py``
  caches them on the ``SegmentBlock``).

The reference passes a one-hot ``sel`` [Gf, Nf]; every finals column
belongs to exactly one group, so the port passes that group's index per
column, ``col_group`` [Nf].

Operands: ``embed`` [T, Lp, C] channel planes holding 0/1 (bool, uint8 or
a float type) with Lp >= Q + W - 1; ``suffix`` [T, Q, NS] holding 0/1;
``lengths`` [T]; ``weights`` [W*C, Nf] holding 0, 1 or 2 (what
``build_segment_block`` makes); ``desc`` [Gf, 4] integers (suffix column,
n_lead, n_real, a_start); ``col_group`` [Nf] integers in [0, Gf). Returns
[T, Nf] bool.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from . import kernels

# Launches of ``cko_finals_match`` (the wrapper counts each one).
LAUNCHES = 0

# Score elements (rows x max(Nf, Gf) x Q) of one chunk of the plain version.
_PLAIN_CHUNK_ELEMS = 2**27

# Dynamic shared memory one block may use on Hopper (227 KB).
SMEM_CAP = 232448
# Largest window-start tile (positions) of one kernel pass over a row.
Q_TILE_MAX = 512


def shift(x: torch.Tensor, k: int, fill) -> torch.Tensor:
    """Shift along axis 1: out[:, p] = x[:, p + k] (k > 0 pulls from the
    right, k < 0 from the left), ``fill`` where p + k is out of range."""
    if k == 0:
        return x
    q = x.shape[1]
    if abs(k) >= q:
        return torch.full_like(x, fill)
    pad = torch.full(
        (x.shape[0], abs(k)) + tuple(x.shape[2:]), fill, dtype=x.dtype, device=x.device
    )
    if k > 0:
        return torch.cat([x[:, k:], pad], dim=1)
    return torch.cat([pad, x[:, : q + k]], dim=1)


def group_reach(s2, n_lead: int, n_real: int, a_start: bool, iota, len1) -> torch.Tensor:
    """[T, Q] bool: where one finals group's first segment window may
    start. ``s2`` [T, Q] is its suffix column (indexed by the real start
    of the next element), ``iota`` [1, Q] int32 and ``len1`` [T, 1] int32
    is 1 + length."""
    g = (iota >= 1) & (iota + n_real <= len1) & shift(s2, n_real, False)
    if a_start:
        g = g & (iota == 1)
    return shift(g, n_lead, False)


@dataclass
class FinalsTables:
    """A segment block's constant finals operands on one device."""

    weights: torch.Tensor  # [W*C, Nf] 0/1/2
    desc: torch.Tensor  # [Gf, 4] int32: suffix column, n_lead, n_real, a_start
    col_group: torch.Tensor  # [Nf] int32
    kbits: torch.Tensor  # [Nf, W, nw, 2] int64: bitplanes K & 1, K >> 1 of 64 channels
    thr: torch.Tensor  # [Nf, W] int32: least partial sum after positions 0..j
    desc_np: np.ndarray  # host copy of desc (the plain version's loop)
    w: int
    c: int

    @property
    def nf(self) -> int:
        return int(self.weights.shape[1])

    @property
    def gf(self) -> int:
        return int(self.desc_np.shape[0])

    @property
    def d_max(self) -> int:
        """Largest n_lead + n_real: how far past a tile the kernel reads."""
        return int((self.desc_np[:, 1] + self.desc_np[:, 2]).max(initial=0))


def pack_weights(v: np.ndarray, w: int) -> tuple[np.ndarray, np.ndarray]:
    """Kernel form of weights ``v`` [W*C, Nf] (values 0..3): bitplanes
    [Nf, W, nw, 2] uint64 and early-exit thresholds [Nf, W] int32. After
    window positions 0..j a partial sum below thr[n, j] cannot reach 2W,
    since the remaining positions add at most their weights' sum."""
    c = v.shape[0] // w if w else 0
    nf = v.shape[1]
    nw = (c + 63) // 64
    v3 = v.reshape(w, c, nf).astype(np.int64)
    bits = np.zeros((nf, w, nw, 2), dtype=np.uint64)
    for ci in range(c):
        sh = np.uint64(ci % 64)
        bits[:, :, ci // 64, 0] |= (v3[:, ci, :].T & 1).astype(np.uint64) << sh
        bits[:, :, ci // 64, 1] |= ((v3[:, ci, :].T >> 1) & 1).astype(np.uint64) << sh
    col_max = v3.sum(axis=1)  # [W, Nf]
    rest = np.cumsum(col_max[::-1], axis=0)[::-1] - col_max  # positions after j
    return bits, np.ascontiguousarray((2 * w - rest).T, dtype=np.int32)


def finals_tables(weights: torch.Tensor, desc, col_group, *, w: int) -> FinalsTables:
    """Validate and lay out a block's constant operands on ``weights``'
    device (one host round trip; callers cache the result)."""
    if weights.dim() != 2 or (w and weights.shape[0] % w):
        raise ValueError(f"finals_tables: weights [W*C, Nf] with W = {w}, got {tuple(weights.shape)}")
    dev = weights.device
    v = weights.detach().to(torch.int64).cpu().numpy()
    if v.size and (v.min() < 0 or v.max() > 3):
        raise ValueError("finals_tables: weights outside 0..3")
    d = np.asarray(desc.cpu() if isinstance(desc, torch.Tensor) else desc, dtype=np.int64).reshape(-1, 4)
    if d.size and (d[:, :3].min() < 0 or not np.isin(d[:, 3], (0, 1)).all()):
        raise ValueError("finals_tables: descriptors need columns, n_lead, n_real >= 0, a_start 0/1")
    cg = np.asarray(col_group, dtype=np.int64)
    if cg.shape != (v.shape[1],):
        raise ValueError(f"finals_tables: col_group {cg.shape}, weights has {v.shape[1]} columns")
    if cg.size and (cg.min() < 0 or cg.max() >= d.shape[0]):
        raise ValueError(f"finals_tables: col_group outside [0, {d.shape[0]})")
    bits, thr = pack_weights(v, w)
    return FinalsTables(
        weights=weights,
        desc=torch.as_tensor(d.astype(np.int32), device=dev),
        col_group=torch.as_tensor(cg.astype(np.int32), device=dev),
        kbits=torch.as_tensor(bits.view(np.int64), device=dev),
        thr=torch.as_tensor(thr, device=dev),
        desc_np=d,
        w=w,
        c=v.shape[0] // w if w else 0,
    )


def _check(embed, suffix, lengths, tables: FinalsTables, q: int) -> None:
    if embed.dim() != 3 or suffix.dim() != 3 or lengths.dim() != 1:
        raise ValueError(
            f"finals_match: embed [T, Lp, C], suffix [T, Q, NS], lengths [T] expected, got "
            f"{tuple(embed.shape)} {tuple(suffix.shape)} {tuple(lengths.shape)}"
        )
    t, lp, c = embed.shape
    if c != tables.c:
        raise ValueError(f"finals_match: embed has {c} channels, the weights W*C = {tables.w} * {tables.c}")
    if suffix.shape[0] != t or suffix.shape[1] != q or lengths.shape[0] != t:
        raise ValueError(f"finals_match: suffix {tuple(suffix.shape)} / lengths do not match T={t}, Q={q}")
    if lp < q + tables.w - 1:
        raise ValueError(f"finals_match: embed has {lp} positions, Q + W - 1 = {q + tables.w - 1}")
    if tables.gf and tables.desc_np[:, 0].max() >= suffix.shape[2]:
        raise ValueError(f"finals_match: a descriptor names a suffix column outside [0, {suffix.shape[2]})")
    if not (suffix.device == lengths.device == tables.weights.device == embed.device):
        raise ValueError("finals_match: embed, suffix, lengths and tables on different devices")


def reach(suffix, lengths, tables: FinalsTables, q: int) -> torch.Tensor:
    """gj [T, Q, Gf] bool from the suffix columns and descriptors."""
    sfx = suffix != 0
    iota = torch.arange(q, dtype=torch.int32, device=suffix.device)[None, :]
    len1 = 1 + lengths.to(torch.int32)[:, None]
    rows = [group_reach(sfx[:, :, int(col)], int(nl), int(nr), bool(a), iota, len1)
            for col, nl, nr, a in tables.desc_np]
    if not rows:
        return torch.zeros((suffix.shape[0], q, 0), dtype=torch.bool, device=suffix.device)
    return torch.stack(rows, dim=-1)


def finals_match_plain(embed, suffix, lengths, tables: FinalsTables, *, q: int) -> torch.Tensor:
    """Plain PyTorch twin of ``cko_finals_match``: reachability, conv,
    threshold, AND, any over Q. Operands as ``finals_match``'s."""
    _check(embed, suffix, lengths, tables, q)
    t, _, c = embed.shape
    nf, w = tables.nf, tables.w
    out = torch.zeros((t, nf), dtype=torch.bool, device=embed.device)
    if t == 0 or nf == 0 or c == 0:  # no channel: every score is 0 < 2W
        return out
    # float32: the operands are small integers and every partial sum is an
    # integer far below 2^24, exact in float32 and in TF32.
    wt = tables.weights.reshape(w, c, nf).permute(2, 1, 0).to(torch.float32).contiguous()  # [Nf, C, W]
    cg = tables.col_group.to(torch.int64)
    rows = max(1, _PLAIN_CHUNK_ELEMS // (q * max(nf, tables.gf)))
    for r0 in range(0, t, rows):
        x = embed[r0 : r0 + rows, : q + w - 1].permute(0, 2, 1).to(torch.float32)
        m = (F.conv1d(x, wt) >= 2 * w).permute(0, 2, 1)  # [rows, Q, Nf]
        gj = reach(suffix[r0 : r0 + rows], lengths[r0 : r0 + rows], tables, q)
        out[r0 : r0 + rows] = (m & gj[:, :, cg]).any(dim=1)
    return out


def _bytes(x: torch.Tensor) -> torch.Tensor:
    """A contiguous uint8 0/1 view (or copy) of a 0/1 tensor."""
    if x.dtype == torch.uint8:
        return x.contiguous()
    if x.dtype != torch.bool:
        x = x != 0
    return x.contiguous().view(torch.uint8)


def _r16(n: int) -> int:
    return (n + 15) // 16 * 16


def smem_bytes(qt: int, tables: FinalsTables, ns: int) -> int:
    """Shared memory of one kernel block at window-start tile ``qt``:
    the tile's embed words, the suffix columns' position masks (the tile
    plus ``d_max`` positions), the groups' reach masks and the row's hit
    bits, each section 16-byte aligned."""
    nw = (tables.c + 63) // 64
    cw = (qt + tables.d_max + 31) // 32
    return (_r16((qt + tables.w - 1) * nw * 8) + _r16(ns * cw * 4)
            + _r16(tables.gf * (qt // 32) * 4) + _r16((tables.nf + 31) // 32 * 4))


def q_tile(q: int, tables: FinalsTables, ns: int) -> int:
    """Window starts per kernel pass over a row: all of Q up to
    ``Q_TILE_MAX`` (a multiple of 32), halved while the block's shared
    memory would exceed ``SMEM_CAP``."""
    qt = min(Q_TILE_MAX, (max(q, 1) + 31) // 32 * 32)
    while qt > 32 and smem_bytes(qt, tables, ns) > SMEM_CAP:
        qt = max(32, qt // 2 // 32 * 32)
    if smem_bytes(qt, tables, ns) > SMEM_CAP:
        raise ValueError(f"finals_match: {tables.gf} groups and {ns} suffix columns exceed shared memory")
    return qt


def finals_match(embed, suffix, lengths, tables: FinalsTables, *, q: int) -> torch.Tensor:
    """[T, Nf] bool: column n of row t matched at some reachable window
    start. CPU tensors take ``finals_match_plain``; CUDA tensors launch
    ``cko_finals_match``; other devices raise."""
    global LAUNCHES
    dev = embed.device
    if dev.type == "cpu":
        return finals_match_plain(embed, suffix, lengths, tables, q=q)
    if dev.type != "cuda":
        raise ValueError(f"finals_match: unsupported device {dev}")
    _check(embed, suffix, lengths, tables, q)
    t, lp, c = embed.shape
    ns = suffix.shape[2]
    out = torch.empty((t, tables.nf), dtype=torch.bool, device=dev)
    if t == 0 or tables.nf == 0:
        return out
    e = _bytes(embed)
    s = _bytes(suffix)
    if s.data_ptr() % 16:  # the kernel reads the suffix rows in 16-byte loads
        s = s.clone()
    lens = lengths.to(torch.int32).contiguous()
    qt = q_tile(q, tables, ns)
    p = kernels.ptr
    i = ctypes.c_int
    args = [
        p(e), p(s), p(lens), p(tables.kbits), p(tables.thr), p(tables.desc), p(tables.col_group),
        i(t), i(lp), i(c), i(q), i(ns), i(tables.w), i(tables.gf), i(tables.nf), i(qt),
        i(tables.d_max), i(smem_bytes(qt, tables, ns)), p(out), kernels.stream_ptr(dev),
    ]
    fn = kernels.function("segment_finals", "cko_finals_match", [type(a) for a in args])
    kernels.check(fn(*args), "segment_finals", "cko_finals_match")
    LAUNCHES += 1
    return out
