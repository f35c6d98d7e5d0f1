"""Flat-slot fused multi-bank DFA scan (PyTorch + CUDA).

Port of ``coraza_kubernetes_operator_tpu/ops/dfa_flat.py``. Many
heterogeneous-S banks are fused into ONE scan by flattening every
(group, local state) pair into one slot axis: slot n holds group
``g(n)``'s local state ``n - base_g``; each table segment covers one
(pipeline, dtype-class) run of slots. The reference spells a byte step as
three one-hot matmuls over the slot axis (the MXU form); here:

- ``scan_flat_bank`` — dispatch: CUDA tensors launch the hand-written
  kernel ``cko_scan_flat`` (``csrc/dfa_scan.cu``): one block per (row
  tile, group) stages the group's own [256, S_g] table in shared memory
  once for up to 1024 rows, stages the tile's bytes from the group's own
  pipeline [B, L] as they are, and walks several rows per thread with
  their chains interleaved. Each launch reads at most ``MAX_PIPES``
  pipelines (a bin over more is split by pipeline). CPU tensors take
  ``scan_flat_xla``.
- ``scan_flat_xla`` — the plain PyTorch twin (name kept from the
  reference): per byte step one index gather per (row, group) at column
  ``base_g + state`` of the concatenated slot table.

The bin planner and bank layout keep the reference's TPU budgets and
dtypes (bf16 segments when 2S <= 256, else f32; bf16 sel/bcast), so a bin
is array-equal to the JAX package's and ``match_tier`` stitches the same
column order.
"""

from __future__ import annotations

import ctypes
import os as _os
from dataclasses import dataclass, field

import numpy as np
import torch

from ..compiler.re_dfa import DFA
from ..utils.device import resolve_device
from . import kernels
from .dfa import MAX_PIPES, SMEM_CAP, _check_batch, _check_on, i32_rows, pipe_structs, r16, split_launches

_LANE = 128
_FLAT_VMEM_BUDGET = int(_os.environ.get("CKO_FLAT_VMEM_MB", "15")) * 2**20
_BLOCK_B = 128
_DEAD_S = float(2**30)  # pad-group state count: hit threshold never reached
_PALLAS_MAX_LEN = int(_os.environ.get("CKO_FLAT_MAX_LEN", "2048"))

# Launches of ``cko_scan_flat`` (the wrapper counts each one).
LAUNCHES = 0

_THREADS = 256  # threads per kernel block
_TILE_BYTES = 96 * 1024  # shared bytes of a block's staged row tile


def _round_up(n: int, m: int) -> int:
    return (n + m - 1) // m * m


@dataclass
class FlatLayout:
    """Kernel-side layout of a bin: per group its int16 [256, S_g] slice of
    the slot table, each 16-byte aligned, and a record per group."""

    tab: torch.Tensor  # int16, per group [256, S_g] tables
    grp_info: torch.Tensor  # [G, 3] int32: table offset, S, end-match offset
    mend: torch.Tensor  # uint8, concatenated [S_g] end-match flags
    always: torch.Tensor  # [G] uint8
    grp_slot: tuple  # per group: its input slot (index into pipeline_ids)
    tab_bytes: tuple  # per group: its padded table bytes
    launches: tuple  # per launch: (first input slot, [n, 2] int32 (group, slot local))


@dataclass
class FlatBank:
    """One fused scan bin: N slots over G groups, table segmented by
    (pipeline, dtype-class) runs along the slot axis."""

    tables: tuple  # per segment: [256, N_seg] bf16 or f32 (N_seg % 128 == 0)
    sel: torch.Tensor  # [N, Gp] bf16 0/1: slot -> its group column
    bcast: torch.Tensor  # [Gp, N] bf16 0/1: group -> its slots
    init_sigma: torch.Tensor  # [1, N] f32: one-hot of each group's state 0
    mend: torch.Tensor  # [1, N] f32: 1 when the slot's state is match_end
    base_g: torch.Tensor  # [1, Gp] f32 slot base per group
    s_g: torch.Tensor  # [1, Gp] f32 state count per group (hit threshold)
    always: torch.Tensor  # [G] bool (unpadded)
    # static
    seg_pipes: tuple = ()  # pipeline id per table segment
    seg_slots: tuple = ()  # padded slot count per table segment
    group_pipe: tuple = ()  # pipeline id per (real) group
    pieces: tuple = ()  # (block_index, g_lo, g_hi) per covered group run
    layout: FlatLayout | None = field(default=None, init=False, repr=False)

    def __post_init__(self):
        self.layout = flat_layout(self)

    @property
    def pipeline_ids(self) -> list[int]:
        return sorted(set(self.seg_pipes))

    @property
    def n_slots(self) -> int:
        return int(self.sel.shape[0])

    @property
    def n_groups(self) -> int:
        return int(self.always.shape[0])


def flat_layout(flat: FlatBank) -> FlatLayout:
    """Lay ``flat``'s slot table out per group for ``cko_scan_flat``."""
    g = flat.n_groups
    dev = flat.always.device
    slot_table = torch.cat([t.to(torch.int32) for t in flat.tables], dim=1)
    base = flat.base_g[0, :g].to(torch.int64).tolist()
    sizes = flat.s_g[0, :g].to(torch.int64).tolist()
    mend = (flat.mend[0] != 0).to(torch.uint8)
    slot_of = {p: i for i, p in enumerate(flat.pipeline_ids)}
    tabs, grp_info, mends, tab_bytes = [], [], [], []
    off = moff = 0
    for a, s in zip(base, sizes):
        if 2 * s - 1 > 32767:
            raise ValueError(f"state count {s} does not fit the int16 scan table")
        n = 256 * s
        pad = -n % 8  # each group's table starts 16-byte aligned
        t = slot_table[:, a : a + s].reshape(-1)
        tabs.append(torch.cat([t, t.new_zeros(pad)]).to(torch.int16))
        grp_info.append((off, s, moff))
        mends.append(mend[a : a + s])
        tab_bytes.append(2 * (n + pad))
        off += n + pad
        moff += s
    grp_slot = tuple(slot_of[p] for p in flat.group_pipe)
    return FlatLayout(
        tab=torch.cat(tabs).contiguous(),
        grp_info=i32_rows(grp_info, dev),
        mend=torch.cat(mends).contiguous(),
        always=flat.always.to(torch.uint8).contiguous(),
        grp_slot=grp_slot,
        tab_bytes=tuple(tab_bytes),
        launches=split_launches(list(enumerate(grp_slot)), 1, len(slot_of), dev),
    )


def flat_launch_shape(layout: FlatLayout, b: int, length: int, n_sms: int) -> tuple[int, int, int, int]:
    """(rows per thread R, byte columns per row tile, table bytes a block
    stages, block shared bytes) of one launch over ``b`` rows of width
    ``length`` on a card of ``n_sms`` SMs. R is the largest of 4, 2, 1 that
    still gives every SM a block, so a staged table serves as many rows as
    the card allows; the row tile holds at most ``_TILE_BYTES``."""
    groups = max(int(r.shape[0]) for _base, r in layout.launches)
    rpt = next(r for r in (4, 2, 1) if r == 1 or -(-b // (_THREADS * r)) * groups >= n_sms)
    rows = _THREADS * rpt
    cols = min(256, r16(max(length, 1)), (_TILE_BYTES // rows - 4) // 16 * 16)
    rest = r16(rows * (cols + 4)) + 16
    tab = max((t for t in layout.tab_bytes if t <= SMEM_CAP - rest), default=0)
    return rpt, cols, tab, tab + rest


def flat_vmem_bytes(
    n_slots: int, n_groups: int, table_bytes: int, length: int, n_pipes: int = 2
) -> int:
    """Resident-set estimate of the reference's TPU fused kernel (kept so
    the bins match the reference layout)."""
    n = _round_up(max(1, n_slots), _LANE)
    g = _round_up(max(1, n_groups), _LANE)
    consts = table_bytes + n * g * 2 * 2 + 4 * 4 * n + 4 * 4 * g
    work = _BLOCK_B * n * 20
    work_g = _BLOCK_B * g * 4 * 6
    data_tile = length * _BLOCK_B * 4 * 2 * max(1, n_pipes)
    return consts + work + work_g + data_tile


def _dfa_table_bytes(d: DFA) -> int:
    return 256 * _round_up(d.n_states, 1) * (2 if 2 * d.n_states <= 256 else 4)


def _layout_stats(pieces) -> tuple[int, int, int, int]:
    """(padded_slots, groups, table_bytes, n_pipes) exactly as
    ``build_flat_bank`` will lay this piece list out."""
    total = 0
    run_slots = 0
    prev = None
    groups = 0
    tbytes = 0
    pipes = set()
    for _blk, pid, _lo, _hi, ds in pieces:
        pipes.add(pid)
        for d in ds:
            key = (pid, 2 * d.n_states <= 256)
            if prev is not None and key != prev and run_slots:
                total += _round_up(run_slots, _LANE)
                run_slots = 0
            prev = key
            run_slots += d.n_states
            groups += 1
            tbytes += _dfa_table_bytes(d)
    total += _round_up(run_slots, _LANE)
    return total, groups, tbytes, max(1, len(pipes))


def plan_flat_bins(
    bank_dfas: list[tuple[int, int, list[DFA]]],
    max_slots: int = 6144,
    budget: int = _FLAT_VMEM_BUDGET,
    length_hint: int = _PALLAS_MAX_LEN,
) -> tuple[list[list[tuple[int, int, int, int, list[DFA]]]], set[int]]:
    """Greedy bin-packing of (block_index, pipeline, dfas) banks into
    fused bins; oversized banks split by group ranges. Returns (bins,
    rejected_blocks) — rejected blocks stay on the per-bank scan path."""
    rejected: set[int] = set()
    for block_idx, _pid, dfas in bank_dfas:
        for d in dfas:
            if (
                flat_vmem_bytes(
                    _round_up(d.n_states, _LANE), 1, _dfa_table_bytes(d),
                    length_hint, 1,
                )
                > budget
            ):
                rejected.add(block_idx)
                break

    def fits(pieces: list) -> bool:
        slots, groups, tbytes, pipes = _layout_stats(pieces)
        return (
            slots <= max_slots
            and flat_vmem_bytes(slots, groups, tbytes, length_hint, pipes)
            <= budget
        )

    pieces: list[tuple[int, int, int, int, list[DFA]]] = []
    for block_idx, pid, dfas in bank_dfas:
        if block_idx in rejected:
            continue
        start = 0
        cur: list[DFA] = []
        for gi, d in enumerate(dfas):
            if cur and not fits([(block_idx, pid, start, gi, cur + [d])]):
                pieces.append((block_idx, pid, start, gi, cur))
                start, cur = gi, []
            cur.append(d)
        if cur:
            pieces.append((block_idx, pid, start, start + len(cur), cur))

    bins: list[list[tuple[int, int, int, int, list[DFA]]]] = []
    by_pid: dict[int, list] = {}
    for p in pieces:
        by_pid.setdefault(p[1], []).append(p)
    for pid in sorted(by_pid):
        cur_bin: list = []
        for p in by_pid[pid]:
            if cur_bin and not fits(cur_bin + [p]):
                bins.append(cur_bin)
                cur_bin = []
            cur_bin.append(p)
        if cur_bin:
            bins.append(cur_bin)

    # Second pass: merge small bins across pipelines while the union fits.
    bins.sort(key=lambda bn: _layout_stats(bn)[0])
    merged: list[list] = []
    for bn in bins:
        placed = False
        for mb in merged:
            if fits(mb + bn):
                mb.extend(bn)
                placed = True
                break
        if not placed:
            merged.append(list(bn))
    return merged, rejected


def build_flat_bank(
    bin_pieces: list[tuple[int, int, int, int, list[DFA]]], device=None
) -> FlatBank:
    """Lay one bin out as tensors on ``device``."""
    device = resolve_device(device)
    entries: list[tuple[DFA, int]] = []  # (dfa, pid) in slot/group order
    pieces_static = []
    for block_idx, pid, g_lo, g_hi, ds in bin_pieces:
        pieces_static.append((block_idx, g_lo, g_hi))
        for d in ds:
            entries.append((d, pid))

    # Segment runs: consecutive entries sharing (pid, bf16-class).
    def klass(d: DFA) -> bool:
        return 2 * d.n_states <= 256

    runs: list[tuple[int, bool, list[DFA]]] = []
    for d, pid in entries:
        kc = klass(d)
        if runs and runs[-1][0] == pid and runs[-1][1] == kc:
            runs[-1][2].append(d)
        else:
            runs.append((pid, kc, [d]))

    g_total = len(entries)
    gp_total = _round_up(g_total, _LANE)
    n_total = sum(_round_up(sum(d.n_states for d in ds), _LANE) for _, _, ds in runs)

    sel = np.zeros((n_total, gp_total), dtype=np.float32)
    init_sigma = np.zeros((1, n_total), dtype=np.float32)
    mend = np.zeros((1, n_total), dtype=np.float32)
    base_g = np.zeros((1, gp_total), dtype=np.float32)
    s_g = np.full((1, gp_total), _DEAD_S, dtype=np.float32)
    always = np.zeros(g_total, dtype=bool)
    group_pipe: list[int] = []

    tables: list[torch.Tensor] = []
    seg_pipes: list[int] = []
    seg_slots: list[int] = []
    off = 0
    gi = 0
    for pid, kc, ds in runs:
        seg_n_raw = sum(d.n_states for d in ds)
        seg_n = _round_up(seg_n_raw, _LANE)
        tab = np.zeros((256, seg_n), dtype=np.float32)
        seg_off = 0
        for d in ds:
            s = d.n_states
            tab[:, seg_off : seg_off + s] = (
                d.trans[:, d.classmap] + s * d.emit[:, d.classmap].astype(np.int64)
            ).T
            a = off + seg_off
            sel[a : a + s, gi] = 1.0
            init_sigma[0, a] = 1.0
            mend[0, a : a + s] = d.match_end.astype(np.float32)
            base_g[0, gi] = a
            s_g[0, gi] = s
            always[gi] = d.always_match
            group_pipe.append(pid)
            gi += 1
            seg_off += s
        tj = torch.as_tensor(tab, device=device)
        if kc:
            tj = tj.to(torch.bfloat16)
        tables.append(tj)
        seg_pipes.append(pid)
        seg_slots.append(seg_n)
        off += seg_n

    def put(a):
        return torch.as_tensor(a, device=device)

    return FlatBank(
        tables=tuple(tables),
        sel=put(sel).to(torch.bfloat16),
        bcast=put(np.ascontiguousarray(sel.T)).to(torch.bfloat16),
        init_sigma=put(init_sigma),
        mend=put(mend),
        base_g=put(base_g),
        s_g=put(s_g),
        always=put(always),
        seg_pipes=tuple(seg_pipes),
        seg_slots=tuple(seg_slots),
        group_pipe=tuple(group_pipe),
        pieces=tuple(pieces_static),
    )


def _check_pipes(flat: FlatBank, data_by_pipe, where: str) -> torch.Tensor:
    """Validate the bin's per-pipeline inputs; returns the first data."""
    pids = flat.pipeline_ids
    d0 = data_by_pipe[pids[0]][0]
    for p in pids:
        d, ln = data_by_pipe[p]
        _check_batch(d, ln, where)
        if d.shape != d0.shape or d.device != d0.device:
            raise ValueError(f"{where}: pipeline buffers differ in shape or device")
    return d0


def _stack_pipes(flat: FlatBank, data_by_pipe, where: str):
    """[P, B, L] bytes and [P, B] lengths for the bin's pipelines."""
    _check_pipes(flat, data_by_pipe, where)
    pids = flat.pipeline_ids
    data = torch.stack([data_by_pipe[p][0] for p in pids])  # [P, B, L]
    lens = torch.stack([data_by_pipe[p][1].to(torch.int32) for p in pids])  # [P, B]
    return data, lens


def scan_flat_xla(flat: FlatBank, data_by_pipe: dict) -> torch.Tensor:
    """Plain twin of ``cko_scan_flat``: per byte step one index gather per
    (row, group) at column ``base_g + state`` of the concatenated slot
    table, with each group reading its own pipeline's byte."""
    data, lens = _stack_pipes(flat, data_by_pipe, "scan_flat_xla")
    g = flat.n_groups
    dev = data.device
    slot_table = torch.cat([t.to(torch.int64) for t in flat.tables], dim=1)  # [256, N]
    n = slot_table.shape[1]
    tab = slot_table.reshape(-1)
    base = flat.base_g[0, :g].to(torch.int64)[None, :]
    s_g = flat.s_g[0, :g].to(torch.int64)[None, :]
    pipe = torch.as_tensor(flat.layout.grp_slot, dtype=torch.int64, device=dev)
    bytes_g = data.to(torch.int64)[pipe]  # [G, B, L]
    lens_g = lens.to(torch.int64)[pipe].t()  # [B, G]

    b, length = data.shape[1], data.shape[2]
    state = torch.zeros((b, g), dtype=torch.int64, device=dev)
    matched = torch.zeros((b, g), dtype=torch.bool, device=dev)
    for t in range(length):
        val = tab[bytes_g[:, :, t].t() * n + base + state]
        hit = val >= s_g
        active = t < lens_g
        matched |= hit & active
        state = torch.where(active, val - s_g * hit.to(torch.int64), state)
    mend = (flat.mend[0] != 0).reshape(-1)
    end_hit = mend[base + state]
    return matched | end_hit | flat.always[None, :]


def scan_flat_bank(flat: FlatBank, data_by_pipe: dict) -> torch.Tensor:
    """Fused scan of one bin. ``data_by_pipe`` maps each pipeline id of
    the bin to its transformed ``(data [B, L] uint8, lengths [B])``.
    Returns matched [B, G_bin] bool.

    CPU tensors take the plain twin; CUDA tensors launch ``cko_scan_flat``
    (once per ``MAX_PIPES`` pipelines of the bin)."""
    global LAUNCHES
    d0 = _check_pipes(flat, data_by_pipe, "scan_flat_bank")
    dev = d0.device
    if dev.type == "cpu":
        return scan_flat_xla(flat, data_by_pipe)
    if dev.type != "cuda":
        raise ValueError(f"scan_flat_bank: unsupported device {dev}")
    _check_on(flat.sel, dev, "scan_flat_bank")
    lay = flat.layout
    b, length = d0.shape
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rpt, cols, tab_smem, smem = flat_launch_shape(lay, b, length, sms)
    structs, _keep = pipe_structs([data_by_pipe[p] for p in flat.pipeline_ids])
    out = torch.empty((b, flat.n_groups), dtype=torch.bool, device=dev)
    p, i = kernels.ptr, ctypes.c_int
    stream = kernels.stream_ptr(dev)
    for base, recs in lay.launches:
        args = [
            structs[base // MAX_PIPES], i(b), i(length), i(cols), i(rpt), p(lay.tab), p(recs),
            p(lay.grp_info), p(lay.mend), p(lay.always), i(tab_smem), i(smem), i(recs.shape[0]),
            p(out), i(flat.n_groups), stream,
        ]
        fn = kernels.function("dfa_scan", "cko_scan_flat", [type(a) for a in args])
        kernels.check(fn(*args), "dfa_scan", "cko_scan_flat")
    LAUNCHES += len(lay.launches)
    return out
