"""Flat-slot fused multi-bank DFA scan (PyTorch + CUDA).

Port of ``coraza_kubernetes_operator_tpu/ops/dfa_flat.py``. Many
heterogeneous-S banks are fused into ONE scan by flattening every
(group, local state) pair into one slot axis: slot n holds group
``g(n)``'s local state ``n - base_g``; each table segment covers one
(pipeline, dtype-class) run of slots. The reference spells a byte step as
three one-hot matmuls over the slot axis (the MXU form); here:

- ``scan_flat_bank`` — dispatch: CUDA tensors launch the hand-written
  kernel ``cko_scan_flat`` (``csrc/dfa_scan.cu``): one block per (row
  block, group) stages the group's own [256, S_g] slice of its segment in
  shared memory and walks rows with the local state in a register; each
  group reads its own pipeline's bytes. CPU tensors take ``scan_flat_xla``.
- ``scan_flat_xla`` — the plain PyTorch twin (name kept from the
  reference): per byte step one index gather per (row, group) at column
  ``base_g + state`` of the concatenated slot table.

The bin planner and bank layout keep the reference's TPU budgets and
dtypes (bf16 segments when 2S <= 256, else f32; bf16 sel/bcast), so a bin
is array-equal to the JAX package's and ``match_tier`` stitches the same
column order.
"""

from __future__ import annotations

import os as _os
from dataclasses import dataclass, field

import numpy as np
import torch

from ..compiler.re_dfa import DFA
from ..utils.device import resolve_device
from . import kernels
from .dfa import ScanTables, _check_batch, _check_on, launch_scan, scan_tables

_LANE = 128
_FLAT_VMEM_BUDGET = int(_os.environ.get("CKO_FLAT_VMEM_MB", "15")) * 2**20
_BLOCK_B = 128
_DEAD_S = float(2**30)  # pad-group state count: hit threshold never reached
_PALLAS_MAX_LEN = int(_os.environ.get("CKO_FLAT_MAX_LEN", "2048"))

# Launches of ``cko_scan_flat`` (the wrapper counts each one).
LAUNCHES = 0


def _round_up(n: int, m: int) -> int:
    return (n + m - 1) // m * m


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
    kt: ScanTables | None = field(default=None, init=False, repr=False)
    k_pipe: torch.Tensor | None = field(default=None, init=False, repr=False)

    def __post_init__(self):
        g = self.n_groups
        slot_table = torch.cat([t.to(torch.int32) for t in self.tables], dim=1)
        base = self.base_g[0, :g].to(torch.int64).tolist()
        sizes = self.s_g[0, :g].to(torch.int64).tolist()
        mend = self.mend[0] != 0
        self.kt = scan_tables(
            [slot_table[:, a : a + s] for a, s in zip(base, sizes)],
            [mend[a : a + s] for a, s in zip(base, sizes)],
            self.always,
            n_rows=256,
        )
        pid_ix = {p: i for i, p in enumerate(self.pipeline_ids)}
        self.k_pipe = torch.as_tensor(
            [pid_ix[p] for p in self.group_pipe], dtype=torch.int32,
            device=self.always.device,
        )

    @property
    def pipeline_ids(self) -> list[int]:
        return sorted(set(self.seg_pipes))

    @property
    def n_slots(self) -> int:
        return int(self.sel.shape[0])

    @property
    def n_groups(self) -> int:
        return int(self.always.shape[0])


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


def _stack_pipes(flat: FlatBank, data_by_pipe, where: str):
    """[P, L, B] bytes and [P, B] lengths for the bin's pipelines."""
    pids = flat.pipeline_ids
    d0 = data_by_pipe[pids[0]][0]
    for p in pids:
        d, ln = data_by_pipe[p]
        _check_batch(d, ln, where)
        if d.shape != d0.shape or d.device != d0.device:
            raise ValueError(f"{where}: pipeline buffers differ in shape or device")
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
    pipe = flat.k_pipe.to(device=dev, dtype=torch.int64)
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

    CPU tensors take the plain twin; CUDA tensors launch ``cko_scan_flat``."""
    global LAUNCHES
    data, lens = _stack_pipes(flat, data_by_pipe, "scan_flat_bank")
    if data.device.type == "cpu":
        return scan_flat_xla(flat, data_by_pipe)
    if data.device.type != "cuda":
        raise ValueError(f"scan_flat_bank: unsupported device {data.device}")
    _check_on(flat.sel, data.device, "scan_flat_bank")
    dataT = data.transpose(1, 2).contiguous()  # [P, L, B]
    out = launch_scan(
        "cko_scan_flat", flat.kt, dataT, lens.contiguous(), flat.n_groups,
        extra=(kernels.ptr(flat.k_pipe),),
    )
    LAUNCHES += 1
    return out
