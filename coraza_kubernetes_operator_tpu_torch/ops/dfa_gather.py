"""DFA hot tier: byte-class-packed transition-gather banks (PyTorch + CUDA).

Port of ``coraza_kubernetes_operator_tpu/ops/dfa_gather.py``. The
two-level automata engine compiles groups whose minimized DFAs are small
into *joint-byte-class* dense tables: a bank-wide joint byte-class
partition (``compiler/re_dfa.joint_classmap``) maps bytes onto C ≪ 256
classes, so the resident table is ``[C, S*G]``.

- ``scan_gather_tier`` — dispatch for every dfa-hot bank of a model in
  ONE launch: CUDA tensors launch the hand-written kernel
  ``cko_scan_gather`` (``csrc/dfa_scan.cu``: a block per (row tile,
  bank) stages the bank's class map and tables in shared memory, maps
  each byte of its row tile to its class once, and walks the bank's
  groups over that class sequence); CPU tensors take
  ``scan_gather_tier_plain``. Banks the kind mask turns off give zeros.
- ``scan_gather_tier_plain`` — the plain twin: ``scan_gather_bank_jnp``
  per mask-on bank, zeros for the others, concatenated in bank order.
- ``scan_gather_bank`` — one bank: the fused path with a one-bank tier.
- ``scan_gather_bank_jnp`` — the plain PyTorch twin of one bank (name
  kept from the reference): per byte step a classmap gather, then one
  index gather from ``tC`` per (row, group).

Bank packing (``plan_gather_bins``) keeps the reference's TPU budgets, so
the bank layout is array-equal to the JAX package's; ``GatherTier`` lays
the banks out once, at model build, for the fused launch.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass, field

import numpy as np
import torch

from ..compiler.re_dfa import DFA, joint_class_count, joint_classmap
from ..utils.device import resolve_device
from . import kernels
from .dfa import _check_batch, _check_on, _dense_dtype, _scan_loop

_LANE = 128
# Reference planning budgets (ops/dfa.py there): the bins are laid out
# exactly as the JAX package lays them out.
_PALLAS_VMEM_BUDGET = 11 * 2**20
_PALLAS_BLOCK_B = 128

# Greedy bin cap on joint classes.
_MAX_JOINT_CLASSES = 120

# Launches of ``cko_scan_gather`` (the wrapper counts each one).
LAUNCHES = 0

# Pipelines one fused launch reads (the kernel's by-value parameter struct).
MAX_PIPES = 8
# Rows per kernel block, and the byte columns of a row tile staged at once.
_ROWS = 128
_MAX_COLS = 256
# Dynamic shared memory one block may use on Hopper (227 KB).
_SMEM_CAP = 232448


class _Pipes(ctypes.Structure):
    """``GatherPipes`` of ``csrc/dfa_scan.cu``: per pipeline slot the base
    of its [B, L] bytes and of its [B] lengths, passed by value."""

    _fields_ = [("data", ctypes.c_void_p * MAX_PIPES), ("lens", ctypes.c_void_p * MAX_PIPES)]


@dataclass
class GatherBank:
    """G stacked hot-tier DFAs sharing one joint byte-class partition."""

    tC: torch.Tensor  # [C, S*G] dense: next + S*emit (slot j = s*G + g)
    classmap: torch.Tensor  # [256] int32 — joint byte -> class
    match_end: torch.Tensor  # [G, S] bool
    always: torch.Tensor  # [G] bool
    _tier: GatherTier | None = field(default=None, init=False, repr=False, compare=False)

    @property
    def tier(self) -> GatherTier:
        """This bank alone, laid out for the fused kernel (built once)."""
        if self._tier is None:
            self._tier = build_gather_tier([self], (0,))
        return self._tier

    @property
    def n_groups(self) -> int:
        return int(self.match_end.shape[0])

    @property
    def n_states(self) -> int:
        return int(self.match_end.shape[1])

    @property
    def n_classes(self) -> int:
        return int(self.tC.shape[0])


def stack_gather_bank(dfas: list[DFA], min_states: int = 1, device=None) -> GatherBank:
    """Stack hot-tier DFAs into one joint-class packed bank."""
    device = resolve_device(device)
    g = len(dfas)
    s_max = max(min_states, max(d.n_states for d in dfas))
    classmap, remaps = joint_classmap(dfas)
    c = int(classmap.max()) + 1
    match_end = np.zeros((g, s_max), dtype=bool)
    always = np.zeros(g, dtype=bool)
    dense = np.zeros((c, s_max, g), dtype=np.int32)
    for i, (d, remap) in enumerate(zip(dfas, remaps)):
        s = d.n_states
        match_end[i, :s] = d.match_end
        always[i] = d.always_match
        per_class_next = d.trans[:, remap]  # [S, C]
        per_class_emit = d.emit[:, remap]  # [S, C]
        # Padded states self-loop to 0 and never activate.
        dense[:, :s, i] = (
            per_class_next + s_max * per_class_emit.astype(np.int32)
        ).T
    tc = dense.reshape(c, s_max * g).astype(_dense_dtype(s_max))
    return GatherBank(
        tC=torch.as_tensor(tc, device=device),
        classmap=torch.as_tensor(np.asarray(classmap, dtype=np.int32), device=device),
        match_end=torch.as_tensor(match_end, device=device),
        always=torch.as_tensor(always, device=device),
    )


@dataclass
class GatherTier:
    """Every dfa-hot bank of a model laid out for one fused launch: the
    flat bin's per-group layout applied to the gather banks."""

    banks: list  # the GatherBanks, in column order
    pipelines: tuple  # pipeline id of each input slot
    pipe_slot: tuple  # per bank: its input slot
    tab: torch.Tensor  # int16: per bank its groups' [C, S] tables, banks 16-byte aligned
    bank_info: torch.Tensor  # [NB, 5] int32: first group, groups, table offset, elements, slot
    grp_info: torch.Tensor  # [G, 3] int32: table offset inside its bank, S, end-match offset
    mend: torch.Tensor  # uint8, concatenated [S] end-match flags per group
    always: torch.Tensor  # [G] uint8
    cmaps: torch.Tensor  # [NB, 256] uint8 byte -> class per bank
    tab_bytes: tuple  # per bank: its padded table bytes
    _on: dict = field(default_factory=dict, repr=False, compare=False)

    @property
    def n_groups(self) -> int:
        return int(self.always.shape[0])

    @property
    def max_groups(self) -> int:
        return max(b.n_groups for b in self.banks)

    def on_groups(self, on: tuple) -> torch.Tensor:
        """[G] uint8 on/off per group for per-bank flags ``on`` (cached)."""
        t = self._on.get(on)
        if t is None:
            flags = [f for bank, f in zip(self.banks, on) for _ in range(bank.n_groups)]
            t = self._on[on] = torch.tensor(flags, dtype=torch.uint8, device=self.always.device)
        return t


def build_gather_tier(banks: list, bank_pipelines) -> GatherTier:
    """Lay out ``banks`` (pipeline id ``bank_pipelines[i]`` each) for
    ``scan_gather_tier``: int16 tables concatenated per bank, class maps,
    and a record per group."""
    dev = banks[0].always.device
    pipelines = tuple(dict.fromkeys(bank_pipelines))
    tabs, bank_info, grp_info, mends, tab_bytes = [], [], [], [], []
    off = g0 = moff = 0
    for bank, pid in zip(banks, bank_pipelines):
        s, g, c = bank.n_states, bank.n_groups, bank.n_classes
        if 2 * s - 1 > 32767:
            raise ValueError(f"state count {s} does not fit the int16 scan table")
        t3 = bank.tC.to(torch.int32).reshape(c, s, g).permute(2, 0, 1)  # [G, C, S]
        n = g * c * s
        pad = -n % 8  # each bank's table starts 16-byte aligned
        tabs.append(torch.cat([t3.reshape(-1), t3.new_zeros(pad)]).to(torch.int16))
        bank_info.append((g0, g, off, n, pipelines.index(pid)))
        for gi in range(g):
            grp_info.append((gi * c * s, s, moff))
            moff += s
        mends.append(bank.match_end.to(torch.uint8).reshape(-1))
        tab_bytes.append(2 * (n + pad))
        off += n + pad
        g0 += g
    if off >= 2**31:
        raise ValueError("gather tier tables exceed int32 offsets")

    def i32(rows):
        return torch.as_tensor(np.asarray(rows, dtype=np.int32).reshape(len(rows), -1), device=dev)

    return GatherTier(
        banks=list(banks),
        pipelines=pipelines,
        pipe_slot=tuple(int(b[4]) for b in bank_info),
        tab=torch.cat(tabs).contiguous(),
        bank_info=i32(bank_info),
        grp_info=i32(grp_info),
        mend=torch.cat(mends).contiguous(),
        always=torch.cat([b.always.to(torch.uint8) for b in banks]).contiguous(),
        cmaps=torch.stack([b.classmap.to(torch.uint8) for b in banks]).contiguous(),
        tab_bytes=tuple(tab_bytes),
    )


def _r16(n: int) -> int:
    return (n + 15) // 16 * 16


def gather_smem(tier: GatherTier, length: int) -> tuple[int, int, int]:
    """(byte columns per row tile, table bytes a block stages, block shared
    bytes) of one launch at row width ``length``. The staged table is the
    largest bank table that fits beside the row tile; larger ones are read
    from global memory (L2)."""
    cols = min(_MAX_COLS, _r16(max(length, 1)))
    g = tier.max_groups  # per row: an int16 state and a match flag per group
    rest = 256 + _r16(cols * (_ROWS + 4)) + _r16(_ROWS * g * 2) + _r16(_ROWS * g) + 16
    if rest > _SMEM_CAP:
        raise ValueError(f"scan_gather_tier: {tier.max_groups} groups in one bank exceed shared memory")
    tab = max((b for b in tier.tab_bytes if b <= _SMEM_CAP - rest), default=0)
    return cols, tab, tab + rest


def _gather_vmem_bytes(s: int, g: int, c: int, itemsize: int, length: int) -> int:
    """Resident working-set estimate of the reference's TPU gather kernel
    (kept so the bins match the reference layout)."""
    gp = (g + _LANE - 1) // _LANE * _LANE
    cp = (c + _LANE - 1) // _LANE * _LANE
    cls256 = 256 * cp * itemsize
    table = cp * s * gp * itemsize
    work = _PALLAS_BLOCK_B * s * gp * 4 * 2 + _PALLAS_BLOCK_B * cp * 4
    data_tile = length * _PALLAS_BLOCK_B * 4 * 2
    return cls256 + table + work + data_tile


def plan_gather_bins(dfas: list[DFA], length_hint: int = 512) -> list[list[int]]:
    """Greedy packing of hot-tier DFAs into gather banks. Returns index
    bins (into ``dfas``); each bin becomes one ``GatherBank``."""
    order = sorted(range(len(dfas)), key=lambda i: (dfas[i].n_states, i))
    bins: list[list[int]] = []
    for idx in order:
        placed = False
        for bin_ in bins:
            cand = [dfas[i] for i in bin_] + [dfas[idx]]
            c = joint_class_count(cand)
            if c > _MAX_JOINT_CLASSES:
                continue
            s = max(d.n_states for d in cand)
            dt = _dense_dtype(s)
            if (
                _gather_vmem_bytes(s, len(cand), c, np.dtype(dt).itemsize, length_hint)
                > _PALLAS_VMEM_BUDGET
            ):
                continue
            bin_.append(idx)
            placed = True
            break
        if not placed:
            bins.append([idx])
    # Deterministic model layout: bins ordered by first member gid.
    for bin_ in bins:
        bin_.sort()
    bins.sort(key=lambda b: b[0])
    return bins


def _check_inputs(tier: GatherTier, inputs, on, where: str) -> tuple[int, int, torch.device]:
    """Validate the per-slot inputs; returns (B, L, device)."""
    if len(inputs) != len(tier.pipelines) or len(on) != len(tier.banks):
        raise ValueError(f"{where}: {len(inputs)} inputs / {len(on)} flags for "
                         f"{len(tier.pipelines)} pipelines / {len(tier.banks)} banks")
    given = [x for x in inputs if x is not None]
    for slot, flag in zip(tier.pipe_slot, on):
        if flag and inputs[slot] is None:
            raise ValueError(f"{where}: a mask-on bank reads pipeline slot {slot}, given None")
    if not given:
        raise ValueError(f"{where}: no input")
    for data, lengths in given:
        _check_batch(data, lengths, where)
        if data.shape != given[0][0].shape or data.device != given[0][0].device:
            raise ValueError(f"{where}: pipeline inputs differ in shape or device")
    b, length = given[0][0].shape
    return b, length, given[0][0].device


def scan_gather_tier(tier: GatherTier, inputs, on) -> torch.Tensor:
    """Scan every bank of ``tier`` in one launch. ``inputs[k]`` is pipeline
    slot k's ``(data [B, L] uint8, lengths [B])`` (None where no mask-on
    bank reads it); ``on[i]`` turns bank i on. Returns matched [B, G] bool
    in bank order, zeros for banks that are off.

    CPU tensors take ``scan_gather_tier_plain``; CUDA tensors launch
    ``cko_scan_gather`` once (none when every bank is off)."""
    global LAUNCHES
    on = tuple(bool(f) for f in on)
    b, length, dev = _check_inputs(tier, inputs, on, "scan_gather_tier")
    if dev.type == "cpu":
        return scan_gather_tier_plain(tier, inputs, on)
    if dev.type != "cuda":
        raise ValueError(f"scan_gather_tier: unsupported device {dev}")
    _check_on(tier.tab, dev, "scan_gather_tier")
    if len(tier.pipelines) > MAX_PIPES:
        raise ValueError(f"scan_gather_tier: {len(tier.pipelines)} pipelines, at most {MAX_PIPES}")
    if not any(on):
        return torch.zeros((b, tier.n_groups), dtype=torch.bool, device=dev)
    pipes = _Pipes()
    keep = []  # the tensors whose pointers the launch reads
    for k, x in enumerate(inputs):
        if x is not None:
            data, lens = x[0].contiguous(), x[1].to(torch.int32).contiguous()
            keep.append((data, lens))
            pipes.data[k], pipes.lens[k] = data.data_ptr(), lens.data_ptr()
    cols, tab_smem, smem = gather_smem(tier, length)
    out = torch.empty((b, tier.n_groups), dtype=torch.bool, device=dev)
    p, i = kernels.ptr, ctypes.c_int
    args = [
        pipes, i(b), i(length), i(cols), p(tier.tab), p(tier.bank_info), p(tier.grp_info),
        p(tier.mend), p(tier.always), p(tier.cmaps), p(tier.on_groups(on)), i(tab_smem),
        i(smem), i(len(tier.banks)), i(tier.max_groups), p(out), i(tier.n_groups),
        kernels.stream_ptr(dev),
    ]
    fn = kernels.function("dfa_scan", "cko_scan_gather", [type(a) for a in args])
    kernels.check(fn(*args), "dfa_scan", "cko_scan_gather")
    LAUNCHES += 1
    return out


def scan_gather_tier_plain(tier: GatherTier, inputs, on) -> torch.Tensor:
    """Plain twin of ``cko_scan_gather``: ``scan_gather_bank_jnp`` on each
    mask-on bank, zeros for the others, concatenated in bank order."""
    b, _length, dev = _check_inputs(tier, inputs, on, "scan_gather_tier_plain")
    cols = [
        scan_gather_bank_jnp(bank, *inputs[slot]) if flag
        else torch.zeros((b, bank.n_groups), dtype=torch.bool, device=dev)
        for bank, slot, flag in zip(tier.banks, tier.pipe_slot, on)
    ]
    return torch.cat(cols, dim=1)


def scan_gather_bank(bank: GatherBank, data: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Scan ``data`` [B, L] uint8 (zero-padded past ``lengths`` [B])
    against every hot-tier DFA in the bank. Returns matched [B, G] bool.

    CPU tensors take the plain twin; CUDA tensors launch ``cko_scan_gather``
    with the bank as a one-bank tier."""
    _check_batch(data, lengths, "scan_gather_bank")
    if data.device.type == "cpu":
        return scan_gather_bank_jnp(bank, data, lengths)
    if data.device.type != "cuda":
        raise ValueError(f"scan_gather_bank: unsupported device {data.device}")
    _check_on(bank.tC, data.device, "scan_gather_bank")
    return scan_gather_tier(bank.tier, [(data, lengths)], (True,))


def scan_gather_bank_jnp(bank: GatherBank, data: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Plain twin of ``cko_scan_gather``: per byte step a joint-classmap
    gather, then one index gather from ``tC`` per (row, group)."""
    s, g = bank.n_states, bank.n_groups
    flat = bank.tC.to(torch.int64).reshape(-1)  # [C * S * G]
    classmap = bank.classmap.to(torch.int64)
    garange = torch.arange(g, dtype=torch.int64, device=data.device)[None, :]
    cols = data.to(torch.int64)

    def lookup(t, state):
        cls = classmap[cols[:, t : t + 1]]  # [B, 1]
        return flat[cls * (s * g) + state * g + garange], s

    matched, end_state = _scan_loop(data, lengths, lookup, g)
    return matched | bank.match_end[garange, end_state] | bank.always[None, :]
