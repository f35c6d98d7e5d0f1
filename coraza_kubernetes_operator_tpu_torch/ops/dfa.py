"""Stacked-DFA batch scanner (PyTorch + CUDA).

Port of ``coraza_kubernetes_operator_tpu/ops/dfa.py``. A bank stacks G
compiled DFAs (``compiler/re_dfa.py``) into device tables and scans a
``[B, L]`` byte batch. Formulations:

- ``scan_dfa_bank`` — dispatch. On a CUDA tensor: the hand-written kernel
  ``cko_scan_dense`` (``csrc/dfa_scan.cu``), one shared-memory lookup per
  byte step. Banks with no dense table (S > 128, reached only by the
  long-buffer fallback) run ``scan_dfa_bank_gather``. On a CPU tensor:
  ``scan_dfa_bank_take``.
- ``scan_dfa_bank_take`` — the plain PyTorch twin of the kernel: per byte
  step one index gather from the dense table ``t256`` per (row, group).
- ``scan_dfa_bank_gather`` — the original two-gathers-per-byte form over
  the class-compressed table, kept as the semantic oracle.

Tables keep the reference layout (``t256`` [256, S*G], slot j = s*G + g,
value next + S*emit; int8 when 2S-1 <= 127 else float32), so a model
built here is array-equal to the JAX package's. The kernel reads its own
int16 copy, laid out [G][256][S], derived once per bank.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass, field

import numpy as np
import torch

from ..compiler.re_dfa import DFA
from ..utils.device import resolve_device
from . import kernels

_EMIT_SHIFT = 30
_STATE_MASK = (1 << _EMIT_SHIFT) - 1

# Launches of ``cko_scan_dense`` (the wrapper counts each one).
LAUNCHES = 0

# Shared memory a block may give one group's table; larger tables are read
# from global memory by the same kernel.
SMEM_TABLE_CAP = 200 * 1024


@dataclass
class ScanTables:
    """Kernel-side layout of a bank: per-group int16 tables, concatenated."""

    tab: torch.Tensor  # int16, concatenated [R, S_g] per group
    tab_off: torch.Tensor  # [G] int64 element offsets
    n_states: torch.Tensor  # [G] int32
    mend: torch.Tensor  # uint8, concatenated [S_g] end-match flags
    mend_off: torch.Tensor  # [G] int64
    always: torch.Tensor  # [G] uint8
    smem_bytes: int  # shared memory to reserve for one table


def scan_tables(tabs, mends, always, n_rows: int) -> ScanTables:
    """Lay out per-group tables ``tabs[g]`` ([R, S_g], values < 2*S_g) and
    end-match rows ``mends[g]`` ([S_g]) for the scan kernel."""
    dev = always.device
    sizes = [int(t.shape[1]) for t in tabs]
    for s in sizes:
        if 2 * s - 1 > 32767:
            raise ValueError(f"state count {s} does not fit the int16 scan table")
    tab = torch.cat([t.to(torch.int16).reshape(-1) for t in tabs])
    offs = np.cumsum([0] + [n_rows * s for s in sizes[:-1]])
    moffs = np.cumsum([0] + sizes[:-1])
    fit = [2 * n_rows * s for s in sizes if 2 * n_rows * s <= SMEM_TABLE_CAP]
    return ScanTables(
        tab=tab.contiguous(),
        tab_off=torch.as_tensor(offs, dtype=torch.int64, device=dev),
        n_states=torch.as_tensor(sizes, dtype=torch.int32, device=dev),
        mend=torch.cat([m.to(torch.uint8).reshape(-1) for m in mends]).contiguous(),
        mend_off=torch.as_tensor(moffs, dtype=torch.int64, device=dev),
        always=always.to(torch.uint8).contiguous(),
        smem_bytes=(max(fit, default=0) + 15) // 16 * 16,
    )


@dataclass
class DFABank:
    """G stacked DFAs, padded to common [S, C]."""

    packed: torch.Tensor  # [G, S, C] int32: next_state | (emit << 30)
    classmap: torch.Tensor  # [256, G] int32 (transposed for row gather)
    match_end: torch.Tensor  # [G, S] bool
    always: torch.Tensor  # [G] bool
    t256: torch.Tensor  # [256, S*G] dense: next + S*emit (slot j = s*G + g)
    kt: ScanTables | None = field(default=None, init=False, repr=False)

    def __post_init__(self):
        if self.t256.numel():
            s, g = self.n_states, self.n_groups
            t3 = self.t256.to(torch.int32).reshape(256, s, g).permute(2, 0, 1)
            self.kt = scan_tables(
                list(t3), list(self.match_end), self.always, n_rows=256
            )

    @property
    def n_groups(self) -> int:
        return int(self.packed.shape[0])

    @property
    def n_states(self) -> int:
        return int(self.packed.shape[1])


# Max padded state count for which the dense byte-indexed table is built.
_DENSE_MAX_STATES = 128


def _dense_dtype(s_max: int):
    """numpy dtype for packed values in [0, 2*s_max)."""
    if 2 * s_max - 1 <= 127:
        return np.int8
    return np.float32


def stack_dfas(dfas: list[DFA], min_states: int = 1, device=None) -> DFABank:
    """Stack DFAs into one padded bank (host-side numpy, then tensors on
    ``device``). ``min_states`` forces a larger state padding."""
    device = resolve_device(device)
    g = len(dfas)
    s_max = max(min_states, max(d.n_states for d in dfas))
    c_max = max(d.n_classes for d in dfas)
    packed = np.zeros((g, s_max, c_max), dtype=np.int32)
    classmap = np.zeros((256, g), dtype=np.int32)
    match_end = np.zeros((g, s_max), dtype=bool)
    always = np.zeros(g, dtype=bool)
    build_dense = s_max <= _DENSE_MAX_STATES
    # Padded states (s >= d.n_states) self-loop to 0 and never activate.
    dense = np.zeros((256, s_max if build_dense else 0, g), dtype=np.int32)
    for i, d in enumerate(dfas):
        s, c = d.n_states, d.n_classes
        packed[i, :s, :c] = d.trans.astype(np.int32) | (
            d.emit.astype(np.int32) << _EMIT_SHIFT
        )
        classmap[:, i] = d.classmap
        match_end[i, :s] = d.match_end
        always[i] = d.always_match
        if build_dense:
            per_byte_next = d.trans[:, d.classmap]  # [S, 256]
            per_byte_emit = d.emit[:, d.classmap]  # [S, 256]
            dense[:, :s, i] = (
                per_byte_next + s_max * per_byte_emit.astype(np.int32)
            ).T
    t256 = dense.reshape(256, dense.shape[1] * g).astype(_dense_dtype(s_max))

    def put(a):
        return torch.as_tensor(a, device=device)

    return DFABank(
        packed=put(packed),
        classmap=put(classmap),
        match_end=put(match_end),
        always=put(always),
        t256=put(t256),
    )


def _check_batch(data: torch.Tensor, lengths: torch.Tensor, where: str) -> None:
    if data.dtype != torch.uint8 or data.dim() != 2:
        raise ValueError(f"{where}: data must be [B, L] uint8, got {data.dtype} {tuple(data.shape)}")
    if lengths.dim() != 1 or lengths.shape[0] != data.shape[0]:
        raise ValueError(f"{where}: lengths must be [B], got {tuple(lengths.shape)}")
    if lengths.device != data.device:
        raise ValueError(f"{where}: data and lengths on different devices")


def _check_on(t: torch.Tensor, device: torch.device, where: str) -> None:
    if t.device != device:
        raise ValueError(f"{where}: bank tables on {t.device}, data on {device}")


def launch_scan(
    fn_name: str, kt: ScanTables, dataT: torch.Tensor, lens: torch.Tensor, g: int, extra=()
) -> torch.Tensor:
    """Launch one ``csrc/dfa_scan.cu`` launcher on ``dataT`` ([L, B] or
    [P, L, B] uint8) and ``lens`` ([B] or [P, B] int32); returns matched
    [B, G] bool. ``extra`` are the launcher's own ctypes arguments that
    follow the common table arguments."""
    p = kernels.ptr
    b = int(dataT.shape[-1])
    length = int(dataT.shape[-2])
    out = torch.empty((b, g), dtype=torch.bool, device=dataT.device)
    args = [
        p(dataT), p(lens), ctypes.c_int(length), ctypes.c_int(b),
        p(kt.tab), p(kt.tab_off), p(kt.n_states), p(kt.mend), p(kt.mend_off),
        p(kt.always), *extra,
        ctypes.c_int(kt.smem_bytes), p(out), ctypes.c_int(g),
        kernels.stream_ptr(dataT.device),
    ]
    fn = kernels.function("dfa_scan", fn_name, [type(a) for a in args])
    kernels.check(fn(*args), "dfa_scan", fn_name)
    return out


def scan_dfa_bank(bank: DFABank, data: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Scan ``data`` [B, L] uint8 (zero-padded past ``lengths`` [B]) against
    every DFA in the bank. Returns ``matched`` [B, G] bool.

    CPU tensors take the plain twin; CUDA tensors launch ``cko_scan_dense``
    (or, for a bank without a dense table, the plain gather scan)."""
    global LAUNCHES
    _check_batch(data, lengths, "scan_dfa_bank")
    if data.device.type == "cpu":
        if bank.t256.numel() == 0:
            return scan_dfa_bank_gather(bank, data, lengths)
        return scan_dfa_bank_take(bank, data, lengths)
    if data.device.type != "cuda":
        raise ValueError(f"scan_dfa_bank: unsupported device {data.device}")
    _check_on(bank.packed, data.device, "scan_dfa_bank")
    if bank.t256.numel() == 0:
        # S > 128: no dense table (a (256/C)x blow-up); long-buffer banks only.
        return scan_dfa_bank_gather(bank, data, lengths)
    dataT = data.t().contiguous()
    lens = lengths.to(torch.int32).contiguous()
    out = launch_scan("cko_scan_dense", bank.kt, dataT, lens, bank.n_groups)
    LAUNCHES += 1
    return out


def _scan_loop(data, lengths, lookup, n_groups: int, latch_end: bool = True):
    """Shared byte loop of the plain scans: ``lookup(t, state)`` returns the
    packed value next + S*emit per (row, group) as int64 and S."""
    b, length = data.shape
    dev = data.device
    state = torch.zeros((b, n_groups), dtype=torch.int64, device=dev)
    matched = torch.zeros((b, n_groups), dtype=torch.bool, device=dev)
    end_state = torch.zeros_like(state)
    lens = lengths.to(torch.int64)[:, None]
    for t in range(length):
        val, s = lookup(t, state)
        hit = val >= s
        nxt = val - s * hit.to(torch.int64)
        active = t < lens
        matched |= hit & active
        state = torch.where(active, nxt, state)
        if latch_end:
            end_state = torch.where(t == lens - 1, state, end_state)
    return matched, (end_state if latch_end else state)


def scan_dfa_bank_take(bank: DFABank, data: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Plain twin of ``cko_scan_dense``: per byte step one index gather
    from ``t256`` per (row, group) (no one-hot matmul)."""
    s, g = bank.n_states, bank.n_groups
    flat = bank.t256.to(torch.int64).reshape(-1)  # [256 * S * G]
    garange = torch.arange(g, dtype=torch.int64, device=data.device)[None, :]
    cols = data.to(torch.int64)

    def lookup(t, state):
        idx = cols[:, t : t + 1] * (s * g) + state * g + garange
        return flat[idx], s

    matched, end_state = _scan_loop(data, lengths, lookup, g)
    end_match = bank.match_end[garange, end_state]
    return matched | end_match | bank.always[None, :]


def scan_dfa_bank_gather(bank: DFABank, data: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Original gather-per-byte formulation — differential-test oracle."""
    g = bank.n_groups
    garange = torch.arange(g, dtype=torch.int64, device=data.device)[None, :]
    classmap = bank.classmap.to(torch.int64)
    packed = bank.packed.to(torch.int64)
    cols = data.to(torch.int64)

    def lookup(t, state):
        cls = classmap[cols[:, t]]  # [B, G]
        p = packed[garange, state, cls]
        hit = (p >> _EMIT_SHIFT) & 1
        # Re-express as next + S*emit so the shared loop applies.
        s = _STATE_MASK + 1
        return (p & _STATE_MASK) + s * hit, s

    matched, end_state = _scan_loop(data, lengths, lookup, g)
    return matched | bank.match_end[garange, end_state] | bank.always[None, :]
