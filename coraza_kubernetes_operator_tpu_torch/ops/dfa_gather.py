"""DFA hot tier: byte-class-packed transition-gather banks (PyTorch + CUDA).

Port of ``coraza_kubernetes_operator_tpu/ops/dfa_gather.py``. The
two-level automata engine compiles groups whose minimized DFAs are small
into *joint-byte-class* dense tables: a bank-wide joint byte-class
partition (``compiler/re_dfa.joint_classmap``) maps bytes onto C ≪ 256
classes, so the resident table is ``[C, S*G]``.

- ``scan_gather_tier`` — dispatch for every dfa-hot bank of a model in
  ONE launch (one per ``MAX_PIPES`` pipelines): CUDA tensors launch the
  hand-written kernel ``cko_scan_gather`` (``csrc/dfa_scan.cu``: a block
  per (row tile, bank) stages the bank's class map and tables in shared
  memory, maps each byte of its row tile to its class once, and walks the
  bank's groups over that class sequence; the dense tier's body with the
  class map on); CPU tensors take ``scan_gather_tier_plain``. Banks the
  kind mask turns off give zeros.
- ``scan_gather_tier_plain`` — the plain twin: ``scan_gather_bank_jnp``
  per mask-on bank, zeros for the others, concatenated in bank order.
- ``scan_gather_bank`` — one bank: the fused path with a one-bank tier.
- ``scan_gather_bank_jnp`` — the plain PyTorch twin of one bank (name
  kept from the reference): per byte step a classmap gather, then one
  index gather from ``tC`` per (row, group).

Bank packing (``plan_gather_bins``) keeps the reference's TPU budgets, so
the bank layout is array-equal to the JAX package's; ``GatherTier`` lays
the banks out once, at model build, for the fused launch (the layout of
``ops/dfa.py::DenseTier`` plus the class maps).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..compiler.re_dfa import DFA, joint_class_count, joint_classmap
from ..utils.device import resolve_device
from . import kernels
from .dfa import (
    DenseTier,
    _check_batch,
    _check_on,
    _dense_dtype,
    _scan_loop,
    check_tier_inputs,
    launch_tier,
    tier_fields,
)

_LANE = 128
# Reference planning budgets (ops/dfa.py there): the bins are laid out
# exactly as the JAX package lays them out.
_PALLAS_VMEM_BUDGET = 11 * 2**20
_PALLAS_BLOCK_B = 128

# Greedy bin cap on joint classes.
_MAX_JOINT_CLASSES = 120

# Launches of ``cko_scan_gather`` (the wrapper books each one: ``kernels.book``).
LAUNCHES = 0

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
class GatherTier(DenseTier):
    """Every dfa-hot bank of a model laid out for one fused launch: the
    dense tier's layout over [C, S] class tables, plus each bank's class
    map."""

    cmaps: torch.Tensor = None  # [NB, 256] uint8 byte -> class per bank


def build_gather_tier(banks: list, bank_pipelines) -> GatherTier:
    """Lay out ``banks`` (pipeline id ``bank_pipelines[i]`` each) for
    ``scan_gather_tier``: int16 tables concatenated per record, class maps,
    and a record per group."""
    tables = [b.tC.to(torch.int32).reshape(b.n_classes, b.n_states, b.n_groups).permute(2, 0, 1)
              for b in banks]
    return GatherTier(
        **tier_fields(banks, bank_pipelines, tables),
        cmaps=torch.stack([b.classmap.to(torch.uint8) for b in banks]).contiguous(),
    )


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


def scan_gather_tier(tier: GatherTier, inputs, on) -> torch.Tensor:
    """Scan every bank of ``tier`` in one launch (one per ``MAX_PIPES``
    pipelines). ``inputs[k]`` is pipeline slot k's ``(data [B, L] uint8,
    lengths [B])`` (None where no mask-on bank reads it); ``on[i]`` turns
    bank i on. Returns matched [B, G] bool in bank order, zeros for banks
    that are off.

    CPU tensors take ``scan_gather_tier_plain``; CUDA tensors launch
    ``cko_scan_gather`` (not at all when every bank is off)."""
    on = tuple(bool(f) for f in on)
    _b, _length, dev = check_tier_inputs(tier, inputs, on, "scan_gather_tier")
    if dev.type == "cpu":
        return scan_gather_tier_plain(tier, inputs, on)
    if dev.type != "cuda":
        raise ValueError(f"scan_gather_tier: unsupported device {dev}")
    out, n = launch_tier(tier, inputs, on, "cko_scan_gather", extra=(kernels.ptr(tier.cmaps),))
    kernels.book(__name__, n)
    return out


def scan_gather_tier_plain(tier: GatherTier, inputs, on) -> torch.Tensor:
    """Plain twin of ``cko_scan_gather``: ``scan_gather_bank_jnp`` on each
    mask-on bank, zeros for the others, concatenated in bank order."""
    b, _length, dev = check_tier_inputs(tier, inputs, on, "scan_gather_tier_plain")
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

    def lookup(col, state):
        cls = classmap[col]  # [n, 1]
        return flat[cls * (s * g) + state * g + garange], s

    matched, end_state = _scan_loop(data, lengths, lookup, g)
    return matched | bank.match_end[garange, end_state] | bank.always[None, :]
