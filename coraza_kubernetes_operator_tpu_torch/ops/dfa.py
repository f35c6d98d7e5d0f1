"""Stacked-DFA batch scanner (PyTorch + CUDA).

Port of ``coraza_kubernetes_operator_tpu/ops/dfa.py``. A bank stacks G
compiled DFAs (``compiler/re_dfa.py``) into device tables and scans a
``[B, L]`` byte batch. Formulations:

- ``scan_dense_tier`` — dispatch for several dense banks (a tier's
  prefilter banks) in ONE launch: CUDA tensors launch the hand-written
  kernel ``cko_scan_dense`` (``csrc/dfa_scan.cu``: a block per (row tile,
  bank) stages the bank's int16 [256, S] tables in shared memory, reads
  its rows' bytes as they are, and walks its groups with one shared-memory
  lookup per byte); CPU tensors take ``scan_dense_tier_plain``. Banks the
  kind mask turns off give zeros. ``DenseTier`` lays the banks out once.
- ``scan_dfa_bank`` — one bank: the fused path with a one-bank tier.
  Banks with no dense table (S > 128, reached only by the long-buffer
  fallback) run ``scan_dfa_bank_gather``. On a CPU tensor:
  ``scan_dfa_bank_take``.
- ``scan_dfa_bank_take`` — the plain PyTorch twin of the kernel: per byte
  step one index gather from the dense table ``t256`` per (row, group).
- ``scan_dfa_bank_gather`` — the original two-gathers-per-byte form over
  the class-compressed table, kept as the semantic oracle.

Tables keep the reference layout (``t256`` [256, S*G], slot j = s*G + g,
value next + S*emit; int8 when 2S-1 <= 127 else float32), so a model
built here is array-equal to the JAX package's. The kernel reads its own
int16 copy, laid out [G][256][S], derived once per tier.

The tier layout and launcher here are shared with the dfa-hot gather tier
(``ops/dfa_gather.py``), whose kernel runs the same device body with a
byte -> class map: a launch reads at most ``MAX_PIPES`` pipelines, and a
tier whose banks read more is split into several launches by pipeline
slot, each writing its own columns of the one output.
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

# Launches of ``cko_scan_dense`` (the wrapper books each one: ``kernels.book``).
LAUNCHES = 0

# Most groups one tier block walks: a bank with more is split into
# records of at most this many groups.
REC_GROUPS = 64
# Rows per tier block, and the byte columns of a row tile staged at once.
_ROWS = 128
_MAX_COLS = 256
# Dynamic shared memory one block may use on Hopper (227 KB).
SMEM_CAP = 232448


def r16(n: int) -> int:
    return (n + 15) // 16 * 16


def i32_rows(rows, dev) -> torch.Tensor:
    """[len(rows), k] int32 tensor on ``dev`` from a list of int tuples."""
    return torch.as_tensor(np.asarray(rows, dtype=np.int32).reshape(len(rows), -1), device=dev)


def split_launches(recs: list, slot_col: int, n_slots: int, dev) -> tuple:
    """Per launch (first input slot, its records as [n, k] int32 with the
    slot made local): records grouped by pipeline slot, ``MAX_PIPES``
    slots per launch, record order kept inside each launch."""
    out = []
    for base in range(0, n_slots, kernels.MAX_PIPES):
        rows = [tuple(r[:slot_col]) + (r[slot_col] - base,) + tuple(r[slot_col + 1 :])
                for r in recs if base <= r[slot_col] < base + kernels.MAX_PIPES]
        out.append((base, i32_rows(rows, dev)))
    return tuple(out)


@dataclass
class DenseTier:
    """Several banks laid out for one fused launch (more where they read
    more than ``MAX_PIPES`` pipelines): per bank its groups' int16 [R, S]
    tables (R = 256 byte rows here, C classes for a gather tier), each
    record 16-byte aligned, with records per bank piece and per group."""

    banks: list  # the banks, in column order
    pipelines: tuple  # pipeline id of each input slot
    pipe_slot: tuple  # per bank: its input slot
    tab: torch.Tensor  # int16: per record its groups' [R, S] tables
    grp_info: torch.Tensor  # [G, 3] int32: table offset inside its record, S, end-match offset
    mend: torch.Tensor  # uint8, concatenated [S] end-match flags per group
    always: torch.Tensor  # [G] uint8
    rec_bytes: tuple  # per record: its padded table bytes
    max_groups: int  # the most groups of one record
    # Per launch: (first input slot, its records [n, 6] int32: first group,
    # groups, table offset, elements, launch-local slot, bank).
    launches: tuple
    _on: dict = field(default_factory=dict, repr=False, compare=False)

    @property
    def n_groups(self) -> int:
        return int(self.always.shape[0])

    def on_groups(self, on: tuple) -> torch.Tensor:
        """[G] uint8 on/off per group for per-bank flags ``on`` (cached).

        Built from a host list at the first use of ``on``: a CUDA graph
        cannot capture that copy. ``on`` follows from a match stage's
        mask, which keys its graph (``engine/compile_cache.py``), and a
        key's eager runs come before its capture, so a capture finds the
        tensor built."""
        t = self._on.get(on)
        if t is None:
            flags = [f for bank, f in zip(self.banks, on) for _ in range(bank.n_groups)]
            t = self._on[on] = torch.tensor(flags, dtype=torch.uint8, device=self.always.device)
        return t


def tier_fields(banks: list, bank_pipelines, tables: list) -> dict:
    """The ``DenseTier`` fields of ``banks`` (pipeline id
    ``bank_pipelines[i]`` each) from ``tables[i]``, bank i's [G, R, S]
    int32 values next + S*emit."""
    dev = banks[0].always.device
    pipelines = tuple(dict.fromkeys(bank_pipelines))
    tabs, recs, grp_info, mends, rec_bytes = [], [], [], [], []
    off = g0 = moff = 0
    for bi, (bank, pid, t3) in enumerate(zip(banks, bank_pipelines, tables)):
        g, rows, s = t3.shape
        if 2 * s - 1 > 32767:
            raise ValueError(f"state count {s} does not fit the int16 scan table")
        slot = pipelines.index(pid)
        for lo in range(0, g, REC_GROUPS):
            piece = t3[lo : lo + REC_GROUPS]
            n = piece.numel()
            pad = -n % 8  # each record's table starts 16-byte aligned
            tabs.append(torch.cat([piece.reshape(-1), piece.new_zeros(pad)]).to(torch.int16))
            recs.append((g0 + lo, piece.shape[0], off, n, slot, bi))
            for gi in range(piece.shape[0]):
                grp_info.append((gi * rows * s, s, moff))
                moff += s
            rec_bytes.append(2 * (n + pad))
            off += n + pad
        mends.append(bank.match_end.to(torch.uint8).reshape(-1))
        g0 += g
    if off >= 2**31:
        raise ValueError("tier tables exceed int32 offsets")
    return dict(
        banks=list(banks),
        pipelines=pipelines,
        pipe_slot=tuple(pipelines.index(p) for p in bank_pipelines),
        tab=torch.cat(tabs).contiguous(),
        grp_info=i32_rows(grp_info, dev),
        mend=torch.cat(mends).contiguous(),
        always=torch.cat([b.always.to(torch.uint8) for b in banks]).contiguous(),
        rec_bytes=tuple(rec_bytes),
        max_groups=max(r[1] for r in recs),
        launches=split_launches(recs, 4, len(pipelines), dev),
    )


def build_dense_tier(banks: list, bank_pipelines) -> DenseTier:
    """Lay out dense ``banks`` (pipeline id ``bank_pipelines[i]`` each)
    for ``scan_dense_tier``. Every bank needs its dense table ``t256``."""
    tables = []
    for bank in banks:
        if bank.t256.numel() == 0:
            raise ValueError(f"a bank of {bank.n_states} states has no dense table")
        s, g = bank.n_states, bank.n_groups
        tables.append(bank.t256.to(torch.int32).reshape(256, s, g).permute(2, 0, 1))
    return DenseTier(**tier_fields(banks, bank_pipelines, tables))


def tier_smem(tier: DenseTier, length: int) -> tuple[int, int, int]:
    """(byte columns per row tile, table bytes a block stages, block shared
    bytes) of one tier launch at row width ``length``. The staged table is
    the largest record table that fits beside the row tile; larger ones are
    read from global memory (L2)."""
    cols = min(_MAX_COLS, r16(max(length, 1)))
    g = tier.max_groups  # per row: an int16 state and a match flag per group
    rest = 256 + r16(cols * (_ROWS + 4)) + r16(_ROWS * g * 2) + r16(_ROWS * g) + 16
    tab = max((b for b in tier.rec_bytes if b <= SMEM_CAP - rest), default=0)
    return cols, tab, tab + rest


def check_tier_inputs(tier, inputs, on, where: str) -> tuple[int, int, torch.device]:
    """Validate a tier's per-slot inputs; returns (B, L, device)."""
    if len(inputs) != len(tier.pipelines) or len(on) != len(tier.banks):
        raise ValueError(f"{where}: {len(inputs)} inputs / {len(on)} flags for "
                         f"{len(tier.pipelines)} pipelines / {len(tier.banks)} banks")
    given = [x for x in inputs if x is not None]
    for slot, flag in zip(tier.pipe_slot, on):
        if flag and inputs[slot] is None:
            raise ValueError(f"{where}: a mask-on bank reads pipeline slot {slot}, given None")
    if not given:
        raise ValueError(f"{where}: no input")
    shape, dev = given[0][0].shape, given[0][0].device
    for data, lengths in given:
        _check_batch(data, lengths, where)
        if data.shape != shape or data.device != dev:
            raise ValueError(f"{where}: pipeline inputs differ in shape or device")
    return shape[0], shape[1], dev


def pipe_structs(inputs) -> tuple[list, list]:
    """(``ScanPipes`` per launch of ``MAX_PIPES`` slots, the tensors whose
    pointers they hold). Lengths already int32 and contiguous are not
    copied."""
    keep, structs = [], []
    for base in range(0, len(inputs), kernels.MAX_PIPES):
        data_p, lens_p = [None] * kernels.MAX_PIPES, [None] * kernels.MAX_PIPES
        for k, x in enumerate(inputs[base : base + kernels.MAX_PIPES]):
            if x is not None:
                data, lens = x
                if lens.dtype != torch.int32:  # .to() costs microseconds even as a no-op
                    lens = lens.to(torch.int32)
                data, lens = data.contiguous(), lens.contiguous()
                keep.append((data, lens))
                data_p[k], lens_p[k] = data.data_ptr(), lens.data_ptr()
        structs.append(kernels.ScanPipes(kernels.PipePtrs(*data_p), kernels.PipePtrs(*lens_p)))
    return structs, keep


def launch_tier(tier: DenseTier, inputs, on, fn_name: str, extra=()) -> tuple[torch.Tensor, int]:
    """Run ``csrc/dfa_scan.cu``'s tier launcher ``fn_name`` over every
    launch of ``tier`` on CUDA inputs that ``check_tier_inputs`` passed;
    returns (matched [B, G] bool, launches made). ``extra`` are the
    launcher's own pointer arguments between ``always`` and ``on`` (the
    gather tier's class maps)."""
    first = next(x for x in inputs if x is not None)[0]
    (b, length), dev = first.shape, first.device
    _check_on(tier.tab, dev, fn_name)
    if not any(on):
        return torch.zeros((b, tier.n_groups), dtype=torch.bool, device=dev), 0
    structs, _keep = pipe_structs(inputs)
    cols, tab_smem, smem = tier_smem(tier, length)
    out = torch.empty((b, tier.n_groups), dtype=torch.bool, device=dev)
    p, i = kernels.ptr, ctypes.c_int
    on_g = tier.on_groups(on)
    with kernels.on_device(dev) as stream:
        for base, recs in tier.launches:
            args = [
                structs[base // kernels.MAX_PIPES], i(b), i(length), i(cols), p(tier.tab), p(recs),
                p(tier.grp_info), p(tier.mend), p(tier.always), *extra, p(on_g), i(tab_smem),
                i(smem), i(recs.shape[0]), i(tier.max_groups), p(out), i(tier.n_groups), stream,
            ]
            fn = kernels.function("dfa_scan", fn_name)
            kernels.check(fn(*args), "dfa_scan", fn_name)
    return out, len(tier.launches)


def scan_dense_tier(tier: DenseTier, inputs, on) -> torch.Tensor:
    """Scan every bank of ``tier`` in one launch (one per ``MAX_PIPES``
    pipelines). ``inputs[k]`` is pipeline slot k's ``(data [B, L] uint8,
    lengths [B])`` (None where no mask-on bank reads it); ``on[i]`` turns
    bank i on. Returns matched [B, G] bool in bank order, zeros for banks
    that are off.

    CPU tensors take ``scan_dense_tier_plain``; CUDA tensors launch
    ``cko_scan_dense`` (not at all when every bank is off)."""
    on = tuple(bool(f) for f in on)
    _b, _length, dev = check_tier_inputs(tier, inputs, on, "scan_dense_tier")
    if dev.type == "cpu":
        return scan_dense_tier_plain(tier, inputs, on)
    if dev.type != "cuda":
        raise ValueError(f"scan_dense_tier: unsupported device {dev}")
    out, n = launch_tier(tier, inputs, on, "cko_scan_dense")
    kernels.book(__name__, n)
    return out


def scan_dense_tier_plain(tier: DenseTier, inputs, on) -> torch.Tensor:
    """Plain twin of ``cko_scan_dense``: ``scan_dfa_bank_take`` on each
    mask-on bank, zeros for the others, concatenated in bank order."""
    b, _length, dev = check_tier_inputs(tier, inputs, on, "scan_dense_tier_plain")
    cols = [
        scan_dfa_bank_take(bank, *inputs[slot]) if flag
        else torch.zeros((b, bank.n_groups), dtype=torch.bool, device=dev)
        for bank, slot, flag in zip(tier.banks, tier.pipe_slot, on)
    ]
    return torch.cat(cols, dim=1)


@dataclass
class DFABank:
    """G stacked DFAs, padded to common [S, C]."""

    packed: torch.Tensor  # [G, S, C] int32: next_state | (emit << 30)
    classmap: torch.Tensor  # [256, G] int32 (transposed for row gather)
    match_end: torch.Tensor  # [G, S] bool
    always: torch.Tensor  # [G] bool
    t256: torch.Tensor  # [256, S*G] dense: next + S*emit (slot j = s*G + g)
    _tier: DenseTier | None = field(default=None, init=False, repr=False, compare=False)

    @property
    def tier(self) -> DenseTier:
        """This bank alone, laid out for the fused kernel (built once)."""
        if self._tier is None:
            self._tier = build_dense_tier([self], (0,))
        return self._tier

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


def scan_dfa_bank(bank: DFABank, data: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Scan ``data`` [B, L] uint8 (zero-padded past ``lengths`` [B]) against
    every DFA in the bank. Returns ``matched`` [B, G] bool.

    CPU tensors take the plain twin; CUDA tensors launch ``cko_scan_dense``
    with the bank as a one-bank tier (or, for a bank without a dense table,
    the plain gather scan)."""
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
    return scan_dense_tier(bank.tier, [(data, lengths)], (True,))


def _scan_loop(data, lengths, lookup, n_groups: int):
    """Shared byte loop of the plain scans. ``lookup(col, state)`` returns
    the packed value next + S*emit per (row, group) as int64 and S, for
    ``col`` [n, 1] the step's bytes of the rows still inside their buffers
    and ``state`` [n, G] theirs. Rows are visited by descending length, so
    those rows are always a prefix and a step costs only the live rows.
    Returns matched [B, G] and each row's state after its last byte (0 for
    a row whose length passes the buffer's end)."""
    b, length = data.shape
    dev = data.device
    lens = lengths.to(torch.int64)
    order = torch.argsort(lens, descending=True, stable=True)
    cols = data.index_select(0, order).to(torch.int64)
    state = torch.zeros((b, n_groups), dtype=torch.int64, device=dev)
    matched = torch.zeros((b, n_groups), dtype=torch.bool, device=dev)
    if dev.type == "cuda":
        kernels.note_host_sync("the plain DFA loop reads the row lengths back")
    live = lens[order].tolist()
    n = b
    for t in range(min(live[0], length) if b else 0):
        while live[n - 1] <= t:
            n -= 1
        val, s = lookup(cols[:n, t : t + 1], state[:n])
        hit = val >= s
        matched[:n] |= hit
        state[:n] = val - s * hit.to(torch.int64)
    back = torch.empty_like(order)
    back[order] = torch.arange(b, device=dev)
    end_state = torch.where((lens > length)[:, None], 0, state[back])
    return matched[back], end_state


def scan_dfa_bank_take(bank: DFABank, data: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Plain twin of ``cko_scan_dense``: per byte step one index gather
    from ``t256`` per (row, group) (no one-hot matmul)."""
    s, g = bank.n_states, bank.n_groups
    flat = bank.t256.to(torch.int64).reshape(-1)  # [256 * S * G]
    garange = torch.arange(g, dtype=torch.int64, device=data.device)[None, :]

    def lookup(col, state):
        return flat[col * (s * g) + state * g + garange], s

    matched, end_state = _scan_loop(data, lengths, lookup, g)
    end_match = bank.match_end[garange, end_state]
    return matched | end_match | bank.always[None, :]


def scan_dfa_bank_gather(bank: DFABank, data: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Original gather-per-byte formulation — differential-test oracle."""
    g = bank.n_groups
    garange = torch.arange(g, dtype=torch.int64, device=data.device)[None, :]
    classmap = bank.classmap.to(torch.int64)
    packed = bank.packed.to(torch.int64)

    def lookup(col, state):
        cls = classmap[col[:, 0]]  # [n, G]
        p = packed[garange, state, cls]
        hit = (p >> _EMIT_SHIFT) & 1
        # Re-express as next + S*emit so the shared loop applies.
        s = _STATE_MASK + 1
        return (p & _STATE_MASK) + s * hit, s

    matched, end_state = _scan_loop(data, lengths, lookup, g)
    return matched | bank.match_end[garange, end_state] | bank.always[None, :]
