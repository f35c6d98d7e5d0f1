"""Conv-segment matcher (PyTorch): every match position of every segment in
ONE convolution, then gap-chaining as bitmap algebra.

Port of ``coraza_kubernetes_operator_tpu/ops/segment.py``.

1. **embed**: bytes → ``[T, C, Lp]`` channel planes (nibble one-hots,
   class-interval tests, a constant ones plane), one lookup of each byte
   in the block's ``[C, 256]`` plane table.
2. **conv**: one ``conv1d`` with kernel ``[W, C, N]`` (the reference's
   channels-last ``[W, C, N]`` layout, permuted to torch's ``[N, C, W]``
   at the call). Each segment position contributes exactly 2 when its
   byte matches, so ``out == 2W`` ⇔ the segment matches at that window
   start.
3. **chain**: gap constraints as bitmap algebra over the window starts,
   suffix-deduped exactly as the reference lays them out
   (``ops/segment_chain.py``: the kernel ``cko_chain_match`` on the card,
   its plain version on the CPU).
4. **finals tier** (``CKO_PALLAS_FINALS=1``, off by default): the finals
   columns skip the conv and the ``[T, Q, N]`` bitmap; the CUDA kernel of
   ``ops/segment_finals.py`` scores them where their group is reachable.

The reference gates some chains behind ``lax.cond`` on "any first segment
matched anywhere"; the gate only skips work whose result is all-False, so
the port always computes the chain (same bits, and no host sync on the
card).

Position space: padded index ``p`` covers a front NUL pad (``p = 0``,
which makes start-of-input read as a non-word byte for ``\\b``) plus the
buffer; chain bitmaps say "the next element may start at ``p``".
"""

from __future__ import annotations

import os as _os
from dataclasses import dataclass, field

import numpy as np
import torch
import torch.nn.functional as F

from ..compiler.re_parser import ALL_BYTES
from ..compiler.segments import Seg, SegmentPlan
from ..utils.device import resolve_device
from .segment_chain import _NCE_MATMUL_MAX_Q  # noqa: F401 (callers read the NCE bound here)
from .segment_chain import ChainTables, chain_match, chain_tables
from .segment_finals import finals_match, finals_tables


def finals_tier_requested() -> bool:
    """``CKO_PALLAS_FINALS=1``: the finals tier is on (read per call)."""
    return _os.environ.get("CKO_PALLAS_FINALS", "0") == "1"


# ---------------------------------------------------------------------------
# Host-side build: plans → channel/kernel spec
# ---------------------------------------------------------------------------


def _intervals(mask: int) -> list[tuple[int, int]]:
    """Byte mask → sorted inclusive intervals."""
    out: list[tuple[int, int]] = []
    b = 0
    while b < 256:
        if mask >> b & 1:
            start = b
            while b < 256 and mask >> b & 1:
                b += 1
            out.append((start, b - 1))
        else:
            b += 1
    return out


def _product_parts(mask: int) -> tuple[tuple[int, ...], tuple[int, ...]] | None:
    """If ``mask`` is exactly ``hiSet x loSet``, return the nibble sets."""
    his: set[int] = set()
    los: set[int] = set()
    count = 0
    for byte in range(256):
        if mask >> byte & 1:
            his.add(byte >> 4)
            los.add(byte & 15)
            count += 1
    if count and len(his) * len(los) == count:
        return tuple(sorted(his)), tuple(sorted(los))
    return None


@dataclass(frozen=True)
class SegmentSpec:
    """Hashable static program for one pipeline's conv block."""

    w: int  # kernel width
    n_seg: int  # conv output channels
    channels: tuple  # embed plan: ('hi',k)|('lo',k)|('one',)|('ind', intervals)
    # per conv channel: (n_lead, n_real)
    seg_meta: tuple[tuple[int, int], ...]
    # per branch: (group, chan_elements) where chan_elements is a tuple of
    #   ('seg', chan) | ('gapany', lo, hi|-1) | ('gapcls', intervals, lo, hi|-1)
    # plus anchors
    branches: tuple[tuple[int, tuple, bool, bool], ...]
    always: tuple[int, ...]  # group ids that always match
    n_groups: int


@dataclass
class SegmentBlock:
    """Device tensor + static spec for one pipeline's conv matcher."""

    kernel: torch.Tensor  # [W, C, N] bf16
    spec: SegmentSpec
    # The finals tier's constant operands per device, built at first use
    # (``match_segment_block``'s ``cache``).
    finals: dict = field(default_factory=dict, init=False, repr=False, compare=False)
    # The static chain program and its constants per device, built at
    # first use (``match_segment_block``'s ``consts``).
    consts: dict = field(default_factory=dict, init=False, repr=False, compare=False)

    @property
    def n_groups(self) -> int:
        return self.spec.n_groups


def build_segment_block(plans: list[SegmentPlan], device=None) -> SegmentBlock:
    """Stack group plans (group id = list index) into one conv block on
    ``device``."""
    device = resolve_device(device)
    channels: list[tuple] = [("hi", k) for k in range(16)]
    channels += [("lo", k) for k in range(16)]
    channels.append(("one",))
    ch_index: dict[tuple, int] = {c: i for i, c in enumerate(channels)}

    def indicator(mask: int) -> int:
        key = ("ind", tuple(_intervals(mask)))
        if key not in ch_index:
            ch_index[key] = len(channels)
            channels.append(key)
        return ch_index[key]

    # Intern segments; collect branch programs. The intern key must be
    # (classes, geometry): two segments with identical byte-class
    # sequences but different lead/trail splits (e.g. `(ALL,)` as a
    # one-byte lead context vs as a one-byte trailing lookahead) need
    # DISTINCT ids — seg_meta is per id, and sharing a column across
    # geometries made every later consumer inherit the first one's
    # shifts (an order-dependent false negative caught by the host
    # fallback parity gate on CRS 942120).
    seg_ids: dict[tuple, int] = {}
    seg_meta: list[tuple[int, int]] = []
    seg_classes: list[tuple[int, ...]] = []
    branches: list[tuple[int, tuple, bool, bool]] = []
    always: list[int] = []
    w = 1
    for gid, plan in enumerate(plans):
        if plan.always:
            always.append(gid)
        for br in plan.branches:
            prog: list[tuple] = []
            for el in br.elements:
                if isinstance(el, Seg):
                    key = (el.classes, el.n_lead, el.n_real)
                    if key not in seg_ids:
                        seg_ids[key] = len(seg_classes)
                        seg_classes.append(el.classes)
                        seg_meta.append((el.n_lead, el.n_real))
                        w = max(w, len(el.classes))
                    prog.append(("seg", seg_ids[key]))
                else:
                    hi = -1 if el.hi is None else el.hi
                    if el.mask == ALL_BYTES:
                        prog.append(("gapany", el.lo, hi))
                    else:
                        prog.append(
                            ("gapcls", tuple(_intervals(el.mask)), el.lo, hi)
                        )
            branches.append((gid, tuple(prog), br.anchored_start, br.anchored_end))

    n = max(1, len(seg_classes))
    # First pass: intern every indicator channel so the kernel can be
    # allocated at its final channel count.
    products: dict[int, tuple] = {}
    for classes in seg_classes:
        for mask in classes:
            if mask not in products:
                products[mask] = _product_parts(mask)
            if products[mask] is None:
                indicator(mask)
    # Kernel: every position of every channel contributes exactly 2 on match.
    kernel = np.zeros((w, len(channels), n), dtype=np.float32)
    for ci, classes in enumerate(seg_classes):
        for pos in range(w):
            if pos < len(classes):
                mask = classes[pos]
                parts = products[mask]
                if parts is not None:
                    his, los = parts
                    for h in his:
                        kernel[pos, ch_index[("hi", h)], ci] += 1.0
                    for lo in los:
                        kernel[pos, ch_index[("lo", lo)], ci] += 1.0
                else:
                    kernel[pos, indicator(mask), ci] += 2.0
            else:
                kernel[pos, ch_index[("one",)], ci] += 2.0
    # Prune embed channels no segment references (e.g. nibble planes of
    # bytes that never appear) — shrinks both the embed and the matmul K.
    used = kernel.any(axis=(0, 2))
    kernel = kernel[:, used, :]
    channels = [c for c, u in zip(channels, used) if u]

    spec = SegmentSpec(
        w=w,
        n_seg=n,
        channels=tuple(channels),
        seg_meta=tuple(seg_meta) or ((0, 1),),
        branches=tuple(branches),
        always=tuple(always),
        n_groups=len(plans),
    )
    return SegmentBlock(
        kernel=torch.as_tensor(kernel, device=device).to(torch.bfloat16), spec=spec
    )

# ---------------------------------------------------------------------------
# Device-side evaluation
# ---------------------------------------------------------------------------


def _plane_table(channels: tuple) -> np.ndarray:
    """[C, 256] bool: channel c's plane holds table[c, byte]."""
    b = np.arange(256)
    rows = []
    for chan in channels:
        kind = chan[0]
        if kind == "hi":
            rows.append((b >> 4) == chan[1])
        elif kind == "lo":
            rows.append((b & 15) == chan[1])
        elif kind == "one":
            rows.append(np.ones(256, dtype=bool))
        else:  # ('ind', intervals)
            rows.append(np.any([(b >= lo) & (b <= hi) for lo, hi in chan[1]], axis=0))
    return np.asarray(rows, dtype=bool).reshape(len(channels), 256)


def _branch_signature(spec: SegmentSpec, prog: tuple, a_start: bool, a_end: bool):
    """Branches with identical signatures run as one batched chain."""
    sig: list[tuple] = []
    for el in prog:
        if el[0] == "seg":
            n_lead, n_real = spec.seg_meta[el[1]]
            sig.append(("seg", n_lead, n_real))
        else:
            sig.append(el)
    return (tuple(sig), a_start, a_end)


def _finals_layout(spec: SegmentSpec):
    """(distinct suffixes, finals channel sets) of the seg-first branches:
    one finals column per DISTINCT (suffix, geometry, anchor, first
    segment) — cross-rule duplicates share it."""
    suffix_ids: dict[tuple, int] = {}
    finals_chans: dict[tuple, set[int]] = {}
    for _, prog, a_start, a_end in spec.branches:
        if len(prog) >= 2 and prog[0][0] == "seg":
            sid = suffix_ids.setdefault((prog[1:], a_end), len(suffix_ids))
            chan = prog[0][1]
            nl, nr = spec.seg_meta[chan]
            finals_chans.setdefault((sid, nl, nr, a_start), set()).add(chan)
    return suffix_ids, finals_chans


def finals_cols(spec: SegmentSpec) -> int:
    """Finals columns of a block: the columns the finals tier takes."""
    return sum(len(chans) for chans in _finals_layout(spec)[1].values())


def conv_n2_cols(spec: SegmentSpec) -> int:
    """Duplicated/permuted conv output column count — ``len(col_order)``
    as ``match_segment_block`` will build it (the [T, Q, N2] conv output
    is what the row-chunk budget must count)."""
    suffix_ids, finals_chans = _finals_layout(spec)
    n2 = sum(
        sum(1 for el in prog if el[0] == "seg")
        for _, prog, _, _ in spec.branches
        if not (len(prog) >= 2 and prog[0][0] == "seg")
    )
    n2 += sum(len(chans) for chans in finals_chans.values())
    for ops, _ in suffix_ids:
        n2 += sum(1 for el in ops if el[0] == "seg")
    return max(1, n2)


def _conv_dtype(device: torch.device) -> torch.dtype:
    # bf16 on the card halves the conv output's memory traffic; the CPU
    # runs float32. Both are exact (see the note at the conv call).
    return torch.bfloat16 if device.type == "cuda" else torch.float32


def match_segment_block(
    kernel: torch.Tensor,  # [W, C, N] bf16
    spec: SegmentSpec,
    data: torch.Tensor,  # [T, L] uint8 (zero padded past lengths)
    lengths: torch.Tensor,  # [T] int32
    *,
    cache: dict,
    consts: dict | None = None,
) -> torch.Tensor:
    """Returns group hits [T, n_groups] bool.

    With ``CKO_PALLAS_FINALS=1`` (read per call; off by default, as in the
    reference) and at least one finals column, the finals columns leave
    the conv and go to ``segment_finals.finals_match``: the kernel on the
    card, its plain version on the CPU. The reference also requires a TPU
    backend, rows a multiple of 128, C <= 128 and Gf <= 512; those only fit
    the Pallas kernel's tiles, the CUDA kernel has none, and the hits are
    identical either way, so the port does not carry them over.

    ``cache`` is the block's ``SegmentBlock.finals``: the tier's constant
    operands (``segment_finals.FinalsTables``), built at the first call
    with the tier on and kept across calls. ``consts`` is the block's
    ``SegmentBlock.consts``: the static chain program and its device
    constants (``_block_consts``), kept across calls, so that a call after
    the first sends nothing from the host to the device and a CUDA graph
    can capture it. None builds them for this call alone."""
    return _match(kernel, spec, data, lengths, finals_tier_requested(), cache, consts=consts)


def finals_inputs(kernel, spec: SegmentSpec, data: torch.Tensor, lengths: torch.Tensor,
                  *, cache: dict, consts: dict | None = None):
    """The finals tier's operands for ``data``, exactly as
    ``match_segment_block`` hands them to ``finals_match`` with the tier
    on: ``(embed, suffix, lengths, tables, q)``, or None when the block has
    no finals column."""
    return _match(kernel, spec, data, lengths, True, cache, inputs="finals", consts=consts)


def chain_inputs(kernel, spec: SegmentSpec, data: torch.Tensor, lengths: torch.Tensor,
                 *, consts: dict | None = None, finals_tier: bool = False):
    """The chain's operands for ``data``, exactly as ``match_segment_block``
    hands them to ``segment_chain.chain_match``: ``(out, data, lengths,
    tables, off, tier)``, or None when the block has no branch."""
    return _match(kernel, spec, data, lengths, finals_tier, {}, inputs="chain", consts=consts)


@dataclass
class _Program:
    """A block's static chain program: everything ``_match`` derives from
    the spec alone."""

    # No-chain-first branches by batched signature -> branch indices.
    buckets: dict
    # Distinct suffixes of the seg-first branches: (ops, a_end) -> sid.
    suffix_ids: dict
    # Suffix signature -> [(suffix key, sid)], batched right to left.
    struct: dict
    # (sid, n_lead, n_real, a_start) -> [(branch, first segment channel)].
    finals: dict
    # Conv column layout: every consumer reads a contiguous slice.
    col_order: tuple
    final_alloc: dict
    final_gidsets: dict
    struct_alloc: dict
    bucket_alloc: dict
    n_finals_cols: int  # the finals columns, allocated first
    gap_classes: tuple  # distinct 'gapcls' interval sets, in first-use order
    col_groups: tuple  # per hit column (buckets, then finals): gid or gid set
    sid_col: dict  # sid -> its suffix column (struct order, members in turn)


@dataclass
class _DeviceConsts:
    """A block's constants on one device."""

    kernel_p: torch.Tensor  # [W, C, N2] the kernel's columns in col_order
    weights: dict  # off -> [N2 - off, C, W] conv weight in the conv dtype
    b2g: torch.Tensor | None  # [hit columns, G] float32 0/1: column -> group
    always: torch.Tensor | None  # [G] bool: groups that always match
    planes: torch.Tensor  # [C, 256] bool: the embed's channel planes by byte
    chain: ChainTables  # the chain program's tables (ops/segment_chain.py)


def _program(spec: SegmentSpec) -> _Program:
    old_path: list[int] = []
    chain_first: list[int] = []
    for bi, (_gid, prog, _a_start, _a_end) in enumerate(spec.branches):
        if len(prog) >= 2 and prog[0][0] == "seg":
            chain_first.append(bi)
        else:
            old_path.append(bi)

    buckets: dict[tuple, list[int]] = {}
    for bi in old_path:
        gid, prog, a_start, a_end = spec.branches[bi]
        buckets.setdefault(_branch_signature(spec, prog, a_start, a_end), []).append(bi)

    suffix_ids: dict[tuple, int] = {}
    finals: dict[tuple, list[tuple[int, int]]] = {}
    for bi in chain_first:
        gid, prog, a_start, a_end = spec.branches[bi]
        skey = (prog[1:], a_end)
        sid = suffix_ids.setdefault(skey, len(suffix_ids))
        seg_chan = prog[0][1]
        n_lead, n_real = spec.seg_meta[seg_chan]
        finals.setdefault((sid, n_lead, n_real, a_start), []).append((bi, seg_chan))

    def _suffix_sig(skey: tuple) -> tuple:
        ops, a_end = skey
        sig: list[tuple] = []
        for el in ops:
            if el[0] == "seg":
                nl, nr = spec.seg_meta[el[1]]
                sig.append(("seg", nl, nr))
            else:
                sig.append(el)
        return (tuple(sig), a_end)

    struct: dict[tuple, list[tuple[tuple, int]]] = {}
    for skey, sid in suffix_ids.items():
        struct.setdefault(_suffix_sig(skey), []).append((skey, sid))

    col_order: list[int] = []

    def alloc(chs: list[int]) -> tuple[int, int]:
        start = len(col_order)
        col_order.extend(chs)
        return (start, len(col_order))

    final_alloc: dict[tuple, tuple[int, int]] = {}
    final_gidsets: dict[tuple, list[set[int]]] = {}
    for gk, items in finals.items():
        uniq: dict[int, set[int]] = {}
        for bi, c in items:
            uniq.setdefault(c, set()).add(spec.branches[bi][0])
        chans = list(uniq)
        final_alloc[gk] = alloc(chans)
        final_gidsets[gk] = [uniq[c] for c in chans]
    struct_alloc: dict[tuple, list[tuple[int, int]]] = {}
    for sig_key, members in struct.items():
        chan_cols = [
            [el[1] for el in skey[0] if el[0] == "seg"] for skey, _ in members
        ]
        n_slots = len(chan_cols[0]) if chan_cols else 0
        struct_alloc[sig_key] = [
            alloc([cc[slot] for cc in chan_cols]) for slot in range(n_slots)
        ]
    bucket_alloc: dict[tuple, list[tuple[int, int]]] = {}
    for sig_key, idxs in buckets.items():
        chan_lists = [
            [el[1] for el in spec.branches[bi][1] if el[0] == "seg"]
            for bi in idxs
        ]
        n_slots = len(chan_lists[0]) if chan_lists else 0
        bucket_alloc[sig_key] = [
            alloc([cl[slot] for cl in chan_lists]) for slot in range(n_slots)
        ]
    if not col_order:
        col_order = [0]

    gap_classes = tuple(dict.fromkeys(
        el[1] for _, prog, _, _ in spec.branches for el in prog if el[0] == "gapcls"
    ))
    col_groups = [spec.branches[bi][0] for idxs in buckets.values() for bi in idxs]
    for gk in finals:
        col_groups.extend(final_gidsets[gk])  # deduped: one col -> gid set
    sid_col = {sid: i for i, (_skey, sid) in enumerate(m for ms in struct.values() for m in ms)}
    return _Program(
        buckets=buckets, suffix_ids=suffix_ids, struct=struct, finals=finals,
        col_order=tuple(col_order), final_alloc=final_alloc, final_gidsets=final_gidsets,
        struct_alloc=struct_alloc, bucket_alloc=bucket_alloc,
        n_finals_cols=sum(len(gs) for gs in final_gidsets.values()),
        gap_classes=gap_classes, col_groups=tuple(col_groups), sid_col=sid_col,
    )


def _block_consts(kernel, spec: SegmentSpec, dev, store: dict) -> tuple[_Program, _DeviceConsts]:
    """The block's program and its constants on ``dev``, from ``store``
    (``SegmentBlock.consts``), built there at first use. Building copies
    host arrays to the device; later calls find them built."""
    prog = store.get("program")
    if prog is None:
        prog = store["program"] = _program(spec)
    dc = store.get(dev)
    if dc is None:
        kernel_p = kernel[:, :, torch.as_tensor(prog.col_order, device=kernel.device)].to(dev)
        b2g = always = None
        if spec.branches:
            b2g_np = np.zeros((len(prog.col_groups), spec.n_groups), dtype=np.float32)
            for ci, gid in enumerate(prog.col_groups):
                b2g_np[ci, list(gid) if isinstance(gid, set) else gid] = 1
            b2g = torch.as_tensor(b2g_np, device=dev)
        if spec.always:
            al = np.zeros(spec.n_groups, dtype=bool)
            al[list(spec.always)] = True
            always = torch.as_tensor(al, device=dev)
        dc = store[dev] = _DeviceConsts(
            kernel_p=kernel_p, weights={}, b2g=b2g, always=always,
            planes=torch.as_tensor(_plane_table(spec.channels), device=dev),
            chain=chain_tables(prog, w=spec.w, device=dev),
        )
    return prog, dc


def _conv_weight(dc: _DeviceConsts, off: int, dev) -> torch.Tensor:
    """[N2 - off, C, W] conv weight without the first ``off`` columns."""
    weight = dc.weights.get(off)
    if weight is None:
        weight = dc.weights[off] = (
            dc.kernel_p[:, :, off:].permute(2, 1, 0).to(dtype=_conv_dtype(dev)).contiguous()
        )
    return weight


def _match(kernel, spec: SegmentSpec, data, lengths, finals_tier: bool, cache: dict,
           inputs: str | None = None, consts: dict | None = None):
    """``match_segment_block``'s body; ``inputs`` "finals" or "chain" returns
    that stage's operands instead of the hits."""
    t, ln = data.shape
    dev = data.device
    w = spec.w
    q = ln + 2  # chain positions: window starts 0 .. L+1
    lengths = lengths.to(torch.int32)
    # Front NUL pad (position 0) + right slack so every window is full.
    dpad = F.pad(data.to(torch.int64), (1, w))  # [T, 1+L+W]

    # The static chain program (pure Python) and its device constants,
    # cached on the block: buckets, suffixes, finals and the conv column
    # layout, in which every consumer reads a contiguous slice.
    # The finals tier takes the finals columns, allocated first ([0, off)),
    # out of the conv; the chain then reads conv columns shifted by off.
    # The conv's exclusion and the dispatch below read the same `off`.
    prog, dc = _block_consts(kernel, spec, dev, {} if consts is None else consts)
    n_finals_cols = prog.n_finals_cols
    tier = finals_tier and n_finals_cols > 0
    if (inputs == "finals" and not tier) or (inputs == "chain" and not spec.branches):
        return None
    off = n_finals_cols if tier else 0
    weight = _conv_weight(dc, off, dev)

    # 1. embed: one lookup of every byte in the [C, 256] plane table.
    planes = dc.planes[:, dpad]  # [C, T, 1+L+W] bool

    def stack_planes(dim: int) -> torch.Tensor:
        """[T, C, 1+L+W] (dim 1, conv1d's layout) or [T, 1+L+W, C] (dim 2,
        the finals tier's) bool."""
        return planes.permute(1, 0, 2) if dim == 1 else planes.permute(1, 2, 0)

    # 2. conv: all segments, all start positions. out[t, n, p] == 2W ⇔
    # segment n matches the window starting at padded position p.
    # Exactness: every operand is 0, 1 or 2 and every sum is at most
    # 2W ≤ 48, so bf16 (integers exact to 256), float32 and TF32 (cuDNN's
    # default for float32 convolutions) all give the exact integer — no
    # global precision flag is needed or set.
    cdt = _conv_dtype(dev)
    if weight.shape[0] and weight.shape[1]:  # [N2 - off, C, W]
        x = stack_planes(1).to(cdt, memory_format=torch.contiguous_format)
        out = F.conv1d(x, weight)  # [T, N2 - off, Q]
    else:  # every column is a finals column, or no byte channel: nothing matches
        out = torch.zeros((t, weight.shape[0], q), dtype=cdt, device=dev)
    if inputs == "chain":
        return out, data, lengths, dc.chain, off, tier

    hits = torch.zeros((t, spec.n_groups), dtype=torch.bool, device=dev)
    if spec.branches:
        # 3. chain: the kernel on the card, its plain version on the CPU.
        bh_all, suffix = chain_match(out, data, lengths, dc.chain, off=off, tier=tier)
        if tier:
            if dev not in cache:
                # Finals columns in allocation order, each tagged with its
                # group; per group (suffix column, n_lead, n_real, a_start).
                col_group = np.zeros(n_finals_cols, dtype=np.int32)
                for slot, key in enumerate(prog.finals):
                    a0, a1 = prog.final_alloc[key]
                    col_group[a0:a1] = slot
                desc = [(prog.sid_col[sid], nl, nr, int(a_st)) for sid, nl, nr, a_st in prog.finals]
                weights = dc.kernel_p[:, :, :off].reshape(-1, off)  # [W*C, Nf]
                cache[dev] = finals_tables(weights, desc, col_group, w=w)
            tier_args = (
                stack_planes(2),  # [T, 1+L+W, C]
                suffix,  # [T, Q, NS]
                lengths,
                cache[dev],
            )
            if inputs == "finals":
                return (*tier_args, q)
            # 4. finals tier: columns in prog.col_groups order after the buckets'.
            bh_all = torch.cat([bh_all, finals_match(*tier_args, q=q)], dim=1)
        # 0/1 operands, sums ≤ branches per group: exact in float32 and TF32.
        hits = (bh_all.to(torch.float32) @ dc.b2g) > 0
    if dc.always is not None:
        hits = hits | dc.always[None, :]
    return hits
