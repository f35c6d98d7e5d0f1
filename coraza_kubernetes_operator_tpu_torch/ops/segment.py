"""Conv-segment matcher (PyTorch): every match position of every segment in
ONE convolution, then gap-chaining as bitmap algebra.

Port of ``coraza_kubernetes_operator_tpu/ops/segment.py`` (its conv path;
the reference's Pallas finals tier is not ported — ``CKO_PALLAS_FINALS=1``
raises ``NotImplementedError`` here rather than being ignored).

1. **embed**: bytes → ``[T, C, Lp]`` channel planes from comparisons
   (nibble one-hots, class-interval tests, a constant ones plane).
2. **conv**: one ``conv1d`` with kernel ``[W, C, N]`` (the reference's
   channels-last ``[W, C, N]`` layout, permuted to torch's ``[N, C, W]``
   at the call). Each segment position contributes exactly 2 when its
   byte matches, so ``out == 2W`` ⇔ the segment matches at that window
   start.
3. **chain**: gap constraints as bitmap algebra on ``[T, Q, ·]`` blocks,
   suffix-deduped exactly as the reference lays them out.

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
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from ..compiler.re_parser import ALL_BYTES
from ..compiler.segments import Seg, SegmentPlan
from ..utils.device import resolve_device

# Above this Q the NCE prefix sum uses cumsum instead of a [Q, Q]
# triangular matmul — the table is O(Q²) and on long-body buckets (up to
# SecRequestBodyLimit) would be a request-triggerable multi-GB allocation.
_NCE_MATMUL_MAX_Q = 512


def _finals_kernel_requested() -> bool:
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


def _in_class(ivs: tuple, dpad: torch.Tensor) -> torch.Tensor:
    acc = torch.zeros_like(dpad, dtype=torch.bool)
    for lo, hi in ivs:
        acc = acc | ((dpad >= lo) & (dpad <= hi)) if lo != hi else acc | (dpad == lo)
    return acc


def _channel_plane(chan: tuple, dpad: torch.Tensor) -> torch.Tensor:
    kind = chan[0]
    if kind == "hi":
        return (dpad >> 4) == chan[1]
    if kind == "lo":
        return (dpad & 15) == chan[1]
    if kind == "one":
        return torch.ones_like(dpad, dtype=torch.bool)
    return _in_class(chan[1], dpad)  # ('ind', intervals)


def _shift(x: torch.Tensor, k: int, fill) -> torch.Tensor:
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


def conv_n2_cols(spec: SegmentSpec) -> int:
    """Duplicated/permuted conv output column count — ``len(col_order)``
    as ``match_segment_block`` will build it (the [T, Q, N2] conv output
    is what the row-chunk budget must count)."""
    n2 = 0
    suffix_ids: dict[tuple, int] = {}
    finals_chans: dict[tuple, set[int]] = {}
    for _, prog, a_start, a_end in spec.branches:
        if len(prog) >= 2 and prog[0][0] == "seg":
            skey = (prog[1:], a_end)
            sid = suffix_ids.setdefault(skey, len(suffix_ids))
            chan = prog[0][1]
            nl, nr = spec.seg_meta[chan]
            finals_chans.setdefault((sid, nl, nr, a_start), set()).add(chan)
        else:
            n2 += sum(1 for el in prog if el[0] == "seg")
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
) -> torch.Tensor:
    """Returns group hits [T, n_groups] bool."""
    if _finals_kernel_requested():
        raise NotImplementedError(
            "CKO_PALLAS_FINALS=1: the fused finals kernel is not ported; "
            "unset it to use the conv path"
        )
    t, ln = data.shape
    dev = data.device
    w = spec.w
    q = ln + 2  # chain positions: window starts 0 .. L+1
    lengths = lengths.to(torch.int32)
    # Front NUL pad (position 0) + right slack so every window is full.
    dpad = F.pad(data.to(torch.int32), (1, w))  # [T, 1+L+W]

    # 1. embed: channel planes from comparisons only, channels-first for conv1d.
    cdt = _conv_dtype(dev)
    embed = torch.stack([_channel_plane(c, dpad) for c in spec.channels], dim=1).to(cdt)

    # --- static chain program (pure Python) ---
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

    # --- conv column layout: every consumer reads a contiguous slice ---
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

    # 2. conv: all segments, all start positions. out[t, p, n] == 2W ⇔
    # segment n matches the window starting at padded position p.
    # Exactness: every operand is 0, 1 or 2 and every sum is at most
    # 2W ≤ 48, so bf16 (integers exact to 256), float32 and TF32 (cuDNN's
    # default for float32 convolutions) all give the exact integer — no
    # global precision flag is needed or set.
    kernel_p = kernel[:, :, torch.as_tensor(col_order, device=kernel.device)]
    weight = kernel_p.permute(2, 1, 0).to(device=dev, dtype=cdt).contiguous()  # [N2, C, W]
    if weight.shape[1]:
        out = F.conv1d(embed, weight)  # [T, N2, Q]
    else:  # no byte channels (always-match groups only): nothing matches
        out = torch.zeros((t, weight.shape[0], q), dtype=cdt, device=dev)
    m_all = (out >= 2.0 * w).permute(0, 2, 1)  # [T, Q, N2]

    def mslice(a0: int, a1: int) -> torch.Tensor:
        return m_all[:, :, a0:a1]

    iota = torch.arange(q, dtype=torch.int32, device=dev)[None, :]  # [1, Q]
    len1 = 1 + lengths[:, None]  # [T, 1] position just past the last byte
    iota3 = iota[..., None]  # [1, Q, 1]
    len3 = len1[..., None]  # [T, 1, 1]

    # NCE (count of non-class bytes before p) per gap class: a [Q, Q]
    # triangular matmul for small Q (0/1 operands, sums ≤ Q ≤ 512: exact
    # in float32 and in TF32), an exclusive cumsum above _NCE_MATMUL_MAX_Q.
    tri_excl = None
    _tabs_cache: dict[tuple, tuple] = {}
    for _, prog, _, _ in spec.branches:
        for el in prog:
            if el[0] == "gapcls" and el[1] not in _tabs_cache:
                in_c = _in_class(el[1], dpad)[:, :q]  # byte at p ∈ class
                if q > _NCE_MATMUL_MAX_Q:
                    non_i = (~in_c).to(torch.int32)
                    nce = torch.cumsum(non_i, dim=1, dtype=torch.int32) - non_i
                else:
                    if tri_excl is None:
                        tri_excl = torch.triu(
                            torch.ones((q, q), dtype=torch.float32, device=dev), 1
                        )  # [p', p]: p' < p
                    nce = ((~in_c).to(torch.float32) @ tri_excl).to(torch.int32)
                _tabs_cache[el[1]] = (in_c, nce)

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
        slots = bucket_alloc[sig]
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
    s_store: dict[int, torch.Tensor] = {}
    for sig_key, members in struct.items():
        sig_ops, a_end = sig_key
        ns = len(members)
        s = ((iota3 == len3) if a_end else (iota3 <= len3)).expand(t, q, ns)
        seg_slot = sum(1 for o in sig_ops if o[0] == "seg")
        for op in reversed(sig_ops):
            if op[0] == "seg":
                seg_slot -= 1
                _, n_lead, n_real = op
                a0, a1 = struct_alloc[sig_key][seg_slot]
                m = _rshift3(mslice(a0, a1), n_lead)  # index by real start
                valid = (iota3 >= 1) & (iota3 + n_real <= len3)
                s = m & valid & _lshift3(s, n_real)
            elif op[0] == "gapany":
                _, lo, hi = op
                s = _spread_or(s, lo, hi, forward=True)
            else:  # gapcls
                _, ivs, lo, hi = op
                s = gap_cls(s, ivs, lo, hi, forward=True)
        for i, (_skey, sid) in enumerate(members):
            s_store[sid] = s[:, :, i]

    hits = torch.zeros((t, spec.n_groups), dtype=torch.bool, device=dev)
    if spec.branches:
        cols: list[torch.Tensor] = []
        col_groups: list = []
        for sig, idxs in buckets.items():
            cols.append(run_bucket(sig, idxs))  # [T, len(idxs)]
            col_groups.extend(spec.branches[bi][0] for bi in idxs)
        for (sid, n_lead, n_real, a_start), _items in finals.items():
            s2 = s_store[sid]  # [T, Q], indexed by real start of the NEXT element
            g = (iota >= 1) & (iota + n_real <= len1) & _shift(s2, n_real, False)
            if a_start:
                g = g & (iota == 1)
            gj = _shift(g, n_lead, False)  # window-start index
            a0, a1 = final_alloc[(sid, n_lead, n_real, a_start)]
            cols.append((mslice(a0, a1) & gj[:, :, None]).any(dim=1))  # [T, NB]
        for gk in finals:
            col_groups.extend(final_gidsets[gk])  # deduped: one col → gid set
        bh_all = torch.cat(cols, dim=1)
        b2g = np.zeros((len(col_groups), spec.n_groups), dtype=np.float32)
        for ci, gid in enumerate(col_groups):
            if isinstance(gid, set):
                for g in gid:
                    b2g[ci, g] = 1
            else:
                b2g[ci, gid] = 1
        # 0/1 operands, sums ≤ branches per group: exact in float32 and TF32.
        hits = (bh_all.to(torch.float32) @ torch.as_tensor(b2g, device=dev)) > 0
    if spec.always:
        al = torch.zeros(spec.n_groups, dtype=torch.bool, device=dev)
        al[list(spec.always)] = True
        hits = hits | al[None, :]
    return hits
