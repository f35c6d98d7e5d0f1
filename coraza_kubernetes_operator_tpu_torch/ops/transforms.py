"""Vectorized Seclang transformations over padded byte batches (PyTorch).

Port of ``coraza_kubernetes_operator_tpu/ops/transforms.py``. Layout
convention: ``data`` is ``[N, L]`` uint8, zero-padded past ``lengths``
(``[N]`` int32). Every transform maps ``(data, lengths) → (data, lengths)``
with the same ``L`` (all device transforms are length-preserving or
contracting; expanding transforms run host-side, see
``compiler/transforms_host.py``).

Contraction (e.g. ``%41`` → ``A``) moves every kept byte to its
destination column (exclusive prefix count of kept bytes) with one
``scatter_``: destinations of kept bytes are distinct, dropped bytes all
land in one spare column that is cut off, so the result is exact and
deterministic. Decode start positions are provably non-overlapping (hex
digits and entity bodies cannot contain ``%``/``&``), so the parallel
decode is exactly equivalent to the sequential host reference.
"""

from __future__ import annotations

import torch


def _valid_mask(data: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    idx = torch.arange(data.shape[1], dtype=torch.int32, device=data.device)
    return idx[None, :] < lengths[:, None]


def _hexval(b: torch.Tensor) -> torch.Tensor:
    """Hex digit value of byte, -1 for non-hex."""
    b = b.to(torch.int32)
    dig = (b >= 0x30) & (b <= 0x39)
    low = (b >= 0x61) & (b <= 0x66)
    upp = (b >= 0x41) & (b <= 0x46)
    neg = torch.full_like(b, -1)
    return torch.where(
        dig, b - 0x30, torch.where(low, b - 0x57, torch.where(upp, b - 0x37, neg))
    )


def _digitval(b: torch.Tensor) -> torch.Tensor:
    b = b.to(torch.int32)
    return torch.where((b >= 0x30) & (b <= 0x39), b - 0x30, torch.full_like(b, -1))


def _is_ws(b: torch.Tensor) -> torch.Tensor:
    return ((b >= 0x09) & (b <= 0x0D)) | (b == 0x20)


def _to_lower(b: torch.Tensor) -> torch.Tensor:
    up = (b >= 0x41) & (b <= 0x5A)
    return torch.where(up, b + 0x20, b)


def _to_upper(b: torch.Tensor) -> torch.Tensor:
    lo = (b >= 0x61) & (b <= 0x7A)
    return torch.where(lo, b - 0x20, b)


def _shift_left(x: torch.Tensor, k: int, fill=0) -> torch.Tensor:
    """x[:, i] ← x[:, i+k] (reads past the end become ``fill``)."""
    if k == 0:
        return x
    pad = torch.full((x.shape[0], k), fill, dtype=x.dtype, device=x.device)
    return torch.cat([x[:, k:], pad], dim=1)


def _shift_right(x: torch.Tensor, k: int, fill=0) -> torch.Tensor:
    """x[:, i] ← x[:, i-k]."""
    if k == 0:
        return x
    pad = torch.full((x.shape[0], k), fill, dtype=x.dtype, device=x.device)
    return torch.cat([pad, x[:, : x.shape[1] - k]], dim=1)


def compact(data: torch.Tensor, keep: torch.Tensor):
    """Stably move kept bytes to the front of each row; zero-pad the rest.
    Returns (data, new_lengths)."""
    n, length = data.shape
    keep_i = keep.to(torch.int32)
    pos = torch.cumsum(keep_i, dim=1, dtype=torch.int32) - keep_i
    new_len = keep_i.sum(dim=1, dtype=torch.int32)
    dest = torch.where(keep, pos, torch.full_like(pos, length)).to(torch.int64)
    out = torch.zeros((n, length + 1), dtype=data.dtype, device=data.device)
    out.scatter_(1, dest, data)
    return out[:, :length].contiguous(), new_len


def lowercase(data, lengths):
    return _to_lower(data), lengths


def uppercase(data, lengths):
    return _to_upper(data), lengths


def replace_nulls(data, lengths):
    valid = _valid_mask(data, lengths)
    return torch.where(valid & (data == 0), torch.full_like(data, 0x20), data), lengths


def remove_nulls(data, lengths):
    valid = _valid_mask(data, lengths)
    return compact(data, valid & (data != 0))


def remove_whitespace(data, lengths):
    valid = _valid_mask(data, lengths)
    return compact(data, valid & ~_is_ws(data))


def compress_whitespace(data, lengths):
    valid = _valid_mask(data, lengths)
    ws = _is_ws(data) & valid
    out = torch.where(ws, torch.full_like(data, 0x20), data)
    prev_ws = _shift_right(ws, 1, fill=False)
    return compact(out, valid & ~(ws & prev_ws))


def _ws_bounds(data, lengths):
    valid = _valid_mask(data, lengths)
    non_ws = valid & ~_is_ws(data)
    idx = torch.arange(data.shape[1], dtype=torch.int32, device=data.device)[None, :]
    big = torch.full_like(idx, data.shape[1] + 1)
    first = torch.where(non_ws, idx, big).amin(dim=1, keepdim=True)
    last = torch.where(non_ws, idx, torch.full_like(idx, -1)).amax(dim=1, keepdim=True)
    return valid, idx, first, last


def trim(data, lengths):
    _valid, idx, first, last = _ws_bounds(data, lengths)
    return compact(data, (idx >= first) & (idx <= last))


def trim_left(data, lengths):
    valid, idx, first, _last = _ws_bounds(data, lengths)
    return compact(data, valid & (idx >= first))


def trim_right(data, lengths):
    valid, idx, _first, last = _ws_bounds(data, lengths)
    return compact(data, valid & (idx <= last))


def url_decode(data, lengths, uni: bool = False):
    """``%XX`` (+ optionally IIS ``%uXXXX``) decode, ``+`` → space.

    Start positions never overlap a decode tail ('%' is not a hex digit and
    not 'u'), so the parallel formulation matches the sequential oracle."""
    valid = _valid_mask(data, lengths)
    d = [_shift_left(data, k) for k in range(6)]
    h = [_hexval(d[k]) for k in range(6)]
    in_bounds = [_shift_left(valid, k, fill=False) for k in range(6)]

    is_pct = (data == 0x25) & valid
    start_u = torch.zeros_like(is_pct)
    dec_u = torch.zeros(data.shape, dtype=torch.int32, device=data.device)
    if uni:
        is_u = (d[1] == 0x75) | (d[1] == 0x55)
        hex4 = (h[2] >= 0) & (h[3] >= 0) & (h[4] >= 0) & (h[5] >= 0)
        start_u = is_pct & is_u & hex4 & in_bounds[5]
        dec_u = (h[4] * 16 + h[5]) & 0xFF  # low byte, matching the host oracle

    start_2 = is_pct & ~start_u & (h[1] >= 0) & (h[2] >= 0) & in_bounds[2]
    dec_2 = h[1] * 16 + h[2]

    killed = torch.zeros_like(is_pct)
    for k in (1, 2):
        killed |= _shift_right(start_2, k, fill=False)
    if uni:
        for k in range(1, 6):
            killed |= _shift_right(start_u, k, fill=False)

    out = torch.where(start_u, (dec_u & 0xFF).to(torch.uint8), data)
    out = torch.where(start_2, (dec_2 & 0xFF).to(torch.uint8), out)
    out = torch.where((data == 0x2B) & valid, torch.full_like(out, 0x20), out)
    return compact(out, valid & ~killed)


def url_decode_uni(data, lengths):
    return url_decode(data, lengths, uni=True)


_ENTITY_NAMES = [  # (lowercased name bytes, decoded byte)
    (b"lt", 0x3C),
    (b"gt", 0x3E),
    (b"amp", 0x26),
    (b"quot", 0x22),
    (b"nbsp", 0xA0),
]
_MAX_ENTITY = 11  # &#xHHHHHHHH; worst case span we scan


def html_entity_decode(data, lengths):
    """Decode ``&#DD;``, ``&#xHH;`` and the named entities ModSecurity
    supports. Entity bodies can't contain '&', so parallel decode is exact."""
    valid = _valid_mask(data, lengths)
    lower = _to_lower(data)
    d = [_shift_left(data, k) for k in range(_MAX_ENTITY + 1)]
    dl = [_shift_left(lower, k) for k in range(_MAX_ENTITY + 1)]
    hv = [_hexval(x) for x in d]
    dv = [_digitval(x) for x in d]
    vb = [_shift_left(valid, k, fill=False) for k in range(_MAX_ENTITY + 1)]

    amp = (data == 0x26) & valid
    hash_ = d[1] == 0x23
    is_x = (d[2] == 0x78) | (d[2] == 0x58)

    # span[i] = total entity length at start i (0 = none); value[i] = byte.
    span = torch.zeros(data.shape, dtype=torch.int32, device=data.device)
    value = torch.zeros(data.shape, dtype=torch.int32, device=data.device)

    # Hex entities &#xH{1..7}; — longest digit runs first so shorter
    # prefixes with a hex digit where ';' should be don't win.
    for ndig in range(7, 0, -1):
        digs = torch.ones(data.shape, dtype=torch.bool, device=data.device)
        val = torch.zeros(data.shape, dtype=torch.int32, device=data.device)
        for k in range(ndig):
            digs &= hv[3 + k] >= 0
            val = val * 16 + hv[3 + k].clamp(min=0)
        semi = d[3 + ndig] == 0x3B
        ok = amp & hash_ & is_x & digs & semi & vb[3 + ndig] & (span == 0)
        span = torch.where(ok, torch.full_like(span, 4 + ndig), span)
        value = torch.where(ok, val & 0xFF, value)

    # Decimal entities &#D{1..7};
    for ndig in range(7, 0, -1):
        digs = torch.ones(data.shape, dtype=torch.bool, device=data.device)
        val = torch.zeros(data.shape, dtype=torch.int32, device=data.device)
        for k in range(ndig):
            digs &= dv[2 + k] >= 0
            val = val * 10 + dv[2 + k].clamp(min=0)
        semi = d[2 + ndig] == 0x3B
        ok = amp & hash_ & ~is_x & digs & semi & vb[2 + ndig] & (span == 0)
        span = torch.where(ok, torch.full_like(span, 3 + ndig), span)
        value = torch.where(ok, val & 0xFF, value)

    # Named entities (case-insensitive), e.g. &lt;
    for name, byte in _ENTITY_NAMES:
        match = torch.ones(data.shape, dtype=torch.bool, device=data.device)
        for k, ch in enumerate(name):
            match &= dl[1 + k] == ch
        semi = d[1 + len(name)] == 0x3B
        ok = amp & ~hash_ & match & semi & vb[1 + len(name)] & (span == 0)
        span = torch.where(ok, torch.full_like(span, 2 + len(name)), span)
        value = torch.where(ok, torch.full_like(value, byte), value)

    started = span > 0
    killed = torch.zeros_like(amp)
    for k in range(1, _MAX_ENTITY + 1):
        killed |= _shift_right(span, k, fill=0) > k

    out = torch.where(started, value.to(torch.uint8), data)
    return compact(out, valid & ~killed)


# Registry of device transforms, keyed by canonical Seclang name. The ruleset
# compiler checks this to decide device vs host execution of a pipeline.
DEVICE_TRANSFORMS = {
    "none": lambda d, l: (d, l),
    "lowercase": lowercase,
    "uppercase": uppercase,
    "urldecode": url_decode,
    "urldecodeuni": url_decode_uni,
    "htmlentitydecode": html_entity_decode,
    "removenulls": remove_nulls,
    "replacenulls": replace_nulls,
    "removewhitespace": remove_whitespace,
    "compresswhitespace": compress_whitespace,
    "trim": trim,
    "trimleft": trim_left,
    "trimright": trim_right,
}


def apply_device_pipeline(data, lengths, transforms: tuple[str, ...]):
    for name in transforms:
        data, lengths = DEVICE_TRANSFORMS[name](data, lengths)
    return data, lengths
