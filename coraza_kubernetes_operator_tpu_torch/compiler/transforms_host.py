"""Host (reference) implementations of Seclang transformation functions.

These are the exact-semantics oracles: the device kernels in
``ops/transforms.py`` are differential-tested against these, and transforms
without a device kernel yet run here during target extraction. Semantics
follow ModSecurity/Coraza (the engine the reference validates against via
``coraza.NewWAF``, ``internal/controller/ruleset_controller.go:158-171``);
the transform names come from the reference corpus (``t:none``,
``t:urlDecodeUni``, ``t:htmlEntityDecode``, ``t:lowercase`` in
``config/samples/ruleset.yaml`` and ``hack/generate_coreruleset_configmaps.py``).
"""

from __future__ import annotations

import base64
import hashlib

_HEX = b"0123456789abcdefABCDEF"


def _is_hex(b: int) -> bool:
    return b in _HEX


def _hex_val(b: int) -> int:
    return int(chr(b), 16)


def t_none(data: bytes) -> bytes:
    return data


def t_lowercase(data: bytes) -> bytes:
    return data.lower()


def t_uppercase(data: bytes) -> bytes:
    return data.upper()


def t_urldecode(data: bytes) -> bytes:
    out = bytearray()
    i, n = 0, len(data)
    while i < n:
        c = data[i]
        if c == 0x25:  # '%'
            if i + 2 < n and _is_hex(data[i + 1]) and _is_hex(data[i + 2]):
                out.append(_hex_val(data[i + 1]) * 16 + _hex_val(data[i + 2]))
                i += 3
                continue
            out.append(c)
            i += 1
        elif c == 0x2B:  # '+'
            out.append(0x20)
            i += 1
        else:
            out.append(c)
            i += 1
    return bytes(out)


def t_urldecodeuni(data: bytes) -> bytes:
    """URL decode with IIS %uXXXX support (low byte taken when the code point
    exceeds one byte, matching ModSecurity's fallback behavior)."""
    out = bytearray()
    i, n = 0, len(data)
    while i < n:
        c = data[i]
        if c == 0x25:  # '%'
            if (
                i + 5 < n
                and data[i + 1] in (0x75, 0x55)  # u/U
                and all(_is_hex(data[i + 2 + k]) for k in range(4))
            ):
                val = int(data[i + 2 : i + 6].decode("ascii"), 16)
                out.append(val & 0xFF)
                i += 6
                continue
            if i + 2 < n and _is_hex(data[i + 1]) and _is_hex(data[i + 2]):
                out.append(_hex_val(data[i + 1]) * 16 + _hex_val(data[i + 2]))
                i += 3
                continue
            out.append(c)
            i += 1
        elif c == 0x2B:
            out.append(0x20)
            i += 1
        else:
            out.append(c)
            i += 1
    return bytes(out)


_NAMED_ENTITIES = {
    b"quot": 0x22,
    b"amp": 0x26,
    b"lt": 0x3C,
    b"gt": 0x3E,
    b"nbsp": 0xA0,
}


def t_htmlentitydecode(data: bytes) -> bytes:
    out = bytearray()
    i, n = 0, len(data)
    while i < n:
        c = data[i]
        if c != 0x26:  # '&'
            out.append(c)
            i += 1
            continue
        # &#xHH...; | &#DD...; | &name;
        j = i + 1
        if j < n and data[j] == 0x23:  # '#'
            j += 1
            if j < n and data[j] in (0x78, 0x58):  # x/X
                j += 1
                start = j
                while j < n and _is_hex(data[j]) and j - start < 7:
                    j += 1
                if j > start and j < n and data[j] == 0x3B:
                    out.append(int(data[start:j].decode("ascii"), 16) & 0xFF)
                    i = j + 1
                    continue
            else:
                start = j
                while j < n and 0x30 <= data[j] <= 0x39 and j - start < 7:
                    j += 1
                if j > start and j < n and data[j] == 0x3B:
                    out.append(int(data[start:j].decode("ascii")) & 0xFF)
                    i = j + 1
                    continue
        else:
            start = j
            while (
                j < n
                and (
                    0x30 <= data[j] <= 0x39
                    or 0x41 <= data[j] <= 0x5A
                    or 0x61 <= data[j] <= 0x7A
                )
                and j - start < 8
            ):
                j += 1
            name = bytes(data[start:j]).lower()
            if j < n and data[j] == 0x3B and name in _NAMED_ENTITIES:
                out.append(_NAMED_ENTITIES[name])
                i = j + 1
                continue
        out.append(c)
        i += 1
    return bytes(out)


def t_removenulls(data: bytes) -> bytes:
    return data.replace(b"\x00", b"")


def t_replacenulls(data: bytes) -> bytes:
    return data.replace(b"\x00", b" ")


_WHITESPACE = b" \t\n\r\f\v"


def t_removewhitespace(data: bytes) -> bytes:
    return bytes(b for b in data if b not in _WHITESPACE)


def t_compresswhitespace(data: bytes) -> bytes:
    out = bytearray()
    in_ws = False
    for b in data:
        if b in _WHITESPACE:
            if not in_ws:
                out.append(0x20)
            in_ws = True
        else:
            out.append(b)
            in_ws = False
    return bytes(out)


def t_trim(data: bytes) -> bytes:
    return data.strip()


def t_trimleft(data: bytes) -> bytes:
    return data.lstrip()


def t_trimright(data: bytes) -> bytes:
    return data.rstrip()


def t_replacecomments(data: bytes) -> bytes:
    """Replace each C-style /*...*/ comment with one space; an unterminated
    comment is replaced to end of input."""
    out = bytearray()
    i, n = 0, len(data)
    while i < n:
        if data[i] == 0x2F and i + 1 < n and data[i + 1] == 0x2A:  # /*
            end = data.find(b"*/", i + 2)
            out.append(0x20)
            if end == -1:
                break
            i = end + 2
        else:
            out.append(data[i])
            i += 1
    return bytes(out)


def t_removecomments(data: bytes) -> bytes:
    """Remove C-style comments, SQL line comments (-- and #) to end of line,
    and HTML comment markers."""
    out = bytearray()
    i, n = 0, len(data)
    while i < n:
        if data[i] == 0x2F and i + 1 < n and data[i + 1] == 0x2A:  # /*
            end = data.find(b"*/", i + 2)
            if end == -1:
                break
            i = end + 2
            continue
        if data[i : i + 4] == b"<!--":
            i += 4
            continue
        if data[i : i + 3] == b"-->":
            i += 3
            continue
        if data[i : i + 2] == b"--" or data[i] == 0x23:  # -- | #
            nl = data.find(b"\n", i)
            if nl == -1:
                break
            i = nl
            continue
        out.append(data[i])
        i += 1
    return bytes(out)


def t_removecommentschar(data: bytes) -> bytes:
    """Remove comment *markers* (/* */ -- # <!-- -->) leaving content."""
    out = bytearray()
    i, n = 0, len(data)
    while i < n:
        for marker in (b"/*", b"*/", b"<!--", b"-->", b"--"):
            if data[i : i + len(marker)] == marker:
                i += len(marker)
                break
        else:
            if data[i] == 0x23:  # '#'
                i += 1
            else:
                out.append(data[i])
                i += 1
    return bytes(out)


def _normalize_path(data: bytes, win: bool) -> bytes:
    if win:
        data = data.replace(b"\\", b"/")
    leading = data.startswith(b"/")
    trailing = data.endswith(b"/") or data.endswith(b"/.") or data.endswith(b"/..")
    parts: list[bytes] = []
    for seg in data.split(b"/"):
        if seg == b"" or seg == b".":
            continue
        if seg == b"..":
            if parts and parts[-1] != b"..":
                parts.pop()
            elif not leading:
                parts.append(seg)
            continue
        parts.append(seg)
    out = b"/".join(parts)
    if leading:
        out = b"/" + out
    if trailing and out and not out.endswith(b"/"):
        out += b"/"
    return out


def t_normalizepath(data: bytes) -> bytes:
    return _normalize_path(data, win=False)


def t_normalizepathwin(data: bytes) -> bytes:
    return _normalize_path(data, win=True)


def t_cmdline(data: bytes) -> bytes:
    """ModSecurity cmdLine: delete \\ " ' ^; delete spaces before / and (;
    replace , and ; with space; lowercase; compress whitespace runs."""
    s = bytearray()
    for b in data:
        if b in b'\\"\'^':
            continue
        if b in b",;":
            b = 0x20
        s.append(b)
    # delete whitespace before / and (
    out = bytearray()
    for b in s:
        if b in b"/(":
            while out and out[-1] in _WHITESPACE:
                out.pop()
        out.append(b)
    # lowercase + compress
    return t_compresswhitespace(bytes(out).lower())


def t_jsdecode(data: bytes) -> bytes:
    r"""Decode JavaScript escapes: \xHH, \uHHHH (low byte), \OOO octal,
    single-char escapes; invalid escapes drop the backslash."""
    out = bytearray()
    i, n = 0, len(data)
    single = {0x61: 7, 0x62: 8, 0x66: 12, 0x6E: 10, 0x72: 13, 0x74: 9, 0x76: 11}
    while i < n:
        c = data[i]
        if c != 0x5C or i + 1 >= n:  # '\'
            out.append(c)
            i += 1
            continue
        e = data[i + 1]
        if e in (0x78, 0x58) and i + 3 < n and _is_hex(data[i + 2]) and _is_hex(data[i + 3]):
            out.append(_hex_val(data[i + 2]) * 16 + _hex_val(data[i + 3]))
            i += 4
        elif e == 0x75 and i + 5 < n and all(_is_hex(data[i + 2 + k]) for k in range(4)):
            out.append(int(data[i + 2 : i + 6].decode("ascii"), 16) & 0xFF)
            i += 6
        elif 0x30 <= e <= 0x37:
            j = i + 1
            val = 0
            while j < n and 0x30 <= data[j] <= 0x37 and j - i <= 3:
                val = val * 8 + (data[j] - 0x30)
                j += 1
            out.append(val & 0xFF)
            i = j
        elif e in single:
            out.append(single[e])
            i += 2
        else:
            out.append(e)
            i += 2
    return bytes(out)


def t_cssdecode(data: bytes) -> bytes:
    r"""Decode CSS escapes: \ followed by up to 6 hex digits (optionally one
    trailing whitespace swallowed), or an escaped literal char."""
    out = bytearray()
    i, n = 0, len(data)
    while i < n:
        c = data[i]
        if c != 0x5C or i + 1 >= n:
            out.append(c)
            i += 1
            continue
        j = i + 1
        start = j
        while j < n and _is_hex(data[j]) and j - start < 6:
            j += 1
        if j > start:
            out.append(int(data[start:j].decode("ascii"), 16) & 0xFF)
            if j < n and data[j] in b" \t\n\r\f":
                j += 1
            i = j
        else:
            out.append(data[i + 1])
            i += 2
    return bytes(out)


_B64_CHARS = set(b"ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz0123456789+/=")


def t_base64decode(data: bytes) -> bytes:
    """Decode base64 up to the first invalid character (forgiving, like
    ModSecurity: leading valid prefix is decoded)."""
    end = 0
    while end < len(data) and data[end] in _B64_CHARS:
        end += 1
    chunk = data[:end]
    chunk = chunk[: len(chunk) - len(chunk) % 4] if len(chunk) % 4 else chunk
    try:
        return base64.b64decode(chunk, validate=False)
    except Exception:
        return b""


def t_base64decodeext(data: bytes) -> bytes:
    """Decode base64 skipping invalid characters entirely."""
    filtered = bytes(b for b in data if b in _B64_CHARS and b != 0x3D)
    filtered += b"=" * (-len(filtered) % 4)
    try:
        return base64.b64decode(filtered, validate=False)
    except Exception:
        return b""


def t_base64encode(data: bytes) -> bytes:
    return base64.b64encode(data)


def t_hexdecode(data: bytes) -> bytes:
    filtered = bytes(b for b in data if _is_hex(b))
    if len(filtered) % 2:
        filtered = filtered[:-1]
    return bytes.fromhex(filtered.decode("ascii")) if filtered else b""


def t_hexencode(data: bytes) -> bytes:
    return data.hex().encode("ascii")


def t_urlencode(data: bytes) -> bytes:
    out = bytearray()
    for b in data:
        # ASCII alnum only: chr().isalnum() is also True for Latin-1 letters
        # (0xB5, 0xC0-0xFF...), which ModSecurity's urlEncode does encode.
        if 0x30 <= b <= 0x39 or 0x41 <= b <= 0x5A or 0x61 <= b <= 0x7A or b in b"-_.":
            out.append(b)
        else:
            out += b"%%%02x" % b
    return bytes(out)


def t_escapeseqdecode(data: bytes) -> bytes:
    """ANSI C escape sequence decode (\\n, \\xHH, \\OOO, ...)."""
    return t_jsdecode(data)


def t_utf8tounicode(data: bytes) -> bytes:
    """Convert UTF-8 multi-byte sequences to %uHHHH form (ModSecurity
    utf8toUnicode)."""
    out = bytearray()
    i, n = 0, len(data)
    while i < n:
        b = data[i]
        if b < 0x80:
            out.append(b)
            i += 1
            continue
        # try to decode a multi-byte sequence
        for width in (2, 3, 4):
            try:
                cp = data[i : i + width].decode("utf-8")
                out += b"%%u%04x" % ord(cp)
                i += width
                break
            except (UnicodeDecodeError, ValueError):
                continue
        else:
            out.append(b)
            i += 1
    return bytes(out)


def t_md5(data: bytes) -> bytes:
    return hashlib.md5(data).digest()


def t_sha1(data: bytes) -> bytes:
    return hashlib.sha1(data).digest()


def t_length(data: bytes) -> bytes:
    return str(len(data)).encode("ascii")


TRANSFORMS = {
    "none": t_none,
    "lowercase": t_lowercase,
    "uppercase": t_uppercase,
    "urldecode": t_urldecode,
    "urldecodeuni": t_urldecodeuni,
    "urlencode": t_urlencode,
    "htmlentitydecode": t_htmlentitydecode,
    "removenulls": t_removenulls,
    "replacenulls": t_replacenulls,
    "removewhitespace": t_removewhitespace,
    "compresswhitespace": t_compresswhitespace,
    "trim": t_trim,
    "trimleft": t_trimleft,
    "trimright": t_trimright,
    "removecomments": t_removecomments,
    "removecommentschar": t_removecommentschar,
    "replacecomments": t_replacecomments,
    "normalisepath": t_normalizepath,
    "normalizepath": t_normalizepath,
    "normalisepathwin": t_normalizepathwin,
    "normalizepathwin": t_normalizepathwin,
    "cmdline": t_cmdline,
    "jsdecode": t_jsdecode,
    "cssdecode": t_cssdecode,
    "base64decode": t_base64decode,
    "base64decodeext": t_base64decodeext,
    "base64encode": t_base64encode,
    "hexdecode": t_hexdecode,
    "hexencode": t_hexencode,
    "escapeseqdecode": t_escapeseqdecode,
    "utf8tounicode": t_utf8tounicode,
    "md5": t_md5,
    "sha1": t_sha1,
    "length": t_length,
}


def apply_pipeline(data: bytes, transforms: list[str]) -> bytes:
    """Apply a ``t:...`` pipeline in order. ``t:none`` resets the pipeline —
    mirroring ModSecurity, the parser hands us the already-normalized order,
    so here ``none`` is just identity."""
    for name in transforms:
        fn = TRANSFORMS.get(name)
        if fn is None:
            raise KeyError(f"transformation {name!r} not implemented")
        data = fn(data)
    return data
