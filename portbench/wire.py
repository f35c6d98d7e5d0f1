"""Envoy ext_proc on the wire, as the load generator speaks it: HTTP/2
frames, gRPC message framing, a literal-only HPACK encoder and the
protobuf subset of ``ProcessingRequest``/``ProcessingResponse``.

A frozen copy of the client half of the port's ``sidecar/extproc.py``, so
that a change to the port's codec cannot move the yardstick.
"""

from __future__ import annotations

EXTPROC_METHOD = b"/envoy.service.ext_proc.v3.ExternalProcessor/Process"
H2_PREFACE = b"PRI * HTTP/2.0\r\n\r\nSM\r\n\r\n"

F_DATA, F_HEADERS, F_RST_STREAM, F_SETTINGS = 0x0, 0x1, 0x3, 0x4
F_PING, F_GOAWAY, F_WINDOW_UPDATE, F_CONTINUATION = 0x6, 0x7, 0x8, 0x9
FLAG_END_STREAM = FLAG_ACK = 0x1
FLAG_END_HEADERS, FLAG_PADDED = 0x4, 0x8
MAX_DATA = 16384
WINDOW_BONUS = 1 << 24

_WT_VARINT, _WT_I64, _WT_LEN, _WT_I32 = 0, 1, 2, 5
_PREQ_REQUEST_HEADERS, _PREQ_REQUEST_BODY = 2, 4
_PRESP_REQUEST_HEADERS, _PRESP_REQUEST_BODY, _PRESP_IMMEDIATE = 1, 3, 7
_HH_HEADERS, _HH_END_OF_STREAM = 1, 3
_HM_HEADERS, _HV_KEY, _HV_VALUE, _HV_RAW_VALUE = 1, 1, 2, 3
_HB_BODY, _HB_END_OF_STREAM = 1, 2
_HR_RESPONSE, _CR_HEADER_MUTATION = 1, 2
_MUT_SET_HEADERS, _HVO_HEADER = 1, 1
_IR_STATUS, _IR_HEADERS, _IR_BODY, _HTTP_STATUS_CODE = 1, 2, 3, 1


def _varint(out: bytearray, value: int) -> None:
    while True:
        b = value & 0x7F
        value >>= 7
        if not value:
            out.append(b)
            return
        out.append(b | 0x80)


def _read_varint(data: bytes, i: int) -> tuple[int, int]:
    shift = value = 0
    while True:
        if i >= len(data):
            raise ValueError("truncated varint")
        b = data[i]
        i += 1
        value |= (b & 0x7F) << shift
        if not b & 0x80:
            return value, i
        shift += 7
        if shift > 63:
            raise ValueError("varint too long")


def _fields(data: bytes):
    i, n = 0, len(data)
    while i < n:
        tag, i = _read_varint(data, i)
        field, wt = tag >> 3, tag & 7
        if wt == _WT_VARINT:
            v, i = _read_varint(data, i)
            yield field, wt, v
        elif wt == _WT_LEN:
            ln, i = _read_varint(data, i)
            if i + ln > n:
                raise ValueError("truncated length-delimited field")
            yield field, wt, data[i:i + ln]
            i += ln
        elif wt in (_WT_I64, _WT_I32):
            i += 8 if wt == _WT_I64 else 4
        else:
            raise ValueError(f"unsupported wire type {wt}")


def _field(field: int, payload: bytes) -> bytes:
    out = bytearray()
    _varint(out, (field << 3) | _WT_LEN)
    _varint(out, len(payload))
    return bytes(out + payload)


def _field_varint(field: int, value: int) -> bytes:
    out = bytearray()
    _varint(out, (field << 3) | _WT_VARINT)
    _varint(out, value)
    return bytes(out)


def encode_request_headers(headers: list, end_of_stream: bool) -> bytes:
    hmap = b"".join(_field(_HM_HEADERS, _field(_HV_KEY, k.encode("latin-1"))
                           + _field(_HV_VALUE, v.encode("latin-1"))) for k, v in headers)
    inner = _field(_HH_HEADERS, hmap)
    if end_of_stream:
        inner += _field_varint(_HH_END_OF_STREAM, 1)
    return _field(_PREQ_REQUEST_HEADERS, inner)


def encode_request_body(body: bytes) -> bytes:
    return _field(_PREQ_REQUEST_BODY, _field(_HB_BODY, body) + _field_varint(_HB_END_OF_STREAM, 1))


def _mutation_headers(data: bytes) -> dict:
    headers = {}
    for field, wt, value in _fields(data):
        if field != _MUT_SET_HEADERS or wt != _WT_LEN:
            continue
        for f2, w2, v2 in _fields(value):
            if f2 == _HVO_HEADER and w2 == _WT_LEN:
                key = val = b""
                for f3, w3, v3 in _fields(v2):
                    if f3 == _HV_KEY and w3 == _WT_LEN:
                        key = v3
                    elif f3 in (_HV_VALUE, _HV_RAW_VALUE) and w3 == _WT_LEN:
                        val = v3
                if key:
                    headers[key.decode("latin-1").lower()] = val.decode("latin-1")
    return headers


def decode_response(data: bytes) -> dict:
    """``{"kind": "immediate", status, headers}`` or ``{"kind": "continue",
    phase, headers}`` (phase ``request_headers``/``request_body``)."""
    for field, wt, value in _fields(data):
        if wt != _WT_LEN:
            continue
        if field == _PRESP_IMMEDIATE:
            status, headers = 0, {}
            for f2, w2, v2 in _fields(value):
                if f2 == _IR_STATUS and w2 == _WT_LEN:
                    for f3, w3, v3 in _fields(v2):
                        if f3 == _HTTP_STATUS_CODE and w3 == _WT_VARINT:
                            status = v3
                elif f2 == _IR_HEADERS and w2 == _WT_LEN:
                    headers = _mutation_headers(v2)
            return {"kind": "immediate", "status": status, "headers": headers}
        if field in (_PRESP_REQUEST_HEADERS, _PRESP_REQUEST_BODY):
            headers = {}
            for f2, w2, v2 in _fields(value):
                if f2 == _HR_RESPONSE and w2 == _WT_LEN:
                    for f3, w3, v3 in _fields(v2):
                        if f3 == _CR_HEADER_MUTATION and w3 == _WT_LEN:
                            headers = _mutation_headers(v3)
            phase = "request_headers" if field == _PRESP_REQUEST_HEADERS else "request_body"
            return {"kind": "continue", "phase": phase, "headers": headers}
    return {"kind": "unknown"}


def hpack_literals(headers: list) -> bytes:
    """Every header as a literal without indexing, raw strings."""
    out = bytearray()
    for name, value in headers:
        out.append(0x00)
        for s in (name, value):
            _hpack_int(out, len(s))
            out += s
    return bytes(out)


def _hpack_int(out: bytearray, value: int) -> None:
    if value < 0x7F:
        out.append(value)
        return
    out.append(0x7F)
    value -= 0x7F
    while value >= 0x80:
        out.append((value & 0x7F) | 0x80)
        value >>= 7
    out.append(value)


def frame(ftype: int, flags: int, stream_id: int, payload: bytes = b"") -> bytes:
    return (len(payload).to_bytes(3, "big") + bytes((ftype, flags))
            + (stream_id & 0x7FFFFFFF).to_bytes(4, "big") + payload)


def data_frames(stream_id: int, message: bytes, end_stream: bool) -> bytes:
    """One gRPC message as DATA frames of at most ``MAX_DATA`` bytes."""
    payload = b"\x00" + len(message).to_bytes(4, "big") + message
    chunks = [payload[i:i + MAX_DATA] for i in range(0, len(payload), MAX_DATA)]
    last = len(chunks) - 1
    return b"".join(frame(F_DATA, FLAG_END_STREAM if end_stream and k == last else 0, stream_id, c)
                    for k, c in enumerate(chunks))


def connection_preface() -> bytes:
    return (H2_PREFACE + frame(F_SETTINGS, 0, 0, (0x4).to_bytes(2, "big") + WINDOW_BONUS.to_bytes(4, "big"))
            + frame(F_WINDOW_UPDATE, 0, 0, WINDOW_BONUS.to_bytes(4, "big")))


def stream_headers(authority: bytes) -> bytes:
    """The gRPC call's HPACK block (the same for every stream)."""
    return hpack_literals([(b":method", b"POST"), (b":scheme", b"http"), (b":path", EXTPROC_METHOD),
                           (b":authority", authority), (b"content-type", b"application/grpc"),
                           (b"te", b"trailers")])
