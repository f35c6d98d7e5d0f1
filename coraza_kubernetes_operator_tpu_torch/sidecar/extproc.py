"""First-party Envoy ext_proc data plane (docs/EXTPROC.md).

The reference operator never evaluates a request itself — it attaches
``coraza-proxy-wasm`` to the mesh and lets Envoy call it. This module is
the equivalent attachment surface for the engine on the card: a gRPC
``envoy.service.ext_proc.v3.ExternalProcessor`` server running alongside
the HTTP frontends, so a real Envoy (Istio gateway or raw) can stream
live traffic through the same batcher and reply builders the HTTP
frontends use — parity by construction, never by transcription.

In repo style the transport is a dependency-free subset of the stack a
generated stub would hide:

- **HTTP/2 framing** (RFC 9113): preface, SETTINGS/PING/WINDOW_UPDATE/
  RST_STREAM/GOAWAY handling, HEADERS+CONTINUATION accumulation, DATA
  flow-control replenishment.
- **HPACK** (RFC 7541): a full decoder (static + dynamic tables,
  integer prefix coding, Huffman — Envoy Huffman-encodes header values)
  and a minimal literal-without-indexing encoder.
- **A hand-rolled protobuf codec** for the handful of ext_proc fields we
  consume and emit (varint + length-delimited only).

``grpcio`` is an optional fast path: when importable (and not pinned off
via ``CKO_EXTPROC_IMPL=native``) the same message-level session engine is
served by ``grpc.server`` with identity byte serializers — the wire
subset and the fast path share every byte of session logic.

Per-stream protocol (processing mode: request headers SEND, request body
BUFFERED, response side SKIP):

- ``request_headers`` (end_of_stream) → evaluate → CONTINUE with a
  header mutation (``x-waf-action``/``traceparent``) or an
  ImmediateResponse carrying the exact ``filter_reply`` tuple.
- ``request_headers`` + buffered ``request_body`` → headers answer
  CONTINUE bare, the body answer carries the verdict (ext_proc applies
  body-phase header mutations because BUFFERED holds the headers).

The :class:`IngressGovernor` covers this surface too: per-stream
connection slots, header/body deadlines (native impl), the streaming
body ceiling (413), and the in-flight byte ledger (429 shed) — one
resource story per sidecar, with the same refusal taxonomy bytes as the
HTTP frontends.
"""

from __future__ import annotations

import os
import socket
import struct
import threading
import time as _time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Tuple

from ..engine.request import HttpRequest
from ..utils import get_logger
from .batcher import LANE_BULK, LANE_INTERACTIVE
from .degraded import Overloaded
from .tenants import TENANT_HEADER

log = get_logger("sidecar.extproc")

EXTPROC_METHOD = "/envoy.service.ext_proc.v3.ExternalProcessor/Process"

# ---------------------------------------------------------------------------
# protobuf wire subset: varints + length-delimited fields
# ---------------------------------------------------------------------------

_WT_VARINT = 0
_WT_I64 = 1
_WT_LEN = 2
_WT_I32 = 5


def write_varint(out: bytearray, value: int) -> None:
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def read_varint(data: bytes, i: int) -> Tuple[int, int]:
    shift = 0
    value = 0
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


def iter_fields(data: bytes):
    """Yield ``(field_number, wire_type, value)``; value is an ``int``
    for varints and ``bytes`` for length-delimited fields. Fixed32/64
    are skipped (the ext_proc subset uses neither)."""
    i = 0
    n = len(data)
    while i < n:
        tag, i = read_varint(data, i)
        field, wt = tag >> 3, tag & 7
        if wt == _WT_VARINT:
            v, i = read_varint(data, i)
            yield field, wt, v
        elif wt == _WT_LEN:
            ln, i = read_varint(data, i)
            if i + ln > n:
                raise ValueError("truncated length-delimited field")
            yield field, wt, data[i : i + ln]
            i += ln
        elif wt == _WT_I64:
            i += 8
        elif wt == _WT_I32:
            i += 4
        else:
            raise ValueError(f"unsupported wire type {wt}")


def field_bytes(field: int, payload: bytes) -> bytes:
    out = bytearray()
    write_varint(out, (field << 3) | _WT_LEN)
    write_varint(out, len(payload))
    out += payload
    return bytes(out)


def field_varint(field: int, value: int) -> bytes:
    out = bytearray()
    write_varint(out, (field << 3) | _WT_VARINT)
    write_varint(out, value)
    return bytes(out)


# -- ext_proc field numbers (envoy/service/ext_proc/v3/external_processor.proto)

# ProcessingRequest oneof
_PREQ_REQUEST_HEADERS = 2
_PREQ_RESPONSE_HEADERS = 3
_PREQ_REQUEST_BODY = 4
_PREQ_RESPONSE_BODY = 5
_PREQ_REQUEST_TRAILERS = 6
_PREQ_RESPONSE_TRAILERS = 7
_PREQ_KINDS = {
    _PREQ_REQUEST_HEADERS: "request_headers",
    _PREQ_RESPONSE_HEADERS: "response_headers",
    _PREQ_REQUEST_BODY: "request_body",
    _PREQ_RESPONSE_BODY: "response_body",
    _PREQ_REQUEST_TRAILERS: "request_trailers",
    _PREQ_RESPONSE_TRAILERS: "response_trailers",
}
# ProcessingResponse oneof
_PRESP_REQUEST_HEADERS = 1
_PRESP_RESPONSE_HEADERS = 2
_PRESP_REQUEST_BODY = 3
_PRESP_RESPONSE_BODY = 4
_PRESP_REQUEST_TRAILERS = 5
_PRESP_RESPONSE_TRAILERS = 6
_PRESP_IMMEDIATE = 7
# HttpHeaders
_HH_HEADERS = 1
_HH_END_OF_STREAM = 3
# HeaderMap / HeaderValue
_HM_HEADERS = 1
_HV_KEY = 1
_HV_VALUE = 2
_HV_RAW_VALUE = 3
# HttpBody
_HB_BODY = 1
_HB_END_OF_STREAM = 2
# HeadersResponse / BodyResponse
_HR_RESPONSE = 1
# CommonResponse
_CR_STATUS = 1  # CONTINUE = 0
_CR_HEADER_MUTATION = 2
# HeaderMutation
_MUT_SET_HEADERS = 1
# HeaderValueOption
_HVO_HEADER = 1
# ImmediateResponse
_IR_STATUS = 1  # HttpStatus { code = 1 }
_IR_HEADERS = 2
_IR_BODY = 3
_HTTP_STATUS_CODE = 1


def decode_header_map(data: bytes) -> List[Tuple[str, str]]:
    pairs: List[Tuple[str, str]] = []
    for field, wt, value in iter_fields(data):
        if field != _HM_HEADERS or wt != _WT_LEN:
            continue
        key = b""
        val = b""
        for f2, w2, v2 in iter_fields(value):
            if f2 == _HV_KEY and w2 == _WT_LEN:
                key = v2
            elif f2 == _HV_VALUE and w2 == _WT_LEN:
                val = v2
            elif f2 == _HV_RAW_VALUE and w2 == _WT_LEN:
                # Newer Envoys populate raw_value and leave value empty.
                val = v2
        pairs.append(
            (key.decode("latin-1"), val.decode("latin-1"))
        )
    return pairs


def decode_processing_request(data: bytes) -> Tuple[str, Dict[str, Any]]:
    """Decode the oneof we care about. Returns ``(kind, payload)`` where
    payload carries ``headers``/``body``/``end_of_stream`` as decoded."""
    for field, wt, value in iter_fields(data):
        kind = _PREQ_KINDS.get(field)
        if kind is None or wt != _WT_LEN:
            continue
        if kind.endswith("_headers"):
            headers: List[Tuple[str, str]] = []
            eos = False
            for f2, w2, v2 in iter_fields(value):
                if f2 == _HH_HEADERS and w2 == _WT_LEN:
                    headers = decode_header_map(v2)
                elif f2 == _HH_END_OF_STREAM and w2 == _WT_VARINT:
                    eos = bool(v2)
            return kind, {"headers": headers, "end_of_stream": eos}
        if kind.endswith("_body"):
            body = b""
            eos = False
            for f2, w2, v2 in iter_fields(value):
                if f2 == _HB_BODY and w2 == _WT_LEN:
                    body = v2
                elif f2 == _HB_END_OF_STREAM and w2 == _WT_VARINT:
                    eos = bool(v2)
            return kind, {"body": body, "end_of_stream": eos}
        return kind, {}
    return "unknown", {}


def encode_header_value(key: str, value: bytes) -> bytes:
    # raw_value (not value): Envoy >= 1.25 validates mutations and
    # prefers the bytes field; older Envoys accept either.
    return field_bytes(_HV_KEY, key.encode("latin-1")) + field_bytes(
        _HV_RAW_VALUE, value
    )


def encode_header_mutation(set_headers: List[Tuple[str, bytes]]) -> bytes:
    out = bytearray()
    for key, value in set_headers:
        out += field_bytes(
            _MUT_SET_HEADERS, field_bytes(_HVO_HEADER, encode_header_value(key, value))
        )
    return bytes(out)


def encode_continue_response(
    phase_field: int, set_headers: List[Tuple[str, bytes]]
) -> bytes:
    """ProcessingResponse{<phase>: {response: CommonResponse{CONTINUE,
    header_mutation}}} — phase is request_headers or request_body."""
    common = bytearray()  # status CONTINUE == 0 == proto default, omitted
    if set_headers:
        common += field_bytes(_CR_HEADER_MUTATION, encode_header_mutation(set_headers))
    return field_bytes(phase_field, field_bytes(_HR_RESPONSE, bytes(common)))


def encode_immediate_response(
    status: int, body: bytes, headers: List[Tuple[str, bytes]]
) -> bytes:
    inner = bytearray()
    inner += field_bytes(_IR_STATUS, field_varint(_HTTP_STATUS_CODE, status))
    if headers:
        inner += field_bytes(_IR_HEADERS, encode_header_mutation(headers))
    if body:
        inner += field_bytes(_IR_BODY, body)
    return field_bytes(_PRESP_IMMEDIATE, bytes(inner))


# -- client-side codec (ExtProcClient, tests, hack/extproc_smoke.py) ---------


def encode_header_map(headers: List[Tuple[str, str]]) -> bytes:
    out = bytearray()
    for key, value in headers:
        hv = field_bytes(_HV_KEY, key.encode("latin-1")) + field_bytes(
            _HV_VALUE, value.encode("latin-1")
        )
        out += field_bytes(_HM_HEADERS, hv)
    return bytes(out)


def encode_request_headers(
    headers: List[Tuple[str, str]], end_of_stream: bool
) -> bytes:
    inner = field_bytes(_HH_HEADERS, encode_header_map(headers))
    if end_of_stream:
        inner += field_varint(_HH_END_OF_STREAM, 1)
    return field_bytes(_PREQ_REQUEST_HEADERS, inner)


def encode_request_body(body: bytes, end_of_stream: bool) -> bytes:
    inner = field_bytes(_HB_BODY, body)
    if end_of_stream:
        inner += field_varint(_HB_END_OF_STREAM, 1)
    return field_bytes(_PREQ_REQUEST_BODY, inner)


def _decode_mutation_headers(data: bytes) -> Dict[str, str]:
    headers: Dict[str, str] = {}
    for field, wt, value in iter_fields(data):
        if field != _MUT_SET_HEADERS or wt != _WT_LEN:
            continue
        for f2, w2, v2 in iter_fields(value):
            if f2 == _HVO_HEADER and w2 == _WT_LEN:
                key = b""
                val = b""
                for f3, w3, v3 in iter_fields(v2):
                    if f3 == _HV_KEY and w3 == _WT_LEN:
                        key = v3
                    elif f3 in (_HV_VALUE, _HV_RAW_VALUE) and w3 == _WT_LEN:
                        val = v3
                if key:
                    headers[key.decode("latin-1").lower()] = val.decode("latin-1")
    return headers


def decode_processing_response(data: bytes) -> Dict[str, Any]:
    """Decode what the server emits: ``{"kind": "immediate", status,
    body, headers}`` or ``{"kind": "continue", phase, headers}``."""
    for field, wt, value in iter_fields(data):
        if wt != _WT_LEN:
            continue
        if field == _PRESP_IMMEDIATE:
            status = 0
            body = b""
            headers: Dict[str, str] = {}
            for f2, w2, v2 in iter_fields(value):
                if f2 == _IR_STATUS and w2 == _WT_LEN:
                    for f3, w3, v3 in iter_fields(v2):
                        if f3 == _HTTP_STATUS_CODE and w3 == _WT_VARINT:
                            status = v3
                elif f2 == _IR_HEADERS and w2 == _WT_LEN:
                    headers = _decode_mutation_headers(v2)
                elif f2 == _IR_BODY and w2 == _WT_LEN:
                    body = v2
            return {"kind": "immediate", "status": status, "body": body,
                    "headers": headers}
        if field in (
            _PRESP_REQUEST_HEADERS,
            _PRESP_REQUEST_BODY,
            _PRESP_RESPONSE_HEADERS,
            _PRESP_RESPONSE_BODY,
            _PRESP_REQUEST_TRAILERS,
            _PRESP_RESPONSE_TRAILERS,
        ):
            headers = {}
            for f2, w2, v2 in iter_fields(value):
                if f2 == _HR_RESPONSE and w2 == _WT_LEN:
                    for f3, w3, v3 in iter_fields(v2):
                        if f3 == _CR_HEADER_MUTATION and w3 == _WT_LEN:
                            headers = _decode_mutation_headers(v3)
            phase = "request_headers" if field == _PRESP_REQUEST_HEADERS else (
                "request_body" if field == _PRESP_REQUEST_BODY else "other"
            )
            return {"kind": "continue", "phase": phase, "headers": headers}
    return {"kind": "unknown"}


# ---------------------------------------------------------------------------
# HPACK (RFC 7541)
# ---------------------------------------------------------------------------

HPACK_STATIC_TABLE: List[Tuple[bytes, bytes]] = [
    (b":authority", b""),
    (b":method", b"GET"),
    (b":method", b"POST"),
    (b":path", b"/"),
    (b":path", b"/index.html"),
    (b":scheme", b"http"),
    (b":scheme", b"https"),
    (b":status", b"200"),
    (b":status", b"204"),
    (b":status", b"206"),
    (b":status", b"304"),
    (b":status", b"400"),
    (b":status", b"404"),
    (b":status", b"500"),
    (b"accept-charset", b""),
    (b"accept-encoding", b"gzip, deflate"),
    (b"accept-language", b""),
    (b"accept-ranges", b""),
    (b"accept", b""),
    (b"access-control-allow-origin", b""),
    (b"age", b""),
    (b"allow", b""),
    (b"authorization", b""),
    (b"cache-control", b""),
    (b"content-disposition", b""),
    (b"content-encoding", b""),
    (b"content-language", b""),
    (b"content-length", b""),
    (b"content-location", b""),
    (b"content-range", b""),
    (b"content-type", b""),
    (b"cookie", b""),
    (b"date", b""),
    (b"etag", b""),
    (b"expect", b""),
    (b"expires", b""),
    (b"from", b""),
    (b"host", b""),
    (b"if-match", b""),
    (b"if-modified-since", b""),
    (b"if-none-match", b""),
    (b"if-range", b""),
    (b"if-unmodified-since", b""),
    (b"last-modified", b""),
    (b"link", b""),
    (b"location", b""),
    (b"max-forwards", b""),
    (b"proxy-authenticate", b""),
    (b"proxy-authorization", b""),
    (b"range", b""),
    (b"referer", b""),
    (b"refresh", b""),
    (b"retry-after", b""),
    (b"server", b""),
    (b"set-cookie", b""),
    (b"strict-transport-security", b""),
    (b"transfer-encoding", b""),
    (b"user-agent", b""),
    (b"vary", b""),
    (b"via", b""),
    (b"www-authenticate", b""),
]

# RFC 7541 Appendix B: (code, bit length) per symbol 0..255 + EOS(256).
HUFFMAN_CODES: List[Tuple[int, int]] = [
    (0x1FF8, 13), (0x7FFFD8, 23), (0xFFFFFE2, 28), (0xFFFFFE3, 28),
    (0xFFFFFE4, 28), (0xFFFFFE5, 28), (0xFFFFFE6, 28), (0xFFFFFE7, 28),
    (0xFFFFFE8, 28), (0xFFFFEA, 24), (0x3FFFFFFC, 30), (0xFFFFFE9, 28),
    (0xFFFFFEA, 28), (0x3FFFFFFD, 30), (0xFFFFFEB, 28), (0xFFFFFEC, 28),
    (0xFFFFFED, 28), (0xFFFFFEE, 28), (0xFFFFFEF, 28), (0xFFFFFF0, 28),
    (0xFFFFFF1, 28), (0xFFFFFF2, 28), (0x3FFFFFFE, 30), (0xFFFFFF3, 28),
    (0xFFFFFF4, 28), (0xFFFFFF5, 28), (0xFFFFFF6, 28), (0xFFFFFF7, 28),
    (0xFFFFFF8, 28), (0xFFFFFF9, 28), (0xFFFFFFA, 28), (0xFFFFFFB, 28),
    (0x14, 6), (0x3F8, 10), (0x3F9, 10), (0xFFA, 12),
    (0x1FF9, 13), (0x15, 6), (0xF8, 8), (0x7FA, 11),
    (0x3FA, 10), (0x3FB, 10), (0xF9, 8), (0x7FB, 11),
    (0xFA, 8), (0x16, 6), (0x17, 6), (0x18, 6),
    (0x0, 5), (0x1, 5), (0x2, 5), (0x19, 6),
    (0x1A, 6), (0x1B, 6), (0x1C, 6), (0x1D, 6),
    (0x1E, 6), (0x1F, 6), (0x5C, 7), (0xFB, 8),
    (0x7FFC, 15), (0x20, 6), (0xFFB, 12), (0x3FC, 10),
    (0x1FFA, 13), (0x21, 6), (0x5D, 7), (0x5E, 7),
    (0x5F, 7), (0x60, 7), (0x61, 7), (0x62, 7),
    (0x63, 7), (0x64, 7), (0x65, 7), (0x66, 7),
    (0x67, 7), (0x68, 7), (0x69, 7), (0x6A, 7),
    (0x6B, 7), (0x6C, 7), (0x6D, 7), (0x6E, 7),
    (0x6F, 7), (0x70, 7), (0x71, 7), (0x72, 7),
    (0xFC, 8), (0x73, 7), (0xFD, 8), (0x1FFB, 13),
    (0x7FFF0, 19), (0x1FFC, 13), (0x3FFC, 14), (0x22, 6),
    (0x7FFD, 15), (0x3, 5), (0x23, 6), (0x4, 5),
    (0x24, 6), (0x5, 5), (0x25, 6), (0x26, 6),
    (0x27, 6), (0x6, 5), (0x74, 7), (0x75, 7),
    (0x28, 6), (0x29, 6), (0x2A, 6), (0x7, 5),
    (0x2B, 6), (0x76, 7), (0x2C, 6), (0x8, 5),
    (0x9, 5), (0x2D, 6), (0x77, 7), (0x78, 7),
    (0x79, 7), (0x7A, 7), (0x7B, 7), (0x7FFE, 15),
    (0x7FC, 11), (0x3FFD, 14), (0x1FFD, 13), (0xFFFFFFC, 28),
    (0xFFFE6, 20), (0x3FFFD2, 22), (0xFFFE7, 20), (0xFFFE8, 20),
    (0x3FFFD3, 22), (0x3FFFD4, 22), (0x3FFFD5, 22), (0x7FFFD9, 23),
    (0x3FFFD6, 22), (0x7FFFDA, 23), (0x7FFFDB, 23), (0x7FFFDC, 23),
    (0x7FFFDD, 23), (0x7FFFDE, 23), (0xFFFFEB, 24), (0x7FFFDF, 23),
    (0xFFFFEC, 24), (0xFFFFED, 24), (0x3FFFD7, 22), (0x7FFFE0, 23),
    (0xFFFFEE, 24), (0x7FFFE1, 23), (0x7FFFE2, 23), (0x7FFFE3, 23),
    (0x7FFFE4, 23), (0x1FFFDC, 21), (0x3FFFD8, 22), (0x7FFFE5, 23),
    (0x3FFFD9, 22), (0x7FFFE6, 23), (0x7FFFE7, 23), (0xFFFFEF, 24),
    (0x3FFFDA, 22), (0x1FFFDD, 21), (0xFFFE9, 20), (0x3FFFDB, 22),
    (0x3FFFDC, 22), (0x7FFFE8, 23), (0x7FFFE9, 23), (0x1FFFDE, 21),
    (0x7FFFEA, 23), (0x3FFFDD, 22), (0x3FFFDE, 22), (0xFFFFF0, 24),
    (0x1FFFDF, 21), (0x3FFFDF, 22), (0x7FFFEB, 23), (0x7FFFEC, 23),
    (0x1FFFE0, 21), (0x1FFFE1, 21), (0x3FFFE0, 22), (0x1FFFE2, 21),
    (0x7FFFED, 23), (0x3FFFE1, 22), (0x7FFFEE, 23), (0x7FFFEF, 23),
    (0xFFFEA, 20), (0x3FFFE2, 22), (0x3FFFE3, 22), (0x3FFFE4, 22),
    (0x7FFFF0, 23), (0x3FFFE5, 22), (0x3FFFE6, 22), (0x7FFFF1, 23),
    (0x3FFFFE0, 26), (0x3FFFFE1, 26), (0xFFFEB, 20), (0x7FFF1, 19),
    (0x3FFFE7, 22), (0x7FFFF2, 23), (0x3FFFE8, 22), (0x1FFFFEC, 25),
    (0x3FFFFE2, 26), (0x3FFFFE3, 26), (0x3FFFFE4, 26), (0x7FFFFDE, 27),
    (0x7FFFFDF, 27), (0x3FFFFE5, 26), (0xFFFFF1, 24), (0x1FFFFED, 25),
    (0x7FFF2, 19), (0x1FFFE3, 21), (0x3FFFFE6, 26), (0x7FFFFE0, 27),
    (0x7FFFFE1, 27), (0x3FFFFE7, 26), (0x7FFFFE2, 27), (0xFFFFF2, 24),
    (0x1FFFE4, 21), (0x1FFFE5, 21), (0x3FFFFE8, 26), (0x3FFFFE9, 26),
    (0xFFFFFFD, 28), (0x7FFFFE3, 27), (0x7FFFFE4, 27), (0x7FFFFE5, 27),
    (0xFFFEC, 20), (0xFFFFF3, 24), (0xFFFED, 20), (0x1FFFE6, 21),
    (0x3FFFE9, 22), (0x1FFFE7, 21), (0x1FFFE8, 21), (0x7FFFF3, 23),
    (0x3FFFEA, 22), (0x3FFFEB, 22), (0x1FFFFEE, 25), (0x1FFFFEF, 25),
    (0xFFFFF4, 24), (0xFFFFF5, 24), (0x3FFFFEA, 26), (0x7FFFF4, 23),
    (0x3FFFFEB, 26), (0x7FFFFE6, 27), (0x3FFFFEC, 26), (0x3FFFFED, 26),
    (0x7FFFFE7, 27), (0x7FFFFE8, 27), (0x7FFFFE9, 27), (0x7FFFFEA, 27),
    (0x7FFFFEB, 27), (0xFFFFFFE, 28), (0x7FFFFEC, 27), (0x7FFFFED, 27),
    (0x7FFFFEE, 27), (0x7FFFFEF, 27), (0x7FFFFF0, 27), (0x3FFFFEE, 26),
    (0x3FFFFFFF, 30),
]


def _build_huffman_tree() -> dict:
    root: dict = {}
    for sym, (code, nbits) in enumerate(HUFFMAN_CODES):
        node = root
        for shift in range(nbits - 1, -1, -1):
            bit = (code >> shift) & 1
            if shift == 0:
                node[bit] = sym
            else:
                nxt = node.get(bit)
                if not isinstance(nxt, dict):
                    nxt = {}
                    node[bit] = nxt
                node = nxt
    return root


_HUFFMAN_TREE = _build_huffman_tree()
_EOS = 256


def huffman_decode(data: bytes) -> bytes:
    out = bytearray()
    node = _HUFFMAN_TREE
    depth = 0
    for byte in data:
        for shift in range(7, -1, -1):
            bit = (byte >> shift) & 1
            nxt = node[bit] if bit in node else None
            if nxt is None:
                raise ValueError("invalid huffman code")
            depth += 1
            if isinstance(nxt, int):
                if nxt == _EOS:
                    raise ValueError("EOS inside huffman string")
                out.append(nxt)
                node = _HUFFMAN_TREE
                depth = 0
            else:
                node = nxt
    # Trailing bits must be a prefix of EOS (all ones), < 8 bits.
    if depth >= 8:
        raise ValueError("huffman padding too long")
    return bytes(out)


class HpackDecoder:
    """RFC 7541 decoder: static + dynamic tables, integer prefix coding,
    Huffman strings. One instance per connection (the dynamic table is
    connection state and MUST track every header block in order)."""

    def __init__(self, max_table_size: int = 4096):
        self._max_size = max_table_size
        self._protocol_max = max_table_size
        self._dynamic: List[Tuple[bytes, bytes]] = []  # newest first
        self._size = 0

    @staticmethod
    def _entry_size(name: bytes, value: bytes) -> int:
        return len(name) + len(value) + 32

    def _evict(self) -> None:
        while self._size > self._max_size and self._dynamic:
            name, value = self._dynamic.pop()
            self._size -= self._entry_size(name, value)

    def _add(self, name: bytes, value: bytes) -> None:
        self._dynamic.insert(0, (name, value))
        self._size += self._entry_size(name, value)
        self._evict()

    def _lookup(self, index: int) -> Tuple[bytes, bytes]:
        if index <= 0:
            raise ValueError("HPACK index 0")
        if index <= len(HPACK_STATIC_TABLE):
            return HPACK_STATIC_TABLE[index - 1]
        dyn = index - len(HPACK_STATIC_TABLE) - 1
        if dyn >= len(self._dynamic):
            raise ValueError(f"HPACK index {index} out of range")
        return self._dynamic[dyn]

    @staticmethod
    def _read_int(data: bytes, i: int, prefix_bits: int) -> Tuple[int, int]:
        mask = (1 << prefix_bits) - 1
        value = data[i] & mask
        i += 1
        if value < mask:
            return value, i
        shift = 0
        while True:
            if i >= len(data):
                raise ValueError("truncated HPACK integer")
            b = data[i]
            i += 1
            value += (b & 0x7F) << shift
            if not b & 0x80:
                return value, i
            shift += 7
            if shift > 56:
                raise ValueError("HPACK integer overflow")

    def _read_string(self, data: bytes, i: int) -> Tuple[bytes, int]:
        if i >= len(data):
            raise ValueError("truncated HPACK string")
        huff = bool(data[i] & 0x80)
        length, i = self._read_int(data, i, 7)
        if i + length > len(data):
            raise ValueError("truncated HPACK string literal")
        raw = data[i : i + length]
        i += length
        return (huffman_decode(raw) if huff else raw), i

    def decode(self, data: bytes) -> List[Tuple[bytes, bytes]]:
        headers: List[Tuple[bytes, bytes]] = []
        i = 0
        while i < len(data):
            b = data[i]
            if b & 0x80:  # indexed
                index, i = self._read_int(data, i, 7)
                headers.append(self._lookup(index))
            elif b & 0x40:  # literal with incremental indexing
                index, i = self._read_int(data, i, 6)
                if index:
                    name = self._lookup(index)[0]
                else:
                    name, i = self._read_string(data, i)
                value, i = self._read_string(data, i)
                self._add(name, value)
                headers.append((name, value))
            elif b & 0x20:  # dynamic table size update
                size, i = self._read_int(data, i, 5)
                if size > self._protocol_max:
                    raise ValueError("HPACK table size update above max")
                self._max_size = size
                self._evict()
            else:  # literal without indexing / never indexed (0x10)
                index, i = self._read_int(data, i, 4)
                if index:
                    name = self._lookup(index)[0]
                else:
                    name, i = self._read_string(data, i)
                value, i = self._read_string(data, i)
                headers.append((name, value))
        return headers


class HpackEncoder:
    """Minimal encoder: every header as a literal without indexing with
    a raw (non-Huffman) name and value — decodable by any peer, no
    dynamic-table state to keep in sync."""

    @staticmethod
    def _write_int(out: bytearray, value: int, prefix_bits: int, flags: int) -> None:
        mask = (1 << prefix_bits) - 1
        if value < mask:
            out.append(flags | value)
            return
        out.append(flags | mask)
        value -= mask
        while value >= 0x80:
            out.append((value & 0x7F) | 0x80)
            value >>= 7
        out.append(value)

    def encode(self, headers: List[Tuple[bytes, bytes]]) -> bytes:
        out = bytearray()
        for name, value in headers:
            out.append(0x00)  # literal without indexing, new name
            self._write_int(out, len(name), 7, 0x00)
            out += name
            self._write_int(out, len(value), 7, 0x00)
            out += value
        return bytes(out)


# ---------------------------------------------------------------------------
# HTTP/2 framing (RFC 9113) + gRPC message framing
# ---------------------------------------------------------------------------

H2_PREFACE = b"PRI * HTTP/2.0\r\n\r\nSM\r\n\r\n"
_F_DATA = 0x0
_F_HEADERS = 0x1
_F_PRIORITY = 0x2
_F_RST_STREAM = 0x3
_F_SETTINGS = 0x4
_F_PUSH_PROMISE = 0x5
_F_PING = 0x6
_F_GOAWAY = 0x7
_F_WINDOW_UPDATE = 0x8
_F_CONTINUATION = 0x9
_FLAG_END_STREAM = 0x1
_FLAG_ACK = 0x1
_FLAG_END_HEADERS = 0x4
_FLAG_PADDED = 0x8
_FLAG_PRIORITY = 0x20
_MAX_FRAME = 1 << 20  # defensive receive cap; we advertise the 16 KiB default
# Extra receive window granted per stream and on the connection so
# buffered bodies larger than the 64 KiB default never stall.
_WINDOW_BONUS = 1 << 24


def h2_frame(ftype: int, flags: int, stream_id: int, payload: bytes = b"") -> bytes:
    return (
        len(payload).to_bytes(3, "big")
        + bytes((ftype, flags))
        + (stream_id & 0x7FFFFFFF).to_bytes(4, "big")
        + payload
    )


def grpc_frame(message: bytes) -> bytes:
    return b"\x00" + len(message).to_bytes(4, "big") + message


def _strip_padding(payload: bytes, flags: int, priority_ok: bool = False) -> bytes:
    i = 0
    pad = 0
    if flags & _FLAG_PADDED:
        if not payload:
            raise ValueError("PADDED frame too short")
        pad = payload[0]
        i = 1
    if priority_ok and flags & _FLAG_PRIORITY:
        i += 5
    if pad > len(payload) - i:
        raise ValueError("padding larger than frame")
    return payload[i : len(payload) - pad]


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed")
        buf += chunk
    return bytes(buf)


def read_h2_frame(sock: socket.socket) -> Tuple[int, int, int, bytes]:
    head = _recv_exact(sock, 9)
    length = int.from_bytes(head[:3], "big")
    if length > _MAX_FRAME:
        raise ValueError(f"frame too large: {length}")
    ftype = head[3]
    flags = head[4]
    stream_id = int.from_bytes(head[5:9], "big") & 0x7FFFFFFF
    payload = _recv_exact(sock, length) if length else b""
    return ftype, flags, stream_id, payload


# ---------------------------------------------------------------------------
# transport-independent session engine (shared native / grpcio)
# ---------------------------------------------------------------------------


class _ExtStream:
    """One ext_proc stream == one proxied HTTP request."""

    __slots__ = (
        "peer", "t_open", "headers", "body", "charged", "done",
        "await_body", "deadline", "ctx", "tenant",
    )

    def __init__(self, peer: str, t_open: float):
        self.peer = peer
        self.t_open = t_open
        self.headers: List[Tuple[str, str]] = []
        self.body = bytearray()
        self.charged = 0
        self.done = False
        self.await_body = False
        self.deadline: Optional[float] = None
        self.ctx = None
        self.tenant: Optional[str] = None


class ExtProcEngine:
    """Message-level ext_proc session logic: decoded ProcessingRequest in,
    encoded ProcessingResponse(s) out. Owns no transport — the native
    HTTP/2 server and the grpcio fast path both drive this, so the
    verdict/refusal story is one body of code."""

    def __init__(self, frontend: "ExtProcFrontend"):
        self.frontend = frontend
        self.sidecar = frontend.sidecar

    # -- stream lifecycle ---------------------------------------------------

    def open_stream(self, peer: str = "") -> Optional[_ExtStream]:
        """Admit one ext_proc stream under the shared connection cap.
        ``None`` means refused — the caller answers the 503 taxonomy
        (``refused_response``) and ends the stream."""
        gov = self.sidecar.governor
        if not gov.try_admit_conn():
            return None
        self.frontend.streams_total += 1
        now = _time.monotonic()
        st = _ExtStream(peer, now)
        if gov.header_timeout_s > 0:
            st.deadline = now + gov.header_timeout_s
        return st

    def close_stream(self, st: _ExtStream) -> None:
        gov = self.sidecar.governor
        if st.charged:
            gov.discharge(st.charged, tenant=st.tenant)
            st.charged = 0
        gov.release_conn()

    def refused_response(self) -> bytes:
        # Same bytes the HTTP frontends answer past the connection cap.
        return encode_immediate_response(
            503, b"too many connections\n",
            [("content-type", b"text/plain")],
        )

    def deadline_response(self, st: _ExtStream) -> bytes:
        """408 for a stream whose headers/body never arrived in time
        (native impl reaper; grpcio relies on Envoy's message timeout)."""
        gov = self.sidecar.governor
        gov.count("deadline_closed_total")
        payload = (
            b"request body timeout\n" if st.await_body
            else b"request header timeout\n"
        )
        st.done = True
        return encode_immediate_response(
            408, payload, [("content-type", b"text/plain")]
        )

    # -- message handling ---------------------------------------------------

    def on_message(self, st: _ExtStream, data: bytes) -> List[bytes]:
        """Handle one ProcessingRequest; returns encoded
        ProcessingResponses. ``st.done`` flips when the stream needs no
        further messages (immediate response or final CONTINUE sent)."""
        self.frontend.messages_total += 1
        try:
            kind, payload = decode_processing_request(data)
        except ValueError as err:
            log.error("ext_proc message decode failed", err)
            self.sidecar.governor.count("conn_errors_total")
            st.done = True
            return [self._reply_immediate(
                400, b"bad ext_proc message\n",
                [("content-type", b"text/plain")],
            )]
        if kind == "request_headers":
            return self._on_request_headers(st, payload)
        if kind == "request_body":
            return self._on_request_body(st, payload)
        if kind in ("request_trailers", "response_trailers",
                    "response_headers", "response_body"):
            # Our processing mode skips these; answer a bare CONTINUE of
            # the matching type so a misconfigured Envoy never stalls.
            field = {
                "request_trailers": _PRESP_REQUEST_TRAILERS,
                "response_trailers": _PRESP_RESPONSE_TRAILERS,
                "response_headers": _PRESP_RESPONSE_HEADERS,
                "response_body": _PRESP_RESPONSE_BODY,
            }[kind]
            return [field_bytes(field, b"")]
        return []

    def _on_request_headers(self, st: _ExtStream, payload: dict) -> List[bytes]:
        gov = self.sidecar.governor
        st.headers = payload.get("headers", [])
        if self.sidecar.config.trust_tenant_header:
            for key, value in st.headers:
                if key.lower() == TENANT_HEADER:
                    st.tenant = value or None
                    break
        head_bytes = sum(len(k) + len(v) for k, v in st.headers)
        if not gov.can_admit(head_bytes):
            gov.count("shed_total")
            st.done = True
            return [self._shed_response()]
        if st.tenant is not None and gov.tenant_over_share(st.tenant, head_bytes):
            gov.count("shed_total")
            gov.count_tenant_shed(st.tenant)
            st.done = True
            return [self._shed_response(tenant=st.tenant)]
        gov.charge(head_bytes, tenant=st.tenant)
        st.charged += head_bytes
        self.frontend.bytes_total += head_bytes
        if payload.get("end_of_stream"):
            st.deadline = None
            # Headers-only request: the interactive lane answers it ahead
            # of any buffered-body traffic queued on the bulk lane.
            return [self._evaluate(
                st, _PRESP_REQUEST_HEADERS, lane=LANE_INTERACTIVE
            )]
        # Body follows (BUFFERED): answer the header phase with a bare
        # CONTINUE and hold the verdict for the body message.
        st.await_body = True
        st.deadline = (
            _time.monotonic() + gov.body_timeout_s
            if gov.body_timeout_s > 0 else None
        )
        return [encode_continue_response(_PRESP_REQUEST_HEADERS, [])]

    def _on_request_body(self, st: _ExtStream, payload: dict) -> List[bytes]:
        gov = self.sidecar.governor
        chunk = payload.get("body", b"")
        if chunk:
            if gov.max_body_bytes >= 0 and (
                len(st.body) + len(chunk) > gov.max_body_bytes
            ):
                gov.count("body_limit_total")
                st.done = True
                return [self._reply_immediate(
                    413, b"request body too large\n",
                    [("content-type", b"text/plain")],
                )]
            if not gov.can_admit(len(chunk)):
                gov.count("shed_total")
                st.done = True
                return [self._shed_response()]
            if st.tenant is not None and gov.tenant_over_share(
                st.tenant, len(chunk)
            ):
                gov.count("shed_total")
                gov.count_tenant_shed(st.tenant)
                st.done = True
                return [self._shed_response(tenant=st.tenant)]
            gov.charge(len(chunk), tenant=st.tenant)
            st.charged += len(chunk)
            self.frontend.bytes_total += len(chunk)
            st.body += chunk
        if payload.get("end_of_stream", True):
            st.deadline = None
            return [self._evaluate(st, _PRESP_REQUEST_BODY, lane=LANE_BULK)]
        return []

    # -- evaluation → ProcessingResponse ------------------------------------

    def _shed_response(self, tenant: Optional[str] = None) -> bytes:
        sc = self.sidecar
        msg = (
            f"tenant {tenant!r} over weighted fair share"
            if tenant is not None else "ingress memory budget exceeded"
        )
        err = Overloaded(msg, retry_after_s=sc.shed_retry_after())
        status, payload, headers = sc.overloaded_reply(err, as_json=False)
        return self._reply_immediate(
            status, payload,
            [(k.lower(), v.encode("latin-1")) for k, v in headers.items()],
        )

    def _reply_immediate(
        self, status: int, payload: bytes, headers: List[Tuple[str, bytes]]
    ) -> bytes:
        self.frontend.immediate_total += 1
        return encode_immediate_response(status, payload, headers)

    def _evaluate(
        self, st: _ExtStream, phase_field: int,
        lane: Optional[str] = None,
    ) -> bytes:
        """The ext_proc analogue of the threaded ``_handle_filter``: one
        ``filter_reply`` call, the same trace events, the same header
        bytes — encoded as CONTINUE+mutation (allow/fail-open) or an
        ImmediateResponse (everything else)."""
        sc = self.sidecar
        method, uri, authority = "GET", "/", ""
        header_list: List[Tuple[str, str]] = []
        traceparent = None
        deadline_raw = None
        tenant_raw = None
        for key, value in st.headers:
            lk = key.lower()
            if lk.startswith(":"):
                if lk == ":method":
                    method = value
                elif lk == ":path":
                    uri = value
                elif lk == ":authority":
                    authority = value
                continue
            header_list.append((key, value))
            if lk == "traceparent":
                traceparent = value
            elif lk == DEADLINE_HEADER_LOWER:
                deadline_raw = value
            elif lk == TENANT_HEADER:
                tenant_raw = value
        if authority and not any(k.lower() == "host" for k, _ in header_list):
            # Envoy folds the HTTP/1.1 Host header into :authority; the
            # rules see REQUEST_HEADERS:Host like the HTTP frontends do.
            header_list.insert(0, ("host", authority))
        t_accept = st.t_open
        ctx = sc.tracer.start(traceparent, t_accept=t_accept)
        st.ctx = ctx
        req = HttpRequest(
            method=method,
            uri=uri,
            version="HTTP/1.1",
            headers=header_list,
            body=bytes(st.body),
            remote_addr=st.peer,
        )
        tenant = None
        if sc.config.trust_tenant_header:
            tenant = tenant_raw or None
        deadline_s = None
        if deadline_raw:
            try:
                ms = float(deadline_raw)
                if ms > 0:
                    deadline_s = _time.monotonic() + ms / 1e3
            except ValueError:
                pass
        if ctx is not None:
            ctx.event("accept", t_accept, t_accept, track="frontend")
            ctx.event("parse", t_accept, _time.monotonic(), track="frontend")
        status, payload, headers = sc.filter_reply(
            req, tenant=tenant, deadline_s=deadline_s, span=ctx, lane=lane
        )
        if ctx is not None:
            headers = {**(headers or {}), "traceparent": ctx.response_traceparent()}
            t_reply = _time.monotonic()
            ctx.event("reply", t_reply, t_reply, track="frontend")
            sc.tracer.commit(ctx)
        st.done = True
        headers = headers or {}
        action = headers.get("x-waf-action", "")
        if status == 200 and action in ("allow", "fail-open"):
            # The request proceeds upstream: no body of ours is on the
            # wire, the verdict rides as a request-header mutation.
            self.frontend.continue_total += 1
            mutation = [
                (k.lower(), v.encode("latin-1"))
                for k, v in headers.items()
                if k.lower() not in ("content-type", "content-length")
            ]
            return encode_continue_response(phase_field, mutation)
        return self._reply_immediate(
            status, payload,
            [(k.lower(), v.encode("latin-1")) for k, v in headers.items()],
        )


DEADLINE_HEADER_LOWER = "x-cko-deadline-ms"


# ---------------------------------------------------------------------------
# native transport: dependency-free HTTP/2 gRPC server
# ---------------------------------------------------------------------------


class _NativeStream:
    __slots__ = ("ext", "header_buf", "grpc_buf", "headers_sent",
                 "closed", "inbox", "busy", "unknown", "half_closed")

    def __init__(self):
        self.ext: Optional[_ExtStream] = None
        self.header_buf = bytearray()
        self.grpc_buf = bytearray()
        self.headers_sent = False
        self.closed = False
        self.inbox: List[bytes] = []
        self.busy = False
        self.unknown = False
        self.half_closed = False


class _NativeConn:
    """One accepted TCP connection: HTTP/2 framing in, responses out
    under a write lock (evaluation happens on the frontend worker pool,
    so interleaved streams never corrupt the frame sequence)."""

    def __init__(self, frontend: "ExtProcFrontend", sock: socket.socket,
                 peer: str):
        self.frontend = frontend
        self.engine = frontend.engine
        self.sock = sock
        self.peer = peer
        self.decoder = HpackDecoder()
        self.encoder = HpackEncoder()
        self.streams: Dict[int, _NativeStream] = {}
        self.wlock = threading.Lock()
        # Guards inbox/busy handoff between the reader thread and the
        # per-stream worker (wlock stays write-only: a blocking sendall
        # must never delay frame parsing).
        self.ilock = threading.Lock()
        self.continuation_for: Optional[int] = None
        self.closing = False

    # -- writes -------------------------------------------------------------

    def _send(self, data: bytes) -> None:
        with self.wlock:
            self.sock.sendall(data)

    def _send_response_headers(self, stream_id: int, ns: _NativeStream) -> None:
        if ns.headers_sent:
            return
        block = self.encoder.encode([
            (b":status", b"200"),
            (b"content-type", b"application/grpc"),
        ])
        self._send(h2_frame(_F_HEADERS, _FLAG_END_HEADERS, stream_id, block))
        ns.headers_sent = True

    def _send_trailers(self, stream_id: int, ns: _NativeStream,
                       grpc_status: int = 0, message: str = "") -> None:
        if ns.closed:
            return
        trailers = [(b"grpc-status", str(grpc_status).encode())]
        if message:
            trailers.append((b"grpc-message", message.encode("latin-1")))
        if not ns.headers_sent:
            # Trailers-only response (unknown method, early refusal).
            trailers = [
                (b":status", b"200"),
                (b"content-type", b"application/grpc"),
            ] + trailers
            ns.headers_sent = True
        block = self.encoder.encode(trailers)
        self._send(h2_frame(
            _F_HEADERS, _FLAG_END_HEADERS | _FLAG_END_STREAM, stream_id, block
        ))
        ns.closed = True

    def _send_messages(self, stream_id: int, ns: _NativeStream,
                       messages: List[bytes]) -> None:
        if ns.closed or not messages:
            return
        self._send_response_headers(stream_id, ns)
        out = bytearray()
        for msg in messages:
            out += grpc_frame(msg)
        self._send(h2_frame(_F_DATA, 0, stream_id, bytes(out)))

    # -- reads --------------------------------------------------------------

    def _read_timeout(self) -> Optional[float]:
        """Idle timeout, tightened to the nearest live stream deadline so
        a header/body reap never waits out the whole idle window."""
        gov = self.engine.sidecar.governor
        timeout = gov.idle_timeout_s if gov.idle_timeout_s > 0 else None
        now = _time.monotonic()
        for ns in self.streams.values():
            if ns.closed or ns.ext is None or ns.ext.deadline is None:
                continue
            remain = max(0.05, ns.ext.deadline - now)
            if timeout is None or remain < timeout:
                timeout = remain
        return timeout

    def serve(self) -> None:
        gov = self.engine.sidecar.governor
        try:
            self.sock.settimeout(
                gov.idle_timeout_s if gov.idle_timeout_s > 0 else None
            )
            preface = _recv_exact(self.sock, len(H2_PREFACE))
            if preface != H2_PREFACE:
                return
            # Our SETTINGS + a receive-window bump for buffered bodies.
            settings = struct.pack("!HI", 0x4, _WINDOW_BONUS)  # INITIAL_WINDOW_SIZE
            self._send(h2_frame(_F_SETTINGS, 0, 0, settings))
            self._send(h2_frame(
                _F_WINDOW_UPDATE, 0, 0, struct.pack("!I", _WINDOW_BONUS)
            ))
            while not self.closing:
                self.sock.settimeout(self._read_timeout())
                try:
                    ftype, flags, stream_id, payload = read_h2_frame(self.sock)
                except socket.timeout:
                    if not self._reap_deadlines():
                        return  # fully idle past the idle deadline
                    continue
                self._dispatch(ftype, flags, stream_id, payload)
                self._reap_deadlines()
        except (ConnectionError, OSError, ValueError):
            pass
        except Exception as err:
            gov.count("conn_errors_total")
            log.error("ext_proc connection failed", err)
        finally:
            for ns in self.streams.values():
                if ns.ext is not None and not ns.closed:
                    self.engine.close_stream(ns.ext)
                    ns.closed = True
            self.streams.clear()
            try:
                self.sock.close()
            except OSError:
                pass

    def _reap_deadlines(self) -> bool:
        """Answer 408 on streams past their header/body deadline.
        Returns False when the connection is idle with no live streams
        (caller closes on idle timeout)."""
        now = _time.monotonic()
        live = False
        for stream_id, ns in list(self.streams.items()):
            if ns.closed or ns.ext is None:
                continue
            live = True
            dl = ns.ext.deadline
            if dl is not None and now > dl:
                self._send_messages(stream_id, ns, [
                    self.engine.deadline_response(ns.ext)
                ])
                self._finish_stream(stream_id, ns)
        return live

    def _dispatch(self, ftype: int, flags: int, stream_id: int,
                  payload: bytes) -> None:
        if self.continuation_for is not None and ftype != _F_CONTINUATION:
            raise ValueError("expected CONTINUATION")
        if ftype == _F_SETTINGS:
            if not flags & _FLAG_ACK:
                self._send(h2_frame(_F_SETTINGS, _FLAG_ACK, 0))
        elif ftype == _F_PING:
            if not flags & _FLAG_ACK:
                self._send(h2_frame(_F_PING, _FLAG_ACK, 0, payload))
        elif ftype == _F_GOAWAY:
            self.closing = True
        elif ftype == _F_HEADERS:
            ns = self.streams.setdefault(stream_id, _NativeStream())
            ns.header_buf += _strip_padding(payload, flags, priority_ok=True)
            if flags & _FLAG_END_HEADERS:
                self._headers_complete(stream_id, ns, flags)
            else:
                self.continuation_for = stream_id
        elif ftype == _F_CONTINUATION:
            if stream_id != self.continuation_for:
                raise ValueError("CONTINUATION for wrong stream")
            ns = self.streams[stream_id]
            ns.header_buf += payload
            if flags & _FLAG_END_HEADERS:
                self.continuation_for = None
                self._headers_complete(stream_id, ns, flags)
        elif ftype == _F_DATA:
            self._on_data(stream_id, flags, payload)
        elif ftype == _F_RST_STREAM:
            ns = self.streams.pop(stream_id, None)
            if ns is not None and ns.ext is not None and not ns.closed:
                self.engine.close_stream(ns.ext)
                ns.closed = True
        # PRIORITY / WINDOW_UPDATE / PUSH_PROMISE: nothing to do — our
        # responses are far below the peer's default send window.

    def _headers_complete(self, stream_id: int, ns: _NativeStream,
                          flags: int) -> None:
        headers = self.decoder.decode(bytes(ns.header_buf))
        ns.header_buf = bytearray()
        if ns.ext is not None:
            # HEADERS after the request headers = gRPC client trailers;
            # nothing to decode beyond keeping HPACK state in sync.
            return
        path = next((v for k, v in headers if k == b":path"), b"")
        if path.decode("latin-1") != EXTPROC_METHOD:
            ns.unknown = True
            self._send_trailers(stream_id, ns, grpc_status=12,
                                message="unknown method")
            return
        ext = self.engine.open_stream(peer=self.peer)
        if ext is None:
            self.frontend.immediate_total += 1
            self._send_messages(
                stream_id, ns, [self.engine.refused_response()]
            )
            self._send_trailers(stream_id, ns)
            return
        ns.ext = ext
        if flags & _FLAG_END_STREAM:
            # A gRPC stream with zero messages: nothing to evaluate.
            self.engine.close_stream(ext)
            self._send_trailers(stream_id, ns)

    def _on_data(self, stream_id: int, flags: int, payload: bytes) -> None:
        data = _strip_padding(payload, flags)
        # Replenish receive flow control for the consumed frame.
        if payload:
            inc = struct.pack("!I", len(payload))
            self._send(
                h2_frame(_F_WINDOW_UPDATE, 0, 0, inc)
                + h2_frame(_F_WINDOW_UPDATE, 0, stream_id, inc)
            )
        ns = self.streams.get(stream_id)
        if ns is None or ns.closed or ns.unknown:
            return
        ns.grpc_buf += data
        messages: List[bytes] = []
        while len(ns.grpc_buf) >= 5:
            mlen = int.from_bytes(ns.grpc_buf[1:5], "big")
            if len(ns.grpc_buf) < 5 + mlen:
                break
            messages.append(bytes(ns.grpc_buf[5 : 5 + mlen]))
            del ns.grpc_buf[: 5 + mlen]
        end = bool(flags & _FLAG_END_STREAM)
        dispatch = False
        with self.ilock:
            ns.inbox.extend(messages)
            ns.half_closed = ns.half_closed or end
            if (ns.inbox or end) and not ns.busy:
                ns.busy = True
                dispatch = True
        if dispatch:
            self.frontend.pool.submit(self._process_stream, stream_id, ns)

    def _process_stream(self, stream_id: int, ns: _NativeStream) -> None:
        """Worker: drain the stream inbox in order (evaluation blocks on
        the batcher, so this never runs on the reader thread)."""
        try:
            while True:
                with self.ilock:
                    if not ns.inbox:
                        half_closed = ns.half_closed
                        ns.busy = False
                        break
                    batch, ns.inbox = ns.inbox, []
                for msg in batch:
                    if ns.closed or ns.ext is None or ns.ext.done:
                        continue
                    responses = self.engine.on_message(ns.ext, msg)
                    self._send_messages(stream_id, ns, responses)
                    if ns.ext.done:
                        self._finish_stream(stream_id, ns)
            if half_closed and not ns.closed:
                self._finish_stream(stream_id, ns)
        except (ConnectionError, OSError):
            pass
        except Exception as err:
            self.engine.sidecar.governor.count("conn_errors_total")
            log.error("ext_proc stream failed", err)
            try:
                self._send_trailers(stream_id, ns, grpc_status=13,
                                    message="internal")
            except (ConnectionError, OSError):
                pass

    def _finish_stream(self, stream_id: int, ns: _NativeStream) -> None:
        if ns.ext is not None and not ns.closed:
            self.engine.close_stream(ns.ext)
        self._send_trailers(stream_id, ns)


# ---------------------------------------------------------------------------
# the frontend
# ---------------------------------------------------------------------------


class ExtProcFrontend:
    """The sidecar's third serving surface: Envoy ext_proc over gRPC.

    ``impl`` resolves ``auto`` → ``grpcio`` when importable, else the
    native HTTP/2 subset (pin with ``CKO_EXTPROC_IMPL``). Both serve the
    same :class:`ExtProcEngine`. The listener binds eagerly so ``port``
    answers before ``start()`` (ephemeral port 0 in tests)."""

    def __init__(self, sidecar, port: int, impl: str = "auto"):
        self.sidecar = sidecar
        self.engine = ExtProcEngine(self)
        self.impl = self._resolve_impl(impl)
        self.connections = 0
        self.connections_total = 0
        self.streams_total = 0
        self.messages_total = 0
        self.immediate_total = 0
        self.continue_total = 0
        self.bytes_total = 0
        self.connections_streams_seen = False
        self._started = threading.Event()
        self._stopping = False
        self._accept_thread: Optional[threading.Thread] = None
        self.pool = ThreadPoolExecutor(
            max_workers=int(os.environ.get("CKO_EXTPROC_WORKERS", "32")),
            thread_name_prefix="cko-extproc",
        )
        self._grpc_server = None
        self._sock: Optional[socket.socket] = None
        host = sidecar.config.host
        if self.impl == "grpcio":
            import grpc

            self._grpc_server = grpc.server(
                self.pool,
                handlers=(_GrpcioHandler(self.engine, self),),
                options=(("grpc.so_reuseport", 0),),
            )
            self._port = self._grpc_server.add_insecure_port(f"{host}:{port}")
            if self._port == 0:
                raise RuntimeError(f"ext_proc grpcio bind failed on {host}:{port}")
        else:
            self._sock = socket.create_server((host, port), backlog=128)
            self._port = self._sock.getsockname()[1]

    @staticmethod
    def _resolve_impl(impl: str) -> str:
        impl = (impl or "auto").strip().lower()
        if impl not in ("auto", "native", "grpcio"):
            impl = "auto"
        if impl == "auto":
            impl = os.environ.get("CKO_EXTPROC_IMPL", "auto").strip().lower()
        if impl == "auto":
            try:
                import grpc  # noqa: F401

                return "grpcio"
            except Exception:
                return "native"
        return impl if impl in ("native", "grpcio") else "native"

    @property
    def port(self) -> int:
        return self._port

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> None:
        if self.impl == "grpcio":
            self._grpc_server.start()
            self._started.set()
        else:
            self._accept_thread = threading.Thread(
                target=self._accept_loop, name="cko-extproc-accept", daemon=True
            )
            self._accept_thread.start()
            self._started.set()
        log.info("ext_proc frontend started", port=self._port, impl=self.impl)

    def stop(self) -> None:
        if self._stopping:
            return
        self._stopping = True
        if self._grpc_server is not None:
            self._grpc_server.stop(grace=self.sidecar.config.drain_timeout_s)
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
        if self._accept_thread is not None:
            self._accept_thread.join(timeout=5)
        self.pool.shutdown(wait=False)

    def _accept_loop(self) -> None:
        # A closed listener does not reliably wake a blocked accept();
        # poll so stop() never eats the join timeout.
        self._sock.settimeout(0.5)
        while not self._stopping:
            try:
                sock, addr = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            sock.settimeout(None)
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self.connections += 1
            self.connections_total += 1
            conn = _NativeConn(self, sock, addr[0] if addr else "")
            threading.Thread(
                target=self._serve_conn, args=(conn,),
                name="cko-extproc-conn", daemon=True,
            ).start()

    def _serve_conn(self, conn: _NativeConn) -> None:
        try:
            conn.serve()
        finally:
            self.connections -= 1

    def stats(self) -> Dict[str, Any]:
        return {
            "impl": self.impl,
            "port": self._port,
            "connections": self.connections,
            "connections_total": self.connections_total,
            "streams_total": self.streams_total,
            "messages_total": self.messages_total,
            "immediate_total": self.immediate_total,
            "continue_total": self.continue_total,
            "bytes_total": self.bytes_total,
        }


# ---------------------------------------------------------------------------
# grpcio fast path
# ---------------------------------------------------------------------------


def _make_grpcio_handler_cls():
    import grpc

    class Handler(grpc.GenericRpcHandler):
        def __init__(self, engine: ExtProcEngine, frontend: ExtProcFrontend):
            self._engine = engine
            self._frontend = frontend

        def service(self, handler_call_details):
            if handler_call_details.method != EXTPROC_METHOD:
                return None
            engine = self._engine
            frontend = self._frontend

            def process(request_iterator, context):
                frontend.connections_total += 1
                frontend.connections += 1
                st = engine.open_stream(peer=str(context.peer() or ""))
                try:
                    if st is None:
                        frontend.immediate_total += 1
                        yield engine.refused_response()
                        return
                    for raw in request_iterator:
                        for resp in engine.on_message(st, raw):
                            yield resp
                        if st.done:
                            return
                finally:
                    if st is not None:
                        engine.close_stream(st)
                    frontend.connections -= 1

            # Identity serializers: the session engine already speaks
            # serialized ProcessingRequest/ProcessingResponse bytes.
            return grpc.stream_stream_rpc_method_handler(
                process, request_deserializer=None, response_serializer=None
            )

    return Handler


def _GrpcioHandler(engine: ExtProcEngine, frontend: ExtProcFrontend):
    return _make_grpcio_handler_cls()(engine, frontend)


# ---------------------------------------------------------------------------
# minimal blocking client (tests, hack/extproc_smoke.py, debugging)
# ---------------------------------------------------------------------------


class ExtProcClient:
    """A sequential ext_proc client over the same HTTP/2 subset — drives
    the tri-parity test and the smoke harness against either server
    impl (it speaks enough HTTP/2 to talk to grpcio's C core too)."""

    def __init__(self, host: str, port: int, timeout_s: float = 30.0):
        self.sock = socket.create_connection((host, port), timeout=timeout_s)
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self.decoder = HpackDecoder()
        self.encoder = HpackEncoder()
        self.authority = f"{host}:{port}"
        self._next_stream = 1
        self.sock.sendall(
            H2_PREFACE
            + h2_frame(_F_SETTINGS, 0, 0,
                       struct.pack("!HI", 0x4, _WINDOW_BONUS))
            + h2_frame(_F_WINDOW_UPDATE, 0, 0,
                       struct.pack("!I", _WINDOW_BONUS))
        )

    def close(self) -> None:
        try:
            self.sock.sendall(h2_frame(_F_GOAWAY, 0, 0, bytes(8)))
        except OSError:
            pass
        try:
            self.sock.close()
        except OSError:
            pass

    # -- wire helpers -------------------------------------------------------

    def _send_headers(self, stream_id: int,
                      extra: List[Tuple[bytes, bytes]] = ()) -> None:
        block = self.encoder.encode([
            (b":method", b"POST"),
            (b":scheme", b"http"),
            (b":path", EXTPROC_METHOD.encode()),
            (b":authority", self.authority.encode()),
            (b"content-type", b"application/grpc"),
            (b"te", b"trailers"),
            *extra,
        ])
        self.sock.sendall(h2_frame(_F_HEADERS, _FLAG_END_HEADERS,
                                   stream_id, block))

    def _send_message(self, stream_id: int, message: bytes,
                      end_stream: bool = False) -> None:
        self.sock.sendall(h2_frame(
            _F_DATA, _FLAG_END_STREAM if end_stream else 0,
            stream_id, grpc_frame(message),
        ))

    def _read_event(self, stream_id: int) -> Tuple[str, Any]:
        """Next (kind, payload) on the stream: ``("message", bytes)``,
        ``("trailers", {header: value})`` or ``("reset", code)``."""
        buf = getattr(self, "_grpc_buf", None)
        if buf is None:
            buf = self._grpc_buf = bytearray()
        while True:
            if len(buf) >= 5:
                mlen = int.from_bytes(buf[1:5], "big")
                if len(buf) >= 5 + mlen:
                    msg = bytes(buf[5 : 5 + mlen])
                    del buf[: 5 + mlen]
                    return "message", msg
            ftype, flags, sid, payload = read_h2_frame(self.sock)
            if ftype == _F_SETTINGS:
                if not flags & _FLAG_ACK:
                    self.sock.sendall(h2_frame(_F_SETTINGS, _FLAG_ACK, 0))
            elif ftype == _F_PING:
                if not flags & _FLAG_ACK:
                    self.sock.sendall(h2_frame(_F_PING, _FLAG_ACK, 0, payload))
            elif ftype == _F_HEADERS:
                block = _strip_padding(payload, flags, priority_ok=True)
                while not flags & _FLAG_END_HEADERS:
                    ftype2, flags, sid2, payload2 = read_h2_frame(self.sock)
                    if ftype2 != _F_CONTINUATION:
                        raise ValueError("expected CONTINUATION")
                    block += payload2
                headers = {
                    k.decode("latin-1"): v.decode("latin-1")
                    for k, v in self.decoder.decode(block)
                }
                if sid == stream_id and (
                    flags & _FLAG_END_STREAM or "grpc-status" in headers
                ):
                    return "trailers", headers
            elif ftype == _F_DATA and sid == stream_id:
                buf += _strip_padding(payload, flags)
            elif ftype == _F_RST_STREAM and sid == stream_id:
                return "reset", int.from_bytes(payload[:4], "big")
            elif ftype == _F_GOAWAY:
                raise ConnectionError("server sent GOAWAY")

    # -- the one call the harnesses need ------------------------------------

    def filter(self, method: str, uri: str,
               headers: List[Tuple[str, str]], body: bytes,
               authority: str | None = None) -> Dict[str, Any]:
        """Run one proxied request through ext_proc. Returns the decoded
        verdict: ``{"status", "headers", "body", "allowed"}`` shaped like
        an HTTP frontend reply (CONTINUE → status 200, mutation headers,
        no body)."""
        stream_id = self._next_stream
        self._next_stream += 2
        self._grpc_buf = bytearray()
        pseudo_authority = authority
        hdrs: List[Tuple[str, str]] = []
        for k, v in headers:
            if k.lower() == "host" and pseudo_authority is None:
                pseudo_authority = v
            hdrs.append((k.lower(), v))
        ext_headers = [
            (":method", method),
            (":scheme", "http"),
            (":authority", pseudo_authority or self.authority),
            (":path", uri),
        ] + [(k, v) for k, v in hdrs if k != "host"]
        self._send_headers(stream_id)
        self._send_message(
            stream_id, encode_request_headers(ext_headers, not body)
        )
        mutation: Dict[str, str] = {}
        while True:
            kind, payload = self._read_event(stream_id)
            if kind == "reset":
                raise ConnectionError(f"stream reset: {payload}")
            if kind == "trailers":
                raise ConnectionError(
                    f"stream ended without verdict: {payload}"
                )
            resp = decode_processing_response(payload)
            if resp["kind"] == "immediate":
                self._drain_stream_end(stream_id)
                return {
                    "status": resp["status"],
                    "headers": resp["headers"],
                    "body": resp["body"],
                    "allowed": False,
                }
            if resp["kind"] != "continue":
                continue
            mutation.update(resp.get("headers", {}))
            if resp.get("phase") == "request_headers" and body:
                self._send_message(
                    stream_id, encode_request_body(body, True),
                    end_stream=True,
                )
                continue
            self._drain_stream_end(stream_id)
            return {
                "status": 200,
                "headers": mutation,
                "body": b"",
                "allowed": True,
            }

    def _drain_stream_end(self, stream_id: int) -> None:
        """Consume trailers (or reset) so the connection is clean for
        the next sequential stream."""
        try:
            while True:
                kind, payload = self._read_event(stream_id)
                if kind in ("trailers", "reset"):
                    return
        except (ConnectionError, OSError, socket.timeout):
            return
