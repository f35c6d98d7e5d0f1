"""PyTorch port parity: the ext_proc wire codec against the JAX package's.

``sidecar/extproc.py`` is device-free: a protobuf subset, HPACK with
Huffman and HTTP/2 framing. Every vector of ``tests/test_extproc.py``
(RFC 7541 Appendix C, the protobuf varint example, the ext_proc message
encoders and decoders, the frame helpers) goes through both packages'
copies and must give equal bytes, or equal decoded values, and the values
the RFCs give. No engine is built.
"""

import binascii
import socket

import pytest

from coraza_kubernetes_operator_tpu.sidecar import extproc as jx
from coraza_kubernetes_operator_tpu_torch.sidecar import extproc as tx

BOTH = pytest.mark.parametrize("xp", [jx, tx], ids=["jax", "torch"])


def _same(fn):
    """``fn(module)`` on both packages; asserts equal and returns it."""
    got_j, got_t = fn(jx), fn(tx)
    assert got_t == got_j
    return got_t


@pytest.mark.parametrize("value", [0, 1, 127, 128, 300, 1 << 21, (1 << 63) - 1])
def test_varint_bytes_equal(value):
    def enc(xp):
        out = bytearray()
        xp.write_varint(out, value)
        return bytes(out)

    out = _same(enc)
    assert _same(lambda xp: xp.read_varint(out, 0)) == (value, len(out))
    if value == 300:  # the protobuf docs' worked example
        assert out == b"\xac\x02"


@pytest.mark.parametrize("field,payload", [(1, b""), (2, b"abc"), (19, b"x" * 300)])
def test_field_framing_equal(field, payload):
    _same(lambda xp: xp.field_bytes(field, payload))
    _same(lambda xp: xp.field_varint(field, len(payload) + 7))
    _same(lambda xp: list(xp.iter_fields(xp.field_bytes(field, payload) + xp.field_varint(3, 5))))


@pytest.mark.parametrize(
    "headers,eos",
    [([(":method", "GET"), (":path", "/x"), ("host", "t")], True),
     ([(":method", "POST"), (":path", "/submit?a=1"), ("content-type", "application/json"),
       ("x-long", "v" * 200)], False)],
    ids=["get", "post"],
)
def test_request_headers_encode_decode_equal(headers, eos):
    msg = _same(lambda xp: xp.encode_request_headers(headers, eos))
    kind, payload = _same(lambda xp: xp.decode_processing_request(msg))
    assert kind == "request_headers"
    assert payload["headers"] == headers and payload["end_of_stream"] is eos
    _same(lambda xp: xp.encode_header_map(headers))
    _same(lambda xp: xp.decode_header_map(xp.encode_header_map(headers)))


@pytest.mark.parametrize("body,eos", [(b"a=1&b=2", True), (b"", True), (b"\x00\xff" * 100, False)])
def test_request_body_encode_decode_equal(body, eos):
    msg = _same(lambda xp: xp.encode_request_body(body, eos))
    kind, payload = _same(lambda xp: xp.decode_processing_request(msg))
    assert kind == "request_body" and payload["body"] == body


@pytest.mark.parametrize(
    "status,body,headers",
    [(403, b"blocked by WAF\n", [("x-waf-action", b"deny"), ("x-waf-rule-id", b"3001")]),
     (503, b"too many connections\n", [("content-type", b"text/plain")]),
     (429, b"WAF overloaded, retry later\n", [("x-waf-action", b"shed"), ("retry-after", b"2")])],
    ids=["403", "503", "429"],
)
def test_immediate_response_equal(status, body, headers):
    msg = _same(lambda xp: xp.encode_immediate_response(status, body, headers))
    resp = _same(lambda xp: xp.decode_processing_response(msg))
    assert (resp["kind"], resp["status"], resp["body"]) == ("immediate", status, body)
    assert resp["headers"] == {k: v.decode() for k, v in headers}


@pytest.mark.parametrize("phase,mutation", [(1, [("x-waf-action", b"allow")]), (3, [])])
def test_continue_response_equal(phase, mutation):
    msg = _same(lambda xp: xp.encode_continue_response(phase, mutation))
    resp = _same(lambda xp: xp.decode_processing_response(msg))
    assert resp["kind"] == "continue"
    assert resp["phase"] == {1: "request_headers", 3: "request_body"}[phase]
    _same(lambda xp: xp.encode_header_mutation(mutation))


HUFFMAN = [  # RFC 7541 C.4 / C.6
    ("f1e3c2e5f23a6ba0ab90f4ff", b"www.example.com"),
    ("a8eb10649cbf", b"no-cache"),
    ("25a849e95ba97d7f", b"custom-key"),
    ("25a849e95bb8e8b4bf", b"custom-value"),
    ("6402", b"302"),
    ("aec3771a4b", b"private"),
    ("d07abe941054d444a8200595040b8166e082a62d1bff", b"Mon, 21 Oct 2013 20:13:21 GMT"),
    ("9d29ad171863c78f0b97c8e9ae82ae43d3", b"https://www.example.com"),
]


@pytest.mark.parametrize("hexval,expect", HUFFMAN, ids=[e.decode()[:16] for _h, e in HUFFMAN])
def test_huffman_vectors_equal(hexval, expect):
    assert _same(lambda xp: xp.huffman_decode(binascii.unhexlify(hexval))) == expect


@BOTH
@pytest.mark.parametrize("bad", ["a8eb10649cbfff", "ffffffff"], ids=["long-padding", "eos"])
def test_huffman_rejects_bad_padding_and_eos(xp, bad):
    with pytest.raises(ValueError):
        xp.huffman_decode(binascii.unhexlify(bad))


@pytest.mark.parametrize("data,prefix,want", [(b"\x1f\x9a\x0a", 5, (1337, 3)), (b"\x0a", 5, (10, 1))])
def test_hpack_integer_prefix_equal(data, prefix, want):
    assert _same(lambda xp: xp.HpackDecoder._read_int(data, 0, prefix)) == want


HPACK_SEQUENCES = {
    "C.3": ["828684410f7777772e6578616d706c652e636f6d", "828684be58086e6f2d6361636865",
            "828785bf400a637573746f6d2d6b65790c637573746f6d2d76616c7565"],
    "C.4": ["828684418cf1e3c2e5f23a6ba0ab90f4ff", "828684be5886a8eb10649cbf"],
}


@pytest.mark.parametrize("name", list(HPACK_SEQUENCES))
def test_hpack_request_sequences_equal(name):
    """Appendix C request sequences on one decoder each: the static table,
    incremental indexing and dynamic-table reuse."""
    def run(xp):
        dec = xp.HpackDecoder()
        return [dec.decode(binascii.unhexlify(h)) for h in HPACK_SEQUENCES[name]]

    blocks = _same(run)
    assert blocks[0][-1] == (b":authority", b"www.example.com")
    assert blocks[1][-1] == (b"cache-control", b"no-cache")


def test_hpack_encoder_bytes_equal():
    headers = [(b":status", b"200"), (b"content-type", b"application/grpc"),
               (b"x-waf-action", b"allow"), (b"grpc-status", b"0")]
    block = _same(lambda xp: xp.HpackEncoder().encode(headers))
    assert _same(lambda xp: xp.HpackDecoder().decode(block)) == headers


def test_frames_equal():
    assert tx.H2_PREFACE == jx.H2_PREFACE
    _same(lambda xp: xp.h2_frame(xp._F_SETTINGS, 0, 0))
    _same(lambda xp: xp.h2_frame(xp._F_HEADERS, xp._FLAG_END_HEADERS | xp._FLAG_END_STREAM, 1, b"abc"))
    _same(lambda xp: xp.grpc_frame(b"\x0a\x03abc"))
    padded = b"\x02abc\x00\x00"
    _same(lambda xp: xp._strip_padding(padded, xp._FLAG_PADDED))


def test_read_frame_equal():
    def read(xp):
        a, b = socket.socketpair()
        try:
            a.sendall(xp.h2_frame(xp._F_DATA, 1, 3, xp.grpc_frame(b"payload")))
            return xp.read_h2_frame(b)
        finally:
            a.close()
            b.close()

    assert _same(read)[:3] == (jx._F_DATA, 1, 3)
