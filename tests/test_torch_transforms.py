"""PyTorch port parity: device byte transforms vs the JAX package.

Every ``DEVICE_TRANSFORMS`` entry and ``apply_device_pipeline`` run on the
same seeded batches through ``coraza_kubernetes_operator_tpu.ops.transforms``
(JAX, CPU) and ``coraza_kubernetes_operator_tpu_torch.ops.transforms``
(PyTorch, CPU). Outputs are bytes and lengths, so parity is exact
equality: no tolerance.
"""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coraza_kubernetes_operator_tpu.ops import transforms as jt
from coraza_kubernetes_operator_tpu_torch.ops import transforms as tt

# Bytes that exercise every decoder: %-escapes (hex, %u), '+', HTML
# entities (named, decimal, hex), whitespace of every class, NUL, and
# high bytes.
_ALPHABET = np.frombuffer(
    b"%%%uU0123456789abcdefABCDEF&&##;;;xXltgampquotnbsp+  \t\n\r\x0b\x0c\x00\x00zZ<>'\xa0\xff",
    dtype=np.uint8,
)
_EDGES = [
    b"",
    b"%41%42%4",
    b"%u0041%U00e9%u00%zz%",
    b"a+b%20c%2",
    b"&lt;&GT;&amp;&quot;&nbsp;&bogus;&lt",
    b"&#65;&#x41;&#X4a;&#0000065;&#x;&#;&#12345678;",
    b"\x00\x00a\x00b\x00",
    b"  \t lead and trail \r\n ",
    b"a   b\t\tc\n\nd",
    b"%00%0a%2525&#37;41",
]


def _batch(seed: int, n: int, length: int):
    rng = np.random.default_rng(seed)
    data = _ALPHABET[rng.integers(0, _ALPHABET.size, size=(n, length))]
    lens = rng.integers(0, length + 1, size=n).astype(np.int32)
    for i, edge in enumerate(_EDGES[: min(n, len(_EDGES))]):
        edge = edge[:length]
        data[i, : len(edge)] = np.frombuffer(edge, dtype=np.uint8)
        lens[i] = len(edge)
    data[np.arange(length)[None, :] >= lens[:, None]] = 0
    return data, lens


def _run_jax(fn, data, lens):
    d, ln = jax.jit(fn)(jnp.asarray(data), jnp.asarray(lens))
    return np.asarray(d), np.asarray(ln)


def _run_torch(fn, data, lens):
    d, ln = fn(torch.as_tensor(data), torch.as_tensor(lens))
    assert d.dtype == torch.uint8 and d.shape == data.shape
    return d.numpy(), ln.numpy()


def _assert_same(got, want, what):
    np.testing.assert_array_equal(got[1], want[1], err_msg=f"{what}: lengths")
    np.testing.assert_array_equal(got[0], want[0], err_msg=f"{what}: bytes")


def test_registry_names_match():
    assert list(tt.DEVICE_TRANSFORMS) == list(jt.DEVICE_TRANSFORMS)


@pytest.mark.parametrize("name", list(jt.DEVICE_TRANSFORMS))
def test_transform_matches_jax(name):
    data, lens = _batch(seed=zlib.crc32(name.encode()), n=160, length=48)
    want = _run_jax(jt.DEVICE_TRANSFORMS[name], data, lens)
    got = _run_torch(tt.DEVICE_TRANSFORMS[name], data, lens)
    _assert_same(got, want, name)


@pytest.mark.parametrize("name", ["urldecodeuni", "removewhitespace", "htmlentitydecode"])
def test_transform_matches_jax_wide_rows(name):
    """Rows wider than 512 bytes: the reference compacts by sort there
    (its one-hot matmul form is for narrow rows); the port's single
    scatter form must give the same bytes at both widths."""
    data, lens = _batch(seed=11, n=6, length=600)
    want = _run_jax(jt.DEVICE_TRANSFORMS[name], data, lens)
    got = _run_torch(tt.DEVICE_TRANSFORMS[name], data, lens)
    _assert_same(got, want, name)


@pytest.mark.parametrize(
    "pipeline",
    [
        ("urldecodeuni", "lowercase"),
        ("urldecodeuni", "htmlentitydecode", "removenulls"),
        ("urldecodeuni", "lowercase", "compresswhitespace"),
        ("htmlentitydecode", "trim", "uppercase", "replacenulls"),
        ("urldecode", "removewhitespace", "trimleft", "trimright"),
    ],
)
def test_pipeline_matches_jax(pipeline):
    data, lens = _batch(seed=len(pipeline) * 7 + 1, n=160, length=64)
    want = _run_jax(lambda d, ln: jt.apply_device_pipeline(d, ln, pipeline), data, lens)
    got = _run_torch(lambda d, ln: tt.apply_device_pipeline(d, ln, pipeline), data, lens)
    _assert_same(got, want, "+".join(pipeline))


def test_compact_matches_jax():
    rng = np.random.default_rng(5)
    data = rng.integers(1, 256, size=(64, 40)).astype(np.uint8)
    keep = rng.random((64, 40)) < 0.6
    want_d, want_l = jax.jit(jt.compact)(jnp.asarray(data), jnp.asarray(keep))
    got_d, got_l = tt.compact(torch.as_tensor(data), torch.as_tensor(keep))
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(want_l))
    np.testing.assert_array_equal(got_d.numpy(), np.asarray(want_d))
