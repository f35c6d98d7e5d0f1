"""PyTorch port parity: the conv-segment matcher vs the JAX package.

``match_segment_block`` of the port (``conv1d`` + bitmap algebra) runs on
the CPU against the JAX package's (jitted, CPU) on the same bytes: on
crs-lite's own segment blocks as ``build_model`` lays them out, on a
block of hand-picked shapes that covers every chain element (bounded and
unbounded any-byte and class gaps, anchors), and at Q > 512, where the
NCE prefix sum switches from the triangular matmul to cumsum. Hits are
booleans, so parity is exact equality.
"""

import dataclasses
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coraza_kubernetes_operator_tpu.compiler.re_parser import parse_regex as jparse
from coraza_kubernetes_operator_tpu.compiler.segments import plan_segments as jplan
from coraza_kubernetes_operator_tpu.ops import segment as jseg
from coraza_kubernetes_operator_tpu_torch.compiler.re_parser import parse_regex as tparse
from coraza_kubernetes_operator_tpu_torch.compiler.segments import plan_segments as tplan
from coraza_kubernetes_operator_tpu_torch.ops import segment as tseg

CPU = torch.device("cpu")

PATTERNS = [
    (r"\bunion\s+(all\s+)?select\b", True),
    (r"select\b.+\bfrom", True),
    (r"<script[^>]*>", True),
    (r"(or|and)\b\s+\d+\s*=\s*\d+", True),
    (r"a{2,4}b", False),
    (r"^/admin", False),
    (r"\.php$", False),
    (r"x\d{3}y", False),
    (r"\$\(.*\)", False),
    (r"select\b[^;]{0,40}\bfrom", True),
    (r"\b(select|update|delete)\b.{2,50}\b(from|where)\b", True),
    (r"q[\s\S]{3,6}z", False),
    (r"go[\s\S]*stop", False),
    (r"^go.*stop$", False),
]
TOKENS = [
    b"union select ", b"select a from b", b"<script src=x>", b" or 1=1", b"aaab",
    b"/admin", b".php", b"x123y", b"$(id)", b"update t where", b"q1234z", b"go",
    b"stop", b"' or '1'='1", b"../../etc/passwd", b"<img onerror=alert(1)>",
    b"exec xp_cmdshell", b"sleep(5)", b"${jndi:", b"union all select",
]


def _rows(n, length, seed):
    rng = np.random.default_rng(seed)
    alphabet = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz0123456789 ='\"<>()/;-_.%&+,:!*#@$", np.uint8)
    data = alphabet[rng.integers(0, alphabet.size, size=(n, length))]
    for r in range(n):
        for _ in range(rng.integers(0, 4)):
            tok = np.frombuffer(TOKENS[rng.integers(len(TOKENS))], np.uint8)
            if tok.size < length:
                at = rng.integers(0, length - tok.size)
                data[r, at : at + tok.size] = tok
    lens = rng.integers(0, length + 1, size=n).astype(np.int32)
    lens[:4] = length
    data[np.arange(length)[None, :] >= lens[:, None]] = 0
    return data, lens


def _jax_hits(kernel, spec, data, lens):
    fn = jax.jit(jseg.match_segment_block, static_argnums=(1,))
    return np.asarray(fn(kernel, spec, jnp.asarray(data), jnp.asarray(lens)))


def _torch_hits(block, data, lens):
    out = tseg.match_segment_block(block.kernel, block.spec, torch.as_tensor(data), torch.as_tensor(lens))
    assert out.dtype == torch.bool
    return out.numpy()


def _blocks(patterns):
    jb = jseg.build_segment_block([jplan(jparse(p, case_insensitive=ci)) for p, ci in patterns])
    tb = tseg.build_segment_block(
        [tplan(tparse(p, case_insensitive=ci)) for p, ci in patterns], device=CPU
    )
    return jb, tb


def _assert_same_block(jb, tb):
    assert dataclasses.asdict(tb.spec) == dataclasses.asdict(jb.spec)
    np.testing.assert_array_equal(
        tb.kernel.to(torch.float32).numpy(), np.asarray(jb.kernel).astype(np.float32)
    )


@pytest.mark.parametrize("length", [64, tseg._NCE_MATMUL_MAX_Q + 88])
def test_shape_block_matches_jax_and_re(length):
    jb, tb = _blocks(PATTERNS)
    _assert_same_block(jb, tb)
    data, lens = _rows(40, length, seed=length)
    # A match deep past the matmul/cumsum threshold.
    deep = b"z" * (length - 40) + b"select x from t"
    data[0, :] = 0
    data[0, : len(deep)] = np.frombuffer(deep, np.uint8)
    lens[0] = len(deep)
    got = _torch_hits(tb, data, lens)
    np.testing.assert_array_equal(got, _jax_hits(jb.kernel, jb.spec, data, lens))
    for gi, (pat, ci) in enumerate(PATTERNS):
        oracle = re.compile(pat.encode(), re.IGNORECASE if ci else 0)
        for i in range(data.shape[0]):
            assert bool(got[i, gi]) == (oracle.search(data[i, : lens[i]].tobytes()) is not None), (pat, i)


@pytest.fixture(scope="module")
def crs_lite_blocks():
    from coraza_kubernetes_operator_tpu.compiler.automata_plan import plan_automata as jpa
    from coraza_kubernetes_operator_tpu.compiler.ruleset import compile_rules as jcompile
    from coraza_kubernetes_operator_tpu.models.waf_model import build_model as jbuild
    from coraza_kubernetes_operator_tpu_torch.compiler.automata_plan import plan_automata as tpa
    from coraza_kubernetes_operator_tpu_torch.compiler.ruleset import compile_rules as tcompile
    from coraza_kubernetes_operator_tpu_torch.ftw.corpus import load_ruleset_text
    from coraza_kubernetes_operator_tpu_torch.models.waf_model import build_model as tbuild

    text = load_ruleset_text()
    jcrs, tcrs = jcompile(text), tcompile(text)
    jm = jbuild(jcrs, automata=jpa(jcrs))
    tm = tbuild(tcrs, automata=tpa(tcrs), device=CPU)
    assert len(tm.segs) == len(jm.segs) == 8
    return jm.segs, tm.segs


# The four cheapest of crs-lite's eight blocks to trace on XLA:CPU; block
# 3 carries bucket and suffix chains, narrow/wide/unbounded class gaps and
# both anchors. The others take minutes to compile on the JAX side.
@pytest.mark.parametrize("bi", [1, 3, 4, 6])
def test_crs_lite_block_matches_jax(crs_lite_blocks, bi):
    jsegs, tsegs = crs_lite_blocks
    _assert_same_block(jsegs[bi], tsegs[bi])
    data, lens = _rows(48, 64, seed=bi)
    np.testing.assert_array_equal(
        _torch_hits(tsegs[bi], data, lens), _jax_hits(jsegs[bi].kernel, jsegs[bi].spec, data, lens)
    )


def test_crs_lite_block_matches_jax_past_q512(crs_lite_blocks):
    jsegs, tsegs = crs_lite_blocks
    data, lens = _rows(6, tseg._NCE_MATMUL_MAX_Q + 40, seed=17)
    np.testing.assert_array_equal(
        _torch_hits(tsegs[3], data, lens), _jax_hits(jsegs[3].kernel, jsegs[3].spec, data, lens)
    )


def test_all_crs_lite_blocks_laid_out_as_jax(crs_lite_blocks):
    jsegs, tsegs = crs_lite_blocks
    for jb, tb in zip(jsegs, tsegs):
        _assert_same_block(jb, tb)
        assert tseg.conv_n2_cols(tb.spec) == jseg.conv_n2_cols(jb.spec)


def test_finals_kernel_knob_raises(monkeypatch):
    _, tb = _blocks(PATTERNS[:2])
    data, lens = _rows(4, 32, seed=0)
    monkeypatch.setenv("CKO_PALLAS_FINALS", "1")
    assert os.environ["CKO_PALLAS_FINALS"] == "1"
    with pytest.raises(NotImplementedError):
        _torch_hits(tb, data, lens)
