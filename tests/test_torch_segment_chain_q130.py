"""``tests/test_torch_segment_chain.py``'s parity checks (the chain
kernel's numpy replay, ``chain_match_plain`` and the JAX package) at
three 64-bit words, the last partly used (Q = 130)."""

import pytest

from test_torch_segment import crs_lite_blocks  # noqa: F401
from test_torch_segment_chain import check_crs_lite_block, check_hand_block, check_shapes_block

LENGTH = 128


@pytest.mark.parametrize("bi", range(8))
def test_crs_lite_chain_emulation_plain_and_jax_agree(crs_lite_blocks, monkeypatch, bi):
    check_crs_lite_block(crs_lite_blocks, monkeypatch, bi, LENGTH)


def test_shapes_block_chain_emulation_plain_and_jax_agree(monkeypatch):
    check_shapes_block(monkeypatch, LENGTH)


def test_hand_block_chain_emulation_plain_and_jax_agree(monkeypatch):
    check_hand_block(monkeypatch, LENGTH)
