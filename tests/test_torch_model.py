"""PyTorch port parity: ``build_model``, ``model_from_arrays`` and the two
window stages (``match_tier_packed``, ``eval_post_tiered``) vs the JAX
package.

The port compiles its own tables from Seclang through its copy of the
compiler; on crs-lite with the automata plan every table equals the
reference's, field by field and dtype by dtype, and so do the statics.
The JAX model's arrays, read out with ``np.asarray``, carried across with
``model_from_arrays``, give the port's own model back. The stages run on
a small ruleset that reaches every matcher kind (segment blocks, a flat
bin, gather banks, a prefilter bank, a host pipeline) plus counters,
chains, a numeric link and a rule removal; their outputs are packed
bytes and int32 words, compared for equality.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coraza_kubernetes_operator_tpu.compiler.automata_plan import plan_automata as jplan
from coraza_kubernetes_operator_tpu.compiler.ruleset import compile_rules as jcompile
from coraza_kubernetes_operator_tpu.models import waf_model as jwm
from coraza_kubernetes_operator_tpu_torch import corpus as tcorpus
from coraza_kubernetes_operator_tpu_torch.compiler.automata_plan import plan_automata as tplan
from coraza_kubernetes_operator_tpu_torch.compiler.ruleset import compile_rules as tcompile
from coraza_kubernetes_operator_tpu_torch.engine import WafEngine
from coraza_kubernetes_operator_tpu_torch.ftw.corpus import load_ruleset_text
from coraza_kubernetes_operator_tpu_torch.models import waf_model as twm
from coraza_kubernetes_operator_tpu_torch.models.convert import model_from_arrays, model_to_arrays
from torch_rules import SMALL_RULES

CPU = torch.device("cpu")



def _build_both(text):
    jcrs, tcrs = jcompile(text), tcompile(text)
    jm = jwm.build_model(jcrs, automata=jplan(jcrs))
    tm = twm.build_model(tcrs, automata=tplan(tcrs), device=CPU)
    return jm, tm


def _jax_arrays(jm) -> dict:
    """The JAX model as ``model_from_arrays`` takes it: numpy arrays and
    statics per field, nested banks as lists of dicts."""

    def arr(v):
        return np.asarray(v)

    def bank(b):
        if hasattr(b, "spec"):
            return {"kernel": arr(b.kernel), "spec": dataclasses.asdict(b.spec)}
        out = {}
        for f in dataclasses.fields(b):
            v = getattr(b, f.name)
            out[f.name] = [arr(t) for t in v] if f.name == "tables" else (
                v if isinstance(v, tuple) else arr(v)
            )
        return out

    out = {}
    for f in dataclasses.fields(twm.WafModel):
        if not f.init:
            continue
        v = getattr(jm, f.name)
        if isinstance(v, list):
            out[f.name] = [bank(b) for b in v]
        elif v is None or isinstance(v, (tuple, bool)):
            out[f.name] = v
        else:
            out[f.name] = arr(v)
    return out


def _dtype_name(x) -> str:
    if isinstance(x, torch.Tensor):
        return str(x.dtype).removeprefix("torch.")
    return np.asarray(x).dtype.name


def _assert_same(got, want, path="model"):
    """Recursive equality of two ``model_to_arrays``-shaped values; bf16
    arrays compare as float32 (exact for the small integers they hold)."""
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _assert_same(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)) and not isinstance(want, np.ndarray):
        assert len(got) == len(want), path
        if all(not isinstance(w, (np.ndarray, dict, list, tuple)) for w in want):
            assert tuple(got) == tuple(want), path
        else:
            for i, (g, w) in enumerate(zip(got, want)):
                _assert_same(g, w, f"{path}[{i}]")
    elif isinstance(want, np.ndarray):
        g = np.asarray(got)
        w = want.astype(np.float32) if want.dtype.name == "bfloat16" else want
        assert g.shape == w.shape, path
        np.testing.assert_array_equal(g, w, err_msg=path)
    else:
        assert got == want, path


def _assert_dtypes(tm, jm):
    """Every tensor of the port's model has the reference array's dtype."""
    for f in dataclasses.fields(twm.WafModel):
        if not f.init:
            continue
        tv, jv = getattr(tm, f.name), getattr(jm, f.name)
        if isinstance(tv, torch.Tensor):
            assert _dtype_name(tv) == _dtype_name(jv), f.name
        elif isinstance(tv, list):
            for tb, jb in zip(tv, jv):
                for g in dataclasses.fields(tb):
                    if not g.init:
                        continue
                    a, b = getattr(tb, g.name), getattr(jb, g.name)
                    if isinstance(a, torch.Tensor):
                        assert _dtype_name(a) == _dtype_name(b), (f.name, g.name)
                    elif g.name == "tables":
                        assert [_dtype_name(x) for x in a] == [_dtype_name(x) for x in b]


@pytest.fixture(scope="module")
def crs_lite_models():
    return _build_both(load_ruleset_text())


def test_crs_lite_tables_equal_reference(crs_lite_models):
    jm, tm = crs_lite_models
    assert (len(tm.segs), len(tm.flat_banks), len(tm.gather_banks), len(tm.pre_banks)) == (8, 1, 7, 6)
    _assert_same(model_to_arrays(tm), _jax_arrays(jm))
    _assert_dtypes(tm, jm)
    for name in ("flat_covered", "prefilter_cols", "group_order", "block_kinds", "block_cost"):
        assert getattr(tm, name) == tuple(getattr(jm, name)), name


def test_model_from_arrays_round_trip(crs_lite_models):
    jm, tm = crs_lite_models
    carried = model_from_arrays(_jax_arrays(jm), device="cpu")
    assert carried.device == CPU
    _assert_same(model_to_arrays(carried), model_to_arrays(tm))
    _assert_dtypes(carried, jm)
    for bank, ref in zip(carried.flat_banks + carried.gather_banks + carried.pre_banks,
                         tm.flat_banks + tm.gather_banks + tm.pre_banks):
        for f in ("tab", "tab_off", "n_states", "mend", "mend_off", "always"):
            assert torch.equal(getattr(bank.kt, f), getattr(ref.kt, f)), f


@pytest.fixture(scope="module")
def small_window():
    jm, tm = _build_both(SMALL_RULES)
    eng = WafEngine(SMALL_RULES, device="cpu")
    reqs = tcorpus.synthetic_requests(48, attack_ratio=0.4, seed=21)
    tiers, numvals, _masks = twm_tier(eng, reqs)
    return jm, tm, tiers, numvals


def twm_tier(eng, reqs):
    """The window's tiers as the engine builds them (numpy, host side),
    without the value cache."""
    from coraza_kubernetes_operator_tpu_torch.engine.waf import tier_tensors

    extractions = [eng.extractor.extract(r) for r in reqs]
    return tier_tensors(eng._tensorize(extractions))


def _stages_jax(jm, tiers, numvals, mask=None, cached=None, pairs=None):
    hits = tuple(
        np.asarray(jwm.match_tier_packed(jm, *(jnp.asarray(t[i]) for i in (0, 1, 6, 7)), mask=mask))
        for t in tiers
    )
    pairs = pairs or tuple(tuple(jnp.asarray(t[i]) for i in (2, 3, 4, 5, 8)) for t in tiers)
    cached_j = None if cached is None else tuple(jnp.asarray(c) for c in cached)
    packed = jwm.eval_post_tiered(
        jm, tuple(jnp.asarray(h) for h in hits), pairs, jnp.asarray(numvals), cached=cached_j
    )
    return hits, np.asarray(packed)


def _stages_torch(tm, tiers, numvals, mask=None, cached=None, pairs=None):
    hits = tuple(
        twm.match_tier_packed(tm, *(torch.as_tensor(t[i]) for i in (0, 1, 6, 7)), mask=mask)
        for t in tiers
    )
    pairs = pairs or tuple(tuple(torch.as_tensor(t[i]) for i in (2, 3, 4, 5, 8)) for t in tiers)
    cached_t = None if cached is None else tuple(torch.as_tensor(c) for c in cached)
    packed = twm.eval_post_tiered(tm, hits, pairs, torch.as_tensor(numvals), cached=cached_t)
    assert packed.dtype == torch.int32
    return tuple(h.numpy() for h in hits), packed.numpy()


def test_small_model_tables_equal_reference(small_window):
    jm, tm, _tiers, _numvals = small_window
    assert len(tm.segs) and len(tm.flat_banks) and len(tm.gather_banks) and len(tm.pre_banks)
    assert tm.has_removals and tm.host_variant_index.count(-1) < len(tm.host_variant_index)
    _assert_same(model_to_arrays(tm), _jax_arrays(jm))


@pytest.mark.parametrize("mask", [None, 0b1010101], ids=["all-blocks", "partition-mask"])
def test_match_tier_packed_and_post_equal_reference(small_window, mask):
    jm, tm, tiers, numvals = small_window
    jhits, jpacked = _stages_jax(jm, tiers, numvals, mask=mask)
    thits, tpacked = _stages_torch(tm, tiers, numvals, mask=mask)
    for th, jh in zip(thits, jhits):
        assert th.dtype == np.uint8
        np.testing.assert_array_equal(th, jh)
    np.testing.assert_array_equal(tpacked, jpacked)
    # The window blocks something, and the verdict words decode the same.
    head, matched, scores = twm.unpack_compact(tpacked, tm.n_rules, tm.n_counters)
    assert matched.any()
    if mask is None:
        assert head[:, 0].any()


def test_post_with_cached_rows_equals_reference(small_window):
    """Rows served from the value cache ride behind the matcher rows; the
    post stage must read them through uid exactly as the reference."""
    jm, tm, tiers, numvals = small_window
    jhits, _ = _stages_jax(jm, tiers, numvals)
    n_cached = 8
    u = jhits[0].shape[0]
    cached = (np.ascontiguousarray(jhits[0][:n_cached]),) + tuple(None for _ in tiers[1:])
    t0 = list(tiers[0])
    uid = t0[8].copy()
    uid[uid < n_cached] += u  # those pairs now read the cached copy
    t0[8] = uid
    tiers2 = (tuple(t0),) + tuple(tiers[1:])
    cached_np = tuple(c for c in cached if c is not None)
    assert len(cached_np) == len(tiers2) == 1
    _, jpacked = _stages_jax(jm, tiers2, numvals, cached=cached_np)
    _, tpacked = _stages_torch(tm, tiers2, numvals, cached=cached_np)
    np.testing.assert_array_equal(tpacked, jpacked)
    _, plain = _stages_torch(tm, tiers, numvals)
    np.testing.assert_array_equal(tpacked, plain)


def test_packbits_is_numpy_packbits():
    rng = np.random.default_rng(3)
    for m in (1, 7, 8, 13, 64, 261):
        bits = rng.random((17, m)) < 0.4
        got = twm.packbits(torch.as_tensor(bits)).numpy()
        np.testing.assert_array_equal(got, np.packbits(bits, axis=1))
        back = twm._unpack_hit_rows(torch.as_tensor(got), m).numpy()
        np.testing.assert_array_equal(back, bits)


def test_pack_verdicts_bytes_equal_reference():
    rng = np.random.default_rng(4)
    b, rr, c = 9, 45, 3
    out = {
        "matched": rng.random((b, rr)) < 0.3,
        "interrupted": rng.random(b) < 0.5,
        "status": rng.integers(200, 500, size=b).astype(np.int32),
        "rule_index": rng.integers(-1, rr, size=b).astype(np.int32),
        "scores": rng.integers(-2**31, 2**31 - 1, size=(b, c)).astype(np.int32),
    }
    want = np.asarray(jwm._pack_verdicts({k: jnp.asarray(v) for k, v in out.items()}))
    got = twm._pack_verdicts({k: torch.as_tensor(v) for k, v in out.items()}).numpy()
    np.testing.assert_array_equal(got, want)
    head, matched, scores = twm.unpack_compact(got, rr, c)
    np.testing.assert_array_equal(matched, out["matched"])
    np.testing.assert_array_equal(scores, out["scores"])


def test_segment_tier_row_chunks_equal_whole(small_window, monkeypatch):
    """Above the bitmap budget the conv tier runs in row chunks (a Python
    loop where the reference maps with lax.map): same hits."""
    _jm, tm, tiers, _numvals = small_window
    t = tiers[0]
    args = [torch.as_tensor(t[i]) for i in (0, 1, 6, 7)]
    whole = twm.match_tier(tm, *args)
    per_row = (args[0].shape[1] + 2) * sum(twm.conv_n2_cols(s.spec) for s in tm.segs)
    budget = per_row * 16  # 16-row chunks
    assert args[0].shape[0] * per_row > budget
    monkeypatch.setattr(twm, "_SEG_CHUNK_ELEMS", budget)
    chunked = twm.match_tier(tm, *args)
    assert torch.equal(chunked, whole)
