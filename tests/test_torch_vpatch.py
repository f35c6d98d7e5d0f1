"""Virtual patches at deployment shape (``crs-lite-pl2-vp5k``), on the CPU.

The port's ``WafEngine`` runs slices of the configuration's ruleset: the
first 300 patches beside crs-lite-pl2, and a 200-patch slice beside
crs-lite's scanner and protocol rules, against the benchmark's plain
reference (``portbench/reference``); the slice also against the JAX
package's engine. In the slice the path gates' columns, taken off the rows
of the 14 other kinds that reach their pipeline, outweigh a partition of
path rows that scans every block, so its model has a narrow segment block
and its windows partition rows by whether they reach it; beside the whole
of crs-lite-pl2 300 patches do not, and that ruleset keeps one block per
pipeline, as crs-lite-pl2 does (``plan_segment_blocks``). The requests go
to patched endpoints with the parameter at an allowed value, at a rejected
one, in a form body, or absent, and some are the ``vpatch`` mix's own.
"""

import random

import numpy as np
import pytest

from coraza_kubernetes_operator_tpu_torch.engine import HttpRequest as TRequest
from coraza_kubernetes_operator_tpu_torch.engine import WafEngine as TEngine
from coraza_kubernetes_operator_tpu_torch.models.waf_model import conv_n2_cols
from portbench import vpatch
from portbench.check import verdict_key
from portbench.generator import Mix, canonical
from portbench.harness import ruleset_text
from portbench.reference.evaluate import Reference

LITE = vpatch.BENCH / "configs" / "crs-lite-pl2"
PATCH_LINES = vpatch.RULES.read_text().splitlines()[3:]  # two lines per patch
PLIST = vpatch.patches(random.Random(f"vpatch:{vpatch.SEED}"))
MIX = Mix("vpatch", 7)


def patch_text(n: int) -> str:
    return "\n".join(PATCH_LINES[: 2 * n]) + "\n"


def lite_with_patches(n: int) -> str:
    """crs-lite-pl2's ruleset with the first ``n`` patches before 949."""
    marker = (LITE / "REQUEST-949-BLOCKING-EVALUATION.conf").read_text()
    text = ruleset_text({"rules": {"dir": "crs-lite-pl2", "data": "data",
                                   "files": vpatch_files()}})
    assert marker in text
    return text.replace(marker, patch_text(n) + marker)


def vpatch_files() -> list:
    import json

    cfg = json.loads((vpatch.BENCH / "configs" / "crs-lite-pl2-vp5k.json").read_text())
    return [f for f in cfg["rules"]["files"] if "VIRTUAL-PATCHES" not in f]


def slice_text(n: int = 200) -> str:
    """The first ``n`` patches beside crs-lite's setup, scanner and protocol
    enforcement rules."""
    parts = [f"SecDataDir {LITE / 'data'}"] + [(LITE / name).read_text() for name in (
        "crs-setup.conf", "REQUEST-913-SCANNER-DETECTION.conf",
        "REQUEST-920-PROTOCOL-ENFORCEMENT.conf")]
    return "\n".join(parts + [patch_text(n), (LITE / "REQUEST-949-BLOCKING-EVALUATION.conf").read_text()])


def requests(n_patches: int, count: int, seed: int) -> list:
    """``count`` requests (reference form) to the first ``n_patches``
    endpoints, in four kinds taken in turn: the parameter allowed,
    rejected in the query, rejected in a form body, or absent; every
    fifth is the vpatch mix's own."""
    rng = random.Random(f"vpatch-test:{seed}")
    hosts, agents = MIX.params["hosts"], MIX.params["user_agents"]
    out = []
    for k in range(count):
        if k % 5 == 4:
            out.append(MIX.request(k))
            continue
        p = PLIST[rng.randrange(n_patches)]
        op, arg, param, allow = p
        headers = [("Host", rng.choice(hosts)), ("User-Agent", rng.choice(agents)), ("Accept", "*/*")]
        body = b""
        kind = k % 4
        if kind == 0:
            uri = vpatch.uri(rng, p, vpatch.allowed_value(rng, allow))
        elif kind == 1:
            uri = vpatch.uri(rng, p, rng.choice(vpatch.ATTACKS))
        elif kind == 2:
            uri = vpatch.endpoint_path(rng, op, arg)
            body = f"{param}={vpatch.encode(rng.choice(vpatch.ATTACKS))}&x=1".encode()
            headers.append(("Content-Type", "application/x-www-form-urlencoded"))
        else:
            uri = f"{vpatch.endpoint_path(rng, op, arg)}?other={rng.randrange(100)}"
        out.append(canonical("POST" if body else "GET", f"{uri}&t={k}" if "?" in uri else f"{uri}?t={k}",
                             headers, body))
    return out


def torch_request(r) -> TRequest:
    return TRequest(method=r.method, uri=r.uri, headers=list(r.headers), body=r.body)


def evaluate(engine, reqs: list, window: int = 32) -> list:
    out = []
    for i in range(0, len(reqs), window):
        out += engine.evaluate([torch_request(r) for r in reqs[i:i + window]])
    return out


@pytest.fixture(scope="module")
def lite300():
    text = lite_with_patches(300)
    return TEngine(text, device="cpu"), Reference(text)


def assert_equal_reference(engine, reference, reqs, got, n_patches):
    want = [reference.evaluate(r) for r in reqs]
    bad = [i for i, (g, w) in enumerate(zip(got, want)) if verdict_key(g) != w.key()]
    assert not bad, [(reqs[i].uri, verdict_key(got[i]), want[i].key()) for i in bad[:3]]
    fired = [set(v.matched_ids) & set(range(10000, 10000 + n_patches)) for v in got]
    for k, (r, f) in enumerate(zip(reqs, fired)):
        if k % 5 == 4:
            continue
        # Allowed or absent parameter: no patch fires; rejected: its patch does.
        assert bool(f) == (k % 4 in (1, 2)), (r.method, r.uri, r.body, f)


def test_lite_plus_300_patches_equal_reference(lite300):
    engine, reference = lite300
    reqs = requests(300, 400, seed=1)
    got = evaluate(engine, reqs, window=400)
    assert_equal_reference(engine, reference, reqs, got, 300)
    assert sum(v.interrupted for v in got) >= 150
    # One block per pipeline, as crs-lite-pl2: 306 path-gate columns saved on
    # 23 other kinds' rows (7,038) weigh less than a row that scans the model.
    assert engine.model.narrow_blocks == () and engine._narrow == 0
    # The value cache serves the repeated windows; no verdict changes.
    again = evaluate(engine, reqs[:32])
    assert [verdict_key(v) for v in again] == [verdict_key(v) for v in got[:32]]


def test_slice_with_narrow_block_equals_reference():
    text = slice_text()
    engine, reference = TEngine(text, device="cpu"), Reference(text)
    assert engine.model.narrow_blocks
    # A 96-request window, then smaller ones: partitions kept apart at every
    # size, the narrow one bucketed at the largest window seen.
    reqs = requests(200, 192, seed=4)
    got = evaluate(engine, reqs[:96], window=96) + evaluate(engine, reqs[96:], window=48)
    assert engine._peak_requests == 96
    assert_equal_reference(engine, reference, reqs, got, 200)
    assert any(v.interrupted for v in got) and not all(v.interrupted for v in got)


def test_slice_equals_jax_engine():
    from coraza_kubernetes_operator_tpu.engine import HttpRequest as JRequest
    from coraza_kubernetes_operator_tpu.engine import WafEngine as JEngine

    text = slice_text()
    reqs = requests(200, 64, seed=2)
    engine = TEngine(text, device="cpu")
    assert engine.model.narrow_blocks
    got = engine.evaluate([torch_request(r) for r in reqs])
    want = JEngine(text).evaluate(
        [JRequest(method=r.method, uri=r.uri, headers=list(r.headers), body=r.body) for r in reqs])
    assert [verdict_key(v) for v in got] == [verdict_key(v) for v in want]
    assert any(v.interrupted for v in got) and not all(v.interrupted for v in got)


def test_narrow_block_meets_only_path_rows():
    text = slice_text()
    engine = TEngine(text, device="cpu")
    model = engine.model
    (nb,) = model.narrow_blocks
    assert conv_n2_cols(model.segs[nb].spec) == 200
    filename = engine.compiled.vocab.lookup("REQUEST_FILENAME", None)
    assert model.block_kinds[nb] == (filename,)
    reqs = [torch_request(r) for r in requests(200, 32, seed=3)]
    for path, floor in (("native", 32), ("python", 32), ("native", 128), ("python", 128)):
        if floor == 128:
            engine._narrow_rows(96)  # a 96-request window was seen
        if path == "native":
            if not engine.native_enabled:
                continue
            tiers, _nv, masks, *_rest = engine._batch_tensors(reqs)
        else:
            tiers, _nv, masks = engine.tier(engine._tensorize(
                [engine.extractor.extract(r) for r in reqs]))
        met = 0
        for t, m in zip(tiers, masks):
            real = t[5] < len(reqs)
            kinds = np.stack([t[2][real], t[3][real], t[4][real]], axis=1)
            if m is None or (m >> nb) & 1:
                # Every row that meets the path gates is a path row, and the
                # partition's rows bucket at one per request of the largest
                # window seen: one shape for every window up to it.
                assert (kinds == filename).any(axis=1).all(), path
                assert t[0].shape[0] >= floor and t[5].shape[0] >= floor, path
                met += int(real.sum())
            else:
                assert not (kinds == filename).any(), path
        assert 0 < met <= len(reqs), path
    # The window's column work: the other rows meet every block but the narrow one.
    rows, col_rows = engine._seg_work(tiers, masks, len(reqs))
    wide = sum(conv_n2_cols(s.spec) for i, s in enumerate(model.segs) if i != nb)
    assert rows > 32 and wide * rows < col_rows < (wide + 200) * rows


def test_crs_lite_layout_has_no_narrow_block():
    engine = TEngine(ruleset_text({"rules": {"dir": "crs-lite-pl2", "data": "data",
                                             "files": vpatch_files()}}), device="cpu")
    model = engine.model
    assert model.seg_pipelines == tuple(sorted(set(model.seg_pipelines)))
    assert model.narrow_blocks == () and engine._narrow == 0
