"""PyTorch port parity: sharded evaluation over a ('data', 'rule') mesh.

The port's ``ShardedWafEngine`` runs one process per rank; here each rank
is its own interpreter on the CPU, joined over gloo through a fresh
localhost port, and every rank returns all the verdicts. With the rules
and requests of ``tests/test_parallel.py`` (all segment groups), and with
five DFA-bank rules added (so the rule axis splits banks and the hit bits
are all-gathered), meshes (2, 1), (1, 2) and (2, 2) give the verdicts of
the JAX ``WafEngine`` and of the port's ``WafEngine``, as does the long-body fallback at (2, 1) with a tiny
``CKO_SEG_CHUNK_ELEMENTS`` in the ranks. Every rank runs under a hard
deadline (collectives time out after 30 s, the ranks are killed at 120 s)
so a hung collective fails the test instead of the suite. Each rank's
sharded model is also held to the reference's stacked model, leaf by
leaf, in this process.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import numpy as np
import pytest

from coraza_kubernetes_operator_tpu_torch.compiler.ruleset import compile_rules as tcompile
from coraza_kubernetes_operator_tpu_torch.engine import HttpRequest, WafEngine
from coraza_kubernetes_operator_tpu_torch.parallel import build_sharded_model, make_mesh

REPO = Path(__file__).resolve().parent.parent
DEADLINE_S = 120

RULES = r"""
SecRuleEngine On
SecRequestBodyAccess On
SecDefaultAction "phase:2,log,auditlog,deny,status:403"
SecRule ARGS "@rx (?i:(\b(select|union|insert|update|delete|drop)\b.*\b(from|into|where|table)\b))" \
  "id:942100,phase:2,deny,status:403,t:none,t:urlDecodeUni,msg:'SQLi'"
SecRule ARGS "@rx (?i:<script[^>]*>)" \
  "id:941100,phase:2,deny,status:403,t:none,t:urlDecodeUni,t:htmlEntityDecode,msg:'XSS'"
SecRule ARGS|REQUEST_URI|REQUEST_HEADERS "@contains evilmonkey" \
  "id:3001,phase:2,deny,status:403,t:none,t:urlDecodeUni,msg:'Monkey'"
SecRule ARGS "@pm sleep benchmark waitfor" "id:44,phase:2,deny,status:403,t:none,t:lowercase"
SecRule REQUEST_URI "@beginsWith /blocked" "id:45,phase:1,deny,status:403,t:none"
"""

# (method, uri, headers, body) of tests/test_parallel.py's ten requests.
REQUESTS = [
    ("GET", "/ok?q=hello", [], b""),
    ("GET", "/?q=union+select+a+from+b", [], b""),
    ("GET", "/?x=%3Cscript%3E", [], b""),
    ("GET", "/", [("UA", "evilmonkey")], b""),
    ("GET", "/?q=SLEEP(9)", [], b""),
    ("GET", "/blocked/path", [], b""),
    ("GET", "/fine/path?a=1&b=2", [], b""),
    ("POST", "/api", [("Content-Type", "application/json")],
     b'{"q": "drop table x; select 1 from t"}'),
    ("GET", "/also-ok", [], b""),
    ("GET", "/?deep=%26lt%3Bscript%26gt%3B", [], b""),
]

# Groups the segment planner rejects, so they ride DFA bank buckets and
# the rule axis splits them (every group of RULES is a segment group):
# four buckets over three pipelines, one bank without a dense table.
DFA_RULES = RULES + r"""
SecRule ARGS "@rx (e|fg)+h" "id:2001,phase:2,deny,status:403,t:none"
SecRule ARGS "@rx (a|bc)*a(a|bc){7}d" "id:2002,phase:2,deny,status:403,t:none"
SecRule ARGS|REQUEST_HEADERS "@rx ^(?:x|yz)+w$" "id:2003,phase:2,deny,status:403,t:none,t:lowercase"
SecRule REQUEST_URI "@rx (ab|ba)+c(d|e)*f" "id:2004,phase:1,deny,status:403,t:none,t:urlDecodeUni"
SecRule ARGS "@rx k(l|mn){2,5}o" "id:2005,phase:2,deny,status:403,t:none"
"""
DFA_REQUESTS = REQUESTS + [
    ("GET", "/?q=fgfgeh", [], b""),
    ("GET", "/?q=aaaaaaaad", [], b""),
    ("GET", "/?q=bcbcbcbcd", [], b""),
    ("GET", "/", [("X-Test", "XYZW")], b""),
    ("GET", "/abbacddf", [], b""),
    ("GET", "/?q=klmnlo", [], b""),
    ("GET", "/?q=kmno", [], b""),
]
CASES = [(RULES, REQUESTS), (DFA_RULES, DFA_REQUESTS)]

LONG_RULES = (
    "SecRuleEngine On\nSecRequestBodyAccess On\n"
    'SecRule ARGS "@rx (?i:\\bunion\\s+select\\b)" "id:1,phase:2,deny,status:403,t:none,t:urlDecodeUni"\n'
    'SecRule ARGS "@contains evilmonkey" "id:2,phase:2,deny,status:403,t:none"\n'
)
_FILLER = "z" * 400
LONG_REQUESTS = [
    ("GET", f"/?q={_FILLER}+union+select+a+from+b", [], b""),
    ("GET", f"/?q={_FILLER}+benign", [], b""),
    ("GET", f"/?q={_FILLER}+evilmonkey", [], b""),
    ("GET", "/short", [], b""),
]

# One rank: join the gloo group, build the mesh, then per case a sharded
# engine; print every case's verdicts as one JSON line.
RANK = textwrap.dedent(
    """
    import datetime, json, os, sys
    import torch.distributed as dist
    spec = json.loads(sys.argv[1])
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{spec['port']}",
                            rank=spec["rank"], world_size=spec["world"],
                            timeout=datetime.timedelta(seconds=30))
    from coraza_kubernetes_operator_tpu_torch.compiler.ruleset import compile_rules
    from coraza_kubernetes_operator_tpu_torch.engine import HttpRequest
    from coraza_kubernetes_operator_tpu_torch.parallel import ShardedWafEngine, make_mesh
    try:
        if spec.get("mesh_errors"):
            out = []
            for n_data, n_rule, kind in ((2, 1, "cpu"), (1, 1, "cuda")):
                try:
                    make_mesh(n_data, n_rule, kind)
                    out.append(None)
                except (ValueError, RuntimeError) as err:
                    out.append([type(err).__name__, str(err)])
        else:
            mesh = make_mesh(spec["n_data"], spec["n_rule"], "cpu")
            out = []
            for rules, wire in spec["cases"]:
                engine = ShardedWafEngine(compiled=compile_rules(rules), mesh=mesh)
                reqs = [HttpRequest(method=m, uri=u, headers=[tuple(h) for h in hs],
                                    body=bytes.fromhex(b)) for m, u, hs, b in wire]
                out.append([[v.interrupted, v.status, v.rule_id] for v in engine.evaluate(reqs)])
    finally:
        dist.destroy_process_group()
    print(json.dumps(out), flush=True)
    # Skip the interpreter's teardown, where now and then a native thread
    # still running ends the process with std::terminate (SIGABRT) after
    # the result is out and the group destroyed.
    os._exit(0)
    """
)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_ranks(world: int, env_extra: dict | None = None, **spec) -> list:
    """Start ``world`` ranks, each given ``spec``; returns each rank's
    printed result. Every rank is killed at the deadline."""
    env = {**os.environ, "PYTHONPATH": str(REPO), **(env_extra or {})}
    port = _free_port()
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", RANK,
             json.dumps({**spec, "rank": r, "world": world, "port": port})],
            cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for r in range(world)
    ]
    deadline = time.monotonic() + DEADLINE_S
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
            assert p.returncode == 0, err[-3000:]
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


def _wire(cases):
    return [[rules, [[m, u, [list(h) for h in hs], b.hex()] for m, u, hs, b in reqs]]
            for rules, reqs in cases]


def _expected(rules, reqs):
    """(JAX WafEngine verdicts, the port's CPU WafEngine verdicts)."""
    from coraza_kubernetes_operator_tpu.engine import HttpRequest as JRequest
    from coraza_kubernetes_operator_tpu.engine import WafEngine as JEngine

    jax_v = JEngine(rules).evaluate(
        [JRequest(method=m, uri=u, headers=list(hs), body=b) for m, u, hs, b in reqs])
    port_v = WafEngine(rules, device="cpu").evaluate(
        [HttpRequest(method=m, uri=u, headers=list(hs), body=b) for m, u, hs, b in reqs])
    return ([[v.interrupted, v.status, v.rule_id] for v in jax_v],
            [[v.interrupted, v.status, v.rule_id] for v in port_v])


@pytest.fixture(scope="module")
def expected():
    out = [_expected(rules, reqs) for rules, reqs in CASES]
    for jax_v, port_v in out:
        assert jax_v == port_v
    assert [sum(v[0] for v in jax_v) for jax_v, _ in out] == [7, 12]
    return [jax_v for jax_v, _ in out]


@pytest.mark.parametrize("shape", [(2, 1), (1, 2), (2, 2)], ids=["2x1", "1x2", "2x2"])
def test_sharded_matches_single(shape, expected):
    n_data, n_rule = shape
    outs = _run_ranks(n_data * n_rule, cases=_wire(CASES), n_data=n_data, n_rule=n_rule)
    for rank, got in enumerate(outs):
        assert got == expected, (shape, rank)


def test_sharded_long_body_fallback():
    """The rule-sharded path takes the same constant-memory DFA fallback
    for long shape buckets as the single-device path: with a segment
    chunk budget of one element in the ranks (read at import, so set in
    their environment), the conv tier cannot run and the long banks
    answer."""
    jax_v, port_v = _expected(LONG_RULES, LONG_REQUESTS)
    assert jax_v == port_v and [v[0] for v in jax_v] == [True, False, True, False]
    outs = _run_ranks(2, env_extra={"CKO_SEG_CHUNK_ELEMENTS": "1"},
                      cases=_wire([(LONG_RULES, LONG_REQUESTS)]), n_data=2, n_rule=1)
    assert outs == [[jax_v], [jax_v]]


def test_mesh_device_requirements():
    with pytest.raises(ValueError):  # no process group in this process
        make_mesh(1000, 1000, "cpu")
    (errors,) = _run_ranks(1, mesh_errors=True)
    assert errors[0] == ["ValueError", "need 2 ranks, have 1"]
    # A cuda mesh without a card raises; it does not fall back to gloo.
    assert errors[1][0] == "RuntimeError" and "CUDA device" in errors[1][1]


@pytest.mark.parametrize("n_rule", [1, 2, 3])
def test_sharded_model_equals_the_reference_stack(n_rule):
    """Each rule shard built alone equals its slice of the reference's
    stacked model: bucket widths and pipelines, the gathered ``lgroup`` /
    ``e_lg``, and each bank's tables (the reference pads classes to the
    widest shard's count)."""
    from coraza_kubernetes_operator_tpu.compiler.ruleset import compile_rules as jcompile
    from coraza_kubernetes_operator_tpu.parallel import build_sharded_model as jbuild

    ref = jbuild(jcompile(DFA_RULES), n_rule)
    crs = tcompile(DFA_RULES)
    for shard in range(n_rule):
        got = build_sharded_model(crs, n_rule, shard=shard, device="cpu")
        assert got.bucket_widths == ref.bucket_widths
        assert got.bank_pipelines == ref.bank_pipelines
        assert got.seg_pipelines == ref.seg_pipelines
        assert len(got.segs) == len(ref.segs)
        np.testing.assert_array_equal(got.post.lgroup.numpy(), np.asarray(ref.post.lgroup))
        np.testing.assert_array_equal(got.post.e_lg.numpy(), np.asarray(ref.post.e_lg))
        assert len(got.banks) == len(ref.banks) > 0
        for mine, theirs in zip(got.banks, ref.banks):
            packed = np.asarray(theirs.packed)[shard]
            c = mine.packed.shape[2]
            np.testing.assert_array_equal(mine.packed.numpy(), packed[:, :, :c])
            assert not packed[:, :, c:].any()
            for leaf in ("classmap", "match_end", "always"):
                np.testing.assert_array_equal(
                    getattr(mine, leaf).numpy(), np.asarray(getattr(theirs, leaf))[shard])


@pytest.mark.parametrize("rules", [RULES, DFA_RULES], ids=["segments", "dfa-banks"])
def test_build_model_without_dfa_banks_keeps_routing_and_post(rules):
    """``build_model(dfa_banks=False)`` routes every group as
    ``build_model`` does and lays out the same segment blocks, long banks
    and post arrays; it only leaves out the DFA bucket banks and the flat
    bins over them."""
    import torch

    from coraza_kubernetes_operator_tpu_torch.models.waf_model import build_model

    crs = tcompile(rules)
    full = build_model(crs, device="cpu")
    lean = build_model(crs, device="cpu", dfa_banks=False)
    assert lean.banks == [] and lean.flat_banks == [] and lean.bank_pipelines == ()
    assert lean.group_order == full.group_order
    assert lean.seg_pipelines == full.seg_pipelines
    assert len(lean.segs) == len(full.segs)
    assert lean.long_bank_pipelines == full.long_bank_pipelines
    for a, b in zip(lean.long_banks, full.long_banks):
        assert torch.equal(a.packed, b.packed)
    for name in ("ltype", "lneg", "lgroup", "inc", "exc", "e_lg", "m_count", "removal",
                 "link_matrix", "decision", "status", "order_key", "phase", "weights"):
        assert torch.equal(getattr(lean, name), getattr(full, name)), name


def test_rank_builds_only_its_rule_shard(monkeypatch):
    """A rank stacks the DFAs of its own slice of each bucket and the
    replicated long banks, and nothing else: no full bucket bank, no flat
    bin, and no single-device engine beside the sharded one."""
    from coraza_kubernetes_operator_tpu_torch.models import waf_model
    from coraza_kubernetes_operator_tpu_torch.parallel import ShardedWafEngine, mesh

    stacked = {"model": 0, "mesh": 0}

    def counting(where, real):
        def stack(dfas, *a, **k):
            stacked[where] += len(dfas)
            return real(dfas, *a, **k)
        return stack

    monkeypatch.setattr(waf_model, "stack_dfas", counting("model", waf_model.stack_dfas))
    monkeypatch.setattr(mesh, "stack_dfas", counting("mesh", mesh.stack_dfas))
    monkeypatch.setattr(waf_model, "build_flat_bank", lambda *a, **k: pytest.fail("flat bin built"))

    class Mesh:  # rule shard 1 of 2, data shard 0 of 1
        device_type, shape = "cpu", (1, 2)

        def get_local_rank(self, dim):
            return {"data": 0, "rule": 1}[dim]

    crs = tcompile(DFA_RULES)
    engine = ShardedWafEngine(compiled=crs, mesh=Mesh())
    n_long = sum(b.n_groups for b in engine.model.post.long_banks)
    assert stacked == {"model": n_long, "mesh": sum(engine.model.bucket_widths)}
    assert sum(engine.model.bucket_widths) < len(crs.groups) - n_long
    assert not any(isinstance(v, WafEngine) for v in vars(engine).values())
