"""Each kernel launch runs under its tensors' card.

A ctypes launcher runs on the calling thread's current card, which need
not be the card its tensors are on. The three launch sites of the port
(``ops/dfa.py::launch_tier``, which the dense and gather tiers share,
``ops/dfa_flat.py::launch_flat``, ``ops/segment_finals.py::
launch_finals`` and ``ops/segment_chain.py::launch_chain``) must therefore call every launcher inside
``ops/kernels.py::on_device`` of the tensors' device, and pass the stream
that the guard yields. Here the launchers are replaced by recorders and the
sites run on CPU tensors: the order of guard entries, launcher calls and
guard exits is what is checked, and that every value a site passes has
the type ``ops/kernels.py::_ABI`` gives its launcher. On the card, ``tests/test_torch_cuda.py``
launches each kernel from a thread whose current card was set explicitly.
"""

import contextlib
import ctypes

import pytest
import torch

from coraza_kubernetes_operator_tpu_torch.compiler.re_parser import parse_regex
from coraza_kubernetes_operator_tpu_torch.compiler.segments import plan_segments
from coraza_kubernetes_operator_tpu_torch.ops import (
    dfa, dfa_flat, dfa_gather, kernels, segment, segment_chain, segment_finals,
)
from test_torch_cuda import FLAT_GROUPS, SMALL, _finals_operands, _on, _rows

CPU = torch.device("cpu")
STREAM = 0x5EED


@pytest.fixture
def record(monkeypatch):
    """Replace the guard and the launcher lookup with recorders; returns
    the event list: ("enter", device), ("call", name, stream), ("exit",)."""
    events = []

    @contextlib.contextmanager
    def on_device(device):
        events.append(("enter", device))
        try:
            yield ctypes.c_void_p(STREAM)
        finally:
            events.append(("exit",))

    def function(stem, name):
        def launch(*args):
            # Each value is an instance of its _ABI type, as ctypes takes it.
            want = [kernels._CTYPES[t] for t in kernels._ABI[name]["args"]]
            assert [type(a) for a in args] == want, (name, args)
            events.append(("call", name, args[-1].value))
            return 0
        return launch

    monkeypatch.setattr(kernels, "on_device", on_device)
    monkeypatch.setattr(kernels, "function", function)
    return events


def _guarded(events, name, n):
    """``n`` calls of ``name``, all inside one guard of the CPU device,
    each given the guard's stream."""
    assert events[0] == ("enter", CPU) and events[-1] == ("exit",), events
    assert events[1:-1] == [("call", name, STREAM)] * n, events


@pytest.mark.parametrize("kind", ["dense", "gather"])
def test_tier_launches_under_the_inputs_device(record, kind):
    stack, build, name, extra = {
        "dense": (dfa.stack_dfas, dfa.build_dense_tier, "cko_scan_dense", ()),
        "gather": (dfa_gather.stack_gather_bank, dfa_gather.build_gather_tier, "cko_scan_gather", None),
    }[kind]
    # Ten pipelines: the tier takes two launches, both under one guard.
    tier = build([stack(SMALL[k % 6 : k % 6 + 2], device=CPU) for k in range(10)], list(range(10)))
    if extra is None:
        extra = (kernels.ptr(tier.cmaps),)
    inputs = [tuple(_on(CPU, *_rows(40, 48, seed=k))) for k in range(10)]
    out, n = dfa.launch_tier(tier, inputs, (True,) * 10, name, extra=extra)
    assert n == len(tier.launches) == 2
    assert out.shape == (40, tier.n_groups)
    _guarded(record, name, n)


def test_tier_with_every_bank_off_enters_no_guard(record):
    tier = dfa.build_dense_tier([dfa.stack_dfas(SMALL, device=CPU)], [0])
    out, n = dfa.launch_tier(tier, [tuple(_on(CPU, *_rows(8, 48, seed=0)))], (False,), "cko_scan_dense")
    assert n == 0 and not out.any() and record == []


def test_flat_launches_under_the_inputs_device(record, monkeypatch):
    # 132 SMs, as on the card: the launch shape reads the tensors' card.
    seen = []
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda d: seen.append(d) or type("P", (), {"multi_processor_count": 132}))
    bins, _ = dfa_flat.plan_flat_bins([(i, p, d) for i, (p, d) in enumerate(FLAT_GROUPS)], max_slots=100000)
    flat = dfa_flat.build_flat_bank(bins[0], device=CPU)
    by_pipe = {p: tuple(_on(CPU, *_rows(64, 48, seed=p))) for p in flat.pipeline_ids}
    out = dfa_flat.launch_flat(flat, by_pipe)
    assert out.shape == (64, flat.n_groups) and seen == [CPU]
    _guarded(record, "cko_scan_flat", len(flat.layout.launches))


def test_finals_launches_under_the_inputs_device(record):
    embed, suffix, lens, tables, q = _finals_operands(CPU, 9, 12, 5, 3, 40, 5, seed=1, suffix_density=0.3)
    out = segment_finals.launch_finals(embed, suffix, lens, tables, q)
    assert out.shape == (9, tables.nf)
    _guarded(record, "cko_finals_match", 1)


@pytest.mark.parametrize("tier", [False, True], ids=["finals-off", "finals-on"])
def test_chain_launches_under_the_inputs_device(record, tier):
    # One chain launch, the finals columns included.
    blk = segment.build_segment_block(
        [plan_segments(parse_regex(p)) for p in (r"select\b.+\bfrom", r"a{2,4}b", r"^go.*stop$")],
        device=CPU,
    )
    data, lens = _rows(12, 200, seed=2)  # Q = 202: the bitmaps in the tile's state area
    out, d, l, tables, off, tier_on = segment.chain_inputs(
        blk.kernel, blk.spec, torch.as_tensor(data), torch.as_tensor(lens), finals_tier=tier)
    bh, sfx, n = segment_chain.launch_chain(out, d, l, tables, off, tier_on)
    assert tier_on == tier and tables.nf > 0
    assert n == 1
    assert bh.shape == (12, tables.n_bucket_cols + (0 if tier else tables.nf))
    assert (sfx is not None) == tier
    _guarded(record, "cko_chain_match", 1)
