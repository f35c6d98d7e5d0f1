"""The PyTorch port stands alone and runs on the card unless asked not to.

- Importing every module of ``coraza_kubernetes_operator_tpu_torch``
  loads neither ``jax`` nor the JAX package (checked in a fresh
  interpreter, since this test process has both loaded); the conformance,
  sharding and analysis paths, which the card's machine runs without
  ``pyyaml``, load no ``yaml`` either.
- Entry points default to ``cuda`` and raise where there is none; the
  CPU is used only when the caller passes ``device="cpu"``.
- A CPU tensor never reaches the CUDA build: the whole window runs with
  ``kernels.build`` replaced by a function that fails.
"""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from coraza_kubernetes_operator_tpu_torch import corpus
from coraza_kubernetes_operator_tpu_torch.compiler.re_dfa import compile_regex_dfa
from coraza_kubernetes_operator_tpu_torch.compiler.ruleset import compile_rules
from coraza_kubernetes_operator_tpu_torch.engine import WafEngine
from coraza_kubernetes_operator_tpu_torch.models.waf_model import build_model
from coraza_kubernetes_operator_tpu_torch.ops import dfa, dfa_flat, dfa_gather, kernels
from torch_rules import SMALL_RULES

ROOT = Path(__file__).resolve().parents[1]


def test_port_imports_no_jax():
    code = textwrap.dedent(
        """
        import importlib, pkgutil, sys
        import coraza_kubernetes_operator_tpu_torch as pkg
        names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
        for name in names:
            importlib.import_module(name)
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith(("jax.", "jaxlib"))
                     or m == "coraza_kubernetes_operator_tpu"
                     or m.startswith("coraza_kubernetes_operator_tpu."))
        print(len(names), bad)
        """
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=300, check=True,
    ).stdout.split()
    assert int(out[0]) >= 30, out
    assert out[1:] == ["[]"], out


def test_ftw_parallel_and_analysis_paths_need_no_yaml():
    """What chip_smoke.py's conformance and sharding phases and
    ``cmd.analyze`` run, with ``yaml`` unimportable: the mirrored corpora
    and ledger load, the CLI lints, and no jax, JAX package or yaml module
    is loaded."""
    code = textwrap.dedent(
        """
        import contextlib, io, sys
        sys.modules["yaml"] = None  # import yaml -> ImportError
        from coraza_kubernetes_operator_tpu_torch import ftw, parallel  # noqa: F401
        from coraza_kubernetes_operator_tpu_torch.cmd import analyze
        from coraza_kubernetes_operator_tpu_torch.ftw.loader import FTW_DIR
        n = len(ftw.load_tests(FTW_DIR / "tests-crs-lite")) + len(ftw.load_tests(FTW_DIR / "tests"))
        assert ftw.load_overrides(FTW_DIR / "ftw.yml")
        with contextlib.redirect_stdout(io.StringIO()):
            rc = analyze.main(["--torchlint", "--native", "--json"])
        bad = sorted(m for m, mod in sys.modules.items() if mod is not None and (
                     m in ("jax", "yaml") or m.startswith(("jax.", "jaxlib", "yaml."))
                     or m == "coraza_kubernetes_operator_tpu"
                     or m.startswith("coraza_kubernetes_operator_tpu.")))
        print(n, rc, bad)
        """
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=300, check=True,
    ).stdout.split()
    assert out == ["344", "0", "[]"], out


def test_chip_smoke_imports_no_jax():
    src = (ROOT / "chip_smoke.py").read_text()
    assert "jax" not in src.replace("coraza_kubernetes_operator_tpu/", "")
    assert "import coraza_kubernetes_operator_tpu\n" not in src
    assert "from coraza_kubernetes_operator_tpu." not in src


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rules = corpus.sample_rules()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        WafEngine(rules)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(compile_rules(rules))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dfa.stack_dfas([compile_regex_dfa("abc")])
    eng = WafEngine(rules, device="cpu")
    assert eng.device == torch.device("cpu")
    assert eng.model.device == torch.device("cpu")


def test_cpu_tensors_never_reach_the_cuda_build(monkeypatch):
    def refuse(*_a, **_k):
        raise AssertionError("a CPU tensor reached the CUDA kernel build")

    monkeypatch.setattr(kernels, "build", refuse)
    monkeypatch.setattr(kernels, "function", refuse)
    before = (dfa.LAUNCHES, dfa_gather.LAUNCHES, dfa_flat.LAUNCHES)
    eng = WafEngine(SMALL_RULES, device="cpu")
    m = eng.model
    assert m.flat_banks and m.gather_banks and m.pre_banks
    verdicts = eng.evaluate(corpus.synthetic_requests(24, attack_ratio=0.5, seed=3))
    assert any(v.interrupted for v in verdicts)
    assert (dfa.LAUNCHES, dfa_gather.LAUNCHES, dfa_flat.LAUNCHES) == before


def test_scans_refuse_other_devices():
    bank = dfa.stack_dfas([compile_regex_dfa("abc")], device="cpu")
    data = torch.zeros((4, 8), dtype=torch.uint8, device="meta")
    lens = torch.zeros(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        dfa.scan_dfa_bank(bank, data, lens)


def test_kernel_sources_are_found():
    names = [p.name for p in kernels.sources()]
    assert names == ["dfa_scan.cu", "segment_finals.cu"]
    src = (kernels.CSRC / "dfa_scan.cu").read_text()
    for launcher in ("cko_scan_dense", "cko_scan_gather", "cko_scan_flat"):
        assert f"int {launcher}(" in src
    assert "int cko_finals_match(" in (kernels.CSRC / "segment_finals.cu").read_text()
    assert "arch=compute_90a,code=sm_90a" in kernels.NVCC_FLAGS
