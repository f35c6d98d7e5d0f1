"""PyTorch port: the ``gpu-engine`` entry point parses the JAX package's
``tpu-engine`` flag set to an equal ``SidecarConfig`` (the port's config
adds ``device``, None: the card), and wires ``--compile-cache-dir`` to
the port's build directories."""

from __future__ import annotations

import dataclasses
import subprocess
import sys
from pathlib import Path

import pytest

from coraza_kubernetes_operator_tpu.cmd import tpu_engine
from coraza_kubernetes_operator_tpu.engine import compile_cache as jcompile_cache
from coraza_kubernetes_operator_tpu_torch import native
from coraza_kubernetes_operator_tpu_torch.cmd import gpu_engine
from coraza_kubernetes_operator_tpu_torch.engine import compile_cache
from coraza_kubernetes_operator_tpu_torch.ops import kernels

ROOT = Path(__file__).resolve().parents[1]

FLAG_SETS = {
    "defaults": ["--cache-server-instance", "ns/rs"],
    "everything": [
        "--cache-server-instance", "ns/a,ns/b", "--cache-server-cluster", "cache.svc:19090",
        "--rule-reload-interval-seconds", "2.5", "--failure-policy", "allow",
        "--max-batch-size", "512", "--max-batch-delay-ms", "3", "--pipeline-depth", "1",
        "--request-timeout-seconds", "7", "--window-deadline-seconds", "0",
        "--compile-timeout-seconds", "90", "--bind-address", "127.0.0.1", "--port", "8081",
        "--frontend", "threaded", "--extproc-impl", "native", "--audit-log", "-",
        "--audit-all", "--disable-host-fallback", "--queue-budget", "-1",
        "--breaker-threshold", "5", "--breaker-cooldown-seconds", "4",
        "--drain-timeout-seconds", "1", "--state-dir", "/var/lib/cko",
        "--drain-budget-seconds", "3", "--max-connections", "10", "--header-timeout-seconds", "2",
        "--idle-timeout-seconds", "9", "--body-timeout-seconds", "8", "--max-body-bytes", "1024",
        "--ingress-memory-budget-bytes", "4096", "--disable-rollout",
        "--compile-budget-seconds", "30", "--shadow-promote-windows", "2",
        "--shadow-sample-rate", "0.5", "--trace-sample-rate", "0.25", "--trace-ring", "64",
        "--audit-max-bytes", "100", "--slo-p99-ms", "20", "--tenant-weights", "a=3,b=1",
        "--lane-delay-ms", "0.5", "--disable-adaptive",
    ],
    "extproc_port": ["--cache-server-instance", "ns/rs", "--extproc-port", "0"],
}


@pytest.fixture
def no_cache_dir(monkeypatch):
    """Neither package's build or compile cache directory moves."""
    monkeypatch.setattr(kernels, "BUILD_DIR", kernels.BUILD_DIR)
    monkeypatch.setattr(native, "BUILD_DIR", native.BUILD_DIR)
    monkeypatch.setattr(compile_cache, "_configured_dir", [])
    monkeypatch.setattr(jcompile_cache, "configure_persistent_cache", lambda d=None: None)
    monkeypatch.delenv("CKO_COMPILE_CACHE_DIR", raising=False)


@pytest.mark.parametrize("flags", list(FLAG_SETS), ids=list(FLAG_SETS))
def test_reference_flags_give_an_equal_config(flags, no_cache_dir):
    want = dataclasses.asdict(tpu_engine.build_config(FLAG_SETS[flags]))
    got = dataclasses.asdict(gpu_engine.build_config(FLAG_SETS[flags]))
    assert got.pop("device") is None
    assert got == want


def test_prog_name(no_cache_dir, capsys):
    with pytest.raises(SystemExit):
        gpu_engine.build_config(["--help"])
    assert capsys.readouterr().out.startswith("usage: gpu-engine")


def test_compile_cache_dir_points_the_builds(tmp_path, no_cache_dir):
    d = tmp_path / "builds"
    gpu_engine.build_config(["--cache-server-instance", "ns/rs", "--compile-cache-dir", str(d)])
    assert kernels.BUILD_DIR == d / "torch_kernels" and native.BUILD_DIR == d / "native"
    assert compile_cache.EXEC_CACHE.stats()["persistent_dir"] == str(d)


def test_module_runs_as_a_program():
    out = subprocess.run(
        [sys.executable, "-m", "coraza_kubernetes_operator_tpu_torch.cmd.gpu_engine", "--help"],
        cwd=ROOT, capture_output=True, text=True, timeout=120, check=True,
    ).stdout
    assert out.startswith("usage: gpu-engine") and "--compile-cache-dir" in out
