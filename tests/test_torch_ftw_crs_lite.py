"""PyTorch port parity on the crs-lite conformance corpus, against the JAX
package run on the same tests.

On this tree the JAX package fails 11 of the corpus's 326 tests, where
``tests/test_ftw_crs_lite.py`` commits 325 passed (only its slow tier
replays them all). ``chip_smoke.py`` phase 7 holds the card to that list
(``CRS_LITE_FAILED``, kept there because the card's machine has no JAX).
Here the JAX ``FtwRunner`` over its own ``WafEngine(crs-lite)`` replays
those 11 tests and the passing tests that follow them in title order,
and its passed, failed and ignored sets must equal the list and the
port's. The JAX side runs in a child process, as the reference's corpus
replay does (``hack/run_ftw_chunk.py``: XLA:CPU's compile arena), and
starts before the port's side so the two overlap: its crs-lite compile
is most of this file's time (two to three minutes on 8 CPU cores).
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from coraza_kubernetes_operator_tpu_torch import ftw as tftw

REPO = Path(__file__).resolve().parent.parent
CRS_CORPUS = REPO / "ftw" / "tests-crs-lite"
LEDGER = REPO / "ftw" / "ftw.yml"
# Passing neighbours replayed beside the failures.
N_NEIGHBOURS = 5
CHILD_TIMEOUT_S = 900

JAX_CHILD = textwrap.dedent(
    """
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", False)
    from coraza_kubernetes_operator_tpu.engine.compile_cache import configure_persistent_cache
    configure_persistent_cache(os.environ["CKO_COMPILE_CACHE_DIR"])
    from coraza_kubernetes_operator_tpu.engine.waf import WafEngine
    from coraza_kubernetes_operator_tpu.ftw.corpus import load_ruleset_text
    from coraza_kubernetes_operator_tpu.ftw.loader import load_overrides, load_tests
    from coraza_kubernetes_operator_tpu.ftw.runner import FtwRunner
    corpus, ledger, titles = sys.argv[1], sys.argv[2], set(json.loads(sys.argv[3]))
    tests = [t for t in load_tests(corpus) if t.title in titles]
    result = FtwRunner(engine=WafEngine(load_ruleset_text()),
                       overrides=load_overrides(ledger)).run(tests)
    print(json.dumps({"passed": sorted(result.passed), "failed": result.failed,
                      "ignored": result.ignored}), flush=True)
    """
)


def _card_expectation() -> dict[str, str]:
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke.CRS_LITE_FAILED


def _titles(failed: dict[str, str]) -> list[str]:
    """The failing titles, then the first N_NEIGHBOURS distinct titles that
    follow one of them in title order and are not failing."""
    titles = sorted(t.title for t in tftw.load_tests(CRS_CORPUS))
    after = [titles[titles.index(f) + 1] for f in sorted(failed)]
    neighbours = list(dict.fromkeys(t for t in after if t not in failed))[:N_NEIGHBOURS]
    return sorted(failed) + neighbours


@pytest.fixture(scope="module")
def failed() -> dict[str, str]:
    return _card_expectation()


@pytest.fixture(scope="module")
def jax_replay(failed):
    """The JAX package's replay of ``_titles(failed)``, started at once in
    a child process; the test reads it with ``communicate``."""
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["PYTHONPATH"] = str(REPO)
    env.setdefault("CKO_COMPILE_CACHE_DIR", str(REPO / "tests" / ".jax_cache"))
    proc = subprocess.Popen(
        [sys.executable, "-c", JAX_CHILD, str(CRS_CORPUS), str(LEDGER),
         json.dumps(_titles(failed))],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )
    try:
        yield proc
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


@pytest.fixture(scope="module")
def crs_engine():
    from coraza_kubernetes_operator_tpu_torch.engine import WafEngine

    return WafEngine(tftw.load_ruleset_text(), device="cpu")


def test_crs_lite_reference_failures_on_the_port(jax_replay, crs_engine, failed):
    """The 11 crs-lite tests the JAX package fails fail on the port's CPU
    engine with the same reasons, and their neighbours pass on both: the
    JAX replay, the port's replay and ``chip_smoke.CRS_LITE_FAILED`` agree."""
    titles = _titles(failed)
    assert len(failed) == 11 and len(titles) == 11 + N_NEIGHBOURS
    tests = [t for t in tftw.load_tests(CRS_CORPUS) if t.title in set(titles)]
    port = tftw.FtwRunner(engine=crs_engine, overrides=tftw.load_overrides(LEDGER)).run(tests)

    out, err = jax_replay.communicate(timeout=CHILD_TIMEOUT_S)
    assert jax_replay.returncode == 0, err[-3000:]
    ref = json.loads(out.strip().splitlines()[-1])
    assert ref["failed"] == failed
    assert ref["passed"] == sorted(titles[11:]) and ref["ignored"] == {}
    assert port.failed == ref["failed"]
    assert sorted(port.passed) == ref["passed"] and port.ignored == ref["ignored"]
