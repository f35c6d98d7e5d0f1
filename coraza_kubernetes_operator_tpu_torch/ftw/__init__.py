"""go-ftw-compatible conformance tier (port of the JAX package's ``ftw``).

A loader for go-ftw's YAML test format (both the legacy
``test_title``/``stage`` nesting and the newer ``rule_id``/``test_id`` +
``log.expect_ids`` shape), read from the JSON mirror of the repo's
corpora where ``pyyaml`` is absent (``ftw/mirror.py``); a replayer that
drives either an in-process ``WafEngine`` or a live gpu-engine sidecar
over HTTP, with the ``ftw/ftw.yml`` ignore-ledger semantics; and the
crs-lite ruleset loader. ``python -m coraza_kubernetes_operator_tpu_torch.ftw``
is the command line (the repo's ``ftw/run.py`` for this package).
"""

from .corpus import CRS_LITE_DIR, load_ruleset_text  # noqa: F401
from .loader import (
    FtwStage,
    FtwTest,
    load_overrides,
    load_test_file,
    load_tests,
    load_tests_report,
)
from .runner import FtwResult, FtwRunner, run_corpus

__all__ = [
    "FtwStage",
    "FtwTest",
    "FtwResult",
    "FtwRunner",
    "load_overrides",
    "load_test_file",
    "load_tests",
    "load_tests_report",
    "run_corpus",
]
