"""Static analysis over rulesets and over this package itself (port of
the JAX package's ``analysis/``).

Three prongs:

- ``rulelint``: semantic analysis of a Seclang document against the
  compiled IR (AST + ``CompileReport`` + NFA/DFA tables) — ReDoS risk on
  host-path regexes, shadowed/unreachable rules, dead chain tails,
  unpopulated variables, duplicate ids, and the device-coverage report
  that turns the compiler's skip log into one enforced number.
- ``torchlint``: an AST linter over our own source flagging torch
  hot-path hazards (host syncs on the no-sync dispatch path,
  whole-package lock-order inversions, GIL-release buffer safety,
  ArenaLease lifetimes); the port of ``jaxlint``.
- ``nativelint``: the Python↔C++ boundary contracts — the ctypes ``_ABI``
  specs in ``native/__init__.py`` and ``ops/kernels.py`` cross-checked
  against the ``extern "C"`` definitions in ``native/src/cko_native.cpp``
  and ``csrc/*.cu`` (arity, type widths, restype, buffer-vs-c_char_p,
  orphan symbols, negative-rc conventions).

``cmd/analyze.py`` runs all three; rulelint also runs at RuleSet
admission (the ``Analyzed`` condition) and at sidecar hot reload (new
error-severity findings refuse the swap unless ``CKO_ANALYZE_OVERRIDE=1``).
"""

from .findings import (  # noqa: F401
    SEV_ERROR,
    SEV_INFO,
    SEV_WARN,
    AnalysisReport,
    Finding,
)
from .nativelint import (  # noqa: F401
    lint_boundary,
    lint_kernels,
    lint_native,
    lint_sources,
)
from .rulelint import (  # noqa: F401
    analyze_compiled,
    analyze_document,
    analyze_ruleset,
)
