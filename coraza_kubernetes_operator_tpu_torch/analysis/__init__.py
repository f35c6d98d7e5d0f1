"""Static analysis over rulesets (port of the JAX package's ``analysis/``).

- ``rulelint``: semantic analysis of a Seclang document against the
  compiled IR (AST + ``CompileReport`` + NFA/DFA tables) — ReDoS risk on
  host-path regexes, shadowed/unreachable rules, dead chain tails,
  unpopulated variables, duplicate ids, and the device-coverage report.
  The sidecar runs it at hot reload: new error-severity findings refuse
  the swap unless ``CKO_ANALYZE_OVERRIDE=1``.
- ``redos`` and ``findings``: its regex risk check and report types.

The JAX package's source linters (``jaxlint``, ``nativelint``) are not
ported yet.
"""

from .findings import (  # noqa: F401
    SEV_ERROR,
    SEV_INFO,
    SEV_WARN,
    AnalysisReport,
    Finding,
)
from .rulelint import (  # noqa: F401
    analyze_compiled,
    analyze_document,
    analyze_ruleset,
)
