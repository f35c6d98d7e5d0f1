"""Seclang (ModSecurity rule language) front end.

Parses the directive subset exercised by the reference corpus (reference
``config/samples/ruleset.yaml``, ``hack/generate_coreruleset_configmaps.py``,
``test/integration/coreruleset_test.go``) into a typed AST. This fills the
validate-on-reconcile role that the reference delegates to
``coraza.NewWAF(conf.WithDirectives(...))``
(``internal/controller/ruleset_controller.go:158-171``) — and additionally
feeds the TPU rule compiler.
"""

from .ast import (  # noqa: F401
    Action,
    Marker,
    Operator,
    Rule,
    RuleSetProgram,
    SeclangParseError,
    Variable,
)
from .parser import parse  # noqa: F401
