"""Rule compiler: lowers Seclang rules to TPU device tables.

Pipeline: Seclang AST → per-operator regex AST (``re_parser``) → assertion-
conditioned position NFA (``re_nfa``) → byte-class-compressed DFA tables
(``re_dfa``) → stacked ``CompiledRuleSet`` pytree (``ruleset``) consumed by
the batch engine. The reference delegates all of this to the external Coraza
Seclang engine (``go.mod:6``, used in ``ruleset_controller.go:158-171``);
here it is first-party and TPU-shaped.
"""

from .re_parser import RegexParseError, parse_regex  # noqa: F401
from .re_dfa import DFA, DFAError, compile_regex_dfa, literal_dfa, pm_dfa  # noqa: F401
