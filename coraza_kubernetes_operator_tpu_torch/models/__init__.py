"""Compiled matcher model: ``WafModel`` and its evaluation stages."""

from .waf_model import WafModel, build_model  # noqa: F401
