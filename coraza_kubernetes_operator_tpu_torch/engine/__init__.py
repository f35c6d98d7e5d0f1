"""Batch WAF engine: request tensorization, tiering and evaluation on the card."""

from .request import HttpRequest  # noqa: F401
from .waf import InFlightBatch, Verdict, WafEngine  # noqa: F401
