"""Shared utilities: structured logging, time, identifiers."""

from .logging import get_logger, Logger  # noqa: F401
