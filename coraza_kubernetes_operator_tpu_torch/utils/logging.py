"""Structured logging helpers.

The reference operator logs through logr/zap with consistent namespace/name
key-value context (reference ``internal/controller/utils.go:41-56``, where
``logDebug``/``logInfo``/``logError`` always attach ``namespace`` and
``name``). This module provides the same shape on top of stdlib logging:
key-value structured records with a ``with_values`` context carrier, and
debug mapped to verbosity level 1.
"""

from __future__ import annotations

import logging
import sys
from typing import Any

_FORMAT = "%(asctime)s %(levelname)s %(name)s %(message)s"


def _ensure_root_handler() -> None:
    root = logging.getLogger("cko")
    if not root.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter(_FORMAT))
        root.addHandler(handler)
        root.setLevel(logging.INFO)


def _render(msg: str, kv: dict[str, Any]) -> str:
    if not kv:
        return msg
    pairs = " ".join(f"{k}={v!r}" for k, v in kv.items())
    return f"{msg} {pairs}"


class Logger:
    """A logr-style structured logger: ``info(msg, **kv)`` with bound context."""

    def __init__(self, name: str, values: dict[str, Any] | None = None):
        _ensure_root_handler()
        self._log = logging.getLogger(f"cko.{name}")
        self._values = dict(values or {})

    def with_values(self, **kv: Any) -> "Logger":
        merged = dict(self._values)
        merged.update(kv)
        return Logger(self._log.name.removeprefix("cko."), merged)

    def _kv(self, kv: dict[str, Any]) -> dict[str, Any]:
        merged = dict(self._values)
        merged.update(kv)
        return merged

    def debug(self, msg: str, **kv: Any) -> None:
        self._log.debug(_render(msg, self._kv(kv)))

    def info(self, msg: str, **kv: Any) -> None:
        self._log.info(_render(msg, self._kv(kv)))

    def error(self, msg: str, err: BaseException | str | None = None, **kv: Any) -> None:
        if err is not None:
            kv = {"error": str(err), **kv}
        self._log.error(_render(msg, self._kv(kv)))

    def critical(self, msg: str, err: BaseException | str | None = None, **kv: Any) -> None:
        """Operator-page severity (breaker opening, data-plane demotion)."""
        if err is not None:
            kv = {"error": str(err), **kv}
        self._log.critical(_render(msg, self._kv(kv)))


def get_logger(name: str, **kv: Any) -> Logger:
    return Logger(name, kv or None)
