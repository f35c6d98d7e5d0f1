"""WAF audit log: JSON lines in a ModSecurity-compatible shape.

The reference's data plane writes ``SecAuditLog /dev/stdout`` with
``SecAuditLogFormat JSON`` (reference
``hack/generate_coreruleset_configmaps.py:47-49``) and the ftw runner
streams those lines to a file that go-ftw greps with patterns like
``id "942100"`` (reference ``ftw/run.py:118-141,258-287``). This logger
emits the same essentials per transaction: unique id, client/host info,
request line, and one ``messages[]`` entry per matched rule whose
``details.ruleId`` / ``message`` render as ``[id "942100"] [msg "..."]``
inside the line, so both JSON consumers and regex log matchers work.
"""

from __future__ import annotations

import json
import os
import threading
import time
import uuid
from dataclasses import dataclass, field
from typing import IO


@dataclass
class AuditRecord:
    """One evaluated transaction."""

    request_line: str
    client: str = ""
    host: str = ""
    status: int = 200
    interrupted: bool = False
    matched: list[dict] = field(default_factory=list)  # rule metadata dicts
    tenant: str = ""


class AuditLogger:
    """Serializes audit records as JSON lines to a stream or file.

    ``relevant_only`` mirrors ``SecAuditEngine RelevantOnly``: only
    transactions that matched at least one rule (or were interrupted) are
    written.

    ``max_bytes`` (default: ``CKO_AUDIT_MAX_BYTES`` env, 0 = unbounded)
    enables size-based keep-1 rotation for path-owned logs: when the
    live file would exceed the cap it is renamed to ``<path>.1``
    (replacing any previous rollover) and a fresh file is opened, so the
    sidecar holds at most ~2x ``max_bytes`` of audit data. Stream-backed
    loggers (stdout) never rotate.
    """

    def __init__(
        self,
        stream: IO[str] | None = None,
        path: str | None = None,
        relevant_only: bool = True,
        max_bytes: int | None = None,
    ):
        if stream is None and path is None:
            raise ValueError("AuditLogger needs a stream or a path")
        if max_bytes is None:
            max_bytes = int(os.environ.get("CKO_AUDIT_MAX_BYTES", "") or 0)
        self._own = stream is None
        self._path = path
        self._stream: IO[str] = stream or open(path, "a", encoding="utf-8")  # noqa: SIM115
        self.relevant_only = relevant_only
        self.max_bytes = max(0, int(max_bytes))
        self._lock = threading.Lock()
        self.written = 0
        self.rotations = 0
        self._bytes = 0
        if self._own:
            try:
                self._bytes = os.path.getsize(path)  # type: ignore[arg-type]
            except OSError:
                self._bytes = 0

    def log(self, record: AuditRecord) -> None:
        if self.relevant_only and not record.matched and not record.interrupted:
            return
        messages = []
        for rule in record.matched:
            rid = rule.get("id", 0)
            msg = rule.get("msg") or ""
            severity = rule.get("severity") or ""
            tags = rule.get("tags") or []
            # The rendered "data" string is what regex-based log matchers
            # (go-ftw log_contains: id "NNN") search for.
            data = f'[id "{rid}"]'
            if msg:
                data += f' [msg "{msg}"]'
            if severity:
                data += f' [severity "{severity}"]'
            for t in tags:
                data += f' [tag "{t}"]'
            messages.append(
                {
                    "message": msg,
                    "details": {
                        "ruleId": str(rid),
                        "severity": severity,
                        "tags": tags,
                        "match": data,
                    },
                }
            )
        doc = {
            "transaction": {
                "id": uuid.uuid4().hex[:16],
                "timestamp": time.strftime("%Y-%m-%dT%H:%M:%S%z"),
                "client_ip": record.client,
                "host_ip": record.host,
                "tenant": record.tenant,
                "request": {"line": record.request_line},
                "response": {"status": record.status},
                "interrupted": record.interrupted,
                "messages": messages,
            }
        }
        line = json.dumps(doc, separators=(",", ":"))
        with self._lock:
            if (
                self._own
                and self.max_bytes > 0
                and self._bytes + len(line) + 1 > self.max_bytes
                and self._bytes > 0
            ):
                self._rotate_locked()
            self._stream.write(line + "\n")
            self._stream.flush()
            self._bytes += len(line) + 1
            self.written += 1

    def _rotate_locked(self) -> None:
        """Keep-1 rollover: live file becomes ``<path>.1`` (previous
        rollover, if any, is replaced) and a fresh live file opens."""
        try:
            self._stream.close()
        except OSError:
            pass
        try:
            os.replace(self._path, self._path + ".1")  # type: ignore[arg-type]
        except OSError:
            pass
        self._stream = open(self._path, "a", encoding="utf-8")  # type: ignore[arg-type]  # noqa: SIM115
        self._bytes = 0
        self.rotations += 1

    def flush(self) -> None:
        """Explicit flush for graceful drain: every record already on
        the stream reaches the file before the process exits."""
        with self._lock:
            try:
                if not self._stream.closed:
                    self._stream.flush()
            except (OSError, ValueError):
                pass

    def close(self) -> None:
        if self._own:
            with self._lock:
                self._stream.close()
