"""Kubernetes-Events-style recorder — the user-visible audit trail.

Reason strings match the reference exactly (RulesCached, ConfigMapNotFound,
InvalidConfigMap, InvalidRuleSet, WasmPluginCreated, ProvisioningFailed,
InvalidConfiguration — see SURVEY §5) so dashboards/tests carry over.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from datetime import datetime, timezone
from typing import Any

from ..utils import get_logger

log = get_logger("events")


@dataclass
class Event:
    event_type: str  # Normal | Warning
    reason: str
    message: str
    kind: str = ""
    namespace: str = ""
    name: str = ""
    timestamp: datetime = field(default_factory=lambda: datetime.now(timezone.utc))


class EventRecorder:
    """Records events and logs them (the in-process analog of the
    EventBroadcaster sink)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.events: list[Event] = []

    def event(self, obj: Any, event_type: str, reason: str, message: str) -> None:
        ev = Event(
            event_type=event_type,
            reason=reason,
            message=message,
            kind=getattr(obj, "kind", ""),
            namespace=obj.metadata.namespace,
            name=obj.metadata.name,
        )
        with self._lock:
            self.events.append(ev)
        log.info(
            "event",
            type=event_type,
            reason=reason,
            object=f"{ev.kind}/{ev.namespace}/{ev.name}",
            message=message,
        )

    def has_event(self, event_type: str, reason: str) -> bool:
        with self._lock:
            return any(
                e.event_type == event_type and e.reason == reason for e in self.events
            )

    def events_for(self, namespace: str, name: str) -> list[Event]:
        with self._lock:
            return [
                e for e in self.events if e.namespace == namespace and e.name == name
            ]


class FakeRecorder(EventRecorder):
    """Test alias mirroring the reference's utils.FakeRecorder."""
