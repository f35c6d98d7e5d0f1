"""Observability: Prometheus-format metrics and the WAF audit log.

The reference exposes controller-runtime's Prometheus metrics server
(reference ``cmd/main.go:86,153-165``) and relies on the data plane's
``SecAuditLog /dev/stdout`` JSON stream for conformance-test log matching
(reference ``hack/generate_coreruleset_configmaps.py:47-49``,
``ftw/run.py:118-141``). This package provides both first-party: a
dependency-free metrics registry rendered in the Prometheus text exposition
format, and a JSON-lines audit logger whose records carry the matched rule
ids that go-ftw-style log assertions grep for.
"""

from .audit import AuditLogger
from .metrics import Counter, Gauge, Histogram, MetricsRegistry
from .tracing import (
    SpanContext,
    TraceRecorder,
    derive_span_id,
    format_traceparent,
    parse_traceparent,
)

__all__ = [
    "AuditLogger",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "SpanContext",
    "TraceRecorder",
    "derive_span_id",
    "format_traceparent",
    "parse_traceparent",
]
