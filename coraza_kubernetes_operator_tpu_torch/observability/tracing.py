"""Pipeline flight recorder: dependency-free W3C trace-context tracing.

The metrics registry answers "how is the fleet doing"; this module
answers "where did THIS request spend its time".  A request entering
either frontend may carry a W3C ``traceparent`` header; both frontends
parse it (or mint one when sampling is on), attach a
:class:`SpanContext` to the batcher item / blob window, and every
pipeline stage stamps the context as the request moves: accept, parse,
queue wait, window assemble, device dispatch, readback, decode, reply —
plus the degraded branches (fallback rescue, shed, breaker open,
quarantine hit, watchdog abandon).  Completed contexts are committed to
a bounded ring buffer and exported as Chrome trace-event JSON
(loadable in Perfetto / ``chrome://tracing``) via ``GET /waf/v1/trace``.

Design constraints, in order:

- **Zero hot-path cost when off.**  ``CKO_TRACE_SAMPLE_RATE=0`` (the
  default) means requests without a ``traceparent`` header pay one
  attribute read; requests *with* one pay a parse + response echo but
  never touch the ring (``TraceRecorder.writes`` stays 0).
- **Deterministic response identity.**  The server span id is derived
  from ``sha256(trace_id, parent_span_id)`` so both frontends echo a
  byte-identical response ``traceparent`` for the same inbound header —
  the frontend-parity test asserts exact equality, and the async
  frontend's small-response render cache stays coherent.
- **Lock-cheap commit.**  Stages append to a plain per-request list
  (hand-offs between threads happen through queues, so appends are
  sequenced); the only shared mutation is one locked ``deque.append``
  per *trace*, not per span.

Knobs (env, read at recorder construction):

- ``CKO_TRACE_SAMPLE_RATE`` (default 0.0): probability a request
  without a ``traceparent`` header is traced; requests carrying the
  header are always recorded when the rate is > 0.
- ``CKO_TRACE_RING`` (default 512): max completed traces retained.
"""

from __future__ import annotations

import hashlib
import json
import os
import random
import threading
import time

DEFAULT_RING = 512

# Chrome trace-event "threads" — one lane per pipeline layer so Perfetto
# renders the hand-offs as a swimlane diagram.
TRACKS = {"frontend": 1, "pipeline": 2, "device": 3, "degraded": 4}

# The full promoted-path span chain, in pipeline order.  Tests and the
# trace smoke assert exported traces against this.
PIPELINE_CHAIN = (
    "accept",
    "parse",
    "queue",
    "assemble",
    "dispatch",
    "readback",
    "decode",
    "reply",
)


def parse_traceparent(raw: str | bytes | None) -> tuple[str, str, int] | None:
    """Parse a W3C ``traceparent`` header.

    Returns ``(trace_id, parent_span_id, flags)`` or ``None`` when the
    header is absent or malformed (unknown versions with the 00 layout
    are accepted, per spec).
    """
    if not raw:
        return None
    if isinstance(raw, bytes):
        try:
            raw = raw.decode("ascii")
        except UnicodeDecodeError:
            return None
    parts = raw.strip().lower().split("-")
    if len(parts) < 4:
        return None
    version, trace_id, span_id, flags = parts[0], parts[1], parts[2], parts[3]
    if len(version) != 2 or len(trace_id) != 32 or len(span_id) != 16:
        return None
    if len(flags) != 2:
        return None
    try:
        int(version, 16)
        int(trace_id, 16)
        int(span_id, 16)
        flag_bits = int(flags, 16)
    except ValueError:
        return None
    if version == "ff":
        return None
    if trace_id == "0" * 32 or span_id == "0" * 16:
        return None
    return trace_id, span_id, flag_bits


def format_traceparent(trace_id: str, span_id: str, flags: int = 1) -> str:
    return f"00-{trace_id}-{span_id}-{flags & 0xFF:02x}"


def derive_span_id(trace_id: str, parent_span_id: str) -> str:
    """Deterministic server span id for an inbound context.

    Both frontends must answer the same inbound ``traceparent`` with a
    byte-identical response header; hashing (trace_id, parent) gives a
    stable non-zero 16-hex id without coordination.
    """
    digest = hashlib.sha256(
        b"cko-span\x00" + trace_id.encode("ascii") + b"\x00" + parent_span_id.encode("ascii")
    ).hexdigest()[:16]
    if digest == "0" * 16:  # pragma: no cover - 2^-64
        digest = "0" * 15 + "1"
    return digest


def new_trace_id() -> str:
    tid = os.urandom(16).hex()
    while tid == "0" * 32:  # pragma: no cover
        tid = os.urandom(16).hex()
    return tid


def new_span_id() -> str:
    sid = os.urandom(8).hex()
    while sid == "0" * 16:  # pragma: no cover
        sid = os.urandom(8).hex()
    return sid


class SpanContext:
    """Per-request flight record.

    Owned by exactly one thread at a time (frontend loop → batcher
    dispatch → collector → frontend reply), so span appends are plain
    list appends.  ``recording=False`` contexts exist only to echo the
    response ``traceparent``; every stamp on them is a no-op.
    """

    __slots__ = (
        "trace_id",
        "span_id",
        "parent_id",
        "flags",
        "recording",
        "path",
        "events",
        "t_accept",
        "t_submit",
        "committed",
    )

    def __init__(
        self,
        trace_id: str,
        span_id: str,
        parent_id: str | None,
        flags: int = 1,
        recording: bool = True,
        t_accept: float | None = None,
    ):
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.flags = flags
        self.recording = recording
        self.path = "promoted"
        self.events: list[tuple[str, float, float, str, dict | None]] = []
        self.t_accept = time.monotonic() if t_accept is None else t_accept
        self.t_submit = 0.0
        self.committed = False

    def event(
        self,
        name: str,
        t0: float,
        t1: float | None = None,
        track: str = "frontend",
        args: dict | None = None,
    ) -> None:
        if not self.recording:
            return
        self.events.append((name, t0, t1 if t1 is not None else t0, track, args))

    def annotate_path(self, path: str) -> None:
        """Tag the serving path taken (promoted/fallback/shed/breaker/
        quarantine/abandoned).  Degraded branches override promoted;
        later degraded tags override earlier ones (e.g. abandoned →
        fallback rescue)."""
        if self.recording:
            self.path = path

    def response_traceparent(self) -> str:
        return format_traceparent(self.trace_id, self.span_id, self.flags)

    def span_names(self) -> list[str]:
        return [e[0] for e in self.events]


class TraceRecorder:
    """Bounded ring of completed flight records + sampling policy."""

    def __init__(
        self,
        capacity: int | None = None,
        sample_rate: float | None = None,
    ):
        if capacity is None:
            capacity = int(os.environ.get("CKO_TRACE_RING", "") or DEFAULT_RING)
        if sample_rate is None:
            sample_rate = float(os.environ.get("CKO_TRACE_SAMPLE_RATE", "") or 0.0)
        self.capacity = max(1, int(capacity))
        self.sample_rate = min(1.0, max(0.0, float(sample_rate)))
        self._lock = threading.Lock()
        from collections import deque

        self._ring: "deque[dict]" = deque(maxlen=self.capacity)
        # Monotonic→wall pairing captured once so exports carry stable
        # absolute timestamps regardless of when they are rendered.
        self._mono0 = time.monotonic()
        self._wall0 = time.time()
        self.writes = 0
        self.dropped = 0

    # -- request lifecycle -------------------------------------------------

    def start(
        self,
        traceparent: str | bytes | None = None,
        t_accept: float | None = None,
    ) -> SpanContext | None:
        """Begin (or decline) a flight record for one request.

        Returns ``None`` for the common untraced case — no header and
        either sampling off or the coin-flip missing — so the hot path
        carries no context object at all.  A parsed header with
        sampling off yields a non-recording context (echo only).
        """
        parsed = parse_traceparent(traceparent)
        rate = self.sample_rate
        if parsed is not None:
            trace_id, parent_id, flags = parsed
            span_id = derive_span_id(trace_id, parent_id)
            recording = rate > 0.0
            return SpanContext(
                trace_id, span_id, parent_id, flags or 1, recording, t_accept
            )
        if rate <= 0.0 or (rate < 1.0 and random.random() >= rate):
            return None
        return SpanContext(new_trace_id(), new_span_id(), None, 1, True, t_accept)

    def commit(self, ctx: SpanContext | None, t_end: float | None = None) -> None:
        """Seal a flight record into the ring.  Idempotent; no-op for
        non-recording contexts."""
        if ctx is None or not ctx.recording or ctx.committed:
            return
        ctx.committed = True
        record = {
            "trace_id": ctx.trace_id,
            "span_id": ctx.span_id,
            "parent_id": ctx.parent_id,
            "path": ctx.path,
            "t_accept": ctx.t_accept,
            "t_end": t_end if t_end is not None else time.monotonic(),
            "events": list(ctx.events),
        }
        with self._lock:
            if len(self._ring) == self.capacity:
                self.dropped += 1
            self._ring.append(record)
            self.writes += 1

    # -- export ------------------------------------------------------------

    def _unix(self, t_mono: float) -> float:
        return self._wall0 + (t_mono - self._mono0)

    def snapshot(self, trace_id: str | None = None) -> list[dict]:
        with self._lock:
            records = list(self._ring)
        if trace_id is not None:
            records = [r for r in records if r["trace_id"] == trace_id]
        return records

    def chrome_trace(self, trace_id: str | None = None) -> dict:
        """Render the ring (optionally one trace) as Chrome trace-event
        JSON — the ``{"traceEvents": [...]}`` object format Perfetto
        and chrome://tracing load directly."""
        records = self.snapshot(trace_id)
        events: list[dict] = [
            {
                "name": "process_name",
                "ph": "M",
                "pid": 1,
                "tid": 0,
                "args": {"name": "cko-sidecar"},
            }
        ]
        for track, tid in sorted(TRACKS.items(), key=lambda kv: kv[1]):
            events.append(
                {
                    "name": "thread_name",
                    "ph": "M",
                    "pid": 1,
                    "tid": tid,
                    "args": {"name": track},
                }
            )
        mono0 = self._mono0
        for rec in records:
            base_args = {
                "trace_id": rec["trace_id"],
                "span_id": rec["span_id"],
                "path": rec["path"],
            }
            if rec["parent_id"]:
                base_args["parent_id"] = rec["parent_id"]
            for name, t0, t1, track, extra in rec["events"]:
                args = dict(base_args)
                if extra:
                    args.update(extra)
                events.append(
                    {
                        "name": name,
                        "ph": "X",
                        "ts": max(0.0, (t0 - mono0) * 1e6),
                        "dur": max(0.0, (t1 - t0) * 1e6),
                        "pid": 1,
                        "tid": TRACKS.get(track, 1),
                        "args": args,
                    }
                )
        return {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": {
                "traces": len(records),
                "writes": self.writes,
                "dropped": self.dropped,
                "sample_rate": self.sample_rate,
            },
        }

    def chrome_trace_json(self, trace_id: str | None = None) -> bytes:
        return json.dumps(self.chrome_trace(trace_id), separators=(",", ":")).encode(
            "utf-8"
        )

    def stats(self) -> dict:
        with self._lock:
            size = len(self._ring)
        return {
            "sample_rate": self.sample_rate,
            "capacity": self.capacity,
            "size": size,
            "writes": self.writes,
            "dropped": self.dropped,
        }
