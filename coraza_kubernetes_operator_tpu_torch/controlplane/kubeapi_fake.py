"""In-repo fake Kubernetes API server — the envtest analog.

The reference's tier-2 suite boots a *real* kube-apiserver via envtest
(``internal/controller/suite_test.go:54-187``) to get schema + CEL
admission without a cluster. No apiserver binary ships in this image, so
this module provides the equivalent seam: a real HTTP server speaking
the API-machinery wire protocol the production client
(``kubeclient.KubeClient``) uses —

- namespaced GET/LIST/POST/PATCH(apply)/DELETE for the managed GVRs,
- the ``/status`` subresource,
- chunked-streaming WATCH with resourceVersion resumption + bookmarks,
- admission validation of RuleSet/Engine via the **shipped CRD YAML**
  (``crdschema.py``: structural OpenAPI + executed CEL) with
  apiserver-shaped error messages,
- Lease objects for leader-election tests,
- resourceVersion/generation semantics (generation bumps only on spec
  changes — the GenerationChanged predicate contract).

Tests drive the full client→server path: the same bytes-on-the-wire the
operator sends a real cluster (minus TLS client auth, which is config).
"""

from __future__ import annotations

import json
import queue
import re
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlsplit

from .crdschema import ValidationError, load_crds

# (api prefix, plural) → kind, matching kubeclient._API_PATHS.
_ROUTES = {
    ("api/v1", "configmaps"): "ConfigMap",
    ("apis/waf.k8s.coraza.io/v1alpha1", "rulesets"): "RuleSet",
    ("apis/waf.k8s.coraza.io/v1alpha1", "engines"): "Engine",
    ("apis/extensions.istio.io/v1alpha1", "wasmplugins"): "WasmPlugin",
    ("apis/apps/v1", "deployments"): "Deployment",
    ("apis/coordination.k8s.io/v1", "leases"): "Lease",
    ("api/v1", "events"): "Event",
}
_VALIDATED_KINDS = ("RuleSet", "Engine")

_API_ALT = "|".join(
    sorted({re.escape(api) for api, _ in _ROUTES}, key=len, reverse=True)
)
_PATH_RE = re.compile(
    rf"^/(?P<api>{_API_ALT})(?:/namespaces/(?P<ns>[^/]+))?/"
    r"(?P<plural>[^/]+)(?:/(?P<name>[^/]+))?(?P<status>/status)?$"
)


class _State:
    def __init__(self):
        self.lock = threading.RLock()
        self.rv = 0
        # kind -> (ns, name) -> doc
        self.objects: dict[str, dict[tuple[str, str], dict]] = {}
        # kind -> list of (rv, event_type, doc)
        self.history: dict[str, list[tuple[int, str, dict]]] = {}
        self.watchers: dict[str, list[queue.Queue]] = {}
        self.crds = load_crds()

    def next_rv(self) -> int:
        self.rv += 1
        return self.rv

    def emit(self, kind: str, etype: str, doc: dict) -> None:
        rv = int(doc["metadata"]["resourceVersion"])
        self.history.setdefault(kind, []).append((rv, etype, doc))
        for q in self.watchers.get(kind, []):
            q.put((etype, doc))


class FakeKubeApiServer:
    """Threaded HTTP server; ``port`` is bound on start (0 = ephemeral).

    ``chaos`` makes the fake HOSTILE (a fake written by the same author
    shares the author's assumptions unless it is taught to misbehave like
    a real apiserver):

    - ``watch_410_after``: after N streamed events per connection, emit
      a 410 Gone ERROR event and close — the client must re-list and
      re-watch from scratch.
    - ``watch_reject_rv_below``: watch requests resuming from a
      resourceVersion below this horizon get an immediate HTTP 410
      (compacted history), like an apiserver that dropped old RVs.
    - ``ssa_conflicts``: fail the next N apply patches with the
      apiserver's 409 field-manager Conflict Status.
    - ``bookmark_interval``: seconds of idle before a BOOKMARK event
      (default 30; tests shorten it to exercise bookmark-only progress).
    - ``tls`` (cert_file, key_file): serve HTTPS, optionally verifying
      client certificates against ``tls_client_ca``.
    """

    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 0,
        chaos: dict | None = None,
        tls: tuple[str, str] | None = None,
        tls_client_ca: str | None = None,
    ):
        self.state = _State()
        self.chaos = chaos if chaos is not None else {}
        self._tls = tls
        self._tls_client_ca = tls_client_ca
        state = self.state
        chaos_ref = self.chaos

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):  # noqa: D102
                pass

            # -- helpers ----------------------------------------------------

            def _send_json(self, code: int, doc: dict) -> None:
                body = json.dumps(doc).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _error(self, code: int, message: str, reason: str = "") -> None:
                self._send_json(
                    code,
                    {
                        "kind": "Status",
                        "apiVersion": "v1",
                        "status": "Failure",
                        "message": message,
                        "reason": reason,
                        "code": code,
                    },
                )

            def _route(self):
                parts = urlsplit(self.path)
                m = _PATH_RE.match(parts.path)
                if not m:
                    return None
                kind = _ROUTES.get((m.group("api"), m.group("plural")))
                if kind is None:
                    return None
                return (
                    kind,
                    m.group("ns"),
                    m.group("name"),
                    bool(m.group("status")),
                    parse_qs(parts.query),
                )

            def _read_body(self) -> dict:
                length = int(self.headers.get("Content-Length", "0"))
                raw = self.rfile.read(length) if length else b""
                return json.loads(raw) if raw else {}

            def _validate(self, kind: str, doc: dict) -> str | None:
                crd = state.crds.get(kind)
                if kind in _VALIDATED_KINDS and crd is not None:
                    try:
                        crd.validate(doc)
                    except ValidationError as err:
                        return str(err)
                return None

            # -- verbs ------------------------------------------------------

            def do_GET(self):  # noqa: N802
                route = self._route()
                if route is None:
                    self._error(404, f"unknown path {self.path}")
                    return
                kind, ns, name, _status, query = route
                with state.lock:
                    objs = state.objects.get(kind, {})
                    if name and ns:
                        doc = objs.get((ns, name))
                        if doc is None:
                            self._error(404, f'{kind} "{name}" not found', "NotFound")
                            return
                        self._send_json(200, doc)
                        return
                    if query.get("watch", ["false"])[0] != "true":
                        # ns=None → cluster-scoped list across namespaces
                        items = [
                            d for (n, _), d in objs.items() if ns is None or n == ns
                        ]
                        # apiserver chunking: limit + opaque continue token.
                        meta = {"resourceVersion": str(state.rv)}
                        limit = int(query.get("limit", ["0"])[0] or 0)
                        offset = int(query.get("continue", ["0"])[0] or 0)
                        if limit and len(items) > offset + limit:
                            meta["continue"] = str(offset + limit)
                        if limit:
                            items = items[offset : offset + limit]
                        self._send_json(
                            200,
                            {
                                "kind": f"{kind}List",
                                "items": items,
                                "metadata": meta,
                            },
                        )
                        return
                    # watch: register + replay history after resourceVersion
                    since = int(query.get("resourceVersion", ["0"])[0] or 0)
                    horizon = int(chaos_ref.get("watch_reject_rv_below", 0))
                    if since and since < horizon:
                        self._error(
                            410,
                            f"too old resource version: {since} ({horizon})",
                            "Expired",
                        )
                        return
                    q: queue.Queue = queue.Queue()
                    backlog = [
                        (etype, doc)
                        for rv, etype, doc in state.history.get(kind, [])
                        if rv > since
                    ]
                    state.watchers.setdefault(kind, []).append(q)
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()

                def write_event(etype: str, doc: dict) -> None:
                    line = json.dumps({"type": etype, "object": doc}).encode() + b"\n"
                    self.wfile.write(f"{len(line):x}\r\n".encode() + line + b"\r\n")
                    self.wfile.flush()

                sent = 0
                budget = int(chaos_ref.get("watch_410_after", 0))
                bookmark_s = float(chaos_ref.get("bookmark_interval", 30))

                def gone_and_close() -> None:
                    write_event(
                        "ERROR",
                        {
                            "kind": "Status",
                            "status": "Failure",
                            "reason": "Expired",
                            "code": 410,
                            "message": "too old resource version (chaos)",
                        },
                    )
                    self.wfile.write(b"0\r\n\r\n")
                    self.wfile.flush()

                try:
                    for etype, doc in backlog:
                        write_event(etype, doc)
                        sent += 1
                        if budget and sent >= budget:
                            gone_and_close()
                            return
                    while True:
                        try:
                            etype, doc = q.get(timeout=bookmark_s)
                            write_event(etype, doc)
                            sent += 1
                            if budget and sent >= budget:
                                gone_and_close()
                                return
                        except queue.Empty:
                            write_event(
                                "BOOKMARK",
                                {"metadata": {"resourceVersion": str(state.rv)}},
                            )
                except (BrokenPipeError, ConnectionResetError, OSError):
                    pass
                finally:
                    with state.lock:
                        if q in state.watchers.get(kind, []):
                            state.watchers[kind].remove(q)

            def do_POST(self):  # noqa: N802
                route = self._route()
                if route is None:
                    self._error(404, f"unknown path {self.path}")
                    return
                kind, ns, _name, _status, _query = route
                doc = self._read_body()
                doc.setdefault("kind", kind)
                meta = doc.setdefault("metadata", {})
                meta.setdefault("namespace", ns)
                name = meta.get("name", "")
                problem = self._validate(kind, doc)
                if problem:
                    self._error(422, problem, "Invalid")
                    return
                with state.lock:
                    objs = state.objects.setdefault(kind, {})
                    if (ns, name) in objs:
                        self._error(409, f'{kind} "{name}" already exists', "AlreadyExists")
                        return
                    meta["uid"] = meta.get("uid") or str(uuid.uuid4())
                    meta["generation"] = 1
                    meta["resourceVersion"] = str(state.next_rv())
                    meta.setdefault("creationTimestamp", _now())
                    objs[(ns, name)] = doc
                    state.emit(kind, "ADDED", doc)
                self._send_json(201, doc)

            def do_PATCH(self):  # noqa: N802
                route = self._route()
                if route is None:
                    self._error(404, f"unknown path {self.path}")
                    return
                kind, ns, name, status_sub, query = route
                patch = self._read_body()
                remaining = int(chaos_ref.get("ssa_conflicts", 0))
                if remaining > 0 and not status_sub:
                    chaos_ref["ssa_conflicts"] = remaining - 1
                    manager = query.get("fieldManager", ["?"])[0]
                    self._error(
                        409,
                        f'Apply failed with 1 conflict: conflict with "legacy-writer"'
                        f" using waf.k8s.coraza.io/v1alpha1: .spec (manager {manager})",
                        "Conflict",
                    )
                    return
                with state.lock:
                    objs = state.objects.setdefault(kind, {})
                    existing = objs.get((ns, name))
                    if existing is None:
                        if status_sub:
                            self._error(404, f'{kind} "{name}" not found', "NotFound")
                            return
                        # SSA create path
                        patch.setdefault("kind", kind)
                        meta = patch.setdefault("metadata", {})
                        meta.setdefault("namespace", ns)
                        meta.setdefault("name", name)
                        problem = self._validate(kind, patch)
                        if problem:
                            self._error(422, problem, "Invalid")
                            return
                        meta["uid"] = str(uuid.uuid4())
                        meta["generation"] = 1
                        meta["resourceVersion"] = str(state.next_rv())
                        meta.setdefault("creationTimestamp", _now())
                        meta["managedFields"] = [
                            {"manager": query.get("fieldManager", ["?"])[0]}
                        ]
                        objs[(ns, name)] = patch
                        state.emit(kind, "ADDED", patch)
                        self._send_json(201, patch)
                        return
                    merged = dict(existing)
                    if status_sub:
                        merged["status"] = patch.get("status", {})
                    else:
                        candidate = dict(existing)
                        for key in ("spec", "data", "stringData"):
                            if key in patch:
                                candidate[key] = patch[key]
                        meta_patch = patch.get("metadata", {}) or {}
                        cand_meta = dict(candidate.get("metadata", {}))
                        for key in ("labels", "annotations", "ownerReferences"):
                            if key in meta_patch:
                                cand_meta[key] = meta_patch[key]
                        candidate["metadata"] = cand_meta
                        problem = self._validate(kind, candidate)
                        if problem:
                            self._error(422, problem, "Invalid")
                            return
                        spec_changed = any(
                            candidate.get(k) != existing.get(k)
                            for k in ("spec", "data", "stringData")
                        )
                        merged = candidate
                        if spec_changed:
                            merged["metadata"]["generation"] = (
                                int(existing["metadata"].get("generation", 1)) + 1
                            )
                        merged["metadata"]["managedFields"] = [
                            {"manager": query.get("fieldManager", ["?"])[0]}
                        ]
                    merged["metadata"]["resourceVersion"] = str(state.next_rv())
                    objs[(ns, name)] = merged
                    state.emit(kind, "MODIFIED", merged)
                self._send_json(200, merged)

            def do_DELETE(self):  # noqa: N802
                route = self._route()
                if route is None:
                    self._error(404, f"unknown path {self.path}")
                    return
                kind, ns, name, _status, _query = route
                with state.lock:
                    objs = state.objects.setdefault(kind, {})
                    doc = objs.pop((ns, name), None)
                    if doc is None:
                        self._error(404, f'{kind} "{name}" not found', "NotFound")
                        return
                    doc["metadata"]["resourceVersion"] = str(state.next_rv())
                    state.emit(kind, "DELETED", doc)
                self._send_json(200, doc)

        class Server(ThreadingHTTPServer):
            daemon_threads = True
            allow_reuse_address = True

        self._httpd = Server((host, port), Handler)
        if tls is not None:
            import ssl as _ssl

            ctx = _ssl.SSLContext(_ssl.PROTOCOL_TLS_SERVER)
            ctx.load_cert_chain(tls[0], tls[1])
            if tls_client_ca:
                ctx.load_verify_locations(tls_client_ca)
                ctx.verify_mode = _ssl.CERT_REQUIRED
            self._httpd.socket = ctx.wrap_socket(
                self._httpd.socket, server_side=True
            )
        self.host = host
        self.port = self._httpd.server_address[1]
        self._thread: threading.Thread | None = None

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True, name="fake-kube-apiserver"
        )
        self._thread.start()

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread:
            self._thread.join(timeout=5)


def _now() -> str:
    return time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())
