"""Operator entrypoint — the reference ``cmd/main.go`` analog
(``python -m coraza_kubernetes_operator_tpu_torch.cmd.operator``). Its
Engine controller deploys the ``gpu-engine`` sidecar for ``spec.driver.gpu``.
It runs on the control-plane host and needs ``pyyaml`` (and
``cryptography`` for ``--metrics-secure`` without a certificate); nothing
that runs on the card imports it.

Wires together, with the same flag surface (reference ``cmd/main.go:71-238``):

- the versioned RuleSet cache + HTTP cache server with GC knobs
  (``--cache-server-port``, ``--cache-gc-interval/-max-age/-max-size``);
- both controllers via the ControllerManager (requires
  ``--envoy-cluster-name`` exactly like the reference refuses to start
  without it);
- health (``/healthz``, ``/readyz``) and Prometheus ``/metrics`` servers;
- a leader-election gate (``--leader-elect``) — in-cluster this should be
  backed by a Lease; standalone it is a no-op latch.

Object source: ``--manifest-dir`` loads ConfigMap / RuleSet / Engine YAML
manifests into the watch-capable object store and re-scans on mtime change,
standing in for the kube-apiserver watch stream when running outside a
cluster (the same seam the in-memory envtest-analog tests use).
"""

from __future__ import annotations

import argparse
import re
import signal
import sys
import threading
import time
from datetime import timedelta
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import yaml

from ..cache import RuleSetCache, RuleSetCacheServer
from ..cache.server import (
    CACHE_GC_INTERVAL,
    CACHE_MAX_AGE,
    CACHE_MAX_SIZE,
    DEFAULT_CACHE_SERVER_PORT,
    GarbageCollectionConfig,
)
from ..controlplane.manager import ControllerManager
from ..controlplane.store import ObjectStore
from ..utils import get_logger

log = get_logger("cmd.operator")


def parse_duration(text: str) -> timedelta:
    """Go-style durations: 3s, 5m, 24h, 1h30m."""
    m = re.fullmatch(r"(?:(\d+)h)?(?:(\d+)m)?(?:(\d+)s)?", text.strip())
    if not m or not any(m.groups()):
        raise argparse.ArgumentTypeError(f"invalid duration {text!r}")
    h, mi, s = (int(g) if g else 0 for g in m.groups())
    return timedelta(hours=h, minutes=mi, seconds=s)


# -- manifest loading ---------------------------------------------------------

# Object <-> manifest conversion is shared with the Kubernetes API source
# (controlplane/manifests.py): one codec, both transports.
from ..controlplane.manifests import object_from_manifest  # noqa: E402


class ManifestSource:
    """Loads CR manifests from a directory into the store; rescans on
    mtime change — the out-of-cluster stand-in for API-server watches."""

    def __init__(self, store: ObjectStore, directory: Path, interval_s: float = 2.0):
        self.store = store
        self.directory = directory
        self.interval_s = interval_s
        self._known: dict[tuple, int] = {}  # (kind, ns, name) -> content hash
        self._file_keys: dict[Path, set[tuple]] = {}  # file -> its object keys
        self._file_stat: dict[Path, tuple[int, int]] = {}  # file -> (mtime_ns, size)
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def sync_once(self) -> int:
        count = 0
        seen: set[tuple] = set()
        for path in sorted(self.directory.rglob("*.y*ml")):
            try:
                st = path.stat()
                sig = (st.st_mtime_ns, st.st_size)
                if self._file_stat.get(path) == sig:
                    # unchanged on disk: keep its objects without re-parsing
                    seen |= self._file_keys.get(path, set())
                    continue
                docs = list(yaml.safe_load_all(path.read_text()))
            except (OSError, yaml.YAMLError) as err:
                # A transient read/parse failure (e.g. a non-atomic write in
                # progress) must NOT read as absence — keep the file's known
                # objects alive and retry next scan.
                log.error("skipping unreadable manifest", err, path=str(path))
                seen |= self._file_keys.get(path, set())
                continue
            file_keys: set[tuple] = set()
            for doc in docs:
                if not isinstance(doc, dict):
                    continue
                obj = object_from_manifest(doc)
                if obj is None:
                    continue
                key = (obj.kind, obj.metadata.namespace, obj.metadata.name)
                seen.add(key)
                file_keys.add(key)
                digest = hash(repr(doc))
                if self._known.get(key) == digest:
                    continue
                existing = self.store.try_get(*key)
                if existing is None:
                    self.store.create(obj)
                else:
                    obj.metadata.uid = existing.metadata.uid
                    obj.metadata.resource_version = existing.metadata.resource_version
                    obj.metadata.generation = existing.metadata.generation
                    self.store.update(obj)
                self._known[key] = digest
                count += 1
            self._file_keys[path] = file_keys
            self._file_stat[path] = sig
        for path in [p for p in self._file_keys if not p.exists()]:
            del self._file_keys[path]
            self._file_stat.pop(path, None)
        for key in [k for k in self._known if k not in seen]:
            del self._known[key]
            try:
                self.store.delete(*key)
            except KeyError:
                pass
        return count

    def start(self) -> None:
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.sync_once()
            except Exception as err:  # keep watching despite bad manifests
                log.error("manifest rescan failed", err)

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)


# -- health/metrics servers ---------------------------------------------------


class _ProbeHandler(BaseHTTPRequestHandler):
    def log_message(self, fmt, *args):  # noqa: D102
        pass

    def do_GET(self):  # noqa: N802
        path = self.path.split("?", 1)[0]
        ready_fn = self.server.ready_fn  # type: ignore[attr-defined]
        metrics = self.server.metrics  # type: ignore[attr-defined]
        token = getattr(self.server, "auth_token", None)
        if path == "/healthz":
            body, code = b"ok\n", 200
        elif path == "/readyz":
            ok = ready_fn()
            body, code = (b"ok\n", 200) if ok else (b"not ready\n", 503)
        elif path == "/metrics" and metrics is not None:
            # Authn/authz parity with the reference's protected metrics
            # endpoint (cmd/main.go:123-177 FilterProvider WithAuthentication
            # AndAuthorization): no cluster TokenReview exists here, so the
            # analog is a static bearer token.
            import hmac

            presented = self.headers.get("Authorization") or ""
            if token and not hmac.compare_digest(
                presented.encode(), f"Bearer {token}".encode()
            ):
                body, code = b"unauthorized\n", 401
            else:
                body, code = metrics.render().encode(), 200
        else:
            body, code = b"not found\n", 404
        self.send_response(code)
        self.send_header("Content-Length", str(len(body)))
        self.send_header("Content-Type", "text/plain; charset=utf-8")
        self.end_headers()
        self.wfile.write(body)


def _self_signed_cert() -> tuple[str, str]:
    """Generate an in-memory self-signed cert (kubebuilder's default when
    --metrics-secure is on and no cert dir is provided); returns
    (certfile, keyfile) temp paths."""
    import datetime
    import tempfile

    from cryptography import x509
    from cryptography.hazmat.primitives import hashes, serialization
    from cryptography.hazmat.primitives.asymmetric import ec
    from cryptography.x509.oid import NameOID

    key = ec.generate_private_key(ec.SECP256R1())
    name = x509.Name(
        [x509.NameAttribute(NameOID.COMMON_NAME, "cko-operator-metrics")]
    )
    now = datetime.datetime.now(datetime.timezone.utc)
    cert = (
        x509.CertificateBuilder()
        .subject_name(name)
        .issuer_name(name)
        .public_key(key.public_key())
        .serial_number(x509.random_serial_number())
        .not_valid_before(now)
        .not_valid_after(now + datetime.timedelta(days=365))
        .add_extension(
            x509.SubjectAlternativeName([x509.DNSName("localhost")]),
            critical=False,
        )
        .sign(key, hashes.SHA256())
    )
    cf = tempfile.NamedTemporaryFile(suffix=".crt", delete=False)
    cf.write(cert.public_bytes(serialization.Encoding.PEM))
    cf.close()
    kf = tempfile.NamedTemporaryFile(suffix=".key", delete=False)
    kf.write(
        key.private_bytes(
            serialization.Encoding.PEM,
            serialization.PrivateFormat.PKCS8,
            serialization.NoEncryption(),
        )
    )
    kf.close()
    return cf.name, kf.name


def _serve(
    addr: str,
    ready_fn,
    metrics=None,
    secure: bool = False,
    certfile: str | None = None,
    keyfile: str | None = None,
    auth_token: str | None = None,
) -> ThreadingHTTPServer:
    import ssl

    host, _, port = addr.rpartition(":")
    srv = ThreadingHTTPServer((host or "0.0.0.0", int(port)), _ProbeHandler)
    srv.ready_fn = ready_fn  # type: ignore[attr-defined]
    srv.metrics = metrics  # type: ignore[attr-defined]
    srv.auth_token = auth_token  # type: ignore[attr-defined]
    if secure:
        if bool(certfile) != bool(keyfile):
            raise SystemExit(
                "metrics TLS: provide BOTH --metrics-cert-path and "
                "--metrics-cert-key, or neither (self-signed)"
            )
        if not certfile:
            certfile, keyfile = _self_signed_cert()
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        ctx.load_cert_chain(certfile, keyfile)
        # HTTP/2 stays off (reference: disableHTTP2 default true —
        # HTTP/2 rapid-reset mitigations, cmd/main.go); h2 would need an
        # explicit ALPN offer, which is simply never made.
        srv.socket = ctx.wrap_socket(srv.socket, server_side=True)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


# -- main ---------------------------------------------------------------------


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="operator", description=__doc__)
    p.add_argument("--envoy-cluster-name", required=True,
                   help="Envoy cluster through which the mesh reaches the cache server")
    p.add_argument("--cache-server-port", type=int, default=DEFAULT_CACHE_SERVER_PORT)
    p.add_argument("--cache-gc-interval", type=parse_duration,
                   default=CACHE_GC_INTERVAL)
    p.add_argument("--cache-max-age", type=parse_duration, default=CACHE_MAX_AGE)
    p.add_argument("--cache-max-size", type=int, default=CACHE_MAX_SIZE)
    p.add_argument("--health-probe-bind-address", default=":8081")
    p.add_argument("--metrics-bind-address", default="",
                   help="empty disables the metrics endpoint (reference default)")
    p.add_argument("--metrics-secure", default=True,
                   type=lambda v: v.lower() not in ("false", "0", "no"),
                   help="serve metrics over HTTPS with bearer authn "
                        "(reference cmd/main.go --metrics-secure default); "
                        "pass false for plaintext")
    p.add_argument("--metrics-cert-path", default="",
                   help="TLS cert for the metrics endpoint; a self-signed "
                        "pair is generated when omitted (kubebuilder parity)")
    p.add_argument("--metrics-cert-key", default="")
    p.add_argument("--metrics-auth-token-file", default="",
                   help="file holding the static bearer token metrics "
                        "clients must present (the no-cluster analog of "
                        "TokenReview authn); generated when omitted")
    p.add_argument("--leader-elect", action="store_true")
    p.add_argument("--kubeconfig", default="",
                   help="kubeconfig path; auto-detects $KUBECONFIG / in-cluster "
                        "service account / ~/.kube/config when omitted")
    p.add_argument("--namespace", default="",
                   help="restrict watches to one namespace (default: all)")
    p.add_argument("--manifest-dir", default="",
                   help="directory of CR manifests (fallback object source when "
                        "no cluster is reachable)")
    p.add_argument("--workers", type=int, default=2)
    return p


def main(argv: list[str] | None = None, stop: threading.Event | None = None) -> int:
    """Run the operator. ``stop`` lets embedders (tests) request shutdown;
    when run as the process entrypoint SIGINT/SIGTERM set it instead."""
    args = build_parser().parse_args(argv)

    store = ObjectStore()
    cache = RuleSetCache()
    cache_server = RuleSetCacheServer(
        cache,
        port=args.cache_server_port,
        gc=GarbageCollectionConfig(
            gc_interval=args.cache_gc_interval,
            max_age=args.cache_max_age,
            max_size=args.cache_max_size,
        ),
    )
    manager = ControllerManager(
        store,
        cache,
        cache_server_cluster=args.envoy_cluster_name,
        cache_server_port=args.cache_server_port,
        workers=args.workers,
    )

    # Object source: a real API server when reachable (list+watch streams,
    # SSA write-back, Lease election — reference cmd/main.go:179-238),
    # manifest-dir as the out-of-cluster fallback.
    from ..controlplane.kubeclient import (
        ClusterSource,
        KubeClient,
        KubeConfig,
        LeaseElector,
    )

    cluster_source: ClusterSource | None = None
    elector: LeaseElector | None = None
    kube_cfg = KubeConfig.detect(args.kubeconfig or None)
    if kube_cfg is not None:
        client = KubeClient(kube_cfg)
        cluster_source = ClusterSource(
            store, client, namespace=args.namespace or None
        )
        if args.leader_elect:
            elector = LeaseElector(client)

    source: ManifestSource | None = None
    if args.manifest_dir:
        source = ManifestSource(store, Path(args.manifest_dir))

    ready = threading.Event()
    probe_srv = _serve(args.health_probe_bind_address, ready.is_set)
    metrics_srv = None
    if args.metrics_bind_address:
        token = None
        if args.metrics_secure:
            if args.metrics_auth_token_file:
                token = Path(args.metrics_auth_token_file).read_text().strip()
            else:
                import secrets
                import tempfile

                token = secrets.token_urlsafe(32)
                tf = tempfile.NamedTemporaryFile(
                    "w", suffix=".metrics-token", delete=False
                )
                tf.write(token)
                tf.close()
                log.info("generated metrics bearer token", path=tf.name)
        metrics_srv = _serve(
            args.metrics_bind_address,
            ready.is_set,
            cache_server.metrics,
            secure=args.metrics_secure,
            certfile=args.metrics_cert_path or None,
            keyfile=args.metrics_cert_key or None,
            auth_token=token,
        )

    if stop is None:
        stop = threading.Event()
    if threading.current_thread() is threading.main_thread():
        for sig in (signal.SIGINT, signal.SIGTERM):
            signal.signal(sig, lambda *_: stop.set())

    if args.leader_elect:
        if elector is not None:
            # Real Lease-based election: block startup until leadership
            # is won (controller-runtime manager semantics).
            elector.start()
            log.info("waiting for leader election", identity=elector.identity)
            while not elector.wait_for_leadership(1.0):
                if stop.is_set():
                    elector.stop()
                    return 0
        else:
            log.info("leader election enabled (standalone latch acquired: "
                     "no API server reachable)")

    cache_server.start()
    manager.start()
    if cluster_source is not None:
        cluster_source.start()
    if source is not None:
        source.sync_once()
        source.start()
    ready.set()
    log.info(
        "operator started",
        cachePort=cache_server.port,
        probes=args.health_probe_bind_address,
        metrics=args.metrics_bind_address or "(disabled)",
        cluster=f"{kube_cfg.host}:{kube_cfg.port}" if kube_cfg else "(none)",
        manifestDir=args.manifest_dir or "(none)",
    )
    stop.wait()
    ready.clear()
    if source is not None:
        source.stop()
    if cluster_source is not None:
        cluster_source.stop()
    if elector is not None:
        elector.stop()
    manager.stop()
    cache_server.stop()
    for srv in (probe_srv, metrics_srv):
        if srv is not None:
            srv.shutdown()
            srv.server_close()
    log.info("operator stopped")
    return 0


if __name__ == "__main__":
    sys.exit(main())
