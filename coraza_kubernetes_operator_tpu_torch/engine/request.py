"""HTTP request model and target extraction.

Extraction maps a request to the byte targets and numeric variables the
compiled ruleset needs: the host-side half of tensorization (the device half
is ``models/waf_model.eval_waf``). Variable semantics follow ModSecurity as
exercised by the reference corpus: ARGS are URL-decoded key/values from the
query string and form/JSON bodies, REQUEST_HEADERS are raw values keyed by
lower-cased name, REQUEST_URI includes the query, JSON bodies are flattened
to dotted paths (the base rules select the JSON body processor by
Content-Type — reference ``hack/generate_coreruleset_configmaps.py`` rules
200001/200006).
"""

from __future__ import annotations

import json
import re
from dataclasses import dataclass, field

from ..compiler.ruleset import (
    COLLECTIONS,
    CompiledRuleSet,
    NUMERIC_SCALARS,
    SCALARS,
)
from ..compiler.transforms_host import t_urldecode


@dataclass
class HttpRequest:
    """One HTTP request to evaluate. ``headers`` preserves order and repeats."""

    method: str = "GET"
    uri: str = "/"
    version: str = "HTTP/1.1"
    headers: list[tuple[str, str]] = field(default_factory=list)
    body: bytes = b""
    remote_addr: str = ""

    def header(self, name: str) -> str | None:
        name = name.lower()
        for k, v in self.headers:
            if k.lower() == name:
                return v
        return None

    @property
    def path(self) -> str:
        return self.uri.split("?", 1)[0]

    @property
    def query_string(self) -> str:
        parts = self.uri.split("?", 1)
        return parts[1] if len(parts) == 2 else ""


@dataclass
class HttpResponse:
    """Upstream response for phases 3/4 (``SecResponseBodyAccess``)."""

    status: int = 200
    headers: list[tuple[str, str]] = field(default_factory=list)
    body: bytes = b""
    version: str = "HTTP/1.1"


@dataclass
class ExtractedTarget:
    collection: str
    name: str | None  # selector key (lower-cased at match time)
    value: bytes


@dataclass
class Extraction:
    targets: list[ExtractedTarget]
    numerics: dict[tuple, int]


def _parse_pairs(raw: str, sep: str = "&") -> list[tuple[bytes, bytes]]:
    pairs: list[tuple[bytes, bytes]] = []
    for item in raw.split(sep):
        if not item:
            continue
        key, _, value = item.partition("=")
        pairs.append(
            (
                t_urldecode(key.encode("latin-1", "replace")),
                t_urldecode(value.encode("latin-1", "replace")),
            )
        )
    return pairs


def _flatten_json(obj, prefix: str, out: list[tuple[bytes, bytes]]) -> None:
    if isinstance(obj, dict):
        for k, v in obj.items():
            _flatten_json(v, f"{prefix}.{k}" if prefix else str(k), out)
    elif isinstance(obj, list):
        for i, v in enumerate(obj):
            _flatten_json(v, f"{prefix}.{i}" if prefix else str(i), out)
    else:
        if isinstance(obj, bool):
            val = b"true" if obj else b"false"
        elif obj is None:
            val = b""
        else:
            val = str(obj).encode("utf-8", "replace")
        out.append((prefix.encode("utf-8", "replace"), val))


# A line that could be a multipart delimiter: '--' + RFC 2046 bchars (no
# spaces; 70-char boundary + up to '--' close suffix = 72).
_BOUNDARY_CANDIDATE = re.compile(rb"--[0-9A-Za-z'()+_,\-./:=?]{1,72}")


def _parse_multipart(
    content_type: str, body: bytes
) -> tuple[list[tuple[bytes, bytes]], list[tuple[str, bytes, int]], int, int]:
    """Minimal RFC 2046 multipart/form-data parser (reference data plane:
    Coraza's bodyprocessors/multipart.go). Returns (args, files,
    strict_error, unmatched_boundary):

    - non-file parts land in ARGS_POST as (name, value);
    - file parts land in FILES as (field, filename, size) — file BYTES
      are never made matchable (CRS matches FILES/FILES_NAMES only);
    - strict_error: malformed framing CRS 922110-shape rules key on
      (missing/invalid boundary parameter, part without terminating
      CRLF, content-disposition missing);
    - unmatched_boundary: body contains what looks like a boundary line
      that does not match the declared boundary (CRS 922120 shape)."""
    m = re.search(r'boundary="?([^";,]{1,256})"?', content_type, re.I)
    if not m:
        return [], [], 1, 0
    boundary = m.group(1).encode("latin-1", "replace")
    delim = b"--" + boundary
    args: list[tuple[bytes, bytes]] = []
    files: list[tuple[str, bytes, int]] = []
    strict = 0
    unmatched = 0

    segments = body.split(delim)
    if len(segments) < 2 or not body.rstrip(b"\r\n ").endswith(delim + b"--"):
        strict = 1
    for seg in segments[1:]:
        if seg.startswith(b"--"):
            break  # closing delimiter
        if not seg.startswith(b"\r\n") and not seg.startswith(b"\n"):
            strict = 1
            continue
        part = seg.lstrip(b"\r\n")
        head, sep, content = part.partition(b"\r\n\r\n")
        if not sep:
            head, sep, content = part.partition(b"\n\n")
            if not sep:
                strict = 1
                continue
        content = content[:-2] if content.endswith(b"\r\n") else content.rstrip(b"\n")
        hm = re.search(
            rb'content-disposition\s*:\s*form-data\s*;([^\r\n]*)', head, re.I
        )
        if not hm:
            strict = 1
            continue
        disp = hm.group(1)
        nm = re.search(rb'name="([^"]*)"', disp)
        fm = re.search(rb'filename="([^"]*)"', disp)
        name = nm.group(1) if nm else b""
        if not nm:
            strict = 1
        if fm is not None:
            files.append(
                (name.decode("latin-1", "replace"), fm.group(1), len(content))
            )
        else:
            args.append((name, content))
    # Boundary-looking lines inside the body that are not the declared
    # boundary (evasion probe: smuggle a second boundary). Only lines that
    # could actually BE a delimiter count (ADVICE r3: '--' + RFC 2046
    # bchars token, no interior spaces, at least one alphanumeric) — a PEM
    # header ('-----BEGIN CERTIFICATE-----'), a markdown rule, or prose
    # starting with '--' in a form field must not trip CRS 922120.
    for line in body.split(b"\n"):
        line = line.strip(b"\r")
        if (
            len(line) > 4
            and _BOUNDARY_CANDIDATE.fullmatch(line)
            and re.search(rb"[0-9A-Za-z]", line[2:])
            and not line.startswith(delim)
        ):
            unmatched = 1
            break
    return args, files, strict, unmatched


class TargetExtractor:
    """Extracts targets/numerics for one compiled ruleset."""

    def __init__(self, crs: CompiledRuleSet):
        self.crs = crs
        self.vocab = crs.vocab
        self.body_access = crs.program.request_body_access
        self.body_limit = crs.program.request_body_limit
        self.response_body_access = crs.program.response_body_access
        self.response_body_limit = crs.program.response_body_limit

    def extract(
        self,
        req: HttpRequest,
        phase1_only: bool = False,
        response: HttpResponse | None = None,
    ) -> Extraction:
        """Extract match targets.

        ``phase1_only`` is the data plane's early-phase pass (reference
        SURVEY §3.4: phase 1 decides on headers *before* the body is
        read): the request body is never touched — no body parse, no
        ARGS_POST, no REQUEST_BODY/FULL_REQUEST body bytes — so a
        phase-1 deny short-circuits body ingest entirely.

        ``response`` adds the phase-3/4 collections (RESPONSE_STATUS,
        RESPONSE_HEADERS[_NAMES], STATUS_LINE, RESPONSE_BODY gated by
        ``SecResponseBodyAccess``/``SecResponseBodyLimit``)."""
        targets: list[ExtractedTarget] = []
        body = b"" if phase1_only else req.body[: self.body_limit]
        reqbody_error = 0

        args_get = _parse_pairs(req.query_string)
        args_post: list[tuple[bytes, bytes]] = []
        files: list[tuple[str, bytes, int]] = []  # (field, filename, size)
        multipart_strict_error = 0
        multipart_unmatched_boundary = 0
        processor = ""
        if self.body_access and body:
            ctype = (req.header("content-type") or "").lower()
            if "json" in ctype:
                processor = "JSON"
                try:
                    _flatten_json(json.loads(body.decode("utf-8", "replace")), "json", args_post)
                except (ValueError, RecursionError):
                    reqbody_error = 1
            elif "multipart/form-data" in ctype:
                processor = "MULTIPART"
                (
                    args_post,
                    files,
                    multipart_strict_error,
                    multipart_unmatched_boundary,
                ) = _parse_multipart(req.header("content-type") or "", body)
                if multipart_strict_error:
                    reqbody_error = 1
            elif "x-www-form-urlencoded" in ctype or not ctype:
                processor = "URLENCODED"
                args_post = _parse_pairs(body.decode("latin-1", "replace"))

        def add(collection: str, name: str | None, value: bytes) -> None:
            targets.append(ExtractedTarget(collection, name, value))

        for k, v in args_get:
            kn = k.decode("latin-1", "replace")
            add("ARGS", kn, v)
            add("ARGS_GET", kn, v)
            add("ARGS_NAMES", kn, k)
            add("ARGS_GET_NAMES", kn, k)
        for k, v in args_post:
            kn = k.decode("latin-1", "replace")
            add("ARGS", kn, v)
            add("ARGS_POST", kn, v)
            add("ARGS_NAMES", kn, k)
            add("ARGS_POST_NAMES", kn, k)

        for field_name, filename, _size in files:
            add("FILES", field_name, filename)
            add("FILES_NAMES", field_name, field_name.encode("latin-1", "replace"))

        for hk, hv in req.headers:
            add("REQUEST_HEADERS", hk, hv.encode("latin-1", "replace"))
            add("REQUEST_HEADERS_NAMES", hk, hk.encode("latin-1", "replace"))
        cookie = req.header("cookie")
        if cookie:
            for part in cookie.split(";"):
                name, _, value = part.strip().partition("=")
                add("REQUEST_COOKIES", name, value.encode("latin-1", "replace"))
                add("REQUEST_COOKIES_NAMES", name, name.encode("latin-1", "replace"))

        status_line = b""
        response_body = b""
        response_status = 0
        if response is not None:
            response_status = response.status
            status_line = f"{response.version} {response.status}".encode(
                "latin-1", "replace"
            )
            for hk, hv in response.headers:
                add("RESPONSE_HEADERS", hk, hv.encode("latin-1", "replace"))
                add("RESPONSE_HEADERS_NAMES", hk, hk.encode("latin-1", "replace"))
            if self.response_body_access:
                response_body = response.body[: self.response_body_limit]

        path = req.path
        basename = path.rsplit("/", 1)[-1]
        request_line = f"{req.method} {req.uri} {req.version}"
        full_request = (
            request_line
            + "\r\n"
            + "".join(f"{k}: {v}\r\n" for k, v in req.headers)
            + "\r\n"
        ).encode("latin-1", "replace") + body

        scalars: dict[str, bytes] = {
            "REQUEST_URI": req.uri.encode("latin-1", "replace"),
            "REQUEST_URI_RAW": req.uri.encode("latin-1", "replace"),
            "REQUEST_FILENAME": path.encode("latin-1", "replace"),
            "REQUEST_BASENAME": basename.encode("latin-1", "replace"),
            "REQUEST_LINE": request_line.encode("latin-1", "replace"),
            "REQUEST_METHOD": req.method.encode("latin-1", "replace"),
            "REQUEST_PROTOCOL": req.version.encode("latin-1", "replace"),
            "QUERY_STRING": req.query_string.encode("latin-1", "replace"),
            "REQUEST_BODY": body if self.body_access else b"",
            "FULL_REQUEST": full_request,
            "PATH_INFO": b"",
            "REMOTE_ADDR": req.remote_addr.encode("latin-1", "replace"),
            "SERVER_NAME": (req.header("host") or "").encode("latin-1", "replace"),
            "STATUS_LINE": status_line,
            "RESPONSE_BODY": response_body,
            "AUTH_TYPE": b"",
            "REQBODY_PROCESSOR": processor.encode("ascii"),
        }
        for name, value in scalars.items():
            if (name, None) in self.vocab.kinds:
                add(name, None, value)

        args_combined = sum(len(k) + len(v) for k, v in args_get + args_post)
        numeric_values = {
            "REQUEST_BODY_LENGTH": len(body),
            "REQBODY_ERROR": reqbody_error,
            "MULTIPART_STRICT_ERROR": multipart_strict_error,
            "MULTIPART_UNMATCHED_BOUNDARY": multipart_unmatched_boundary,
            "ARGS_COMBINED_SIZE": args_combined,
            "FULL_REQUEST_LENGTH": len(full_request),
            "FILES_COMBINED_SIZE": sum(size for _, _, size in files),
            "RESPONSE_STATUS": response_status,
            "DURATION": 0,
        }
        # Numeric scalars used with string operators appear as byte targets.
        for name, value in numeric_values.items():
            if (name, None) in self.vocab.kinds:
                add(name, None, str(value).encode("ascii"))

        numerics: dict[tuple, int] = {}
        for key, _nv in self.crs.numvars.vars.items():
            if key[0] == "scalar":
                numerics[key] = numeric_values.get(key[1], 0)
            elif key[0] == "hostop":
                # Host-evaluated operator bit (e.g. @detectSQLi via the
                # libinjection-architecture detector): OR over this rule's
                # targets after its host transform pipeline.
                numerics[key] = self._eval_hostop(key, targets)
            else:  # ('count', collection, selector)
                _, coll, sel = key
                count = 0
                for t in targets:
                    if t.collection != coll:
                        continue
                    if sel is None or (t.name or "").lower() == sel:
                        count += 1
                numerics[key] = count
        return Extraction(targets=targets, numerics=numerics)

    def _eval_hostop(self, key: tuple, targets: list[ExtractedTarget]) -> int:
        from ..compiler.sqli import is_sqli
        from ..compiler.xss import is_xss
        from ..compiler.transforms_host import apply_pipeline

        _, opname, pipeline, include, exclude = key
        inc = set(include)
        exc = set(exclude)
        for t in targets:
            kinds = set(self.kind_ids(t))
            if not (kinds & inc) or (kinds & exc):
                continue
            value = apply_pipeline(t.value, list(pipeline))
            if opname == "sqli" and is_sqli(value)[0]:
                return 1
            if opname == "xss" and is_xss(value):
                return 1
        return 0

    def kind_ids(self, target: ExtractedTarget) -> list[int]:
        """All kind ids this target belongs to (generic, exact selector, and
        every matching regex selector). The batcher packs three per tensor
        row and duplicates rows for overflow, so a name matching several
        regex selectors stays visible to every rule."""
        coll = target.collection
        kinds: list[int] = []
        if coll in COLLECTIONS:
            generic = self.vocab.lookup(coll, None)
            if generic:
                kinds.append(generic)
            if target.name:
                exact = self.vocab.lookup(coll, target.name)
                if exact:
                    kinds.append(exact)
                name_b = target.name.encode("latin-1", "replace")
                for dfa, kid in self.vocab.regex_kinds_for(coll):
                    if dfa.search(name_b):
                        kinds.append(kid)
            return kinds
        # Scalars: single exact kind.
        if coll in SCALARS or coll in NUMERIC_SCALARS:
            kid = self.vocab.lookup(coll, None)
            if kid:
                kinds.append(kid)
        return kinds
