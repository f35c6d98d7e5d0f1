"""Loader for go-ftw YAML test files and override ledgers.

Port of ``coraza_kubernetes_operator_tpu/ftw/loader.py``, with the same
normalisation. Supports both corpus generations found in OWASP CRS
regression tests:

- legacy: ``tests: [{test_title: "942100-1", stages: [{stage: {input:
  {...}, output: {...}}}]}]``
- current: ``rule_id: 942100`` + ``tests: [{test_id: 1, stages:
  [{input: {...}, output: {status: 403, log: {expect_ids: [...]}}}]}]``

Output assertions normalized to: expected status list, expect/no-expect
rule ids, and log_contains / no_log_contains regexes matched against raw
audit-log lines.

Where the documents come from: a file under one of the repo's mirrored
``ftw/`` inputs (``ftw/tests``, ``ftw/tests-crs-lite``, ``ftw/ftw.yml``)
is read from its JSON mirror (``ftw/data/``, written by ``ftw/mirror.py``),
which must match the
YAML file's bytes; any other file is parsed with ``pyyaml``. With neither
a mirror nor ``pyyaml`` the loader raises and names the mirror's
generator: it never returns an empty corpus for want of a parser. A file
the mirror records as unparsable raises ``FtwFormatError`` (``pyyaml``
raises its own ``YAMLError``); ``load_tests_report`` skips and reports
both.
"""

from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass, field
from pathlib import Path

from ..utils import get_logger

log = get_logger("ftw.loader")

FTW_DIR = Path(__file__).resolve().parents[2] / "ftw"
DATA_DIR = Path(__file__).resolve().parent / "data"
GENERATOR = "python -m coraza_kubernetes_operator_tpu_torch.ftw.mirror"
# What is mirrored: directories of test files, and the ledger.
CORPORA = ("tests", "tests-crs-lite")
LEDGER = "ftw.yml"


def mirror_path(source: Path) -> Path:
    """The mirror file of ``source`` (a directory or file under ``ftw/``)."""
    rel = source.resolve().relative_to(FTW_DIR)
    return DATA_DIR / (str(rel).replace("/", "__").removesuffix(".yml") + ".json")


def yaml_files(root: Path) -> list[Path]:
    """Every YAML file under ``root`` in the loader's order, ``ftw.yml``
    ledgers excluded."""
    paths = sorted(root.rglob("*.yaml")) + sorted(root.rglob("*.yml"))
    return [p for p in paths if p.name != LEDGER]


def sha256(path: Path) -> str:
    return hashlib.sha256(path.read_bytes()).hexdigest()


@dataclass
class FtwStage:
    method: str = "GET"
    uri: str = "/"
    version: str = "HTTP/1.1"
    headers: list[tuple[str, str]] = field(default_factory=list)
    data: bytes = b""
    # First-party extension for response phases 3/4: go-ftw can only
    # observe responses produced by a real backend, so CRS response-rule
    # tests normally need a live echo server. In-process we inject the
    # upstream response directly: `input.response: {status, headers,
    # data}`. None = request-only stage (standard go-ftw semantics).
    response_status: int | None = None
    response_headers: list[tuple[str, str]] = field(default_factory=list)
    response_data: bytes = b""
    # assertions
    status: list[int] = field(default_factory=list)
    expect_ids: list[int] = field(default_factory=list)
    no_expect_ids: list[int] = field(default_factory=list)
    log_contains: str | None = None
    no_log_contains: str | None = None


@dataclass
class FtwTest:
    title: str  # e.g. "942100-1"
    rule_id: int | None
    description: str = ""
    stages: list[FtwStage] = field(default_factory=list)
    source: str = ""  # file it came from


class FtwFormatError(ValueError):
    pass


class MirrorStaleError(RuntimeError):
    """A mirrored YAML input changed since its mirror was generated."""


# -- documents ---------------------------------------------------------------

_MIRRORS: dict[Path, dict] = {}


def _mirror(source: Path) -> dict | None:
    """The parsed mirror of a mirrored source, or None when absent."""
    target = mirror_path(source)
    if target not in _MIRRORS:
        if not target.exists():
            return None
        _MIRRORS[target] = json.loads(target.read_text())
    return _MIRRORS[target]


def _covering(path: Path) -> tuple[Path, str] | None:
    """(mirrored source, key in its mirror) for a file under a mirrored
    input, else None."""
    path = path.resolve()
    ledger = FTW_DIR / LEDGER
    if path == ledger:
        return ledger, LEDGER
    for name in CORPORA:
        root = FTW_DIR / name
        if path.is_relative_to(root) and path != root:
            return root, str(path.relative_to(root))
    return None


def _stale(source: Path, what: str) -> MirrorStaleError:
    return MirrorStaleError(
        f"the JSON mirror of {source} is stale ({what}); regenerate it with `{GENERATOR}`"
    )


def _yaml():
    try:
        import yaml
    except ImportError:
        return None
    return yaml


def _read_document(path: Path):
    """The ``yaml.safe_load`` document of one file, from its mirror when
    one covers it, else parsed with ``pyyaml``."""
    cov = _covering(path)
    mirror = _mirror(cov[0]) if cov is not None else None
    if mirror is not None:
        entry = mirror.get(cov[1])
        if entry is None:
            raise _stale(cov[0], f"{cov[1]} is not in it")
        if entry["sha256"] != sha256(path):
            raise _stale(cov[0], f"{cov[1]} changed")
        if "error" in entry:
            raise FtwFormatError(f"{path}: not valid YAML: {entry['error']}")
        return entry["doc"]
    yaml = _yaml()
    if yaml is None:
        raise RuntimeError(
            f"{path}: no JSON mirror covers it and pyyaml is not installed; "
            f"mirror the repo's ftw inputs with `{GENERATOR}`"
        )
    return yaml.safe_load(path.read_text())


def _parse_errors() -> tuple[type[Exception], ...]:
    yaml = _yaml()
    return (FtwFormatError,) if yaml is None else (FtwFormatError, yaml.YAMLError)


# -- normalisation -----------------------------------------------------------


def _as_bytes(data) -> bytes:
    if data is None:
        return b""
    if isinstance(data, bytes):
        return data
    if isinstance(data, str):
        return data.encode("utf-8", "replace")
    if isinstance(data, list):  # go-ftw joins list lines with \r\n
        return "\r\n".join(str(x) for x in data).encode("utf-8", "replace")
    return str(data).encode()


def _parse_stage(obj: dict, source: str) -> FtwStage:
    if "stage" in obj:  # legacy nesting
        obj = obj["stage"]
    inp = obj.get("input", {}) or {}
    out = obj.get("output", {}) or {}

    headers = inp.get("headers", {}) or {}
    if isinstance(headers, dict):
        header_list = [(str(k), str(v)) for k, v in headers.items()]
    else:
        header_list = [(str(k), str(v)) for k, v in headers]

    status = out.get("status", [])
    if status is None:
        status = []
    if isinstance(status, int):
        status = [status]
    status = [int(s) for s in status]

    log = out.get("log", {}) or {}
    expect_ids = [int(x) for x in (log.get("expect_ids") or [])]
    no_expect_ids = [int(x) for x in (log.get("no_expect_ids") or [])]

    resp = inp.get("response") or {}
    resp_headers = resp.get("headers", {}) or {}
    if isinstance(resp_headers, dict):
        resp_header_list = [(str(k), str(v)) for k, v in resp_headers.items()]
    else:
        resp_header_list = [(str(k), str(v)) for k, v in resp_headers]

    return FtwStage(
        method=str(inp.get("method", "GET")),
        uri=str(inp.get("uri", "/")),
        version=str(inp.get("version", "HTTP/1.1")),
        headers=header_list,
        data=_as_bytes(inp.get("data")),
        response_status=int(resp["status"]) if "status" in resp else (
            200 if resp else None
        ),
        response_headers=resp_header_list,
        response_data=_as_bytes(resp.get("data")),
        status=status,
        expect_ids=expect_ids,
        no_expect_ids=no_expect_ids,
        log_contains=out.get("log_contains") or log.get("match_regex"),
        no_log_contains=out.get("no_log_contains") or log.get("no_match_regex"),
    )


def load_test_file(path: str | Path) -> list[FtwTest]:
    path = Path(path)
    doc = _read_document(path)
    if not isinstance(doc, dict) or "tests" not in doc:
        raise FtwFormatError(f"{path}: not a go-ftw test file (no 'tests' key)")
    file_rule_id = doc.get("rule_id")
    meta = doc.get("meta", {}) or {}
    tests: list[FtwTest] = []
    for t in doc["tests"] or []:
        title = t.get("test_title")
        if title is None:
            if file_rule_id is None or t.get("test_id") is None:
                raise FtwFormatError(
                    f"{path}: test needs test_title or rule_id+test_id"
                )
            title = f"{file_rule_id}-{t['test_id']}"
        rule_id = file_rule_id
        if rule_id is None:
            head = str(title).split("-", 1)[0]
            rule_id = int(head) if head.isdigit() else None
        stages = [_parse_stage(s, str(path)) for s in t.get("stages", [])]
        tests.append(
            FtwTest(
                title=str(title),
                rule_id=rule_id,
                description=t.get("desc", meta.get("description", "")) or "",
                stages=stages,
                source=str(path),
            )
        )
    return tests


def _check_file_set(root: Path, paths: list[Path]) -> None:
    """A mirror covering ``root`` must list exactly its YAML files."""
    cov = _covering(root / "_")
    mirror = _mirror(cov[0]) if cov is not None else None
    if mirror is None:
        return
    prefix = "" if root.resolve() == cov[0] else str(root.resolve().relative_to(cov[0])) + "/"
    listed = {k for k in mirror if k.startswith(prefix)}
    present = {_covering(p)[1] for p in paths}
    if listed != present:
        raise _stale(cov[0], f"files {sorted(listed ^ present)[:5]} differ")


def load_tests_report(root: str | Path) -> tuple[list[FtwTest], list[str]]:
    """Recursively load every go-ftw test file under ``root``. Returns
    ``(tests, skipped_paths)``: files that are not ftw test files (no
    ``tests`` key, or unparsable) are skipped — a stray fixture must not
    abort the whole conformance run — but each skip is logged and reported
    so a corrupted file can't silently shrink the corpus."""
    root = Path(root)
    tests: list[FtwTest] = []
    skipped: list[str] = []
    paths = yaml_files(root)
    _check_file_set(root, paths)
    errors = _parse_errors()
    for path in paths:
        try:
            tests.extend(load_test_file(path))
        except errors as err:
            skipped.append(str(path))
            log.error("skipping unparsable ftw test file", err, path=str(path))
    return tests, skipped


def load_tests(root: str | Path) -> list[FtwTest]:
    """``load_tests_report`` without the skip report."""
    return load_tests_report(root)[0]


def load_overrides(path: str | Path) -> dict[str, str]:
    """The known-failure ledger: {test title: reason} (go-ftw
    ``testoverride.ignore`` shape, reference ``ftw/ftw.yml``)."""
    doc = _read_document(Path(path)) or {}
    ignore = (doc.get("testoverride") or {}).get("ignore") or {}
    return {str(k): str(v) for k, v in ignore.items()}
