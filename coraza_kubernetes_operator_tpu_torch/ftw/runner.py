"""Conformance replayer: drive loaded ftw tests against the WAF.

Port of ``coraza_kubernetes_operator_tpu/ftw/runner.py`` over the port's
``WafEngine`` (on the card unless built with ``device="cpu"``) and its
sidecar.

Two targets, mirroring how the reference runs go-ftw against a live
gateway while unit tiers run in-process (SURVEY §4):

- **in-process**: each stage is evaluated directly on a ``WafEngine``;
  the audit line is synthesized with the same ``AuditLogger`` the sidecar
  uses, so log assertions exercise the real serialization.
- **HTTP**: each stage is sent to a live gpu-engine sidecar (filter
  mode); audit lines are read from the sidecar's audit-log file — the
  shape of the reference's ftw/run.py pod-log streaming.

Pass criteria per stage: expected status (if asserted) AND expected /
forbidden rule ids in the audit line AND log_contains / no_log_contains
regexes. A test passes when every stage passes. Tests in the override
ledger are reported ``ignored`` and never fail the run.
"""

from __future__ import annotations

import io
import json
import re
import time
from dataclasses import dataclass, field
from pathlib import Path

from ..compiler.ruleset import CompiledRuleSet
from ..engine.request import HttpRequest
from ..engine.waf import WafEngine
from ..observability.audit import AuditLogger, AuditRecord
from ..utils import get_logger
from .loader import FtwStage, FtwTest, load_overrides, load_tests_report

log = get_logger("ftw.runner")


@dataclass
class StageOutcome:
    passed: bool
    reason: str = ""


@dataclass
class FtwResult:
    passed: list[str] = field(default_factory=list)
    failed: dict[str, str] = field(default_factory=dict)  # title -> reason
    ignored: dict[str, str] = field(default_factory=dict)  # title -> ledger reason
    skipped_files: list[str] = field(default_factory=list)  # unparsable corpus files

    @property
    def ok(self) -> bool:
        # A run with zero executed tests (or any unparsable corpus file) is
        # not green: a fully-corrupted corpus must not gate CI to pass.
        ran_any = bool(self.passed or self.failed or self.ignored)
        return not self.failed and not self.skipped_files and ran_any

    def summary(self) -> dict:
        return {
            "passed": len(self.passed),
            "failed": len(self.failed),
            "ignored": len(self.ignored),
            "skipped_files": len(self.skipped_files),
            "failures": self.failed,
        }


def _stage_request(stage: FtwStage) -> HttpRequest:
    return HttpRequest(
        method=stage.method,
        uri=stage.uri,
        version=stage.version,
        headers=stage.headers,
        body=stage.data,
        remote_addr="127.0.0.1",
    )


def _ids_in_line(line: str) -> set[int]:
    ids: set[int] = set()
    try:
        doc = json.loads(line)
        for m in doc.get("transaction", {}).get("messages", []):
            rid = m.get("details", {}).get("ruleId")
            if rid and str(rid).isdigit():
                ids.add(int(rid))
    except (ValueError, AttributeError):
        pass
    # fallback: grep id "NNN" escaped or raw
    for m in re.finditer(r'id \\?"(\d+)\\?"', line):
        ids.add(int(m.group(1)))
    return ids


def check_stage(stage: FtwStage, status: int, audit_lines: list[str]) -> StageOutcome:
    if stage.status and status not in stage.status:
        return StageOutcome(False, f"status {status} not in {stage.status}")
    joined = "\n".join(audit_lines)
    seen: set[int] = set()
    for line in audit_lines:
        seen |= _ids_in_line(line)
    for rid in stage.expect_ids:
        if rid not in seen:
            return StageOutcome(False, f"rule {rid} not in audit log (saw {sorted(seen)})")
    for rid in stage.no_expect_ids:
        if rid in seen:
            return StageOutcome(False, f"forbidden rule {rid} in audit log")
    if stage.log_contains and not re.search(stage.log_contains, joined):
        return StageOutcome(False, f"log_contains {stage.log_contains!r} not found")
    if stage.no_log_contains and re.search(stage.no_log_contains, joined):
        return StageOutcome(False, f"no_log_contains {stage.no_log_contains!r} found")
    return StageOutcome(True)


class FtwRunner:
    """Replays tests against an in-process engine or a live sidecar."""

    def __init__(
        self,
        engine: WafEngine | None = None,
        base_url: str | None = None,
        audit_log_path: str | None = None,
        overrides: dict[str, str] | None = None,
    ):
        if (engine is None) == (base_url is None):
            raise ValueError("exactly one of engine / base_url required")
        self.engine = engine
        self.base_url = base_url.rstrip("/") if base_url else None
        self.audit_log_path = audit_log_path
        self.overrides = overrides or {}

    # -- stage execution ----------------------------------------------------

    def _stage_outcome_from_verdict(
        self, stage: FtwStage, req, verdict
    ) -> tuple[int, list[str]]:
        """Resolve a stage's observed status + synthesized audit lines
        from an already-computed request-phase verdict (response-phase
        stages run phases 3/4 here for request survivors)."""
        assert self.engine is not None
        if stage.response_status is not None:
            # Response-phase stage (loader extension): the request phases
            # ran first (an interrupted request never reaches upstream);
            # survivors evaluate phases 3/4 against the injected upstream
            # response. Observed status: request verdict if interrupted,
            # else response verdict if interrupted, else the upstream
            # status passes through.
            from ..engine.request import HttpResponse

            if not verdict.interrupted:
                verdict = self.engine.evaluate_response(
                    req,
                    HttpResponse(
                        status=stage.response_status,
                        headers=list(stage.response_headers),
                        body=stage.response_data,
                    ),
                )
            passthrough = stage.response_status
        else:
            passthrough = 200
        buf = io.StringIO()
        logger = AuditLogger(stream=buf, relevant_only=False)
        meta = self.engine.rule_meta
        logger.log(
            AuditRecord(
                request_line=f"{req.method} {req.uri} {req.version}",
                client=req.remote_addr,
                status=verdict.status,
                interrupted=verdict.interrupted,
                matched=[meta.get(r, {"id": r}) for r in verdict.matched_ids],
            )
        )
        status = verdict.status if verdict.interrupted else passthrough
        return status, buf.getvalue().splitlines()

    def _run_stage_inproc(self, stage: FtwStage) -> tuple[int, list[str]]:
        assert self.engine is not None
        req = _stage_request(stage)
        verdict = self.engine.evaluate_one(req)
        return self._stage_outcome_from_verdict(stage, req, verdict)

    def _run_stage_http(self, stage: FtwStage) -> tuple[int | None, list[str]]:
        """Returns (status, audit lines); status None = transport failure
        (always a test failure — a dead target must not pass
        negative-assertion-only tests vacuously)."""
        assert self.base_url is not None
        mark = 0
        audit = Path(self.audit_log_path) if self.audit_log_path else None
        if audit is not None and audit.exists():
            mark = audit.stat().st_size
        # http.client directly: go-ftw corpora use repeated header names
        # (e.g. duplicate Cookie), which a dict-based API would collapse.
        import http.client
        from urllib.parse import urlsplit

        parts = urlsplit(self.base_url)
        try:
            conn = http.client.HTTPConnection(
                parts.hostname, parts.port or 80, timeout=30
            )
            conn.putrequest(
                stage.method, stage.uri, skip_host=True, skip_accept_encoding=True
            )
            has_host = any(k.lower() == "host" for k, _ in stage.headers)
            if not has_host:
                conn.putheader("Host", parts.netloc)
            for k, v in stage.headers:
                conn.putheader(k, v)
            if stage.data and not any(
                k.lower() == "content-length" for k, _ in stage.headers
            ):
                conn.putheader("Content-Length", str(len(stage.data)))
            conn.endheaders()
            if stage.data:
                conn.send(stage.data)
            resp = conn.getresponse()
            status: int | None = resp.status
            resp.read()
            conn.close()
        except OSError as err:
            # Connection refused/reset (target down): fail this test, but
            # keep the run going for the remaining corpus.
            log.error("stage request failed", err, uri=stage.uri)
            return None, []
        lines: list[str] = []
        if audit is not None:
            # the sidecar flushes per line; small settle loop for batching
            for _ in range(50):
                if audit.exists() and audit.stat().st_size > mark:
                    break
                time.sleep(0.01)
            if audit.exists():
                with open(audit, encoding="utf-8") as fh:
                    fh.seek(mark)
                    lines = fh.read().splitlines()
        return status, lines

    # -- test execution -----------------------------------------------------

    def run(self, tests: list[FtwTest]) -> FtwResult:
        # In-process mode batch-evaluates every stage's REQUEST phases in
        # one engine.evaluate() call first: row-level tiering makes the
        # verdicts identical to per-stage evaluation (a documented
        # invariant, held by tests), and the corpus runs as one window
        # of a handful of tier shapes instead of one window per stage.
        batch: dict[int, object] = {}
        if self.engine is not None:
            reqs = []
            keys = []
            for test in tests:
                if test.title in self.overrides:
                    continue
                for i, stage in enumerate(test.stages):
                    reqs.append(_stage_request(stage))
                    keys.append((test.title, i))
            if reqs:
                verdicts = self.engine.evaluate(reqs)
                batch = {
                    key: (req, v) for key, req, v in zip(keys, reqs, verdicts)
                }

        result = FtwResult()
        for test in tests:
            if test.title in self.overrides:
                result.ignored[test.title] = self.overrides[test.title]
                continue
            failure = None
            ignored_reason = None
            for i, stage in enumerate(test.stages):
                if self.engine is not None:
                    req, verdict = batch[(test.title, i)]
                    status, lines = self._stage_outcome_from_verdict(
                        stage, req, verdict
                    )
                else:
                    if stage.response_status is not None:
                        # Response injection needs the in-process engine;
                        # a live backend produces its own responses, so
                        # running the request alone would assert nothing
                        # about the response rules (or pass vacuously).
                        ignored_reason = (
                            "response-injection stage requires in-process mode"
                        )
                        break
                    status, lines = self._run_stage_http(stage)
                if status is None:
                    failure = f"stage {i}: transport failure (target unreachable)"
                    break
                outcome = check_stage(stage, status, lines)
                if not outcome.passed:
                    failure = f"stage {i}: {outcome.reason}"
                    break
            if ignored_reason is not None:
                result.ignored[test.title] = ignored_reason
            elif failure is None:
                result.passed.append(test.title)
            else:
                result.failed[test.title] = failure
                log.info("ftw test failed", test=test.title, reason=failure)
        return result


def run_corpus(
    corpus_dir: str | Path,
    rules: str | CompiledRuleSet,
    overrides_path: str | Path | None = None,
    device=None,
) -> FtwResult:
    """Convenience: compile ``rules`` (Seclang text, or an already
    compiled ruleset to reuse a shared compile), load every test under
    ``corpus_dir`` and replay in-process honoring the ledger, on
    ``device`` (the card unless the caller passes ``device="cpu"``)."""
    overrides = load_overrides(overrides_path) if overrides_path else {}
    runner = FtwRunner(engine=WafEngine(rules, device=device), overrides=overrides)
    tests, skipped = load_tests_report(corpus_dir)
    result = runner.run(tests)
    result.skipped_files = skipped
    return result
