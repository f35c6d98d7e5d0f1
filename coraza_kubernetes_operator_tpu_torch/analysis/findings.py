"""Structured analysis findings shared by rulelint and jaxlint.

A finding is one diagnosed fact with a stable code, a severity, and an
identity key — the reload gate compares keys across ruleset versions, so
two analyses of the same document must produce identical keys (the
analyzer sorts its output and dedupes on key).
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field

SEV_ERROR = "error"
SEV_WARN = "warn"
SEV_INFO = "info"

_SEV_RANK = {SEV_ERROR: 0, SEV_WARN: 1, SEV_INFO: 2}


@dataclass(frozen=True)
class Finding:
    """One diagnosed fact about a ruleset (or about our own source)."""

    code: str  # stable id, e.g. "CKO-R002"
    severity: str  # error | warn | info
    message: str
    rule_id: int | None = None  # Seclang rule id, when attributable
    location: str = ""  # file:line (jaxlint) or directive context
    detail: str = ""  # free-form elaboration (not part of the key)

    @property
    def key(self) -> tuple:
        """Identity for cross-version comparison (the reload gate's "new
        error" test). ``detail`` is excluded so cosmetic elaboration
        changes never read as a fresh finding."""
        return (self.code, self.rule_id, self.location, self.message)

    def to_json(self) -> dict:
        return {
            "code": self.code,
            "severity": self.severity,
            "message": self.message,
            "rule_id": self.rule_id,
            "location": self.location,
            "detail": self.detail,
        }

    def render(self) -> str:
        where = f" rule {self.rule_id}" if self.rule_id is not None else ""
        loc = f" [{self.location}]" if self.location else ""
        tail = f" ({self.detail})" if self.detail else ""
        return f"{self.severity.upper():5s} {self.code}{where}{loc}: {self.message}{tail}"


@dataclass
class AnalysisReport:
    """Sorted, deduped findings plus the TPU-coverage summary."""

    findings: list[Finding] = field(default_factory=list)
    # Coverage summary (rulelint only): how much of the document actually
    # runs on-device vs. skipped/approximated/const-folded.
    coverage: dict = field(default_factory=dict)

    def add(self, finding: Finding) -> None:
        self.findings.append(finding)

    def finalize(self) -> "AnalysisReport":
        """Dedupe by key (keeping the first occurrence) and sort so equal
        inputs always produce byte-identical reports."""
        seen: set[tuple] = set()
        out: list[Finding] = []
        for f in self.findings:
            if f.key in seen:
                continue
            seen.add(f.key)
            out.append(f)
        out.sort(
            key=lambda f: (
                _SEV_RANK.get(f.severity, 9),
                f.code,
                f.rule_id if f.rule_id is not None else -1,
                f.location,
                f.message,
            )
        )
        self.findings = out
        return self

    # -- aggregation ---------------------------------------------------------

    def by_severity(self, severity: str) -> list[Finding]:
        return [f for f in self.findings if f.severity == severity]

    @property
    def errors(self) -> list[Finding]:
        return self.by_severity(SEV_ERROR)

    @property
    def warnings(self) -> list[Finding]:
        return self.by_severity(SEV_WARN)

    def counts(self) -> dict[str, int]:
        out = {SEV_ERROR: 0, SEV_WARN: 0, SEV_INFO: 0}
        for f in self.findings:
            out[f.severity] = out.get(f.severity, 0) + 1
        return out

    def error_keys(self) -> set[tuple]:
        return {f.key for f in self.errors}

    def findings_for(self, rule_id: int) -> list[Finding]:
        return [f for f in self.findings if f.rule_id == rule_id]

    # -- rendering -----------------------------------------------------------

    def to_json(self) -> dict:
        return {
            "counts": self.counts(),
            "findings": [f.to_json() for f in self.findings],
            "coverage": self.coverage,
        }

    def render(self) -> str:
        lines = [f.render() for f in self.findings]
        c = self.counts()
        lines.append(
            f"-- {c[SEV_ERROR]} error(s), {c[SEV_WARN]} warning(s), "
            f"{c[SEV_INFO]} info"
        )
        if self.coverage:
            cov = self.coverage
            if "total_rules" in cov:
                lines.append(
                    "-- tpu coverage: "
                    f"{cov.get('device_rules', 0)}/{cov.get('total_rules', 0)} rules on-device "
                    f"({cov.get('coverage_pct', 0.0):.1f}%), "
                    f"{cov.get('skipped_rules', 0)} skipped, "
                    f"{cov.get('approximated_rules', 0)} approximated, "
                    f"{cov.get('const_eliminated', 0)} const-eliminated"
                )
            else:
                # Non-rulelint reports (e.g. nativelint) carry their own
                # coverage shape — render it generically.
                lines.append(
                    "-- coverage: "
                    + ", ".join(f"{k}={cov[k]}" for k in sorted(cov))
                )
        return "\n".join(lines)

    def dumps(self, indent: int | None = None) -> str:
        return json.dumps(self.to_json(), indent=indent, sort_keys=True)
