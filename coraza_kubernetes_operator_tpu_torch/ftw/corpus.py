"""crs-lite corpus loading: setup-first file ordering + SecDataDir.

The reference pipeline concatenates the CRS base config before the rule
files (``hack/generate_coreruleset_configmaps.py`` embeds it, the
Makefile orders ``crs-setup`` first); plain lexicographic globbing would
put ``REQUEST-*.conf`` before ``crs-setup.conf`` and break compile-time
threshold resolution."""

from __future__ import annotations

from pathlib import Path

_HERE = Path(__file__).resolve().parents[2] / "ftw" / "rules"
CRS_LITE_DIR = _HERE / "crs-lite"


def load_ruleset_text(root: str | Path = CRS_LITE_DIR) -> str:
    """Concatenate a CRS-layout rules directory: ``crs-setup.conf`` (and
    any other non-rule config) first, then REQUEST-*/RESPONSE-* rule
    files in CRS order (request families, then response families, as
    the numeric prefixes already encode); SecDataDir pinned to the
    corpus ``data/`` directory."""
    root = Path(root)

    def is_rule_file(p: Path) -> bool:
        return p.name.startswith(("REQUEST-", "RESPONSE-"))

    setup = sorted(p for p in root.glob("*.conf") if not is_rule_file(p))
    # (family, name) keeps a deterministic total order even when one
    # family spans multiple .conf files — rule order matters for
    # setvar/anomaly accumulation.
    rules = sorted((p for p in root.glob("*.conf") if is_rule_file(p)),
                   key=lambda p: (p.name.split("-", 2)[1], p.name))
    parts = [f"SecDataDir {root / 'data'}"]
    for path in setup + rules:
        parts.append(path.read_text())
    return "\n".join(parts)
