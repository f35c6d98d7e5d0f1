"""``cko-analyze`` CLI: ruleset static analysis + torch self-lint +
ctypes ABI lint (port of ``coraza_kubernetes_operator_tpu/cmd/analyze.py``).

Usage::

    python -m coraza_kubernetes_operator_tpu_torch.cmd.analyze <rules...> \
        [--json] [--torchlint] [--native] [--fail-on {error,warn,never}]

Each positional argument is one Seclang document: a ``.conf`` file, a
CRS-layout directory (loaded setup-first via ``ftw.corpus``), or ``-``
for stdin. ``--torchlint`` additionally (or, with no rules given, only)
lints this package's own source for torch hot-path hazards
(analysis/torchlint.py); ``--native`` cross-checks both ctypes ``_ABI``
specs against their ``extern "C"`` definitions: ``native/__init__.py``
against ``native/src/cko_native.cpp``, and ``ops/kernels.py`` against
``csrc/*.cu`` (analysis/nativelint.py). Exit status is 0 when no finding
at or above ``--fail-on`` severity exists, 1 otherwise. Needs no card
and no ``pyyaml``.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from ..analysis import SEV_ERROR, SEV_WARN, analyze_ruleset
from ..analysis.nativelint import lint_kernels, lint_native
from ..analysis.torchlint import lint_package


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="cko-analyze",
        description="Seclang ruleset analyzer + torch hot-path and ABI linter",
    )
    p.add_argument(
        "rules",
        nargs="*",
        help="Seclang documents: .conf files, CRS-layout directories, or -",
    )
    p.add_argument("--json", action="store_true", help="machine-readable output")
    p.add_argument(
        "--torchlint",
        action="store_true",
        help="also lint this package's source for torch hot-path hazards",
    )
    p.add_argument(
        "--native",
        action="store_true",
        help="also cross-check the ctypes ABI specs against the C++ and CUDA exports",
    )
    p.add_argument(
        "--fail-on",
        choices=["error", "warn", "never"],
        default="error",
        help="minimum severity that makes the exit status nonzero",
    )
    return p


def _load_document(arg: str) -> tuple[str, str]:
    """(label, text) for one positional argument."""
    if arg == "-":
        return ("<stdin>", sys.stdin.read())
    path = Path(arg)
    if path.is_dir():
        from ..ftw.corpus import load_ruleset_text

        return (str(path), load_ruleset_text(path))
    return (str(path), path.read_text())


def _failed(counts: dict, fail_on: str) -> bool:
    if fail_on == "never":
        return False
    if fail_on == "warn":
        return counts.get(SEV_ERROR, 0) + counts.get(SEV_WARN, 0) > 0
    return counts.get(SEV_ERROR, 0) > 0


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    if not args.rules and not args.torchlint and not args.native:
        build_parser().error(
            "give at least one rules document, --torchlint, or --native"
        )

    out: dict[str, dict] = {}
    failed = False
    for arg in args.rules:
        label, text = _load_document(arg)
        report = analyze_ruleset(text)
        out[label] = report.to_json()
        failed = failed or _failed(report.counts(), args.fail_on)
        if not args.json:
            print(f"== rulelint {label}")
            print(report.render())
    if args.torchlint:
        report = lint_package()
        out["<torchlint>"] = report.to_json()
        failed = failed or _failed(report.counts(), args.fail_on)
        if not args.json:
            print("== torchlint coraza_kubernetes_operator_tpu_torch/")
            print(report.render())
    if args.native:
        for key, title, lint in (
            ("<nativelint>", "native/src/cko_native.cpp <-> native/_ABI", lint_native),
            ("<kernellint>", "csrc/*.cu <-> ops/kernels.py::_ABI", lint_kernels),
        ):
            report = lint()
            out[key] = report.to_json()
            failed = failed or _failed(report.counts(), args.fail_on)
            if not args.json:
                print(f"== nativelint {title}")
                print(report.render())
    if args.json:
        print(json.dumps(out, indent=2, sort_keys=True))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
