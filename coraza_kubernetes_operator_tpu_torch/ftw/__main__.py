"""Conformance runner CLI: the repo's ``ftw/run.py`` for the port.

Replays a go-ftw corpus either in-process (compile the rules, evaluate on
the card, or on the CPU with ``--device cpu``) or against a live
gpu-engine sidecar over HTTP with audit-log matching.

Usage::

  python -m coraza_kubernetes_operator_tpu_torch.ftw        # bundled corpus, in-proc
  python -m coraza_kubernetes_operator_tpu_torch.ftw --corpus DIR --rules a.conf b.conf
  python -m coraza_kubernetes_operator_tpu_torch.ftw --mode http \\
      --url http://127.0.0.1:9090 --audit-log /var/log/waf-audit.log

Exit code 0 iff no non-ignored test failed. Prints one JSON summary line.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from .loader import FTW_DIR


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m coraza_kubernetes_operator_tpu_torch.ftw",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--corpus", default=str(FTW_DIR / "tests"))
    ap.add_argument(
        "--rules",
        nargs="*",
        default=[str(FTW_DIR / "rules" / "base.conf"), str(FTW_DIR / "rules" / "crs-mini.conf")],
        help="Seclang files compiled in order (in-proc mode)",
    )
    ap.add_argument("--overrides", default=str(FTW_DIR / "ftw.yml"))
    ap.add_argument("--mode", choices=("inproc", "http"), default="inproc")
    ap.add_argument("--url", default="http://127.0.0.1:9090")
    ap.add_argument("--audit-log", default=None, help="sidecar audit log path (http mode)")
    ap.add_argument("--device", default="cuda", help="the engine's device (in-proc mode)")
    args = ap.parse_args(argv)

    from .loader import load_overrides, load_tests_report
    from .runner import FtwRunner

    overrides = load_overrides(args.overrides) if Path(args.overrides).exists() else {}
    tests, skipped_files = load_tests_report(args.corpus)
    if args.mode == "inproc":
        from ..engine import WafEngine

        rules = "\n".join(Path(p).read_text() for p in args.rules)
        runner = FtwRunner(engine=WafEngine(rules, device=args.device), overrides=overrides)
    else:
        runner = FtwRunner(
            base_url=args.url, audit_log_path=args.audit_log, overrides=overrides
        )

    result = runner.run(tests)
    result.skipped_files = skipped_files
    print(json.dumps({"mode": args.mode, "tests": len(tests), **result.summary()}))
    return 0 if result.ok else 1


if __name__ == "__main__":
    sys.exit(main())
