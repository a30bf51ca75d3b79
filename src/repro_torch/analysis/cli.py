"""``python -m repro_torch.analysis`` — run the invariant linter.

::

    PYTHONPATH=src python -m repro_torch.analysis                 # full sweep
    PYTHONPATH=src python -m repro_torch.analysis --rules obs-guard,wall-clock
    PYTHONPATH=src python -m repro_torch.analysis --format json
    PYTHONPATH=src python -m repro_torch.analysis --list-rules
    PYTHONPATH=src python -m repro_torch.analysis path/to/file.py

Exit status: 0 on a clean tree, 1 when any finding survives
suppression, 2 on a bad invocation (unknown rule, unreadable path).
Stdlib-only: it imports neither torch nor numpy.  The JSON report has the
reference linter's ``kind`` and ``version``, so a tool reads either alike.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
from typing import List, Optional

from repro_torch.analysis.core import (AnalysisError, analyze, default_root,
                                 rule_names, rules)

JSON_SCHEMA_VERSION = 1


def _parse_rules(arg: Optional[str]) -> Optional[List[str]]:
    if arg is None:
        return None
    return [r.strip() for r in arg.split(",") if r.strip()]


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="AST-based invariant linter for the repro_torch tree "
                    "(determinism, bit-identity, zero-overhead "
                    "contracts).")
    ap.add_argument("paths", nargs="*",
                    help="files to scan (default: every *.py under "
                         "--root)")
    ap.add_argument("--root", default=None,
                    help="scan root (default: the installed "
                         "repro_torch package source tree)")
    ap.add_argument("--rules", default=None, metavar="R1,R2",
                    help="comma-separated rule subset (default: all)")
    ap.add_argument("--format", default="text", choices=("text", "json"))
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule catalog and exit")
    args = ap.parse_args(argv)

    if args.list_rules:
        catalog = rules()
        for name in sorted(catalog):
            print(f"{name}: {catalog[name].description}")
        return 0

    root = pathlib.Path(args.root) if args.root else default_root()
    paths = [pathlib.Path(p) for p in args.paths] or None
    try:
        if paths:
            missing = [str(p) for p in paths if not p.is_file()]
            if missing:
                raise AnalysisError(f"no such file: {missing}")
        findings, n_files = analyze(root=root,
                                    rule_filter=_parse_rules(args.rules),
                                    paths=paths)
    except AnalysisError as err:
        print(f"error: {err}", file=sys.stderr)
        return 2

    active = _parse_rules(args.rules) or rule_names()
    if args.format == "json":
        print(json.dumps({
            "kind": "repro.analysis.report",
            "version": JSON_SCHEMA_VERSION,
            "root": str(root),
            "rules": list(active),
            "files_scanned": n_files,
            "n_findings": len(findings),
            "findings": [f.to_dict() for f in findings],
        }, indent=2))
    else:
        for f in findings:
            print(f.format(root=str(root)))
        print(f"# repro_torch.analysis: {len(findings)} finding"
              f"{'s' if len(findings) != 1 else ''} over {n_files} "
              f"files ({len(active)} rules)")
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
