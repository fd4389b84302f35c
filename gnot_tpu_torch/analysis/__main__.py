"""``python -m gnot_tpu_torch.analysis``: lint the port.

Usage::

    python -m gnot_tpu_torch.analysis                       # the port's paths
    python -m gnot_tpu_torch.analysis gnot_tpu_torch/serve --rules GL004,GL009
    python -m gnot_tpu_torch.analysis --format json         # one JSON document

Exit status, as ``tools/lint.py``'s: 0 when clean, 1 when any finding
survives its suppressions, 2 on a usage error. The default paths and
every rule knob are ``LintConfig``'s defaults (``core.py``); ``--rules``
narrows the run to a comma-separated subset.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from gnot_tpu_torch.analysis import RULES, LintConfig, run_analysis

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m gnot_tpu_torch.analysis", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    parser.add_argument("paths", nargs="*", default=[],
                        help="files or directories to analyze (default: the port's)")
    parser.add_argument("--format", choices=("text", "json"), default="text",
                        help="findings as human-readable lines or one JSON document")
    parser.add_argument("--rules", default="",
                        help="comma-separated rule ids to run (default: all)")
    parser.add_argument("--root", default=_REPO_ROOT,
                        help="repo root the paths and registries are relative to")
    try:
        args = parser.parse_args(argv)
    except SystemExit as e:
        return 0 if e.code == 0 else 2
    root = os.path.abspath(args.root)
    config = LintConfig()
    if args.rules:
        config.enable = [r.strip().upper() for r in args.rules.split(",") if r.strip()]
        unknown = sorted(set(config.enable) - set(RULES))
        if unknown:
            print(f"graftlint: unknown rule id(s) {', '.join(unknown)}; "
                  f"this package has {', '.join(sorted(RULES))}", file=sys.stderr)
            return 2
    paths = args.paths or list(config.paths)
    for p in paths:
        if not os.path.exists(p if os.path.isabs(p) else os.path.join(root, p)):
            print(f"graftlint: no such path: {p}", file=sys.stderr)
            return 2
    findings, stats = run_analysis(paths, root=root, config=config)
    if args.format == "json":
        print(json.dumps({"findings": [f.to_dict() for f in findings], "stats": stats},
                         indent=2))
    else:
        for f in findings:
            print(f.format())
        print(f"graftlint: {len(findings)} finding(s) in {stats['files']} file(s) "
              f"({stats['suppressed']} suppressed; rules: {', '.join(stats['rules'])})")
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
