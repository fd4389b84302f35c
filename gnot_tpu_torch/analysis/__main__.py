"""``python -m gnot_tpu_torch.analysis``: lint the port.

Usage::

    python -m gnot_tpu_torch.analysis                       # the port's paths
    python -m gnot_tpu_torch.analysis gnot_tpu_torch/serve --rules GL004,GL009
    python -m gnot_tpu_torch.analysis --format json         # one JSON document
    python -m gnot_tpu_torch.analysis --changed             # pre-commit: diff-scoped
    python -m gnot_tpu_torch.analysis --update-baseline     # refresh the baseline

Exit status, as ``tools/lint.py``'s: 0 when clean, 1 when any finding
survives its suppressions (with ``--changed``: any finding the baseline
does not cover), 2 on a usage error. The default paths and every rule
knob are ``LintConfig``'s defaults (``core.py``); ``--rules`` narrows the
run to a comma-separated subset.

``--changed`` reports the findings of the files git sees as changed
against ``HEAD`` (staged and unstaged) plus untracked ones, the ``.py``
files under the default paths only; project-level findings (a cross-file
pass: registry and docs drift, the lock order, the ABI, the config
wiring) are reported whatever changed, since an edit elsewhere can cause
them. The analysis itself always covers every default path, so a
cross-file rule still sees the unchanged files. Findings recorded in the
baseline (``gnot_tpu_torch/analysis/baseline.json``) are tolerated,
counted per ``(rule, path)``, as line numbers move under edits; a finding
beyond those counts fails. Without git the mode falls back to a full run.
``--update-baseline`` writes the baseline from a full run of the default
paths and exits 0. The port's tree-clean test keeps the zero-findings
bar, so the baseline masks nothing on this tree.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

from gnot_tpu_torch.analysis import RULES, LintConfig, run_analysis

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BASELINE_PATH = os.path.join("gnot_tpu_torch", "analysis", "baseline.json")


def changed_files(root: str) -> list[str] | None:
    """Repo-relative files changed against ``HEAD`` (staged and unstaged)
    plus untracked ones, every kind of file; None when git cannot say (the
    caller then runs in full, never skips)."""
    out: set[str] = set()
    for args in (["git", "diff", "--name-only", "HEAD", "--"],
                 ["git", "ls-files", "--others", "--exclude-standard"]):
        try:
            proc = subprocess.run(args, cwd=root, capture_output=True, text=True, timeout=30)
        except (OSError, subprocess.TimeoutExpired):
            return None
        if proc.returncode != 0:
            return None
        out.update(line.strip() for line in proc.stdout.splitlines() if line.strip())
    return sorted(out)


def load_baseline(root: str) -> dict[tuple[str, str], int]:
    """``(rule, path) -> tolerated count`` from the baseline; empty when
    it is missing or unreadable (strict by default)."""
    counts: dict[tuple[str, str], int] = {}
    try:
        with open(os.path.join(root, BASELINE_PATH)) as f:
            data = json.load(f)
    except (OSError, json.JSONDecodeError):
        return counts
    for rec in data.get("findings", []):
        key = (rec.get("rule", ""), rec.get("path", ""))
        counts[key] = counts.get(key, 0) + 1
    return counts


def subtract_baseline(findings, baseline: dict) -> tuple[list, int]:
    """The findings the baseline's counts do not cover, and how many it
    masked."""
    remaining = dict(baseline)
    fresh, masked = [], 0
    for f in findings:
        key = (f.rule, f.path)
        if remaining.get(key, 0) > 0:
            remaining[key] -= 1
            masked += 1
        else:
            fresh.append(f)
    return fresh, masked


def write_baseline(root: str, findings) -> str:
    path = os.path.join(root, BASELINE_PATH)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump({"version": 1,
                   "note": ("tolerated findings for python -m gnot_tpu_torch.analysis "
                            "--changed; refresh with --update-baseline. The port's "
                            "tree-clean test stays authoritative."),
                   "findings": [fi.to_dict() for fi in findings]}, f, indent=2)
        f.write("\n")
    return path


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
    parser.add_argument("--changed", action="store_true",
                        help="report only git-changed files; tolerate the baseline's findings")
    parser.add_argument("--update-baseline", action="store_true",
                        help=f"full run over the default paths, write {BASELINE_PATH}, exit 0")
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
    if args.paths and (args.changed or args.update_baseline):
        print("graftlint: --changed/--update-baseline choose their own paths; drop the "
              "positional arguments", file=sys.stderr)
        return 2
    masked = 0
    if args.changed and not args.update_baseline:
        files = changed_files(root)
        scope = None
        if files is None:
            print("graftlint: git unavailable; falling back to a full run", file=sys.stderr)
        elif not files:
            print("graftlint: no changes vs HEAD")
            return 0
        else:
            roots = tuple(p.rstrip("/") + "/" for p in config.paths)
            scope = {f for f in files
                     if f.endswith(".py") and os.path.exists(os.path.join(root, f))
                     and (f.startswith(roots) or f in config.paths)}
        # The whole roots are analyzed: only the report is scoped.
        findings, stats = run_analysis(list(config.paths), root=root, config=config)
        if scope is not None:
            findings = [f for f in findings if f.path in scope or f.project_level]
        findings, masked = subtract_baseline(findings, load_baseline(root))
    else:
        def exists(p: str) -> bool:
            return os.path.exists(p if os.path.isabs(p) else os.path.join(root, p))

        for p in args.paths:
            if not exists(p):
                print(f"graftlint: no such path: {p}", file=sys.stderr)
                return 2
        # A default path the tree lacks is skipped; a named one is an error.
        paths = args.paths or [p for p in config.paths if exists(p)]
        findings, stats = run_analysis(paths, root=root, config=config)
    if args.update_baseline:
        path = write_baseline(root, findings)
        print(f"graftlint: baseline written to {path} ({len(findings)} finding(s))")
        return 0
    if args.format == "json":
        print(json.dumps({"findings": [f.to_dict() for f in findings],
                          "stats": {**stats, "findings": len(findings),
                                    "baseline_masked": masked}}, indent=2))
    else:
        for f in findings:
            print(f.format())
        extra = f", {masked} baseline-masked" if masked else ""
        print(f"graftlint: {len(findings)} finding(s) in {stats['files']} file(s) "
              f"({stats['suppressed']} suppressed{extra}; rules: {', '.join(stats['rules'])})")
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
