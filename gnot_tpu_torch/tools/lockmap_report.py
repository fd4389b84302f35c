"""Emit the port's lock map: every lock, every ordering edge, zero cycles.

Port of ``tools/lockmap_report.py`` over the port's tree. The GL008 pass
(``gnot_tpu_torch/analysis/lockorder.py``) builds the project-wide
acquires-while-holding graph to gate on cycles; this publishes the same
graph in JAX's record shapes, so a locking change is read by diffing
the map instead of re-deriving the ordering discipline from source.

Record shapes (one JSON object per line, ``record`` discriminates):

* ``{"record": "node", "lock", "kind", "file", "line", "module",
  "class"}`` — one per lock identity (``Class.attr`` /
  ``module.name`` / ``module.fn.name``).
* ``{"record": "edge", "held", "acquired", "witness": [...]}`` — one
  per ordering edge; ``witness`` is the ``file:line`` hop chain from
  the outer acquisition to the inner one (call-mediated hops carry
  ``(inside callee)`` markers).
* ``{"record": "summary", "schema": 1, "locks", "edges", "cycles",
  "census": {module: lock count}}`` — last line; ``cycles`` is a list
  (``[]`` when cycle-free), so a regression shows in the map itself.

Usage::

    python -m gnot_tpu_torch.tools.lockmap_report                 # stdout
    python -m gnot_tpu_torch.tools.lockmap_report --out build/lockmap.jsonl

The files are the port lint's default paths (``gnot_tpu_torch``,
``chip_smoke.py``) under ``--root``. Exit status: 0 when cycle-free, 1
when any cycle exists.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from gnot_tpu_torch.analysis.core import FileContext, LintConfig, iter_python_files
from gnot_tpu_torch.analysis.lockorder import build_lock_graph

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def lockmap_lines(root: str) -> tuple[list[str], int]:
    """The map's lines (no trailing newline each) and the cycle count —
    separated from main() so tests can call it in-process."""
    cfg = LintConfig()
    paths = [p for p in cfg.paths if os.path.exists(os.path.join(root, p))]
    contexts = []
    for rel in iter_python_files(paths, root, cfg):
        try:
            with open(os.path.join(root, rel), encoding="utf-8") as f:
                source = f.read()
        except OSError:
            continue
        contexts.append(FileContext(root, rel, source, cfg))
    nodes, edges, cycles = build_lock_graph(contexts)

    lines: list[str] = []
    for lock in sorted(nodes):
        lines.append(json.dumps({"record": "node", "lock": lock, **nodes[lock]}))
    for held, acquired in sorted(edges):
        lines.append(
            json.dumps(
                {
                    "record": "edge",
                    "held": held,
                    "acquired": acquired,
                    "witness": edges[(held, acquired)],
                }
            )
        )
    census: dict[str, int] = {}
    for meta in nodes.values():
        census[meta["module"]] = census.get(meta["module"], 0) + 1
    lines.append(
        json.dumps(
            {
                "record": "summary",
                "schema": 1,
                "locks": len(nodes),
                "edges": len(edges),
                "cycles": cycles,
                "census": dict(sorted(census.items())),
            }
        )
    )
    return lines, len(cycles)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=_REPO_ROOT)
    ap.add_argument(
        "--out", default="", help="write here instead of stdout"
    )
    args = ap.parse_args(argv)

    lines, n_cycles = lockmap_lines(args.root)
    text = "\n".join(lines) + "\n"
    if args.out:
        with open(args.out, "w", encoding="utf-8") as f:
            f.write(text)
    else:
        sys.stdout.write(text)
    if n_cycles:
        print(f"lockmap: {n_cycles} cycle(s) — NOT shippable", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
