"""GL004 — lock discipline for annotated shared state.

The JAX package's rule (``gnot_tpu/analysis/locks.py``), unchanged, over
the port. The serving layer shares mutable counters and the published weight
reference between the client thread (``submit``/``reload``/``drain``),
the worker thread, and reload callers. The convention: a field declared
with a ``#: guarded_by <lock>`` annotation comment

.. code-block:: python

    self._completed = 0  #: guarded_by _lock

may only be touched inside a ``with self.<lock>`` block. The rule reads
the annotation comments straight from the source lines (the AST drops
comments), then checks every ``self.<attr>`` load/store in the class.

Exemptions: ``__init__`` (the object is not shared while it is being
constructed) and the annotated declaration lines themselves. Anything
else — including "it's only read" accesses: torn reads of a dict or
list during a concurrent resize are real — must hold the lock or carry
a justified ``# graftlint: disable=GL004 — reason`` suppression.
"""

from __future__ import annotations

import ast
import re

from gnot_tpu_torch.analysis.core import FileContext, Finding, Rule, register

_GUARD_RE = re.compile(r"#:\s*guarded_by\s+(\w+)")


@register
class LockDiscipline(Rule):
    id = "GL004"
    title = "lock-discipline"
    hint = (
        "wrap the access in `with self.<lock>:` (or move it into an "
        "existing locked block); if the access is provably "
        "single-threaded, suppress with a justification"
    )

    def check_file(self, ctx: FileContext) -> list[Finding]:
        findings: list[Finding] = []
        for cls in ast.walk(ctx.tree):
            if isinstance(cls, ast.ClassDef):
                findings.extend(self._check_class(ctx, cls))
        return findings

    def _check_class(self, ctx: FileContext, cls: ast.ClassDef) -> list[Finding]:
        guarded, decl_lines = self._guarded_attrs(ctx, cls)
        if not guarded:
            return []
        findings: list[Finding] = []
        for method in cls.body:
            if not isinstance(method, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if method.name == "__init__":
                continue  # not shared during construction
            for node in ast.walk(method):
                if not (
                    isinstance(node, ast.Attribute)
                    and isinstance(node.value, ast.Name)
                    and node.value.id == "self"
                    and node.attr in guarded
                ):
                    continue
                if node.lineno in decl_lines:
                    continue
                lock = guarded[node.attr]
                if self._under_lock(ctx, node, lock):
                    continue
                access = (
                    "written" if isinstance(node.ctx, ast.Store) else "read"
                )
                findings.append(
                    Finding(
                        rule=self.id,
                        path=ctx.path,
                        line=node.lineno,
                        message=(
                            f"`self.{node.attr}` (guarded_by {lock}) "
                            f"{access} outside `with self.{lock}` in "
                            f"`{cls.name}.{method.name}`"
                        ),
                        hint=self.hint,
                    )
                )
        return findings

    def _guarded_attrs(
        self, ctx: FileContext, cls: ast.ClassDef
    ) -> tuple[dict[str, str], set[int]]:
        """``{attr: lock_name}`` from ``#: guarded_by`` comments on (or
        immediately above) ``self.<attr> = ...`` lines, plus the
        declaration line numbers (exempt from the check)."""
        guarded: dict[str, str] = {}
        decl_lines: set[int] = set()
        for node in ast.walk(cls):
            targets: list[ast.AST] = []
            if isinstance(node, ast.Assign):
                targets = node.targets
            elif isinstance(node, ast.AnnAssign):
                targets = [node.target]
            for t in targets:
                if not (
                    isinstance(t, ast.Attribute)
                    and isinstance(t.value, ast.Name)
                    and t.value.id == "self"
                ):
                    continue
                lock = self._annotation_at(ctx, t.lineno)
                if lock is not None:
                    guarded[t.attr] = lock
                    decl_lines.add(t.lineno)
        return guarded, decl_lines

    @staticmethod
    def _annotation_at(ctx: FileContext, lineno: int) -> str | None:
        line = ctx.lines[lineno - 1] if lineno <= len(ctx.lines) else ""
        m = _GUARD_RE.search(line)
        if m:
            return m.group(1)
        prev = ctx.lines[lineno - 2].strip() if lineno >= 2 else ""
        if prev.startswith("#:"):
            m = _GUARD_RE.search(prev)
            if m:
                return m.group(1)
        return None

    @staticmethod
    def _under_lock(ctx: FileContext, node: ast.AST, lock: str) -> bool:
        for anc in ctx.ancestors(node):
            if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef)):
                return False  # don't credit an outer function's lock
            if isinstance(anc, ast.With):
                for item in anc.items:
                    e = item.context_expr
                    if (
                        isinstance(e, ast.Attribute)
                        and isinstance(e.value, ast.Name)
                        and e.value.id == "self"
                        and e.attr == lock
                    ):
                        return True
        return False
