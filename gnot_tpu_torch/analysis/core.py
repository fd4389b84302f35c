"""The port's lint framework: rule registry, per-file runner, suppressions.

The part of ``gnot_tpu/analysis/core.py`` that the rules with a torch
subject need (GL004, GL005, GL007-GL010): no donation call graph, which
only the JAX package's GL001/GL006 use. Pure stdlib (``ast`` + ``re``):
the analysis reads source, never imports the code under test.

Suppressions (the JAX package's grammar, ``docs/static_analysis.md``):

* ``# graftlint: disable=GL004`` on the offending line silences that
  rule there (comma-separate several ids; append ``— reason`` — every
  committed suppression must carry one).
* ``# graftlint: disable-file=GL005`` anywhere in a file silences the
  rule for the whole file.

The configuration lives in code (:class:`LintConfig`'s defaults point at
the port), not in ``pyproject.toml``, whose ``[tool.graftlint]`` block
configures the JAX package's lint.
"""

from __future__ import annotations

import ast
import dataclasses
import fnmatch
import io
import os
import re
import tokenize
from typing import Iterable

#: Rule-id grammar: GL + digits (or "all"). The capture is anchored to
#: id tokens so a trailing justification — with or without a dash —
#: is never swallowed into the id list.
_IDS = r"(?:[A-Za-z]+\d+|all|ALL)(?:\s*,\s*(?:[A-Za-z]+\d+|all|ALL))*"
_SUPPRESS_RE = re.compile(rf"#\s*graftlint:\s*disable=({_IDS})")
_SUPPRESS_FILE_RE = re.compile(rf"#\s*graftlint:\s*disable-file=({_IDS})")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation, anchored to ``file:line`` with a fix hint.

    ``project_level`` marks findings from a rule's cross-file pass
    (GL005 registry/docs drift, GL007, GL008, GL010): they are caused by
    the tree as a whole, not by the file they are anchored in."""

    rule: str  # "GL001"
    path: str  # repo-relative
    line: int
    message: str
    hint: str = ""
    project_level: bool = False

    def format(self) -> str:
        s = f"{self.path}:{self.line}: {self.rule} {self.message}"
        if self.hint:
            s += f" [hint: {self.hint}]"
        return s

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class LintConfig:
    """Per-run configuration; the defaults are the port's.

    ``enable``/``disable`` select rules by id; ``exclude`` drops files
    whose repo-relative path matches any glob (or contains it as a
    substring). Rule-specific knobs carry their rule id in the name.
    Each ``docs_*`` knob is a list of files: a kind or field counts as
    documented when any of them mentions it (the JAX package's pages,
    read and never edited, plus ``README.md``, whose port section
    documents what only the port has).
    """

    enable: list[str] = dataclasses.field(default_factory=list)  # [] = all
    disable: list[str] = dataclasses.field(default_factory=list)
    exclude: list[str] = dataclasses.field(default_factory=lambda: ["build/"])
    # Default scan roots for the CLI (no positional paths) and the
    # port-tree-clean test.
    paths: list[str] = dataclasses.field(
        default_factory=lambda: ["gnot_tpu_torch", "chip_smoke.py"]
    )
    # GL005: registry + docs locations (repo-relative).
    events_registry: str = "gnot_tpu_torch/obs/events.py"
    faults_registry: str = "gnot_tpu_torch/resilience/faults.py"
    messages_registry: str = "gnot_tpu_torch/serve/federation.py"
    docs_events: list[str] = dataclasses.field(
        default_factory=lambda: ["docs/observability.md", "README.md"]
    )
    docs_faults: list[str] = dataclasses.field(
        default_factory=lambda: ["docs/robustness.md", "README.md"]
    )
    docs_messages: list[str] = dataclasses.field(
        default_factory=lambda: ["docs/serving.md", "README.md"]
    )
    # GL007: the ctypes bindings module and the C source whose
    # extern "C" declarations it must match (arity + dtype tags).
    native_binding: str = "gnot_tpu_torch/native/__init__.py"
    native_source: str = "gnot_tpu_torch/native/ragged_pack.cpp"
    # GL009: terminal names of project callables known to block for
    # "long" (dispatch/IO scale, not counter-bump scale) — calling one
    # inside a held-lock region wedges every sibling thread. A trailing
    # "*" makes the entry a prefix match ("infer*" covers infer,
    # infer_batch, infer_packed, infer_session).
    slow_callables: list[str] = dataclasses.field(
        default_factory=lambda: [
            "infer*",
            "warmup",
            "save_checkpoint",
            "restore_checkpoint",
            "reload",
        ]
    )
    # GL010: the config dataclasses, the CLI that must wire them, and
    # the docs where every knob must be mentioned.
    config_module: str = "gnot_tpu_torch/config.py"
    cli_module: str = "gnot_tpu_torch/main.py"
    # "<prefix>:<dataclass name>" pairs: every field of the class must be
    # a keyword of a ``<dataclass name>(...)`` call in the CLI module (or
    # be named in ``config_unwired``), and every keyword a real field.
    config_sections: list[str] = dataclasses.field(
        default_factory=lambda: [
            "train:TrainConfig",
            "serve:ServeConfig",
            "optim:OptimConfig",
            "mesh:MeshConfig",
        ]
    )
    # "<prefix>.<field>" keys that no flag reaches by design: AdamW's and
    # the one-cycle schedule's constants, which the reference fixes and
    # neither package's CLI exposes (library callers may set them).
    config_unwired: list[str] = dataclasses.field(
        default_factory=lambda: [
            "optim.b1",
            "optim.b2",
            "optim.eps",
            "optim.weight_decay",
            "optim.grad_clip_norm",
            "optim.pct_start",
            "optim.div_factor",
            "optim.final_div_factor",
        ]
    )
    docs_config: list[str] = dataclasses.field(
        default_factory=lambda: [
            "docs/serving.md",
            "docs/robustness.md",
            "docs/observability.md",
            "README.md",
        ]
    )

    def rule_enabled(self, rule_id: str) -> bool:
        if rule_id in self.disable:
            return False
        return not self.enable or rule_id in self.enable

    def excludes(self, rel_path: str) -> bool:
        rel = rel_path.replace(os.sep, "/")
        return any(
            fnmatch.fnmatch(rel, pat) or pat in rel for pat in self.exclude
        )


class FileContext:
    """One parsed file handed to each rule: tree with parent links,
    raw lines (rules read annotation comments the AST drops), and the
    per-line suppression map."""

    def __init__(
        self,
        root: str,
        rel_path: str,
        source: str,
        config: "LintConfig | None" = None,
    ):
        self.root = root
        self.path = rel_path
        self.source = source
        self.config = config or LintConfig()
        # Back-reference to the run's ProjectContext (set by
        # run_analysis). Rules must degrade gracefully when None.
        self.project: "ProjectContext | None" = None
        self.lines = source.splitlines()
        self.tree = ast.parse(source, filename=rel_path)
        self._parents: dict[ast.AST, ast.AST] = {}
        for node in ast.walk(self.tree):
            for child in ast.iter_child_nodes(node):
                self._parents[child] = node
        self.suppressed: dict[int, set[str]] = {}
        self.file_suppressed: set[str] = set()
        # Real COMMENT tokens only — a docstring merely *documenting*
        # the suppression syntax must not suppress anything.
        for line_no, comment in self._comments(source):
            m = _SUPPRESS_RE.search(comment)
            if m:
                self.suppressed.setdefault(line_no, set()).update(
                    r.strip().upper() for r in m.group(1).split(",") if r.strip()
                )
            m = _SUPPRESS_FILE_RE.search(comment)
            if m:
                self.file_suppressed |= {
                    r.strip().upper() for r in m.group(1).split(",") if r.strip()
                }

    @staticmethod
    def _comments(source: str) -> list[tuple[int, str]]:
        try:
            return [
                (tok.start[0], tok.string)
                for tok in tokenize.generate_tokens(io.StringIO(source).readline)
                if tok.type == tokenize.COMMENT
            ]
        except (tokenize.TokenError, IndentationError):
            # ast.parse succeeded, so this should be unreachable; stay
            # permissive rather than dropping all suppressions.
            return []

    def ancestors(self, node: ast.AST) -> Iterable[ast.AST]:
        cur = self._parents.get(node)
        while cur is not None:
            yield cur
            cur = self._parents.get(cur)

    def is_suppressed(self, rule_id: str, line: int) -> bool:
        if rule_id in self.file_suppressed or "ALL" in self.file_suppressed:
            return True
        rules = self.suppressed.get(line, ())
        return rule_id in rules or "ALL" in rules


class ProjectContext:
    """Cross-file state for the project-level checks (GL005 docs drift,
    GL007, GL008's lock graph, GL010)."""

    def __init__(self, root: str, config: LintConfig):
        self.root = root
        self.config = config
        #: FileContexts of every parsed file in this run (set by
        #: run_analysis before any rule executes).
        self.contexts: list[FileContext] = []


class Rule:
    """Base rule: subclass, set ``id``/``title``, implement
    ``check_file`` (and optionally ``check_project`` for cross-file
    invariants — called once, after every file)."""

    id: str = ""
    title: str = ""
    hint: str = ""

    def check_file(self, ctx: FileContext) -> list[Finding]:
        return []

    def check_project(self, project: ProjectContext) -> list[Finding]:
        return []


#: id -> rule class. Populated by the ``@register`` decorator at import
#: of the rule modules (analysis/__init__ imports them all).
RULES: dict[str, type[Rule]] = {}


def register(cls: type[Rule]) -> type[Rule]:
    if not cls.id or cls.id in RULES:
        raise ValueError(f"bad or duplicate rule id: {cls.id!r}")
    RULES[cls.id] = cls
    return cls


def iter_python_files(paths: list[str], root: str, config: LintConfig):
    """Yield repo-relative .py paths under ``paths`` (files or dirs),
    honoring ``config.exclude``. Deterministic order."""
    seen = []
    for p in paths:
        full = p if os.path.isabs(p) else os.path.join(root, p)
        if os.path.isfile(full):
            seen.append(os.path.relpath(full, root))
            continue
        for dirpath, dirnames, filenames in os.walk(full):
            dirnames.sort()
            for name in sorted(filenames):
                if name.endswith(".py"):
                    seen.append(
                        os.path.relpath(os.path.join(dirpath, name), root)
                    )
    return [rel for rel in seen if not config.excludes(rel)]


def run_analysis(
    paths: list[str],
    *,
    root: str,
    config: LintConfig | None = None,
) -> tuple[list[Finding], dict]:
    """Run every enabled rule over every python file under ``paths``.

    Returns ``(findings, stats)`` where stats counts files scanned and
    suppressions honored. Findings are sorted by (path, line, rule).
    A file that fails to parse yields a synthetic ``GL000`` finding
    instead of crashing the run (the lint gate must report, not die).
    """
    config = config or LintConfig()
    rules = [
        cls() for rid, cls in sorted(RULES.items()) if config.rule_enabled(rid)
    ]
    findings: list[Finding] = []
    n_suppressed = 0
    files = iter_python_files(paths, root, config)
    # Phase 1 — parse everything: the project-level passes (GL008's
    # lock graph) need every file's tree.
    contexts: list[FileContext] = []
    for rel in files:
        try:
            with open(os.path.join(root, rel), encoding="utf-8") as f:
                contexts.append(FileContext(root, rel, f.read(), config))
        except (OSError, SyntaxError, UnicodeDecodeError, ValueError) as err:
            findings.append(
                Finding(
                    rule="GL000",
                    path=rel,
                    line=getattr(err, "lineno", 0) or 0,
                    message=f"could not analyze file: {err}",
                    hint="fix the syntax error or exclude the file",
                )
            )
    # Phase 2 — project context, then the per-file rules.
    project = ProjectContext(root, config)
    project.contexts = contexts
    for ctx in contexts:
        ctx.project = project
        for rule in rules:
            for f in rule.check_file(ctx):
                if ctx.is_suppressed(f.rule, f.line):
                    n_suppressed += 1
                else:
                    findings.append(f)
    for rule in rules:
        findings.extend(
            dataclasses.replace(f, project_level=True)
            for f in rule.check_project(project)
        )
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    stats = {
        "files": len(files),
        "rules": [r.id for r in rules],
        "suppressed": n_suppressed,
        "findings": len(findings),
    }
    return findings, stats


# -- shared AST helpers (used by several rules) ----------------------------


def dotted_name(node: ast.AST) -> str:
    """Best-effort dotted name of a call target: ``subprocess.run`` ->
    "subprocess.run"; unresolvable pieces become ``?``."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        return f"{dotted_name(node.value)}.{node.attr}"
    return "?"


def terminal_name(node: ast.AST) -> str:
    """Final attribute/name of a call target (``self.train_step`` ->
    "train_step")."""
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return ""
