"""GL010 — config drift: dataclass knobs vs CLI flags vs docs.

The JAX package's rule (``gnot_tpu/analysis/config_drift.py``) in the
port's form. JAX wires its config through one ``"train.<field>"``
mapping in ``config_from_args``; the port builds its configs with
keyword calls, ``TrainConfig(epochs=args.epochs, ...)`` in
``main.py::train_config`` and ``ServeConfig(...)`` in
``configs_from_args``. The rule reads those calls; its checks stay
JAX's, project-wide and AST-only (registries are *parsed*, never
imported):

* every field of a configured dataclass is a keyword of a call to it in
  the CLI module, or is named in ``LintConfig.config_unwired``;
* every keyword of such a call names a real field;
* every ``args.<flag>`` a keyword's value reads is a declared
  ``--<flag>``;
* every field is mentioned in at least one configured doc — as a
  backticked code token (`` `field` ``) or as its flag spelling
  (``--flag``, fenced command lines count).

Suppressions anchor at the field's declaration line in the config
module (unwired, undocumented) or at the keyword's line in the CLI
module (ghost keyword, undeclared flag).
"""

from __future__ import annotations

import ast
import os
import re

from gnot_tpu_torch.analysis.core import (
    FileContext,
    Finding,
    ProjectContext,
    Rule,
    register,
    terminal_name,
)


def _dataclass_fields(tree: ast.Module, class_name: str) -> dict[str, int]:
    """``field -> declaration line`` for one dataclass, by AST."""
    for node in tree.body:
        if isinstance(node, ast.ClassDef) and node.name == class_name:
            return {
                st.target.id: st.lineno
                for st in node.body
                if isinstance(st, ast.AnnAssign)
                and isinstance(st.target, ast.Name)
            }
    return {}


def _declared_flags(tree: ast.Module) -> set[str]:
    """Flag names from every ``*.add_argument("--name", ...)``."""
    out: set[str] = set()
    for node in ast.walk(tree):
        if not (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr == "add_argument"
        ):
            continue
        for a in node.args:
            if (
                isinstance(a, ast.Constant)
                and isinstance(a.value, str)
                and a.value.startswith("--")
            ):
                out.add(a.value[2:])
    return out


def _config_calls(
    tree: ast.Module, sections: dict[str, str]
) -> dict[str, tuple[int, set[str]]]:
    """``"section.field" -> (line, {args attributes read})`` from every
    keyword of a call to a configured dataclass (``sections`` maps class
    name -> section prefix), wherever the CLI module makes it."""
    out: dict[str, tuple[int, set[str]]] = {}
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        prefix = sections.get(terminal_name(node.func))
        if prefix is None:
            continue
        for kw in node.keywords:
            if kw.arg is None:
                continue  # **kwargs: nothing to check by name
            refs = {
                n.attr
                for n in ast.walk(kw.value)
                if isinstance(n, ast.Attribute)
                and isinstance(n.value, ast.Name)
                and n.value.id == "args"
            }
            key = f"{prefix}.{kw.arg}"
            if key in out:
                line, seen = out[key]
                out[key] = (line, seen | refs)
            else:
                out[key] = (kw.lineno, refs)
    return out


def _parse_module(root: str, rel: str) -> ast.Module | None:
    try:
        with open(os.path.join(root, rel), encoding="utf-8") as f:
            return ast.parse(f.read(), filename=rel)
    except (OSError, SyntaxError):
        return None


def _doc_mentions(root: str, docs: list[str]) -> str:
    chunks = []
    for rel in docs:
        try:
            with open(os.path.join(root, rel), encoding="utf-8") as f:
                chunks.append(f.read())
        except OSError:
            pass
    return "\n".join(chunks)


def _documented(field: str, flags: set[str], corpus: str) -> bool:
    """Mentioned as a code token: `` `field` `` (optionally dotted or
    ``--``-prefixed inside the backticks) or a ``--flag`` occurrence —
    fenced command lines count, bare prose does not."""
    toks = {field} | flags
    for tok in toks:
        if re.search(rf"`(--|[\w.]+\.)?{re.escape(tok)}[`@ =]", corpus):
            return True
        if re.search(rf"(^|[^\w-])--{re.escape(tok)}\b", corpus):
            return True
    return False


@register
class ConfigDrift(Rule):
    id = "GL010"
    title = "config-drift"
    hint = (
        "pass the field to its config call in main.py (add_argument + "
        "a keyword reading args.<flag>) and mention it in the configured "
        "docs (README.md's port section for a port-only knob) — or name "
        "it in LintConfig.config_unwired with a reason, or delete the "
        "dead knob"
    )

    def check_project(self, project: ProjectContext) -> list[Finding]:
        cfg = project.config
        cfg_path = os.path.join(project.root, cfg.config_module)
        cli_path = os.path.join(project.root, cfg.cli_module)
        if not (os.path.exists(cfg_path) and os.path.exists(cli_path)):
            return []  # fixture trees without a config surface
        cfg_tree = _parse_module(project.root, cfg.config_module)
        cli_tree = _parse_module(project.root, cfg.cli_module)
        if cfg_tree is None or cli_tree is None:
            return []  # unparseable files already carry a GL000
        sections: list[tuple[str, str]] = []
        for spec in cfg.config_sections:
            prefix, _, cls = spec.partition(":")
            if prefix and cls:
                sections.append((prefix, cls))
        # The configured files' FileContexts, for suppression anchoring.
        by_path = {c.path: c for c in project.contexts}
        cfg_ctx = by_path.get(cfg.config_module)
        cli_ctx = by_path.get(cfg.cli_module)

        flags = _declared_flags(cli_tree)
        calls = _config_calls(cli_tree, {cls: prefix for prefix, cls in sections})
        unwired = set(cfg.config_unwired)
        corpus = _doc_mentions(project.root, cfg.docs_config)
        findings: list[Finding] = []

        def emit(ctx: FileContext | None, path: str, line: int, msg: str):
            if ctx is not None and ctx.is_suppressed(self.id, line):
                return
            findings.append(
                Finding(
                    rule=self.id, path=path, line=line, message=msg,
                    hint=self.hint,
                )
            )

        all_fields: set[str] = set()
        for prefix, cls in sections:
            fields = _dataclass_fields(cfg_tree, cls)
            if not fields:
                # The class is configured but has no parseable annotated
                # fields: every check below would be vacuous — say so.
                emit(
                    cfg_ctx,
                    cfg.config_module,
                    1,
                    f"config section {prefix!r}: dataclass {cls} has no "
                    "parseable annotated fields — GL010 cannot check "
                    "its CLI/docs wiring",
                )
                continue
            for field, line in sorted(fields.items(), key=lambda kv: kv[1]):
                key = f"{prefix}.{field}"
                all_fields.add(key)
                wired = calls.get(key)
                field_flags: set[str] = set()
                if wired is None:
                    if key not in unwired:
                        emit(
                            cfg_ctx,
                            cfg.config_module,
                            line,
                            f"config field {key} has no CLI wiring in "
                            f"{cfg.cli_module} (no {cls}({field}=...) "
                            "keyword) and is not named as unwired",
                        )
                else:
                    _, refs = wired
                    field_flags = refs & flags
                    for ref in sorted(refs - flags):
                        emit(
                            cli_ctx,
                            cfg.cli_module,
                            wired[0],
                            f"{cls}({field}=...) reads args.{ref} "
                            f"but no --{ref} flag is declared",
                        )
                if not _documented(field, field_flags, corpus):
                    emit(
                        cfg_ctx,
                        cfg.config_module,
                        line,
                        f"config field {key} is not documented in any "
                        f"of {', '.join(cfg.docs_config)} (mention "
                        f"`{field}` or its --flag)",
                    )
        for key, (line, _) in sorted(calls.items()):
            if key not in all_fields:
                emit(
                    cli_ctx,
                    cfg.cli_module,
                    line,
                    f"config keyword {key!r} does not match any "
                    f"field of the configured dataclasses in "
                    f"{cfg.config_module}",
                )
        return findings
