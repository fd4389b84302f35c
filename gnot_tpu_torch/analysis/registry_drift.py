"""GL005 — event/fault/wire/span registry drift.

The JAX package's rule (``gnot_tpu/analysis/registry_drift.py``) over
the port's four registries:

* ``gnot_tpu_torch/obs/events.py`` — every event kind a ``MetricsSink``
  record may carry (name, required payload fields, emitting module);
* ``gnot_tpu_torch/obs/events.py::SPANS`` — every tracer span kind
  (``obs/tracing.py`` / ``obs/dtrace.py``);
* ``gnot_tpu_torch/resilience/faults.py::FAULT_KINDS`` — every
  injectable fault kind;
* ``gnot_tpu_torch/serve/federation.py::MESSAGES`` — every federation
  wire message kind (the versioned multi-host protocol).

The rule enforces, per file: every event kind passed to
``sink.log(event=...)`` / ``self._event(...)`` / ``on_event(event=...)``
resolves to an events-registry entry, every wire kind passed to
``wire(X, ...)`` resolves to a MESSAGES entry (string literals and
module-constant references both), and every LITERAL span name passed
to a tracer span site (``span``/``add_span``/``timed_iter``/
``_trace_span``/``_tspan``) resolves to a SPANS entry — in library and
tool code only: tests construct toy spans by design, so ``tests/`` is
exempt from the span-site check (events and wire kinds stay checked
there). Project-wide: every registry entry appears in one of its docs
(``LintConfig.docs_events`` for events AND spans, ``docs_faults`` for
fault kinds, ``docs_messages`` for wire messages: the JAX package's
page and ``README.md``) — the docs are part of the contract.

Registries are read by AST, not import: the linter must not pay a
torch import to check a string table.
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


def _parse_string_constants(tree: ast.AST) -> dict[str, str]:
    """Top-level ``NAME = "value"`` string assignments."""
    out: dict[str, str] = {}
    for node in tree.body if isinstance(tree, ast.Module) else []:
        if (
            isinstance(node, ast.Assign)
            and isinstance(node.value, ast.Constant)
            and isinstance(node.value.value, str)
        ):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    out[t.id] = node.value.value
    return out


def _parse_registry(path: str) -> tuple[dict[str, int], dict[str, str]]:
    """``(kinds, constants)`` from a registry module's source:
    ``kinds`` maps each registered kind to its declaration line —
    EVENTS dict keys, or FAULT_KINDS/KINDS tuple entries — and
    ``constants`` maps module-level constant names to kind strings."""
    try:
        with open(path, encoding="utf-8") as f:
            tree = ast.parse(f.read(), filename=path)
    except (OSError, SyntaxError):
        return {}, {}
    kinds: dict[str, int] = {}
    for node in tree.body:
        if isinstance(node, ast.Assign):
            names = {t.id for t in node.targets if isinstance(t, ast.Name)}
        elif isinstance(node, ast.AnnAssign) and isinstance(
            node.target, ast.Name
        ):
            names = {node.target.id}
        else:
            continue
        if node.value is None:
            continue
        if names & {"EVENTS", "MESSAGES"} and isinstance(
            node.value, ast.Dict
        ):
            for k in node.value.keys:
                if isinstance(k, ast.Constant) and isinstance(k.value, str):
                    kinds[k.value] = k.lineno
        if names & {"FAULT_KINDS", "KINDS"} and isinstance(
            node.value, (ast.Tuple, ast.List)
        ):
            for e in node.value.elts:
                if isinstance(e, ast.Constant) and isinstance(e.value, str):
                    kinds[e.value] = e.lineno
    return kinds, _parse_string_constants(tree)


class _EmitSite:
    __slots__ = ("kind", "line")

    def __init__(self, kind: str, line: int):
        self.kind = kind
        self.line = line


def _emitted_kinds(
    ctx: FileContext, constants: dict[str, str]
) -> list[_EmitSite]:
    """Event kinds this file passes to a sink: ``*.log(event=X)``,
    ``*._event(X, ...)``, ``*.on_event(event=X)``. ``X`` may be a
    string literal, an ``events.<CONST>`` attribute, or a bare
    imported constant name; dynamic values (locals, parameters) are
    skipped — they are checked at their own literal origin."""
    sites: list[_EmitSite] = []

    def resolve(node: ast.AST) -> str | None:
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            return node.value
        name = None
        if isinstance(node, ast.Attribute):
            name = node.attr
        elif isinstance(node, ast.Name):
            name = node.id
        if name is not None and name in constants:
            return constants[name]
        return None

    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        attr = terminal_name(node.func)
        expr: ast.AST | None = None
        if attr in ("log", "on_event"):
            for kw in node.keywords:
                if kw.arg == "event":
                    expr = kw.value
        elif attr == "_event" and node.args:
            expr = node.args[0]
        if expr is None:
            continue
        kind = resolve(expr)
        if kind is not None:
            sites.append(_EmitSite(kind, expr.lineno))
    return sites


def _parse_spans(path: str) -> tuple[dict[str, int], bool]:
    """``(kinds, declared)``: ``SPANS`` literal-dict keys → declaration
    lines from the events registry module, plus whether a top-level
    ``SPANS`` assignment exists at all. Kept separate from
    ``_parse_registry`` on purpose: span kinds are a sibling namespace
    to event kinds, not a subset — merging them would let a span name
    silence a missing-event finding (and vice versa). ``declared``
    distinguishes a registry that predates SPANS (fixture trees:
    the span checks are simply vacuous) from one whose SPANS table
    fails to parse (a loud project finding)."""
    try:
        with open(path, encoding="utf-8") as f:
            tree = ast.parse(f.read(), filename=path)
    except (OSError, SyntaxError):
        return {}, False
    kinds: dict[str, int] = {}
    declared = False
    for node in tree.body:
        if isinstance(node, ast.Assign):
            names = {t.id for t in node.targets if isinstance(t, ast.Name)}
        elif isinstance(node, ast.AnnAssign) and isinstance(
            node.target, ast.Name
        ):
            names = {node.target.id}
        else:
            continue
        if node.value is None or "SPANS" not in names:
            continue
        declared = True
        if isinstance(node.value, ast.Dict):
            for k in node.value.keys:
                if isinstance(k, ast.Constant) and isinstance(k.value, str):
                    kinds[k.value] = k.lineno
    return kinds, declared


# Span-recording call sites and which positional argument carries the
# span NAME. ``span``/``add_span`` take it first; ``timed_iter`` takes
# (iterable, name); the ``_trace_span``/``_tspan`` helpers in
# server.py/trainer.py take (trace, name).
_SPAN_CALLS = {
    "span": 0,
    "add_span": 0,
    "timed_iter": 1,
    "_trace_span": 1,
    "_tspan": 1,
}


def _span_sites(ctx: FileContext) -> list[_EmitSite]:
    """Literal span names this file records via a tracer span site.
    Dynamic names (variables, f-strings) are skipped — they are checked
    at their own literal origin, same as event emit sites."""
    sites: list[_EmitSite] = []
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        pos = _SPAN_CALLS.get(terminal_name(node.func))
        if pos is None or len(node.args) <= pos:
            continue
        expr = node.args[pos]
        if isinstance(expr, ast.Constant) and isinstance(expr.value, str):
            sites.append(_EmitSite(expr.value, expr.lineno))
    return sites


def _wire_sites(ctx: FileContext, constants: dict[str, str]) -> list[_EmitSite]:
    """Wire message kinds this file passes to ``wire(X, ...)`` — the
    federation protocol's frame constructor. ``X`` may be a string literal
    or a module-level constant (``HELLO``/``federation.HELLO``);
    dynamic values are skipped, same as event emit sites."""
    sites: list[_EmitSite] = []
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call) or not node.args:
            continue
        if terminal_name(node.func) != "wire":
            continue
        expr = node.args[0]
        if isinstance(expr, ast.Constant) and isinstance(expr.value, str):
            sites.append(_EmitSite(expr.value, expr.lineno))
            continue
        name = None
        if isinstance(expr, ast.Attribute):
            name = expr.attr
        elif isinstance(expr, ast.Name):
            name = expr.id
        if name is not None and name in constants:
            sites.append(_EmitSite(constants[name], expr.lineno))
    return sites


@register
class RegistryDrift(Rule):
    id = "GL005"
    title = "registry-drift"
    hint = (
        "add the kind to gnot_tpu_torch/obs/events.py (events/SPANS), "
        "resilience/faults.py::FAULT_KINDS (faults) or "
        "serve/federation.py::MESSAGES (wire), and document it in "
        "the configured docs (a kind only the port has: README.md)"
    )

    def __init__(self) -> None:
        self._event_kinds: dict[str, dict[str, int]] = {}
        self._constants: dict[str, dict[str, str]] = {}
        self._msg_kinds: dict[str, dict[str, int]] = {}
        self._msg_constants: dict[str, dict[str, str]] = {}
        self._span_kinds: dict[str, tuple[dict[str, int], bool]] = {}

    def _registry(self, root: str, cfg) -> tuple[dict[str, int], dict[str, str]]:
        key = root
        if key not in self._event_kinds:
            kinds, constants = _parse_registry(
                os.path.join(root, cfg.events_registry)
            )
            self._event_kinds[key] = kinds
            self._constants[key] = constants
        return self._event_kinds[key], self._constants[key]

    def _messages(self, root: str, cfg) -> tuple[dict[str, int], dict[str, str]]:
        key = root
        if key not in self._msg_kinds:
            kinds, constants = _parse_registry(
                os.path.join(root, cfg.messages_registry)
            )
            self._msg_kinds[key] = kinds
            self._msg_constants[key] = constants
        return self._msg_kinds[key], self._msg_constants[key]

    def _spans(self, root: str, cfg) -> tuple[dict[str, int], bool]:
        key = root
        if key not in self._span_kinds:
            self._span_kinds[key] = _parse_spans(
                os.path.join(root, cfg.events_registry)
            )
        return self._span_kinds[key]

    def check_file(self, ctx: FileContext) -> list[Finding]:
        kinds, constants = self._registry(ctx.root, ctx.config)
        findings: list[Finding] = []
        if kinds:
            for site in _emitted_kinds(ctx, constants):
                if site.kind not in kinds:
                    findings.append(
                        Finding(
                            rule=self.id,
                            path=ctx.path,
                            line=site.line,
                            message=(
                                f"event kind {site.kind!r} is not in the "
                                f"central registry ({ctx.config.events_registry})"
                            ),
                            hint=self.hint,
                        )
                    )
        span_kinds, _ = self._spans(ctx.root, ctx.config)
        rel = ctx.path.replace(os.sep, "/")
        # tests/ is exempt from the SPAN-site check only: test suites
        # construct toy spans ("outer", "orphan", ...) to exercise the
        # tracer itself. Event and wire checks still apply there.
        if span_kinds and not (
            rel.startswith("tests/") or "/tests/" in rel
        ):
            for site in _span_sites(ctx):
                if site.kind not in span_kinds:
                    findings.append(
                        Finding(
                            rule=self.id,
                            path=ctx.path,
                            line=site.line,
                            message=(
                                f"span kind {site.kind!r} is not in the "
                                f"SPANS registry "
                                f"({ctx.config.events_registry})"
                            ),
                            hint=self.hint,
                        )
                    )
        # No registry in this tree (fixture trees): the
        # project-level pass reports the missing registry instead.
        msg_kinds, msg_constants = self._messages(ctx.root, ctx.config)
        if msg_kinds:
            # The registry module defines its constants; a CALLER file
            # referencing federation.HELLO resolves through them too.
            lookup = dict(msg_constants)
            lookup.update(_parse_string_constants(ctx.tree))
            for site in _wire_sites(ctx, lookup):
                if site.kind not in msg_kinds:
                    findings.append(
                        Finding(
                            rule=self.id,
                            path=ctx.path,
                            line=site.line,
                            message=(
                                f"wire message kind {site.kind!r} is not "
                                "in the MESSAGES registry "
                                f"({ctx.config.messages_registry})"
                            ),
                            hint=self.hint,
                        )
                    )
        return findings

    def check_project(self, project: ProjectContext) -> list[Finding]:
        cfg = project.config
        findings: list[Finding] = []
        ev_path = os.path.join(project.root, cfg.events_registry)
        if not os.path.exists(ev_path):
            return []  # fixture trees carry no registry
        kinds, _ = self._registry(project.root, cfg)
        if not kinds:
            # The registry EXISTS but EVENTS did not parse as a literal
            # dict: the per-file emit checks were all vacuous this run.
            # That must be a loud finding, not a silent rule shutdown.
            return [
                Finding(
                    rule=self.id,
                    path=cfg.events_registry,
                    line=1,
                    message=(
                        "EVENTS is not parseable as a literal dict of "
                        "string keys — GL005 cannot check emit sites "
                        "against it"
                    ),
                    hint="keep EVENTS a literal {str: EventSpec} dict",
                )
            ]
        findings.extend(
            self._docs_coverage(
                project.root, cfg.events_registry, kinds, cfg.docs_events
            )
        )
        span_kinds, spans_declared = self._spans(project.root, cfg)
        if spans_declared and not span_kinds:
            # Same loudness contract as EVENTS/MESSAGES: a declared
            # SPANS table that fails to parse as a literal dict would
            # silently disable every span-site check — surface it. A
            # registry with NO SPANS assignment (fixture trees)
            # simply has the span plane vacuous.
            findings.append(
                Finding(
                    rule=self.id,
                    path=cfg.events_registry,
                    line=1,
                    message=(
                        "SPANS is not parseable as a literal dict of "
                        "string keys — GL005 cannot check span sites "
                        "against it"
                    ),
                    hint="keep SPANS a literal {str: SpanSpec} dict",
                )
            )
        elif span_kinds:
            findings.extend(
                self._docs_coverage(
                    project.root,
                    cfg.events_registry,
                    span_kinds,
                    cfg.docs_events,
                )
            )
        fault_kinds, _ = _parse_registry(
            os.path.join(project.root, cfg.faults_registry)
        )
        findings.extend(
            self._docs_coverage(
                project.root, cfg.faults_registry, fault_kinds, cfg.docs_faults
            )
        )
        msg_path = os.path.join(project.root, cfg.messages_registry)
        if os.path.exists(msg_path):
            msg_kinds, _ = self._messages(project.root, cfg)
            if not msg_kinds:
                # Same loudness contract as EVENTS: an existing wire
                # registry that fails to parse silently disables every
                # wire-site check — surface it.
                findings.append(
                    Finding(
                        rule=self.id,
                        path=cfg.messages_registry,
                        line=1,
                        message=(
                            "MESSAGES is not parseable as a literal dict "
                            "of string keys — GL005 cannot check wire "
                            "sites against it"
                        ),
                        hint="keep MESSAGES a literal {str: MessageSpec} "
                        "dict",
                    )
                )
            else:
                findings.extend(
                    self._docs_coverage(
                        project.root,
                        cfg.messages_registry,
                        msg_kinds,
                        cfg.docs_messages,
                    )
                )
        return findings

    def _docs_coverage(
        self, root: str, reg_rel: str, kinds: dict[str, int], doc_rels: list[str]
    ) -> list[Finding]:
        docs = []
        for doc_rel in doc_rels:
            try:
                with open(os.path.join(root, doc_rel), encoding="utf-8") as f:
                    docs.append(f.read())
            except OSError:
                return [
                    Finding(
                        rule=self.id,
                        path=reg_rel,
                        line=1,
                        message=f"registry documented in missing file {doc_rel}",
                        hint=self.hint,
                    )
                ]
        doc = "\n".join(docs)
        return [
            Finding(
                rule=self.id,
                path=reg_rel,
                line=line,
                message=(
                    f"registry entry {kind!r} is not documented in "
                    f"{' or '.join(doc_rels)}"
                ),
                hint=self.hint,
            )
            for kind, line in sorted(kinds.items(), key=lambda kv: kv[1])
            # "Documented" = appears as a code token: `kind` exactly, or
            # `kind@...` (the fault-spec form). A bare prose mention
            # ("reloads are retried") must NOT count.
            if not re.search(rf"`{re.escape(kind)}[`@]", doc)
        ]
