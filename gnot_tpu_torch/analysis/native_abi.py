"""GL007 — native ABI drift (ctypes bindings vs C symbol declarations).

The port's native packer (``gnot_tpu_torch/native/ragged_pack.cpp``) is
loaded via ctypes with hand-written ``argtypes`` in
``gnot_tpu_torch/native/__init__.py`` (the JAX package's rule,
``gnot_tpu/analysis/native_abi.py``, over the port's pair).
Nothing type-checks that seam: add a parameter on one side only and the
call still "works" — reading garbage through a mis-laid stack, the
classic silent-drift bug shape for a .so behind a Python caller.

This rule parses BOTH sides on every lint run and compares, per
exported ``gnot_*`` symbol:

* the symbol exists on both sides (a binding without a C definition,
  or an ``extern "C"`` export nothing binds, are both findings);
* arity agrees;
* every parameter's dtype TAG agrees, under a coarse canonical map —
  pointer-to-pointer (``const float**``/``char**``) is
  ``POINTER(c_void_p)``, ``int64_t*`` is ``POINTER(c_int64)``, scalar
  ``int64_t`` is ``c_int64``, and any other single pointer
  (``float*``, ``uint16_t*``, ``char*``) is the opaque ``c_void_p``
  the bindings pass buffers as.

Project-level (the C++ file is not a lintable Python file): an edit to
either file alone can cause a finding.
"""

from __future__ import annotations

import ast
import os
import re

from gnot_tpu_torch.analysis.core import (
    Finding,
    ProjectContext,
    Rule,
    register,
)

#: C parameter type -> canonical ctypes tag. Checked after stripping
#: ``const``/whitespace and the parameter name. Unknown types map to
#: themselves, which can only ever MATCH nothing — an unknown type is
#: a (loud) mismatch, never a silent pass.
_C_TAGS = (
    (re.compile(r"^.*\*\s*\*$"), "POINTER(c_void_p)"),
    (re.compile(r"^u?int64_t\s*\*$"), "POINTER(c_int64)"),
    (re.compile(r"^u?int64_t$"), "c_int64"),
    (re.compile(r"^[A-Za-z_][A-Za-z_0-9]*\s*\*$"), "c_void_p"),
)

_DECL_RE = re.compile(
    r"\b(?:void|int|int64_t|float|double)\s+(gnot_\w+)\s*\(([^)]*)\)",
    re.DOTALL,
)


def _strip_c_comments(src: str) -> str:
    src = re.sub(r"/\*.*?\*/", " ", src, flags=re.DOTALL)
    return re.sub(r"//[^\n]*", " ", src)


def _c_param_tag(param: str) -> str:
    """Canonical tag of one C parameter declaration."""
    p = param.strip()
    # Drop the parameter NAME: the last identifier not glued to a '*'.
    p = re.sub(r"\b[A-Za-z_][A-Za-z_0-9]*\s*$", "", p).strip()
    p = re.sub(r"\bconst\b", "", p)
    p = re.sub(r"\s+", "", p)
    # Normalize '**' spacing forms like '* *'.
    for pat, tag in _C_TAGS:
        if pat.match(p):
            return tag
    return p or "?"


def _c_symbols(path: str) -> dict[str, tuple[int, list[str]]]:
    """``symbol -> (line, [tags])`` for every ``gnot_*`` declaration."""
    with open(path, encoding="utf-8") as f:
        raw = f.read()
    src = _strip_c_comments(raw)
    out: dict[str, tuple[int, list[str]]] = {}
    for m in _DECL_RE.finditer(src):
        name, args = m.group(1), m.group(2)
        line = src.count("\n", 0, m.start()) + 1
        params = [a for a in args.split(",") if a.strip()]
        out[name] = (line, [_c_param_tag(a) for a in params])
    return out


def _ctypes_tag(node: ast.AST) -> str:
    """Canonical tag of one ctypes argtypes element (AST form)."""

    def terminal(n: ast.AST) -> str:
        if isinstance(n, ast.Attribute):
            return n.attr
        if isinstance(n, ast.Name):
            return n.id
        return "?"

    if isinstance(node, ast.Call) and terminal(node.func) == "POINTER":
        inner = terminal(node.args[0]) if node.args else "?"
        return f"POINTER({inner})"
    return terminal(node)


def _py_bindings(path: str) -> dict[str, tuple[int, list[str]]]:
    """``symbol -> (line, [tags])`` from ``lib.<symbol>.argtypes = [...]``
    assignments anywhere in the bindings module."""
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), filename=path)
    out: dict[str, tuple[int, list[str]]] = {}
    for node in ast.walk(tree):
        if not isinstance(node, ast.Assign) or len(node.targets) != 1:
            continue
        t = node.targets[0]
        if not (
            isinstance(t, ast.Attribute)
            and t.attr == "argtypes"
            and isinstance(t.value, ast.Attribute)
        ):
            continue
        symbol = t.value.attr
        if not isinstance(node.value, (ast.List, ast.Tuple)):
            out[symbol] = (node.lineno, ["?unparseable"])
            continue
        out[symbol] = (
            node.lineno,
            [_ctypes_tag(e) for e in node.value.elts],
        )
    return out


@register
class NativeAbiDrift(Rule):
    id = "GL007"
    title = "native-abi-drift"
    hint = (
        "keep gnot_tpu_torch/native/__init__.py argtypes and the "
        "extern \"C\" declarations in ragged_pack.cpp in lockstep "
        "(arity + dtype tags; the tag map is in native_abi.py)"
    )

    def check_project(self, project: ProjectContext) -> list[Finding]:
        cfg = project.config
        py_rel = cfg.native_binding
        cpp_rel = cfg.native_source
        py_path = os.path.join(project.root, py_rel)
        cpp_path = os.path.join(project.root, cpp_rel)
        if not (os.path.exists(py_path) and os.path.exists(cpp_path)):
            return []  # fixture trees carry no native layer
        try:
            bindings = _py_bindings(py_path)
            symbols = _c_symbols(cpp_path)
        except (OSError, SyntaxError) as err:
            return [
                Finding(
                    rule=self.id,
                    path=py_rel,
                    line=1,
                    message=f"native ABI check could not parse: {err}",
                    hint=self.hint,
                )
            ]
        findings: list[Finding] = []
        for symbol, (line, py_tags) in sorted(bindings.items()):
            if symbol not in symbols:
                findings.append(
                    Finding(
                        rule=self.id,
                        path=py_rel,
                        line=line,
                        message=(
                            f"ctypes binds {symbol!r} but {cpp_rel} "
                            "declares no such extern \"C\" symbol"
                        ),
                        hint=self.hint,
                    )
                )
                continue
            c_line, c_tags = symbols[symbol]
            if len(py_tags) != len(c_tags):
                findings.append(
                    Finding(
                        rule=self.id,
                        path=py_rel,
                        line=line,
                        message=(
                            f"{symbol!r} arity drift: ctypes binds "
                            f"{len(py_tags)} argtypes, {cpp_rel}:{c_line} "
                            f"declares {len(c_tags)} parameters"
                        ),
                        hint=self.hint,
                    )
                )
                continue
            for i, (pt, ct) in enumerate(zip(py_tags, c_tags)):
                if pt != ct:
                    findings.append(
                        Finding(
                            rule=self.id,
                            path=py_rel,
                            line=line,
                            message=(
                                f"{symbol!r} dtype-tag drift at arg {i}: "
                                f"ctypes {pt}, C declares {ct} "
                                f"({cpp_rel}:{c_line})"
                            ),
                            hint=self.hint,
                        )
                    )
        for symbol, (c_line, _) in sorted(symbols.items()):
            if symbol not in bindings:
                findings.append(
                    Finding(
                        rule=self.id,
                        path=cpp_rel,
                        line=c_line,
                        message=(
                            f"extern \"C\" symbol {symbol!r} has no "
                            f"ctypes binding in {py_rel} (dead export, "
                            "or a binding was forgotten)"
                        ),
                        hint=self.hint,
                    )
                )
        return findings
