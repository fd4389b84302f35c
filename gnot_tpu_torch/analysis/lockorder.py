"""GL008/GL009 — the concurrency plane: lock-order graph + blocking
calls under locks.

The JAX package's rules (``gnot_tpu/analysis/lockorder.py``) over the
port, whose router, federation, autoscaler and server hold the same
locks in the same call chains.

The serving stack holds ~25 distinct ``threading.Lock``s across
router/federation/autoscaler/metrics, and the cross-object call chains
(autoscale tick → router → server drain; cluster router → host agent →
wire link) take them in nested orders nobody checks by hand. Two bug
classes follow, both invisible to GL004's per-attribute discipline:

* **GL008 lock-order inversion** — thread A acquires ``X`` then ``Y``,
  thread B acquires ``Y`` then ``X``: a deadlock that only fires under
  the right interleaving. The rule resolves every ``with self._lock:``
  site to a per-class lock identity (``ClassName._lock``; module- and
  function-local locks get module-qualified identities), propagates
  held-lock sets through the intra-project call graph (``self.m()``,
  typed ``self.attr.m()`` receivers, project-unique method names —
  the same terminal-name philosophy as the JAX donation graph), builds the
  directed *acquires-while-holding* graph, and reports every cycle
  with a ``file:line`` witness path for each edge. ``RLock``
  self-reentrancy is not a finding; re-acquiring a non-reentrant lock
  (directly or through a call chain) is reported as a self-deadlock.
* **GL009 blocking-call-under-lock** — a ``Future.result()``,
  ``Thread.join()``/``Event.wait()`` without timeout, socket
  ``recv``/``accept``, ``subprocess`` wait, or configured slow
  callable (engine ``infer*``/``warmup``, checkpoint I/O, ``reload`` —
  ``LintConfig.slow_callables``) lexically inside a
  held-lock region wedges every thread that wants the lock. Justified
  cases carry a ``#: allowed_blocking — reason`` annotation on (or
  immediately above) the call line; the reason is mandatory.

:func:`build_lock_graph` returns the whole graph (nodes, edges with
witness paths, cycles); the port writes no lock-map artifact of its
own. Resolution is deliberately
import-free and terminal-name keyed; an ambiguous method name (defined
by several classes, untyped receiver) resolves to *nothing* rather
than to every candidate — missed edges are honest, invented cycles are
not.
"""

from __future__ import annotations

import ast
import dataclasses
import os
import re

from gnot_tpu_torch.analysis.core import (
    FileContext,
    Finding,
    ProjectContext,
    Rule,
    dotted_name,
    register,
    terminal_name,
)

_LOCK_CTORS = ("Lock", "RLock", "Condition")

#: Method names ubiquitous on builtin containers/IO/concurrency
#: objects. The project-unique-name fallback must not resolve these —
#: ``self._entries.get(key)`` is a dict read, not a call into the one
#: class that happens to define a ``get`` method.
_BUILTIN_METHODS = frozenset(
    {
        "get", "pop", "append", "extend", "add", "remove", "discard",
        "clear", "update", "items", "keys", "values", "copy",
        "setdefault", "popitem", "insert", "count", "index", "sort",
        "reverse", "join", "split", "strip", "format", "encode",
        "decode", "read", "write", "readline", "flush", "close",
        "put", "get_nowait", "put_nowait", "acquire", "release",
        "wait", "notify", "notify_all", "start", "send", "recv",
        "accept", "result", "done", "cancel", "set", "is_set",
    }
)

#: Constructors whose result is a builtin container — an attribute
#: assigned one of these has NO project-class methods; calls through
#: it must not resolve via the unique-name fallback.
_BUILTIN_CTORS = frozenset(
    {"dict", "list", "set", "tuple", "defaultdict", "OrderedDict", "deque",
     "Counter", "Queue", "SimpleQueue", "LifoQueue", "PriorityQueue"}
)

#: Annotation contract for justified blocking calls: on the call line
#: or the line immediately above (which must start with "#:").
_ALLOWED_RE = re.compile(r"#:\s*allowed_blocking\b\s*(?:[—–-]+\s*)?(.*)")

#: Bound on interprocedural witness chains — deeper chains exist but a
#: six-hop path is already past what a reader will follow.
_CHAIN_CAP = 6
_FIXPOINT_ROUNDS = 12


def _lock_ctor_kind(node: ast.AST) -> str | None:
    """"Lock"/"RLock"/"Condition" when ``node`` constructs one
    (``threading.Lock()`` or bare ``Lock()``), else None."""
    if isinstance(node, ast.Call) and terminal_name(node.func) in _LOCK_CTORS:
        return terminal_name(node.func)
    return None


def _module_stem(rel_path: str) -> str:
    """Short module identity for lock naming: ``gnot_tpu_torch/native/
    __init__.py`` -> "native", ``serve/federation.py`` -> "federation"."""
    parts = rel_path.replace(os.sep, "/").rsplit(".py", 1)[0].split("/")
    if parts and parts[-1] == "__init__":
        parts.pop()
    return parts[-1] if parts else rel_path


class _ClassInfo:
    """Per-class lock model: lock attributes (with constructor kind),
    attribute receiver types, and method defs."""

    __slots__ = ("name", "locks", "attr_types", "methods")

    def __init__(self, name: str):
        self.name = name
        self.locks: dict[str, tuple[str, int]] = {}  # attr -> (kind, line)
        self.attr_types: dict[str, str] = {}  # attr -> class name
        self.methods: dict[str, ast.AST] = {}


class _FileLockInfo:
    __slots__ = ("classes", "module_locks", "functions", "stem")

    def __init__(self, stem: str):
        self.stem = stem
        self.classes: dict[str, _ClassInfo] = {}
        self.module_locks: dict[str, tuple[str, int]] = {}
        self.functions: dict[str, ast.AST] = {}


def _file_lock_info(ctx: FileContext) -> _FileLockInfo:
    """Lock declarations in one file (memoized per FileContext)."""
    cached = getattr(ctx, "_lockinfo", None)
    if cached is not None:
        return cached
    info = _FileLockInfo(_module_stem(ctx.path))
    for node in ctx.tree.body:
        if isinstance(node, ast.Assign):
            kind = _lock_ctor_kind(node.value)
            if kind:
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        info.module_locks[t.id] = (kind, node.lineno)
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            info.functions[node.name] = node
    for cls in ast.walk(ctx.tree):
        if not isinstance(cls, ast.ClassDef):
            continue
        ci = info.classes.setdefault(cls.name, _ClassInfo(cls.name))
        for fn in cls.body:
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            ci.methods.setdefault(fn.name, fn)
            # Annotated __init__ params give receiver types for
            # `self.router = router`-style wiring.
            param_types: dict[str, str] = {}
            for a in (*fn.args.posonlyargs, *fn.args.args):
                if a.annotation is not None:
                    tn = terminal_name(a.annotation)
                    if tn and tn[:1].isupper():
                        param_types[a.arg] = tn
            for node in ast.walk(fn):
                if not isinstance(node, ast.Assign):
                    continue
                for t in node.targets:
                    if not (
                        isinstance(t, ast.Attribute)
                        and isinstance(t.value, ast.Name)
                        and t.value.id == "self"
                    ):
                        continue
                    kind = _lock_ctor_kind(node.value)
                    if kind:
                        ci.locks.setdefault(t.attr, (kind, node.lineno))
                    elif isinstance(
                        node.value,
                        (ast.Dict, ast.List, ast.Set, ast.Tuple,
                         ast.DictComp, ast.ListComp, ast.SetComp),
                    ):
                        ci.attr_types.setdefault(t.attr, "<builtin>")
                    elif isinstance(node.value, ast.Call):
                        tn = terminal_name(node.value.func)
                        if tn in _BUILTIN_CTORS:
                            ci.attr_types.setdefault(t.attr, "<builtin>")
                        elif tn and tn[:1].isupper():
                            ci.attr_types.setdefault(t.attr, tn)
                    elif isinstance(node.value, ast.Name):
                        tn = param_types.get(node.value.id)
                        if tn:
                            ci.attr_types.setdefault(t.attr, tn)
    ctx._lockinfo = info
    return info


class _ProjectLocks:
    """Cross-file lock model: every lock identity, every method keyed
    ``(ClassName, method)``, and the unique-name resolution indexes."""

    def __init__(self) -> None:
        #: lock id -> {"kind", "file", "line", "module", "class"}
        self.nodes: dict[str, dict] = {}
        self.class_locks: dict[str, dict[str, tuple[str, str]]] = {}
        self.attr_types: dict[str, dict[str, str]] = {}
        self.methods: dict[tuple[str, str], tuple[FileContext, ast.AST, str]] = {}
        self.method_classes: dict[str, set[str]] = {}
        self.functions: dict[str, tuple[FileContext, ast.AST]] = {}
        self._dup_functions: set[str] = set()

    def add_file(self, ctx: FileContext) -> None:
        info = _file_lock_info(ctx)
        for name, (kind, line) in info.module_locks.items():
            lid = f"{info.stem}.{name}"
            self.nodes.setdefault(
                lid,
                {
                    "kind": kind,
                    "file": ctx.path,
                    "line": line,
                    "module": info.stem,
                    "class": None,
                },
            )
        for fname, fn in info.functions.items():
            if fname in self.functions or fname in self._dup_functions:
                self.functions.pop(fname, None)
                self._dup_functions.add(fname)
            else:
                self.functions[fname] = (ctx, fn)
        for cname, ci in info.classes.items():
            locks = self.class_locks.setdefault(cname, {})
            for attr, (kind, line) in ci.locks.items():
                lid = f"{cname}.{attr}"
                locks.setdefault(attr, (kind, lid))
                self.nodes.setdefault(
                    lid,
                    {
                        "kind": kind,
                        "file": ctx.path,
                        "line": line,
                        "module": info.stem,
                        "class": cname,
                    },
                )
            types = self.attr_types.setdefault(cname, {})
            for attr, tn in ci.attr_types.items():
                types.setdefault(attr, tn)
            for mname, fn in ci.methods.items():
                self.methods.setdefault((cname, mname), (ctx, fn, cname))
                self.method_classes.setdefault(mname, set()).add(cname)


@dataclasses.dataclass(frozen=True)
class _Held:
    lock: str
    kind: str
    line: int


class _Acq:
    """One lock acquisition with the locks lexically held at it."""

    __slots__ = ("lock", "kind", "line", "held")

    def __init__(self, lock: str, kind: str, line: int, held: tuple):
        self.lock, self.kind, self.line, self.held = lock, kind, line, held


class _CallSite:
    """One call expression inside a function body, with held locks and
    (when resolvable) the project callable it targets."""

    __slots__ = ("node", "key", "line", "held")

    def __init__(self, node: ast.Call, key, line: int, held: tuple):
        self.node, self.key, self.line, self.held = node, key, line, held


def _local_lock_aliases(
    fn: ast.AST, ci: _ClassInfo | None, info: _FileLockInfo
) -> tuple[
    dict[str, tuple[str, str]],
    dict[str, tuple[str, str]],
    dict[str, tuple[str, int]],
]:
    """``(aliases, local_locks, local_lines)``: single-assignment local
    names bound to a known lock (``wlock = self._wlock``),
    function-local lock constructions (``wlock = threading.Lock()``),
    and — keyed by lock identity — each construction's ``(kind, line)``
    so the graph can register these as nodes. A name assigned more
    than once is dropped — its identity is not trackable."""
    assigned: dict[str, int] = {}
    aliases: dict[str, tuple[str, str]] = {}
    local_locks: dict[str, tuple[str, str]] = {}
    local_lines: dict[str, tuple[str, int]] = {}
    for node in ast.walk(fn):
        if not isinstance(node, ast.Assign):
            continue
        for t in node.targets:
            if not isinstance(t, ast.Name):
                continue
            assigned[t.id] = assigned.get(t.id, 0) + 1
            kind = _lock_ctor_kind(node.value)
            if kind:
                lid = f"{info.stem}.{getattr(fn, 'name', '<fn>')}.{t.id}"
                local_locks[t.id] = (kind, lid)
                local_lines[lid] = (kind, node.lineno)
            elif (
                ci is not None
                and isinstance(node.value, ast.Attribute)
                and isinstance(node.value.value, ast.Name)
                and node.value.value.id == "self"
                and node.value.attr in ci.locks
            ):
                aliases[t.id] = (
                    ci.locks[node.value.attr][0],
                    f"{ci.name}.{node.value.attr}",
                )
    for name, n in assigned.items():
        if n > 1:
            aliases.pop(name, None)
            dropped = local_locks.pop(name, None)
            if dropped:
                local_lines.pop(dropped[1], None)
    return aliases, local_locks, local_lines


def _callable_events(
    ctx: FileContext,
    fn: ast.AST,
    ci: _ClassInfo | None,
    data: _ProjectLocks | None,
) -> tuple[list[_Acq], list[_CallSite]]:
    """Walk one function body tracking the lexically-held lock stack:
    every acquisition (``with`` item or explicit ``.acquire()``) and
    every call expression, each tagged with the held set at that
    point. Nested function/class defs are separate callables — their
    bodies do not run under the enclosing ``with``."""
    info = _file_lock_info(ctx)
    aliases, local_locks, local_lines = _local_lock_aliases(fn, ci, info)
    if data is not None:
        # Function-local constructions are graph nodes too: any edge
        # they participate in must resolve to a registered identity.
        for lid, (kind, line) in local_lines.items():
            data.nodes.setdefault(
                lid,
                {
                    "kind": kind,
                    "file": ctx.path,
                    "line": line,
                    "module": info.stem,
                    "class": ci.name if ci is not None else None,
                },
            )
    acqs: list[_Acq] = []
    calls: list[_CallSite] = []

    def resolve_lock(expr: ast.AST) -> tuple[str, str] | None:
        """(kind, lock id) for an expression denoting a known lock."""
        if (
            isinstance(expr, ast.Attribute)
            and isinstance(expr.value, ast.Name)
            and expr.value.id == "self"
            and ci is not None
            and expr.attr in ci.locks
        ):
            return ci.locks[expr.attr][0], f"{ci.name}.{expr.attr}"
        if isinstance(expr, ast.Name):
            hit = local_locks.get(expr.id) or aliases.get(expr.id)
            if hit:
                return hit
            mod = info.module_locks.get(expr.id)
            if mod:
                return mod[0], f"{info.stem}.{expr.id}"
        return None

    def resolve_call(call: ast.Call):
        if data is None:
            return None
        f = call.func
        if isinstance(f, ast.Attribute):
            m = f.attr
            recv = f.value
            if isinstance(recv, ast.Name) and recv.id == "self" and ci is not None:
                if (ci.name, m) in data.methods:
                    return (ci.name, m)
            if (
                isinstance(recv, ast.Attribute)
                and isinstance(recv.value, ast.Name)
                and recv.value.id == "self"
                and ci is not None
            ):
                tn = data.attr_types.get(ci.name, {}).get(recv.attr)
                if tn == "<builtin>":
                    return None  # dict/list/queue attr: never a project call
                if tn and (tn, m) in data.methods:
                    return (tn, m)
            if m in _BUILTIN_METHODS:
                return None  # too generic for the unique-name fallback
            cands = data.method_classes.get(m, set())
            if len(cands) > 1:
                # Test stubs shadow real serving classes by method name
                # (_StubRouter.pool vs ReplicaRouter.pool). Classes
                # that own no locks cannot contribute acquisitions, so
                # when exactly one candidate does, resolve there.
                cands = {c for c in cands if data.class_locks.get(c)}
            if len(cands) == 1:
                cand = next(iter(cands))
                if (cand, m) in data.methods:
                    return (cand, m)
            return None
        if isinstance(f, ast.Name) and f.id in data.functions:
            return ("", f.id)
        return None

    def scan_expr(node: ast.AST, held: tuple) -> None:
        """Calls inside one expression (lazily-evaluated subtrees —
        nested defs and lambdas — excluded: they run later, possibly
        after the lock is released)."""
        stack = [node]
        while stack:
            n = stack.pop()
            if isinstance(
                n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda, ast.ClassDef)
            ):
                continue
            if isinstance(n, ast.Call):
                fnode = n.func
                if (
                    isinstance(fnode, ast.Attribute)
                    and fnode.attr == "acquire"
                ):
                    lk = resolve_lock(fnode.value)
                    if lk:
                        acqs.append(_Acq(lk[1], lk[0], n.lineno, held))
                calls.append(_CallSite(n, resolve_call(n), n.lineno, held))
            stack.extend(ast.iter_child_nodes(n))

    def visit_stmt(st: ast.stmt, held: tuple) -> None:
        if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            return
        if isinstance(st, (ast.With, ast.AsyncWith)):
            newheld = held
            for item in st.items:
                scan_expr(item.context_expr, newheld)
                lk = resolve_lock(item.context_expr)
                if lk:
                    acqs.append(_Acq(lk[1], lk[0], item.context_expr.lineno, newheld))
                    newheld = newheld + (
                        _Held(lk[1], lk[0], item.context_expr.lineno),
                    )
            for s in st.body:
                visit_stmt(s, newheld)
            return
        for _, value in ast.iter_fields(st):
            if isinstance(value, list):
                for v in value:
                    if isinstance(v, ast.stmt):
                        visit_stmt(v, held)
                    elif isinstance(v, ast.AST):
                        scan_expr(v, held)
            elif isinstance(value, ast.AST):
                scan_expr(value, held)

    for s in fn.body:
        visit_stmt(s, ())
    return acqs, calls


# -- the project lock graph (GL008) -------------------------------------------


def build_lock_graph(
    contexts: list[FileContext],
) -> tuple[dict[str, dict], dict[tuple[str, str], list[str]], list[list[str]]]:
    """``(nodes, edges, cycles)`` of the acquires-while-holding graph.

    ``nodes`` maps lock identity -> declaration metadata; ``edges``
    maps ``(held, acquired)`` -> witness path (``file:line`` strings,
    outermost first); ``cycles`` lists node sequences
    ``[A, B, ..., A]`` — an empty list is the shippable state. Edges
    whose inner-acquisition line carries a GL008 suppression are
    omitted."""
    data = _ProjectLocks()
    for ctx in contexts:
        data.add_file(ctx)

    per_callable: dict = {}
    for ctx in contexts:
        info = _file_lock_info(ctx)
        for (cname, mname), (mctx, fn, _) in list(data.methods.items()):
            if mctx is ctx:
                ci = info.classes.get(cname)
                per_callable[(cname, mname)] = (
                    ctx,
                    _callable_events(ctx, fn, ci, data),
                )
        for fname, (fctx, fn) in data.functions.items():
            if fctx is ctx:
                per_callable[("", fname)] = (
                    ctx,
                    _callable_events(ctx, fn, None, data),
                )

    # Fixpoint: summary[key] = lock -> witness chain of file:line hops
    # from the callable's entry to the acquisition.
    summaries: dict = {key: {} for key in per_callable}
    for _ in range(_FIXPOINT_ROUNDS):
        changed = False
        for key, (ctx, (acqs, calls)) in per_callable.items():
            summ = summaries[key]
            for a in acqs:
                if a.lock not in summ:
                    summ[a.lock] = (f"{ctx.path}:{a.line}",)
                    changed = True
            for c in calls:
                if c.key is None or c.key not in summaries:
                    continue
                for lock, chain in summaries[c.key].items():
                    if lock not in summ and len(chain) < _CHAIN_CAP:
                        summ[lock] = (f"{ctx.path}:{c.line}",) + chain
                        changed = True
        if not changed:
            break

    edges: dict[tuple[str, str], list[str]] = {}

    def add_edge(held: _Held, lock: str, witness: list[str]) -> None:
        edges.setdefault((held.lock, lock), witness)

    for key, (ctx, (acqs, calls)) in per_callable.items():
        for a in acqs:
            if ctx.is_suppressed("GL008", a.line):
                continue
            for h in a.held:
                if h.lock == a.lock and h.kind == "RLock":
                    continue  # RLock self-reentrancy is the point of RLock
                add_edge(
                    h,
                    a.lock,
                    [
                        f"{ctx.path}:{h.line} acquires {h.lock}",
                        f"{ctx.path}:{a.line} acquires {a.lock} "
                        f"while holding {h.lock}",
                    ],
                )
        for c in calls:
            if c.key is None or not c.held:
                continue
            if ctx.is_suppressed("GL008", c.line):
                continue
            callee = ".".join(p for p in c.key if p)
            for lock, chain in summaries.get(c.key, {}).items():
                for h in c.held:
                    if h.lock == lock and h.kind == "RLock":
                        continue
                    add_edge(
                        h,
                        lock,
                        [
                            f"{ctx.path}:{h.line} acquires {h.lock}",
                            f"{ctx.path}:{c.line} calls {callee}() "
                            f"while holding {h.lock}",
                            *(f"{hop} (inside {callee})" for hop in chain[:-1]),
                            f"{chain[-1]} acquires {lock}",
                        ],
                    )

    return data.nodes, edges, _find_cycles(edges)


def _find_cycles(
    edges: dict[tuple[str, str], list[str]]
) -> list[list[str]]:
    """Cycle node sequences ``[A, ..., A]``: self-loops, plus one
    representative cycle per distinct node set inside each non-trivial
    strongly connected component (shortest path back to the edge's
    tail). Deduplicated by normalized rotation."""
    adj: dict[str, set[str]] = {}
    for a, b in edges:
        adj.setdefault(a, set()).add(b)
        adj.setdefault(b, set())
    cycles: list[list[str]] = []
    seen: set[tuple[str, ...]] = set()
    for a, b in sorted(edges):
        if a == b:
            cycles.append([a, a])
            continue
        # Shortest path b -> a (BFS); exists iff this edge is in a cycle.
        prev: dict[str, str | None] = {b: None}
        queue = [b]
        while queue and a not in prev:
            cur = queue.pop(0)
            for nxt in sorted(adj.get(cur, ())):
                if nxt not in prev:
                    prev[nxt] = cur
                    queue.append(nxt)
        if a not in prev:
            continue
        back = [a]  # walk prev links a -> ... -> b
        while prev[back[-1]] is not None:
            back.append(prev[back[-1]])
        # Cycle: the edge a -> b, then the BFS path b -> ... -> a.
        cyc = [a] + back[::-1]  # [a, b, ..., a]
        # Normalize by rotating the (open) cycle to its minimal node.
        body = cyc[:-1]
        i = body.index(min(body))
        norm = tuple(body[i:] + body[:i])
        if norm in seen:
            continue
        seen.add(norm)
        cycles.append(list(norm) + [norm[0]])
    return cycles


@register
class LockOrder(Rule):
    id = "GL008"
    title = "lock-order-inversion"
    hint = (
        "make every thread acquire these locks in one global order "
        "(or collapse them to one lock); each edge's witness path lists "
        "the file:line hops, outermost first"
    )

    def check_project(self, project: ProjectContext) -> list[Finding]:
        _, edges, cycles = build_lock_graph(project.contexts)
        findings: list[Finding] = []
        for cyc in cycles:
            if len(cyc) == 2 and cyc[0] == cyc[1]:
                witness = edges[(cyc[0], cyc[0])]
                path, line = _witness_anchor(witness)
                findings.append(
                    Finding(
                        rule=self.id,
                        path=path,
                        line=line,
                        message=(
                            f"non-reentrant lock {cyc[0]} is re-acquired "
                            "while already held (self-deadlock): "
                            + "; ".join(witness)
                        ),
                        hint="use an RLock or split the inner acquisition "
                        "out of the held region",
                    )
                )
                continue
            parts = []
            for u, v in zip(cyc, cyc[1:]):
                witness = edges.get((u, v), [])
                parts.append(f"{u} -> {v} [" + "; ".join(witness) + "]")
            anchor = edges.get((cyc[0], cyc[1]), [""])
            path, line = _witness_anchor(anchor)
            findings.append(
                Finding(
                    rule=self.id,
                    path=path,
                    line=line,
                    message=(
                        "lock-order cycle "
                        + " -> ".join(cyc)
                        + ": "
                        + " | ".join(parts)
                    ),
                    hint=self.hint,
                )
            )
        return findings


def _witness_anchor(witness: list[str]) -> tuple[str, int]:
    """(path, line) of a witness path's innermost hop."""
    for hop in reversed(witness):
        m = re.match(r"(.+?):(\d+)", hop)
        if m:
            return m.group(1), int(m.group(2))
    return "<unknown>", 0


# -- GL009: blocking calls under a held lock --------------------------------

_SOCKET_BLOCKERS = ("recv", "recvfrom", "recv_into", "accept")
_WAIT_BLOCKERS = ("result", "join", "wait", "communicate")
_SUBPROCESS_FNS = ("run", "call", "check_call", "check_output")


def _slow_match(name: str, patterns: list[str]) -> bool:
    for pat in patterns:
        if pat.endswith("*"):
            if name.startswith(pat[:-1]):
                return True
        elif name == pat:
            return True
    return False


def _blocking_reason(call: ast.Call, slow: list[str]) -> str | None:
    """Why this call blocks unboundedly, or None. The wait family is
    clean when bounded (any positional arg or a timeout= keyword);
    socket/subprocess/slow calls block regardless of arguments."""
    t = terminal_name(call.func)
    dn = dotted_name(call.func)
    bounded = bool(call.args) or any(
        kw.arg == "timeout" for kw in call.keywords
    )
    if t in _WAIT_BLOCKERS and not bounded:
        return f"{t}() without a timeout"
    if t in _SOCKET_BLOCKERS:
        return f"socket {t}()"
    if dn.startswith("subprocess.") and t in _SUBPROCESS_FNS:
        return f"{dn}()"
    if dn == "time.sleep":
        return "time.sleep()"
    if _slow_match(t, slow):
        return f"slow callable {t}()"
    return None


def _allowed_annotation(ctx: FileContext, line: int) -> tuple[bool, bool]:
    """``(annotated, has_reason)`` for a ``#: allowed_blocking`` on the
    given line or the line above (above-form must start with ``#:``,
    mirroring GL004's guarded_by contract)."""
    candidates = []
    if 0 < line <= len(ctx.lines):
        candidates.append(ctx.lines[line - 1])
    if line >= 2:
        above = ctx.lines[line - 2].strip()
        if above.startswith("#:"):
            candidates.append(above)
    for text in candidates:
        m = _ALLOWED_RE.search(text)
        if m:
            return True, bool(m.group(1).strip())
    return False, False


@register
class BlockingUnderLock(Rule):
    id = "GL009"
    title = "blocking-call-under-lock"
    hint = (
        "move the call outside the lock (snapshot under the lock, act "
        "after release), bound it with a timeout, or justify it with "
        "`#: allowed_blocking — reason`"
    )

    def check_file(self, ctx: FileContext) -> list[Finding]:
        info = _file_lock_info(ctx)
        findings: list[Finding] = []
        slow = list(ctx.config.slow_callables)
        for fn in ast.walk(ctx.tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            ci = None
            for anc in ctx.ancestors(fn):
                if isinstance(anc, ast.ClassDef):
                    ci = info.classes.get(anc.name)
                    break
                if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    break  # nested def: no enclosing-class lock attrs
            _, calls = _callable_events(ctx, fn, ci, None)
            for c in calls:
                if not c.held:
                    continue
                reason = _blocking_reason(c.node, slow)
                if reason is None:
                    continue
                t = terminal_name(c.node.func)
                if t == "wait" and len(c.held) == 1:
                    lk = _receiver_lock(ctx, c.node, ci, info)
                    if lk is not None and lk == c.held[0].lock:
                        # Condition.wait on the ONLY held lock releases
                        # it while waiting — the intended pattern.
                        continue
                annotated, has_reason = _allowed_annotation(ctx, c.line)
                if annotated and has_reason:
                    continue
                held = c.held[-1]
                if annotated:
                    msg = (
                        f"#: allowed_blocking on {reason} under "
                        f"{held.lock} is missing its justification "
                        "(append `— reason`)"
                    )
                else:
                    msg = (
                        f"blocking {reason} inside the held-lock region "
                        f"of {held.lock} (held since line {held.line}) — "
                        "every thread wanting the lock wedges behind it"
                    )
                findings.append(
                    Finding(
                        rule=self.id,
                        path=ctx.path,
                        line=c.line,
                        message=msg,
                        hint=self.hint,
                    )
                )
        return findings


def _receiver_lock(
    ctx: FileContext,
    call: ast.Call,
    ci: _ClassInfo | None,
    info: _FileLockInfo,
) -> str | None:
    """Lock identity of a ``<recv>.wait()`` receiver, when it is one."""
    f = call.func
    if not isinstance(f, ast.Attribute):
        return None
    recv = f.value
    if (
        isinstance(recv, ast.Attribute)
        and isinstance(recv.value, ast.Name)
        and recv.value.id == "self"
        and ci is not None
        and recv.attr in ci.locks
    ):
        return f"{ci.name}.{recv.attr}"
    if isinstance(recv, ast.Name) and recv.id in info.module_locks:
        return f"{info.stem}.{recv.id}"
    return None
