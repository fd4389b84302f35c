"""Runtime lock-order witness: reports the first lock-order inversion the
process actually performs, with both witness stacks.

Port of ``gnot_tpu/utils/lockguard.py``. ``GNOT_LOCK_GUARD`` selects the
mode, read when :func:`install` runs:

* **off** (unset / ``0`` / ``off``): nothing is patched;
  ``threading.Lock`` and ``threading.RLock`` stay the factories they were
  when this module was imported (``_ORIG_LOCK`` / ``_ORIG_RLOCK``).
* **witness** (``1`` / ``on`` / ``witness``): locks constructed in this
  project's files (paths under ``gnot_tpu_torch/`` or ``tests/``) are
  wrapped. Each remembers its construction site (``file:line``), every
  thread tracks the locks it holds, and each first-seen edge ``A -> B``
  (B acquired while holding A) enters a process-wide happened-before
  graph. The first edge that closes a cycle is reported once, with the
  stack now and the stack of the first reverse observation, as a
  ``warnings.warn``; the run goes on.
* **strict**: as witness, but the cycle-closing acquire raises
  :class:`LockOrderViolation` before it blocks.

Nothing installs the guard at import; the port's ``main`` never does.
``on_report`` is the observer hook ``obs/dtrace.FlightRecorder.
watch_lockguard`` sets: an inversion report then dumps the recorder's
ring. Unlike JAX's copy, a report reaches ``on_report`` only after the
graph's own lock is released: the recorder's trigger takes a guarded lock,
and checking it under the graph's lock would deadlock the reporting
thread. Locks of two instances from one construction site form no edge,
a reentrant re-acquire by the holder is legal, and a non-reentrant lock
re-acquired by its holder is reported at once as a self-deadlock.

The JAX package's copy patches the same ``threading`` attributes; a
process that installs both restores the factories it found (``tests``
do so after each check). Stdlib only.
"""

from __future__ import annotations

import os
import sys
import threading
import traceback
import warnings

_MODES = ("off", "witness", "strict")

#: Live mode; "off" until install() runs.
_mode = "off"

#: The untouched factories, captured once at import (before any
#: install can swap them); off-mode restores these very objects.
_ORIG_LOCK = threading.Lock
_ORIG_RLOCK = threading.RLock

#: Graph bookkeeping lock: a raw original primitive, so the guard
#: never traces itself.
_meta = _ORIG_LOCK()

#: site -> {site acquired while holding it, ...}
_edges: dict[str, set[str]] = {}
#: (held_site, acquired_site) -> witness stack of the FIRST observation.
_edge_stacks: dict[tuple[str, str], str] = {}
#: Reported inversions: list of dicts (test/triage introspection).
_inversions: list[dict] = []
_reported: set[tuple[str, str]] = set()

_tls = threading.local()


class LockOrderViolation(RuntimeError):
    """Strict mode: an acquisition closed a lock-order cycle."""


def guard_mode() -> str:
    """The mode ``GNOT_LOCK_GUARD`` requests (not necessarily
    installed yet): off / witness / strict."""
    raw = os.environ.get("GNOT_LOCK_GUARD", "").strip().lower()
    if raw in ("", "0", "off", "false", "no"):
        return "off"
    if raw == "strict":
        return "strict"
    return "witness"  # "1" / "on" / "true" / "witness"


def installed_mode() -> str:
    """The mode actually live in this process."""
    return _mode


def install() -> str:
    """Install the guard per ``GNOT_LOCK_GUARD``. Idempotent; safe to
    call more than once. Off-mode restores the original factory
    objects: no wrapper shims left behind. Locks
    constructed while a previous mode was live keep their wrapping
    (witness/strict wrappers re-check the live mode per acquire, so
    switching to off disarms them too). Returns the live mode."""
    global _mode
    want = guard_mode()
    if want == _mode:
        return _mode
    if want == "off":
        threading.Lock = _ORIG_LOCK
        threading.RLock = _ORIG_RLOCK
    else:
        threading.Lock = _make_lock
        threading.RLock = _make_rlock
    _mode = want
    return _mode


def _site(depth: int = 2) -> str | None:
    """``file:line`` of the construction site when it lies in project
    code (a path under gnot_tpu_torch/ or tests/), else None: stdlib and
    third-party constructions stay unwrapped."""
    frame = sys._getframe(depth)
    fn = frame.f_code.co_filename.replace(os.sep, "/")
    for anchor in ("gnot_tpu_torch/", "tests/"):
        i = fn.rfind(anchor)
        if i >= 0:
            return f"{fn[i:]}:{frame.f_lineno}"
    return None


def _make_lock():
    site = _site()
    real = _ORIG_LOCK()
    if site is None or _mode == "off":
        return real
    return _LockGuard(real, site, reentrant=False)


def _make_rlock():
    site = _site()
    real = _ORIG_RLOCK()
    if site is None or _mode == "off":
        return real
    return _LockGuard(real, site, reentrant=True)


def _held() -> list:
    held = getattr(_tls, "held", None)
    if held is None:
        held = _tls.held = []
    return held


def _stack() -> str:
    """The current stack, lockguard frames trimmed."""
    frames = traceback.extract_stack()
    keep = [
        f for f in frames
        if "utils/lockguard" not in f.filename.replace(os.sep, "/")
    ]
    return "".join(traceback.format_list(keep[-12:]))


def _reaches(src: str, dst: str) -> list[str] | None:
    """DFS path ``src -> ... -> dst`` in the happened-before graph, or
    None. Called under _meta."""
    stack = [(src, [src])]
    seen = {src}
    while stack:
        node, path = stack.pop()
        for nxt in _edges.get(node, ()):
            if nxt == dst:
                return path + [dst]
            if nxt not in seen:
                seen.add(nxt)
                stack.append((nxt, path + [nxt]))
    return None


#: Optional observer for inversion reports: ``obs/dtrace.py``'s
#: flight recorder registers here (``FlightRecorder.watch_lockguard``)
#: so a runtime lock-order warning triggers a black-box dump. Called
#: after the record is appended and after the graph's lock is released
#: (the observer takes locks of its own, which the guard then checks);
#: a raising observer is swallowed (reporting must not add failure
#: modes to the thing being reported on).
on_report = None


def _record(kind: str, message: str, record: dict) -> dict:
    """Append one report (under ``_meta``); :func:`_notify` delivers it."""
    record = {"kind": kind, "message": message, **record}
    _inversions.append(record)
    return record


def _notify(record: dict | None) -> None:
    """Deliver a report outside ``_meta``: the observer, then the raise
    (strict) or the warning (witness)."""
    if record is None:
        return
    cb = on_report
    if cb is not None:
        try:
            cb(dict(record))
        except Exception:
            pass
    if _mode == "strict":
        raise LockOrderViolation(record["message"])
    warnings.warn(f"GNOT_LOCK_GUARD: {record['message']}", stacklevel=4)


class _LockGuard:
    """A project lock: the real primitive plus order bookkeeping."""

    __slots__ = ("_real", "site", "reentrant")

    def __init__(self, real, site: str, reentrant: bool):
        self._real = real
        self.site = site
        self.reentrant = reentrant

    def __repr__(self):
        return f"<lockguard {'RLock' if self.reentrant else 'Lock'} {self.site}>"

    def acquire(self, blocking: bool = True, timeout: float = -1):
        if _mode != "off":
            self._before()
        ok = (
            self._real.acquire(blocking, timeout)
            if timeout != -1
            else self._real.acquire(blocking)
        )
        if ok:
            _held().append(self)
        return ok

    def release(self):
        self._real.release()
        held = _held()
        for i in range(len(held) - 1, -1, -1):
            if held[i] is self:
                del held[i]
                break

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def locked(self):
        return self._real.locked()

    def _before(self) -> None:
        """Pre-acquire ordering checks: self-deadlock and cycle-closing
        edges are reported BEFORE the real acquire (strict mode must
        raise while the thread can still raise)."""
        held = _held()
        if not held:
            return
        report = None
        if not self.reentrant and any(g is self for g in held):
            with _meta:
                key = (self.site, self.site)
                if key not in _reported:
                    _reported.add(key)
                    stack = _stack()
                    report = _record(
                        "self-deadlock",
                        f"non-reentrant lock {self.site} re-acquired by "
                        f"its holding thread (this acquire never "
                        f"returns)\n--- acquiring stack ---\n{stack}",
                        {"cycle": [self.site], "stacks": [stack]},
                    )
            _notify(report)
            return
        holder = held[-1]
        if holder is self or holder.site == self.site:
            # Reentrant re-acquire, or a sibling instance from the
            # same construction site: no orderable edge either way.
            return
        with _meta:
            edge = (holder.site, self.site)
            if self.site in _edges.get(holder.site, ()):
                return  # known edge: steady state, no stack capture
            stack = _stack()
            _edges.setdefault(holder.site, set()).add(self.site)
            _edge_stacks[edge] = stack
            back = _reaches(self.site, holder.site)
            if back is None:
                return
            cycle = [holder.site] + back
            key = (holder.site, self.site)
            if key in _reported:
                return
            _reported.add(key)
            first = _edge_stacks.get((back[0], back[1]), "<unrecorded>")
            report = _record(
                "inversion",
                f"lock-order inversion: acquiring {self.site} while "
                f"holding {holder.site}, but the reverse order "
                f"{' -> '.join(cycle)} was already witnessed\n"
                f"--- this acquisition ---\n{stack}"
                f"--- first reverse witness ({back[0]} -> {back[1]}) ---\n"
                f"{first}",
                {"cycle": cycle, "stacks": [stack, first]},
            )
        _notify(report)


def inversions() -> list[dict]:
    """Reported inversions so far (test/triage introspection)."""
    with _meta:
        return list(_inversions)


def edge_count() -> int:
    """Witnessed happened-before edges (test/triage introspection)."""
    with _meta:
        return sum(len(v) for v in _edges.values())


def reset() -> None:
    """Drop the happened-before graph and reports (test isolation).
    Held-stack state is per-thread and survives: callers reset
    between scenarios, not mid-acquisition."""
    with _meta:
        _edges.clear()
        _edge_stacks.clear()
        _inversions.clear()
        _reported.clear()
