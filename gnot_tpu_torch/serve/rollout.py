"""Stateful autoregressive rollout sessions for the serving tier.

Port of ``gnot_tpu/serve/rollout.py``. One-shot serving answers
``f(sample) -> field``; a rollout is ``K`` chained dispatches of one
request: step ``k+1``'s input is derived from step ``k``'s prediction, and
the carry stays with the server between steps. The carry is host state, as
in JAX: each step's output comes back to the host, and the next step's
input goes up to the card like any request's.

* ``advance_sample``: the carry. ``theta`` advances by ``dt`` and the
  input functions' trailing value channels are refreshed from the
  predicted field, so every step depends on the one before. Shapes never
  change, so a session stays in one bucket and concurrent sessions at
  different steps batch together through the ordinary ``Batcher``.
* ``offline_rollout``: the engine-only K-step loop, the reference a served
  rollout is held to (``parity_check``, 1e-5 a step).
* ``RolloutSession``: id, step cursor, carry, per-step and whole-rollout
  deadlines, and the rolling host-side snapshot taken every
  ``snapshot_every`` committed steps.
* ``RolloutFuture``: the client's future with streamed partial results
  (``iter_steps()``, or an ``on_step`` callback); it always resolves to a
  ``RolloutResult``: completed, partial with ``drained_at_step``, or shed
  with a reason.
* ``SessionStore``: one ``.npz`` per named session, written atomically, so
  a drained session resumes on a restarted server (``resume_rollout``).
  Its files are JAX's: either package reads the other's.

A session is mutated by the server's worker thread and read by the
client's and the drain's threads: its mutable state is under its own lock.
Numpy and stdlib only.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import queue
import re
import threading
from concurrent.futures import Future
from typing import Callable, Iterator, Sequence

import numpy as np

from gnot_tpu_torch.data.batch import MeshSample

#: Default time increment of a rollout step (the theta advance).
ROLLOUT_DT = 0.05

#: Terminal reasons of a rollout beyond the one-shot reasons a failing
#: step passes through: "ok" (all K steps), "drained" (partial, with the
#: ``drained_at_step`` marker).
ROLLOUT_REASONS = ("ok", "drained")


def advance_sample(
    sample: MeshSample, output: np.ndarray, *, dt: float = ROLLOUT_DT
) -> MeshSample:
    """The next step's request from this step's prediction: ``theta``
    advances by ``dt``; each input function's trailing value channels take
    the predicted field at its first ``m`` points (the synthetic
    generators' function meshes are node-mesh prefixes). Coordinates and
    every shape are kept exactly, so the rollout stays in one bucket. All
    arrays are fresh copies: the previous sample (which may be a held
    snapshot) is never written."""
    out = np.asarray(output, dtype=np.float32)
    funcs = []
    for f in sample.funcs:
        f_new = np.array(f, dtype=np.float32)
        k = min(f_new.shape[1], out.shape[1])
        t = min(f_new.shape[0], out.shape[0])
        f_new[:t, f_new.shape[1] - k:] = out[:t, :k]
        funcs.append(f_new)
    theta = (np.asarray(sample.theta, dtype=np.float32) + np.float32(dt)).astype(np.float32)
    return MeshSample(
        coords=np.array(sample.coords, dtype=np.float32),
        y=np.array(sample.y, dtype=np.float32),
        theta=theta,
        funcs=tuple(funcs),
    )


def offline_rollout(
    engine,
    sample: MeshSample,
    steps: int,
    *,
    rows: int | None = None,
    advance: Callable = advance_sample,
    dt: float = ROLLOUT_DT,
) -> list[np.ndarray]:
    """The engine-only K-step loop (no server): the trajectory a served
    rollout must match, 1e-5 a step. ``rows`` pins the dispatch's row
    count to the server's ``max_batch``."""
    if steps < 1:
        raise ValueError(f"rollout needs steps >= 1, got {steps}")
    outs: list[np.ndarray] = []
    cur = sample
    for _ in range(steps):
        pn, pf = engine.bucket_key(cur)
        out = engine.infer([cur], pad_nodes=pn, pad_funcs=pf, rows=rows)[0]
        outs.append(out)
        cur = advance(cur, out, dt=dt)
    return outs


@dataclasses.dataclass
class RolloutResult:
    """What a rollout future resolves to, on every path. ``ok`` means all
    ``steps`` completed; otherwise ``reason`` names the end ("drained",
    with ``drained_at_step``, or the failing step's one-shot reason), and
    ``outputs`` holds the committed prefix."""

    ok: bool
    reason: str
    session: str
    steps: int
    steps_completed: int
    outputs: list = dataclasses.field(default_factory=list)
    drained_at_step: int | None = None
    migrations: int = 0
    detail: str = ""


class RolloutFuture(Future):
    """A future of a ``RolloutResult`` that also streams each committed
    step to ``iter_steps()``; the stream closes when the future resolves,
    so iteration always ends."""

    def __init__(self):
        super().__init__()
        self._step_queue: queue.Queue = queue.Queue()

    def _publish(self, step: int, output: np.ndarray) -> None:
        self._step_queue.put((step, output))

    def _close_stream(self) -> None:
        self._step_queue.put(None)

    def iter_steps(self, timeout: float | None = None) -> Iterator[tuple]:
        """Yield ``(step, output)`` (1-indexed, in order) as the rollout
        goes on; return when the session reaches its end."""
        while True:
            item = self._step_queue.get(timeout=timeout)
            if item is None:
                return
            yield item


class RolloutSession:
    """One rollout in flight: identity, cursor, carry, rolling snapshot and
    the client's future. ``tenant`` is inherited by every step request and
    carried through ``snapshot_state`` / ``from_state``. ``migrate_cb`` is
    the router's hand-over (None on a standalone server, where a failed
    step ends the session)."""

    def __init__(
        self,
        sid: str,
        sample: MeshSample,
        steps: int,
        *,
        snapshot_every: int = 1,
        step_deadline_ms: float | None = None,
        rollout_deadline: float | None = None,
        on_step: Callable | None = None,
        advance: Callable = advance_sample,
        dt: float = ROLLOUT_DT,
        tenant: str | None = None,
    ):
        if steps < 1:
            raise ValueError(f"rollout needs steps >= 1, got {steps}")
        if snapshot_every < 1:
            raise ValueError(f"snapshot_every must be >= 1, got {snapshot_every}")
        self.sid = sid
        self.steps = steps
        self.snapshot_every = snapshot_every
        self.step_deadline_ms = step_deadline_ms
        # The absolute whole-rollout expiry on the server's clock (None:
        # no budget); every step's deadline is clamped to it.
        self.rollout_deadline = rollout_deadline
        self.on_step = on_step
        self.advance = advance
        self.dt = dt
        self.tenant = tenant
        self.future = RolloutFuture()
        # Only sessions the client named persist to a SessionStore: an
        # automatic id restarts from 1 in every process.
        self.named = False
        self.migrate_cb: Callable | None = None
        # The propagated cluster trace context (obs/dtrace.TraceContext) a
        # federated placement installs: every step request adopts the same
        # decision, so steps resumed after a migration stay spans of the
        # original trace. None: a locally placed session, whose steps run
        # untraced.
        self.trace_ctx = None
        self._lock = threading.Lock()
        self._sample = sample  #: guarded_by _lock
        self._cursor = 0  #: guarded_by _lock
        self._outputs: list = []  #: guarded_by _lock
        # The rolling last-good snapshot: taken at creation (step 0 is
        # always restorable) and every snapshot_every committed steps.
        self._snapshot = {"cursor": 0, "sample": sample, "outputs": []}  #: guarded_by _lock
        self._streamed = 0  #: guarded_by _lock
        self._migrations = 0  #: guarded_by _lock
        self._resolved = False  #: guarded_by _lock

    @property
    def sample(self) -> MeshSample:
        """The current carry: the next step's request."""
        with self._lock:
            return self._sample

    @property
    def cursor(self) -> int:
        """Committed steps (the next to run is ``cursor + 1``)."""
        with self._lock:
            return self._cursor

    @property
    def finished(self) -> bool:
        with self._lock:
            return self._cursor >= self.steps

    @property
    def migrations(self) -> int:
        with self._lock:
            return self._migrations

    def record_step(self, output: np.ndarray) -> int:
        """Commit one completed step and advance the carry; returns the
        1-indexed step committed."""
        with self._lock:
            self._outputs.append(output)
            self._cursor += 1
            if self._cursor < self.steps:
                self._sample = self.advance(self._sample, output, dt=self.dt)
            return self._cursor

    def publish_step(self, step: int, output: np.ndarray) -> None:
        """Stream one committed step to the client (callback and
        iterator), once per step index."""
        with self._lock:
            if step <= self._streamed:
                return
            self._streamed = step
        if self.on_step is not None:
            self.on_step(self.sid, step, output)
        self.future._publish(step, output)

    def snapshot_due(self) -> bool:
        with self._lock:
            return (self._cursor < self.steps
                    and self._cursor - self._snapshot["cursor"] >= self.snapshot_every)

    def take_snapshot(self) -> int:
        """Copy the carry and the committed prefix host-side; returns the
        snapshot's cursor."""
        with self._lock:
            self._snapshot = {
                "cursor": self._cursor, "sample": self._sample, "outputs": list(self._outputs),
            }
            return self._cursor

    def snapshot_state(self) -> dict:
        """The last snapshot (not the live cursor) as a plain dict: what
        the ``SessionStore`` persists."""
        with self._lock:
            snap = self._snapshot
            return {
                "sid": self.sid,
                "steps": self.steps,
                "cursor": snap["cursor"],
                "sample": snap["sample"],
                "outputs": list(snap["outputs"]),
                "dt": self.dt,
                "tenant": self.tenant,
            }

    @classmethod
    def from_state(
        cls,
        state: dict,
        *,
        snapshot_every: int = 1,
        step_deadline_ms: float | None = None,
        rollout_deadline: float | None = None,
        on_step: Callable | None = None,
        advance: Callable = advance_sample,
    ) -> "RolloutSession":
        """A session rebuilt from a persisted ``snapshot_state``: the next
        step to run is ``cursor + 1``, and the restored prefix counts as
        already streamed."""
        s = cls(
            state["sid"],
            state["sample"],
            state["steps"],
            snapshot_every=snapshot_every,
            step_deadline_ms=step_deadline_ms,
            rollout_deadline=rollout_deadline,
            on_step=on_step,
            advance=advance,
            dt=state.get("dt", ROLLOUT_DT),
            tenant=state.get("tenant"),
        )
        s.named = True  # only named sessions are persisted
        with s._lock:
            s._cursor = int(state["cursor"])
            s._outputs = list(state["outputs"])
            s._snapshot = {
                "cursor": s._cursor, "sample": state["sample"], "outputs": list(state["outputs"]),
            }
            s._streamed = s._cursor
        return s

    def restore_from_snapshot(self) -> int:
        """Roll back to the last snapshot (cursor, carry, prefix) and count
        one migration; returns the cursor the replay resumes from."""
        with self._lock:
            self._cursor = self._snapshot["cursor"]
            self._sample = self._snapshot["sample"]
            self._outputs = list(self._snapshot["outputs"])
            self._migrations += 1
            return self._cursor

    def resolve(
        self,
        ok: bool,
        reason: str,
        *,
        drained_at_step: int | None = None,
        detail: str = "",
    ) -> bool:
        """Resolve the client's future with its ``RolloutResult``.
        Idempotent: the first caller wins, a late duplicate (a drain racing
        the worker) is a no-op. True when this call resolved it."""
        with self._lock:
            if self._resolved:
                return False
            self._resolved = True
            result = RolloutResult(
                ok=ok,
                reason=reason,
                session=self.sid,
                steps=self.steps,
                steps_completed=self._cursor,
                outputs=list(self._outputs),
                drained_at_step=drained_at_step,
                migrations=self._migrations,
                detail=detail,
            )
        self.future.set_result(result)
        self.future._close_stream()
        return True


class SessionStore:
    """On-disk rollout snapshots: a drain persists every open named
    session's final snapshot here, and a restarted server resumes it from
    that step (``resume_rollout``).

    One ``.npz`` per session: the carry's arrays, the committed outputs
    and a JSON meta record (sid, steps, cursor, dt, tenant), under the
    sanitized name plus a sha1 digest of the raw name (two sids that
    sanitize alike get two files). Writes go to a temporary file that is
    then renamed, so a crash mid-write leaves the previous snapshot whole.
    One writer per session (the draining server)."""

    def __init__(self, directory: str):
        if not directory:
            raise ValueError("SessionStore needs a directory")
        self.directory = directory
        os.makedirs(directory, exist_ok=True)

    def _path(self, name: str) -> str:
        safe = re.sub(r"[^A-Za-z0-9._-]", "_", name)
        digest = hashlib.sha1(name.encode()).hexdigest()[:8]
        return os.path.join(self.directory, f"{safe}-{digest}.session.npz")

    def names(self) -> list[str]:
        """The persisted sessions' sids, from each file's meta record
        (unreadable files are skipped)."""
        out = []
        for fn in sorted(os.listdir(self.directory)):
            if not fn.endswith(".session.npz"):
                continue
            try:
                with np.load(os.path.join(self.directory, fn), allow_pickle=False) as z:
                    out.append(json.loads(str(z["meta"]))["sid"])
            except (OSError, KeyError, ValueError):
                continue
        return out

    def save(self, session: RolloutSession) -> str:
        """Persist the session's last snapshot; returns the path."""
        state = session.snapshot_state()
        sample: MeshSample = state["sample"]
        arrays = {
            "coords": np.asarray(sample.coords),
            "y": np.asarray(sample.y),
            "theta": np.asarray(sample.theta),
        }
        for i, f in enumerate(sample.funcs):
            arrays[f"func_{i}"] = np.asarray(f)
        for i, o in enumerate(state["outputs"]):
            arrays[f"out_{i}"] = np.asarray(o)
        meta = {
            "sid": state["sid"],
            "steps": state["steps"],
            "cursor": state["cursor"],
            "dt": state["dt"],
            "tenant": state.get("tenant"),
            "n_funcs": len(sample.funcs),
            "n_outputs": len(state["outputs"]),
        }
        path = self._path(state["sid"])
        tmp = f"{path}.tmp"
        with open(tmp, "wb") as fh:
            np.savez(fh, meta=json.dumps(meta), **arrays)
        os.replace(tmp, path)
        return path

    def load(self, name: str) -> dict | None:
        """The persisted ``snapshot_state`` of ``name`` (None when there is
        none), for ``RolloutSession.from_state``."""
        try:
            z = np.load(self._path(name), allow_pickle=False)
        except FileNotFoundError:  # never written, or deleted by its finished owner
            return None
        with z:
            meta = json.loads(str(z["meta"]))
            sample = MeshSample(
                coords=z["coords"],
                y=z["y"],
                theta=z["theta"],
                funcs=tuple(z[f"func_{i}"] for i in range(meta["n_funcs"])),
            )
            outputs = [z[f"out_{i}"] for i in range(meta["n_outputs"])]
        return {
            "sid": meta["sid"],
            "steps": meta["steps"],
            "cursor": meta["cursor"],
            "dt": meta["dt"],
            "tenant": meta.get("tenant"),
            "sample": sample,
            "outputs": outputs,
        }

    def delete(self, name: str) -> None:
        """Drop a persisted snapshot (a resumed session that completed
        leaves none behind)."""
        try:
            os.remove(self._path(name))
        except FileNotFoundError:
            pass


def parity_check(
    served: Sequence[np.ndarray],
    reference: Sequence[np.ndarray],
    *,
    atol: float = 1e-5,
) -> float:
    """The worst per-step absolute deviation of a served rollout from the
    offline reference; raises when the step counts differ."""
    if len(served) != len(reference):
        raise ValueError(
            f"served rollout has {len(served)} steps, reference {len(reference)}"
        )
    worst = 0.0
    for got, want in zip(served, reference):
        worst = max(worst, float(np.max(np.abs(got - want))))
    return worst
