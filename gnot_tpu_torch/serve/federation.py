"""The federation: a multi-host control plane over loopback.

Port of ``gnot_tpu/serve/federation.py``. Every host is a
``ReplicaRouter`` (``serve/router.py``, unchanged underneath) behind a
``HostAgent``, and hosts talk only through a versioned, length-prefixed
JSON wire protocol; a ``ClusterRouter`` places requests and rollout
sessions across them. On one card the hosts are threads of one process,
their replicas each on its own CUDA stream; the data plane stays local,
the control plane is honest about topology.

Three layers, bottom up:

* **Wire protocol**: a 4-byte big-endian length prefix and a UTF-8 JSON
  payload. ``MESSAGES`` is the wire-schema registry; every frame is built
  by :func:`wire`, which validates against it. ``FrameDecoder`` is a
  tolerant parser: truncated frames buffer, garbage is counted and
  skipped, oversize frames are drained in skip mode, so a malformed peer
  can never wedge a host. Version skew is refused at the ``hello``
  handshake. The wire is JAX's byte for byte (``PROTOCOL_VERSION``,
  ``MAX_FRAME_BYTES``, kinds, fields, frames, the sample codec): a JAX
  controller drives a port host.
* **Transports**: ``TcpLink`` speaks real loopback TCP (a socket and a
  reader thread); ``InProcLink`` delivers the same encoded bytes
  synchronously on the caller's thread with an injectable clock, so the
  chaos hooks (partitions, dropped and delayed frames, host kills) are
  deterministic. Both feed the same ``FrameDecoder``.
* **Control plane**: ``HostAgent`` serves the protocol for one host's
  pool (place, stream, drain, stats, scale, trace pull). ``ClusterRouter``
  is the controller: lease heartbeats feed a suspicion-then-dead
  ``FailureDetector`` (a silent host dwells in SUSPECT, drained around by
  hedged placements, before it is declared dead); one-shots hedge and
  re-deliver to survivors with at-least-once suppression (the first
  ``result`` wins); a dead host's sessions re-migrate to a survivor from
  their persisted ``SessionStore`` snapshots (``persist_snapshots``: the
  replayed steps below the cluster's high-water mark are suppressed);
  ``drain()`` resolves every future and emits one ``cluster_summary``.
  With cluster tracing (``obs/dtrace.py``) the controller decides head
  sampling once per request, propagates it as ``trace_ctx``, records the
  ``placement`` / ``cluster_request`` / ``cluster_rollout`` spans, pulls
  every host's spans at drain and writes one merged trace.

Chaos enters where real systems fail (``resilience/faults.py``):
``host_kill@N`` (an agent dies before its N-th inbound control message),
``net_partition@N`` / ``msg_drop@N`` (an in-proc link's N-th outbound
frame partitions the link / vanishes), ``msg_delay@MS`` (one frame held MS
milliseconds of the link's clock).

A result frame carries its output as a numpy array: the engine copies it
to the host on its replica's stream before the future resolves, so the
frame is encoded from memory the card has finished writing.

The one difference from JAX is AOT: eager PyTorch has no executable to
serialize, so ``manifests=`` raises ``NotPortedError`` for a non-empty
dict and an agent answers ``prewarm`` with an ``error`` frame and goes on
serving. Numpy, torch-free; the router is imported where a federation is
built.
"""

from __future__ import annotations

import base64
import json
import socket
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Callable

import numpy as np

from gnot_tpu_torch.config import NotPortedError
from gnot_tpu_torch.data.batch import MeshSample
from gnot_tpu_torch.obs import dtrace, events
from gnot_tpu_torch.serve.rollout import RolloutResult
from gnot_tpu_torch.serve.server import ServeResult

# -- wire protocol: framing -------------------------------------------------

#: Protocol generation; a ``hello`` carrying another is refused with
#: ``hello_reject`` (version skew fails at connect time, never mid-storm).
PROTOCOL_VERSION = 1

#: Per-frame payload ceiling. A larger length prefix is treated as corrupt:
#: the decoder drains the declared bytes in skip mode and counts
#: ``oversize``.
MAX_FRAME_BYTES = 8 * 1024 * 1024


class ProtocolError(RuntimeError):
    """The wire contract failed: version skew, a message invalid against
    ``MESSAGES``, a handshake timeout."""


def encode_frame(msg: dict) -> bytes:
    """One wire frame: 4-byte big-endian payload length + UTF-8 JSON."""
    payload = json.dumps(msg, separators=(",", ":")).encode("utf-8")
    if len(payload) > MAX_FRAME_BYTES:
        raise ProtocolError(f"frame payload {len(payload)}B exceeds MAX_FRAME_BYTES")
    return len(payload).to_bytes(4, "big") + payload


class FrameDecoder:
    """The receiving half of the wire: ``feed(data)`` takes any byte split
    and returns the complete, well-formed messages it can extract. A
    truncated frame buffers; a zero length or a payload that is not a JSON
    object with a ``kind`` counts in ``garbage``; a length above
    ``max_frame_bytes`` counts in ``oversize`` and its declared payload is
    drained without buffering. Raw garbage is misread as a length prefix
    and consumed as a bogus frame: skipped bytes and counters, never an
    exception or an unbounded buffer."""

    def __init__(self, max_frame_bytes: int = MAX_FRAME_BYTES) -> None:
        self.max_frame_bytes = max_frame_bytes
        self._buf = bytearray()
        self._skip = 0  # bytes of an oversize payload left to drain
        self.garbage = 0
        self.oversize = 0

    def feed(self, data: bytes) -> list[dict]:
        self._buf.extend(data)
        out: list[dict] = []
        while True:
            if self._skip:
                take = min(self._skip, len(self._buf))
                del self._buf[:take]
                self._skip -= take
                if self._skip:
                    break
                continue
            if len(self._buf) < 4:
                break
            n = int.from_bytes(self._buf[:4], "big")
            if n == 0:
                self.garbage += 1
                del self._buf[:4]
                continue
            if n > self.max_frame_bytes:
                self.oversize += 1
                del self._buf[:4]
                self._skip = n
                continue
            if len(self._buf) < 4 + n:
                break
            payload = bytes(self._buf[4:4 + n])
            del self._buf[:4 + n]
            try:
                msg = json.loads(payload.decode("utf-8"))
            except (UnicodeDecodeError, json.JSONDecodeError):
                self.garbage += 1
                continue
            if not isinstance(msg, dict) or "kind" not in msg:
                self.garbage += 1
                continue
            out.append(msg)
        return out


# -- wire protocol: the message registry -------------------------------------


@dataclass(frozen=True)
class MessageSpec:
    """One wire message kind: required fields, a one-line doc, optional
    fields."""

    fields: tuple[str, ...]
    doc: str
    optional: tuple[str, ...] = ()


# Controller-to-agent kinds.
HELLO = "hello"
HEARTBEAT = "heartbeat"
SUBMIT = "submit"
SUBMIT_ROLLOUT = "submit_rollout"
DRAIN = "drain"
STATS = "stats"
PREWARM = "prewarm"
SCALE = "scale"
TRACE_PULL = "trace_pull"
# Agent-to-controller kinds.
HELLO_OK = "hello_ok"
HELLO_REJECT = "hello_reject"
HEARTBEAT_ACK = "heartbeat_ack"
RESULT = "result"
PLACED = "placed"
STEP = "step"
ROLLOUT_DONE = "rollout_done"
DRAIN_OK = "drain_ok"
STATS_OK = "stats_ok"
PREWARM_OK = "prewarm_ok"
SCALE_OK = "scale_ok"
TRACE_OK = "trace_ok"
ERROR = "error"

#: The wire-schema registry, JAX's kinds, fields and optional fields.
MESSAGES: dict[str, MessageSpec] = {
    "hello": MessageSpec(
        fields=("version",),
        doc="Controller handshake; carries the controller's protocol "
        "version for skew refusal.",
        optional=("cluster",),
    ),
    "hello_ok": MessageSpec(
        fields=("version", "host", "pool"),
        doc="Agent accepts the handshake: its host id, pool size and "
        "(optionally) topology key.",
        optional=("topology",),
    ),
    "hello_reject": MessageSpec(
        fields=("version", "want"),
        doc="Version-skew refusal: the agent's version and the version it "
        "requires. The controller raises ProtocolError.",
        optional=("host",),
    ),
    "heartbeat": MessageSpec(
        fields=("seq",),
        doc="Controller lease probe, sequenced per round; `t` stamps the "
        "controller's send clock for the clock-alignment exchange.",
        optional=("t",),
    ),
    "heartbeat_ack": MessageSpec(
        fields=("seq", "host", "load"),
        doc="Agent lease renewal: echoes seq, reports queue load; `t` "
        "echoes the probe's stamp and `agent_t` adds the agent's clock "
        "(one midpoint clock-offset sample a round).",
        optional=("pool", "sessions", "depth", "t", "agent_t"),
    ),
    "submit": MessageSpec(
        fields=("id", "sample"),
        doc="Place one one-shot request (base64 array codec) on the agent's "
        "local router. `trace_ctx` carries the cluster's head-sampling "
        "decision; the host never re-decides it.",
        optional=("deadline_ms", "tenant", "trace_ctx"),
    ),
    "result": MessageSpec(
        fields=("id", "ok"),
        doc="Terminal reply for a one-shot submit; duplicates from hedged "
        "placements are suppressed (first wins).",
        optional=("reason", "output", "latency_ms", "detail"),
    ),
    "submit_rollout": MessageSpec(
        fields=("id", "steps"),
        doc="Place (resume=false) or re-migrate (resume=true, from the "
        "persisted snapshot) a rollout session; `trace_ctx` carries the "
        "session's original trace context on every placement.",
        optional=(
            "sample",
            "name",
            "resume",
            "deadline_ms",
            "rollout_deadline_ms",
            "tenant",
            "trace_ctx",
        ),
    ),
    "placed": MessageSpec(
        fields=("id", "host", "at_step"),
        doc="Rollout placement ack; at_step is the restored snapshot cursor "
        "(0 for a fresh session), the migration replay point.",
    ),
    "step": MessageSpec(
        fields=("id", "step", "output"),
        doc="One committed rollout step streamed back; the cluster's "
        "high-water mark suppresses replayed duplicates.",
    ),
    "rollout_done": MessageSpec(
        fields=("id", "ok"),
        doc="Terminal reply for a rollout session; carries all per-step "
        "outputs so step frames lost to a healed partition are repaired.",
        optional=(
            "reason",
            "steps_completed",
            "migrations",
            "drained_at_step",
            "detail",
            "outputs",
        ),
    ),
    "drain": MessageSpec(
        fields=(),
        doc="Coordinated drain: the agent drains its local pool and replies "
        "drain_ok with the pool serve_summary.",
        optional=("timeout_s",),
    ),
    "drain_ok": MessageSpec(
        fields=("host", "summary"),
        doc="Drain completion with the host's pool summary.",
    ),
    "stats": MessageSpec(
        fields=("seq",),
        doc="Poll the agent's MetricsRegistry snapshot.",
    ),
    "stats_ok": MessageSpec(
        fields=("seq", "host", "series"),
        doc="Registry snapshot reply; the controller prefixes series keys "
        "with the host id and merges across hosts.",
    ),
    "prewarm": MessageSpec(
        fields=("manifest",),
        doc="Hydrate the joiner's pool from an AOT deploy manifest (the port "
        "answers error: eager PyTorch has no executable to serialize).",
    ),
    "prewarm_ok": MessageSpec(
        fields=("host", "replicas"),
        doc="Prewarm completion: replicas hydrated.",
    ),
    "scale": MessageSpec(
        fields=("direction",),
        doc="Cluster-scoped scale order ('up'/'down') to the least-loaded "
        "live host.",
        optional=("reason",),
    ),
    "scale_ok": MessageSpec(
        fields=("host", "ok", "pool"),
        doc="Scale order outcome with the host's new pool size.",
        optional=("detail",),
    ),
    "trace_pull": MessageSpec(
        fields=("seq",),
        doc="Collect the agent's span buffer for cross-host stitching (sent "
        "by ClusterRouter.drain before the merged trace is written).",
    ),
    "trace_ok": MessageSpec(
        fields=("seq", "host", "trace"),
        doc="Trace-pull reply: the host tracer's Chrome export (empty when "
        "untraced) and its `coverage` counters.",
        optional=("coverage",),
    ),
    "error": MessageSpec(
        fields=("reason",),
        doc="Agent-side failure for one inbound message (unknown kind, schema "
        "violation, a path not ported); bad_kind names the offending kind; "
        "the stream continues.",
        optional=("detail", "bad_kind"),
    ),
}

_CONSTANT_KINDS = {
    v for k, v in list(globals().items())
    if k.isupper() and isinstance(v, str) and v in MESSAGES
}
assert _CONSTANT_KINDS == set(MESSAGES), (
    "MESSAGES registry and module constants diverged: "
    f"{_CONSTANT_KINDS.symmetric_difference(set(MESSAGES))}"
)


def validate_message(msg: dict) -> None:
    """Raise :class:`ProtocolError` unless ``msg`` matches its registered
    spec (an unknown kind, a required field missing). Extra fields pass."""
    kind = msg.get("kind")
    spec = MESSAGES.get(kind)
    if spec is None:
        raise ProtocolError(f"unregistered message kind {kind!r}")
    missing = [f for f in spec.fields if f not in msg]
    if missing:
        raise ProtocolError(f"message {kind!r} missing fields {missing}")


def wire(_kind: str, **fields) -> dict:
    """One validated wire message; every frame either side sends is built
    here."""
    msg = {"kind": _kind, **fields}
    validate_message(msg)
    return msg


# -- the array and sample codec (byte-exact: base64 of the raw buffer) -------


def _enc_arr(a) -> dict | None:
    if a is None:
        return None
    a = np.ascontiguousarray(a)
    return {
        "shape": list(a.shape),
        "dtype": str(a.dtype),
        "b64": base64.b64encode(a.tobytes()).decode("ascii"),
    }


def _dec_arr(d) -> np.ndarray | None:
    if d is None:
        return None
    raw = base64.b64decode(d["b64"])
    return np.frombuffer(raw, dtype=np.dtype(d["dtype"])).reshape(d["shape"]).copy()


def encode_sample(sample: MeshSample) -> dict:
    """A JSON-safe MeshSample: every array round-trips byte-exactly."""
    return {
        "coords": _enc_arr(sample.coords),
        "y": _enc_arr(sample.y),
        "theta": _enc_arr(sample.theta),
        "funcs": [_enc_arr(f) for f in sample.funcs],
    }


def decode_sample(d: dict) -> MeshSample:
    return MeshSample(
        coords=_dec_arr(d["coords"]),
        y=_dec_arr(d["y"]),
        theta=_dec_arr(d["theta"]),
        funcs=tuple(_dec_arr(f) for f in d["funcs"]),
    )


def topology_key(hosts: int, replicas_per_host: int) -> str:
    """The topology's identity (JAX matches AOT manifests on it): ``h2r3``
    is 2 hosts of 3 replicas each."""
    return f"h{hosts}r{replicas_per_host}"


# -- the failure detector: ALIVE -> SUSPECT -> DEAD, with dwell ----------------

ALIVE = "alive"
SUSPECT = "suspect"
DEAD = "dead"


class FailureDetector:
    """Lease-based suspicion-then-dead detector. A host silent for
    ``suspect_after_s`` is SUSPECT (drained around: hedged placements, no
    new work, its in-flight work left alone) and DEAD only after
    ``dead_after_s``: slowness is far more common than death, and a false
    kill costs a migration storm. Any ack revives, from DEAD too (a
    partition healing)."""

    def __init__(self, *, suspect_after_s: float = 2.0, dead_after_s: float = 6.0,
                 clock: Callable[[], float] = time.monotonic) -> None:
        if not 0 < suspect_after_s < dead_after_s:
            raise ValueError(
                "need 0 < suspect_after_s < dead_after_s (the dwell), "
                f"got {suspect_after_s} / {dead_after_s}"
            )
        self.suspect_after_s = suspect_after_s
        self.dead_after_s = dead_after_s
        self._clock = clock
        self._last: dict[str, float] = {}
        self._state: dict[str, str] = {}
        self._probe_start: dict[str, float] = {}  # the first unanswered probe

    def register(self, host: str) -> None:
        self._last[host] = self._clock()
        self._state[host] = ALIVE
        self._probe_start.pop(host, None)

    def probe(self, host: str) -> None:
        """A liveness probe was just sent. Silence is anchored at the first
        unanswered probe, so a controller idle between registration and
        its first heartbeat round (warm-up, a long pause) never bills its
        own gap as host silence."""
        if host not in self._probe_start:
            self._probe_start[host] = self._clock()

    def ack(self, host: str) -> str:
        """Lease renewal from any state; returns the previous state, so the
        caller can reconcile a revival."""
        old = self._state.get(host, DEAD)
        self._last[host] = self._clock()
        self._state[host] = ALIVE
        self._probe_start.pop(host, None)
        return old

    def state(self, host: str) -> str:
        return self._state.get(host, DEAD)

    def silent_s(self, host: str) -> float:
        now = self._clock()
        anchor = self._last.get(host, now)
        p = self._probe_start.get(host)
        if p is not None:
            anchor = max(anchor, p)
        return now - anchor

    def sweep(self) -> list[tuple[str, str, str]]:
        """Advance every host's state by its lease age; returns the edges
        ``[(host, old, new), ...]``. DEAD is sticky under silence."""
        edges: list[tuple[str, str, str]] = []
        for host in list(self._last):
            old = self._state[host]
            silent = self.silent_s(host)
            if silent >= self.dead_after_s:
                new = DEAD
            elif silent >= self.suspect_after_s:
                new = SUSPECT if old != DEAD else DEAD
            else:
                new = old  # freshness is recorded by ack(), not here
            if new != old:
                self._state[host] = new
                edges.append((host, old, new))
        return edges


# -- transports --------------------------------------------------------------


class InProcLink:
    """The deterministic in-proc transport: the same encoded frames as TCP,
    delivered synchronously on the caller's thread through real
    ``FrameDecoder``s, with the chaos hooks at the wire. Outbound frames
    are counted per link: ``net_partition@N`` partitions the link both
    ways at the N-th (until :meth:`heal_partition`), ``msg_drop@N`` drops
    the N-th, ``msg_delay@MS`` holds one frame MS milliseconds of the
    link's clock (released by :meth:`flush`, which ``ClusterRouter.tick``
    calls). Replies cross the same partition."""

    def __init__(self, agent: "HostAgent", *, faults=None,
                 clock: Callable[[], float] = time.monotonic) -> None:
        self._agent = agent
        self._faults = faults
        self._clock = clock
        self._n_out = 0
        self.partitioned = False
        self._pending: list[tuple[float, bytes]] = []  # (due, frame)
        self._on_message: Callable[[dict], None] | None = None
        self._to_agent = FrameDecoder()
        self._to_ctrl = FrameDecoder()

    def connect(self, on_message: Callable[[dict], None]) -> None:
        self._on_message = on_message

    def arm(self, faults) -> None:
        """(Re)attach a fault injector; ``build_local_federation`` arms chaos
        after the handshake, so the hello is never its victim."""
        self._faults = faults

    def send(self, msg: dict) -> bool:
        """Controller to agent. False when a fault ate the frame
        (partition, drop) or ``msg_delay`` deferred it."""
        frame = encode_frame(msg)
        self._n_out += 1
        f = self._faults
        if f is not None and f.maybe_net_partition(self._n_out):
            self.partitioned = True
        if self.partitioned:
            return False
        if f is not None and f.maybe_msg_drop(self._n_out):
            return False
        if f is not None:
            delay_ms = f.maybe_msg_delay()
            if delay_ms > 0:
                self._pending.append((self._clock() + delay_ms / 1000.0, frame))
                return False
        self._deliver(frame)
        return True

    def flush(self) -> int:
        """Release every delayed frame now due; returns how many."""
        now = self._clock()
        due = [f for t, f in self._pending if t <= now]
        self._pending = [(t, f) for t, f in self._pending if t > now]
        for frame in due:
            if not self.partitioned:
                self._deliver(frame)
        return len(due)

    def heal_partition(self) -> None:
        self.partitioned = False

    def close(self) -> None:
        self._pending.clear()

    def _deliver(self, frame: bytes) -> None:
        for msg in self._to_agent.feed(frame):
            self._agent.handle(msg, self._reply)

    def _reply(self, msg: dict) -> None:
        """Agent to controller: the same partition, the same codec."""
        if self.partitioned:
            return
        frame = encode_frame(msg)
        if self._on_message is None:
            return
        for m in self._to_ctrl.feed(frame):
            self._on_message(m)

    @property
    def protocol_errors(self) -> int:
        return (self._to_agent.garbage + self._to_agent.oversize
                + self._to_ctrl.garbage + self._to_ctrl.oversize)


class TcpLink:
    """The loopback-TCP transport: a client socket to a ``HostAgent.listen``
    endpoint, each frame written whole under a lock, replies decoded on a
    reader thread and handed to ``connect``'s callback. No chaos hooks:
    this transport proves the protocol against real sockets (partial
    reads, interleaved frames, peer close)."""

    def __init__(self, host: str, port: int, *, timeout_s: float = 5.0):
        self._sock = socket.create_connection((host, port), timeout=timeout_s)
        self._sock.settimeout(0.2)
        # Guards the write path only: one sendall per frame, so concurrent
        # senders never interleave partial frames. recv has one consumer.
        self._wlock = threading.Lock()
        self._decoder = FrameDecoder()
        self._on_message: Callable[[dict], None] | None = None
        self._closed = False
        self._reader: threading.Thread | None = None
        self.partitioned = False  # InProcLink's attribute, never set here

    def connect(self, on_message: Callable[[dict], None]) -> None:
        self._on_message = on_message
        self._reader = threading.Thread(target=self._read_loop, name="fed-link-reader",
                                        daemon=True)
        self._reader.start()

    def send(self, msg: dict) -> bool:
        frame = encode_frame(msg)
        with self._wlock:
            try:
                self._sock.sendall(frame)
                return True
            except OSError:
                return False

    def flush(self) -> int:
        return 0

    def heal_partition(self) -> None:
        self.partitioned = False

    def close(self) -> None:
        """Close the socket and join the reader (it polls every 0.2 s)."""
        self._closed = True
        try:
            self._sock.close()
        except OSError:
            pass
        if self._reader is not None and self._reader is not threading.current_thread():
            self._reader.join(timeout=2.0)

    def _read_loop(self) -> None:
        while not self._closed:
            try:
                data = self._sock.recv(65536)
            except socket.timeout:
                continue
            except OSError:
                return
            if not data:
                return
            for msg in self._decoder.feed(data):
                if self._on_message is not None:
                    self._on_message(msg)

    @property
    def protocol_errors(self) -> int:
        return self._decoder.garbage + self._decoder.oversize


# -- HostAgent: one host's protocol server around its pool --------------------


class HostAgent:
    """The per-host half of the federation: serves the wire protocol for
    one local ``ReplicaRouter``. ``handle(msg, send)`` is the whole server,
    called by ``InProcLink`` synchronously or by the TCP accept loop per
    connection; replies go through the ``send`` the message came with.

    Chaos: ``faults`` arms ``host_kill@N``: the agent dies (stops handling
    and sending; its local work keeps running but nothing leaves the host)
    just before handling its N-th inbound message, as a kill -9 between
    frames; the controller sees only silence.

    At-least-once discipline: after a partition heals the controller
    re-sends in-flight work, so duplicates are normal. ``_inflight`` makes
    a duplicate placement a no-op (the live future streams to the link);
    ``_outbox`` keeps every terminal reply, so a duplicate for finished
    work re-sends the same result instead of re-running it."""

    def __init__(
        self,
        host_id: str,
        router,
        *,
        sink=None,
        faults=None,
        session_store=None,
        metrics=None,
        scale_cb: Callable[[str], int] | None = None,
        version: int = PROTOCOL_VERSION,
        topology: str | None = None,
        tracer=None,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        self.host_id = host_id
        self.router = router
        self.sink = sink
        self.faults = faults
        self.session_store = session_store
        self.metrics = metrics
        self.scale_cb = scale_cb
        self.version = version
        self.topology = topology
        # This host's tracer (the one its router's servers record into):
        # trace_pull exports it, and inbound trace_ctx fields are adopted
        # against it.
        self.tracer = tracer
        self._clock = clock
        self.alive = True
        self.errors = 0  # inbound messages refused with ERROR
        self._n_in = 0  #: guarded_by _lock
        self._inflight: set[str] = set()  #: guarded_by _lock
        self._outbox: dict[str, dict] = {}  #: guarded_by _lock
        self._lock = threading.Lock()
        self._server_sock: socket.socket | None = None
        self._accept_thread: threading.Thread | None = None
        self._conn_threads: list[threading.Thread] = []
        self._stopping = False

    # -- lifecycle ---------------------------------------------------------

    def kill(self) -> None:
        """Silent death: no goodbye frame, no flush."""
        self.alive = False

    def drain_local(self, timeout_s: float = 30.0) -> dict:
        return self.router.drain(timeout_s=timeout_s)

    # -- the protocol server -----------------------------------------------

    def handle(self, msg: dict, send: Callable[[dict], None]) -> None:
        """Serve one inbound message. A schema violation is answered with
        ERROR and the stream continues; nothing is sent once killed."""
        if not self.alive:
            return
        with self._lock:
            self._n_in += 1
            n = self._n_in
        if self.faults is not None and self.faults.maybe_host_kill(n):
            self.kill()
            return
        reply = self._guarded(send)
        try:
            validate_message(msg)
        except ProtocolError as e:
            self.errors += 1
            reply(wire(ERROR, reason=str(e), bad_kind=str(msg.get("kind"))))
            return
        kind = msg["kind"]
        if kind == SUBMIT_ROLLOUT and not msg.get("resume") and "sample" not in msg:
            self.errors += 1
            reply(wire(ERROR, reason="submit_rollout without resume needs a sample",
                       bad_kind=kind))
            return
        try:
            if kind == HELLO:
                self._on_hello(msg, reply)
            elif kind == HEARTBEAT:
                self._on_heartbeat(msg, reply)
            elif kind == SUBMIT:
                self._on_submit(msg, reply)
            elif kind == SUBMIT_ROLLOUT:
                self._on_submit_rollout(msg, reply)
            elif kind == DRAIN:
                summary = self.drain_local(timeout_s=float(msg.get("timeout_s", 30.0)))
                reply(wire(DRAIN_OK, host=self.host_id, summary=summary))
            elif kind == STATS:
                series = self.metrics.snapshot() if self.metrics is not None else {}
                reply(wire(STATS_OK, seq=msg["seq"], host=self.host_id, series=series))
            elif kind == PREWARM:
                # The one path the port does not have; the agent goes on.
                self.errors += 1
                reply(wire(ERROR, reason="prewarm is not ported: AOT executable snapshots "
                                         "(eager PyTorch has no executable to serialize)",
                           bad_kind=kind, detail="each replica warms by dispatching "
                                                 "every bucket"))
            elif kind == SCALE:
                self._on_scale(msg, reply)
            elif kind == TRACE_PULL:
                if self.tracer is not None:
                    export = self.tracer.export()
                    coverage = self.tracer.coverage()
                else:
                    export = {"traceEvents": [], "otherData": {}}
                    coverage = {}
                reply(wire(TRACE_OK, seq=msg["seq"], host=self.host_id, trace=export,
                           coverage=coverage))
            else:
                # An agent-to-controller kind arriving here is a peer bug.
                self.errors += 1
                reply(wire(ERROR, reason=f"kind {kind!r} is not a controller request",
                           bad_kind=kind))
        except ProtocolError as e:
            self.errors += 1
            reply(wire(ERROR, reason=str(e), bad_kind=kind))
        except Exception as e:  # one bad frame never wedges the agent
            self.errors += 1
            reply(wire(ERROR, reason="internal", bad_kind=kind, detail=repr(e)))

    def _guarded(self, send: Callable[[dict], None]):
        def _send(msg: dict) -> None:
            if self.alive:
                send(msg)

        return _send

    # -- handlers -----------------------------------------------------------

    def _on_hello(self, msg: dict, reply) -> None:
        if int(msg["version"]) != self.version:
            reply(wire(HELLO_REJECT, version=int(msg["version"]), want=self.version,
                       host=self.host_id))
            return
        out = wire(HELLO_OK, version=self.version, host=self.host_id,
                   pool=len(self.router.pool()))
        if self.topology is not None:
            out["topology"] = self.topology
        reply(out)

    def _on_heartbeat(self, msg: dict, reply) -> None:
        out = wire(HEARTBEAT_ACK, seq=int(msg["seq"]), host=self.host_id,
                   load=self._load(), pool=len(self.router.pool()))
        # The clock-alignment exchange: echo the controller's stamp, add
        # ours; the controller does the arithmetic.
        if "t" in msg:
            out["t"] = msg["t"]
            out["agent_t"] = self._clock()
        reply(out)

    def _load(self) -> float:
        """The placement signal: the pool's live queue depth."""
        total = 0
        for rep in self.router.pool():
            server = getattr(rep, "server", None)
            if server is not None:
                try:
                    total += int(server.depth())
                except Exception:
                    pass
        return float(total)

    def _on_submit(self, msg: dict, reply) -> None:
        rid = msg["id"]
        with self._lock:
            done_msg = self._outbox.get(rid)
            running = rid in self._inflight
            if done_msg is None and not running:
                self._inflight.add(rid)
        if done_msg is not None:
            reply(done_msg)  # an idempotent replay of the terminal result
            return
        if running:
            return  # the live future's callback streams the result
        sample = decode_sample(msg["sample"])
        fut = self.router.submit(sample, deadline_ms=msg.get("deadline_ms"),
                                 tenant=msg.get("tenant"),
                                 trace_ctx=dtrace.TraceContext.from_wire(msg.get("trace_ctx")))

        def _done(f: Future) -> None:
            try:
                res = f.result()
                out = wire(RESULT, id=rid, ok=bool(res.ok), reason=res.reason,
                           output=_enc_arr(res.output), latency_ms=res.latency_ms,
                           detail=res.detail)
            except Exception as e:  # a local bug, surfaced
                out = wire(RESULT, id=rid, ok=False, reason="exception", detail=str(e))
            with self._lock:
                self._outbox[rid] = out
                self._inflight.discard(rid)
            reply(out)

        fut.add_done_callback(_done)

    def _on_submit_rollout(self, msg: dict, reply) -> None:
        rid = msg["id"]
        name = msg.get("name") or rid
        at_step = 0
        with self._lock:
            done_msg = self._outbox.get(rid)
            running = rid in self._inflight
            if done_msg is None and not running:
                self._inflight.add(rid)
        if done_msg is not None:
            reply(done_msg)
            return
        if running:
            # A reconcile duplicate for a session still running here: ack the
            # placement; its callbacks keep streaming.
            reply(wire(PLACED, id=rid, host=self.host_id, at_step=0))
            return

        def _on_step(sid: str, step: int, output) -> None:
            reply(wire(STEP, id=rid, step=int(step), output=_enc_arr(output)))

        ctx = dtrace.TraceContext.from_wire(msg.get("trace_ctx"))
        if msg.get("resume"):
            # Re-migration: restore from the persisted snapshot; its cursor
            # is the replay point.
            state = None
            if self.session_store is not None:
                try:
                    state = self.session_store.load(name)
                except KeyError:
                    state = None
            if state is None:
                with self._lock:
                    self._inflight.discard(rid)
                reply(wire(ROLLOUT_DONE, id=rid, ok=False, reason="no_snapshot",
                           detail=f"nothing persisted for {name!r}"))
                return
            at_step = int(state.get("cursor", 0))
            fut = self.router.resume_rollout(
                name, deadline_ms=msg.get("deadline_ms"),
                rollout_deadline_ms=msg.get("rollout_deadline_ms"), on_step=_on_step,
                trace_ctx=ctx)
        else:
            fut = self.router.submit_rollout(
                decode_sample(msg["sample"]), int(msg["steps"]),
                deadline_ms=msg.get("deadline_ms"),
                rollout_deadline_ms=msg.get("rollout_deadline_ms"), on_step=_on_step,
                name=name, tenant=msg.get("tenant"), trace_ctx=ctx)
        reply(wire(PLACED, id=rid, host=self.host_id, at_step=at_step))

        def _done(f: Future) -> None:
            try:
                res = f.result()
                out = wire(
                    ROLLOUT_DONE, id=rid, ok=bool(res.ok), reason=res.reason,
                    steps_completed=int(res.steps_completed), migrations=int(res.migrations),
                    drained_at_step=res.drained_at_step, detail=res.detail,
                    # All per-step outputs ride the terminal frame, so step
                    # frames lost to a healed partition are repaired.
                    outputs=[_enc_arr(o) for o in res.outputs])
            except Exception as e:
                out = wire(ROLLOUT_DONE, id=rid, ok=False, reason="exception", detail=str(e))
            with self._lock:
                self._outbox[rid] = out
                self._inflight.discard(rid)
            reply(out)

        fut.add_done_callback(_done)

    def _on_scale(self, msg: dict, reply) -> None:
        if self.scale_cb is None:
            reply(wire(SCALE_OK, host=self.host_id, ok=False, pool=len(self.router.pool()),
                       detail="no scale_cb wired"))
            return
        pool = int(self.scale_cb(str(msg["direction"])))
        reply(wire(SCALE_OK, host=self.host_id, ok=True, pool=pool))

    # -- the TCP server ------------------------------------------------------

    def listen(self, port: int = 0) -> int:
        """Serve the protocol on loopback TCP; returns the bound port
        (``port=0`` asks the OS). One reader thread per connection."""
        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind(("127.0.0.1", port))
        srv.listen(8)
        srv.settimeout(0.2)
        self._server_sock = srv
        self._accept_thread = threading.Thread(target=self._accept_loop,
                                               name=f"fed-{self.host_id}", daemon=True)
        self._accept_thread.start()
        return srv.getsockname()[1]

    def stop(self) -> None:
        """Close the listener and join the accept and connection threads
        (each polls every 0.2 s)."""
        self._stopping = True
        if self._server_sock is not None:
            try:
                self._server_sock.close()
            except OSError:
                pass
        for t in [self._accept_thread, *self._conn_threads]:
            if t is not None and t is not threading.current_thread():
                t.join(timeout=2.0)

    def _accept_loop(self) -> None:
        while not self._stopping:
            try:
                conn, _ = self._server_sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            t = threading.Thread(target=self._conn_loop, args=(conn,),
                                 name=f"fed-{self.host_id}-conn", daemon=True)
            self._conn_threads.append(t)
            t.start()

    def _conn_loop(self, conn: socket.socket) -> None:
        conn.settimeout(0.2)
        wlock = threading.Lock()

        def _send(msg: dict) -> None:
            frame = encode_frame(msg)
            with wlock:
                try:
                    conn.sendall(frame)
                except OSError:
                    pass

        decoder = FrameDecoder()
        while not self._stopping:
            try:
                data = conn.recv(65536)
            except socket.timeout:
                continue
            except OSError:
                break
            if not data:
                break
            for msg in decoder.feed(data):
                self.handle(msg, _send)
        self.errors += decoder.garbage + decoder.oversize
        try:
            conn.close()
        except OSError:
            pass


# -- ClusterRouter: the federation's controller -------------------------------


@dataclass
class _Pending:
    """One in-flight one-shot: the hosts it was placed on (hedges add
    hosts) and the caller's future (the first RESULT wins)."""

    rid: str
    sample: MeshSample
    deadline_ms: float | None
    tenant: str | None
    future: Future
    hosts: set[str] = field(default_factory=set)
    last_sent: float = 0.0  # clock of the last placement frame
    trace: str | None = None  # cluster trace id ("!"-prefixed: shadow)
    root_span: str | None = None  # the first placement's span id
    t0: float = 0.0  # submit clock (the cluster_request span's start)


@dataclass
class _ClusterSession:
    """One cluster-owned rollout session: its owner host, the high-water
    step the cluster has seen (replay suppression across migrations) and
    the per-step outputs."""

    rid: str
    name: str
    steps: int
    owner: str
    future: Future
    on_step: Callable | None
    deadline_ms: float | None
    rollout_deadline_ms: float | None
    tenant: str | None
    sample: MeshSample | None = None  # kept for a restart from zero
    streamed: int = 0
    at_step: int = 0  # the last placement's restored cursor
    migrations: int = 0
    restarts: int = 0  # no-snapshot restarts used (bounded)
    outputs: dict[int, np.ndarray] = field(default_factory=dict)
    last_sent: float = 0.0
    acked: bool = False  # PLACED seen for the current placement
    last_resume: bool = False  # how the current placement was sent
    trace: str | None = None
    root_span: str | None = None
    t0: float = 0.0


@dataclass
class _HostState:
    host_id: str
    link: object
    pool: int = 0
    load: float = 0.0
    last_series: dict = field(default_factory=dict)
    placed: int = 0  # placements routed here, hedges included
    rtt_ms: float | None = None  # the last heartbeat round trip


class ClusterRouter:
    """The federation's controller: places work across ``HostAgent``s,
    keeps leases, survives partitions and host death, and drains the
    cluster to one ``cluster_summary``.

    A single-threaded control loop by design: the owner calls :meth:`tick`
    at its own cadence (tests drive a fake clock). Inbound messages arrive
    on any thread (TCP readers, replica workers through in-proc replies);
    state is under ``_lock``, which is never held across a ``link.send``
    (an in-proc send can re-enter :meth:`_on_message` on the same stack).

    ``failover=False`` resolves a dead host's work as lost instead of
    re-placing it (the baseline failover is measured against).
    ``tracer`` makes the controller the cluster's head-sampling authority
    (``placement`` / ``cluster_request`` / ``cluster_rollout`` spans);
    ``trace_path`` is where ``drain()`` writes the merged trace.
    ``manifests`` (AOT deploy manifests by topology key) is not ported."""

    def __init__(
        self,
        *,
        sink=None,
        clock: Callable[[], float] = time.monotonic,
        suspect_after_s: float = 2.0,
        dead_after_s: float = 6.0,
        manifests: dict[str, dict] | None = None,
        series_path: str | None = None,
        failover: bool = True,
        tracer=None,
        trace_path: str | None = None,
    ) -> None:
        if manifests:
            raise NotPortedError(
                "ClusterRouter(manifests=...) hydrates joiners from AOT executable snapshots; "
                "eager PyTorch has no executable to serialize (each replica warms by "
                "dispatching every bucket)")
        self.sink = sink
        self.failover = failover
        self._clock = clock
        self._tracer = tracer
        self._trace_path = trace_path
        # Per-host clock offsets from the stamped heartbeats, kept whether
        # or not tracing is on (host_heartbeat reports them).
        self.clocks = dtrace.ClockSync()
        self.merged_trace: dict | None = None  # drain()'s stitched trace
        self.detector = FailureDetector(suspect_after_s=suspect_after_s,
                                        dead_after_s=dead_after_s, clock=clock)
        self._series_path = series_path
        self._series_seq = 0  #: guarded_by _lock
        self._lock = threading.RLock()
        self._hosts: dict[str, _HostState] = {}  #: guarded_by _lock
        self._pending: dict[str, _Pending] = {}  #: guarded_by _lock
        self._sessions: dict[str, _ClusterSession] = {}  #: guarded_by _lock
        self._session_by_name: dict[str, str] = {}  #: guarded_by _lock
        self._next_id = 0  #: guarded_by _lock
        self._hb_seq = 0  #: guarded_by _lock
        self._stats_seq = 0  #: guarded_by _lock
        self._drained = False  #: guarded_by _lock
        self.protocol_errors = 0  # controller-side schema violations
        #: The ledger cluster_summary reports. guarded_by _lock
        self.counts = {
            "requests": 0,
            "completed": 0,
            "shed": 0,
            "suppressed": 0,
            "sessions": 0,
            "remigrated": 0,
            "lost": 0,
            "hosts_dead": 0,
        }

    # -- membership ---------------------------------------------------------

    def add_host(self, host_id: str, link) -> None:
        """Handshake and register one host; version skew raises
        :class:`ProtocolError` (a skewed host never joins quietly)."""
        with self._lock:
            if host_id in self._hosts:
                raise ValueError(f"host {host_id!r} already federated")
        state = _HostState(host_id=host_id, link=link)
        done = threading.Event()
        verdict: dict = {}

        def _on_message(msg: dict) -> None:
            if not done.is_set() and msg.get("kind") in (HELLO_OK, HELLO_REJECT):
                verdict.update(msg)
                done.set()
                return
            self._on_message(host_id, msg)

        link.connect(_on_message)
        link.send(wire(HELLO, version=PROTOCOL_VERSION))
        if not done.wait(timeout=5.0):
            raise ProtocolError(f"host {host_id!r}: no hello reply")
        if verdict["kind"] == HELLO_REJECT:
            raise ProtocolError(
                f"host {host_id!r} refused federation: protocol version "
                f"skew (ours {PROTOCOL_VERSION}, theirs {verdict['want']})"
            )
        state.pool = int(verdict.get("pool", 0))
        with self._lock:
            if host_id in self._hosts:
                # A racing add_host of the same id won the handshake.
                raise ValueError(f"host {host_id!r} already federated")
            self._hosts[host_id] = state
        self.detector.register(host_id)

    def hosts(self) -> list[str]:
        with self._lock:
            return list(self._hosts)

    def host_state(self, host_id: str) -> str:
        return self.detector.state(host_id)

    # -- placement ----------------------------------------------------------

    def _alive_hosts(self) -> list[_HostState]:
        with self._lock:
            return [h for h in self._hosts.values()
                    if self.detector.state(h.host_id) == ALIVE]

    def _pick_host(self, exclude: set[str] = frozenset()) -> _HostState | None:
        """The least-loaded ALIVE host (SUSPECT hosts are drained around)."""
        candidates = [h for h in self._alive_hosts() if h.host_id not in exclude]
        if not candidates:
            return None
        return min(candidates, key=lambda h: (h.load, h.placed, h.host_id))

    def merged_load(self) -> dict[str, float]:
        """Per-host queue load from the last heartbeat acks."""
        with self._lock:
            return {h.host_id: h.load for h in self._hosts.values()}

    def autoscale_target(self, direction: str = "up") -> str | None:
        """The host a scale order lands on: the least-loaded live host in
        both directions."""
        h = self._pick_host()
        return None if h is None else h.host_id

    def scale(self, direction: str, *, reason: str = "load") -> bool:
        target = self.autoscale_target(direction)
        if target is None:
            return False
        with self._lock:
            link = self._hosts[target].link
        return bool(link.send(wire(SCALE, direction=direction, reason=reason)))

    def submit(self, sample: MeshSample, *, deadline_ms: float | None = None,
               tenant: str | None = None) -> Future:
        """Place one one-shot on the least-loaded live host; the future
        resolves to a ``ServeResult`` (``no_host`` when no host is alive:
        shed, never hung)."""
        fut: Future = Future()
        rid = self._new_id("q")
        pend = _Pending(
            rid=rid, sample=sample, deadline_ms=deadline_ms, tenant=tenant, future=fut,
            # Head sampling is decided here, once: every host the request
            # touches honours this id through the propagated trace_ctx.
            trace=self._tracer.start_trace() if self._tracer is not None else None,
            t0=self._clock(),
        )
        with self._lock:
            self.counts["requests"] += 1
            self._pending[rid] = pend
        if not self._place_oneshot(pend):
            self._resolve_oneshot(rid, ServeResult(ok=False, reason="no_host", output=None,
                                                   detail="no live host", latency_ms=0.0))
        return fut

    def _record_placement(self, trace: str | None, root_span: str | None, *, host: str,
                          kind: str, **extra) -> str | None:
        """One instant ``placement`` span (the frame send). The first
        placement's span id is the anchor every later placement of the
        request links to (``link_to``): one trace, never a second chain."""
        if self._tracer is None or trace is None:
            return None
        now = self._clock()
        args = {"host": host, "kind": kind, **extra}
        if root_span is not None:
            args["link_to"] = root_span
        return self._tracer.add_span("placement", now, now, trace=trace,
                                     parent_id=root_span, args=args)

    def _wire_ctx(self, trace: str | None, span_id: str | None,
                  tenant: str | None) -> dict | None:
        """The ``trace_ctx`` field of one placement, or None when cluster
        tracing is off for the request (the host then starts nothing)."""
        if trace is None:
            return None
        return dtrace.TraceContext(trace_id=trace, span_id=span_id,
                                   sampled=not trace.startswith("!"),
                                   tenant=tenant).to_wire()

    def _submit_msg(self, pend: _Pending, host_id: str, kind: str) -> dict:
        """The SUBMIT frame of one placement of ``pend`` on ``host_id``,
        its ``placement`` span recorded."""
        msg = wire(SUBMIT, id=pend.rid, sample=encode_sample(pend.sample))
        if pend.deadline_ms is not None:
            msg["deadline_ms"] = pend.deadline_ms
        if pend.tenant is not None:
            msg["tenant"] = pend.tenant
        sid = self._record_placement(pend.trace, pend.root_span, host=host_id, kind=kind)
        ctx = self._wire_ctx(pend.trace, sid or pend.root_span, pend.tenant)
        if ctx is not None:
            msg["trace_ctx"] = ctx
        with self._lock:
            if pend.root_span is None:
                pend.root_span = sid
        return msg

    def _place_oneshot(self, pend: _Pending, kind: str = "place") -> bool:
        host = self._pick_host(exclude=pend.hosts)
        if host is None:
            return False
        msg = self._submit_msg(pend, host.host_id, kind)
        with self._lock:
            pend.hosts.add(host.host_id)
            pend.last_sent = self._clock()
            host.placed += 1
        host.link.send(msg)
        return True

    def submit_rollout(self, sample: MeshSample, steps: int, *,
                       deadline_ms: float | None = None,
                       rollout_deadline_ms: float | None = None, on_step: Callable | None = None,
                       name: str | None = None, tenant: str | None = None) -> Future:
        """Place one rollout session. Every cluster session is named (auto
        ``s%05d``), so its owner persists its rolling snapshots: if the owner
        dies, the session resumes on a survivor from the persisted cursor.
        The future resolves to a ``RolloutResult``."""
        fut: Future = Future()
        rid = self._new_id("s")
        sess = _ClusterSession(
            rid=rid, name=name or rid, steps=int(steps), owner="", future=fut,
            on_step=on_step, deadline_ms=deadline_ms, rollout_deadline_ms=rollout_deadline_ms,
            tenant=tenant, sample=sample,
            # One trace id for the session's whole cluster life: every
            # re-migration and restart appends to it.
            trace=self._tracer.start_trace("r") if self._tracer is not None else None,
            t0=self._clock(),
        )
        host = self._pick_host()
        with self._lock:
            self.counts["sessions"] += 1
            self._sessions[rid] = sess
            self._session_by_name[sess.name] = rid
        if host is None:
            self._resolve_session(rid, ok=False, reason="no_host", detail="no live host")
            return fut
        self._send_rollout(sess, host, sample=sample, resume=False)
        return fut

    def _send_rollout(self, sess: _ClusterSession, host: _HostState, *,
                      sample: MeshSample | None, resume: bool, kind: str = "place") -> None:
        msg = wire(SUBMIT_ROLLOUT, id=sess.rid, steps=sess.steps, name=sess.name,
                   resume=resume)
        if sample is not None:
            msg["sample"] = encode_sample(sample)
        if sess.deadline_ms is not None:
            msg["deadline_ms"] = sess.deadline_ms
        if sess.rollout_deadline_ms is not None:
            msg["rollout_deadline_ms"] = sess.rollout_deadline_ms
        if sess.tenant is not None:
            msg["tenant"] = sess.tenant
        sid = self._record_placement(sess.trace, sess.root_span, host=host.host_id, kind=kind)
        ctx = self._wire_ctx(sess.trace, sid or sess.root_span, sess.tenant)
        if ctx is not None:
            msg["trace_ctx"] = ctx
        with self._lock:
            if sess.root_span is None:
                sess.root_span = sid
            sess.owner = host.host_id
            sess.last_sent = self._clock()
            sess.acked = False  # each placement needs its own PLACED
            sess.last_resume = resume
            host.placed += 1
        host.link.send(msg)

    # -- inbound -------------------------------------------------------------

    def _on_message(self, host_id: str, msg: dict) -> None:
        """Controller-side dispatch, on a TCP reader, a replica worker or
        re-entrantly on the controller's own stack: hence the RLock, and no
        sends while holding it."""
        try:
            validate_message(msg)
        except ProtocolError:
            with self._lock:
                self.protocol_errors += 1
            return
        kind = msg["kind"]
        if kind == HEARTBEAT_ACK:
            was = self.detector.ack(host_id)
            now = self._clock()
            if "t" in msg and "agent_t" in msg:
                # One midpoint clock-alignment sample a round trip.
                self.clocks.observe(host_id, float(msg["t"]), now, float(msg["agent_t"]))
            # Read outside _lock: ClockSync has its own lock.
            rtt = self.clocks.rtt_ms(host_id)
            with self._lock:
                h = self._hosts.get(host_id)
                if h is not None:
                    h.load = float(msg["load"])
                    h.pool = int(msg.get("pool", h.pool))
                    if rtt is not None:
                        h.rtt_ms = rtt
            if was != ALIVE:
                # A revival (a healed partition, a slow host caught up):
                # frames were lost both ways, so re-drive this host's
                # in-flight work (agents and controller both deduplicate).
                self._reconcile(host_id)
        elif kind == RESULT:
            res = ServeResult(
                ok=bool(msg["ok"]),
                reason=str(msg.get("reason") or ""),
                output=_dec_arr(msg.get("output")),
                detail=str(msg.get("detail") or ""),
                latency_ms=float(msg.get("latency_ms") or 0.0),
            )
            self._resolve_oneshot(msg["id"], res)
        elif kind == PLACED:
            with self._lock:
                sess = self._sessions.get(msg["id"])
                if sess is not None:
                    sess.at_step = int(msg["at_step"])
                    sess.acked = True
        elif kind == STEP:
            self._on_step(msg)
        elif kind == ROLLOUT_DONE:
            self._on_rollout_done(host_id, msg)
        elif kind == STATS_OK:
            with self._lock:
                h = self._hosts.get(host_id)
                if h is not None:
                    h.last_series = dict(msg["series"])
        elif kind == TRACE_OK:
            # Stashed beside the series: drain()'s waiter polls for it.
            with self._lock:
                h = self._hosts.get(host_id)
                if h is not None:
                    h.last_series["_trace"] = msg["trace"]
                    if "coverage" in msg:
                        h.last_series["_trace_coverage"] = msg["coverage"]
        elif kind in (DRAIN_OK, PREWARM_OK, SCALE_OK, ERROR, HELLO_OK, HELLO_REJECT):
            # DRAIN_OK feeds drain()'s waiter; the rest are acks, never fatal.
            with self._lock:
                h = self._hosts.get(host_id)
                if h is not None and kind == DRAIN_OK:
                    h.last_series["_drain_summary"] = msg["summary"]

    def _on_step(self, msg: dict) -> None:
        cb = None
        with self._lock:
            sess = self._sessions.get(msg["id"])
            if sess is None:
                return
            sess.acked = True  # a streamed step proves delivery
            step = int(msg["step"])
            if step <= sess.streamed:
                # A replayed duplicate: at-least-once delivery,
                # exactly-once consumption.
                self.counts["suppressed"] += 1
                return
            sess.streamed = step
            sess.outputs[step] = _dec_arr(msg["output"])
            cb = sess.on_step
            name = sess.name
            out = sess.outputs[step]
        if cb is not None:
            cb(name, step, out)

    def _on_rollout_done(self, host_id: str, msg: dict) -> None:
        restart_to = None
        with self._lock:
            sess = self._sessions.get(msg["id"])
            if sess is None or sess.future.done():
                if sess is not None:
                    self.counts["suppressed"] += 1
                return
            if not msg["ok"] and sess.owner != host_id:
                # A failure from a previous owner: the new placement rules.
                self.counts["suppressed"] += 1
                return
            if (not msg["ok"] and msg.get("reason") == "no_snapshot"
                    and sess.sample is not None and sess.restarts < 3):
                # The owner died before its first persisted snapshot: restart
                # from step zero on a survivor (the engine is deterministic;
                # the re-streamed prefix is suppressed). Bounded.
                sess.restarts += 1
                restart_to = True
        if restart_to:
            host = self._pick_host()
            if host is not None:
                self._send_rollout(sess, host, sample=sess.sample, resume=False,
                                   kind="restart")
                return
        self._resolve_session(
            msg["id"], ok=bool(msg["ok"]), reason=msg.get("reason"),
            steps_completed=int(msg.get("steps_completed") or 0),
            drained_at_step=msg.get("drained_at_step"),
            local_migrations=int(msg.get("migrations") or 0),
            detail=msg.get("detail"), wire_outputs=msg.get("outputs"),
        )

    # -- resolution ----------------------------------------------------------

    def _resolve_oneshot(self, rid: str, res: ServeResult) -> None:
        with self._lock:
            pend = self._pending.pop(rid, None)
            if pend is None or pend.future.done():
                self.counts["suppressed"] += 1
                return
            self.counts["completed" if res.ok else "shed"] += 1
        if self._tracer is not None and pend.trace is not None:
            self._tracer.add_span(
                "cluster_request", pend.t0, self._clock(), trace=pend.trace, parent_id=None,
                args={"ok": res.ok, "reason": res.reason or "ok",
                      "placements": len(pend.hosts), "hosts": sorted(pend.hosts)})
        pend.future.set_result(res)

    def _resolve_session(self, rid: str, *, ok: bool, reason: str | None,
                         steps_completed: int = 0, drained_at_step=None,
                         local_migrations: int = 0, detail=None, wire_outputs=None) -> None:
        with self._lock:
            sess = self._sessions.pop(rid, None)
            if sess is None or sess.future.done():
                return
            self._session_by_name.pop(sess.name, None)
            if ok:
                self.counts["completed"] += 1
            elif reason in ("host_dead", "no_host", "no_snapshot"):
                self.counts["lost"] += 1
            else:
                self.counts["shed"] += 1
            # Gap repair: step frames lost to a healed partition come from
            # the terminal frame (streamed and terminal copies of a step
            # are byte-identical).
            for i, enc in enumerate(wire_outputs or []):
                step = i + 1
                if step not in sess.outputs and enc is not None:
                    sess.outputs[step] = _dec_arr(enc)
            outputs = [sess.outputs[k] for k in sorted(sess.outputs)]
        if self._tracer is not None and sess.trace is not None:
            self._tracer.add_span(
                "cluster_rollout", sess.t0, self._clock(), trace=sess.trace, parent_id=None,
                args={"ok": ok, "reason": str(reason or ("ok" if ok else "error")),
                      "session": sess.name,
                      "steps_completed": steps_completed or sess.streamed,
                      "migrations": sess.migrations + local_migrations,
                      "restarts": sess.restarts})
        sess.future.set_result(RolloutResult(
            ok=ok,
            reason=str(reason or ("ok" if ok else "error")),
            session=sess.name,
            steps=sess.steps,
            steps_completed=steps_completed or sess.streamed,
            outputs=outputs,
            drained_at_step=drained_at_step,
            migrations=sess.migrations + local_migrations,
            detail=str(detail or ""),
        ))

    # -- the control loop ----------------------------------------------------

    def tick(self) -> list[tuple[str, str, str]]:
        """One control-loop beat: flush delayed frames, probe every lease,
        sweep the detector, react to its edges (hedge around SUSPECT,
        declare and re-migrate on DEAD), re-deliver stale placements, emit
        ``host_heartbeat``s and publish the merged series. Returns the
        detector's edges."""
        with self._lock:
            hosts = list(self._hosts.values())
            self._hb_seq += 1
            seq = self._hb_seq
        for h in hosts:
            h.link.flush()
        for h in hosts:
            # Every host is probed, DEAD ones too (a healed partition revives
            # through the next ack); the probe anchors the silence before
            # the send, and its stamp is one clock-alignment sample.
            self.detector.probe(h.host_id)
            h.link.send(wire(HEARTBEAT, seq=seq, t=self._clock()))
        edges = self.detector.sweep()
        for host_id, old, new in edges:
            if new == SUSPECT:
                self._hedge_around(host_id)
            elif new == DEAD:
                self._on_host_dead(host_id)
        self._redrive_stale()
        for h in hosts:
            off = self.clocks.offset(h.host_id)
            self._event(
                events.HOST_HEARTBEAT,
                host=h.host_id,
                seq=seq,
                state=self.detector.state(h.host_id),
                load=h.load,
                pool=h.pool,
                edge=next((f"{o}->{n}" for hid, o, n in edges if hid == h.host_id), None),
                **({"clock_offset_s": round(off[0], 6), "clock_err_s": round(off[1], 6)}
                   if off is not None else {}),
            )
        self._publish_series(hosts)
        return edges

    def _redrive_stale(self) -> None:
        """At-least-once re-delivery: a submit dropped on a healthy link
        would hang forever (heartbeats flow, no detector edge re-drives
        it), so any placement unacknowledged for a full suspicion dwell is
        re-sent. Agents deduplicate by id and the controller suppresses
        duplicate replies: a spurious re-send costs one suppressed result."""
        now = self._clock()
        dwell = self.detector.suspect_after_s
        with self._lock:
            stale_pend = [p for p in self._pending.values()
                          if not p.future.done() and p.hosts and now - p.last_sent >= dwell]
            stale_sess = [s for s in self._sessions.values()
                          if not s.acked and not s.future.done() and s.last_sent > 0.0
                          and now - s.last_sent >= dwell]
        for p in stale_pend:
            with self._lock:
                p.last_sent = now
            for host_id in sorted(p.hosts):
                if self.detector.state(host_id) == DEAD:
                    continue  # _on_host_dead owns the death path
                with self._lock:
                    host = self._hosts.get(host_id)
                if host is None:
                    continue
                host.link.send(self._submit_msg(p, host_id, "redeliver"))
        for s in stale_sess:
            if self.detector.state(s.owner) == DEAD:
                continue
            with self._lock:
                host = self._hosts.get(s.owner)
            if host is None:
                continue
            # Replay the current placement as it was: a dropped resume stays
            # a resume, a dropped fresh submit re-ships the sample.
            self._send_rollout(s, host, sample=None if s.last_resume else s.sample,
                               resume=s.last_resume, kind="redeliver")

    def _reconcile(self, host_id: str) -> None:
        """Re-drive a revived host's in-flight work: every pending one-shot
        placed there again, every session it owns re-attached
        (``resume=True``: the agent acks a running session, replays a
        finished one's terminal frame, or resumes from the snapshot)."""
        with self._lock:
            host = self._hosts.get(host_id)
            pend = [p for p in self._pending.values()
                    if host_id in p.hosts and not p.future.done()]
            sessions = [s for s in self._sessions.values()
                        if s.owner == host_id and not s.future.done()]
        if host is None:
            return
        for p in pend:
            msg = self._submit_msg(p, host_id, "reconcile")
            with self._lock:
                p.last_sent = self._clock()
            host.link.send(msg)
        for s in sessions:
            self._send_rollout(s, host, sample=None, resume=True, kind="reconcile")

    def _hedge_around(self, host_id: str) -> None:
        """The SUSPECT reaction: duplicate the host's in-flight one-shots on
        a healthy sibling (linked placements of the same trace); the first
        RESULT wins. Sessions are not hedged: two live writers would fork
        one; they wait out the dwell."""
        with self._lock:
            pending = [p for p in self._pending.values()
                       if host_id in p.hosts and not p.future.done()]
        for pend in pending:
            self._place_oneshot(pend, kind="hedge")

    def _on_host_dead(self, host_id: str) -> None:
        """The DEAD reaction: re-place every one-shot whose only placement
        was the dead host, re-migrate every session it owned to a survivor
        from its persisted snapshot, and resolve as ``host_dead`` when no
        survivor exists."""
        with self._lock:
            self.counts["hosts_dead"] += 1
            silent = self.detector.silent_s(host_id)
            owned_sessions = [s for s in self._sessions.values() if s.owner == host_id]
            sole_pending = [p for p in self._pending.values()
                            if p.hosts == {host_id} and not p.future.done()]
        self._event(events.HOST_DEAD, host=host_id, silent_s=round(silent, 3),
                    sessions=len(owned_sessions), pending=len(sole_pending),
                    reason="lease_expired")
        for pend in sole_pending:
            if not self.failover or not self._place_oneshot(pend, kind="redeliver"):
                self._resolve_oneshot(pend.rid, ServeResult(
                    ok=False, reason="host_dead", output=None,
                    detail=f"owner {host_id} dead, no survivor", latency_ms=0.0))
        for sess in owned_sessions:
            survivor = self._pick_host(exclude={host_id}) if self.failover else None
            if survivor is None:
                self._resolve_session(sess.rid, ok=False, reason="host_dead",
                                      detail=f"owner {host_id} dead, no survivor")
                continue
            from_host = sess.owner
            with self._lock:
                sess.migrations += 1
                self.counts["remigrated"] += 1
            self._send_rollout(sess, survivor, sample=None, resume=True, kind="remigrate")
            self._event(events.SESSION_REMIGRATE, session=sess.name, from_host=from_host,
                        to_host=survivor.host_id, at_step=sess.streamed,
                        replay_from=sess.at_step, reason="host_dead")

    def _publish_series(self, hosts: list[_HostState]) -> None:
        """One merged metrics row: every live host's registry snapshot, keys
        prefixed with the host id."""
        if self._series_path is None:
            return
        with self._lock:
            self._stats_seq += 1
            seq = self._stats_seq
        for h in hosts:
            if self.detector.state(h.host_id) == ALIVE:
                h.link.send(wire(STATS, seq=seq))
        merged: dict = {}
        with self._lock:
            self._series_seq += 1
            row_seq = self._series_seq
            for h in hosts:
                for key, st in h.last_series.items():
                    if key.startswith("_"):
                        continue
                    merged[f"{h.host_id}/{key}"] = st
        row = {"seq": row_seq, "t": self._clock(), "series": merged}
        with open(self._series_path, "a", encoding="utf-8") as f:
            f.write(json.dumps(row) + "\n")

    # -- drain ----------------------------------------------------------------

    def drain(self, timeout_s: float = 30.0) -> dict:
        """Coordinated drain: every live host drains its pool, every
        pending future resolves (drained one-shots as shed, unfinished
        sessions as drained), one ``cluster_summary`` reports the ledger.
        Idempotent. The summaries are polled on the wall clock, whatever
        the injected one."""
        with self._lock:
            if self._drained:
                return self._summary()
            self._drained = True
            hosts = list(self._hosts.values())
        per_host: dict[str, dict] = {}
        for h in hosts:
            if self.detector.state(h.host_id) == DEAD:
                continue
            h.link.flush()
            h.link.send(wire(DRAIN, timeout_s=timeout_s))
        # TCP replies are asynchronous: poll for the summaries.
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            with self._lock:
                missing = [h for h in hosts if self.detector.state(h.host_id) != DEAD
                           and "_drain_summary" not in h.last_series]
            if not missing:
                break
            time.sleep(0.02)
        # A last series row at the drained registries' final values.
        self._publish_series(hosts)
        with self._lock:
            for h in hosts:
                if "_drain_summary" in h.last_series:
                    per_host[h.host_id] = h.last_series["_drain_summary"]
            leftover_pending = list(self._pending.keys())
            leftover_sessions = list(self._sessions.keys())
        for rid in leftover_pending:
            self._resolve_oneshot(rid, ServeResult(ok=False, reason="drained", output=None,
                                                   detail="cluster drained", latency_ms=0.0))
        for rid in leftover_sessions:
            self._resolve_session(rid, ok=False, reason="drained", detail="cluster drained")
        summary = self._summary(per_host)
        if self._tracer is not None:
            summary["trace_coverage"] = self._stitch_traces(hosts)
        self._event(events.CLUSTER_SUMMARY, **summary)
        return summary

    def _stitch_traces(self, hosts: list[_HostState]) -> dict:
        """Pull every live host's spans (``trace_pull``), rebase them into
        the controller's clock by the heartbeat offsets, write one merged
        trace, and return each source's coverage (sampled/total, clock
        offset and error) for ``cluster_summary.trace_coverage``. Runs
        after the leftover futures resolved, so the controller's terminal
        spans are in."""
        with self._lock:
            self._stats_seq += 1
            tseq = self._stats_seq
        live = [h for h in hosts if self.detector.state(h.host_id) != DEAD]
        for h in live:
            h.link.flush()
            h.link.send(wire(TRACE_PULL, seq=tseq))
        tr_deadline = time.monotonic() + 5.0
        while time.monotonic() < tr_deadline:
            with self._lock:
                missing = [h for h in live if "_trace" not in h.last_series]
            if not missing:
                break
            time.sleep(0.02)
        exports = {"controller": self._tracer.export()}
        coverage: dict[str, dict] = {"controller": self._tracer.coverage()}
        offsets: dict[str, tuple[float, float]] = {}
        clock_meta = self.clocks.snapshot()
        with self._lock:
            for h in hosts:
                tr = h.last_series.get("_trace")
                if tr is not None:
                    exports[h.host_id] = tr
                cov = h.last_series.get("_trace_coverage")
                if cov is not None:
                    coverage[h.host_id] = dict(cov)
        for host_id, meta in clock_meta.items():
            offsets[host_id] = (meta["clock_offset_s"], meta["clock_err_s"])
            coverage.setdefault(host_id, {}).update(meta)
        merged = dtrace.merge_traces(exports, offsets=offsets, controller="controller")
        if self._trace_path is not None:
            dtrace.write_trace(self._trace_path, merged)
        self.merged_trace = merged
        return coverage

    def _summary(self, per_host: dict | None = None) -> dict:
        with self._lock:
            proto_errors = self.protocol_errors + sum(
                getattr(h.link, "protocol_errors", 0) for h in self._hosts.values())
            return {
                "hosts": len(self._hosts),
                "requests": self.counts["requests"],
                "completed": self.counts["completed"],
                "shed": self.counts["shed"],
                "sessions": self.counts["sessions"],
                "remigrated": self.counts["remigrated"],
                "hosts_dead": self.counts["hosts_dead"],
                "per_host": per_host or {},
                "lost": self.counts["lost"],
                "protocol_errors": proto_errors,
            }

    def close(self) -> None:
        """Close every host's link (a ``TcpLink``'s reader thread joins).
        Call after :meth:`drain`."""
        with self._lock:
            links = [h.link for h in self._hosts.values()]
        for link in links:
            link.close()

    # -- plumbing -------------------------------------------------------------

    def _new_id(self, prefix: str) -> str:
        with self._lock:
            self._next_id += 1
            return f"{prefix}{self._next_id:05d}"

    def _event(self, event: str, **fields) -> None:
        if self.sink is not None:
            self.sink.log(event=event, **fields)


# -- assembly -----------------------------------------------------------------


class _HostSink:
    """A per-host sink: tags every record with its host id, so one merged
    event stream stays attributable."""

    def __init__(self, inner, host_id: str) -> None:
        self._inner = inner
        self.host_id = host_id

    def log(self, **fields) -> None:
        if self._inner is not None:
            self._inner.log(host=self.host_id, **fields)

    def flush(self) -> None:
        if self._inner is not None and hasattr(self._inner, "flush"):
            self._inner.flush()


def build_local_federation(
    replica_groups,
    *,
    sink=None,
    clock: Callable[[], float] = time.monotonic,
    suspect_after_s: float = 2.0,
    dead_after_s: float = 6.0,
    session_store=None,
    link_faults: dict[str, object] | None = None,
    host_faults: dict[str, object] | None = None,
    manifests: dict[str, dict] | None = None,
    series_path: str | None = None,
    router_kwargs: dict | None = None,
    metrics_factory: Callable | None = None,
    tcp_base_port: int = 0,
    failover: bool = True,
    tracer_factory: Callable[[str], object] | None = None,
    cluster_tracer=None,
    trace_path: str | None = None,
    recorders: dict[str, "dtrace.FlightRecorder"] | None = None,
) -> tuple[ClusterRouter, dict[str, HostAgent]]:
    """A whole loopback federation in one call: one ``ReplicaRouter`` and
    ``HostAgent`` per replica group (``host<i>``), in-proc links (chaos per
    host through ``link_faults`` / ``host_faults``), one shared
    ``SessionStore`` (the migration substrate: a survivor must read the
    dead host's snapshots; with a store every router persists each due
    snapshot), and a ``ClusterRouter`` over them. Returns ``(cluster,
    agents)``; the routers are not started.

    ``tcp_base_port`` > 0 runs loopback TCP instead: ``host<i>`` listens on
    ``tcp_base_port + i`` and the controller connects a ``TcpLink``
    (``link_faults`` are in-proc only and refused there).

    Cluster tracing: ``cluster_tracer`` makes the controller the sampling
    authority; ``tracer_factory(host_id)`` builds each host's tracer
    (pulled at drain and stitched into ``trace_path``); ``recorders[id]``
    wraps that host's sink (and ``recorders["controller"]`` the
    controller's, where ``host_dead`` fires: a dead host cannot dump its
    own ring) in a ``FlightRecorderSink``. ``manifests`` raises
    ``NotPortedError`` when non-empty (no AOT executables)."""
    from gnot_tpu_torch.serve.router import ReplicaRouter

    if tcp_base_port and link_faults:
        raise ValueError(
            "link_faults are in-proc chaos hooks; the TCP transport "
            "(tcp_base_port) has none — drop one or the other"
        )
    ctrl_recorder = (recorders or {}).get("controller")
    cluster = ClusterRouter(
        sink=(dtrace.FlightRecorderSink(sink, ctrl_recorder)
              if ctrl_recorder is not None else sink),
        clock=clock,
        failover=failover,
        suspect_after_s=suspect_after_s,
        dead_after_s=dead_after_s,
        manifests=manifests,
        series_path=series_path,
        tracer=cluster_tracer,
        trace_path=trace_path,
    )
    agents: dict[str, HostAgent] = {}
    kwargs = dict(router_kwargs or {})
    for i, replicas in enumerate(replica_groups):
        host_id = f"host{i}"
        host_sink: object = _HostSink(sink, host_id) if sink is not None else None
        recorder = (recorders or {}).get(host_id)
        if recorder is not None:
            host_sink = dtrace.FlightRecorderSink(host_sink, recorder)
        metrics = metrics_factory() if metrics_factory is not None else None
        tracer = tracer_factory(host_id) if tracer_factory is not None else None
        host_kwargs = dict(kwargs)
        if tracer is not None:
            host_kwargs["tracer"] = tracer
        router = ReplicaRouter(
            replicas,
            sink=host_sink,
            clock=clock,
            session_store=session_store,
            persist_snapshots=session_store is not None,
            metrics=metrics,
            **host_kwargs,
        )
        agent = HostAgent(
            host_id,
            router,
            sink=host_sink,
            faults=(host_faults or {}).get(host_id),
            session_store=session_store,
            metrics=metrics,
            topology=topology_key(len(replica_groups), len(replicas)),
            tracer=tracer,
            clock=clock,
        )
        if tcp_base_port:
            port = agent.listen(tcp_base_port + i)
            link: object = TcpLink("127.0.0.1", port)
        else:
            link = InProcLink(agent, clock=clock)
        cluster.add_host(host_id, link)
        if not tcp_base_port:
            # Chaos is armed after the handshake: an armed msg_delay or
            # partition eating the hello would wedge setup instead.
            link.arm((link_faults or {}).get(host_id))
        agents[host_id] = agent
    return cluster, agents
