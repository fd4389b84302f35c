"""Cluster-scoped tracing: context propagation, clock alignment,
cross-host stitching and the anomaly flight recorder.

Port of ``gnot_tpu/obs/dtrace.py``. The span tracer (``obs/tracing.py``)
is per process and per clock; once a request crosses the federation's
wire (``serve/federation.py``: placement, hedge, re-delivery, session
re-migration) its chain would break. Four pieces join it up:

* :class:`TraceContext`: one sampling decision on the wire (trace id,
  parent span id, sampled flag, tenant), the optional ``trace_ctx`` field
  of every request-bearing message. The ``ClusterRouter`` decides once;
  every host adopts it (``Tracer.adopt``) and never consults its own
  sampling counter for propagated work.
* :class:`ClockSync`: each host's clock offset +/- uncertainty from the
  heartbeat round trips the federation already makes (the midpoint
  method over a sliding window, trusting the exchange with the least
  round trip: ``offset = remote_t - (t_send + t_recv) / 2``, uncertainty
  ``rtt / 2``).
* :func:`merge_traces`: per-source Chrome exports stitched into one
  file, remote span times rebased into the controller's clock by those
  offsets, span and parent ids prefixed by their source so the per-host
  ``s%06d`` counters cannot collide, each remote span given a ``host``
  arg; ``otherData.hosts`` carries each source's offset, error and
  coverage counters.
* :class:`FlightRecorder`: a bounded ring of the trailing ``window_s``
  of every span and event, whatever the sample rate (sampled-out traces
  record shadow spans that exist only there), dumped atomically to JSON
  on trigger edges. :class:`FlightRecorderSink` wraps a sink and fires
  the dump on ``slo_alert`` fire, ``breaker_open``, ``host_dead`` and
  ``non_finite_loss`` records; ``watch_lockguard`` makes a
  ``utils/lockguard.py`` inversion report a trigger too.

The wire dicts, the merged trace and the dump files are JAX's, field for
field. Stdlib only.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from collections import deque
from typing import Callable

#: Trace-id prefix marking a SHADOW trace: sampled OUT by head
#: sampling, recorded only into a flight recorder's ring (never the
#: tracer's export buffer). The prefix travels the wire, so a request
#: shadow-traced at the controller stays shadow on every host.
SHADOW_PREFIX = "!"


# --------------------------------------------------------------------------
# Trace-context propagation
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TraceContext:
    """One head-sampling decision in wire form.

    ``trace_id`` is the cluster-assigned id (possibly shadow-prefixed);
    ``span_id`` the cluster-side parent span the receiving host should
    chain under; ``sampled`` the decision itself — False means "do not
    export spans for this request" (a host with a flight recorder still
    shadow-records them); ``tenant`` rides along so host-side spans are
    tenant-attributable without a second lookup.
    """

    trace_id: str
    span_id: str | None = None
    sampled: bool = True
    tenant: str | None = None

    def to_wire(self) -> dict:
        d: dict = {"trace_id": self.trace_id, "sampled": self.sampled}
        if self.span_id is not None:
            d["span_id"] = self.span_id
        if self.tenant is not None:
            d["tenant"] = self.tenant
        return d

    @staticmethod
    def from_wire(d: dict | None) -> "TraceContext | None":
        """Tolerant decode: a missing/malformed ``trace_ctx`` field is
        None (the request simply runs untraced) — a peer speaking a
        newer dialect can never wedge admission."""
        if not isinstance(d, dict) or not d.get("trace_id"):
            return None
        return TraceContext(
            trace_id=str(d["trace_id"]),
            span_id=(
                str(d["span_id"]) if d.get("span_id") is not None else None
            ),
            sampled=bool(d.get("sampled", True)),
            tenant=(
                str(d["tenant"]) if d.get("tenant") is not None else None
            ),
        )


# --------------------------------------------------------------------------
# Clock alignment
# --------------------------------------------------------------------------


class ClockSync:
    """Per-host monotonic-clock offset estimation from heartbeat RTTs.

    Each heartbeat round gives one exchange: the controller stamps its
    send time ``t`` into the probe, the agent echoes it back with its
    own clock ``agent_t``, and the controller reads ``t_recv`` at ack
    arrival. The midpoint method assumes the remote stamp was taken
    halfway through the round trip::

        offset = agent_t - (t_send + t_recv) / 2
        host_clock = controller_clock + offset

    The uncertainty is ``rtt / 2`` — the remote stamp could have been
    taken anywhere inside the round trip, so the TRUE offset lies in
    ``offset ± rtt/2`` under any path asymmetry; no tighter bound is
    honest without a symmetric-delay assumption. A sliding window keeps
    the last ``window`` exchanges per host and :meth:`offset` trusts
    the MINIMUM-RTT one (least queueing noise), so one slow ack never
    poisons the estimate.
    """

    def __init__(self, *, window: int = 32) -> None:
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        self.window = window
        self._lock = threading.Lock()
        #: host -> deque[(rtt_s, offset_s)], newest last. guarded_by _lock
        self._samples: dict[str, deque] = {}

    def observe(
        self, host: str, t_send: float, t_recv: float, remote_t: float
    ) -> None:
        """Fold one heartbeat exchange in. Exchanges with a negative
        RTT (clock retrograde — cannot happen on one monotonic clock,
        CAN happen if a caller mixes clocks) are discarded."""
        rtt = t_recv - t_send
        if rtt < 0.0:
            return
        offset = remote_t - (t_send + t_recv) / 2.0
        with self._lock:
            dq = self._samples.setdefault(host, deque(maxlen=self.window))
            dq.append((rtt, offset))

    def offset(self, host: str) -> tuple[float, float] | None:
        """``(offset_s, err_s)`` for ``host`` from the minimum-RTT
        exchange in the window, or None before the first exchange.
        ``err_s`` is the half-RTT uncertainty bound of THAT exchange."""
        with self._lock:
            dq = self._samples.get(host)
            if not dq:
                return None
            rtt, off = min(dq, key=lambda s: s[0])
        return off, rtt / 2.0

    def rtt_ms(self, host: str) -> float | None:
        """Most recent exchange's RTT in milliseconds (None before the
        first exchange) — the ``host_heartbeat`` event's ``rtt_ms``."""
        with self._lock:
            dq = self._samples.get(host)
            if not dq:
                return None
            return dq[-1][0] * 1e3

    def snapshot(self) -> dict[str, dict]:
        """Per-host ``{clock_offset_s, clock_err_s, samples}`` — what
        ``cluster_summary.trace_coverage`` and merge metadata report."""
        out: dict[str, dict] = {}
        with self._lock:
            hosts = {h: list(dq) for h, dq in self._samples.items()}
        for host, samples in hosts.items():
            if not samples:
                continue
            rtt, off = min(samples, key=lambda s: s[0])
            out[host] = {
                "clock_offset_s": off,
                "clock_err_s": rtt / 2.0,
                "samples": len(samples),
            }
        return out


# --------------------------------------------------------------------------
# Cross-host stitching
# --------------------------------------------------------------------------


def merge_traces(
    exports: dict[str, dict],
    *,
    offsets: dict[str, tuple[float, float]] | None = None,
    controller: str = "controller",
) -> dict:
    """Stitch per-source Chrome exports into ONE merged trace object.

    ``exports`` maps source name (``controller`` plus host ids) to each
    ``Tracer.export()`` dict; ``offsets`` maps host id to its
    ``ClockSync.offset`` pair (host clock = controller clock + offset).
    Every non-controller span's timestamps are rebased into the
    controller's clock frame via its host's offset (a host with no
    estimate keeps its own frame — recorded honestly as
    ``clock_offset_s: None``); span and parent ids are prefixed with
    the source name so per-host ``s%06d`` counters cannot collide, and
    each span gains a ``host`` arg. Each source renders as its own
    process track (``pid`` + a ``process_name`` metadata event). The
    result's ``otherData.hosts`` carries per-source offset ± error and
    coverage counters — the merged timeline ships its own error bars.
    """
    offsets = offsets or {}
    placed: list[tuple[float, dict]] = []  # (abs_controller_ts_s, event)
    hosts_meta: dict[str, dict] = {}
    names = sorted(exports, key=lambda s: (s != controller, s))
    for pid, source in enumerate(names, start=1):
        export = exports[source] or {}
        other = export.get("otherData", {})
        t0 = float(other.get("clock_t0_s", 0.0))
        off_err = offsets.get(source) if source != controller else (0.0, 0.0)
        off = off_err[0] if off_err is not None else None
        hosts_meta[source] = {
            "clock_offset_s": off,
            "clock_err_s": off_err[1] if off_err is not None else None,
            "traces_seen": other.get("traces_seen", 0),
            "traces_kept": other.get("traces_kept", 0),
            "spans_dropped": other.get("spans_dropped", 0),
            "spans": len(export.get("traceEvents", [])),
        }
        for ev in export.get("traceEvents", []):
            ev = dict(ev)
            args = dict(ev.get("args") or {})
            for key in ("span_id", "parent_id"):
                if args.get(key):
                    args[key] = f"{source}:{args[key]}"
            if source != controller:
                args.setdefault("host", source)
            ev["args"] = args
            ev["pid"] = pid
            # Host-frame absolute seconds, mapped into the controller
            # frame when an offset estimate exists.
            abs_s = float(ev.get("ts", 0.0)) / 1e6 + t0
            if off is not None:
                abs_s -= off
            placed.append((abs_s, ev))
    base = min((t for t, _ in placed), default=0.0)
    trace_events: list[dict] = [
        {
            "name": "process_name",
            "ph": "M",
            "pid": pid,
            "tid": 0,
            "args": {"name": source},
        }
        for pid, source in enumerate(names, start=1)
    ]
    for abs_s, ev in sorted(placed, key=lambda p: p[0]):
        ev["ts"] = round((abs_s - base) * 1e6, 3)
        trace_events.append(ev)
    return {
        "traceEvents": trace_events,
        "displayTimeUnit": "ms",
        "otherData": {
            "generator": "gnot_tpu_torch.obs.dtrace",
            "hosts": hosts_meta,
        },
    }


def write_trace(path: str, merged: dict) -> str:
    """Atomic JSON write (tmp + rename) of a merged trace file."""
    if d := os.path.dirname(path):
        os.makedirs(d, exist_ok=True)
    tmp = f"{path}.tmp"
    with open(tmp, "w") as f:
        json.dump(merged, f)
    os.replace(tmp, path)
    return path


# --------------------------------------------------------------------------
# Flight recorder
# --------------------------------------------------------------------------


class FlightRecorder:
    """Bounded ring buffer of the trailing ``window_s`` of spans and
    events, regardless of sample rate, dumped atomically on trigger.

    Hooked into a :class:`~gnot_tpu_torch.obs.tracing.Tracer` via its
    ``recorder=`` argument, the recorder sees EVERY closed span —
    sampled ones on their way to the export buffer AND shadow spans of
    sampled-out traces that exist nowhere else. Event records arrive
    through :class:`FlightRecorderSink`. Retention is by time window
    (entries older than ``window_s`` behind the newest are evicted on
    append) with a hard ``max_items`` cap so a hot window stays
    bounded; evictions are counted, never silent.

    :meth:`trigger` snapshots the ring under the lock and writes the
    dump OUTSIDE it (one file per trigger, ``flight_<seq>_<kind>.json``
    via tmp+rename — a reader never sees a torn dump), tagged with the
    triggering event.
    """

    def __init__(
        self,
        dir: str,
        *,
        window_s: float = 30.0,
        max_items: int = 50_000,
        clock: Callable[[], float] = time.monotonic,
        host: str | None = None,
    ) -> None:
        if window_s <= 0:
            raise ValueError(f"window_s must be > 0, got {window_s}")
        if max_items < 1:
            raise ValueError(f"max_items must be >= 1, got {max_items}")
        self.dir = dir
        self.window_s = window_s
        self.max_items = max_items
        self.host = host
        self._clock = clock
        self._lock = threading.Lock()
        self._ring: deque = deque()  #: guarded_by _lock
        self._evicted = 0  #: guarded_by _lock
        self._seq = 0  #: guarded_by _lock
        self.dumps: list[str] = []  # paths written, newest last

    # -- recording ---------------------------------------------------------
    def record_span(self, span) -> None:
        """One closed span (an ``obs/tracing.Span``) into the ring."""
        entry = {
            "type": "span",
            "t": span.end,
            "name": span.name,
            "trace_id": span.trace_id,
            "span_id": span.span_id,
            "parent_id": span.parent_id,
            "start": span.start,
            "end": span.end,
            "tid": span.tid,
            "args": span.args,
        }
        self._append(entry, span.end)

    def record_event(self, record: dict) -> None:
        """One sink record into the ring (stamped with the recorder's
        clock — sink records carry no monotonic time of their own)."""
        t = self._clock()
        self._append({"type": "event", "t": t, "record": dict(record)}, t)

    def _append(self, entry: dict, t: float) -> None:
        cutoff = t - self.window_s
        with self._lock:
            self._ring.append(entry)
            while self._ring and (
                len(self._ring) > self.max_items
                or self._ring[0]["t"] < cutoff
            ):
                self._ring.popleft()
                self._evicted += 1

    # -- inspection / dump -------------------------------------------------
    def snapshot(self) -> dict:
        with self._lock:
            return {
                "host": self.host,
                "window_s": self.window_s,
                "entries": list(self._ring),
                "evicted": self._evicted,
            }

    def trigger(self, kind: str, **info) -> str:
        """Dump the current ring, tagged with the triggering event.
        Returns the written path. Every trigger writes its own file —
        a second fault arriving during a postmortem must not overwrite
        the first one's evidence."""
        with self._lock:
            self._seq += 1
            seq = self._seq
            entries = list(self._ring)
            evicted = self._evicted
        dump = {
            "trigger": {"kind": kind, "t": self._clock(), **info},
            "host": self.host,
            "window_s": self.window_s,
            "evicted": evicted,
            "entries": entries,
        }
        os.makedirs(self.dir, exist_ok=True)
        path = os.path.join(self.dir, f"flight_{seq:03d}_{kind}.json")
        tmp = f"{path}.tmp"
        with open(tmp, "w") as f:
            json.dump(dump, f, default=str)
        os.replace(tmp, path)
        self.dumps.append(path)
        return path

    def watch_lockguard(self) -> None:
        """Register this recorder with ``utils/lockguard.py``: a
        runtime lock-order inversion report becomes a trigger edge
        (the black box captures the seconds BEFORE a deadlock risk,
        which is exactly when it matters)."""
        from gnot_tpu_torch.utils import lockguard

        def _on_report(record: dict) -> None:
            self.trigger(
                "lockguard_warning",
                message=str(record.get("message", "")),
            )

        lockguard.on_report = _on_report


#: Sink-record predicates that fire a flight-recorder dump. Level
#: discipline matters: ``slo_alert`` triggers on the FIRE edge only
#: (its 'clear' edge is good news), the others are intrinsically
#: edge-emitted by their producers.
TRIGGER_EVENTS: dict[str, Callable[[dict], bool]] = {
    "slo_alert": lambda r: r.get("state") == "fire",
    "breaker_open": lambda r: True,
    "host_dead": lambda r: True,
    "non_finite_loss": lambda r: True,
}


class FlightRecorderSink:
    """MetricsSink wrapper feeding (and triggering) a flight recorder.

    Every record passes through to the inner sink unchanged, is copied
    into the recorder's ring, and — when it matches
    :data:`TRIGGER_EVENTS` — fires a dump tagged with the event. The
    wrapper is transparent: a pipeline built with or without it emits
    the identical event stream.
    """

    def __init__(self, inner, recorder: FlightRecorder) -> None:
        self._inner = inner
        self.recorder = recorder

    def log(self, **fields) -> None:
        if self._inner is not None:
            self._inner.log(**fields)
        self.recorder.record_event(fields)
        kind = fields.get("event")
        pred = TRIGGER_EVENTS.get(kind) if kind is not None else None
        if pred is not None and pred(fields):
            info = {
                k: fields[k]
                for k in ("host", "reason", "state", "objective", "tenant")
                if k in fields
            }
            self.recorder.trigger(kind, **info)

    def flush(self) -> None:
        if self._inner is not None and hasattr(self._inner, "flush"):
            self._inner.flush()
