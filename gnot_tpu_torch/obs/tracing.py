"""Host-side span tracing, exported as Chrome trace-event JSON.

Port of ``Span``, ``Tracer`` and ``percentiles`` of
``gnot_tpu/obs/tracing.py``: the same span names, nesting, head-sampling
rule, bounded buffer and export format, so ``tools/trace_report.py``
reads the port's files as it reads the JAX package's.

* **No device syncs.** A span is two reads of a monotonic clock and one
  locked list append; nothing here touches a tensor.
* **Head sampling.** The keep/drop decision is made once per trace at
  ``start_trace``, per stream, by a counter rule with no RNG: trace ``n``
  of a stream is kept iff ``floor(n * rate) > floor((n - 1) * rate)``.
  At one rate the port keeps the same traces as the JAX tracer.
* **Bounded buffer, explicit flush.** At most ``max_spans`` spans are
  held; later ones are counted as ``dropped``. ``flush`` writes the file
  and, given a sink, a ``trace_flush`` event.
* **Profiler bridge.** With ``annotate=True`` (``--profile_dir``) each
  span is also a ``torch.profiler.record_function`` range, so host spans
  line up with the kernels in the profile.

Span taxonomy: serving, per request, ``admission -> queue_wait ->
batch_assembly -> dispatch -> device -> unpad -> resolve``; training, per
epoch, an ``epoch`` root with ``data_iter`` / ``step`` (containing
``host_to_device`` and ``step_dispatch``) / ``telemetry_drain`` /
``eval`` / ``checkpoint_save`` children.

Cluster tracing (``obs/dtrace.py``, ``serve/federation.py``): ``adopt``
is the receiving side of trace propagation. A host never re-decides
sampling for work the cluster controller placed: it takes the propagated
``TraceContext``'s id and decision, and counts the id once in an adoption
ledger that ``coverage()`` adds in. With a flight recorder attached
(``recorder=``) every closed span is copied into its ring, and a trace
sampled out at ``start_trace`` gets a shadow id (``"!"``-prefixed) whose
spans go to the ring only, never to the export buffer.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import json
import math
import os
import threading
import time
from typing import Callable, Iterable, Iterator

from gnot_tpu_torch.obs import events

#: Serve-side span names, in request-lifecycle order.
SERVE_SPANS = (
    "admission",
    "queue_wait",
    "batch_assembly",
    "dispatch",
    "device",
    "unpad",
    "resolve",
)

#: Train-side span names.
TRAIN_SPANS = (
    "epoch",
    "data_iter",
    "step",
    "host_to_device",
    "step_dispatch",
    "telemetry_drain",
    "eval",
    "checkpoint_save",
)


@dataclasses.dataclass
class Span:
    """One closed host-side span; times are raw ``clock()`` seconds."""

    name: str
    trace_id: str
    span_id: str
    parent_id: str | None
    start: float
    end: float
    tid: int
    args: dict | None = None
    #: Set inside a ``span()`` block to drop the span on exit.
    discard: bool = False

    @property
    def duration_ms(self) -> float:
        return (self.end - self.start) * 1e3


class Tracer:
    """Thread-safe span recorder with deterministic head sampling.

    ``clock`` is any monotonic ``() -> float``; ``sample_rate`` in [0, 1]
    keeps that fraction of traces per stream; ``max_spans`` bounds host
    memory; ``annotate`` mirrors each span onto the torch profiler's
    timeline; ``recorder`` an ``obs/dtrace.FlightRecorder`` that sees every
    closed span, shadow spans of sampled-out traces included."""

    def __init__(
        self,
        *,
        path: str = "",
        sample_rate: float = 1.0,
        max_spans: int = 100_000,
        clock: Callable[[], float] = time.monotonic,
        annotate: bool = False,
        recorder=None,
    ):
        if not 0.0 <= sample_rate <= 1.0:
            raise ValueError(
                f"sample_rate must be in [0, 1], got {sample_rate}"
            )
        if max_spans < 1:
            raise ValueError(f"max_spans must be >= 1, got {max_spans}")
        self.path = path
        self.sample_rate = sample_rate
        self.max_spans = max_spans
        self._clock = clock
        self._annotate = annotate
        self._recorder = recorder
        self._t0 = clock()
        self._lock = threading.Lock()
        self._spans: list[Span] = []  #: guarded_by _lock
        self._dropped = 0  #: guarded_by _lock
        # Per-stream sampling counters (stream = trace-id prefix).
        self._stream_seen: dict[str, int] = {}  #: guarded_by _lock
        self._stream_kept: dict[str, int] = {}  #: guarded_by _lock
        # The adoption ledger: unique trace ids this tracer adopted rather
        # than decided, and how many of them were sampled.
        self._adopted_ids: set[str] = set()  #: guarded_by _lock
        self._adopted_kept = 0  #: guarded_by _lock
        self._next_span = 0  #: guarded_by _lock
        self._current: contextvars.ContextVar[Span | None] = (
            contextvars.ContextVar("gnot_torch_trace_span", default=None)
        )

    def start_trace(self, stream: str = "t") -> str | None:
        """The head-sampling decision: a fresh ``trace_id`` when this
        trace is kept, ``None`` when it is sampled out (every later span
        call on it is then a no-op). Each ``stream`` (the id prefix)
        counts and samples on its own. With a flight recorder attached, a
        sampled-out trace gets a shadow id (``"!"`` and the stream's seen
        count) whose spans go to the recorder's ring only."""
        with self._lock:
            n = self._stream_seen.get(stream, 0) + 1
            self._stream_seen[stream] = n
            keep = math.floor(n * self.sample_rate) > math.floor(
                (n - 1) * self.sample_rate
            )
            if not keep:
                if self._recorder is not None:
                    return f"!{stream}{n:06d}"
                return None
            kept = self._stream_kept.get(stream, 0) + 1
            self._stream_kept[stream] = kept
            return f"{stream}{kept:06d}"

    def adopt(self, ctx) -> str | None:
        """The local trace id for a propagated ``obs/dtrace.TraceContext``,
        honouring the sender's sampling decision (this tracer's counters
        are not consulted): a sampled context keeps its id, an unsampled
        one shadow-records with a recorder attached (the ``"!"`` prefix
        kept across hops) and is None otherwise. Each id enters the
        adoption ledger once, however many steps of a session adopt it."""
        if ctx is None or not ctx.trace_id:
            return None
        tid = ctx.trace_id
        sampled = ctx.sampled and not tid.startswith("!")
        bare = tid.lstrip("!")
        with self._lock:
            if bare not in self._adopted_ids:
                self._adopted_ids.add(bare)
                if sampled:
                    self._adopted_kept += 1
        if sampled:
            return tid
        if self._recorder is not None:
            return tid if tid.startswith("!") else f"!{tid}"
        return None

    def _new_span_id(self) -> str:
        with self._lock:
            self._next_span += 1
            return f"s{self._next_span:06d}"

    @contextlib.contextmanager
    def span(self, name: str, *, trace: str | None = None, args: dict | None = None):
        """Context-managed span. ``trace`` pins the trace id (root spans);
        omitted, it inherits the enclosing span's on this thread. With
        neither, or an unsampled ``trace=None``, it yields ``None`` and
        records nothing. The enclosing span is the parent when it shares
        the trace id."""
        parent = self._current.get()
        trace_id = trace if trace is not None else (
            parent.trace_id if parent is not None else None
        )
        if trace_id is None:
            yield None
            return
        parent_id = (
            parent.span_id
            if parent is not None and parent.trace_id == trace_id
            else None
        )
        s = Span(
            name=name,
            trace_id=trace_id,
            span_id=self._new_span_id(),
            parent_id=parent_id,
            start=self._clock(),
            end=0.0,
            tid=threading.get_ident(),
            args=args,
        )
        token = self._current.set(s)
        ann = None
        if self._annotate:
            from gnot_tpu_torch.utils import profiling

            ann = profiling.annotate(name)
            ann.__enter__()
        try:
            yield s
        finally:
            if ann is not None:
                ann.__exit__(None, None, None)
            self._current.reset(token)
            s.end = self._clock()
            if not s.discard:
                self._store(s)

    def add_span(
        self,
        name: str,
        start: float,
        end: float,
        *,
        trace: str | None,
        parent_id: str | None = None,
        tid: int | None = None,
        args: dict | None = None,
    ) -> str | None:
        """Record a span from timestamps taken elsewhere (a request's
        queue wait starts on the client thread and ends on the worker).
        Returns the span id, or None for an unsampled trace."""
        if trace is None:
            return None
        s = Span(
            name=name,
            trace_id=trace,
            span_id=self._new_span_id(),
            parent_id=parent_id,
            start=start,
            end=end,
            tid=tid if tid is not None else threading.get_ident(),
            args=args,
        )
        self._store(s)
        return s.span_id

    def timed_iter(
        self, it: Iterable, name: str, *, trace: str | None
    ) -> Iterator:
        """Wrap an iterator so each ``next()`` is one ``name`` span; the
        final exhausted ``next()`` is discarded, so N pulls export N
        spans."""
        it = iter(it)
        _end = object()
        while True:
            with self.span(name, trace=trace) as sp:
                item = next(it, _end)
                if item is _end and sp is not None:
                    sp.discard = True
            if item is _end:
                return
            yield item

    def _store(self, s: Span) -> None:
        if self._recorder is not None:
            self._recorder.record_span(s)
        if s.trace_id.startswith("!"):
            return  # a shadow span: the ring only, never the export buffer
        with self._lock:
            if len(self._spans) < self.max_spans:
                self._spans.append(s)
            else:
                self._dropped += 1

    def snapshot(self) -> list[Span]:
        with self._lock:
            return list(self._spans)

    @property
    def dropped(self) -> int:
        with self._lock:
            return self._dropped

    def coverage(self) -> dict:
        """Traces seen and kept (all streams, adopted ids included), the
        adopted ids, spans dropped to the buffer bound, and the rate."""
        with self._lock:
            return {
                "seen": sum(self._stream_seen.values()) + len(self._adopted_ids),
                "kept": sum(self._stream_kept.values()) + self._adopted_kept,
                "adopted": len(self._adopted_ids),
                "dropped": self._dropped,
                "sample_rate": self.sample_rate,
            }

    def export(self) -> dict:
        """The buffered spans as a Chrome trace-event JSON object
        (``ph: "X"`` complete events, microsecond timestamps rebased to
        the earliest span start)."""
        with self._lock:
            spans = list(self._spans)
            dropped = self._dropped
            kept = sum(self._stream_kept.values())
            seen = sum(self._stream_seen.values())
        t0 = min((s.start for s in spans), default=self._t0)
        trace_events = [
            {
                "name": s.name,
                "cat": "host",
                "ph": "X",
                "ts": round((s.start - t0) * 1e6, 3),
                "dur": round((s.end - s.start) * 1e6, 3),
                "pid": os.getpid(),
                "tid": s.tid,
                "args": {
                    "trace_id": s.trace_id,
                    "span_id": s.span_id,
                    **({"parent_id": s.parent_id} if s.parent_id else {}),
                    **(s.args or {}),
                },
            }
            for s in spans
        ]
        return {
            "traceEvents": trace_events,
            "displayTimeUnit": "ms",
            "otherData": {
                "generator": "gnot_tpu_torch.obs.tracing",
                "sample_rate": self.sample_rate,
                "traces_seen": seen,
                "traces_kept": kept,
                "spans_dropped": dropped,
                "clock_t0_s": t0,
            },
        }

    def flush(self, sink=None) -> str | None:
        """Write the Chrome trace file to ``self.path`` (no-op without a
        path) and, given a sink, a ``trace_flush`` event. The file is
        rewritten whole; buffered spans are kept."""
        if not self.path:
            return None
        out = self.export()
        if d := os.path.dirname(self.path):
            os.makedirs(d, exist_ok=True)
        tmp = f"{self.path}.tmp"
        with open(tmp, "w") as f:
            json.dump(out, f)
        os.replace(tmp, self.path)
        if sink is not None:
            sink.log(
                event=events.TRACE_FLUSH,
                path=self.path,
                spans=len(out["traceEvents"]),
                dropped=out["otherData"]["spans_dropped"],
            )
        return self.path


def percentiles(values_ms: list[float]) -> dict:
    """p50/p99 of a duration list, nearest rank on the sorted values.
    Empty gives Nones."""
    if not values_ms:
        return {"p50_ms": None, "p99_ms": None}
    v = sorted(values_ms)
    rank = lambda q: v[min(len(v) - 1, math.ceil(q * len(v)) - 1)]  # noqa: E731
    return {
        "p50_ms": round(rank(0.50), 4),
        "p99_ms": round(rank(0.99), 4),
    }
