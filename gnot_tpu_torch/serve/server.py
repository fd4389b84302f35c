"""InferenceServer core: admission, per-bucket batching, one worker.

Port of the core of ``gnot_tpu/serve/server.py::InferenceServer``:
``submit`` admits a request (bounded queue, fast-fail when full or
invalid), one worker thread drives Batcher -> ``engine.infer`` ->
resolved futures, and ``drain`` stops admission, flushes what is
queued, joins the worker and returns a summary. Every future resolves
on every path; a request is never left hanging.

With ``pack_plan`` the server dispatches packed ("pack, don't pad"):
every request the plan fits shares one bucket (``PACKED_BUCKET``) whose
dispatches the batcher cuts by first-fit FIFO prefix packing, and each
goes through ``engine.infer_packed`` as chunk-aligned segments of the
plan's fixed shape; a request the plan does not fit takes the padded
per-bucket path, so packing rejects nothing the padded server accepts.
``summary()`` reports each bucket's real and capacity tokens
(``pad_waste_by_bucket``) under the names of JAX's ``serve_summary``.

With a ``sink`` (``utils/metrics.MetricsSink``) the server writes JAX's
events: ``shed`` at each admission reject it records (invalid input, a
full queue), ``queue_depth`` per dispatch and ``serve_summary`` at drain.
With a ``tracer`` (``obs/tracing.Tracer``) each sampled request gets
JAX's chain of spans on the server's clock: ``admission`` (with its
``reason``) -> ``queue_wait`` -> ``batch_assembly`` -> ``dispatch`` (with
``device`` and ``unpad`` inside) -> ``resolve``; a request swept at drain
ends at a ``queue_wait`` with ``reason="rejected_draining"``. The port has
no jit, so no ``compile`` span.

Not ported yet: the circuit breaker, deadlines, tenants, rollout
sessions, fault injection and hot reload (``reloads`` and
``breaker_trips`` in the summary are 0).
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
import traceback
from concurrent.futures import Future
from typing import Sequence

import numpy as np

from gnot_tpu_torch.data.batch import MeshSample, PackPlan, pack_prefix
from gnot_tpu_torch.obs import events
from gnot_tpu_torch.obs.tracing import percentiles
from gnot_tpu_torch.serve.batcher import Batcher
from gnot_tpu_torch.serve.engine import InferenceEngine

#: The bucket key every plan-fitting request shares in packed dispatch
#: mode (``pack_plan=``); the batcher sizes its dispatches by first-fit
#: prefix packing instead of max_batch.
PACKED_BUCKET = ("packed",)

REASONS = (
    "ok",
    "shed_queue_full",
    "rejected_invalid",
    "rejected_draining",
    "error_nan_output",
    "error_dispatch",
)


@dataclasses.dataclass
class ServeResult:
    """What a request's Future resolves to — always, on every path."""

    ok: bool
    reason: str  # one of REASONS
    output: np.ndarray | None = None  # [n_i, out_dim] when ok
    detail: str = ""
    latency_ms: float = 0.0


@dataclasses.dataclass
class _Request:
    sample: MeshSample
    future: Future
    submitted: float
    trace: str | None = None  # the tracer's id, None when not sampled


def _percentile(values: list[float], q: float) -> float | None:
    return float(np.percentile(values, q)) if values else None


class InferenceServer:
    """One worker thread draining a bounded request queue through the
    engine. ``submit()`` is thread-safe and non-blocking; results arrive
    via ``concurrent.futures.Future``."""

    def __init__(
        self,
        engine: InferenceEngine,
        *,
        max_batch: int = 4,
        max_wait_ms: float = 10.0,
        queue_limit: int = 64,
        pack_plan: PackPlan | None = None,
        sink=None,
        tracer=None,
    ):
        if queue_limit < 1:
            raise ValueError(f"queue_limit must be >= 1, got {queue_limit}")
        self.engine = engine
        self.max_batch = max_batch
        self.queue_limit = queue_limit
        self.pack_plan = pack_plan
        self.sink = sink
        self._tracer = tracer
        self._clock = time.monotonic

        def key_fn(r):
            if pack_plan is not None and pack_plan.packable(r.sample):
                return PACKED_BUCKET
            return engine.bucket_key(r.sample)

        def take_fn(key, reqs):
            if key is not PACKED_BUCKET:
                return None
            return len(pack_prefix([r.sample.coords.shape[0] for r in reqs], pack_plan))

        # Owned by the worker thread alone once start() ran.
        self.batcher = Batcher(
            max_batch=max_batch,
            max_wait_ms=max_wait_ms,
            key_fn=key_fn,
            take_fn=take_fn if pack_plan is not None else None,
        )
        self._inbound: queue.Queue = queue.Queue()
        self._draining = threading.Event()
        self._worker: threading.Thread | None = None
        self.warmed = 0
        self._lock = threading.Lock()
        self._in_system = 0  #: guarded_by _lock
        self._submitted = 0  #: guarded_by _lock
        self._admitted = 0  #: guarded_by _lock
        self._completed = 0  #: guarded_by _lock
        self._dispatches = 0  #: guarded_by _lock
        self._shed: dict[str, int] = {}  #: guarded_by _lock
        self._latency_ms: list[float] = []  #: guarded_by _lock
        self._dispatch_ms: list[float] = []  #: guarded_by _lock
        # Per bucket: dispatches, real and capacity node tokens.
        self._pack_stats: dict[str, dict[str, int]] = {}  #: guarded_by _lock
        # Per bucket, over the traced requests: queue and device ms.
        self._bucket_stats: dict[str, dict[str, list]] = {}  #: guarded_by _lock

    # -- client side -------------------------------------------------------

    def start(self, warmup: Sequence[MeshSample] = ()) -> "InferenceServer":
        """Start the worker. With ``warmup`` samples the worker first runs
        one dispatch per bucket among them (``engine.warmup``), and with a
        ``pack_plan`` one packed dispatch (``engine.warmup_packed``), and
        this returns once that is done (``self.warmed`` dispatches). The warm-up
        runs on the worker thread itself because PyTorch keeps per-thread
        CUDA state (the cuBLAS handle and its workspace): warmed on
        another thread, the first live dispatch would still pay for it."""
        if self._worker is not None:
            raise RuntimeError("server already started")
        ready: Future = Future()
        self._worker = threading.Thread(
            target=self._run, args=(list(warmup), ready),
            name="gnot-torch-serve-worker", daemon=True,
        )
        self._worker.start()
        self.warmed = ready.result()  # re-raises a failed warm-up
        return self

    def submit(self, sample: MeshSample) -> Future:
        """Admit one request. Fast-fails (resolved Future) when draining,
        on invalid input (non-finite / oversize, named by index) and when
        ``queue_limit`` requests are already in the system."""
        fut: Future = Future()
        now = self._clock()
        # Head sampling decides once, at submit; every later span of this
        # request reuses the id.
        trace = self._tracer.start_trace() if self._tracer is not None else None
        with self._lock:
            self._submitted += 1
        if self._draining.is_set():
            return self._reject(fut, "rejected_draining", now, trace)
        try:
            self.engine.validate([sample])
        except ValueError as err:
            self._event(events.SHED, reason="rejected_invalid", detail=str(err),
                        **({"trace_id": trace} if trace else {}))
            return self._reject(fut, "rejected_invalid", now, trace, str(err))
        # Enqueue under the same lock drain() sets its flag under: a put
        # serialized before the flag flips is seen by the worker's final
        # sweep, one serialized after it is rejected here.
        with self._lock:
            depth = self._in_system
            if self._draining.is_set():
                reason = "rejected_draining"
            elif self._in_system >= self.queue_limit:
                reason = "shed_queue_full"
            else:
                reason = None
                self._in_system += 1
                self._admitted += 1
                self._inbound.put(_Request(sample, fut, now, trace))
        if reason == "shed_queue_full":
            self._event(events.SHED, reason=reason, depth=depth, limit=self.queue_limit,
                        **({"trace_id": trace} if trace else {}))
        if reason is not None:
            return self._reject(fut, reason, now, trace)
        # Admission closed; queue_wait opens here and is recorded at
        # dispatch, when its end is known.
        self._trace_span(trace, "admission", now, reason="admitted")
        return fut

    def _reject(self, fut: Future, reason: str, now: float, trace, detail: str = "") -> Future:
        with self._lock:
            self._shed[reason] = self._shed.get(reason, 0) + 1
        self._trace_span(trace, "admission", now, reason=reason)
        fut.set_result(
            ServeResult(
                ok=False, reason=reason, detail=detail,
                latency_ms=(self._clock() - now) * 1e3,
            )
        )
        return fut

    def drain(self, timeout_s: float = 30.0) -> dict:
        """Graceful shutdown: stop admitting, flush every queued request
        through dispatch, join the worker, write the ``serve_summary``
        event and return the summary."""
        with self._lock:
            self._draining.set()
        if self._worker is not None:
            self._inbound.put(None)  # wake the worker
            self._worker.join(timeout=timeout_s)
            if self._worker.is_alive():
                # A dispatch is stuck past the budget; the worker still
                # owns the batcher, so report what we have.
                return self._summary(emit=True)
        # The worker has exited (or never ran): resolve anything left.
        left = []
        try:
            while True:
                item = self._inbound.get_nowait()
                if item is not None:
                    left.append(item)
        except queue.Empty:
            pass
        for r in left + list(self.batcher.requests()):
            self._finish(r, ServeResult(ok=False, reason="rejected_draining"))
            # The chain ends at its shed point, with the reason.
            self._trace_span(r.trace, "queue_wait", r.submitted, reason="rejected_draining")
        return self._summary(emit=True)

    def summary(self) -> dict:
        """The serving rollup under the names of JAX's ``serve_summary``:
        requests, admitted, completed, sheds by reason, dispatches,
        ``reloads`` and ``breaker_trips`` (0: neither is ported),
        ``compiled_shapes`` (distinct dispatch shapes), the host-clock
        latency p50 / p99 of completed requests, and per bucket the real
        and capacity node tokens of its dispatches (fill = real /
        capacity, pad waste = 1 - fill); then the serving dtype and the
        dispatch times. With a tracer, the per-bucket queue / device
        split of the traced requests and the trace's coverage."""
        return self._summary(emit=False)

    def _summary(self, *, emit: bool) -> dict:
        with self._lock:
            pad_waste = {
                key: {
                    **st,
                    "fill_frac": st["real_tokens"] / st["capacity_tokens"],
                    "pad_waste_frac": 1.0 - st["real_tokens"] / st["capacity_tokens"],
                }
                for key, st in sorted(self._pack_stats.items())
            }
            summary = {
                "requests": self._submitted,
                "admitted": self._admitted,
                "completed": self._completed,
                "shed": dict(self._shed),
                "dispatches": self._dispatches,
                "reloads": 0,
                "breaker_trips": 0,
                "compiled_shapes": self.engine.dispatch_shapes,
                "latency_p50_ms": _percentile(self._latency_ms, 50),
                "latency_p99_ms": _percentile(self._latency_ms, 99),
                "dtype": self.engine.dtype,
                "dispatch_ms_p50": _percentile(self._dispatch_ms, 50),
                "dispatch_ms_max": max(self._dispatch_ms, default=None),
                "pad_waste_by_bucket": pad_waste,
            }
            bucket_stats = {k: {kk: list(vv) for kk, vv in v.items()}
                            for k, v in self._bucket_stats.items()}
        if self._tracer is not None:
            # The same population and nearest-rank percentiles as
            # tools/trace_report.py's per-bucket breakdown of the file.
            summary["queue_device_by_bucket"] = {
                key: {
                    "n": len(st["queue_ms"]),
                    **{f"queue_{k}": v for k, v in percentiles(st["queue_ms"]).items()},
                    **{f"device_{k}": v for k, v in percentiles(st["device_ms"]).items()},
                }
                for key, st in sorted(bucket_stats.items())
            }
            summary["trace"] = self._tracer.coverage()
        if emit:
            self._event(events.SERVE_SUMMARY, **summary)
            if self.sink is not None:
                self.sink.flush()
        return summary

    # -- worker side -------------------------------------------------------

    def _run(self, warmup: list[MeshSample], ready: Future) -> None:
        try:
            warmed = self.engine.warmup(warmup, rows=self.max_batch)
            if self.pack_plan is not None:
                warmed += self.engine.warmup_packed(warmup, self.pack_plan)
            ready.set_result(warmed)
        except Exception as err:  # noqa: BLE001 — handed to start()'s caller
            ready.set_exception(err)
            return
        while True:
            if self._draining.is_set():
                timeout = 0.0
            else:
                timeout = self.batcher.next_flush_in(self._clock())
                timeout = 0.1 if timeout is None else min(timeout, 0.1)
            try:
                item = self._inbound.get(timeout=timeout)
                if item is not None:
                    self.batcher.add(item, self._clock())
            except queue.Empty:
                pass
            # Absorb the rest of the burst without blocking.
            try:
                while True:
                    item = self._inbound.get_nowait()
                    if item is not None:
                        self.batcher.add(item, self._clock())
            except queue.Empty:
                pass
            draining = self._draining.is_set()
            for key, reqs in self.batcher.pop_ready(self._clock(), flush_all=draining):
                self._dispatch(key, reqs)
            if draining and len(self.batcher) == 0 and self._inbound.empty():
                return

    def _dispatch(self, key, reqs: list[_Request]) -> None:
        """One bucket's batch: padded to ``max_batch`` rows in ONE engine
        dispatch, or for the packed bucket cut into plan-shaped packed
        dispatches in arrival order (first-fit prefixes). Resolves every
        request of the batch."""
        if key is not PACKED_BUCKET:
            self._dispatch_one(reqs, None, key)
            return
        rest = reqs
        while rest:
            placements = pack_prefix([r.sample.coords.shape[0] for r in rest], self.pack_plan)
            n = max(1, len(placements))
            self._dispatch_one(rest[:n], placements[:n], key)
            rest = rest[n:]

    def _dispatch_one(self, reqs: list[_Request], placements, key) -> None:
        """ONE engine dispatch: packed at ``placements`` into the pack
        plan, or (None) padded at the bucket ``key``'s shape; then the
        pad-waste tally, the finiteness check and the resolves, with the
        ``queue_depth`` event and the traced members' spans."""
        plan = self.pack_plan if placements is not None else None
        t0 = self._clock()
        with self._lock:
            self._dispatches += 1
            dispatch = self._dispatches
            depth = self._in_system
        if plan is not None:
            bucket, capacity = f"packed:{plan.n_rows}x{plan.row_len}", plan.capacity_tokens
            bucket_nodes, bucket_funcs = plan.row_len, plan.pad_funcs
        else:
            bucket, capacity = f"{key[0]}x{key[1]}", self.max_batch * key[0]
            bucket_nodes, bucket_funcs = key
        real = sum(r.sample.coords.shape[0] for r in reqs)
        member_ids = [r.trace for r in reqs if r.trace is not None]
        for r in reqs:
            self._trace_span(r.trace, "queue_wait", r.submitted, t0, bucket=bucket,
                             waited_ms=(t0 - r.submitted) * 1e3)
        self._event(
            events.QUEUE_DEPTH, depth=depth, batched=len(self.batcher), dispatch=dispatch,
            bucket_nodes=bucket_nodes, bucket_funcs=bucket_funcs, n=len(reqs),
            packed=plan is not None, real_tokens=real, capacity_tokens=capacity,
            **({"trace_ids": member_ids} if member_ids else {}),
        )
        # Phase stamps only when a member is traced.
        timings = {} if member_ids else None
        stamps = {"timings": timings, "clock": self._clock} if member_ids else {}
        try:
            samples = [r.sample for r in reqs]
            if plan is not None:
                outs = self.engine.infer_packed(samples, plan, placements=placements, **stamps)
            else:
                pn, pf = key
                outs = self.engine.infer(samples, pad_nodes=pn, pad_funcs=pf,
                                         rows=self.max_batch, **stamps)
        except Exception as err:  # noqa: BLE001 — the worker must keep serving
            traceback.print_exc()
            detail = f"{type(err).__name__}: {err}"
            for r in reqs:
                self._trace_span(r.trace, "dispatch", t0, bucket=bucket, dispatch=dispatch,
                                 error="error_dispatch")
                self._finish(r, ServeResult(ok=False, reason="error_dispatch", detail=detail))
            return
        with self._lock:
            self._dispatch_ms.append((self._clock() - t0) * 1e3)
            st = self._pack_stats.setdefault(
                bucket, {"dispatches": 0, "real_tokens": 0, "capacity_tokens": 0})
            st["dispatches"] += 1
            st["real_tokens"] += real
            st["capacity_tokens"] += capacity
        bad = sum(not np.all(np.isfinite(o)) for o in outs)
        # One stamp ends the dispatch span and starts every resolve, so
        # queue_wait + dispatch is each request's latency.
        done = self._clock()
        self._trace_batch_phases(reqs, timings, t0, done, dispatch, bucket, member_ids)
        for r, o in zip(reqs, outs):
            if bad:
                self._finish(
                    r,
                    ServeResult(
                        ok=False, reason="error_nan_output",
                        detail=f"non-finite outputs for {bad}/{len(reqs)} requests",
                    ),
                    done,
                )
            else:
                self._finish(r, ServeResult(ok=True, reason="ok", output=o), done)

    def _trace_batch_phases(self, reqs, timings, start, done, dispatch, bucket,
                            member_ids) -> None:
        """The batch-level spans (``dispatch`` around the engine's
        ``batch_assembly`` / ``device`` / ``unpad`` stamps), once per traced
        member, linked by ``member_trace_ids``; and the per-bucket queue /
        device rollup of ``serve_summary``."""
        if timings is None:
            return
        link = {"dispatch": dispatch, "bucket": bucket, "member_trace_ids": member_ids}
        t_dev = timings.get("device")
        for r in reqs:
            if r.trace is None:
                continue
            self._trace_span(r.trace, "dispatch", start, done, **link)
            for phase in ("batch_assembly", "device", "unpad"):
                if phase in timings:
                    self._trace_span(r.trace, phase, *timings[phase], **link)
            with self._lock:
                st = self._bucket_stats.setdefault(bucket, {"queue_ms": [], "device_ms": []})
                st["queue_ms"].append((start - r.submitted) * 1e3)
                if t_dev is not None:
                    st["device_ms"].append((t_dev[1] - t_dev[0]) * 1e3)

    def _finish(self, r: _Request, result: ServeResult, now: float | None = None) -> None:
        """Resolve one admitted request at ``now`` (default: the clock),
        with its ``resolve`` span when it reached a dispatch."""
        now = self._clock() if now is None else now
        result.latency_ms = (now - r.submitted) * 1e3
        with self._lock:
            self._in_system -= 1
            if result.ok:
                self._completed += 1
                self._latency_ms.append(result.latency_ms)
            else:
                self._shed[result.reason] = self._shed.get(result.reason, 0) + 1
        r.future.set_result(result)
        if result.reason != "rejected_draining":
            self._trace_span(r.trace, "resolve", now, reason=result.reason,
                             **({"latency_ms": result.latency_ms} if result.ok else {}))

    def _trace_span(self, trace, name: str, start: float, end: float | None = None, **args):
        """One request span on the server's clock (``end`` defaults to
        now); a no-op when tracing is off or the request was not sampled."""
        if self._tracer is None or trace is None:
            return None
        return self._tracer.add_span(name, start, end if end is not None else self._clock(),
                                     trace=trace, args=args or None)

    def _event(self, event: str, **fields) -> None:
        if self.sink is not None:
            self.sink.log(event=event, **fields)
