"""InferenceServer: admission, per-bucket batching, one worker, and what a
single server does when something goes wrong.

Port of the single-server part of ``gnot_tpu/serve/server.py``.
``submit`` admits a request (``policies.AdmissionController``: a bounded
queue, fast-fail when full, invalid or draining), one worker thread
drives Batcher -> ``engine.infer`` -> resolved futures, and ``drain``
stops admission, flushes what is queued, joins the worker and returns a
summary. Every future resolves on every path.

The policies apply in JAX's order at each dispatch:

1. ``slow_request`` (fault injection) stalls the victim's dispatch past
   its deadline;
2. deadline shed: expired requests leave before the forward
   (``shed_deadline``);
3. circuit breaker: while open, the whole group gets
   ``rejected_breaker_open`` at once; it trips on consecutive failed
   dispatches and recovers through one half-open trial;
4. the forward, then ``nan_output`` (fault injection), then the
   finiteness scan: non-finite outputs fail their requests and count one
   breaker failure.

``reload()`` restores on the caller's thread (``CheckpointReloader``: the
checkpointer's fallback walk under a deadline) while the worker serves
the old weights, then publishes atomically through
``engine.swap_params``; a failed restore keeps the old weights serving.
A ``PreemptionHandler`` passed as ``preempt`` makes SIGTERM drain the
server. ``drain(timeout_s)`` emits ``drain_timeout`` when the worker
outlives the budget; a second drain emits no second summary.

With ``pack_plan`` the server dispatches packed ("pack, don't pad"):
every request the plan fits shares one bucket (``PACKED_BUCKET``) whose
dispatches are cut by first-fit FIFO prefix packing, each through
``engine.infer_packed``; a request the plan does not fit takes the
padded per-bucket path.

With a ``sink`` (``utils/metrics.MetricsSink``) the server writes JAX's
events: ``shed``, ``queue_depth`` per dispatch, ``breaker_open`` /
``breaker_close``, ``reload``, ``drain_timeout`` and ``serve_summary``.
With a ``tracer`` (``obs/tracing.Tracer``) each sampled request gets
JAX's chain of spans on the server's clock: ``admission`` -> ``queue_wait``
-> ``batch_assembly`` -> ``dispatch`` (``device`` and ``unpad`` inside) ->
``resolve``; a request shed by its deadline, the breaker or the drain ends
at a ``queue_wait`` with its ``reason``; a reload is one ``reload`` span on
the tracer's ``"r"`` stream. The port has no jit, so no ``compile`` span.

With ``metrics`` (``obs/metrics.MetricsRegistry``) the server registers
JAX's single-server series, by name and label: request, completion,
dispatch and per-reason shed counters, the request and per-bucket
latency histograms, the per-bucket token counters (which are then the
summary's ``pad_waste_by_bucket``), the queue-depth and breaker gauges,
and the rollout and jit-fallback series, which stay at 0 (no rollout
sessions yet; eager PyTorch has no jit fallback). With or without a
registry, the summary's latency percentiles are read from one
``LogHistogram``, as JAX's are.

Not ported yet: tenants, rollout sessions, replicas and the router.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
import traceback
from concurrent.futures import Future
from typing import Callable, Sequence

import numpy as np

from gnot_tpu_torch.data.batch import MeshSample, PackPlan, pack_prefix
from gnot_tpu_torch.obs import events
from gnot_tpu_torch.obs.metrics import LogHistogram
from gnot_tpu_torch.obs.tracing import percentiles
from gnot_tpu_torch.serve.batcher import Batcher
from gnot_tpu_torch.serve.engine import InferenceEngine
from gnot_tpu_torch.serve.policies import AdmissionController, CircuitBreaker, Deadline
from gnot_tpu_torch.train.trainer import serving_weights

#: The bucket key every plan-fitting request shares in packed dispatch
#: mode (``pack_plan=``); the batcher sizes its dispatches by first-fit
#: prefix packing instead of max_batch.
PACKED_BUCKET = ("packed",)

REASONS = (
    "ok",
    "shed_deadline",
    "shed_queue_full",
    "rejected_breaker_open",
    "rejected_invalid",
    "rejected_draining",
    "error_nan_output",
    "error_dispatch",
)

#: Reasons whose request chain ends at its ``queue_wait`` span (it never
#: reached a forward), with no ``resolve`` span.
_ENDS_AT_QUEUE_WAIT = ("rejected_draining", "shed_deadline", "rejected_breaker_open")


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
    ordinal: int  # 1-indexed admission count (the slow_request key)
    submitted: float
    deadline: Deadline | None
    trace: str | None = None  # the tracer's id, None when not sampled


def _percentile(values: list[float], q: float) -> float | None:
    return float(np.percentile(values, q)) if values else None


class InferenceServer:
    """One worker thread draining a bounded request queue through the
    engine. ``submit()`` is thread-safe and non-blocking; results arrive
    via ``concurrent.futures.Future``.

    ``reload_fn(deadline_ms=) -> (state_dict, info) | None`` is the hot
    reload source (``CheckpointReloader``); ``faults`` a
    ``resilience.faults.FaultInjector`` with serve kinds armed;
    ``preempt`` a ``PreemptionHandler`` whose flag the worker polls;
    ``clock`` the monotonic clock of every policy, span and latency."""

    def __init__(
        self,
        engine: InferenceEngine,
        *,
        max_batch: int = 4,
        max_wait_ms: float = 10.0,
        queue_limit: int = 64,
        default_deadline_ms: float = 0.0,
        breaker_threshold: int = 3,
        breaker_cooldown_s: float = 1.0,
        pack_plan: PackPlan | None = None,
        sink=None,
        tracer=None,
        reload_fn: Callable | None = None,
        faults=None,
        preempt=None,
        clock: Callable[[], float] = time.monotonic,
        metrics=None,
    ):
        self.engine = engine
        self.max_batch = max_batch
        self.pack_plan = pack_plan
        self.sink = sink
        self._tracer = tracer
        self.reload_fn = reload_fn
        self.faults = faults
        self.preempt = preempt
        self._clock = clock
        self.default_deadline_ms = default_deadline_ms
        self.admission = AdmissionController(queue_limit)
        self.breaker = CircuitBreaker(
            threshold=breaker_threshold, cooldown_s=breaker_cooldown_s, clock=clock)

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
        self._drained = threading.Event()
        self._worker: threading.Thread | None = None
        self.warmed = 0
        self._lock = threading.Lock()
        self._submitted = 0  #: guarded_by _lock
        self._admitted = 0  #: guarded_by _lock
        self._completed = 0  #: guarded_by _lock
        self._dispatches = 0  #: guarded_by _lock
        self._reloads = 0  #: guarded_by _lock
        self._shed: dict[str, int] = {}  #: guarded_by _lock
        self._dispatch_ms: list[float] = []  #: guarded_by _lock
        # Per bucket: dispatches, real and capacity node tokens (the
        # ledger when there is no registry).
        self._pack_stats: dict[str, dict[str, int]] = {}  #: guarded_by _lock
        # Per bucket, over the traced requests: queue and device ms.
        self._bucket_stats: dict[str, dict[str, list]] = {}  #: guarded_by _lock
        # The latency histogram is the percentile source of the summary:
        # the registry's own series when there is one, so the summary and
        # every snapshot read the same buckets. It locks internally.
        self._metrics = metrics
        if metrics is not None:
            self._lat_hist = metrics.histogram("serve_request_latency_ms")
            # Registered as JAX registers them; no rollout session records
            # into them yet.
            metrics.histogram("rollout_step_latency_ms")
            self._c_requests = metrics.counter("serve_requests_total")
            self._c_completed = metrics.counter("serve_completed_total")
            self._c_dispatches = metrics.counter("serve_dispatches_total")
            metrics.counter("rollout_steps_total")
            metrics.gauge("serve_queue_depth", fn=lambda: self.admission.depth)
            metrics.gauge("serve_breaker_open",
                          fn=lambda: 1.0 if self.breaker.state == "open" else 0.0)
            metrics.gauge("serve_resident_sessions", fn=lambda: 0)  # no sessions yet
            # Eager PyTorch has no jit fallback: JAX's counter, never moved.
            metrics.counter("serve_jit_fallback_total")
        else:
            self._lat_hist = LogHistogram()
            self._c_requests = self._c_completed = self._c_dispatches = None
        # Registry series caches (get-or-create off the hot path).
        self._pack_counters: dict[str, dict] = {}
        self._bucket_hists: dict[str, LogHistogram] = {}
        self._shed_counters: dict[str, object] = {}

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

    def submit(self, sample: MeshSample, *, deadline_ms: float | None = None) -> Future:
        """Admit one request. Fast-fails (resolved Future) when draining,
        on invalid input (non-finite / oversize, named by index) and when
        ``queue_limit`` requests are already in the system. ``deadline_ms``
        (default ``default_deadline_ms``; 0 = none) is the budget after
        which the request is shed before its forward."""
        fut: Future = Future()
        now = self._clock()
        # Head sampling decides once, at submit; every later span of this
        # request reuses the id.
        trace = self._tracer.start_trace() if self._tracer is not None else None
        with self._lock:
            self._submitted += 1
        if self._c_requests is not None:
            self._c_requests.inc()
        if self._draining.is_set():
            return self._reject(fut, "rejected_draining", now, trace)
        try:
            self.engine.validate([sample])
        except ValueError as err:
            self._event(events.SHED, reason="rejected_invalid", detail=str(err),
                        **({"trace_id": trace} if trace else {}))
            return self._reject(fut, "rejected_invalid", now, trace, str(err))
        if not self.admission.try_admit():
            self._event(events.SHED, reason="shed_queue_full", depth=self.admission.depth,
                        limit=self.admission.limit, **({"trace_id": trace} if trace else {}))
            return self._reject(fut, "shed_queue_full", now, trace)
        # A per-request 0 means no deadline, as the config's does.
        ms = (deadline_ms if deadline_ms is not None else self.default_deadline_ms) or None
        # Enqueue under the same lock drain() sets its flag under: a put
        # serialized before the flag flips is seen by the worker's final
        # sweep, one serialized after it is rejected here.
        with self._lock:
            raced = self._draining.is_set()
            if not raced:
                self._admitted += 1
                self._inbound.put(_Request(
                    sample, fut, self._admitted, now,
                    Deadline(now + ms / 1e3) if ms is not None else None, trace,
                ))
        if raced:
            self.admission.release()
            return self._reject(fut, "rejected_draining", now, trace)
        # Admission closed; queue_wait opens here and is recorded at
        # dispatch, when its end is known.
        self._trace_span(trace, "admission", now, reason="admitted")
        return fut

    def _reject(self, fut: Future, reason: str, now: float, trace, detail: str = "") -> Future:
        """Resolve a request refused at admission."""
        self._count_shed(reason)
        self._trace_span(trace, "admission", now, reason=reason)
        fut.set_result(
            ServeResult(
                ok=False, reason=reason, detail=detail,
                latency_ms=(self._clock() - now) * 1e3,
            )
        )
        return fut

    def reload(self, *, deadline_ms: float = 0.0) -> bool:
        """Swap in the weights of the reload source, on the caller's
        thread, while the worker serves the old ones; publish atomically
        through ``engine.swap_params``. A failed or empty restore leaves
        the old weights serving and returns False. Either way one
        ``reload`` event and one ``reload`` span."""
        if self.reload_fn is None:
            raise RuntimeError("no reload source configured")
        with self._lock:
            self._reloads += 1
            ordinal = self._reloads
        t0 = self._clock()
        if self.faults is not None and hasattr(self.reload_fn, "directory"):
            self.faults.maybe_reload_corrupt(ordinal, self.reload_fn.directory)
        info: dict = {}
        params = None
        try:
            out = self.reload_fn(deadline_ms=deadline_ms or None)
            if out is not None:
                params, info = out
        except Exception as err:  # noqa: BLE001 — serving must outlive reloads
            info = {"error": f"{type(err).__name__}: {err}"}
        ok = params is not None
        if ok:
            self.engine.swap_params(params)
        # Reloads trace on their own "r" stream: they take no request's
        # sampling slot.
        trace = self._tracer.start_trace(stream="r") if self._tracer is not None else None
        self._trace_span(trace, "reload", t0, ok=ok, reload=ordinal)
        self._event(
            events.RELOAD, ok=ok, reload=ordinal, duration_ms=(self._clock() - t0) * 1e3,
            **info, **({"trace_id": trace} if trace else {}),
        )
        return ok

    def drain(self, timeout_s: float = 30.0) -> dict:
        """Graceful shutdown: stop admitting, flush every queued request
        through dispatch (deadline shedding still applies), join the
        worker, write the ``serve_summary`` event and return the summary.
        A worker that outlives ``timeout_s`` (a wedged dispatch) is left
        to finish: ``drain_timeout`` is emitted and what is known is
        returned. Idempotent: only the first drain writes the summary."""
        with self._lock:
            self._draining.set()
        if self._worker is not None:
            self._inbound.put(None)  # wake the worker
            self._worker.join(timeout=timeout_s)
            if self._worker.is_alive():
                # The worker still owns the batcher and the queue:
                # sweeping them from here would race it.
                self._event(events.DRAIN_TIMEOUT, timeout_s=timeout_s)
                return self._summary(emit=not self._drained.is_set())
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
        if not self._drained.is_set():
            self._drained.set()
            return self._summary(emit=True)
        return self._summary(emit=False)

    def summary(self) -> dict:
        """The serving rollup under the names of JAX's ``serve_summary``:
        requests, admitted, completed, sheds by reason, dispatches,
        reloads, breaker trips, ``compiled_shapes`` (distinct dispatch shapes), the latency p50 /
        p99 of completed requests (``LogHistogram`` estimates, within
        ``obs.metrics.REL_ERROR`` of the nearest rank), and per bucket the
        real and capacity node tokens of its dispatches (fill = real /
        capacity, pad waste = 1 - fill); then the serving dtype and the
        dispatch times. With a tracer, the per-bucket queue / device
        split of the traced requests and the trace's coverage."""
        return self._summary(emit=False)

    def _summary(self, *, emit: bool) -> dict:
        with self._lock:
            summary = {
                "requests": self._submitted,
                "admitted": self._admitted,
                "completed": self._completed,
                "shed": dict(self._shed),
                "dispatches": self._dispatches,
                "reloads": self._reloads,
            }
            pack_stats = {k: dict(v) for k, v in self._pack_stats.items()}
            dispatch_ms = list(self._dispatch_ms)
            bucket_stats = {k: {kk: list(vv) for kk, vv in v.items()}
                            for k, v in self._bucket_stats.items()}
        if self._metrics is not None:
            # With a registry its per-bucket counters are the ledger: the
            # summary reads them back, so the two cannot drift.
            pack_stats = {k: {kk: c.value for kk, c in cs.items()}
                          for k, cs in dict(self._pack_counters).items()}
        summary["pad_waste_by_bucket"] = {
            key: {
                **st,
                "fill_frac": st["real_tokens"] / st["capacity_tokens"]
                if st["capacity_tokens"] else None,
                "pad_waste_frac": 1.0 - st["real_tokens"] / st["capacity_tokens"]
                if st["capacity_tokens"] else None,
            }
            for key, st in sorted(pack_stats.items())
        }
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
        summary.update(
            dtype=getattr(self.engine, "dtype", "float32"),
            breaker_trips=self.breaker.trips,
            compiled_shapes=getattr(self.engine, "dispatch_shapes", 0),
            latency_p50_ms=self._lat_hist.percentile(0.50),
            latency_p99_ms=self._lat_hist.percentile(0.99),
            dispatch_ms_p50=_percentile(dispatch_ms, 50),
            dispatch_ms_max=max(dispatch_ms, default=None),
        )
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
            if self.preempt is not None and self.preempt.triggered:
                self._draining.set()
            if self._draining.is_set():
                timeout = 0.0
            else:
                # At most 100 ms, so the preemption flag is polled even
                # when no flush is due.
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
        """One bucket's batch, screened in JAX's order (``slow_request``,
        deadline shed, breaker), then padded to ``max_batch`` rows in one
        engine dispatch, or for the packed bucket cut into plan-shaped
        packed dispatches in arrival order (first-fit prefixes). Resolves
        every request of the batch."""
        if key is PACKED_BUCKET:
            plan, bucket = self.pack_plan, f"packed:{self.pack_plan.n_rows}x{self.pack_plan.row_len}"
        else:
            plan, bucket = None, f"{key[0]}x{key[1]}"
        if self.faults is not None:
            for r in reqs:
                if self.faults.maybe_slow_request(r.ordinal):
                    # An injected straggler: stall until the victim's
                    # deadline has passed.
                    time.sleep(r.deadline.remaining_s(self._clock()) + 1e-3
                               if r.deadline is not None else 0.01)
        now = self._clock()
        live: list[_Request] = []
        for r in reqs:
            if r.deadline is None or not r.deadline.expired(now):
                live.append(r)
                continue
            self._finish(r, ServeResult(ok=False, reason="shed_deadline"))
            if r.trace is not None:
                self._trace_span(r.trace, "queue_wait", r.submitted, now, bucket=bucket,
                                 reason="shed_deadline")
                self._note_bucket(bucket, queue_ms=[(now - r.submitted) * 1e3])
            self._event(events.SHED, reason="shed_deadline", ordinal=r.ordinal,
                        waited_ms=(now - r.submitted) * 1e3,
                        **({"trace_id": r.trace} if r.trace else {}))
        if not live:
            return
        if not self.breaker.allow():
            for r in live:
                self._finish(r, ServeResult(ok=False, reason="rejected_breaker_open",
                                            detail="circuit breaker open (backend unhealthy)"))
                if r.trace is not None:
                    self._trace_span(r.trace, "queue_wait", r.submitted, now, bucket=bucket,
                                     reason="rejected_breaker_open")
                    self._note_bucket(bucket, queue_ms=[(now - r.submitted) * 1e3])
            rejected = [r.trace for r in live if r.trace is not None]
            self._event(events.SHED, reason="rejected_breaker_open", n=len(live),
                        **({"trace_ids": rejected} if rejected else {}))
            return
        if plan is None:
            self._dispatch_one(live, None, key, bucket, now)
            return
        # First-fit prefixes of the live set, recomputed: a deadline shed
        # may have changed it since the batcher's take.
        rest = live
        while rest:
            placements = pack_prefix([r.sample.coords.shape[0] for r in rest], plan)
            n = max(1, len(placements))
            self._dispatch_one(rest[:n], placements[:n], key, bucket, now)
            rest = rest[n:]

    def _dispatch_one(self, live: list[_Request], placements, key, bucket: str,
                      now: float) -> None:
        """ONE engine dispatch of a screened group: packed at
        ``placements`` into the pack plan, or (None) padded at the bucket
        ``key``'s shape; then the pad-waste tally, ``nan_output``, the
        finiteness scan, the breaker's bookkeeping and the resolves, with
        the ``queue_depth`` event and the traced members' spans."""
        plan = self.pack_plan if placements is not None else None
        with self._lock:
            self._dispatches += 1
            dispatch = self._dispatches
        if self._c_dispatches is not None:
            self._c_dispatches.inc()
        if plan is not None:
            capacity, bucket_nodes, bucket_funcs = plan.capacity_tokens, plan.row_len, plan.pad_funcs
        else:
            capacity, (bucket_nodes, bucket_funcs) = self.max_batch * key[0], key
        real = sum(r.sample.coords.shape[0] for r in live)
        member_ids = [r.trace for r in live if r.trace is not None]
        for r in live:
            self._trace_span(r.trace, "queue_wait", r.submitted, now, bucket=bucket,
                             waited_ms=(now - r.submitted) * 1e3,
                             **({"remaining_ms": r.deadline.remaining_ms(now)}
                                if r.deadline is not None else {}))
        self._event(
            events.QUEUE_DEPTH, depth=self.admission.depth, batched=len(self.batcher),
            dispatch=dispatch, bucket_nodes=bucket_nodes, bucket_funcs=bucket_funcs,
            n=len(live), packed=plan is not None, real_tokens=real, capacity_tokens=capacity,
            **({"trace_ids": member_ids} if member_ids else {}),
        )
        # Phase stamps only when a member is traced.
        timings = {} if member_ids else None
        stamps = {"timings": timings, "clock": self._clock} if member_ids else {}
        t0 = self._clock()
        try:
            samples = [r.sample for r in live]
            if plan is not None:
                outs = self.engine.infer_packed(samples, plan, placements=placements, **stamps)
            else:
                outs = self.engine.infer(samples, pad_nodes=key[0], pad_funcs=key[1],
                                         rows=self.max_batch, **stamps)
        except Exception as err:  # noqa: BLE001 — device errors feed the breaker
            traceback.print_exc()
            for r in live:
                if r.trace is None:
                    continue
                self._trace_span(r.trace, "dispatch", now, bucket=bucket, dispatch=dispatch,
                                 error="error_dispatch")
                self._note_bucket(bucket, queue_ms=[(now - r.submitted) * 1e3])
            self._fail_dispatch(live, "error_dispatch", f"{type(err).__name__}: {err}")
            return
        with self._lock:
            self._dispatch_ms.append((self._clock() - t0) * 1e3)
        # The dispatch ran: its pad waste is real whatever its outputs hold.
        self._note_pack(bucket, real, capacity)
        if self.faults is not None and self.faults.maybe_nan_output(dispatch):
            outs = [np.full_like(o, np.nan) for o in outs]
        bad = [i for i, o in enumerate(outs) if not np.all(np.isfinite(o))]
        if bad:
            self._trace_batch_phases(live, timings, now, self._clock(), dispatch, bucket,
                                     member_ids)
            self._fail_dispatch(
                live, "error_nan_output",
                f"non-finite outputs for {len(bad)}/{len(live)} requests in dispatch {dispatch}",
            )
            return
        if self.breaker.record_success():
            self._event(events.BREAKER_CLOSE, state="closed")
        # One stamp, after the scan and the breaker's bookkeeping, ends the
        # dispatch span and starts every resolve, so queue_wait + dispatch
        # is each request's latency.
        done = self._clock()
        self._trace_batch_phases(live, timings, now, done, dispatch, bucket, member_ids)
        for r, o in zip(live, outs):
            self._finish(r, ServeResult(ok=True, reason="ok", output=o), done, bucket)

    def _fail_dispatch(self, reqs: list[_Request], reason: str, detail: str) -> None:
        """A whole-dispatch failure: every rider gets its reason now and
        the breaker counts one failure."""
        now = self._clock()
        for r in reqs:
            self._finish(r, ServeResult(ok=False, reason=reason, detail=detail), now)
        if self.breaker.record_failure():
            first = next((r.trace for r in reqs if r.trace is not None), None)
            self._event(events.BREAKER_OPEN, state="open", reason=reason, detail=detail,
                        trips=self.breaker.trips, **({"trace_id": first} if first else {}))

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
            self._note_bucket(bucket, queue_ms=[(start - r.submitted) * 1e3],
                              device_ms=[(t_dev[1] - t_dev[0]) * 1e3] if t_dev else ())

    # -- bookkeeping -------------------------------------------------------

    def _finish(self, r: _Request, result: ServeResult, now: float | None = None,
                bucket: str | None = None) -> None:
        """Resolve one admitted request at ``now`` (default: the clock):
        release its admission slot, count it, and record its ``resolve``
        span when it reached a forward."""
        now = self._clock() if now is None else now
        result.latency_ms = (now - r.submitted) * 1e3
        self.admission.release()
        if result.ok:
            with self._lock:
                self._completed += 1
            self._note_latency(result.latency_ms, bucket)
        else:
            self._count_shed(result.reason)
        r.future.set_result(result)
        if result.reason not in _ENDS_AT_QUEUE_WAIT:
            self._trace_span(r.trace, "resolve", now, reason=result.reason,
                             **({"latency_ms": result.latency_ms} if result.ok else {}))

    def _note_latency(self, lat_ms: float, bucket: str) -> None:
        """One completed request: the latency histogram, and with a
        registry the completion counter and the bucket's series."""
        self._lat_hist.record(lat_ms)
        if self._metrics is None:
            return
        self._c_completed.inc()
        h = self._bucket_hists.get(bucket)
        if h is None:
            h = self._bucket_hists[bucket] = self._metrics.histogram(
                "serve_bucket_latency_ms", bucket=bucket)
        h.record(lat_ms)

    def _note_pack(self, bucket: str, real_tokens: int, capacity_tokens: int) -> None:
        """One executed dispatch's tokens: into the registry's per-bucket
        counters when there is a registry (the summary reads them back),
        else into the server's own table."""
        if self._metrics is not None:
            cs = self._pack_counters.get(bucket)
            if cs is None:
                cs = self._pack_counters[bucket] = {
                    field: self._metrics.counter(f"serve_bucket_{field}_total", bucket=bucket)
                    for field in ("dispatches", "real_tokens", "capacity_tokens")
                }
            cs["dispatches"].inc()
            cs["real_tokens"].inc(real_tokens)
            cs["capacity_tokens"].inc(capacity_tokens)
            return
        with self._lock:
            st = self._pack_stats.setdefault(
                bucket, {"dispatches": 0, "real_tokens": 0, "capacity_tokens": 0})
            st["dispatches"] += 1
            st["real_tokens"] += real_tokens
            st["capacity_tokens"] += capacity_tokens

    def _note_bucket(self, bucket: str, queue_ms=(), device_ms=()) -> None:
        """Traced requests' contribution to the per-bucket queue / device
        rollup (``queue_device_by_bucket``)."""
        with self._lock:
            st = self._bucket_stats.setdefault(bucket, {"queue_ms": [], "device_ms": []})
            st["queue_ms"].extend(queue_ms)
            st["device_ms"].extend(device_ms)

    def _count_shed(self, reason: str, n: int = 1) -> None:
        with self._lock:
            self._shed[reason] = self._shed.get(reason, 0) + n
        if self._metrics is not None:
            c = self._shed_counters.get(reason)
            if c is None:
                c = self._shed_counters[reason] = self._metrics.counter(
                    "serve_shed_total", reason=reason)
            c.inc(n)

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


class CheckpointReloader:
    """The hot-reload source over a ``train.checkpoint.Checkpointer``:
    restores ``latest`` through the checkpointer's fallback walk (on to
    ``best``, loudly, when ``latest`` does not load), and turns the
    restored state's weights, in the flat, stacked or standard layout the
    run's flags name (``layout``), into the standard weights a served
    model loads, as ``main.restore_for_serving`` does: a layout conflict
    raises its ValueError. The caller's ``deadline_ms`` clamps the
    restore's retry backoff, so a reload against flaky storage never
    stalls past its budget.

    ``model`` is the served model (its state_dict fixes the flat
    layout's order). A call returns ``(state_dict, info)``, ``info``
    being ``last_restore``'s fields plus ``epoch`` and ``best_metric``, or
    None when nothing restores."""

    def __init__(self, checkpointer, model, *, layout: str = "standard"):
        self.checkpointer = checkpointer
        self.layout = layout
        self._template = model.state_dict()
        self._n_layers = model.config.n_attn_layers

    @property
    def directory(self) -> str:
        return self.checkpointer.directory

    def __call__(self, *, deadline_ms: float | None = None):
        deadline = time.monotonic() + deadline_ms / 1e3 if deadline_ms is not None else None
        out = self.checkpointer.restore_latest(deadline=deadline)
        if out is None:
            return None
        state, epoch, best_metric = out
        info = dict(self.checkpointer.last_restore or {})
        weights = serving_weights(state, self._template, self._n_layers, self.layout,
                                  info.get("name", "latest"))
        info.update(epoch=epoch, best_metric=best_metric)
        return weights, info
