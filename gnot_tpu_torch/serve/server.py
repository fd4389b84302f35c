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
summary's ``pad_waste_by_bucket``), the queue-depth, breaker and
resident-session gauges, the rollout series (``rollout_step_latency_ms``,
``rollout_steps_total``, ``rollout_sessions_total{outcome=}``,
``rollout_sessions_lost_total``), the ``tenant_*`` series of tagged
traffic, and the jit-fallback counter, which stays at 0 (eager PyTorch
has no jit fallback). With or without a registry, the summary's latency
percentiles are read from one ``LogHistogram``, as JAX's are.

Tenants (``tenants=`` a ``policies.TenantPolicy``; ``submit(tenant=)``):
a tenant over its quota fast-fails ``shed_tenant_quota`` at its own door,
before the global admission gate, with a ``tenant_quota_shed`` event; the
batcher drains per-tenant sub-queues by weighted fair queueing within
priority tiers; tagged traffic is counted per tenant (the summary's
``tenants`` block). With no policy and no tags none of this runs: the
summary and the events are those of the single-tenant server.

Rollout sessions (``serve/rollout.py``; ``submit_rollout``,
``resume_rollout``): one request becomes K chained dispatches. Each step
re-enters admission, the batcher and the dispatch like any request (so
sessions at different steps batch together, and every policy above
applies to a step), with the per-step deadline clamped to the whole
rollout's. A committed step emits ``rollout_step``, streams to the client
and advances the carry; every ``session_snapshot_every`` steps the carry
is snapshotted host-side (``session_snapshot``). A step failing on a sick
server (``MIGRATABLE_REASONS``) ends the session as lost on a standalone
server, or hands it to ``migrate_cb`` (the router re-places it from its
snapshot); a deadline or quota shed ends it with its reason; a drain
ends it ``drained`` with ``drained_at_step``, after persisting a named
session's final snapshot to the ``session_store``. The rollout fault hooks (``replica_kill``,
``stale_session``, ``rollout_nan``) fire at dispatch; ``replica_kill``
fails every request in the system ``error_replica_dead`` and ends the
worker. A session future, like a request future, always resolves.

A server the router owns (``replica=`` its id, ``serve/router.py``) tags
every event, span and registry series with ``replica`` and prefixes its
session ids ``s{replica}.``; with ``replica=None`` its output is that of a
standalone server. For the router's health check and pool rollup it
exposes ``progress_age_s`` (stamped by the worker loop once a poll and
once a dispatch), ``depth``, ``worker_alive`` (False from the moment the
``replica_kill`` fault fires), ``latency_histogram`` and
``begin_eviction`` (a scale-in hands each resident session to the router
at its next step boundary). With a program catalog (``catalog=``,
``serve/catalog.py``, attached to the engine too when it has none) every
executed dispatch (padded, packed, rollout step) is attributed to its
program where the pad-waste rollup is fed, and a standalone server's
summary carries the ``capacity_model`` (one ``capacity_snapshot`` event).
Rolling persistence (``persist_snapshots``,
the federation's migration substrate) is not ported.
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

from gnot_tpu_torch.config import NotPortedError
from gnot_tpu_torch.data.batch import MeshSample, PackPlan, pack_prefix
from gnot_tpu_torch.obs import events
from gnot_tpu_torch.obs.metrics import LogHistogram, Reservoir
from gnot_tpu_torch.obs.tracing import percentiles
from gnot_tpu_torch.serve.batcher import Batcher
from gnot_tpu_torch.serve.engine import InferenceEngine
from gnot_tpu_torch.serve.policies import (
    DEFAULT_TENANT,
    AdmissionController,
    CircuitBreaker,
    Deadline,
)
from gnot_tpu_torch.serve.rollout import RolloutFuture, RolloutSession
from gnot_tpu_torch.train.trainer import serving_weights

#: The bucket key every plan-fitting request shares in packed dispatch
#: mode (``pack_plan=``); the batcher sizes its dispatches by first-fit
#: prefix packing instead of max_batch.
PACKED_BUCKET = ("packed",)

REASONS = (
    "ok",
    "shed_deadline",
    "shed_queue_full",
    "shed_tenant_quota",
    "rejected_breaker_open",
    "rejected_invalid",
    "rejected_draining",
    "error_nan_output",
    "error_dispatch",
    # rollout-session step failures
    "error_replica_dead",
    "error_stale_session",
)

#: Step failures that indict the server rather than the request: the
#: router re-places such a session from its snapshot (``migrate_cb``); on
#: a standalone server the session ends and counts as lost. Deadline,
#: queue and quota sheds end a session with their own reason.
MIGRATABLE_REASONS = frozenset((
    "rejected_breaker_open",
    "error_nan_output",
    "error_dispatch",
    "error_replica_dead",
    "error_stale_session",
))

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
    # The owning rollout session (None for a one-shot request) and the
    # server's 1-indexed rollout-step ordinal (the rollout faults' key).
    session: RolloutSession | None = None
    rollout_ordinal: int = 0
    # The submitter's tenant (a session's steps inherit its), None untagged.
    tenant: str | None = None


class _ReplicaKilled(Exception):
    """The ``replica_kill`` fault fired at the dispatch about to run: the
    worker fails every request in the system and exits."""


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
    ``clock`` the monotonic clock of every policy, span and latency;
    ``tenants`` a ``TenantPolicy`` (None: tenant mode off);
    ``session_store`` a ``rollout.SessionStore`` for drained sessions;
    ``catalog`` a ``ProgramCatalog`` (one shared by a pool)."""

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
        session_snapshot_every: int = 1,
        session_store=None,
        persist_snapshots: bool = False,
        tenants=None,
        replica: int | None = None,
        catalog=None,
    ):
        if persist_snapshots:
            raise NotPortedError(
                "persist_snapshots (every due snapshot written to the session store, "
                "the federation's migration substrate) waits for the federation")
        if session_snapshot_every < 1:
            raise ValueError(
                f"session_snapshot_every must be >= 1, got {session_snapshot_every}")
        self.engine = engine
        self.max_batch = max_batch
        self.pack_plan = pack_plan
        self.sink = sink
        # The router's replica id: every event, span and series carries it.
        self.replica = replica
        self._tracer = tracer
        self.reload_fn = reload_fn
        self.faults = faults
        self.preempt = preempt
        self._clock = clock
        self.default_deadline_ms = default_deadline_ms
        self.admission = AdmissionController(queue_limit)
        self.breaker = CircuitBreaker(
            threshold=breaker_threshold, cooldown_s=breaker_cooldown_s, clock=clock)
        # Gates per-tenant quotas at submit, before the global gate, and
        # drives the batcher's per-tenant WFQ sub-queues. None: off.
        self.tenants = tenants

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
            tenants=tenants,
            # Untagged traffic under a policy rides the default tenant.
            tenant_fn=lambda r: r.tenant if r.tenant is not None else DEFAULT_TENANT,
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
        lbl = {"replica": replica} if replica is not None else {}
        self._metric_labels = lbl
        if metrics is not None:
            self._lat_hist = metrics.histogram("serve_request_latency_ms", **lbl)
            self._step_hist = metrics.histogram("rollout_step_latency_ms", **lbl)
            self._c_requests = metrics.counter("serve_requests_total", **lbl)
            self._c_completed = metrics.counter("serve_completed_total", **lbl)
            self._c_dispatches = metrics.counter("serve_dispatches_total", **lbl)
            self._c_steps = metrics.counter("rollout_steps_total", **lbl)
            metrics.gauge("serve_queue_depth", fn=lambda: self.admission.depth, **lbl)
            metrics.gauge("serve_breaker_open",
                          fn=lambda: 1.0 if self.breaker.state == "open" else 0.0, **lbl)
            metrics.gauge("serve_resident_sessions", fn=self.resident_sessions, **lbl)
            # Eager PyTorch has no jit fallback: JAX's counter, never moved.
            metrics.counter("serve_jit_fallback_total", **lbl)
        else:
            self._lat_hist = LogHistogram()
            self._step_hist = LogHistogram()
            self._c_requests = self._c_completed = self._c_dispatches = self._c_steps = None
        self._step_res = Reservoir()
        # Program catalog: every executed dispatch is attributed to its
        # program; one catalog= arms the engine's cost capture too when
        # nothing else did (the router passes it per replica).
        self._catalog = catalog
        if catalog is not None and getattr(engine, "catalog", None) is None:
            engine.attach_catalog(catalog)
        # Registry series caches (get-or-create off the hot path).
        self._pack_counters: dict[str, dict] = {}
        self._bucket_hists: dict[str, LogHistogram] = {}
        self._shed_counters: dict[str, object] = {}
        # Per-tenant accounting, of tagged requests only: the summary's
        # ``tenants`` block and, with a registry, the tenant_* series the
        # tenant SLOs read. The histograms and counters lock inside.
        self._tenant_stats: dict[str, dict] = {}  #: guarded_by _lock
        self._tenant_hists: dict[str, LogHistogram] = {}
        self._tenant_counters: dict = {}
        # Rollout sessions: the resident table, the summary's counters and
        # the rollout-step admission ordinal (the rollout faults' key).
        self.session_snapshot_every = session_snapshot_every
        self._session_store = session_store
        self._sessions: dict[str, RolloutSession] = {}  #: guarded_by _lock
        self._sessions_started = 0  #: guarded_by _lock
        self._sessions_completed = 0  #: guarded_by _lock
        self._sessions_drained = 0  #: guarded_by _lock
        self._sessions_shed = 0  #: guarded_by _lock
        self._sessions_failed = 0  #: guarded_by _lock
        self._rollout_steps = 0  #: guarded_by _lock
        # The worker's liveness stamp (the router's wedge signal): set once
        # a loop iteration and once a dispatch, so it ages only while the
        # worker is stuck inside one dispatch.
        self._last_progress = clock()  #: guarded_by _lock
        # Set by _die the moment replica_kill fires: the router reads the
        # server dead at once (migration callbacks run on the dying thread).
        self._dead = False  #: guarded_by _lock
        # Scale-in (the router's remove_replica): when set, a committed step
        # hands its unfinished session to this callback instead of chaining.
        self._evict_cb = None  #: guarded_by _lock

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

    def submit(self, sample: MeshSample, *, deadline_ms: float | None = None,
               tenant: str | None = None) -> Future:
        """Admit one request. Fast-fails (resolved Future) when draining,
        on invalid input (non-finite / oversize, named by index), when the
        tenant is at its quota (``shed_tenant_quota``, checked before the
        global gate, so a flooding tenant fails at its own door without
        taking shared admission) and when ``queue_limit`` requests are
        already in the system. ``deadline_ms`` (default
        ``default_deadline_ms``; 0 = none) is the budget after which the
        request is shed before its forward. ``tenant`` names the submitter
        (None: untagged; without a policy the tag only counts)."""
        fut: Future = Future()
        now = self._clock()
        # Head sampling decides once, at submit; every later span of this
        # request reuses the id.
        trace = self._tracer.start_trace() if self._tracer is not None else None
        with self._lock:
            self._submitted += 1
        if self._c_requests is not None:
            self._c_requests.inc()
        self._note_tenant_request(tenant)
        if self._draining.is_set():
            return self._reject(fut, "rejected_draining", now, trace, tenant=tenant)
        try:
            self.engine.validate([sample])
        except ValueError as err:
            self._event(events.SHED, reason="rejected_invalid", detail=str(err),
                        **({"trace_id": trace} if trace else {}))
            return self._reject(fut, "rejected_invalid", now, trace, str(err), tenant=tenant)
        if self.tenants is not None:
            tname = tenant if tenant is not None else DEFAULT_TENANT
            if not self.tenants.try_admit(tname):
                self._event(events.TENANT_QUOTA_SHED, tenant=tname,
                            quota=self.tenants.quota(tname),
                            in_system=self.tenants.in_system(tname),
                            **({"trace_id": trace} if trace else {}))
                return self._reject(fut, "shed_tenant_quota", now, trace, tenant=tname)
        if not self.admission.try_admit():
            self._release_tenant(tenant)
            self._event(events.SHED, reason="shed_queue_full", depth=self.admission.depth,
                        limit=self.admission.limit,
                        **({"tenant": tenant} if tenant is not None else {}),
                        **({"trace_id": trace} if trace else {}))
            return self._reject(fut, "shed_queue_full", now, trace, tenant=tenant)
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
                    tenant=tenant,
                ))
        if raced:
            self.admission.release()
            self._release_tenant(tenant)
            return self._reject(fut, "rejected_draining", now, trace, tenant=tenant)
        # Admission closed; queue_wait opens here and is recorded at
        # dispatch, when its end is known.
        self._trace_span(trace, "admission", now, reason="admitted")
        return fut

    def _reject(self, fut: Future, reason: str, now: float, trace, detail: str = "",
                *, tenant: str | None = None) -> Future:
        """Resolve a request refused at admission."""
        self._count_shed(reason)
        self._note_tenant_shed(tenant, reason)
        self._trace_span(trace, "admission", now, reason=reason)
        fut.set_result(
            ServeResult(
                ok=False, reason=reason, detail=detail,
                latency_ms=(self._clock() - now) * 1e3,
            )
        )
        return fut

    def submit_rollout(
        self,
        sample: MeshSample | None = None,
        steps: int | None = None,
        *,
        deadline_ms: float | None = None,
        rollout_deadline_ms: float | None = None,
        on_step: Callable | None = None,
        session: RolloutSession | None = None,
        name: str | None = None,
        tenant: str | None = None,
    ) -> RolloutFuture:
        """Admit one rollout: ``steps`` chained dispatches whose carry
        stays with this server between steps. Each step re-enters the
        ordinary admission, batcher and dispatch. ``deadline_ms`` is the
        per-step budget (default ``default_deadline_ms``),
        ``rollout_deadline_ms`` the whole trajectory's; ``on_step(sid,
        step, output)`` streams committed steps (``iter_steps()`` of the
        returned future is the pull-style twin). ``session`` places an
        existing session (a resume) and ignores the other arguments;
        ``name`` is a client-chosen id, the handle ``resume_rollout``
        resumes a drained session under. The future always resolves with a
        ``RolloutResult``."""
        if session is None:
            if sample is None or steps is None:
                raise ValueError("submit_rollout needs (sample, steps) or a session")
            if name is not None and self.has_session(name):
                # Two live sessions under one sid would shadow each other.
                raise ValueError(f"a session named {name!r} is already resident")
            with self._lock:
                self._sessions_started += 1
                n = self._sessions_started
            self._note_session("started")
            prefix = "s" if self.replica is None else f"s{self.replica}."
            ms = deadline_ms if deadline_ms is not None else self.default_deadline_ms
            session = RolloutSession(
                name or f"{prefix}{n:04d}",
                sample,
                steps,
                snapshot_every=self.session_snapshot_every,
                step_deadline_ms=ms or None,
                rollout_deadline=(self._clock() + rollout_deadline_ms / 1e3
                                  if rollout_deadline_ms else None),
                on_step=on_step,
                tenant=tenant,
            )
            session.named = name is not None
        else:
            with self._lock:
                self._sessions_started += 1
            self._note_session("started")
        with self._lock:
            self._sessions[session.sid] = session
        self._submit_step(session)
        return session.future

    def resume_rollout(
        self,
        name: str,
        *,
        deadline_ms: float | None = None,
        rollout_deadline_ms: float | None = None,
        on_step: Callable | None = None,
    ) -> RolloutFuture:
        """Resume a session a drain persisted to the session store: load
        its final snapshot, rebuild the session at that step and run the
        remaining steps here. Raises ``KeyError`` when there is no
        snapshot; a session already complete at its snapshot resolves at
        once. The restored prefix is not streamed again."""
        if self._session_store is None:
            raise RuntimeError("no session store configured")
        if self.has_session(name):
            raise ValueError(f"a session named {name!r} is already resident")
        state = self._session_store.load(name)
        if state is None:
            raise KeyError(f"no persisted session {name!r}")
        ms = deadline_ms if deadline_ms is not None else self.default_deadline_ms
        session = RolloutSession.from_state(
            state,
            snapshot_every=self.session_snapshot_every,
            step_deadline_ms=ms or None,
            rollout_deadline=(self._clock() + rollout_deadline_ms / 1e3
                              if rollout_deadline_ms else None),
            on_step=on_step,
        )
        if session.finished:
            session.resolve(True, "ok")
            return session.future
        return self.submit_rollout(session=session)

    # -- rollout-session internals -------------------------------------------

    def _submit_step(self, session: RolloutSession) -> None:
        """Enqueue the session's next step as a request. A drain, a spent
        rollout budget, an invalid carry, the tenant's quota or a full
        queue ends the session now instead: a session never strands
        between steps."""
        now = self._clock()
        if self._draining.is_set():
            self._end_session(session, reason="drained", kind="drained")
            return
        rd = session.rollout_deadline
        if rd is not None and now >= rd:
            self._end_session(session, reason="shed_deadline", kind="shed",
                              detail="whole-rollout deadline exhausted")
            return
        try:
            self.engine.validate([session.sample])
        except ValueError as err:
            self._end_session(session, reason="rejected_invalid", kind="shed", detail=str(err))
            return
        if self.tenants is not None:
            # Each step holds one of its tenant's in-system slots; a quota
            # shed ends the session (it is the tenant's own doing).
            tname = session.tenant if session.tenant is not None else DEFAULT_TENANT
            if not self.tenants.try_admit(tname):
                self._count_shed("shed_tenant_quota")
                self._note_tenant_shed(tname, "shed_tenant_quota")
                self._event(events.TENANT_QUOTA_SHED, tenant=tname,
                            quota=self.tenants.quota(tname),
                            in_system=self.tenants.in_system(tname), session=session.sid)
                self._end_session(session, reason="shed_tenant_quota", kind="shed",
                                  detail=f"tenant quota exhausted at step {session.cursor + 1}")
                return
        if not self.admission.try_admit():
            self._release_tenant(session.tenant)
            self._end_session(session, reason="shed_queue_full", kind="shed",
                              detail=f"admission full at step {session.cursor + 1}")
            return
        ms = session.step_deadline_ms
        at = now + ms / 1e3 if ms is not None else None
        if rd is not None:
            at = rd if at is None else min(at, rd)
        with self._lock:
            raced = self._draining.is_set()
            if not raced:
                self._submitted += 1
                self._admitted += 1
                self._rollout_steps += 1
                # Locally placed sessions' steps run untraced, as in JAX.
                self._inbound.put(_Request(
                    session.sample, Future(), self._admitted, now,
                    Deadline(at) if at is not None else None, None,
                    session=session, rollout_ordinal=self._rollout_steps,
                    tenant=session.tenant,
                ))
        if raced:
            self.admission.release()
            self._release_tenant(session.tenant)
            self._end_session(session, reason="drained", kind="drained")
            return
        if self._c_requests is not None:
            self._c_requests.inc()
        if self._c_steps is not None:
            self._c_steps.inc()
        self._note_tenant_request(session.tenant)

    def _session_step_done(self, req: _Request, result: ServeResult) -> None:
        """One session step left the system: commit it and chain the next,
        or end the session by the failure's reason. Runs on the thread
        that finished the step (the worker's or the drain's)."""
        session = req.session
        if result.ok:
            step = session.record_step(result.output)
            self._step_hist.record(result.latency_ms)
            self._step_res.add(result.latency_ms)
            self._event(events.ROLLOUT_STEP, session=session.sid, step=step,
                        steps=session.steps, latency_ms=result.latency_ms)
            session.publish_step(step, result.output)
            if session.snapshot_due():
                self._event(events.SESSION_SNAPSHOT, session=session.sid,
                            step=session.take_snapshot())
            if session.finished:
                if session.resolve(True, "ok"):
                    with self._lock:
                        self._sessions_completed += 1
                    self._note_session("completed")
                self._drop_session(session)
                # A completed named session's persisted snapshot is stale.
                if self._session_store is not None and session.named:
                    self._session_store.delete(session.sid)
                return
            with self._lock:
                evict = self._evict_cb
            if evict is not None:
                # Scale-in: hand the session over at this step boundary,
                # snapshotted first so the sibling replays nothing; kept
                # here (and resolved by the drain) when nobody can take it.
                self._event(events.SESSION_SNAPSHOT, session=session.sid,
                            step=session.take_snapshot())
                self._drop_session(session)
                if evict(session, self.replica):
                    return
                with self._lock:
                    self._sessions[session.sid] = session
            self._submit_step(session)
            return
        reason = result.reason
        if reason == "rejected_draining":
            self._end_session(session, reason="drained", kind="drained")
        elif reason in MIGRATABLE_REASONS:
            # A sick server, not a sick request: the router's hand-over,
            # or on a standalone server a terminal failure, still resolved.
            self._drop_session(session)
            if session.migrate_cb is not None:
                session.migrate_cb(session, reason, result.detail, self.replica)
            else:
                if session.resolve(False, reason, detail=result.detail):
                    with self._lock:
                        self._sessions_failed += 1
                    self._note_session("failed", lost=True)
                self._event(events.SHED, reason=reason, session=session.sid,
                            step=session.cursor)
        else:
            self._end_session(session, reason=reason, kind="shed", detail=result.detail)

    def _end_session(self, session: RolloutSession, *, reason: str, kind: str,
                     detail: str = "") -> None:
        """End a session early on this server: take a final snapshot,
        persist a drained named session's to the store before the future
        resolves (once the client sees ``drained``, ``resume_rollout`` can
        continue from it; a failed write does not block the drain),
        resolve (idempotent; ``drained`` carries ``drained_at_step``),
        drop it, and emit ``session_snapshot`` and ``shed``."""
        step = session.take_snapshot()
        drained = kind == "drained"
        persisted = False
        if drained and session.named and self._session_store is not None:
            try:
                self._session_store.save(session)
                persisted = True
            except OSError:
                pass
        resolved = session.resolve(False, reason, drained_at_step=step if drained else None,
                                   detail=detail)
        self._drop_session(session)
        if not resolved:
            return
        with self._lock:
            if drained:
                self._sessions_drained += 1
            else:
                self._sessions_shed += 1
        self._note_session("drained" if drained else "shed")
        self._event(events.SESSION_SNAPSHOT, session=session.sid, step=step,
                    **({"persisted": True} if persisted else {}))
        self._event(events.SHED, reason=reason, session=session.sid, step=step)

    def begin_eviction(self, evict_cb: Callable) -> None:
        """Arm scale-in eviction (the router's ``remove_replica``): from the
        next committed step on, each unfinished resident session goes to
        ``evict_cb(session, replica) -> bool`` at its step boundary, its
        snapshot taken at the cursor (no replay). False keeps the session
        here, for the removal's drain to resolve."""
        with self._lock:
            self._evict_cb = evict_cb

    def _drop_session(self, session: RolloutSession) -> None:
        with self._lock:
            self._sessions.pop(session.sid, None)

    def _open_sessions(self) -> list[RolloutSession]:
        with self._lock:
            return list(self._sessions.values())

    def _die(self, pending: list[_Request]) -> None:
        """The ``replica_kill`` fault fired: every request still in the
        system (the popped batches, the inbound queue, the batcher)
        resolves ``error_replica_dead`` now, their sessions with it, and
        the worker then exits."""
        with self._lock:
            self._dead = True

        def dead() -> ServeResult:
            return ServeResult(ok=False, reason="error_replica_dead",
                               detail="replica killed (injected replica_kill)")

        for r in pending:
            self._finish(r, dead())
        try:
            while True:
                item = self._inbound.get_nowait()
                if item is not None:
                    self._finish(item, dead())
        except queue.Empty:
            pass
        # pop_ready(flush_all) removes what it returns, so a later drain
        # cannot finish these twice.
        for _, rs in self.batcher.pop_ready(self._clock(), flush_all=True):
            for r in rs:
                self._finish(r, dead())

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
                # Open sessions still resolve (the wedged worker may never
                # chain them); if it comes back, its own ending is a no-op.
                for session in self._open_sessions():
                    self._end_session(session, reason="drained", kind="drained",
                                      detail="drain timed out behind a wedged dispatch")
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
        # Sessions still resident (their step was swept above, or they
        # raced the drain flag) end drained, their snapshots persisted.
        for session in self._open_sessions():
            self._end_session(session, reason="drained", kind="drained")
        if not self._drained.is_set():
            self._drained.set()
            return self._summary(emit=True)
        return self._summary(emit=False)

    def summary(self) -> dict:
        """The serving rollup with the keys of JAX's ``serve_summary``:
        requests, admitted, completed, sheds by reason, dispatches,
        reloads, breaker trips, ``compiled_shapes`` (distinct dispatch
        shapes), ``jit_fallbacks`` (always 0: no dispatch runs a fallback
        program), the latency p50 / p99 of completed requests
        (``LogHistogram`` estimates, within ``obs.metrics.REL_ERROR`` of the
        nearest rank), the serving dtype and, once a dispatch ran, per
        bucket the real and capacity node tokens of its dispatches (fill =
        real / capacity, pad waste = 1 - fill). With a tracer, the
        per-bucket queue / device split of the traced requests and the
        trace's coverage; with tenants or sessions, their blocks. Two keys
        are the port's own, ``dispatch_ms_p50`` and ``dispatch_ms_max`` (the
        host time of the dispatches): JAX's event spec allows extra keys."""
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
            tenant_stats = {t: {"requests": v["requests"], "completed": v["completed"],
                                "shed": dict(v["shed"])}
                            for t, v in self._tenant_stats.items()}
            if self._sessions_started:
                # The sessions accepted here, how each ended, and the step
                # latency percentiles.
                summary["sessions"] = {
                    "started": self._sessions_started,
                    "completed": self._sessions_completed,
                    "drained": self._sessions_drained,
                    "shed": self._sessions_shed,
                    "failed": self._sessions_failed,
                    "resident": len(self._sessions),
                    "steps": self._step_hist.count,
                    "step_latency_p50_ms": self._step_hist.percentile(0.50),
                    "step_latency_p99_ms": self._step_hist.percentile(0.99),
                }
        if self._metrics is not None:
            # With a registry its per-bucket counters are the ledger: the
            # summary reads them back, so the two cannot drift.
            pack_stats = {k: {kk: c.value for kk, c in cs.items()}
                          for k, cs in dict(self._pack_counters).items()}
        if tenant_stats:
            # How each tenant's tagged traffic fared; absent when no
            # request carried a tag.
            summary["tenants"] = {
                t: {
                    **st,
                    "latency_p50_ms": (self._tenant_hists[t].percentile(0.50)
                                       if t in self._tenant_hists else None),
                    "latency_p99_ms": (self._tenant_hists[t].percentile(0.99)
                                       if t in self._tenant_hists else None),
                }
                for t, st in sorted(tenant_stats.items())
            }
        # No fallback program ever runs (eager PyTorch has no jit cache):
        # JAX's key, always 0.
        summary["jit_fallbacks"] = 0
        if pack_stats:
            # Present once a dispatch ran, as in JAX.
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
        if self._catalog is not None and self.replica is None:
            # A standalone server (the router's drain builds the pool's):
            # the catalog's costs joined with this server's traffic, the
            # capacity_snapshot event once.
            model = self._catalog.emit_snapshot() if emit else None
            summary["capacity_model"] = (
                model if model is not None else self._catalog.capacity_model())
        if emit:
            self._event(events.SERVE_SUMMARY, **summary)
            if self.sink is not None:
                self.sink.flush()
        return summary

    # -- worker side -------------------------------------------------------

    def _run(self, warmup: list[MeshSample], ready: Future) -> None:
        """The worker loop. A router replica's engine enters the replica's
        own CUDA stream around each of its calls (``InferenceEngine(stream=)``),
        so the warm-up and every dispatch made from this thread run on it."""
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
            now = self._clock()
            # The liveness stamp, once a poll and once a dispatch: a worker
            # draining a backlog makes progress; one stuck inside a dispatch
            # stops stamping (the router's wedge signal).
            with self._lock:
                self._last_progress = now
            batches = self.batcher.pop_ready(now, flush_all=draining)
            for i, (key, reqs) in enumerate(batches):
                with self._lock:
                    self._last_progress = self._clock()
                try:
                    self._dispatch(key, reqs)
                except _ReplicaKilled:
                    # It fires before any request of the batch resolves:
                    # this batch and every later one popped are whole.
                    self._die([r for _, rs in batches[i:] for r in rs])
                    return
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
            # The rollout faults, keyed by the rollout-step ordinal:
            # replica_kill first (a dying server fails everything, before
            # any request resolves), then stale carries, whose victims
            # leave the batch.
            for r in reqs:
                if r.session is not None and self.faults.maybe_replica_kill(r.rollout_ordinal):
                    raise _ReplicaKilled()
            fresh = []
            for r in reqs:
                if r.session is not None and self.faults.maybe_stale_session(r.rollout_ordinal):
                    self._event(events.SHED, reason="error_stale_session", ordinal=r.ordinal,
                                session=r.session.sid)
                    # JAX counts no tenant shed here.
                    self._finish(r, ServeResult(
                        ok=False, reason="error_stale_session",
                        detail="resident carry lost (injected stale_session)"),
                        tenant_shed=False)
                else:
                    fresh.append(r)
            reqs = fresh
            if not reqs:
                return
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
                        **({"tenant": r.tenant} if r.tenant is not None else {}),
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
                                if r.deadline is not None else {}),
                             **({"tenant": r.tenant} if r.tenant is not None else {}))
        self._event(
            events.QUEUE_DEPTH, depth=self.admission.depth, batched=len(self.batcher),
            dispatch=dispatch, bucket_nodes=bucket_nodes, bucket_funcs=bucket_funcs,
            n=len(live), packed=plan is not None, real_tokens=real, capacity_tokens=capacity,
            **({"trace_ids": member_ids} if member_ids else {}),
        )
        # Phase stamps when a member is traced or the catalog attributes
        # the dispatch (its device time and program key).
        timings = {} if member_ids or self._catalog is not None else None
        stamps = {"timings": timings, "clock": self._clock} if timings is not None else {}
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
        # The dispatch ran: its pad waste is real whatever its outputs hold,
        # and the catalog attributes it to its program.
        self._note_pack(bucket, real, capacity)
        if self._catalog is not None:
            dev = timings.get("device")
            self._catalog.note_dispatch(
                timings.get("program") or bucket, requests=len(live), real_tokens=real,
                capacity_tokens=capacity, device_s=(dev[1] - dev[0]) if dev else None,
                replica=self.replica)
        if self.faults is not None and self.faults.maybe_nan_output(dispatch):
            outs = [np.full_like(o, np.nan) for o in outs]
        if self.faults is not None and [
                r for r in live
                if r.session is not None and self.faults.maybe_rollout_nan(r.rollout_ordinal)]:
            # rollout_nan poisons the whole dispatch (a sick chip does not
            # keep its garbage to one row): every rider fails.
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
            ten = {"tenant": r.tenant} if r.tenant is not None else {}
            self._trace_span(r.trace, "dispatch", start, done, **link, **ten)
            for phase in ("batch_assembly", "device", "unpad"):
                if phase in timings:
                    self._trace_span(r.trace, phase, *timings[phase], **link, **ten)
            self._note_bucket(bucket, queue_ms=[(start - r.submitted) * 1e3],
                              device_ms=[(t_dev[1] - t_dev[0]) * 1e3] if t_dev else ())

    # -- bookkeeping -------------------------------------------------------

    def _finish(self, r: _Request, result: ServeResult, now: float | None = None,
                bucket: str | None = None, *, tenant_shed: bool = True) -> None:
        """Resolve one admitted request at ``now`` (default: the clock):
        release its admission and tenant slots, count it (for its tenant
        too, unless ``tenant_shed`` is False), record its ``resolve`` span
        when it reached a forward, and for a session step chain the
        session on (commit and the next step, or its end)."""
        now = self._clock() if now is None else now
        result.latency_ms = (now - r.submitted) * 1e3
        self.admission.release()
        self._release_tenant(r.tenant)
        if result.ok:
            with self._lock:
                self._completed += 1
            self._note_latency(result.latency_ms, bucket)
            self._note_tenant_done(r.tenant, result.latency_ms)
        else:
            self._count_shed(result.reason)
            if tenant_shed:
                self._note_tenant_shed(r.tenant, result.reason)
        r.future.set_result(result)
        if result.reason not in _ENDS_AT_QUEUE_WAIT:
            self._trace_span(r.trace, "resolve", now, reason=result.reason,
                             **({"latency_ms": result.latency_ms} if result.ok else {}),
                             **({"tenant": r.tenant} if r.tenant is not None else {}))
        if r.session is not None:
            self._session_step_done(r, result)

    # -- per-tenant accounting: each helper is a no-op for untagged
    # (tenant=None) traffic, so the single-tenant path records nothing. ------

    def _release_tenant(self, tenant: str | None) -> None:
        """The quota twin of ``admission.release()`` (an untagged request
        under a policy rides the default tenant)."""
        if self.tenants is not None:
            self.tenants.release(tenant if tenant is not None else DEFAULT_TENANT)

    def _tenant_stat(self, tenant: str) -> dict:
        """The tenant's summary record; the caller holds ``_lock``."""
        st = self._tenant_stats.get(tenant)
        if st is None:
            st = self._tenant_stats[tenant] = {"requests": 0, "completed": 0, "shed": {}}
        return st

    def _tenant_counter(self, name: str, tenant: str, **labels):
        key = (name, tenant, tuple(sorted(labels.items())))
        c = self._tenant_counters.get(key)
        if c is None:
            c = self._tenant_counters[key] = self._metrics.counter(
                name, tenant=tenant, **labels, **self._metric_labels)
        return c

    def _note_tenant_request(self, tenant: str | None) -> None:
        if tenant is None:
            return
        with self._lock:
            self._tenant_stat(tenant)["requests"] += 1
        if self._metrics is not None:
            self._tenant_counter("tenant_requests_total", tenant).inc()

    def _note_tenant_shed(self, tenant: str | None, reason: str, n: int = 1) -> None:
        if tenant is None:
            return
        with self._lock:
            shed = self._tenant_stat(tenant)["shed"]
            shed[reason] = shed.get(reason, 0) + n
        if self._metrics is not None:
            self._tenant_counter("tenant_shed_total", tenant, reason=reason).inc(n)

    def _note_tenant_done(self, tenant: str | None, lat_ms: float) -> None:
        if tenant is None:
            return
        with self._lock:
            self._tenant_stat(tenant)["completed"] += 1
        h = self._tenant_hists.get(tenant)
        if h is None:
            h = self._tenant_hists[tenant] = (
                self._metrics.histogram("tenant_latency_ms", tenant=tenant,
                                        **self._metric_labels)
                if self._metrics is not None else LogHistogram())
        h.record(lat_ms)
        if self._metrics is not None:
            self._tenant_counter("tenant_completed_total", tenant).inc()

    def _note_session(self, outcome: str, lost: bool = False) -> None:
        """One session outcome into the registry (``started``,
        ``completed``, ``drained``, ``shed``, ``failed``); ``lost`` also
        counts a session that failed on a server signal with nobody to
        migrate it (the session-loss SLO's counter)."""
        if self._metrics is None:
            return
        self._metrics.counter("rollout_sessions_total", outcome=outcome,
                              **self._metric_labels).inc()
        if lost:
            self._metrics.counter("rollout_sessions_lost_total", **self._metric_labels).inc()

    # -- probes ----------------------------------------------------------------

    def tenant_rollup(self) -> dict:
        """Per-tenant counts and latency-histogram copies (empty dicts
        when no request carried a tag): the router's merge input."""
        with self._lock:
            counts = {t: {"requests": v["requests"], "completed": v["completed"],
                          "shed": dict(v["shed"])}
                      for t, v in self._tenant_stats.items()}
        hists = {t: h.copy() for t, h in dict(self._tenant_hists).items()}
        return {"counts": counts, "hists": hists}

    def progress_age_s(self, now: float | None = None) -> float:
        """Seconds since the worker loop last stamped its progress: large
        while ``depth() > 0`` means the worker is stuck inside a dispatch
        (the router's wedge signal)."""
        now = self._clock() if now is None else now
        with self._lock:
            return max(0.0, now - self._last_progress)

    def depth(self) -> int:
        """Requests in the system (queued, batched or in a dispatch): the
        router's load signal."""
        return self.admission.depth

    def latency_histogram(self) -> LogHistogram:
        """A copy of the request-latency histogram (the router's lossless
        pool merge input)."""
        return self._lat_hist.copy()

    def worker_alive(self) -> bool:
        """False once a started worker has exited or ``replica_kill`` has
        fired on it; True before its thread starts (the router assesses
        replicas it is still warming, and ``start`` creates the thread
        before it runs)."""
        with self._lock:
            if self._dead:
                return False
        w = self._worker
        return w is None or w.ident is None or w.is_alive()

    def resident_sessions(self) -> int:
        """Rollout sessions resident on this server now."""
        with self._lock:
            return len(self._sessions)

    def has_session(self, sid: str) -> bool:
        """Is a session with this id resident here?"""
        with self._lock:
            return sid in self._sessions

    def step_latencies_ms(self) -> list[float]:
        """A bounded sample of committed rollout-step latencies (ms)."""
        return self._step_res.values()

    def step_latency_histogram(self) -> LogHistogram:
        """A copy of the rollout-step latency histogram."""
        return self._step_hist.copy()

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
                "serve_bucket_latency_ms", bucket=bucket, **self._metric_labels)
        h.record(lat_ms)

    def _note_pack(self, bucket: str, real_tokens: int, capacity_tokens: int) -> None:
        """One executed dispatch's tokens: into the registry's per-bucket
        counters when there is a registry (the summary reads them back),
        else into the server's own table."""
        if self._metrics is not None:
            cs = self._pack_counters.get(bucket)
            if cs is None:
                cs = self._pack_counters[bucket] = {
                    field: self._metrics.counter(f"serve_bucket_{field}_total", bucket=bucket,
                                                 **self._metric_labels)
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
                    "serve_shed_total", reason=reason, **self._metric_labels)
            c.inc(n)

    def _trace_span(self, trace, name: str, start: float, end: float | None = None, **args):
        """One request span on the server's clock (``end`` defaults to
        now); a no-op when tracing is off or the request was not sampled."""
        if self._tracer is None or trace is None:
            return None
        if self.replica is not None:
            args = {"replica": self.replica, **args}
        return self._tracer.add_span(name, start, end if end is not None else self._clock(),
                                     trace=trace, args=args or None)

    def _event(self, event: str, **fields) -> None:
        if self.sink is not None:
            if self.replica is not None:
                fields.setdefault("replica", self.replica)
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
