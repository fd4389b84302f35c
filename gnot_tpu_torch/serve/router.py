"""The request router over N engine replicas.

Port of ``gnot_tpu/serve/router.py``. A single ``InferenceServer``
serializes every dispatch through one worker loop; the ``ReplicaRouter``
front-ends N replicas (``serve/replica.py``: on one card, each with its own
engine, weights copy, worker and CUDA stream) and places each request:

1. **Health first** (``policies.ReplicaHealthPolicy``): a replica with an
   open breaker, a wedged worker (requests in its system, its loop
   silent), a warming reload, a dead worker or a scale-in under way is
   drained: new traffic goes to its siblings instead of being shed.
   Changes emit ``replica_health`` events. When no replica is healthy the
   router still places (least loaded), so the replica's own policies answer
   with their reasons: the router never invents a failure mode.
2. **Bucket affinity** (the default policy): prefer a replica that has
   served the request's bucket (or the pack plan). A bucket seen for the
   first time is assigned to the least-loaded healthy replica before the
   request lands (``cold_assign``); a full affinity target spills to the
   least-loaded sibling (``spill``); with every candidate full the
   least-loaded replica's admission sheds (``pool_full``).
   ``least_loaded`` and ``round_robin`` are the yardsticks
   (``--route_policy``). Load counts in-system requests plus resident
   rollout sessions.
3. **Rolling hot reload** (``reload()``): one replica at a time is marked
   warming (drained for new traffic, its old weights serving what it
   holds) and reloads on the caller's thread; a replica whose restore
   fails keeps its old weights and the rollout goes on. A
   ``rolling_reload`` event per step.
4. **Rollout sessions** (``submit_rollout``): a session is placed once (one
   ``route`` event tagged with its id) and stays on its owner. When the
   owner fails mid-rollout (breaker, NaN, dispatch error, ``replica_kill``,
   a stale carry) the session is re-placed on a sibling from its last
   snapshot and replays forward (``session_migrate``); with migration off
   or its budget spent the future resolves with the failure, counted lost.
5. **Elastic membership** (``add_replica`` / ``remove_replica``): a warmed
   replica joins routing at the next placement (``replica_warm``); a
   removal drains first: the replica goes ``retiring``, hands its resident
   sessions to siblings at a step boundary (``session_migrate`` with reason
   ``scale_in``, no replay), flushes its queue and retires, its history
   kept in the pool rollup (``replica_remove``).

``drain()`` emits one pool ``serve_summary`` with the ``per_replica``
rollup and the ``routing`` block, beside the per-replica summaries each
replica's server writes (tagged ``replica``). With a registry the router
adds ``router_routes_total{reason=}``, ``router_migrations_total``, the
``pool_replicas`` gauge and a ``serve_wedged{replica=}`` level per replica
(the metrics plane's ``wedged`` objective).

One ``catalog=`` (``serve/catalog.py``) is shared by every replica's
server, scale-outs included: each attributes its dispatches to the one
catalog, and ``drain()`` puts the pool's ``capacity_model`` in the summary
(one ``capacity_snapshot`` event). ``pool()`` and ``assess(replica)`` are
the probes the autoscaler reads (``serve/autoscaler.py``).

Under the federation (``serve/federation.py``) a router is one host's
pool: ``persist_snapshots`` passes to every replica's server (each due
snapshot of a named session goes to the shared store, the cross-host
migration substrate), and ``submit`` / ``submit_rollout`` /
``resume_rollout`` take the cluster's ``trace_ctx``, which a session
keeps through every migration, so its steps stay spans of one trace.
``prewarm_from`` has no counterpart (AOT snapshots: eager PyTorch has no
executable).

Thread-safety: the routing counters, health memory and round-robin cursor
are shared between submitting threads and the reload and drain threads,
all under ``_lock``; a rollout holds ``_reload_lock`` so a slow restore
never blocks placement.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import Future
from typing import Callable, Sequence

from gnot_tpu_torch.data.batch import MeshSample, PackPlan
from gnot_tpu_torch.obs import events
from gnot_tpu_torch.obs.metrics import LogHistogram
from gnot_tpu_torch.serve.policies import ROUTE_POLICIES, ReplicaHealthPolicy
from gnot_tpu_torch.serve.replica import EngineReplica
from gnot_tpu_torch.serve.rollout import RolloutFuture, RolloutSession
from gnot_tpu_torch.serve.server import PACKED_BUCKET, InferenceServer


class ReplicaRouter:
    """N per-replica ``InferenceServer``s behind one ``submit()``.

    ``replicas`` are ``EngineReplica``s (``build_replicas``); the router
    builds one server per replica with the given knobs (admission, batcher
    and breaker each its own) tagged with its ``replica_id``. ``faults`` is
    ``{replica_id: FaultInjector}``, or one injector for replica 0;
    ``reload_fn`` is shared: every replica restores from the same source,
    one at a time."""

    def __init__(
        self,
        replicas: Sequence[EngineReplica],
        *,
        route_policy: str = "affinity",
        max_batch: int = 4,
        max_wait_ms: float = 10.0,
        queue_limit: int = 64,
        default_deadline_ms: float = 0.0,
        breaker_threshold: int = 3,
        breaker_cooldown_s: float = 1.0,
        sink=None,
        reload_fn: Callable | None = None,
        faults=None,
        preempt=None,
        clock: Callable[[], float] = time.monotonic,
        tracer=None,
        pack_plan: PackPlan | None = None,
        wedge_after_s: float = 2.0,
        session_snapshot_every: int = 1,
        session_migration: bool = True,
        max_session_migrations: int = 3,
        metrics=None,
        session_store=None,
        persist_snapshots: bool = False,
        catalog=None,
        tenants=None,
    ):
        if not replicas:
            raise ValueError("ReplicaRouter needs at least one replica")
        if route_policy not in ROUTE_POLICIES:
            raise ValueError(f"unknown route_policy {route_policy!r}; one of {ROUTE_POLICIES}")
        if max_session_migrations < 0:
            raise ValueError(
                f"max_session_migrations must be >= 0, got {max_session_migrations}")
        self.replicas = list(replicas)  #: guarded_by _lock
        self.route_policy = route_policy
        self.pack_plan = pack_plan
        self.sink = sink
        self.reload_fn = reload_fn
        self._clock = clock
        self._tracer = tracer
        self.health = ReplicaHealthPolicy(wedge_after_s=wedge_after_s)
        if faults is None:
            fault_map: dict = {}
        elif isinstance(faults, dict):
            fault_map = dict(faults)
        else:
            fault_map = {self.replicas[0].replica_id: faults}
        # The server knobs, kept so a scale-out replica gets the same
        # server; injected faults stay with the founding replicas.
        self._server_kwargs = dict(
            max_batch=max_batch,
            max_wait_ms=max_wait_ms,
            queue_limit=queue_limit,
            default_deadline_ms=default_deadline_ms,
            breaker_threshold=breaker_threshold,
            breaker_cooldown_s=breaker_cooldown_s,
            sink=sink,
            reload_fn=reload_fn,
            preempt=preempt,
            clock=clock,
            tracer=tracer,
            pack_plan=pack_plan,
            session_snapshot_every=session_snapshot_every,
            metrics=metrics,
            session_store=session_store,
            persist_snapshots=persist_snapshots,
            # One TenantPolicy for every replica: a tenant's quota bounds
            # its in-system requests across the pool.
            tenants=tenants,
            # One program catalog: program keys are pool-wide, traffic rows
            # carry the replica id.
            catalog=catalog,
        )
        self.tenants = tenants
        self._catalog = catalog
        self._session_store = session_store
        self._metrics = metrics
        # Per-replica wedge gauges, cached off the placement path.
        self._wedge_gauges: dict = {}
        if metrics is not None:
            metrics.gauge("pool_replicas", fn=lambda: float(len(self._pool())))
        self.session_migration = session_migration
        self.max_session_migrations = max_session_migrations
        for r in self.replicas:
            r.attach_server(InferenceServer(r.engine, faults=fault_map.get(r.replica_id),
                                            replica=r.replica_id, **self._server_kwargs))
        # One serving dtype a pool, read off the engines.
        self._dtype = getattr(self.replicas[0].engine, "dtype", "float32")
        self._lock = threading.Lock()
        self._submitted = 0  #: guarded_by _lock
        self._routed: dict[int, int] = {}  #: guarded_by _lock
        self._spills = 0  #: guarded_by _lock
        self._rr_next = 0  #: guarded_by _lock
        # The last health reason emitted per replica: edges become events.
        self._health_seen: dict[int, str] = {}  #: guarded_by _lock
        self._rollouts = 0  #: guarded_by _lock
        self._sessions_started = 0  #: guarded_by _lock
        self._sessions_migrated = 0  #: guarded_by _lock
        self._sessions_lost = 0  #: guarded_by _lock
        # Held while a rolling reload runs: one replica warms at a time.
        self._reload_lock = threading.Lock()
        self._drained = threading.Event()
        # Retired replicas' summaries and histograms, merged into the pool
        # rollup so a scale-in never drops served history.
        self._retired: dict[int, dict] = {}  #: guarded_by _lock
        self._retired_hist = LogHistogram()
        self._retired_step_hist = LogHistogram()
        self._retired_tenant_hists: dict = {}  #: guarded_by _lock

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "ReplicaRouter":
        for r in self._pool():
            r.server.start()
        return self

    def _pool(self) -> list[EngineReplica]:
        """A snapshot of the replica list (``add_replica`` grows it while
        other threads iterate)."""
        with self._lock:
            return list(self.replicas)

    def pool(self) -> list[EngineReplica]:
        """The live pool, a snapshot (the autoscaler's read of membership)."""
        return self._pool()

    def assess(self, replica: EngineReplica):
        """One pooled replica's health verdict, emitting its
        ``replica_health`` edge as a placement would (the autoscaler's
        self-healing scan)."""
        return self._assess(replica, self._clock())

    def add_replica(self, replica: EngineReplica) -> EngineReplica:
        """Scale-out: give an already warmed replica (``build_replica`` and
        ``warm``) a server configured like the others, start it and put it
        in the live pool; traffic can route to it from the next placement.
        Emits its ``replica_warm`` event. Ids in the pool or retired from it
        are refused."""
        with self._lock:
            if any(r.replica_id == replica.replica_id for r in self.replicas):
                raise ValueError(f"replica {replica.replica_id} is already in the pool")
            if replica.replica_id in self._retired:
                raise ValueError(
                    f"replica id {replica.replica_id} was retired from this pool; "
                    "scale-out replicas need fresh ids")
        replica.attach_server(InferenceServer(replica.engine, replica=replica.replica_id,
                                              **self._server_kwargs))
        replica.server.start()
        with self._lock:
            if any(r.replica_id == replica.replica_id for r in self.replicas):
                # A racing add of the same id: stop our server first.
                replica.server.drain(timeout_s=0.0)
                raise ValueError(f"replica {replica.replica_id} is already in the pool")
            self.replicas.append(replica)
        self._note_warm(replica, None)
        return replica

    def _note_warm(self, r: EngineReplica, t0: float | None) -> None:
        """A ``replica_warm`` event with the replica's warm stats, and its
        warm window as a span on the tracer's "r" stream."""
        stats = r.warm_stats or {"source": "none", "programs": 0, "seconds": 0.0}
        self._event(events.REPLICA_WARM, replica=r.replica_id, source=stats["source"],
                    programs=stats["programs"], seconds=stats["seconds"],
                    **({"reason": stats["reason"]} if stats.get("reason") else {}))
        if self._tracer is not None:
            trace = self._tracer.start_trace(stream="r")
            if trace is not None:
                # Warmed before it joined (t0 None): the span ends now and
                # lasts the warm-up.
                now = self._clock()
                start = t0 if t0 is not None else now - stats["seconds"]
                self._tracer.add_span("replica_warm", start, now, trace=trace,
                                      args={"replica": r.replica_id, "source": stats["source"],
                                            "programs": stats["programs"]})

    def remove_replica(self, replica_id: int, *, timeout_s: float = 30.0,
                       reason: str = "scale_in") -> dict:
        """Scale-in, drain-then-remove: the replica goes ``retiring`` (no
        new placement; a ``replica_health`` edge now), hands its resident
        sessions to siblings at their next step boundary (no replay), its
        server drains (emitting its summary), and it leaves the pool with
        its summary and histograms kept for the pool rollup. Returns the
        replica's summary. The last replica is never removed. The handover
        wait is bounded by wall time, whatever the injected clock."""
        with self._lock:
            target = next((r for r in self.replicas if r.replica_id == replica_id), None)
            if target is None:
                raise ValueError(f"replica {replica_id} is not in the pool")
            if len(self.replicas) == 1:
                raise ValueError(
                    "cannot remove the last replica; the pool must keep serving (scale out first)")
        target.set_retiring(True)
        self._assess(target, self._clock())
        srv = target.server
        deadline = time.monotonic() + timeout_s
        if srv.worker_alive():
            srv.begin_eviction(self._evict_session)
            while (srv.resident_sessions() and srv.worker_alive()
                   and time.monotonic() < deadline):
                time.sleep(0.002)
        summary = srv.drain(max(0.0, deadline - time.monotonic()))
        with self._lock:
            # The ledger entry and its histograms appear together: a drain
            # racing this one merges the replica exactly once.
            self._retired[replica_id] = {"summary": summary, "warm_stats": target.warm_stats}
            self._retired_hist.merge(srv.latency_histogram())
            self._retired_step_hist.merge(srv.step_latency_histogram())
            for t, h in srv.tenant_rollup()["hists"].items():
                self._retired_tenant_hists.setdefault(t, LogHistogram()).merge(h)
            self.replicas = [r for r in self.replicas if r.replica_id != replica_id]
            self._health_seen.pop(replica_id, None)
            pool_n = len(self.replicas)
        self._wedge_gauges.pop(replica_id, None)
        if self._metrics is not None:
            # Its callback gauges would pin the drained server (and its
            # weights on the card); counters and histograms stay.
            self._metrics.unregister_gauges(replica=replica_id)
        self._event(events.REPLICA_REMOVE, replica=replica_id, reason=reason,
                    requests=summary.get("requests", 0), completed=summary.get("completed", 0),
                    pool=pool_n, drain_timeout_s=timeout_s)
        return summary

    def _evict_session(self, session: RolloutSession, from_replica: int | None) -> bool:
        """Re-place one session of a retiring replica on a sibling (called
        by its worker at a step boundary, the snapshot at the cursor).
        False when no sibling can take it. A planned handover spends none
        of the session's migration budget."""
        now = self._clock()
        candidates = [r for r in self._pool()
                      if r.replica_id != from_replica and not r.retiring]
        healthy = [r for r in candidates if self._assess(r, now).healthy]
        pool = healthy or [r for r in candidates if r.server.worker_alive()]
        if not pool:
            return False
        with self._lock:
            target = min(pool, key=self._load)
            self._sessions_migrated += 1
        if self._metrics is not None:
            self._metrics.counter("router_migrations_total").inc()
        at_step = session.cursor
        self._event(events.SESSION_MIGRATE, session=session.sid, from_replica=from_replica,
                    to_replica=target.replica_id, at_step=at_step, replay_from=at_step,
                    reason="scale_in")
        target.server.submit_rollout(session=session)
        return True

    # -- placement ---------------------------------------------------------

    def submit(self, sample: MeshSample, *, deadline_ms: float | None = None,
               tenant: str | None = None, trace_ctx=None) -> Future:
        """Place one request and submit it there. The future resolves as a
        single server's would. ``tenant`` tags it for the placed replica's
        quota and WFQ; placement itself is tenant-blind. ``trace_ctx`` (an
        ``obs/dtrace.TraceContext``) is the cluster's sampling decision,
        which the placed server adopts."""
        key, label = self._bucket_of(sample)
        replica, reason = self._place(key)
        self._note_placed(replica, reason, label)
        return replica.server.submit(sample, deadline_ms=deadline_ms, tenant=tenant,
                                     trace_ctx=trace_ctx)

    def _note_placed(self, replica: EngineReplica, reason: str, label: str,
                     **extra) -> None:
        """Count one placement and emit its ``route`` event."""
        rid = replica.replica_id
        with self._lock:
            self._submitted += 1
            self._routed[rid] = self._routed.get(rid, 0) + 1
            if reason == "spill":
                self._spills += 1
        if self._metrics is not None:
            self._metrics.counter("router_routes_total", reason=reason).inc()
        self._event(events.ROUTE, replica=rid, bucket=label, policy=self.route_policy,
                    reason=reason, depth=replica.server.depth(), dtype=self._dtype, **extra)

    def _bucket_of(self, sample: MeshSample) -> tuple:
        """(affinity key, label): the bucket the replica's server batches
        the request under."""
        plan = self.pack_plan
        if plan is not None and plan.packable(sample):
            return PACKED_BUCKET, f"packed:{plan.n_rows}x{plan.row_len}"
        pn, pf = self._pool()[0].engine.bucket_key(sample)
        return (pn, pf), f"{pn}x{pf}"

    def _place(self, key) -> tuple[EngineReplica, str]:
        """One placement. Health filters the candidates (outside the lock:
        it emits events); the policy picks under ``_lock``, so two first
        requests of one cold bucket cannot both assign it."""
        now = self._clock()
        replicas = self._pool()
        pool = [r for r in replicas if self._assess(r, now).healthy]
        degraded = not pool
        if degraded:
            pool = replicas
        with self._lock:
            if self.route_policy == "round_robin" and not degraded:
                idx = self._rr_next % len(pool)
                self._rr_next += 1
                return pool[idx], "round_robin"
            open_pool = [r for r in pool if self._has_room(r)]
            if self.route_policy == "least_loaded" or degraded:
                target = min(open_pool or pool, key=self._load)
                return target, ("no_healthy" if degraded else "least_loaded")
            warm = [r for r in open_pool if r.has_bucket(key)]
            if warm:
                return min(warm, key=self._load), "affinity"
            # Assigned anywhere in the pool (its replica drained or full):
            # a spill, not a cold bucket.
            assigned = any(r.has_bucket(key) for r in replicas)
            if open_pool:
                target = min(open_pool, key=self._load)
                target.note_bucket(key)
                return target, ("spill" if assigned else "cold_assign")
            # Every candidate full: its admission sheds with the reason.
            return min(pool, key=self._load), "pool_full"

    @staticmethod
    def _load(r: EngineReplica) -> tuple:
        # In-system requests plus resident sessions (a session keeps
        # re-entering its replica's queue); ties to the lowest id.
        return (r.server.depth() + r.server.resident_sessions(), r.replica_id)

    @staticmethod
    def _has_room(r: EngineReplica) -> bool:
        return r.server.depth() < r.server.admission.limit

    def _assess(self, r: EngineReplica, now: float):
        """One replica's verdict from its live signals; a ``replica_health``
        event when its reason changed."""
        verdict = self.health.assess(
            breaker_state=r.server.breaker.state,
            warming=r.warming,
            progress_age_s=r.server.progress_age_s(now),
            depth=r.server.depth(),
            worker_alive=r.server.worker_alive(),
            breaker_trial_due=r.server.breaker.trial_due(),
            retiring=r.retiring,
        )
        if self._metrics is not None:
            # The metrics plane's wedged objective reads this level.
            g = self._wedge_gauges.get(r.replica_id)
            if g is None:
                g = self._wedge_gauges[r.replica_id] = self._metrics.gauge(
                    "serve_wedged", replica=r.replica_id)
            g.set(1.0 if verdict.reason == "wedged" else 0.0)
        with self._lock:
            if self._health_seen.get(r.replica_id) != verdict.reason:
                self._health_seen[r.replica_id] = verdict.reason
                # Under the lock, so edges cannot interleave out of order.
                self._event(events.REPLICA_HEALTH, replica=r.replica_id,
                            healthy=verdict.healthy, reason=verdict.reason)
        return verdict

    # -- rollout sessions --------------------------------------------------

    def submit_rollout(self, sample: MeshSample, steps: int, *,
                       deadline_ms: float | None = None,
                       rollout_deadline_ms: float | None = None, on_step=None,
                       name: str | None = None, tenant: str | None = None,
                       trace_ctx=None) -> RolloutFuture:
        """Place one ``steps``-step rollout session: its first step routes
        like a request (one ``route`` event with the session id), the rest
        stay on the owner. A session whose owner fails mid-rollout is
        re-placed on a sibling from its last snapshot (``session_migrate``),
        unless migration is off or its budget spent, when the future
        resolves with the failure. The future always resolves. A
        ``trace_ctx`` rides the session, so every step it runs here, after
        a local migration too, adopts the one cluster decision."""
        sc = self._server_kwargs
        ms = deadline_ms if deadline_ms is not None else sc["default_deadline_ms"]
        if name is not None and any(r.server.has_session(name) for r in self._pool()):
            raise ValueError(f"a session named {name!r} is already resident in the pool")
        with self._lock:
            self._sessions_started += 1
            sid = name or f"r{self._sessions_started:05d}"
        session = RolloutSession(
            sid, sample, steps,
            snapshot_every=sc["session_snapshot_every"],
            step_deadline_ms=ms or None,
            rollout_deadline=(self._clock() + rollout_deadline_ms / 1e3
                              if rollout_deadline_ms else None),
            on_step=on_step,
            tenant=tenant,
        )
        session.named = name is not None
        session.migrate_cb = self._session_failed
        session.trace_ctx = trace_ctx
        self._place_session(session, sample)
        return session.future

    def resume_rollout(self, name: str, *, deadline_ms: float | None = None,
                       rollout_deadline_ms: float | None = None,
                       on_step=None, trace_ctx=None) -> RolloutFuture:
        """Resume a session persisted to the session store (by a drain, or
        by a federated host's rolling persistence), placed like a fresh
        rollout. ``KeyError`` when nothing is stored under ``name``; a
        session complete at its snapshot resolves at once. A cross-host
        re-migration arrives here with the session's original
        ``trace_ctx``, so its resumed steps join that trace."""
        if self._session_store is None:
            raise RuntimeError("no session store configured")
        if any(r.server.has_session(name) for r in self._pool()):
            raise ValueError(f"a session named {name!r} is already resident in the pool")
        state = self._session_store.load(name)
        if state is None:
            raise KeyError(f"no persisted session {name!r}")
        sc = self._server_kwargs
        ms = deadline_ms if deadline_ms is not None else sc["default_deadline_ms"]
        session = RolloutSession.from_state(
            state,
            snapshot_every=sc["session_snapshot_every"],
            step_deadline_ms=ms or None,
            rollout_deadline=(self._clock() + rollout_deadline_ms / 1e3
                              if rollout_deadline_ms else None),
            on_step=on_step,
        )
        if session.finished:
            session.resolve(True, "ok")
            return session.future
        with self._lock:
            self._sessions_started += 1
        session.migrate_cb = self._session_failed
        session.trace_ctx = trace_ctx
        self._place_session(session, session.sample)
        return session.future

    def _place_session(self, session: RolloutSession, sample) -> None:
        """A session's one placement, its ``route`` event tagged with its id."""
        key, label = self._bucket_of(sample)
        replica, reason = self._place(key)
        self._note_placed(replica, reason, label, session=session.sid)
        replica.server.submit_rollout(session=session)

    def _session_failed(self, session: RolloutSession, reason: str, detail: str,
                        from_replica: int | None) -> None:
        """The migration callback, run by the failed owner's server on its
        worker or drain thread: re-place the session from its snapshot on a
        sibling, or (migration off, budget spent, nobody left) resolve it
        with the failure, lost."""
        # The owner's health edge lands first.
        if from_replica is not None:
            for r in self._pool():
                if r.replica_id == from_replica:
                    self._assess(r, self._clock())
        give_up = (not self.session_migration or self._drained.is_set()
                   or session.migrations >= self.max_session_migrations)
        target = None
        if not give_up:
            now = self._clock()
            replicas = [r for r in self._pool() if r.replica_id != from_replica]
            healthy = [r for r in replicas if self._assess(r, now).healthy]
            # A fallback must have a live worker (a dead one would strand
            # the step); a retiring one is the last resort.
            alive = [r for r in replicas if r.server.worker_alive() and not r.retiring]
            alive = alive or [r for r in replicas if r.server.worker_alive()]
            pool = healthy or alive
            if pool:
                with self._lock:
                    target = min(pool, key=self._load)
        if target is None:
            if session.resolve(False, reason, detail=detail):
                with self._lock:
                    self._sessions_lost += 1
                if self._metrics is not None:
                    self._metrics.counter("rollout_sessions_lost_total").inc()
            return
        at_step = session.cursor
        replay_from = session.restore_from_snapshot()
        with self._lock:
            self._sessions_migrated += 1
        if self._metrics is not None:
            self._metrics.counter("router_migrations_total").inc()
        self._event(events.SESSION_MIGRATE, session=session.sid, from_replica=from_replica,
                    to_replica=target.replica_id, at_step=at_step, replay_from=replay_from,
                    reason=reason)
        target.server.submit_rollout(session=session)

    # -- rolling hot reload ------------------------------------------------

    def reload(self, *, deadline_ms: float = 0.0) -> int:
        """Rolling hot reload: one replica at a time is marked warming,
        reloads on this thread and rejoins before the next starts; a failed
        restore keeps that replica's old weights and the rollout goes on.
        Each replica restores from the source itself (a failure stays its
        own; a checkpoint published mid-rollout reaches the rest). Returns
        the replicas that reloaded ok."""
        if self.reload_fn is None:
            raise RuntimeError("no reload source configured")
        with self._reload_lock:
            with self._lock:
                self._rollouts += 1
                rollout = self._rollouts
            ok_n = 0
            rollout_pool = self._pool()
            for step, r in enumerate(rollout_pool, 1):
                r.set_warming(True)
                self._assess(r, self._clock())  # the warming edge
                try:
                    # _reload_lock exists to serialize rollouts; holding it
                    # across each replica's reload IS the rolling-reload
                    # contract (one replica warming, the rest serving).
                    # Request traffic never takes this lock.
                    #: allowed_blocking — rolling reload serialized by design
                    ok = r.server.reload(deadline_ms=deadline_ms)
                finally:
                    r.set_warming(False)
                self._assess(r, self._clock())
                ok_n += bool(ok)
                self._event(events.ROLLING_RELOAD, replica=r.replica_id, ok=ok, step=step,
                            n_replicas=len(rollout_pool), rollout=rollout)
            return ok_n

    # -- drain and the pool rollup -------------------------------------------

    def drain(self, timeout_s: float = 30.0) -> dict:
        """Drain every replica at once under one budget, then emit one pool
        ``serve_summary`` with the ``per_replica`` rollup and the ``routing``
        block (once; a later drain returns it again without an event).
        Pool percentiles come from the lossless merge of the replicas'
        histograms, retired replicas included."""
        per: dict[int, dict] = {}
        pool = self._pool()

        def _drain_one(r):
            per[r.replica_id] = r.server.drain(timeout_s)

        threads = [threading.Thread(target=_drain_one, args=(r,), daemon=True) for r in pool]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        with self._lock:
            retired = dict(self._retired)
            retired_hist = self._retired_hist.copy()
            retired_step_hist = self._retired_step_hist.copy()
            retired_tenant_hists = {t: h.copy() for t, h in self._retired_tenant_hists.items()}
        retired_ids = set(retired)
        for rid, ret in retired.items():
            per[rid] = ret["summary"]
        # A removal that finished after the pool snapshot merges from the
        # ledger only.
        live = [r for r in pool if r.replica_id not in retired_ids]
        pool_hist = LogHistogram()
        pool_hist.merge(retired_hist)
        for r in live:
            pool_hist.merge(r.server.latency_histogram())
        shed: dict[str, int] = {}
        for s in per.values():
            for reason, n in s["shed"].items():
                shed[reason] = shed.get(reason, 0) + n
        pad_waste: dict[str, dict] = {}
        for s in per.values():
            for key, st in (s.get("pad_waste_by_bucket") or {}).items():
                agg = pad_waste.setdefault(
                    key, {"dispatches": 0, "real_tokens": 0, "capacity_tokens": 0})
                for k in agg:
                    agg[k] += st[k]
        for st in pad_waste.values():
            cap = st["capacity_tokens"]
            st["fill_frac"] = st["real_tokens"] / cap if cap else None
            st["pad_waste_frac"] = 1.0 - st["real_tokens"] / cap if cap else None
        tenants_roll: dict[str, dict] = {}
        for s in per.values():
            for t, st in (s.get("tenants") or {}).items():
                agg = tenants_roll.setdefault(t, {"requests": 0, "completed": 0, "shed": {}})
                agg["requests"] += st["requests"]
                agg["completed"] += st["completed"]
                for reason, n in st["shed"].items():
                    agg["shed"][reason] = agg["shed"].get(reason, 0) + n
        tenant_hists: dict[str, LogHistogram] = {
            t: h.copy() for t, h in retired_tenant_hists.items()}
        for r in live:
            for t, h in r.server.tenant_rollup()["hists"].items():
                tenant_hists.setdefault(t, LogHistogram()).merge(h)
        warm_by_id = {r.replica_id: r.warm_stats for r in pool}
        warm_by_id.update({rid: ret["warm_stats"] for rid, ret in retired.items()})
        step_hist = LogHistogram()
        step_hist.merge(retired_step_hist)
        for r in live:
            step_hist.merge(r.server.step_latency_histogram())
        with self._lock:
            routed = dict(self._routed)
            spills = self._spills
            rollouts = self._rollouts
            submitted = self._submitted
            sessions_started = self._sessions_started
            sessions_migrated = self._sessions_migrated
            sessions_lost = self._sessions_lost
        summary = {
            "dtype": self._dtype,
            "requests": sum(s["requests"] for s in per.values()),
            "admitted": sum(s["admitted"] for s in per.values()),
            "completed": sum(s["completed"] for s in per.values()),
            "shed": shed,
            "dispatches": sum(s["dispatches"] for s in per.values()),
            "reloads": sum(s["reloads"] for s in per.values()),
            "breaker_trips": sum(s["breaker_trips"] for s in per.values()),
            "compiled_shapes": sum(s["compiled_shapes"] for s in per.values()),
            "latency_p50_ms": pool_hist.percentile(0.50),
            "latency_p99_ms": pool_hist.percentile(0.99),
            **({"pad_waste_by_bucket": dict(sorted(pad_waste.items()))} if pad_waste else {}),
            "per_replica": {
                str(rid): {
                    "requests": s["requests"],
                    "completed": s["completed"],
                    "shed": s["shed"],
                    "dispatches": s["dispatches"],
                    "reloads": s["reloads"],
                    "breaker_trips": s["breaker_trips"],
                    "compiled_shapes": s["compiled_shapes"],
                    "latency_p50_ms": s["latency_p50_ms"],
                    "latency_p99_ms": s["latency_p99_ms"],
                    "routed": routed.get(rid, 0),
                    "warmup_cache": warm_by_id.get(rid),
                    **({"retired": True} if rid in retired_ids else {}),
                }
                for rid, s in sorted(per.items())
            },
            "routing": {
                "policy": self.route_policy,
                "replicas": len(pool),
                "removed": len(retired_ids),
                # The router's count: the per-replica requests' sum unless
                # callers also submitted to a replica's server directly.
                "submitted": submitted,
                "spills": spills,
                "rollouts": rollouts,
            },
        }
        if tenants_roll:
            summary["tenants"] = {
                t: {
                    **agg,
                    "latency_p50_ms": (tenant_hists[t].percentile(0.50)
                                       if t in tenant_hists else None),
                    "latency_p99_ms": (tenant_hists[t].percentile(0.99)
                                       if t in tenant_hists else None),
                }
                for t, agg in sorted(tenants_roll.items())
            }
        if self._tracer is not None:
            # One tracer for every replica: its counters are the pool's.
            summary["trace"] = self._tracer.coverage()
        if sessions_started:
            summary["sessions"] = {
                "started": sessions_started,
                "completed": sum((s.get("sessions") or {}).get("completed", 0)
                                 for s in per.values()),
                "drained": sum((s.get("sessions") or {}).get("drained", 0) for s in per.values()),
                "shed": sum((s.get("sessions") or {}).get("shed", 0) for s in per.values()),
                "migrated": sessions_migrated,
                "lost": sessions_lost,
                "steps": step_hist.count,
                "step_latency_p50_ms": step_hist.percentile(0.50),
                "step_latency_p99_ms": step_hist.percentile(0.99),
            }
        if self._catalog is not None:
            # The pool's capacity model, retired replicas' traffic included;
            # the capacity_snapshot event once across repeated drains.
            model = self._catalog.emit_snapshot()
            summary["capacity_model"] = (
                model if model is not None else self._catalog.capacity_model())
        if not self._drained.is_set():
            self._drained.set()
            self._event(events.SERVE_SUMMARY, **summary)
            if self.sink is not None:
                self.sink.flush()
        return summary

    def _event(self, event: str, **fields) -> None:
        if self.sink is not None:
            self.sink.log(event=event, **fields)
