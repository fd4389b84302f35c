"""Self-healing elastic serving: the autoscaling controller that closes
the loop from load and SLO burn to pool size.

Port of ``gnot_tpu/serve/autoscaler.py``. It reads the live metrics plane
(``obs/metrics.py``: the registry's load gauges and the
``SLOEvaluator``'s alert state, not raw events) and drives the router's
membership verbs (``ReplicaRouter.add_replica`` / ``remove_replica``).
Each tick takes at most ONE action:

1. **Self-heal** (first): a replica whose worker died is replaced at once;
   one wedged or breaker-stuck past ``heal_after_s`` after that dwell.
   Replacement is remove-then-rebuild on the freed slot under a fresh
   replica id (``replica_replace``), so the pool keeps its size and
   healing is exempt from the min / max bounds.
2. **Scale out**: per-replica in-system load (queue depth + resident
   rollout sessions, the registry's ``serve_queue_depth`` /
   ``serve_resident_sessions`` gauges) at or above ``up_load``, or any
   active pressure alert (latency, shed, queue saturation). The new
   replica is built on a free slot, warmed BEFORE it joins (its warm-up
   dispatches, ``warm_source`` "compile" as in JAX) and only then admitted
   to routing (``scale_up``).
3. **Scale in**: load at or below ``down_load`` (``down_load < up_load``)
   with no active alert for ``down_ticks`` consecutive ticks. The
   least-loaded replica retires by drain-then-remove (``scale_down``): its
   resident sessions migrate to siblings and its history stays in the
   pool rollup.

Guards, all config-declared (``--autoscale*``): the min / max bounds,
per-direction cooldowns, the up / down hysteresis, the calm-ticks
requirement and a flap suppressor (no scale-in within ``flap_suppress_s``
of a scale-out). A vetoed move emits ``autoscale_decision`` with
``action="hold"`` on edges only. With a ``TenantPolicy``, pressure owned
entirely by batch-class tenants is held (``batch_deferral``: the WFQ
batcher defers batch work instead), and a tenant's alert names the
scale-out's reason.

Slots. JAX partitions the devices ``max_replicas`` ways and gives each
replica a slot's devices. The port's replicas share the one card, each on
its own CUDA stream (``serve/replica.py``), so every slot is that card: the
slot ledger is kept, for the same ids, events and replacement rule, and
``replica_factory(replica_id, slot)`` builds on the card whatever the slot.

``tick()`` is the synchronous core (tests drive it on an injected clock);
``start()`` / ``close()`` run it on a daemon thread every ``interval_s``.
The controller keeps the replica-seconds ledger (the integral of pool size
over time). ``prewarm_manifest`` (JAX's AOT hydration before a join) is
refused: eager PyTorch has no executable to serialize.
"""

from __future__ import annotations

import time
from typing import Callable, Iterable

import threading

from gnot_tpu_torch.config import NotPortedError
from gnot_tpu_torch.obs import events

#: SLO objectives that read as CAPACITY pressure (scale out): burn on
#: these means the pool is too small. Health objectives (breaker,
#: wedge, session loss) are healing signals, not sizing ones.
PRESSURE_OBJECTIVES = ("latency_p99", "shed_fraction", "queue_saturation")

#: Health-verdict reasons that condemn a replica to replacement once
#: they persist past ``heal_after_s`` ("dead" skips the dwell).
HEAL_REASONS = ("dead", "wedged", "breaker_open")


class AutoscaleController:
    """The control loop. One action per tick, stability guards first.

    ``replica_factory(replica_id, slot) -> EngineReplica`` builds a new
    (unwarmed) replica for slot ``slot`` (slots ``0..max-1``; on the port
    every slot is the one card). The controller owns slot allocation:
    founding replicas occupy slots ``0..n-1``; a removed replica frees its
    slot for the next scale-out or replacement.

    ``registry`` (``obs.metrics.MetricsRegistry``) is the load sensor;
    without one the controller probes the replica servers directly.
    ``evaluator`` contributes the burn-rate alert state. ``warm_samples``
    (and ``pack_plan``) warm a joining replica before it takes traffic;
    ``prewarm_manifest`` must be None.
    """

    def __init__(
        self,
        router,
        *,
        replica_factory: Callable,
        min_replicas: int = 1,
        max_replicas: int = 4,
        interval_s: float = 0.5,
        cooldown_s: float = 2.0,
        up_load: float = 8.0,
        down_load: float = 1.0,
        surge_mult: float = 2.0,
        down_ticks: int = 3,
        flap_suppress_s: float | None = None,
        heal_after_s: float = 5.0,
        drain_timeout_s: float = 30.0,
        registry=None,
        evaluator=None,
        pressure_objectives: Iterable[str] = PRESSURE_OBJECTIVES,
        warm_samples=None,
        pack_plan=None,
        prewarm_manifest: dict | None = None,
        sink=None,
        clock: Callable[[], float] = time.monotonic,
        tenants=None,
    ):
        if not 1 <= min_replicas <= max_replicas:
            raise ValueError(
                f"need 1 <= autoscale min <= max, got "
                f"{min_replicas}/{max_replicas}"
            )
        if interval_s <= 0:
            raise ValueError(f"interval_s must be > 0, got {interval_s}")
        if cooldown_s < 0:
            raise ValueError(f"cooldown_s must be >= 0, got {cooldown_s}")
        if not 0 <= down_load < up_load:
            raise ValueError(
                "hysteresis needs 0 <= down_load < up_load, got "
                f"{down_load}/{up_load}"
            )
        if down_ticks < 1:
            raise ValueError(f"down_ticks must be >= 1, got {down_ticks}")
        if heal_after_s <= 0:
            raise ValueError(
                f"heal_after_s must be > 0, got {heal_after_s}"
            )
        if prewarm_manifest is not None:
            raise NotPortedError(
                "prewarm_manifest (AOT executable snapshots) has no counterpart: "
                "eager PyTorch has no compiled executable to serialize; a joining "
                "replica warms from warm_samples"
            )
        self.router = router
        self.replica_factory = replica_factory
        self.min_replicas = min_replicas
        self.max_replicas = max_replicas
        self.interval_s = float(interval_s)
        self.cooldown_s = float(cooldown_s)
        self.up_load = float(up_load)
        self.down_load = float(down_load)
        # Surge scaling: load this far past up_load bypasses the up
        # cooldown (a step change in demand must not pay one cooldown
        # per replica while the backlog compounds). <= 1 disables.
        self.surge_mult = float(surge_mult)
        self.down_ticks = down_ticks
        # Flap suppressor: scale-in is vetoed this close after a
        # scale-out (a burst's tail must not retire the replica the
        # burst just bought). Default: three cooldowns.
        self.flap_suppress_s = (
            float(flap_suppress_s)
            if flap_suppress_s is not None
            else 3.0 * self.cooldown_s
        )
        self.heal_after_s = float(heal_after_s)
        self.drain_timeout_s = float(drain_timeout_s)
        self.registry = registry
        self.evaluator = evaluator
        self.pressure_objectives = tuple(pressure_objectives)
        self.warm_samples = warm_samples
        self.pack_plan = pack_plan
        self.prewarm_manifest = prewarm_manifest
        self.sink = sink
        # TenantPolicy (serve/policies.py), when the pool is multi-
        # tenant: per-tenant slo_alert edges (latency_p99:<tenant>)
        # ATTRIBUTE scale-out to the tenant burning budget, and
        # pressure owned entirely by batch-class tenants is answered by
        # deferral (WFQ/priority already shields interactive), not
        # replicas — the batch-deferral veto.
        self.tenants = tenants
        self._clock = clock
        pool = router.pool()
        # Slot ledger: founding replicas occupy the first slots in pool
        # order; everything else is free for scale-out/replacement.
        self._slot_of = {
            r.replica_id: i for i, r in enumerate(pool)
        }  #: guarded_by _lock
        self._free_slots = sorted(
            set(range(max_replicas)) - set(self._slot_of.values())
        )  #: guarded_by _lock
        self._next_id = (
            max((r.replica_id for r in pool), default=-1) + 1
        )  #: guarded_by _lock
        # Guard state: per-direction last-action stamps, the calm-tick
        # counter, the per-replica first-seen-unhealthy dwell stamps,
        # and the last emitted hold reason (vetoes are edge events).
        self._last_up = -float("inf")  #: guarded_by _lock
        self._last_down = -float("inf")  #: guarded_by _lock
        self._last_heal = -float("inf")  #: guarded_by _lock
        self._calm_ticks = 0  #: guarded_by _lock
        self._unhealthy_since: dict[int, float] = {}  #: guarded_by _lock
        self._last_hold: str | None = None  #: guarded_by _lock
        # Replica-seconds ledger (capacity paid for): integral
        # of pool size over time, stepped at every tick/size change.
        self._rs_total = 0.0  #: guarded_by _lock
        self._rs_since: float | None = None  #: guarded_by _lock
        self._rs_size = 0  #: guarded_by _lock
        self._ticks = 0  #: guarded_by _lock
        self._scale_ups = 0  #: guarded_by _lock
        self._scale_downs = 0  #: guarded_by _lock
        self._replaces = 0  #: guarded_by _lock
        self._holds = 0  #: guarded_by _lock
        self._errors = 0  #: guarded_by _lock
        self._last_tick_error: str | None = None  #: guarded_by _lock
        self._lock = threading.Lock()
        # Serializes whole ticks: manual test ticks must not interleave
        # with the cadence thread's (one action per tick, globally).
        self._tick_lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._closed = False

    # -- observation --------------------------------------------------------

    def observed_load(self) -> float:
        """Per-replica in-system load: pool queue depth + resident
        rollout sessions, divided by pool size. Read from the metrics
        registry's gauges when one is attached (the controller
        subscribes to the sensor plane, not raw events); probed from
        the replica servers directly otherwise."""
        pool = self.router.pool()
        n = max(1, len(pool))
        if self.registry is not None:
            total = self.registry.aggregate_gauge(
                "serve_queue_depth"
            ) + self.registry.aggregate_gauge("serve_resident_sessions")
        else:
            total = float(
                sum(
                    r.server.depth() + r.server.resident_sessions()
                    for r in pool
                )
            )
        return total / n

    def _active_alerts(self) -> list[str]:
        if self.evaluator is None:
            return []
        return sorted(
            name for name, on in self.evaluator.active().items() if on
        )

    # -- the loop -----------------------------------------------------------

    def tick(self) -> dict:
        """One control cycle: observe -> decide -> act (at most one
        action). Returns the decision record."""
        with self._tick_lock:
            return self._tick_locked()

    def _tick_locked(self) -> dict:
        now = self._clock()
        pool = self.router.pool()
        self._note_pool_size(len(pool), now)
        with self._lock:
            self._ticks += 1
        healed = self._heal(now, pool)
        if healed is not None:
            return healed
        n = len(pool)
        load = self.observed_load()
        alerts = self._active_alerts()
        # Tenant-scoped alerts are named ``<objective>:<tenant>``
        # (metrics.tenant_objectives); their BASE name decides whether
        # they are capacity pressure, and their suffix attributes it.
        pressure = [
            a
            for a in alerts
            if a.split(":", 1)[0] in self.pressure_objectives
        ]
        want_up = load >= self.up_load or bool(pressure)
        calm = load <= self.down_load and not alerts
        with self._lock:
            self._calm_ticks = self._calm_ticks + 1 if calm else 0
            calm_ticks = self._calm_ticks
            last_up, last_down = self._last_up, self._last_down
        if n < self.min_replicas:
            # Below the floor (a replacement build failed mid-heal):
            # restore the minimum before any other consideration — but
            # still on the up cooldown, so a persistently failing
            # factory cannot hot-loop the build.
            if now - last_up < self.cooldown_s:
                return self._hold(now, n, "cooldown_up", load, alerts)
            return self._scale_up(now, n, "below_min", load, alerts)
        if want_up:
            # Batch-deferral veto: when the ONLY pressure is SLO burn
            # attributed entirely to batch-class tenants (raw load is
            # below up_load), the right answer is deferral — WFQ +
            # priority classes already push the pain onto batch work —
            # not buying replicas for a flood the policy exists to
            # absorb. Interactive-attributed or pool-level burn still
            # scales out.
            if (
                self.tenants is not None
                and pressure
                and load < self.up_load
                and all(
                    ":" in a
                    and self.tenants.priority(a.split(":", 1)[1])
                    == "batch"
                    for a in pressure
                )
            ):
                return self._hold(now, n, "batch_deferral", load, alerts)
            # Attribution: prefer a tenant-scoped alert for the reason
            # (``slo:latency_p99:alice`` names who is burning budget).
            attributed = [a for a in pressure if ":" in a]
            reason = (
                f"slo:{(attributed or pressure)[0]}"
                if pressure
                else "load"
            )
            if n >= self.max_replicas:
                return self._hold(now, n, "at_max", load, alerts)
            surge = (
                self.surge_mult > 1.0
                and load >= self.surge_mult * self.up_load
            )
            if surge:
                reason = "surge"
            elif now - last_up < self.cooldown_s:
                return self._hold(now, n, "cooldown_up", load, alerts)
            return self._scale_up(now, n, reason, load, alerts)
        if n > self.min_replicas and calm and calm_ticks >= self.down_ticks:
            if now - last_up < self.flap_suppress_s:
                return self._hold(now, n, "flap_suppressed", load, alerts)
            if now - last_down < self.cooldown_s:
                return self._hold(now, n, "cooldown_down", load, alerts)
            return self._scale_down(now, n, load, alerts)
        with self._lock:
            self._last_hold = None  # nothing wanted: reset the veto edge
        return {"action": "none", "pool": n, "load": load}

    # -- actions ------------------------------------------------------------

    def _scale_up(
        self, now: float, n: int, reason: str, load: float, alerts
    ) -> dict:
        with self._lock:
            if not self._free_slots:
                # Every slot occupied at sub-max pool size can only
                # mean an id/slot leak — surface it, don't wedge.
                self._errors += 1
                return {"action": "error", "reason": "no_free_slot"}
            slot = self._free_slots.pop(0)
            rid = self._next_id
            self._next_id += 1
        t0 = self._clock()
        try:
            replica = self.replica_factory(rid, slot)
            warm_source = self._warm_before_join(replica, slot)
            self.router.add_replica(replica)
        except Exception as err:  # noqa: BLE001 — the loop must outlive one failed join
            with self._lock:
                self._free_slots.append(slot)
                self._free_slots.sort()
                self._errors += 1
                # Stamp the cooldown anyway: a persistently failing
                # factory retries at cooldown cadence, not per tick.
                self._last_up = now
            self._decision(
                "hold", f"scale_up_failed:{type(err).__name__}", n,
                load=load, alerts=alerts, detail=str(err),
            )
            return {"action": "error", "reason": str(err)}
        with self._lock:
            self._slot_of[rid] = slot
            self._last_up = now
            self._calm_ticks = 0
            self._last_hold = None
            self._scale_ups += 1
        self._note_pool_size(n + 1, self._clock())
        self._decision(
            "scale_up", reason, n + 1, replica=rid, load=load,
            alerts=alerts,
        )
        self._event(
            events.SCALE_UP,
            replica=rid,
            pool=n + 1,
            reason=reason,
            warm_source=warm_source,
            seconds=self._clock() - t0,
            load=load,
        )
        return {
            "action": "scale_up", "replica": rid, "pool": n + 1,
            "reason": reason, "warm_source": warm_source,
        }

    def _warm_before_join(self, replica, slot: int) -> str:
        """Warm-before-join: the replica dispatches every bucket of
        ``warm_samples`` (and the pack plan) before ``add_replica`` admits
        it to routing, so no affinity assignment lands on a cold replica.
        JAX hydrates the slot's AOT block here when a manifest covers it;
        the port has none (``prewarm_manifest`` is refused)."""
        if self.warm_samples is not None:
            replica.warm(
                self.warm_samples, pack_plan=self.pack_plan
            )
            return "compile"
        return (replica.warm_stats or {}).get("source", "none")

    def _scale_down(self, now: float, n: int, load: float, alerts) -> dict:
        pool = self.router.pool()
        # Victim: fewest resident sessions first (least state to hand
        # over), then lowest depth; newest replica on ties — founding
        # replicas stick around longest.
        victim = min(
            pool,
            key=lambda r: (
                r.server.resident_sessions(),
                r.server.depth(),
                -r.replica_id,
            ),
        )
        rid = victim.replica_id
        with self._lock:
            self._last_down = now
            self._calm_ticks = 0
            self._last_hold = None
            self._scale_downs += 1
        self._decision(
            "scale_down", "calm", n - 1, replica=rid, load=load,
            alerts=alerts,
        )
        self.router.remove_replica(
            rid, timeout_s=self.drain_timeout_s, reason="scale_in"
        )
        with self._lock:
            slot = self._slot_of.pop(rid, None)
            if slot is not None:
                self._free_slots.append(slot)
                self._free_slots.sort()
        self._note_pool_size(n - 1, self._clock())
        self._event(
            events.SCALE_DOWN,
            replica=rid,
            pool=n - 1,
            reason="calm",
            load=load,
        )
        return {"action": "scale_down", "replica": rid, "pool": n - 1}

    def _heal(self, now: float, pool) -> dict | None:
        """Replace dead/wedged/breaker-stuck replicas. Dead replicas
        replace immediately; the others after ``heal_after_s`` of
        sustained unhealth (a breaker mid-cooldown or a transient stall
        must recover on its own first). Returns the decision when an
        action (or its veto) happened, None to fall through to the
        sizing rules."""
        live_ids = set()
        condemned = None
        verdict_reason = ""
        for r in pool:
            rid = r.replica_id
            live_ids.add(rid)
            verdict = self.router.assess(r)
            if verdict.healthy or verdict.reason not in HEAL_REASONS:
                with self._lock:
                    self._unhealthy_since.pop(rid, None)
                continue
            dead = verdict.reason == "dead"
            with self._lock:
                since = self._unhealthy_since.setdefault(rid, now)
            if condemned is None and (
                dead or now - since >= self.heal_after_s
            ):
                condemned = r
                verdict_reason = verdict.reason
        with self._lock:
            for rid in list(self._unhealthy_since):
                if rid not in live_ids:
                    self._unhealthy_since.pop(rid)
            last_heal = self._last_heal
        if condemned is None:
            return None
        n = len(pool)
        if n == 1:
            # remove_replica refuses the last replica; a 1-replica pool
            # heals by scaling OUT first (next tick's pressure path) —
            # veto with the honest reason.
            return self._hold(now, n, "last_replica", None, [])
        if now - last_heal < self.cooldown_s:
            return self._hold(now, n, "cooldown_heal", None, [])
        rid = condemned.replica_id
        t0 = self._clock()
        self.router.remove_replica(
            rid,
            timeout_s=self.drain_timeout_s,
            reason=f"heal_{verdict_reason}",
        )
        with self._lock:
            slot = self._slot_of.pop(rid, 0)
            new_id = self._next_id
            self._next_id += 1
            self._unhealthy_since.pop(rid, None)
        try:
            replica = self.replica_factory(new_id, slot)
            self._warm_before_join(replica, slot)
            self.router.add_replica(replica)
        except Exception as err:  # noqa: BLE001 — a failed rebuild must not kill the loop
            with self._lock:
                self._free_slots.append(slot)
                self._free_slots.sort()
                self._errors += 1
                # Stamp the heal cooldown even on failure: a
                # persistently failing factory must retry at cooldown
                # cadence — condemning one replica per TICK would
                # dismantle the pool during a transient storm.
                self._last_heal = now
            self._decision(
                "hold", f"replace_failed:{type(err).__name__}", n - 1,
                replica=rid, detail=str(err),
            )
            return {"action": "error", "reason": str(err)}
        with self._lock:
            self._slot_of[new_id] = slot
            self._last_heal = now
            self._replaces += 1
            self._last_hold = None
        self._decision(
            "replace", verdict_reason, len(self.router.pool()),
            replica=rid,
        )
        self._event(
            events.REPLICA_REPLACE,
            from_replica=rid,
            to_replica=new_id,
            reason=verdict_reason,
            pool=len(self.router.pool()),
            seconds=self._clock() - t0,
        )
        return {
            "action": "replace", "from_replica": rid,
            "to_replica": new_id, "reason": verdict_reason,
        }

    def _hold(
        self, now: float, n: int, guard: str, load, alerts
    ) -> dict:
        """A wanted move was vetoed by a stability guard. Emitted as an
        ``autoscale_decision`` EDGE (the first veto for this guard;
        steady vetoes stay silent — the event stream must not spam one
        record per tick of a long cooldown)."""
        with self._lock:
            self._holds += 1
            edge = self._last_hold != guard
            self._last_hold = guard
        if edge:
            self._decision("hold", guard, n, load=load, alerts=alerts)
        return {"action": "hold", "reason": guard, "pool": n}

    # -- bookkeeping --------------------------------------------------------

    def _note_pool_size(self, n: int, now: float) -> None:
        with self._lock:
            if self._rs_since is not None:
                self._rs_total += (now - self._rs_since) * self._rs_size
            self._rs_since, self._rs_size = now, n

    def replica_seconds(self, now: float | None = None) -> float:
        """The pool-size integral so far — the capacity actually paid
        for, the number to hold against a static pool."""
        now = self._clock() if now is None else now
        with self._lock:
            total = self._rs_total
            if self._rs_since is not None:
                total += (now - self._rs_since) * self._rs_size
            return total

    def _decision(
        self, action: str, reason: str, pool_n: int, *, replica=None,
        load=None, alerts=None, detail=None,
    ) -> None:
        self._event(
            events.AUTOSCALE_DECISION,
            action=action,
            reason=reason,
            pool=pool_n,
            min=self.min_replicas,
            max=self.max_replicas,
            **({"replica": replica} if replica is not None else {}),
            **({"load": round(load, 3)} if load is not None else {}),
            **({"alerts": alerts} if alerts else {}),
            **({"detail": detail} if detail else {}),
        )

    def _event(self, event: str, **fields) -> None:
        if self.sink is not None:
            self.sink.log(event=event, **fields)

    def stats(self) -> dict:
        """The run.json ``autoscale`` block."""
        with self._lock:
            return {
                "min": self.min_replicas,
                "max": self.max_replicas,
                "interval_s": self.interval_s,
                "cooldown_s": self.cooldown_s,
                "ticks": self._ticks,
                "scale_ups": self._scale_ups,
                "scale_downs": self._scale_downs,
                "replaces": self._replaces,
                "holds": self._holds,
                "errors": self._errors,
                **(
                    {"last_error": self._last_tick_error}
                    if self._last_tick_error
                    else {}
                ),
                "pool": self._rs_size,
            }

    # -- thread lifecycle ---------------------------------------------------

    def start(self) -> "AutoscaleController":
        if self._thread is not None:
            raise RuntimeError("controller already started")
        self._thread = threading.Thread(
            target=self._run, name="gnot-autoscaler", daemon=True
        )
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.tick()
            except Exception as err:  # noqa: BLE001 — one bad tick must not end elasticity
                with self._lock:
                    self._errors += 1
                    first = self._last_tick_error is None
                    self._last_tick_error = f"{type(err).__name__}: {err}"
                if first:
                    # Elasticity silently dying would be invisible
                    # until the post-run stats; put the FIRST failure
                    # in the event stream (repeats stay counted only).
                    self._decision(
                        "hold",
                        f"tick_failed:{type(err).__name__}",
                        len(self.router.pool()),
                        detail=str(err),
                    )

    def close(self) -> dict:
        """Stop the loop and settle the replica-seconds ledger.
        Idempotent. Returns ``stats()``."""
        with self._lock:
            closed, self._closed = self._closed, True
        if not closed:
            self._stop.set()
            t = self._thread
            if t is not None:
                t.join(timeout=max(5.0, 2 * self.interval_s))
                self._thread = None
            self._note_pool_size(
                len(self.router.pool()), self._clock()
            )
        return self.stats()
