"""Serving robustness policies: request deadlines, bounded-queue admission
and a circuit breaker.

The port of ``gnot_tpu/serve/policies.py`` (``Deadline``,
``AdmissionController``, ``CircuitBreaker``, ``TenantPolicy``, and the
router's ``ROUTE_POLICIES`` and ``ReplicaHealthPolicy``), with the same
semantics. Each is deterministic given an injectable ``clock`` (tests pass
a fake one; serving uses ``time.monotonic``), holds no thread of its own
and decides one thing; the server and the router compose them. Stdlib
only.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable

from gnot_tpu_torch.config import parse_tenant_spec


@dataclasses.dataclass(frozen=True)
class Deadline:
    """An absolute monotonic expiry. Expired requests are shed before
    dispatch: no forward is spent on an answer nobody waits for."""

    at: float  # absolute clock() time

    def expired(self, now: float) -> bool:
        return now >= self.at

    def remaining_s(self, now: float) -> float:
        return max(0.0, self.at - now)

    def remaining_ms(self, now: float) -> float:
        """Milliseconds of budget left, the unit of the serve events and
        span args."""
        return self.remaining_s(now) * 1e3


class AdmissionController:
    """Bounded-queue admission: at most ``limit`` requests in the system
    (queued, batched or in dispatch). ``try_admit`` fast-fails a full
    queue in O(1) instead of growing a backlog that then misses every
    deadline."""

    def __init__(self, limit: int):
        if limit < 1:
            raise ValueError(f"admission limit must be >= 1, got {limit}")
        self.limit = limit
        self._n = 0
        self._lock = threading.Lock()

    @property
    def depth(self) -> int:
        return self._n

    def try_admit(self) -> bool:
        with self._lock:
            if self._n >= self.limit:
                return False
            self._n += 1
            return True

    def release(self) -> None:
        """One admitted request left the system (completed or shed)."""
        with self._lock:
            if self._n <= 0:
                raise RuntimeError("release() without a matching admit")
            self._n -= 1


#: The tenant of untagged traffic under an active ``TenantPolicy``: weight
#: 1, interactive, no quota. With no policy, requests carry no tenant.
DEFAULT_TENANT = "default"

#: Priority classes, highest first: under contention ``batch`` work waits
#: behind every ``interactive`` request.
PRIORITY_CLASSES = ("interactive", "batch")


class TenantPolicy:
    """Per-tenant WFQ weights, admission quotas and priority classes, from
    the three spec strings (``--tenant_weights interactive:3,batch:1``):

    * ``weight(t)``: the tenant's deficit-round-robin share within its
      priority tier (unlisted tenants weigh 1);
    * ``priority(t)``: ``"interactive"`` or ``"batch"``, the strict drain
      order under contention; unlisted tenants are interactive, but for
      one named ``batch``;
    * ``try_admit(t)`` / ``release(t)``: a bounded in-system count per
      tenant with a quota (one ``AdmissionController`` each, locked
      inside), an O(1) fast-fail; tenants without a quota are never
      limited.

    Weights and priorities are fixed at construction."""

    def __init__(self, *, weights=None, quotas=None, priorities=None):
        self.weights = {t: int(w) for t, w in dict(weights or {}).items()}
        self.quotas = {t: int(q) for t, q in dict(quotas or {}).items()}
        self.priorities = dict(priorities or {})
        for t, w in self.weights.items():
            if w < 1:
                raise ValueError(f"tenant weight for {t!r} must be >= 1, got {w}")
        for t, p in self.priorities.items():
            if p not in PRIORITY_CLASSES:
                raise ValueError(
                    f"tenant priority for {t!r} must be one of "
                    f"{PRIORITY_CLASSES}, got {p!r}"
                )
        # AdmissionController refuses a quota below 1.
        self._admission = {t: AdmissionController(q) for t, q in self.quotas.items()}

    @classmethod
    def from_specs(
        cls, weights: str = "", quotas: str = "", priorities: str = ""
    ) -> "TenantPolicy | None":
        """From the ``ServeConfig`` spec strings; None when all three are
        empty (tenant mode off)."""
        if not (weights or quotas or priorities):
            return None
        return cls(
            weights=parse_tenant_spec(weights, what="weight"),
            quotas=parse_tenant_spec(quotas, what="quota"),
            priorities=parse_tenant_spec(priorities, what="priority"),
        )

    @property
    def tenants(self) -> list[str]:
        """Every tenant a spec names, sorted (the SLO plane's tenants)."""
        return sorted(set(self.weights) | set(self.quotas) | set(self.priorities))

    def weight(self, tenant: str) -> int:
        return self.weights.get(tenant, 1)

    def priority(self, tenant: str) -> str:
        p = self.priorities.get(tenant)
        if p is None:
            p = "batch" if tenant == "batch" else "interactive"
        return p

    def quota(self, tenant: str) -> int | None:
        a = self._admission.get(tenant)
        return a.limit if a is not None else None

    def in_system(self, tenant: str) -> int:
        a = self._admission.get(tenant)
        return a.depth if a is not None else 0

    def try_admit(self, tenant: str) -> bool:
        """The per-tenant quota gate; True for a tenant without a quota."""
        a = self._admission.get(tenant)
        return True if a is None else a.try_admit()

    def release(self, tenant: str) -> None:
        """One of this tenant's admitted requests left the system."""
        a = self._admission.get(tenant)
        if a is not None:
            a.release()


#: The router's placement policies (``serve/router.py``): ``affinity``
#: (the default) prefers a replica that has already served the request's
#: bucket; ``least_loaded`` and ``round_robin`` are the yardsticks.
ROUTE_POLICIES = ("affinity", "least_loaded", "round_robin")


@dataclasses.dataclass(frozen=True)
class HealthVerdict:
    """One replica's routability: healthy replicas take new traffic,
    unhealthy ones are drained to their siblings (not shed); ``reason``
    names the signal ("ok", "trial", "warming", "breaker_open", "wedged",
    "dead", "retiring")."""

    healthy: bool
    reason: str


class ReplicaHealthPolicy:
    """A replica's routability from the signals the server already has,
    checked in this order:

    * ``dead``: the worker thread exited (or ``replica_kill`` fired);
    * ``retiring``: a scale-in is draining it out of the pool;
    * ``warming``: the rolling reload is swapping its weights;
    * ``breaker_open``: its circuit breaker is open; once the cooldown has
      passed (``breaker_trial_due``) it reads healthy, reason ``trial``, so
      the half-open trial dispatch can reach it;
    * ``wedged``: requests are in its system and its worker has not
      stamped progress for ``wedge_after_s``;
    * else ``ok``.

    Stateless: the router samples the signals and emits the
    ``replica_health`` edges."""

    def __init__(self, *, wedge_after_s: float = 2.0):
        if wedge_after_s <= 0:
            raise ValueError(f"wedge_after_s must be > 0, got {wedge_after_s}")
        self.wedge_after_s = wedge_after_s

    def assess(
        self,
        *,
        breaker_state: str,
        warming: bool,
        progress_age_s: float,
        depth: int,
        worker_alive: bool = True,
        breaker_trial_due: bool = False,
        retiring: bool = False,
    ) -> HealthVerdict:
        if not worker_alive:
            return HealthVerdict(False, "dead")
        if retiring:
            return HealthVerdict(False, "retiring")
        if warming:
            return HealthVerdict(False, "warming")
        if breaker_state == "open" and not breaker_trial_due:
            return HealthVerdict(False, "breaker_open")
        if depth > 0 and progress_age_s >= self.wedge_after_s:
            return HealthVerdict(False, "wedged")
        if breaker_state == "open":
            return HealthVerdict(True, "trial")
        return HealthVerdict(True, "ok")


class CircuitBreaker:
    """Trips open after ``threshold`` consecutive dispatch failures
    (non-finite outputs, device errors); while open, requests are
    rejected at once with a reason. After ``cooldown_s`` one trial
    dispatch is allowed (half-open): success closes the breaker, failure
    opens it for another cooldown.

    States: ``closed`` (serving), ``open`` (rejecting), ``half_open``
    (one trial in flight). Thread-safe; the server emits ``breaker_open``
    and ``breaker_close`` events on the transitions."""

    def __init__(
        self,
        *,
        threshold: int = 3,
        cooldown_s: float = 1.0,
        clock: Callable[[], float] = time.monotonic,
    ):
        if threshold < 1:
            raise ValueError(f"breaker threshold must be >= 1, got {threshold}")
        self.threshold = threshold
        self.cooldown_s = cooldown_s
        self._clock = clock
        self._lock = threading.Lock()
        self._state = "closed"
        self._failures = 0
        self._opened_at = 0.0
        self.trips = 0  # lifetime open transitions (serve_summary)

    @property
    def state(self) -> str:
        return self._state

    def trial_due(self) -> bool:
        """Would ``allow()`` admit a half-open trial now? The router's
        health check reads it to route one trial back to an open-breaker
        replica: a drained replica never dispatches, and ``allow`` is the
        only way out of ``open``."""
        with self._lock:
            return self._state == "open" and self._clock() - self._opened_at >= self.cooldown_s

    def allow(self) -> bool:
        """May a dispatch proceed now? Open: False until the cooldown has
        passed, then one half-open trial."""
        with self._lock:
            if self._state == "closed":
                return True
            if self._state == "open":
                if self._clock() - self._opened_at >= self.cooldown_s:
                    self._state = "half_open"
                    return True
                return False
            return False  # half_open: one trial at a time

    def record_success(self) -> bool:
        """True when this success closed a half-open breaker (the recovery
        transition, worth an event)."""
        with self._lock:
            recovered = self._state == "half_open"
            self._state = "closed"
            self._failures = 0
            return recovered

    def record_failure(self) -> bool:
        """True when this failure tripped the breaker open (the threshold
        reached, or a half-open trial failed)."""
        with self._lock:
            self._failures += 1
            should_open = self._state == "half_open" or self._failures >= self.threshold
            if should_open and self._state != "open":
                self._state = "open"
                self._opened_at = self._clock()
                self.trips += 1
                return True
            if should_open:  # already open: a later failure restarts the cooldown
                self._opened_at = self._clock()
            return False
