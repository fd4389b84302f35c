"""Serving robustness policies: request deadlines, bounded-queue admission
and a circuit breaker.

The port of the single-server part of ``gnot_tpu/serve/policies.py``
(``Deadline``, ``AdmissionController``, ``CircuitBreaker``), with the same
semantics. Each is deterministic given an injectable ``clock`` (tests pass
a fake one; serving uses ``time.monotonic``), holds no thread of its own
and decides one thing; the server composes them. ``TenantPolicy`` waits
for the tenant slice, ``ReplicaHealthPolicy`` for the router
(``ROADMAP.md``). Stdlib only.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable


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
