"""Exponential-backoff retries for transient I/O.

A copy of ``gnot_tpu/resilience/retry.py``. Checkpoint storage is often
remote (NFS, an object-store mount) and flakes: a transient error on a
save or a restore must not kill an hours-long run when a retry a second
later would succeed. The policy is full-jitter exponential backoff
(delay_i = uniform(0, min(cap, base * 2**i))); the jitter decorrelates
the retries of many processes hitting the same filesystem together.

Defaults: 4 tries (1 + 3 retries), base 0.5 s, cap 8 s. Deterministic
callers (tests) pass ``sleep=lambda s: None``. Stdlib only.
"""

from __future__ import annotations

import dataclasses
import logging
import random
import time
from typing import Callable, Iterable

logger = logging.getLogger(__name__)

#: Exceptions treated as transient by default: filesystem/network-class
#: errors. ValueError/TypeError/pickle errors (corrupt content) are NOT
#: transient: retrying a truncated checkpoint re-reads the same bad
#: bytes; the checkpointer's fallback walk handles those instead.
TRANSIENT_ERRORS: tuple[type[BaseException], ...] = (OSError, IOError)

#: OSError subclasses that are PERMANENT: retrying a missing path or a
#: permission denial re-reads the same answer, so these surface at once
#: (a mistyped path must not sit through the whole backoff schedule, and
#: a missing checkpoint file must advance the fallback walk, not stall it).
PERMANENT_ERRORS: tuple[type[BaseException], ...] = (
    FileNotFoundError,
    PermissionError,
    NotADirectoryError,
    IsADirectoryError,
)


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    attempts: int = 4  # total tries: 1 initial + 3 retries
    base_delay_s: float = 0.5
    max_delay_s: float = 8.0

    def delays(self) -> Iterable[float]:
        for i in range(max(0, self.attempts - 1)):
            yield random.uniform(
                0.0, min(self.max_delay_s, self.base_delay_s * (2.0**i))
            )


def retry_io(
    fn: Callable,
    *,
    policy: RetryPolicy | None = None,
    transient: tuple[type[BaseException], ...] = TRANSIENT_ERRORS,
    describe: str = "io",
    on_retry: Callable[[int, BaseException], None] | None = None,
    sleep: Callable[[float], None] = time.sleep,
    deadline: float | None = None,
    clock: Callable[[], float] = time.monotonic,
):
    """Call ``fn()``; on a transient error, back off and retry up to
    ``policy.attempts`` tries in all. The final failure re-raises the
    LAST error. ``on_retry(attempt, exc)`` fires before each sleep (the
    checkpointer routes it to the sink as an ``io_retry`` event).

    ``deadline`` is an ABSOLUTE ``clock()`` time bounding the whole loop:
    backoff sleeps are clamped to the remaining budget and no retry starts
    past it; a deadline already passed when the next retry would start
    re-raises the last error at once.
    """
    policy = policy or RetryPolicy()
    delays = list(policy.delays())
    for attempt in range(policy.attempts):
        try:
            return fn()
        except transient as exc:
            if isinstance(exc, PERMANENT_ERRORS):
                raise
            if attempt >= policy.attempts - 1:
                raise
            delay = delays[attempt]
            if deadline is not None:
                remaining = deadline - clock()
                if remaining <= 0:
                    logger.warning(
                        "%s error and the caller's deadline has passed "
                        "(attempt %d/%d): %s — giving up without retrying",
                        describe, attempt + 1, policy.attempts, exc,
                    )
                    raise
                delay = min(delay, remaining)
            logger.warning(
                "transient %s error (attempt %d/%d): %s — retrying",
                describe, attempt + 1, policy.attempts, exc,
            )
            if on_retry is not None:
                on_retry(attempt + 1, exc)
            sleep(delay)
