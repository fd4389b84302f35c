"""Dynamic request batching with per-bucket flush discipline.

Port of ``gnot_tpu/serve/batcher.py::Batcher`` in its single-tenant
mode. Requests queue per BUCKET (the engine's ``bucket_key``, the static
pad shape their dispatch uses) and a bucket flushes when it holds
``max_batch`` requests or its oldest entry has waited ``max_wait_ms``.
A batch NEVER spans two buckets, and FIFO within a bucket keeps
per-bucket latency arrival-ordered.

``take_fn`` gives a bucket another size discipline (the packed serving
path): ``take_fn(key, requests)`` is how many of the bucket's FIFO
prefix fit one dispatch (a first-fit packer), or None for the
``max_batch`` rule. Such a bucket is full when that prefix is shorter
than its queue: one whole dispatch is ready and the next arrival
already spills.

Pure data structure — no thread, no lock, no clock of its own (callers
pass ``now``); exactly one worker loop drives each instance.
"""

from __future__ import annotations

from typing import Callable, Hashable, Iterable


class Batcher:
    """Groups queued requests per bucket; flush on size or age."""

    def __init__(
        self,
        *,
        max_batch: int,
        max_wait_ms: float,
        key_fn: Callable[[object], Hashable],
        take_fn: Callable[[Hashable, list], int | None] | None = None,
    ):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if max_wait_ms < 0:
            raise ValueError(f"max_wait_ms must be >= 0, got {max_wait_ms}")
        self.max_batch = max_batch
        self.max_wait_s = max_wait_ms / 1e3
        self.key_fn = key_fn
        self.take_fn = take_fn
        # Per-bucket FIFO of (request, arrival) pairs. Ages are
        # per-request, so a leftover surviving a size-based flush keeps
        # its true arrival time and the max_wait bound holds for it too.
        self._pending: dict[Hashable, list] = {}

    def __len__(self) -> int:
        return sum(len(v) for v in self._pending.values())

    def add(self, request, now: float) -> None:
        self._pending.setdefault(self.key_fn(request), []).append((request, now))

    def _take(self, key: Hashable, q: list) -> int | None:
        """How many of ``q``'s FIFO prefix the next dispatch takes under
        ``take_fn``, clamped to ``[1, len(q)]`` (a 0 from a degenerate
        packer must not wedge the queue); None for the ``max_batch``
        rule."""
        n = None if self.take_fn is None else self.take_fn(key, [r for r, _ in q])
        return None if n is None else max(1, min(n, len(q)))

    def pop_ready(
        self, now: float, *, flush_all: bool = False
    ) -> list[tuple[Hashable, list]]:
        """Flushable ``(bucket_key, requests)`` batches: full buckets
        always; aged buckets (oldest waiting >= max_wait); everything
        when ``flush_all`` (drain). Each batch holds at most
        ``max_batch`` requests from ONE bucket, or for a ``take_fn``
        bucket exactly the FIFO prefix its packer fits in one dispatch;
        an overfull bucket yields several batches in arrival order."""
        out: list[tuple[Hashable, list]] = []
        for key in list(self._pending):
            q = self._pending[key]
            aged = now - q[0][1] >= self.max_wait_s
            take = self._take(key, q)
            if take is None:
                if not (flush_all or len(q) >= self.max_batch or aged):
                    continue
                while q and (flush_all or len(q) >= self.max_batch):
                    out.append((key, [r for r, _ in q[: self.max_batch]]))
                    del q[: self.max_batch]
            else:
                if not (flush_all or take < len(q) or aged):
                    continue
                while q and (flush_all or take < len(q)):
                    out.append((key, [r for r, _ in q[:take]]))
                    del q[:take]
                    if q:
                        take = self._take(key, q)
            if q and not flush_all and now - q[0][1] >= self.max_wait_s:
                # Aged flush of a partial bucket: the oldest entry has
                # already waited its budget. (A take_fn bucket is cut down
                # to one whole dispatch by now.)
                out.append((key, [r for r, _ in q]))
                q.clear()
            if not q:
                del self._pending[key]
        return out

    def next_flush_in(self, now: float) -> float | None:
        """Seconds until the next age-based flush (0 when one is already
        due), or None when empty — the worker's poll timeout."""
        if not self._pending:
            return None
        due = min(q[0][1] for q in self._pending.values())
        return max(0.0, due + self.max_wait_s - now)

    def requests(self) -> Iterable:
        """All pending requests (the drain sweep)."""
        for q in self._pending.values():
            for r, _ in q:
                yield r
