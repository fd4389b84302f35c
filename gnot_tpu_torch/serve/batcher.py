"""Dynamic request batching with per-bucket flush discipline.

Port of ``gnot_tpu/serve/batcher.py::Batcher``. Requests queue per BUCKET (the engine's ``bucket_key``, the static
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

Tenant mode (``tenants=`` a ``policies.TenantPolicy``): each bucket holds
per-tenant FIFO sub-queues drained by weighted fair queueing, as JAX's
are: strict priority tiers first (every ``interactive`` tenant before any
``batch`` one), then deficit round robin by weight within a tier, FIFO
within a tenant, the ring rotated past the last tenant served. Age is per
request across every sub-queue, so ``max_wait_ms`` bounds the wait of the
lowest-weight tenant's head too; a ``take_fn`` cuts the WFQ order.
``tenants=None`` is the single-FIFO batcher above, unchanged.

Pure data structure — no thread, no lock, no clock of its own (callers
pass ``now``); exactly one worker loop drives each instance.
"""

from __future__ import annotations

from typing import Callable, Hashable, Iterable


class _TenantQueues:
    """One bucket's per-tenant FIFO sub-queues and its WFQ ring (the
    tenant service order, rotated past the last tenant served after each
    cut)."""

    __slots__ = ("queues", "ring")

    def __init__(self):
        self.queues: dict[Hashable, list] = {}  # tenant -> [(req, arrival)]
        self.ring: list = []

    def size(self) -> int:
        return sum(len(q) for q in self.queues.values())

    def oldest(self) -> float:
        """The oldest arrival across every sub-queue (each head is its
        queue's oldest): the whole bucket's per-request age clock."""
        return min(q[0][1] for q in self.queues.values() if q)

    def add(self, tenant, request, now: float) -> None:
        q = self.queues.get(tenant)
        if q is None:
            q = self.queues[tenant] = []
            self.ring.append(tenant)
        q.append((request, now))

    def prune(self) -> None:
        for t in [t for t, q in self.queues.items() if not q]:
            del self.queues[t]
            self.ring.remove(t)


class Batcher:
    """Groups queued requests per bucket; flush on size or age.
    ``tenant_fn(request)`` names a request's tenant in tenant mode."""

    def __init__(
        self,
        *,
        max_batch: int,
        max_wait_ms: float,
        key_fn: Callable[[object], Hashable],
        take_fn: Callable[[Hashable, list], int | None] | None = None,
        tenants=None,
        tenant_fn: Callable[[object], Hashable] | None = None,
    ):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if max_wait_ms < 0:
            raise ValueError(f"max_wait_ms must be >= 0, got {max_wait_ms}")
        self.max_batch = max_batch
        self.max_wait_s = max_wait_ms / 1e3
        self.key_fn = key_fn
        self.take_fn = take_fn
        self.tenants = tenants
        self.tenant_fn = tenant_fn or (lambda r: getattr(r, "tenant", None))
        # Per-bucket FIFO of (request, arrival) pairs, or in tenant mode a
        # _TenantQueues. Ages are per-request, so a leftover surviving a
        # size-based flush keeps its true arrival time and the max_wait
        # bound holds for it too.
        self._pending: dict[Hashable, list | _TenantQueues] = {}

    def __len__(self) -> int:
        if self.tenants is not None:
            return sum(b.size() for b in self._pending.values())
        return sum(len(v) for v in self._pending.values())

    def add(self, request, now: float) -> None:
        if self.tenants is not None:
            key = self.key_fn(request)
            b = self._pending.get(key)
            if b is None:
                b = self._pending[key] = _TenantQueues()
            b.add(self.tenant_fn(request), request, now)
            return
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
        an overfull bucket yields several batches in arrival order (in WFQ
        order in tenant mode)."""
        if self.tenants is not None:
            return self._pop_ready_wfq(now, flush_all)
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

    # -- tenant mode (WFQ) ---------------------------------------------------

    def _wfq_order(self, b: _TenantQueues) -> list:
        """The bucket's whole dispatch order as ``(tenant, request)`` pairs,
        without changing state: the interactive tier before the batch
        tier; within a tier deficit round robin (quantum = weight, cost 1
        a request, the deficit reset when a tenant's queue runs dry, so no
        banking while idle); FIFO within a tenant. A cut of n commits
        exactly the first n, so stopping early never reorders."""
        pol = self.tenants
        seq: list = []
        cursor = dict.fromkeys(b.ring, 0)
        for tier in ("interactive", "batch"):
            ring = [t for t in b.ring if pol.priority(t) == tier]
            deficit = dict.fromkeys(ring, 0.0)
            while any(cursor[t] < len(b.queues[t]) for t in ring):
                for t in ring:
                    q = b.queues[t]
                    if cursor[t] >= len(q):
                        deficit[t] = 0.0
                        continue
                    deficit[t] += pol.weight(t)
                    while cursor[t] < len(q) and deficit[t] >= 1.0:
                        seq.append((t, q[cursor[t]][0]))
                        cursor[t] += 1
                        deficit[t] -= 1.0
        return seq

    def _cut(self, b: _TenantQueues, seq: list, n: int) -> list:
        """Commit the first ``n`` of ``seq``: pop each tenant's head in
        order (the order is FIFO per tenant, so the heads are the requests
        emitted), rotate the ring past the last tenant served, prune the
        emptied sub-queues."""
        batch = [b.queues[t].pop(0)[0] for t, _ in seq[:n]]
        if n and len(b.ring) > 1:
            i = b.ring.index(seq[n - 1][0])
            b.ring = b.ring[i + 1:] + b.ring[: i + 1]
        b.prune()
        return batch

    def _pop_ready_wfq(self, now: float, flush_all: bool) -> list[tuple[Hashable, list]]:
        out: list[tuple[Hashable, list]] = []
        for key in list(self._pending):
            b = self._pending[key]
            while b.size():
                seq = self._wfq_order(b)
                take = None
                if self.take_fn is not None:
                    n = self.take_fn(key, [r for _, r in seq])
                    if n is not None:
                        take = max(1, min(n, len(seq)))
                # The oldest head anywhere in the bucket starts the flush
                # clock, whatever tenant WFQ favours.
                aged = now - b.oldest() >= self.max_wait_s
                if take is None:
                    if flush_all or len(seq) >= self.max_batch:
                        out.append((key, self._cut(b, seq, min(self.max_batch, len(seq)))))
                        continue
                    if aged:
                        # Aged flush of a partial bucket: take it all.
                        out.append((key, self._cut(b, seq, len(seq))))
                    break
                if flush_all or take < len(seq) or aged:
                    out.append((key, self._cut(b, seq, take)))
                    continue
                break
            if not b.size():
                self._pending.pop(key, None)
        return out

    def next_flush_in(self, now: float) -> float | None:
        """Seconds until the next age-based flush (0 when one is already
        due), or None when empty — the worker's poll timeout."""
        if not self._pending:
            return None
        if self.tenants is not None:
            due = min(b.oldest() for b in self._pending.values())
        else:
            due = min(q[0][1] for q in self._pending.values())
        return max(0.0, due + self.max_wait_s - now)

    def requests(self) -> Iterable:
        """All pending requests (the drain sweep)."""
        for q in self._pending.values():
            subs = q.queues.values() if isinstance(q, _TenantQueues) else (q,)
            for sub in subs:
                for r, _ in sub:
                    yield r
