"""InferenceServer core: admission, per-bucket batching, one worker.

Port of the core of ``gnot_tpu/serve/server.py::InferenceServer``:
``submit`` admits a request (bounded queue, fast-fail when full or
invalid), one worker thread drives Batcher -> ``engine.infer`` ->
resolved futures, and ``drain`` stops admission, flushes what is
queued, joins the worker and returns a summary. Every future resolves
on every path; a request is never left hanging.

Not ported yet: the circuit breaker, deadlines, tenants, rollout
sessions, fault injection, hot reload and tracing.
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

from gnot_tpu_torch.data.batch import MeshSample
from gnot_tpu_torch.serve.batcher import Batcher
from gnot_tpu_torch.serve.engine import InferenceEngine

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
    ):
        if queue_limit < 1:
            raise ValueError(f"queue_limit must be >= 1, got {queue_limit}")
        self.engine = engine
        self.max_batch = max_batch
        self.queue_limit = queue_limit
        self._clock = time.monotonic
        # Owned by the worker thread alone once start() ran.
        self.batcher = Batcher(
            max_batch=max_batch,
            max_wait_ms=max_wait_ms,
            key_fn=lambda r: engine.bucket_key(r.sample),
        )
        self._inbound: queue.Queue = queue.Queue()
        self._draining = threading.Event()
        self._worker: threading.Thread | None = None
        self.warmed = 0
        self._lock = threading.Lock()
        self._in_system = 0  #: guarded_by _lock
        self._submitted = 0  #: guarded_by _lock
        self._completed = 0  #: guarded_by _lock
        self._dispatches = 0  #: guarded_by _lock
        self._shed: dict[str, int] = {}  #: guarded_by _lock
        self._latency_ms: list[float] = []  #: guarded_by _lock
        self._dispatch_ms: list[float] = []  #: guarded_by _lock

    # -- client side -------------------------------------------------------

    def start(self, warmup: Sequence[MeshSample] = ()) -> "InferenceServer":
        """Start the worker. With ``warmup`` samples the worker first runs
        one dispatch per bucket among them (``engine.warmup``) and this
        returns once that is done (``self.warmed`` buckets). The warm-up
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
        with self._lock:
            self._submitted += 1
        if self._draining.is_set():
            return self._reject(fut, "rejected_draining", now)
        try:
            self.engine.validate([sample])
        except ValueError as err:
            return self._reject(fut, "rejected_invalid", now, str(err))
        # Enqueue under the same lock drain() sets its flag under: a put
        # serialized before the flag flips is seen by the worker's final
        # sweep, one serialized after it is rejected here.
        with self._lock:
            if self._draining.is_set():
                reason = "rejected_draining"
            elif self._in_system >= self.queue_limit:
                reason = "shed_queue_full"
            else:
                reason = None
                self._in_system += 1
                self._inbound.put(_Request(sample, fut, now))
        if reason is not None:
            return self._reject(fut, reason, now)
        return fut

    def _reject(self, fut: Future, reason: str, now: float, detail: str = "") -> Future:
        with self._lock:
            self._shed[reason] = self._shed.get(reason, 0) + 1
        fut.set_result(
            ServeResult(
                ok=False, reason=reason, detail=detail,
                latency_ms=(self._clock() - now) * 1e3,
            )
        )
        return fut

    def drain(self, timeout_s: float = 30.0) -> dict:
        """Graceful shutdown: stop admitting, flush every queued request
        through dispatch, join the worker, return the summary."""
        with self._lock:
            self._draining.set()
        if self._worker is not None:
            self._inbound.put(None)  # wake the worker
            self._worker.join(timeout=timeout_s)
            if self._worker.is_alive():
                # A dispatch is stuck past the budget; the worker still
                # owns the batcher, so report what we have.
                return self.summary()
        # The worker has exited (or never ran): resolve anything left.
        try:
            while True:
                item = self._inbound.get_nowait()
                if item is not None:
                    self._finish(item, ServeResult(ok=False, reason="rejected_draining"))
        except queue.Empty:
            pass
        for r in list(self.batcher.requests()):
            self._finish(r, ServeResult(ok=False, reason="rejected_draining"))
        return self.summary()

    def summary(self) -> dict:
        """Requests, completions, sheds, dispatches, distinct dispatch
        shapes and the host-clock latency of requests and dispatches."""
        with self._lock:
            return {
                "requests": self._submitted,
                "completed": self._completed,
                "shed": dict(self._shed),
                "dispatches": self._dispatches,
                "dispatch_shapes": self.engine.dispatch_shapes,
                "latency_ms_p50": _percentile(self._latency_ms, 50),
                "latency_ms_p99": _percentile(self._latency_ms, 99),
                "dispatch_ms_p50": _percentile(self._dispatch_ms, 50),
                "dispatch_ms_max": max(self._dispatch_ms, default=None),
            }

    # -- worker side -------------------------------------------------------

    def _run(self, warmup: list[MeshSample], ready: Future) -> None:
        try:
            ready.set_result(self.engine.warmup(warmup, rows=self.max_batch))
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
        """ONE engine dispatch for one bucket's batch, padded to
        ``max_batch`` rows; resolves every request of the batch."""
        pn, pf = key
        t0 = self._clock()
        with self._lock:
            self._dispatches += 1
        try:
            outs = self.engine.infer(
                [r.sample for r in reqs], pad_nodes=pn, pad_funcs=pf,
                rows=self.max_batch,
            )
        except Exception as err:  # noqa: BLE001 — the worker must keep serving
            traceback.print_exc()
            detail = f"{type(err).__name__}: {err}"
            for r in reqs:
                self._finish(r, ServeResult(ok=False, reason="error_dispatch", detail=detail))
            return
        with self._lock:
            self._dispatch_ms.append((self._clock() - t0) * 1e3)
        bad = sum(not np.all(np.isfinite(o)) for o in outs)
        for r, o in zip(reqs, outs):
            if bad:
                self._finish(
                    r,
                    ServeResult(
                        ok=False, reason="error_nan_output",
                        detail=f"non-finite outputs for {bad}/{len(reqs)} requests",
                    ),
                )
            else:
                self._finish(r, ServeResult(ok=True, reason="ok", output=o))

    def _finish(self, r: _Request, result: ServeResult) -> None:
        result.latency_ms = (self._clock() - r.submitted) * 1e3
        with self._lock:
            self._in_system -= 1
            if result.ok:
                self._completed += 1
                self._latency_ms.append(result.latency_ms)
            else:
                self._shed[result.reason] = self._shed.get(result.reason, 0) + 1
        r.future.set_result(result)
