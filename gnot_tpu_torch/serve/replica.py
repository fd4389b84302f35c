"""Engine replicas: N ``InferenceEngine``s behind the router.

Port of ``gnot_tpu/serve/replica.py``. One engine drives one worker loop:
one queue, one failure domain. The replica tier multiplies that. JAX gives
each replica its own slice of the TPU devices; the port has one card, so
its replicas share it, each with its own engine, its own copy of the
weights on the card (a rolling reload swaps one replica at a time), its
own worker thread (its server's) and, on ``cuda``, its own
``torch.cuda.Stream``, which the engine enters around each of its calls on
whatever thread makes them. The copy is made on the builder's stream, and
the replica's stream waits for it before its first dispatch. On the CPU
there are no streams and the same code runs without them. Replicas never
talk to each other: the router's placement is their only coupling
(``serve/router.py``).

``EngineReplica`` carries the state the router routes on:

* bucket affinity: the bucket keys this replica has served (seeded by
  ``warm()``, extended when the router assigns it a cold bucket). In JAX a
  bucket's first dispatch compiles its program; keeping each bucket on one
  replica keeps that compile off the rest of the pool. The port compiles
  nothing, but keeps the policy, so the two route alike;
* ``warming``: set by the rolling reload while this replica's weights swap;
* ``retiring``: set by a scale-in while the replica drains out of the pool;
* ``warm_stats``: how the replica became serve-ready, JAX's ``source``
  ("compile", JAX's name for the cold path, here the warm-up dispatches),
  ``programs`` and ``seconds``, without JAX's compile-cache ``hits`` and
  ``misses`` (eager PyTorch has no compile cache).

``prewarm_from`` (hydrating AOT executables from a deploy manifest) is not
ported: eager PyTorch has no executable to serialize.

Thread-safety: the affinity set and the flags are read by every submitting
thread and written by the router and reload threads, all under the
replica's lock.
"""

from __future__ import annotations

import copy
import threading
import time
from typing import Sequence

import torch

from gnot_tpu_torch.config import NotPortedError
from gnot_tpu_torch.data.batch import MeshSample, PackPlan
from gnot_tpu_torch.models.gnot import GNOT
from gnot_tpu_torch.serve.engine import InferenceEngine
from gnot_tpu_torch.serve.server import PACKED_BUCKET


class EngineReplica:
    """One engine and its routing state. The router attaches the
    replica's ``InferenceServer`` (``attach_server``) and reads
    ``has_bucket`` / ``warming`` / ``retiring`` and the server's probes at
    every placement."""

    def __init__(self, replica_id: int, engine: InferenceEngine):
        self.replica_id = replica_id
        self.engine = engine
        self.server = None  # the InferenceServer, attached by the router
        self._lock = threading.Lock()
        self._buckets: set = set()  #: guarded_by _lock
        self._warming = False  #: guarded_by _lock
        self._retiring = False  #: guarded_by _lock
        self._warm_stats: dict | None = None  #: guarded_by _lock

    def attach_server(self, server) -> "EngineReplica":
        self.server = server
        return self

    # -- affinity ----------------------------------------------------------

    def warm(self, samples: Sequence[MeshSample], *, rows: int | None = None,
             pack_plan: PackPlan | None = None) -> int:
        """One warm-up dispatch per bucket in ``samples`` (and one packed
        dispatch with a plan), on the replica's stream, on the calling
        thread; seeds the affinity set with the warmed keys and records
        ``warm_stats``. Returns the dispatches made."""
        t0 = time.monotonic()
        warmed = self.engine.warmup(samples, rows=rows)
        keys = {self.engine.bucket_key(s) for s in samples}
        if pack_plan is not None:
            warmed += self.engine.warmup_packed(samples, pack_plan)
            keys.add(PACKED_BUCKET)
        stats = {"source": "compile", "programs": warmed, "seconds": time.monotonic() - t0}
        with self._lock:
            self._buckets |= keys
            self._warm_stats = stats
        return warmed

    def prewarm_from(self, manifest: dict, *, snapshot_dir: str | None = None) -> dict:
        """JAX hydrates AOT-compiled executables here; not ported."""
        raise NotPortedError(
            "EngineReplica.prewarm_from (--serve_prewarm: AOT executable snapshots) has no "
            "counterpart: eager PyTorch has no compiled executable to serialize; warm() "
            "dispatches each bucket instead")

    @property
    def warm_stats(self) -> dict | None:
        with self._lock:
            return dict(self._warm_stats) if self._warm_stats else None

    def has_bucket(self, key) -> bool:
        with self._lock:
            return key in self._buckets

    def note_bucket(self, key) -> None:
        """The router assigned this replica a cold bucket: recorded before
        the request dispatches, so later requests of the bucket follow."""
        with self._lock:
            self._buckets.add(key)

    # -- the drain flags ----------------------------------------------------

    @property
    def warming(self) -> bool:
        with self._lock:
            return self._warming

    def set_warming(self, value: bool) -> None:
        with self._lock:
            self._warming = value

    @property
    def retiring(self) -> bool:
        with self._lock:
            return self._retiring

    def set_retiring(self, value: bool) -> None:
        with self._lock:
            self._retiring = value


def build_replicas(model: GNOT, n_replicas: int, *, batch_size: int,
                   devices: Sequence[torch.device] | None = None,
                   dtype: str = "float32") -> list[EngineReplica]:
    """``n_replicas`` replicas of ``model``'s weights, replica ``i`` on
    ``devices[i]``; by default every replica on ``model``'s own device, the
    one card they then share. ``batch_size`` is the serving dispatch's row
    count; ``dtype`` the serving compute dtype."""
    if n_replicas < 1:
        raise ValueError(f"n_replicas must be >= 1, got {n_replicas}")
    if devices is None:
        devices = [next(model.parameters()).device] * n_replicas
    devices = list(devices)
    if n_replicas > len(devices):
        raise ValueError(
            f"{n_replicas} replicas need at least one device each; only {len(devices)} visible")
    return [build_replica(model, i, devices[i], batch_size=batch_size, dtype=dtype)
            for i in range(n_replicas)]


def build_replica(model: GNOT, replica_id: int, device: torch.device | str, *,
                  batch_size: int, dtype: str = "float32") -> EngineReplica:
    """One replica on ``device``, the scale-out unit: a copy of ``model``'s
    weights there (``model`` itself is never changed or served), an engine
    at ``dtype`` and, on ``cuda``, the replica's own stream, which waits
    for the copy before it runs anything."""
    device = torch.device(device)
    weights = copy.deepcopy(model).to(device)
    stream = torch.cuda.Stream(device=device) if device.type == "cuda" else None
    engine = InferenceEngine(weights, batch_size=batch_size, dtype=dtype, stream=stream)
    if stream is not None:
        # The copies (and a bf16 cast) ran on the builder's stream.
        stream.wait_stream(torch.cuda.current_stream(device))
    return EngineReplica(replica_id, engine)
