"""Inference serving of the port (``gnot_tpu/serve/``'s server, replicas and
router):

* ``engine``: ``InferenceEngine``, validation, bucketed static-shape
  collate, the forward and the atomic weight swap;
* ``batcher``: per-bucket dynamic batching, with per-tenant WFQ
  sub-queues under a ``TenantPolicy``;
* ``policies``: deadlines, bounded admission, the circuit breaker, the
  tenant policy (weights, quotas, priority classes) and the router's
  placement policies and replica health policy;
* ``rollout``: stateful rollout sessions, their futures and the on-disk
  ``SessionStore``;
* ``server``: ``InferenceServer``, the worker loop composing the above,
  SIGTERM drain, hot reload (``CheckpointReloader``), the tenant plane and
  rollout sessions;
* ``replica``: ``EngineReplica``, ``build_replicas``, ``build_replica``
  (replicas sharing one card, each on its own CUDA stream);
* ``router``: ``ReplicaRouter`` (health, bucket affinity, the rolling
  reload, session migration, scale-in and scale-out, the pool summary).

The autoscaler, the program catalog, AOT prewarm and federation are not
ported (``ROADMAP.md``). The names of ``server``, ``replica`` and
``router`` load on first use: ``server`` imports the trainer, which
imports the engine from this package.
"""

from gnot_tpu_torch.serve import rollout  # noqa: F401
from gnot_tpu_torch.serve.batcher import Batcher  # noqa: F401
from gnot_tpu_torch.serve.engine import InferenceEngine  # noqa: F401
from gnot_tpu_torch.serve.policies import (  # noqa: F401
    DEFAULT_TENANT,
    PRIORITY_CLASSES,
    ROUTE_POLICIES,
    AdmissionController,
    CircuitBreaker,
    Deadline,
    HealthVerdict,
    ReplicaHealthPolicy,
    TenantPolicy,
)
from gnot_tpu_torch.serve.rollout import (  # noqa: F401
    RolloutFuture,
    RolloutResult,
    RolloutSession,
    SessionStore,
    advance_sample,
    offline_rollout,
)

_LAZY = {
    "CheckpointReloader": "server",
    "InferenceServer": "server",
    "ServeResult": "server",
    "EngineReplica": "replica",
    "build_replica": "replica",
    "build_replicas": "replica",
    "ReplicaRouter": "router",
}


def __getattr__(name: str):
    if name in _LAZY:
        import importlib

        return getattr(importlib.import_module(f"{__name__}.{_LAZY[name]}"), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
