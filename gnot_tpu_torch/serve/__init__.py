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
  reload, session migration, scale-in and scale-out, the pool summary);
* ``catalog``: ``ProgramCatalog``, per-program costs joined with traffic
  (the capacity model);
* ``autoscaler``: ``AutoscaleController``, the self-healing elastic pool;
* ``federation``: ``HostAgent`` (one host's pool behind the versioned wire
  protocol), ``ClusterRouter`` (placement across hosts, the lease-based
  ``FailureDetector``, session re-migration, the merged cluster trace),
  ``build_local_federation`` and ``topology_key``;
* ``mesh_serve``: serving over a rank mesh (``--serve --distributed``):
  ``MeshEngine`` on rank 0, ``follow`` on the other ranks, the op
  protocol between them.

AOT prewarm is not ported (``ROADMAP.md``). The names of ``server``,
``replica``, ``router``, ``autoscaler`` and ``federation`` load on first
use: ``server`` imports the trainer, which imports the engine from this
package.
"""

from gnot_tpu_torch.serve import rollout  # noqa: F401
from gnot_tpu_torch.serve.batcher import Batcher  # noqa: F401
from gnot_tpu_torch.serve.catalog import (  # noqa: F401
    ProgramCatalog,
    bucket_program_key,
    packed_program_key,
)
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
    "AutoscaleController": "autoscaler",
    "HEAL_REASONS": "autoscaler",
    "PRESSURE_OBJECTIVES": "autoscaler",
    "ClusterRouter": "federation",
    "FailureDetector": "federation",
    "HostAgent": "federation",
    "build_local_federation": "federation",
    "topology_key": "federation",
}


def __getattr__(name: str):
    if name in _LAZY:
        import importlib

        return getattr(importlib.import_module(f"{__name__}.{_LAZY[name]}"), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
