"""Inference serving of the port (``gnot_tpu/serve/``'s single server):

* ``engine``: ``InferenceEngine``, validation, bucketed static-shape
  collate, the forward and the atomic weight swap;
* ``batcher``: per-bucket dynamic batching, with per-tenant WFQ
  sub-queues under a ``TenantPolicy``;
* ``policies``: deadlines, bounded admission, the circuit breaker and the
  tenant policy (weights, quotas, priority classes);
* ``rollout``: stateful rollout sessions, their futures and the on-disk
  ``SessionStore``;
* ``server``: ``InferenceServer``, the worker loop composing the above,
  SIGTERM drain, hot reload (``CheckpointReloader``), the tenant plane and
  rollout sessions.

Replicas, the router, the autoscaler, the program catalog, AOT prewarm
and federation are not ported (``ROADMAP.md``). The server's names load
on first use: ``server`` imports the trainer, which imports the engine
from this package.
"""

from gnot_tpu_torch.serve import rollout  # noqa: F401
from gnot_tpu_torch.serve.batcher import Batcher  # noqa: F401
from gnot_tpu_torch.serve.engine import InferenceEngine  # noqa: F401
from gnot_tpu_torch.serve.policies import (  # noqa: F401
    DEFAULT_TENANT,
    PRIORITY_CLASSES,
    AdmissionController,
    CircuitBreaker,
    Deadline,
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

_SERVER_NAMES = ("CheckpointReloader", "InferenceServer", "ServeResult")


def __getattr__(name: str):
    if name in _SERVER_NAMES:
        from gnot_tpu_torch.serve import server

        return getattr(server, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
