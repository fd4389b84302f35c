"""Fault injection and automatic recovery of a training run, the port of
``gnot_tpu/resilience/`` (its trainer side):

* ``faults``: deterministic fault injection from ``--inject_fault``
  (NaN gradients or a bad sample at step k, SIGTERM at step k, transient
  checkpoint-I/O errors, a truncated ``latest`` checkpoint, a clean stop
  after epoch N), so every recovery path runs on the CPU in the tests.
* ``supervisor``: the recovery ladder of ``Trainer.fit``: a rolling
  last-good snapshot of the train state on the device every
  ``snapshot_every`` steps; a non-finite loss rolls back to it,
  quarantines the dispatch and goes on, within ``max_rollbacks``, then
  restores a checkpoint, then aborts.
* ``preemption``: SIGTERM / SIGINT stop at the next step boundary, save
  ``latest``, flush the sink and exit resume-ready.
* ``retry``: exponential backoff with jitter around checkpoint I/O.
"""

from gnot_tpu_torch.resilience.faults import (  # noqa: F401
    FaultInjector,
    FaultSpec,
    InjectedIOError,
    corrupt_checkpoint,
    corrupt_published,
    parse_fault_spec,
)
from gnot_tpu_torch.resilience.preemption import PreemptionHandler  # noqa: F401
from gnot_tpu_torch.resilience.retry import RetryPolicy, retry_io  # noqa: F401
from gnot_tpu_torch.resilience.supervisor import (  # noqa: F401
    NonFiniteLossError,
    PreemptionRequested,
    RecoverySupervisor,
)
