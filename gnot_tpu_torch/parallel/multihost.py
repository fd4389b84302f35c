"""Multi-process training over ``torch.distributed``: one process a rank.

Port of ``gnot_tpu/parallel/multihost.py``. JAX runs one process per
host, each driving its local chips, and one global mesh across them; the
port runs one process per rank (a point of the mesh), launched by
``torchrun`` (``python -m torch.distributed.run``), whose environment
(``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``,
``GROUP_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``) ``initialize`` reads.
Without that environment the run is a world of one and every collective
here returns at once, as JAX's helpers do in a single process.

Two counts, which JAX's one process count covers:

* ranks (``process_count`` / ``process_index``): the processes. The stop
  and restore agreements (``sync_flag``, ``all_agree``), the straggler
  gauge and the rank-0-only sinks count these.
* nodes (``node_count`` / ``node_index``, ``torchrun --nnodes``): the
  hosts. Per-host sample sharding (``shard_samples``) and the hybrid
  mesh's data axis count these: on one node sharding is the identity.

The backend (``backend_for``): gloo for CPU tensors; NCCL when each rank
of a node has its own card; gloo with CUDA tensors when the ranks of a
node outnumber its cards and so share one (NCCL refuses two ranks on one
device). ``initialize`` prints the choice on rank 0's ``Distributed:``
line; the tensors stay on the card either way.
"""

from __future__ import annotations

import datetime
import hashlib
import os
from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist

from gnot_tpu_torch.config import MeshConfig

#: Bound of every collective's wait (``init_process_group(timeout=...)``):
#: a rank that never comes fails the others after this long, not never.
DEFAULT_TIMEOUT_S = float(os.environ.get("GNOT_DIST_TIMEOUT_S", "300"))

_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def _env_int(name: str, default: int) -> int:
    value = os.environ.get(name)
    return int(value) if value not in (None, "") else default


def launched() -> bool:
    """Whether the environment describes a ``torchrun``-style launch."""
    return all(os.environ.get(k) for k in _ENV)


def _managed_job_hint() -> str | None:
    """Name the env evidence of a multi-process job, or None
    (``gnot_tpu/parallel/multihost.py::_managed_job_hint``)."""
    ntasks = os.environ.get("SLURM_NTASKS")
    if ntasks and int(ntasks) > 1:
        return f"SLURM_NTASKS={ntasks}"
    world = os.environ.get("OMPI_COMM_WORLD_SIZE")
    if world and int(world) > 1:
        return f"OMPI_COMM_WORLD_SIZE={world}"
    hosts = os.environ.get("TPU_WORKER_HOSTNAMES")
    if hosts and "," in hosts:
        return f"TPU_WORKER_HOSTNAMES={hosts}"
    return None


def backend_for(device_type: str, local_world: int, n_cards: int) -> str:
    """gloo on the CPU; NCCL when each of a node's ``local_world`` ranks has
    its own card; gloo (with CUDA tensors) when they share cards."""
    if device_type == "cpu":
        return "gloo"
    return "nccl" if local_world <= n_cards else "gloo"


def rank_device(device: torch.device) -> torch.device:
    """This rank's device: the CPU, or on the card ``cuda:(LOCAL_RANK mod
    cards)``: its own card under NCCL, the shared one under gloo."""
    if device.type != "cuda" or not launched():
        return device
    return torch.device("cuda", _env_int("LOCAL_RANK", 0) % max(1, torch.cuda.device_count()))


def initialize(device: torch.device | str = "cuda", *,
               timeout_s: float = DEFAULT_TIMEOUT_S) -> str | None:
    """Join the process group ``torchrun``'s environment describes and
    return its backend; ``None`` for a world of one (no environment), as
    ``jax.distributed.initialize`` degrades to a single process. A
    managed multi-process job (SLURM, Open MPI, a TPU pod) without that
    environment raises instead: p independent single-process runs would
    race on the same checkpoint and metrics paths."""
    if dist.is_initialized():
        return dist.get_backend()
    if not launched():
        managed = _managed_job_hint()
        if managed:
            raise RuntimeError(
                f"no torchrun environment ({'/'.join(_ENV)}) but the environment "
                f"advertises a multi-process job ({managed}); refusing to "
                "degrade to p independent single-process runs"
            )
        return None
    device = torch.device(device)
    n_cards = torch.cuda.device_count() if device.type == "cuda" else 0
    local_world = _env_int("LOCAL_WORLD_SIZE", _env_int("WORLD_SIZE", 1))
    backend = backend_for(device.type, local_world, n_cards)
    if device.type == "cuda":
        torch.cuda.set_device(rank_device(device))
    dist.init_process_group(
        backend, init_method="env://", timeout=datetime.timedelta(seconds=timeout_s),
    )
    if dist.get_rank() == 0:
        print(
            f"Distributed: backend={backend} ranks={dist.get_world_size()} "
            f"nodes={node_count()} device={device.type}"
            + (f" (ranks share {n_cards} card(s): gloo with CUDA tensors)"
               if device.type == "cuda" and backend == "gloo" else "")
        )
    return backend


def shutdown() -> None:
    """Leave the process group, if any (every rank calls it)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def node_count() -> int:
    """Hosts of the launch (``torchrun --nnodes``): ranks over ranks a node."""
    if not dist.is_initialized():
        return 1
    local = _env_int("LOCAL_WORLD_SIZE", dist.get_world_size())
    return max(1, dist.get_world_size() // max(1, local))


def node_index() -> int:
    if not dist.is_initialized():
        return 0
    return _env_int("GROUP_RANK", dist.get_rank() // max(
        1, _env_int("LOCAL_WORLD_SIZE", dist.get_world_size())))


def make_hybrid_mesh(cfg: MeshConfig):
    """The global mesh over every rank of every node, ``gnot_tpu``'s
    ``make_hybrid_mesh``: ``cfg.data`` is the TOTAL data degree, factored
    as nodes x per-node, and seq/model/expert/pipe stay inside a node.
    ``torchrun`` numbers a node's ranks consecutively, so the row-major
    mesh of ``make_mesh`` is that layout; this adds JAX's checks."""
    from gnot_tpu_torch.parallel.mesh import make_mesh

    n_nodes = node_count()
    if n_nodes > 1:
        local = process_count() // n_nodes
        rest = cfg.seq * cfg.model * cfg.expert * cfg.pipe
        if local % rest:
            raise ValueError(
                f"seq*model*expert*pipe={rest} must divide the {local} "
                "local devices (SP/TP/EP/PP must not cross hosts)"
            )
        if cfg.data > 0 and cfg.data % n_nodes:
            raise ValueError(
                f"total data degree {cfg.data} must be divisible by the "
                f"{n_nodes} processes"
            )
    return make_mesh(cfg, nodes=n_nodes)


def shard_samples(
    samples: Sequence,
    *,
    process_index: int | None = None,
    process_count: int | None = None,
) -> list:
    """This host's strided shard of the dataset (every host must call with
    the same ``samples`` order). The host is the node: every rank of a
    node keeps the node's shard."""
    i = node_index() if process_index is None else process_index
    n = node_count() if process_count is None else process_count
    return list(samples)[i::n]


def _flag_device() -> torch.device:
    """Where a small host value crosses the group: the card under NCCL."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def per_host_gauge(value: float) -> np.ndarray:
    """All-gather one float from every rank into a ``[process_count]`` f32
    array in rank order: the straggler gauge (each rank's step time; rank 0
    logs the max-min skew). COLLECTIVE. A world of one returns ``[value]``."""
    if process_count() == 1:
        return np.asarray([value], np.float32)
    t = torch.tensor([float(value)], dtype=torch.float32, device=_flag_device())
    out = [torch.empty_like(t) for _ in range(process_count())]
    dist.all_gather(out, t)
    return torch.cat(out).cpu().numpy()


def sync_flag(value: bool) -> bool:
    """All-reduce OR of one rank-local boolean over every rank: a SIGTERM
    landing on ONE rank stops EVERY rank on the same step, or the others
    hang in the next collective. COLLECTIVE: every rank calls it together
    (the SPMD loop keeps the cadence). A world of one returns ``value``."""
    if process_count() == 1:
        return bool(value)
    t = torch.tensor([int(bool(value))], dtype=torch.int32, device=_flag_device())
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


def all_agree(token: str) -> bool:
    """Whether every rank holds the same ``token``: the checkpoint restore
    walk's guard (train/checkpoint.py), so ranks that would load different
    candidates fail loudly instead of diverging. COLLECTIVE. A world of
    one returns True."""
    if process_count() == 1:
        return True
    digest = torch.tensor(list(hashlib.md5(token.encode()).digest()), dtype=torch.int32,
                          device=_flag_device())
    out = [torch.empty_like(digest) for _ in range(process_count())]
    dist.all_gather(out, digest)
    return all(torch.equal(o, out[0]) for o in out)


def global_batch(mesh, local_batch, *, stacked: bool = False):
    """This rank's block of the global batch that the nodes' local batches
    make (the batch axis concatenates across nodes in node order): rows by
    the rank's data coordinate within its node, points by its seq
    coordinate. ``stacked=True`` for K-step stacked batches. On one node it
    is ``mesh.shard_batch``'s block of the one batch."""
    from gnot_tpu_torch.parallel.mesh import shard_batch

    return shard_batch(mesh, local_batch, stacked=stacked)
