"""Serving over a rank mesh: rank 0 serves, every other rank joins each
dispatch.

The port of JAX's serving on a one-process mesh of several devices
(``gnot_tpu/main.py::_run_serve`` through ``Trainer.inference_engine``:
a layout-aware forward with replicated outputs, the mesh batch placement,
the training data's fixed pad lengths). The port's ranks are JAX's
devices (``parallel/multihost.py``), so a one-node world of N ranks is
that mesh: every rank builds the same ``Trainer`` (the mesh, its checks,
its shards of the weights), rank 0 runs the whole serving tier over a
``MeshEngine``, and ranks 1..N-1 run ``follow`` and nothing else (no
server, no sink, no trace, no summary).

The op protocol, over the world group, one op at a time in one order on
every rank: rank 0 broadcasts a small header (a pickled dict: the op,
each tensor's name, shape, dtype and offset) and then one byte buffer
holding the tensors (``Wire``). Three ops:

* ``weights``: the whole standard-layout weights; every rank loads them
  into its trainer's layout and keeps its shards
  (``Trainer.load_standard_params``), then its serving copy
  (``serving_copy``: a cast copy of the shards below f32). The first
  publish and every hot reload are this op, so a reload reaches every
  rank before the next dispatch, and a reload that fails on rank 0 sends
  nothing: every rank keeps the old weights.
* ``dispatch``: the host batch (a ``MeshBatch`` or a ``PackedBatch``)
  collated on rank 0; each rank keeps its block (``Trainer._device_batch``:
  rows over ``data``, points over ``seq``), runs the model's mesh forward
  (the one ``Trainer.evaluate`` runs) and the output comes back whole,
  points over ``seq`` (``gather_points``) and rows over ``data``
  (``gather_rows``). Only dispatches that run reach the followers: sheds,
  deadlines, the breaker and the quotas act on rank 0 before the engine
  is called.
* ``stop``: the followers leave their loop. Rank 0 sends it on every way
  out (``MeshEngine.close`` in a ``finally``): the drain, the SIGTERM
  drain and an exception in warm-up, a dispatch or a reload.

A follower's wait is the group's timeout (``multihost.DEFAULT_TIMEOUT_S``);
a SIGTERM to a follower alone is recorded and does not end it: it leaves
on rank 0's stop op. A collective that fails on rank 0 (a dead follower)
marks the engine failed: every later op raises at once instead of
waiting, and the serve run raises after its drain.

Rows are padded to a multiple of the node's data ranks (JAX's
``group_pad``; on a pipe axis, times the microbatches); the pad lengths are the trainer's fixed ones, bucketed,
so point counts split over ``seq`` (JAX's "sequence parallelism requires
bucketed padding" check runs in the trainer). A packed dispatch splits its
rows over ``data`` and keeps its points whole on every ``seq`` rank, as
``shard_packed_batch`` does.
"""

from __future__ import annotations

import collections
import dataclasses
import statistics
import threading
import time

import torch
import torch.distributed as dist

from gnot_tpu_torch.data.batch import MeshBatch, PackedBatch, validate_samples
from gnot_tpu_torch.models import precision
from gnot_tpu_torch.models.gnot import apply_batch
from gnot_tpu_torch.parallel import mesh as mesh_lib
from gnot_tpu_torch.parallel import multihost
from gnot_tpu_torch.resilience.preemption import PreemptionHandler
from gnot_tpu_torch.serve.engine import InferenceEngine

OP_WEIGHTS, OP_DISPATCH, OP_STOP = "weights", "dispatch", "stop"
# Each tensor's bytes start at a multiple of this in the buffer, so every
# dtype's view of its slice is aligned.
_ALIGN = 16
_BATCHES = {"mesh": MeshBatch, "packed": PackedBatch}


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name.rpartition(".")[2])


def pack_tensors(tensors: dict) -> tuple[list, torch.Tensor]:
    """``(specs, buffer)``: every tensor of ``tensors`` (None kept as None)
    laid into one uint8 host buffer, each at an aligned offset."""
    specs, parts, size = [], [], 0
    for name, t in tensors.items():
        if t is None:
            specs.append((name, None))
            continue
        t = t.detach().contiguous()
        n = t.numel() * t.element_size()
        specs.append((name, tuple(t.shape), str(t.dtype), size, n))
        parts.append((size, n, t))
        size += -(-n // _ALIGN) * _ALIGN
    buf = torch.empty(size, dtype=torch.uint8)
    for off, n, t in parts:
        if n:
            buf[off:off + n].copy_(t.reshape(-1).view(torch.uint8))
    return specs, buf


def unpack_tensors(specs: list, buf: torch.Tensor) -> dict:
    """``pack_tensors``' tensors again, each a view of ``buf``."""
    out = {}
    for spec in specs:
        if spec[1] is None:
            out[spec[0]] = None
            continue
        name, shape, dtype, off, n = spec
        out[name] = buf[off:off + n].view(_dtype(dtype)).view(shape)
    return out


class Wire:
    """The op protocol's transport over the world group: a header object,
    then one byte buffer on ``device`` (the card under NCCL, the host under
    gloo). ``send`` is rank 0's, ``recv`` every other rank's; both are the
    one broadcast pair. A world of one sends nothing."""

    def __init__(self, device: torch.device):
        self.world = multihost.process_count()
        self.device = (torch.device("cuda", torch.cuda.current_device())
                       if self.world > 1 and dist.get_backend() == "nccl"
                       else torch.device("cpu"))
        self._object_device = self.device if self.device.type == "cuda" else None

    def send(self, header: dict, tensors: dict | None = None) -> None:
        if self.world == 1:
            return
        specs, buf = pack_tensors(tensors or {})
        box = [dict(header, specs=specs, nbytes=buf.numel())]
        dist.broadcast_object_list(box, src=0, device=self._object_device)
        if buf.numel():
            dist.broadcast(buf.to(self.device), src=0)

    def recv(self) -> tuple[dict, dict]:
        box = [None]
        dist.broadcast_object_list(box, src=0, device=self._object_device)
        header = box[0]
        buf = torch.empty(header["nbytes"], dtype=torch.uint8, device=self.device)
        if buf.numel():
            dist.broadcast(buf, src=0)
        return header, unpack_tensors(header["specs"], buf.cpu())


def batch_message(batch) -> tuple[dict, dict]:
    """A host batch as a dispatch op's header fields and tensors."""
    kind = "packed" if isinstance(batch, PackedBatch) else "mesh"
    tensors, scalars = {}, {}
    for f in dataclasses.fields(batch):
        value = getattr(batch, f.name)
        if value is None or isinstance(value, torch.Tensor):
            tensors[f.name] = value
        else:
            scalars[f.name] = value
    return {"op": OP_DISPATCH, "kind": kind, "scalars": scalars}, tensors


def batch_from(header: dict, tensors: dict):
    return _BATCHES[header["kind"]](**tensors, **header["scalars"])


#: Dispatches whose phase times a rank keeps for their medians.
RECENT = 1024
_PHASES = ("broadcast_ms", "forward_ms", "gather_ms")


def new_stats() -> dict:
    """A rank's serving counters: ops of each kind and their host ms: a
    dispatch's broadcast (rank 0's send; a follower's receive, its idle
    wait for the op included), forward and output gather, and a weights
    op's whole (send or receive, and the load); ``recent`` keeps the last
    ``RECENT`` dispatches' phase times."""
    return {"dispatches": 0, "weights": 0, "broadcast_ms": 0.0, "forward_ms": 0.0,
            "gather_ms": 0.0, "weights_ms": 0.0, "recent": collections.deque(maxlen=RECENT)}


def stats_summary(stats: dict) -> dict:
    """``stats`` as plain numbers: the counts and sums, and the median of
    each dispatch phase over the recent dispatches after the first (the
    first builds the card's and the backend's state)."""
    out = {k: v for k, v in stats.items() if k != "recent"}
    recent = list(stats["recent"])[1:] if stats["dispatches"] <= RECENT else stats["recent"]
    for i, phase in enumerate(_PHASES):
        out[f"{phase}_p50"] = statistics.median(r[i] for r in recent) if recent else None
    return out


def _record(stats: dict, broadcast_ms: float, forward_ms: float, gather_ms: float) -> None:
    stats["dispatches"] += 1
    for phase, ms in zip(_PHASES, (broadcast_ms, forward_ms, gather_ms)):
        stats[phase] += ms
    stats["recent"].append((broadcast_ms, forward_ms, gather_ms))


def serving_copy(model: torch.nn.Module, mesh, dtype: str) -> torch.nn.Module:
    """The model a rank dispatches: ``model`` itself for float32, else the
    same architecture at ``dtype`` holding a cast copy of this rank's
    shards (``precision.serve_model`` on a mesh: built on the meta device,
    sharded, then given the cast shards)."""
    if dtype == "float32":
        return model.eval()
    with torch.device("meta"):
        fresh = type(model)(dataclasses.replace(model.config, dtype=dtype))
    mesh_lib.shard_model(fresh, mesh)
    fresh.load_state_dict(precision.cast_params(model.state_dict(), dtype), strict=True,
                          assign=True)
    return fresh.eval()


def load_weights(trainer, state_dict: dict, dtype: str) -> torch.nn.Module:
    """Every rank's part of a ``weights`` op: the whole weights into the
    trainer's layout (its shards), and the serving copy of them."""
    trainer.load_standard_params(state_dict)
    return serving_copy(trainer.model, trainer.mesh, dtype)


def forward_block(trainer, model, batch, stats: dict, broadcast_ms: float) -> torch.Tensor:
    """Every rank's part of a ``dispatch`` op: this rank's block of the host
    ``batch`` through the model's mesh forward, and the whole output
    ``[rows, points, out]`` gathered from every rank's block; the op's
    phase times go into ``stats``."""
    mesh = trainer.mesh
    t0 = time.perf_counter()
    with torch.inference_mode():
        out = apply_batch(model, trainer._device_batch(batch))
        t1 = time.perf_counter()
        if not isinstance(batch, PackedBatch):
            out = mesh_lib.gather_points(mesh, out)
        out = mesh_lib.gather_rows(mesh, out)
    _record(stats, broadcast_ms, (t1 - t0) * 1e3, (time.perf_counter() - t1) * 1e3)
    return out


class MeshEngine(InferenceEngine):
    """Rank 0's engine over the serving mesh: ``InferenceEngine``'s
    validation, bucketing, collation and unpad, with each dispatch and each
    weight swap sent to every rank as one op (serialized by ``_wire_lock``:
    the worker's dispatches and a caller's reload never interleave on the
    wire). The bucket key is the trainer's fixed pad lengths (one dispatch
    shape, as JAX's mesh engine keys it); batches collate where the wire
    carries them. ``close`` sends the stop op once."""

    def __init__(self, trainer, *, batch_size: int, dtype: str = "float32"):
        self.trainer = trainer
        self.mesh = trainer.mesh
        self.wire = Wire(trainer.device)
        self._wire_lock = threading.Lock()
        self.failed: BaseException | None = None  #: guarded_by _wire_lock
        self._stopped = False  #: guarded_by _wire_lock
        self.stats = new_stats()  #: guarded_by _wire_lock
        data = trainer.config.data
        self._pads = (data.pad_nodes, data.pad_funcs)
        super().__init__(trainer.model, batch_size=batch_size, dtype=dtype)
        # Batches collate where the wire carries them.
        self.device = self.wire.device

    def _published(self, model):
        return serving_copy(model, self.mesh, self.dtype)

    def bucket_key(self, sample) -> tuple[int, int]:
        return self._pads

    def validate(self, samples) -> None:
        validate_samples(samples, pad_nodes=self._pads[0], pad_funcs=self._pads[1])

    def rows_for(self, rows: int) -> int:
        """``rows`` rounded up to a multiple of the node's data ranks (times
        the pipeline's microbatches, each of which takes whole rows)."""
        per = self.mesh.local_data * getattr(self.trainer.model, "n_micro", 1)
        return -(-rows // per) * per

    def _infer(self, reqs, pad_nodes, pad_funcs, rows, timings, clock):
        return super()._infer(reqs, pad_nodes, pad_funcs, self.rows_for(rows or self.batch_size),
                              timings, clock)

    def _raise_if_unusable(self) -> None:
        """A failed or stopped engine raises before it talks. The caller
        holds ``_wire_lock``."""
        failed = self.failed  # graftlint: disable=GL004 — caller holds _wire_lock
        if failed is not None:
            raise RuntimeError(f"the serving mesh failed earlier: {failed}")
        if self._stopped:  # graftlint: disable=GL004 — caller holds _wire_lock
            raise RuntimeError("the serving mesh was stopped")

    def _forward(self, model, batch):
        with self._wire_lock:
            self._raise_if_unusable()
            try:
                t0 = time.perf_counter()
                self.wire.send(*batch_message(batch))
                out = forward_block(self.trainer, self.model, batch, self.stats,
                                    (time.perf_counter() - t0) * 1e3)
            except BaseException as exc:
                # A failed collective leaves the group unusable.
                self.failed = exc
                raise
        return out.cpu().numpy()

    def swap_params(self, state_dict) -> None:
        with self._wire_lock:
            self._raise_if_unusable()
            try:
                t0 = time.perf_counter()
                self.wire.send({"op": OP_WEIGHTS}, dict(state_dict))
                fresh = load_weights(self.trainer, state_dict, self.dtype)
                self.stats["weights"] += 1
                self.stats["weights_ms"] += (time.perf_counter() - t0) * 1e3
            except BaseException as exc:
                self.failed = exc
                raise
        with self._lock:
            self._model = fresh

    def close(self) -> None:
        """Send the stop op, once; nothing after a failure (the group is
        broken: the followers' waits end with their timeout or the lost
        connection)."""
        with self._wire_lock:
            if self._stopped or self.failed is not None:
                return
            self._stopped = True
            self.wire.send({"op": OP_STOP})


def follow(trainer, *, dtype: str) -> dict:
    """Ranks 1..N-1 of a serving mesh: apply rank 0's ops until its stop
    op, under a ``PreemptionHandler`` that only records a SIGTERM (this
    rank leaves on the stop op, so rank 0 never waits on a rank that left).
    Returns the rank's counters (``stats_summary``), with ``sigterm``
    whether one arrived."""
    wire = Wire(trainer.device)
    model = serving_copy(trainer.model, trainer.mesh, dtype)
    stats = new_stats()
    with PreemptionHandler() as preempt:
        while True:
            t0 = time.perf_counter()
            header, tensors = wire.recv()
            op = header["op"]
            if op == OP_STOP:
                break
            if op == OP_WEIGHTS:
                model = load_weights(trainer, tensors, dtype)
                stats["weights"] += 1
                stats["weights_ms"] += (time.perf_counter() - t0) * 1e3
            elif op == OP_DISPATCH:
                forward_block(trainer, model, batch_from(header, tensors), stats,
                              (time.perf_counter() - t0) * 1e3)
            else:
                raise ValueError(f"unknown serving op {op!r}")
        sigterm = preempt.triggered
    return {**stats_summary(stats), "sigterm": sigterm}
