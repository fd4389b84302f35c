"""The rank mesh and its sharding layout: the distributed backend.

Port of ``gnot_tpu/parallel/mesh.py``. JAX builds one 5-axis mesh over
the devices of its processes and lets GSPMD insert the collectives from
sharding annotations; the port builds the same 5-axis mesh over the
``torch.distributed`` ranks (one process each, row-major over ``AXES``
as JAX reshapes its device list), keeps on each rank its block of the
batch and of every weight by the same rules, and writes each collective
where GSPMD would put one (``ops/collectives.py`` says which backward
each takes):

* ``data``: batch rows split. The gradient of every weight is summed
  over the ranks that saw other data (``reduce_grads``) and divided by
  the data degree: the loss is the mean over the data ranks' row means.
* ``seq``: mesh points and function points split. Each attention sums its
  ``k_sum`` and Gram ``k^T v`` over the axis (``ops/attention.py``), and
  the loss sums its per-graph pools (``ops/segment.py``); gradients are
  summed over it with ``data``'s.
* ``model``: attention heads and the hidden axis of the expert and
  input-function MLPs split (``_param_pspec``); ``fc_out`` and each
  row-parallel hidden layer close with an all-reduce
  (``models/layers.py``).
* ``expert``: the stacked experts split; each rank runs its experts on
  every token and the gate-weighted combine closes with an all-reduce.
* ``pipe``: the block stack split into stages, one a rank of the line,
  run as a microbatch schedule (``parallel/pipeline.py``); composes with
  ``data`` and ``model``. The stacked blocks keep their stage's layers
  (``param_spec``: ``blocks.X`` takes X's spec behind a leading layer dim
  on ``pipe``, which on a mesh without a pipe axis is JAX's GSPMD rule for
  the stacked layout); the embedding's gradients are summed over ``pipe``
  as well as ``data`` (``reduce_grads``).

Each rank builds the whole model from the seed and keeps its shards
(``shard_model``); ``gather_params`` / ``gather_tensor`` assemble the
whole weights again, which is what checkpoints, export and predict read.
The groups are ``dist.new_group`` lines of the mesh, each with the run's
timeout (``init_device_mesh`` would give them the backend's default, 30
minutes for gloo).
"""

from __future__ import annotations

import dataclasses
import datetime
import math
import re
from typing import Iterable

import numpy as np
import torch
import torch.distributed as dist

from gnot_tpu_torch.config import MeshConfig, ModelConfig
from gnot_tpu_torch.data.batch import PackedBatch
from gnot_tpu_torch.ops.collectives import copy_to, reduce_from

AXES = ("data", "seq", "model", "expert", "pipe")
#: The axes that split weights (the rest split the batch).
SPLIT_AXES = ("model", "expert", "pipe")


def mesh_shape(cfg: MeshConfig, n: int) -> dict[str, int]:
    """The ``AXES`` sizes of ``cfg`` over ``n`` ranks, with
    ``gnot_tpu``'s ``make_mesh`` checks and messages (``data=-1`` fills
    what the other axes leave)."""
    seq, model, expert, pipe = cfg.seq, cfg.model, cfg.expert, cfg.pipe
    rest = seq * model * expert * pipe
    data = cfg.data if cfg.data > 0 else n // rest
    if data * rest != n:
        raise ValueError(
            f"mesh {data}x{seq}x{model}x{expert}x{pipe} "
            f"(data x seq x model x expert x pipe) does not cover {n} devices"
        )
    if pipe > 1 and (seq > 1 or expert > 1):
        raise ValueError(
            "pipe > 1 composes with the data and model axes only (the "
            "pipeline is a partially-manual shard_map: data/pipe are "
            "mapped, model stays a GSPMD auto axis); set seq=expert=1"
        )
    return dict(zip(AXES, (data, seq, model, expert, pipe)))


def rank_coords(shape: dict[str, int], rank: int) -> dict[str, int]:
    """A rank's coordinate on each axis: row-major over ``AXES``."""
    idx = np.unravel_index(rank, [shape[a] for a in AXES])
    return {a: int(i) for a, i in zip(AXES, idx)}


def _lines(shape: dict[str, int], axes: tuple[str, ...]) -> list[list[int]]:
    """Every group of ranks that differ only along ``axes``, in a fixed
    order, each rank list ascending."""
    sizes = [shape[a] for a in AXES]
    ranks = np.arange(math.prod(sizes)).reshape(sizes)
    moved = np.moveaxis(ranks, [AXES.index(a) for a in axes], range(-len(axes), 0))
    return [sorted(int(r) for r in line.ravel())
            for line in moved.reshape(-1, math.prod(shape[a] for a in axes))]


@dataclasses.dataclass
class Mesh:
    """This rank's view of the mesh: the axis sizes, its coordinate on each,
    and the process group of each axis of size > 1 (``None`` otherwise)
    plus the gradient group (``data`` x ``seq``). ``nodes`` is the number
    of hosts, the leading factor of the data axis."""

    shape: dict[str, int]
    coords: dict[str, int]
    groups: dict[str, object]
    grad_group: object = None
    nodes: int = 1

    def size(self, axis: str) -> int:
        return self.shape[axis]

    def group(self, axis: str):
        return self.groups.get(axis)

    @property
    def sharded(self) -> bool:
        """Whether any weight is split (model, expert or pipe axis > 1)."""
        return any(self.shape[a] > 1 for a in SPLIT_AXES)

    @property
    def local_data(self) -> int:
        """The data degree within a node: the rows of a node's batch split
        this many ways."""
        return self.shape["data"] // self.nodes


def make_mesh(cfg: MeshConfig, *, nodes: int = 1, timeout_s: float | None = None) -> Mesh:
    """The mesh of ``cfg`` over every rank of the process group (a world of
    one without one), with a group for each axis line and for the
    data x seq gradient lines. COLLECTIVE: every rank builds every group,
    in one order."""
    from gnot_tpu_torch.parallel import multihost

    n = multihost.process_count()
    shape = mesh_shape(cfg, n)
    rank = multihost.process_index()
    mesh = Mesh(shape, rank_coords(shape, rank), {a: None for a in AXES}, nodes=nodes)
    if n == 1:
        return mesh
    timeout = datetime.timedelta(
        seconds=multihost.DEFAULT_TIMEOUT_S if timeout_s is None else timeout_s)

    def build(axes: tuple[str, ...]):
        mine = None
        for ranks in _lines(shape, axes):
            g = dist.new_group(ranks, timeout=timeout)
            if rank in ranks:
                mine = g
        return mine

    for axis in AXES:
        if shape[axis] > 1:
            mesh.groups[axis] = build((axis,))
    if shape["data"] * shape["seq"] > 1:
        mesh.grad_group = build(("data", "seq"))
    return mesh


# --------------------------------------------------------------------------
# The GSPMD checks.
# --------------------------------------------------------------------------


def _validate_gspmd(model_cfg: ModelConfig, mesh: Mesh) -> None:
    """``gnot_tpu``'s config-validity guards of every GSPMD step builder,
    with its messages, plus the port's own (``validate_layers``)."""
    if mesh.shape.get("expert", 1) > 1 and (model_cfg.n_expert % mesh.shape["expert"]):
        raise ValueError(
            f"n_expert={model_cfg.n_expert} must be divisible by the "
            f"mesh expert axis ({mesh.shape['expert']})"
        )
    if model_cfg.ffn_impl == "pallas":
        raise ValueError(
            "ffn_impl='pallas' is single-device/DP only (no shard_map "
            "form yet); use ffn_impl='xla' on a mesh"
        )
    validate_layers(model_cfg, mesh)


def validate_layers(model_cfg: ModelConfig, mesh: Mesh) -> None:
    """The port's own checks of the layers' mesh forward, on every mesh
    (a pipeline's stages split heads over ``model`` as GSPMD's mesh does):
    whole head groups a rank, and a column layer closed by a row layer.
    Parity mode runs on every axis: its interleaved head merge gathers the
    heads and points it mixes (``models/layers.py::_parity_merge``)."""
    if model_cfg.n_head % mesh.shape["model"]:
        raise ValueError(
            f"n_head={model_cfg.n_head} must be divisible by the model axis size "
            f"{mesh.shape['model']} (TP shards whole head groups)"
        )
    if mesh.shape["model"] > 1 and model_cfg.n_mlp_num_layers < 1:
        raise ValueError(
            "tensor parallelism needs n_mlp_num_layers >= 1 (a column layer "
            "closed by a row layer)"
        )


# --------------------------------------------------------------------------
# The batch: each rank's block.
# --------------------------------------------------------------------------


def _block(t: torch.Tensor, dim: int, index: int, parts: int, what: str) -> torch.Tensor:
    n = t.shape[dim]
    if n % parts:
        raise ValueError(
            f"{what}: length {n} of dim {dim} does not split over {parts} ranks"
        )
    step = n // parts
    return t.narrow(dim, index * step, step)


def shard_batch(mesh: Mesh, batch, *, stacked: bool = False):
    """This rank's block of a host ``MeshBatch`` (``batch_pspecs``): batch
    rows by its data coordinate within the node, mesh points and function
    points by its seq coordinate. ``stacked=True`` for a K-step stacked
    batch (leading step axis, never split). Contiguous CPU tensors. A
    ``PackedBatch`` takes ``packed_batch_pspecs``' block."""
    if isinstance(batch, PackedBatch):
        return shard_packed_batch(mesh, batch, stacked=stacked)
    lead = 1 if stacked else 0
    d, dn = mesh.coords["data"] % mesh.local_data, mesh.local_data
    s, sn = mesh.coords["seq"], mesh.shape["seq"]

    def rows(t, dim, what):
        return _block(t, lead + dim, d, dn, f"batch {what} rows")

    def points(t, dim, what):
        return _block(t, lead + dim, s, sn, f"{what} (sequence axis; bucketed padding)")

    def part(t, row_dim, point_dim, what):
        if t is None:
            return None
        t = rows(t, row_dim, what)
        if point_dim is not None:
            t = points(t, point_dim, what)
        return t.contiguous()

    return dataclasses.replace(
        batch,
        coords=part(batch.coords, 0, 1, "coords"),
        theta=part(batch.theta, 0, None, "theta"),
        y=part(batch.y, 0, 1, "y"),
        node_mask=part(batch.node_mask, 0, 1, "node_mask"),
        funcs=part(batch.funcs, 1, 2, "funcs"),
        func_mask=part(batch.func_mask, 1, 2, "func_mask"),
    )


def shard_packed_batch(mesh: Mesh, batch: PackedBatch, *, stacked: bool = False) -> PackedBatch:
    """This rank's block of a host ``PackedBatch``
    (``gnot_tpu/parallel/mesh.py::packed_batch_pspecs``): the packed rows
    (coords, y, the token mask, the chunk -> segment table) split over
    ``data``; the slot tables (theta, the input-function slot rows, their
    mask and segment map) stay whole on every rank, and segment ids stay
    global. Each sample lies whole in one row (first-fit places it so), so
    each segment's Grams and loss sums are one rank's."""
    lead = 1 if stacked else 0
    d, dn = mesh.coords["data"] % mesh.local_data, mesh.local_data

    def rows(t, what):
        return _block(t, lead, d, dn, f"packed {what} rows").contiguous()

    return dataclasses.replace(
        batch,
        coords=rows(batch.coords, "coords"),
        y=rows(batch.y, "y"),
        node_mask=rows(batch.node_mask, "node_mask"),
        node_seg=rows(batch.node_seg, "node_seg"),
    )


# --------------------------------------------------------------------------
# The weights: the sharding rules, each rank's shard, the gather.
# --------------------------------------------------------------------------


def _param_pspec(path: str, ndim: int) -> tuple:
    """Name-based TP/EP rules for the GNOT param tree, ``gnot_tpu``'s
    ``_param_pspec``: one mesh axis (or None) per dim. ``path`` uses
    ``/`` between names, as the JAX tree's paths do. ``blocks/`` paths
    (the stacked layout) carry a leading unsharded layer axis."""
    if "blocks/" in path:
        return (None,) + _param_pspec_at(path, ndim - 1)
    return _param_pspec_at(path, ndim)


def _param_pspec_at(path: str, ndim: int) -> tuple:
    is_kernel = path.endswith("kernel")
    if re.search(r"(query|key|value)/kernel$", path):
        return (None,) * (ndim - 1) + ("model",)  # column (head) parallel
    if re.search(r"(query|key|value)/bias$", path):
        return (None,) * (ndim - 1) + ("model",)
    if re.search(r"fc_out/kernel$", path):
        return ("model", None)  # row parallel -> all-reduce
    if "experts/" in path:
        # Stacked expert MLPs [E, in, out]: the stack axis is EP, the
        # hidden axis TP.
        if is_kernel and "dense_0" in path:
            return ("expert", None, "model")
        if is_kernel:
            return ("expert", "model", None)
        if "dense_0" in path and ndim == 2:
            return ("expert", "model")
        return ("expert",) + (None,) * (ndim - 1)
    if "input_func_mlps/" in path:
        # Stacked per-input-function MLPs [F, in, out]: the function axis
        # is never split; hidden is TP.
        if is_kernel and "dense_0" in path:
            return (None, None, "model")
        if is_kernel:
            return (None, "model", None)
        if "dense_0" in path and ndim == 2:
            return (None, "model")
        return (None,) * ndim
    return (None,) * ndim  # everything else replicated


def param_spec(name: str, ndim: int) -> tuple:
    """The rule of a port parameter name (``block_0.ffn1.experts...``).
    A stacked ``blocks.X`` splits its leading layer dim over ``pipe``
    (``gnot_tpu/parallel/pipeline.py::state_shardings``); on a mesh whose
    pipe axis is 1 that is ``_param_pspec``'s unsplit layer dim."""
    path = name.replace(".", "/")
    if path.startswith("blocks/"):
        return ("pipe",) + _param_pspec_at(path, ndim - 1)
    return _param_pspec(path, ndim)


def shard_tensor(full: torch.Tensor, spec: tuple, mesh: Mesh) -> torch.Tensor:
    """This rank's block of ``full`` under ``spec``."""
    out = full
    for dim, axis in enumerate(spec):
        if axis is not None and mesh.shape[axis] > 1:
            out = _block(out, dim, mesh.coords[axis], mesh.shape[axis], f"weight on {axis}")
    return out


def gather_tensor(local: torch.Tensor, spec: tuple, mesh: Mesh) -> torch.Tensor:
    """The whole tensor from every rank's block (all-gather over each
    sharded axis). COLLECTIVE over those axes."""
    out = local.detach().contiguous()
    for dim, axis in enumerate(spec):
        group = mesh.group(axis) if axis is not None else None
        if group is None:
            continue
        parts = [torch.empty_like(out) for _ in range(mesh.shape[axis])]
        dist.all_gather(parts, out, group=group)
        out = torch.cat(parts, dim=dim)
    return out


def shard_model(model: torch.nn.Module, mesh: Mesh) -> None:
    """Keep this rank's shard of every weight (in place) and give every
    layer the mesh (``layers.set_mesh``): the whole model was built from
    the seed on every rank, so the shards are the whole model's blocks."""
    from gnot_tpu_torch.models.layers import set_mesh

    if mesh.sharded:
        with torch.no_grad():
            for name, p in model.named_parameters():
                spec = param_spec(name, p.dim())
                if any(a is not None and mesh.shape[a] > 1 for a in spec):
                    p.data = shard_tensor(p.data, spec, mesh).clone()
    set_mesh(model, mesh)


def param_specs(model: torch.nn.Module) -> dict[str, tuple]:
    return {n: param_spec(n, p.dim()) for n, p in model.named_parameters()}


def gather_params(params: dict[str, torch.Tensor], mesh: Mesh) -> dict[str, torch.Tensor]:
    """The whole weights of a map of shards (``model.state_dict()``).
    COLLECTIVE."""
    if not mesh.sharded:
        return dict(params)
    return {n: gather_tensor(t, param_spec(n, t.dim()), mesh) for n, t in params.items()}


def shard_params(params: dict[str, torch.Tensor], mesh: Mesh) -> dict[str, torch.Tensor]:
    """This rank's shards of a map of whole weights."""
    if not mesh.sharded:
        return dict(params)
    return {n: shard_tensor(t, param_spec(n, t.dim()), mesh).clone() for n, t in params.items()}


# --------------------------------------------------------------------------
# The step's collectives.
# --------------------------------------------------------------------------


def _all_reduce_packed(grads: list[torch.Tensor], group, divide: int = 1) -> None:
    """Sum ``grads`` over ``group`` in place, divided by ``divide``: one
    all-reduce of them all packed into one buffer (a collective a tensor
    would pay the group's latency ~200 times a step)."""
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=group)
    if divide > 1:
        flat /= divide
    torch._foreach_copy_(grads, [part.view_as(g) for part, g in
                                 zip(flat.split([g.numel() for g in grads]), grads)])


def reduce_grads(mesh: Mesh, grads: list[torch.Tensor],
                 over_pipe: list[bool] | None = None) -> None:
    """Sum every gradient over the ranks that saw other data (the data x
    seq line) and divide by the data degree, in place: the gradient of the
    mean over the data ranks' losses. Sharded weights are summed the same
    way (their model/expert/pipe shards already hold their whole gradient).
    On a pipe axis the gradients ``over_pipe`` marks (the embedding's, which
    every stage's blocks read) are first summed over it: each stage holds
    the part its own blocks gave."""
    if mesh.group("pipe") is not None and over_pipe and any(over_pipe):
        _all_reduce_packed([g for g, o in zip(grads, over_pipe) if o], mesh.group("pipe"))
    if mesh.grad_group is None:
        return
    _all_reduce_packed(grads, mesh.grad_group, mesh.shape["data"])


def _summed(value: torch.Tensor, group) -> torch.Tensor:
    """``value`` summed over ``group`` (no gradient; itself without one)."""
    if group is None:
        return value
    out = value.detach().clone()
    dist.all_reduce(out, group=group)
    return out


def mean_over_data(mesh: Mesh, value: torch.Tensor) -> torch.Tensor:
    """The mean of a per-rank value over the data axis (the loss of the
    global batch from each rank's row mean). COLLECTIVE over data."""
    if mesh.group("data") is None:
        return value
    return _summed(value, mesh.group("data")) / mesh.shape["data"]


def gather_rows(mesh: Mesh, value: torch.Tensor) -> torch.Tensor:
    """Per-row values ``[B_local, ...]`` of every data rank, concatenated
    in data order. COLLECTIVE over data."""
    group = mesh.group("data")
    if group is None:
        return value
    parts = [torch.empty_like(value) for _ in range(mesh.shape["data"])]
    dist.all_gather(parts, value.contiguous(), group=group)
    return torch.cat(parts)


def gather_points(mesh: Mesh, value: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """Per-point values of every seq rank (their blocks of the sequence
    axis ``dim``), concatenated in seq order. COLLECTIVE over seq."""
    group = mesh.group("seq")
    if group is None:
        return value
    parts = [torch.empty_like(value) for _ in range(mesh.shape["seq"])]
    dist.all_gather(parts, value.contiguous(), group=group)
    return torch.cat(parts, dim)


def global_sq_norm(mesh: Mesh, tensors: Iterable[torch.Tensor], specs: Iterable[tuple]
                   ) -> torch.Tensor:
    """The squared global norm of tensors held as shards under ``specs``:
    each tensor's local sum of squares, summed over the axes it is split
    over (replicated tensors count once). COLLECTIVE over model, expert and
    pipe when any splits a tensor."""
    by_axes: dict[tuple, list[torch.Tensor]] = {}
    for t, spec in zip(tensors, specs):
        axes = tuple(a for a in SPLIT_AXES if a in spec and mesh.shape[a] > 1)
        by_axes.setdefault(axes, []).append(t)
    total = None
    for axes, ts in sorted(by_axes.items()):
        sq = torch.sum(torch.stack(torch._foreach_norm(ts)) ** 2)
        for a in axes:
            dist.all_reduce(sq, group=mesh.group(a))
        total = sq if total is None else total + sq
    return total


def sum_over_data(mesh: Mesh, value: torch.Tensor) -> torch.Tensor:
    """A value summed over the data axis (no gradient)."""
    return _summed(value, mesh.group("data"))


def sum_over_grad_group(mesh: Mesh, value: torch.Tensor) -> torch.Tensor:
    """A value summed over the data x seq line (no gradient)."""
    return _summed(value, mesh.grad_group)


# --------------------------------------------------------------------------
# Tensor- and expert-parallel pieces of the forward.
# --------------------------------------------------------------------------


def enter(x: torch.Tensor, mesh: Mesh | None, *axes: str) -> torch.Tensor:
    """A replicated activation entering a region split over ``axes``: the
    identity, with its gradient summed over each axis."""
    if mesh is None:
        return x
    for a in axes:
        x = copy_to(x, mesh.group(a))
    return x


def close(x: torch.Tensor, mesh: Mesh | None, axis: str) -> torch.Tensor:
    """A partial sum over ``axis`` closed into a replicated activation."""
    if mesh is None:
        return x
    return reduce_from(x, mesh.group(axis))


def local_slice(x: torch.Tensor, mesh: Mesh, axis: str, dim: int = -1) -> torch.Tensor:
    """This rank's block of a replicated activation along ``dim``."""
    return _block(x, dim % x.dim(), mesh.coords[axis], mesh.shape[axis], f"activation on {axis}")

