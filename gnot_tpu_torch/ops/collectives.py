"""Collectives with their backward: the all-reduces the mesh's forward
writes out, and the ring schedule.

Port of ``gnot_tpu/ops/collectives.py``. Where the JAX package lets GSPMD
insert the all-reduces of data, sequence, tensor and expert parallelism,
the port writes each one in the forward, and its backward is the
transpose of what the forward does with the result:

* ``all_reduce_sum``: all-reduce forward, all-reduce backward. For a sum
  whose result feeds rows that differ from rank to rank: the sequence
  axis's Gram ``k^T v`` and ``k_sum`` (as JAX's ``psum`` transposes to a
  ``psum``), each rank's queries reading the one global Gram.
* ``reduce_from``: all-reduce forward, identity backward. For a sum whose
  result every rank of the group then uses alike (replicated): the row-
  parallel close of tensor parallelism (``fc_out``, the expert and
  input-function MLPs' hidden layers), the gate-weighted combine over the
  expert axis, the loss's per-graph sums over the sequence axis. Every rank
  computes the same gradient of the result, which is each partial's.
* ``copy_to``: identity forward, all-reduce backward, its conjugate. For a
  replicated tensor that enters a tensor- or expert-parallel region: each
  rank takes its part of the gradient, the group's sum is the whole.

``ring_allreduce`` sums over a group by S-1 neighbour hops (send to the
next rank, receive from the previous one, add) instead of one all-reduce;
its backward replays the ring in the reverse direction. ``hop`` is one
such exchange, the pipeline's stage-to-stage handoff (JAX's ``ppermute``
``s -> s+1``), and ``broadcast_from`` makes one rank's tensor every rank's
(the pipeline's last-stage outputs). Gloo carries a hop and a broadcast
through host memory when the tensor is on the card (``_staged``: gloo
takes no point-to-point of a CUDA tensor); NCCL takes them on the card.
``HOP_STATS`` counts the hops and their host time.

``all_gather``: this rank's block of a tensor concatenated with every
other rank's along one dim, forward; the backward sums the gathered
gradient over the group and keeps this rank's block (a reduce-scatter,
written as an all-reduce and a slice: gloo has no reduce-scatter). For a
block that every rank then reads whole: the parity head merge on the
seq and model axes (``models/layers.py``), whose interleave mixes every
rank's heads and points into each rank's rows. ``GATHER_STATS`` counts
its forward calls and their host time.

A group of size 1, or ``None``, makes every function here the identity.
"""

from __future__ import annotations

import time

import torch
import torch.distributed as dist

#: Every ``hop`` since the last reset: calls, the host milliseconds of each
#: whole call and the part of them spent waiting on the backend's send and
#: receive (the rest stages the tensor through host memory).
HOP_STATS = {"calls": 0, "ms": 0.0, "wait_ms": 0.0}


#: Every forward ``all_gather`` since the last reset: calls and the host
#: milliseconds of each whole call.
GATHER_STATS = {"calls": 0, "ms": 0.0}


def reset_hop_stats() -> None:
    HOP_STATS.update(calls=0, ms=0.0, wait_ms=0.0)


def reset_gather_stats() -> None:
    GATHER_STATS.update(calls=0, ms=0.0)


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    out = x.contiguous().clone()
    dist.all_reduce(out, group=group)
    return out


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over ``group``; the gradient is summed over it too."""
    return x if group_size(group) == 1 else _AllReduceSum.apply(x, group)


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over ``group`` into a result every rank uses alike; the gradient
    passes through unchanged."""
    return x if group_size(group) == 1 else _ReduceFrom.apply(x, group)


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` itself; its gradient is summed over ``group``."""
    return x if group_size(group) == 1 else _CopyTo.apply(x, group)


def _gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    t0 = time.perf_counter()
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    out = torch.cat(parts, dim)
    GATHER_STATS["calls"] += 1
    GATHER_STATS["ms"] += (time.perf_counter() - t0) * 1e3
    return out


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim, ctx.n = group, dim, x.shape[dim]
        return _gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        summed = _all_reduce(g, ctx.group)
        mine = summed.narrow(ctx.dim, dist.get_rank(ctx.group) * ctx.n, ctx.n)
        return mine.contiguous(), None, None


def all_gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Every rank's ``x`` of ``group`` concatenated along ``dim`` in group
    rank order; the gradient is summed over the group and this rank's block
    kept."""
    return x if group_size(group) == 1 else _AllGather.apply(x, group, dim % x.dim())


def _staged(group, t: torch.Tensor) -> bool:
    """Whether ``t``'s point-to-point hops go through host memory: gloo on a
    tensor on the card."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def hop(buf: torch.Tensor, group, to: int, frm: int) -> torch.Tensor:
    """Send ``buf`` to group rank ``to`` while receiving the same shape
    from group rank ``frm``; returns what was received."""
    t0 = time.perf_counter()
    staged = _staged(group, buf)
    send = buf.cpu() if staged else buf.contiguous()
    recv = torch.empty_like(send)
    ops = [
        dist.P2POp(dist.isend, send, dist.get_global_rank(group, to), group),
        dist.P2POp(dist.irecv, recv, dist.get_global_rank(group, frm), group),
    ]
    t1 = time.perf_counter()
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    t2 = time.perf_counter()
    out = recv.to(buf.device, non_blocking=True) if staged else recv
    HOP_STATS["calls"] += 1
    HOP_STATS["wait_ms"] += (t2 - t1) * 1e3
    HOP_STATS["ms"] += (time.perf_counter() - t0) * 1e3
    return out


def broadcast_from(x: torch.Tensor, group, src: int) -> torch.Tensor:
    """Group rank ``src``'s ``x`` on every rank of ``group`` (a new tensor
    on ``x``'s device; no gradient)."""
    staged = _staged(group, x)
    buf = x.detach().cpu() if staged else x.detach().contiguous().clone()
    dist.broadcast(buf, src=dist.get_global_rank(group, src), group=group)
    return buf.to(x.device, non_blocking=True) if staged else buf


def _ring(x: torch.Tensor, group, step: int) -> torch.Tensor:
    """``x`` summed over ``group`` by S-1 hops, each rank forwarding the
    partial it last received to the rank ``step`` places on."""
    size = dist.get_world_size(group)
    me = dist.get_rank(group)
    acc, buf = x.clone(), x
    for _ in range(size - 1):
        buf = hop(buf, group, (me + step) % size, (me - step) % size)
        acc = acc + buf
    return acc


class _RingAllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _ring(x, group, 1)

    @staticmethod
    def backward(ctx, g):
        return _ring(g, ctx.group, -1), None


def ring_allreduce(x: torch.Tensor, group) -> torch.Tensor:
    """Sum ``x`` over ``group`` with S-1 neighbour hops instead of a
    one-shot all-reduce. Differentiable: the backward replays the ring in
    reverse (``gnot_tpu/ops/collectives.py::ring_allreduce``)."""
    return x if group_size(group) == 1 else _RingAllReduce.apply(x, group)
