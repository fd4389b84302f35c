"""Fused normalized linear attention: the Hopper kernels and their plain versions.

Port of ``gnot_tpu/ops/pallas_attention.py``. The layout is the JAX one: heads
merged, ``q [B, L, E]``, ``k``/``v [F, B, Lk, E]``, ``mask [F, B, Lk]``
(F input functions, 1 for self-attention), E = H * D. Every per-head
operation is a per-lane-group one:

* the feature softmax is a softmax within each head's D lanes, with a
  per-head max, so a head whose logits sit far below another head's
  never underflows to 0/0 (``group_softmax``);
* ``nla_reduce`` accumulates the masked full Gram ``ks^T v [F, B, E, E]``
  and ``k_sum [F, B, 1, E]``; ``nla_apply`` keeps each head's diagonal
  block of it, normalizes by the per-head ``<qs, k_sum>`` (0 -> 1) and
  returns ``(out [F, B, L, E], qs [B, L, E])``;
* ``nla_reduce_seg`` / ``nla_apply_seg`` are the packed forms: rows carry
  several samples as chunk-aligned segments, ``seg [B, N]`` maps each
  chunk of L / N rows to its segment slot (pad chunks carry ``n_seg``),
  and a token only ever meets its own segment's Gram.

``fused_nla_sp`` runs the reduce and apply stages on each rank of a mesh
(``parallel/mesh.py``) with its block of the batch, the sequence and the
heads, and sums the Gram partials over the sequence axis between them.

Four kernels back the four stages (``csrc/nla_reduce.cu``,
``csrc/nla_apply.cu``). Each public stage is a ``torch.autograd.Function``
whose forward launches the kernel on CUDA tensors (or raises) and runs the
plain version on CPU tensors; its backward recomputes through the plain
version, as the JAX ``custom_vjp``s do. Masks and segment ids get no
gradient. The kernels take D in {16, 32}, E <= 256, and float32 or bfloat16
inputs, as the JAX kernels take any float dtype and compute in float32: the
reduce stages return float32 whatever their inputs; the apply stages
return ``out`` and ``qs`` in q's dtype, their plain versions too.
"""

from __future__ import annotations

import ctypes

import torch

from gnot_tpu_torch.ops import build
from gnot_tpu_torch.ops.collectives import all_reduce_sum, ring_allreduce

HEAD_WIDTHS = (16, 32)
MAX_E = 256
# Gram tile (rows i x columns j), key rows per step and fewest rows per
# piece of csrc/nla_reduce.cu. Every piece writes a whole partial Gram
# (E^2 floats, the size of 128 rows of k and v at E = 256), so pieces stay
# at 64 rows or more even where that leaves SMs idle.
REDUCE_TILE = (64, 128)
REDUCE_ROWS = 32
REDUCE_MIN_SPLIT = 64

# C launchers by name, bound once (argtypes set) per process.
_launchers: dict = {}
# The element types the kernels read, by the launchers' type codes.
TYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


# --------------------------------------------------------------------------
# Plain versions (CPU path, backward source, on-card oracle).
# --------------------------------------------------------------------------


def group_softmax(x: torch.Tensor, n_head: int) -> torch.Tensor:
    """Per-head softmax of ``[..., E]`` rows in float32: a softmax over
    each head's D lanes, with the max taken per head (``torch.softmax``
    subtracts the max of the axis it normalizes)."""
    e = x.shape[-1]
    shaped = x.float().reshape(*x.shape[:-1], n_head, e // n_head)
    return torch.softmax(shaped, dim=-1).reshape(x.shape)


def block_diag_mask(e: int, d: int, device=None) -> torch.Tensor:
    """``[E, E]`` with 1 inside each head's D x D diagonal block."""
    idx = torch.arange(e, device=device) // d
    return (idx[:, None] == idx[None, :]).float()


def _one_hot(ids: torch.Tensor, n_seg: int) -> torch.Tensor:
    """``[..., S]`` one-hot of segment ids; ids outside ``[0, S)`` (the
    pad id S) map to an all-zero row, like ``jax.nn.one_hot(ids, S + 1)
    [..., :S]``."""
    return (ids[..., None] == torch.arange(n_seg, device=ids.device)).float()


def reduce_reference(k, v, mask, n_head: int):
    """Plain form of the reduce stage: ``(kv [F,B,E,E], ksum [F,B,1,E])``."""
    ks = group_softmax(k, n_head) * mask[..., None]
    kv = torch.einsum("fbld,fble->fbde", ks, v.float())
    return kv, ks.sum(dim=2, keepdim=True)


def apply_reference(q, kv, ksum, n_head: int):
    """Plain form of the apply stage: ``(out [F,B,L,E], qs [B,L,E])`` in
    q's dtype, computed in f32 (``pallas_attention._apply_ref``)."""
    e = q.shape[-1]
    qs = group_softmax(q, n_head)
    bd = block_diag_mask(e, e // n_head, q.device)
    # Per-head <qs, k_sum>, broadcast to the head's lanes through bd.
    denom = torch.einsum("fble,ed->fbld", qs[None] * ksum, bd)
    denom = torch.where(denom == 0.0, torch.ones_like(denom), denom)
    out = torch.einsum("bld,fbde->fble", qs, kv * bd) / denom
    return out.to(q.dtype), qs.to(q.dtype)


def reduce_seg_reference(k, v, mask, seg, n_seg: int, n_head: int):
    """Plain form of the segment reduce: ``(kv [F,S,E,E], ksum [F,S,1,E])``,
    zero for a slot no chunk belongs to."""
    lk = k.shape[2]
    ks = group_softmax(k, n_head) * mask[..., None]  # [F, B, Lk, E]
    tok_seg = torch.repeat_interleave(seg, lk // seg.shape[1], dim=1)  # [B, Lk]
    oh = _one_hot(tok_seg, n_seg).permute(2, 0, 1)  # [S, B, Lk]
    ks_s = ks[:, None] * oh[None, ..., None]  # [F, S, B, Lk, E]
    kv = torch.einsum("fsbld,fble->fsde", ks_s, v.float())
    return kv, ks_s.sum(dim=(2, 3))[:, :, None, :]


def apply_seg_reference(q, kv, ksum, seg, n_head: int):
    """Plain form of the segment apply: ``(out [F,B,L,E], qs [B,L,E])`` in
    q's dtype (``pallas_attention._apply_seg_ref``); rows of pad chunks
    give 0."""
    b, l, e = q.shape
    n_seg = kv.shape[1]
    n = seg.shape[1]
    qs = group_softmax(q, n_head)
    bd = block_diag_mask(e, e // n_head, q.device)
    oh = _one_hot(seg, n_seg)  # [B, N, S]
    kv_t = torch.einsum("bns,fsde->fbnde", oh, kv * bd)
    ks_t = torch.einsum("bns,fse->fbne", oh, ksum[:, :, 0])
    qc = qs.reshape(b, n, l // n, e)
    # Per-head <qs, k_sum> of the chunk's segment, broadcast through bd.
    denom = torch.matmul(qc[None] * ks_t[:, :, :, None, :], bd)  # [F, B, N, C, E]
    denom = torch.where(denom == 0.0, torch.ones_like(denom), denom)
    out = torch.einsum("bncd,fbnde->fbnce", qc, kv_t) / denom
    return out.reshape(kv.shape[0], b, l, e).to(q.dtype), qs.to(q.dtype)


def reference_impl(q, k, v, mask, n_head: int):
    """The whole op in plain form (oracle)."""
    kv, ksum = reduce_reference(k, v, mask, n_head)
    return apply_reference(q, kv, ksum, n_head)


def reference_seg_impl(q, k, v, mask, q_seg, kv_seg, n_seg: int, n_head: int):
    """The whole packed op in plain form (oracle)."""
    kv, ksum = reduce_seg_reference(k, v, mask, kv_seg, n_seg, n_head)
    return apply_seg_reference(q, kv, ksum, q_seg, n_head)


# --------------------------------------------------------------------------
# Kernel wrappers: CUDA tensors only; each launch adds one to its counter.
# --------------------------------------------------------------------------


def _head_width(e: int, n_head: int) -> int:
    if n_head < 1 or e % n_head:
        raise ValueError(f"E={e} is not divisible by n_head={n_head}")
    d = e // n_head
    if d not in HEAD_WIDTHS or e > MAX_E:
        raise ValueError(
            f"the attention kernels take head widths D in {HEAD_WIDTHS} and "
            f"E <= {MAX_E}; got E={e}, n_head={n_head} (D={d})"
        )
    return d


def _check_tensors(floats, ints=()) -> None:
    dev = floats[0].device
    for t in (*floats, *ints):
        if not t.is_cuda or t.device != dev:
            raise ValueError("every tensor must lie on the same CUDA device")
        if not t.is_contiguous():
            raise ValueError("the attention kernels need contiguous tensors")
        if t.data_ptr() % 16:
            raise ValueError("the attention kernels need 16-byte aligned tensors")
    for t in floats:
        if t.dtype not in TYPE_CODES:
            raise ValueError(f"the attention kernels take float32 or bfloat16, got {t.dtype}")
    for t in ints:
        if t.dtype != torch.int32:
            raise ValueError(f"segment ids must be int32, got {t.dtype}")


def _reduce_inputs(k, v, mask):
    """``(k, v, mask)`` as a reduce kernel instance takes them: k and v of
    one type, the mask f32 or k's type. Any other mix is widened here to
    f32, an exact cast: f32 k with bf16 v reads as f32 k and v."""
    if k.dtype != v.dtype:
        k, v = k.float(), v.float()
    if mask.dtype not in (torch.float32, k.dtype):
        mask = mask.float()
    return k, v, mask


def _seg_tile(l: int, n_tiles: int, what: str) -> int:
    """Rows per chunk, with ``pallas_attention._seg_tile``'s checks, so
    both packages accept the same packed inputs."""
    if l % n_tiles:
        raise ValueError(
            f"{what}: sequence length {l} not divisible by the segment "
            f"tile count {n_tiles} (chunk-aligned packing required)"
        )
    tile = l // n_tiles
    if tile % 8:
        raise ValueError(
            f"{what}: packing chunk {tile} must be a multiple of 8 "
            "(TPU sublane alignment); repack with chunk in {64, 128, 256}"
        )
    return tile


def _check_kv(k, v, mask) -> None:
    if k.dim() != 4 or v.shape != k.shape or mask.shape != k.shape[:3]:
        raise ValueError(
            f"k and v must be [F, B, Lk, E] and mask [F, B, Lk], got "
            f"{tuple(k.shape)}, {tuple(v.shape)} and {tuple(mask.shape)}"
        )


def _check_apply(q, kv, ksum, n_slots: int) -> None:
    e = q.shape[-1]
    if q.dim() != 3 or kv.dim() != 4 or kv.shape[1:] != (n_slots, e, e) or (
        tuple(ksum.shape) != (kv.shape[0], n_slots, 1, e)
    ):
        raise ValueError(
            f"q must be [B, L, E], kv [F, {n_slots}, E, E] and ksum "
            f"[F, {n_slots}, 1, E], got {tuple(q.shape)}, {tuple(kv.shape)} "
            f"and {tuple(ksum.shape)}"
        )


def reduce_splits(f: int, n_chunks: int, chunk_len: int, e: int, n_sm: int) -> tuple[int, int]:
    """``(n_split, split_len)``: how the reduce kernel cuts each of its
    ``n_chunks`` chunks of ``chunk_len`` key rows (one per row of ``nla_reduce``;
    the packing chunks of ``nla_reduce_seg``) into pieces, so that its
    (tile, piece, f) blocks number about two per SM on ``n_sm`` SMs, with
    no piece under ``REDUCE_MIN_SPLIT`` rows unless the chunk is. ``split_len``
    is a multiple of the kernel's 32-row step."""
    tiles = (-(-e // REDUCE_TILE[0])) * (-(-e // REDUCE_TILE[1]))
    want = -(-2 * n_sm // max(1, tiles * f * n_chunks))
    n = max(1, min(want, chunk_len // REDUCE_MIN_SPLIT))
    rows = -(-chunk_len // n)
    split_len = max(REDUCE_ROWS, -(-rows // REDUCE_ROWS) * REDUCE_ROWS)
    return max(1, -(-chunk_len // split_len)), split_len


def _lib(name: str, fn: str, n_ptr: int, n_int: int):
    """The C launcher ``fn`` of ``csrc/<name>.cu``: ``n_ptr`` pointers,
    ``n_int`` ints, then the stream; it returns a ``cudaError_t``."""
    c_fn = _launchers.get(fn)
    if c_fn is None:
        c_fn = getattr(build.load(name), fn)
        c_fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [ctypes.c_void_p]
        c_fn.restype = ctypes.c_int
        _launchers[fn] = c_fn
    return c_fn


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: cudaError {err}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def nla_reduce_kernel(k, v, mask, n_head: int):
    """Launch ``csrc/nla_reduce.cu`` (dense form) on PyTorch's current
    stream: ``(kv [F,B,E,E], ksum [F,B,1,E])`` in f32. k and v are f32 or
    bf16, the mask f32 or k's dtype; ``_reduce_inputs`` widens other mixes."""
    _check_kv(k, v, mask)
    _check_tensors([k, v, mask])
    k, v, mask = _reduce_inputs(k, v, mask)
    f, b, lk, e = k.shape
    d = _head_width(e, n_head)
    n_sm = torch.cuda.get_device_properties(k.device).multi_processor_count
    n_split, split_len = reduce_splits(f, b, lk, e, n_sm)
    opts = dict(device=k.device, dtype=torch.float32)
    partial = torch.empty(f, b * n_split, e * e + e, **opts)
    kv = torch.empty(f, b, e, e, **opts)
    ksum = torch.empty(f, b, 1, e, **opts)
    fn = _lib("nla_reduce", "gnot_nla_reduce", 6, 9)
    err = fn(k.data_ptr(), v.data_ptr(), mask.data_ptr(), partial.data_ptr(),
             kv.data_ptr(), ksum.data_ptr(), f, b, lk, e, d, n_split, split_len,
             TYPE_CODES[k.dtype], TYPE_CODES[mask.dtype], _stream(k))
    _raise_on(err, "nla_reduce")
    nla_reduce_kernel.launches += 1
    return kv, ksum


def nla_apply_kernel(q, kv, ksum, n_head: int):
    """Launch ``csrc/nla_apply.cu`` (dense form) on PyTorch's current
    stream: ``(out [F,B,L,E], qs [B,L,E])`` in q's dtype (f32 or bf16). The
    kernel reads f32 Grams: bf16 ones are widened here, an exact cast."""
    _check_apply(q, kv, ksum, q.shape[0])
    _check_tensors([q, kv, ksum])
    kv, ksum = kv.float(), ksum.float()
    b, l, e = q.shape
    d = _head_width(e, n_head)
    f = kv.shape[0]
    out = torch.empty(f, b, l, e, device=q.device, dtype=q.dtype)
    qs = torch.empty(b, l, e, device=q.device, dtype=q.dtype)
    fn = _lib("nla_apply", "gnot_nla_apply", 5, 6)
    err = fn(q.data_ptr(), kv.data_ptr(), ksum.data_ptr(), out.data_ptr(),
             qs.data_ptr(), f, b, l, e, d, TYPE_CODES[q.dtype], _stream(q))
    _raise_on(err, "nla_apply")
    nla_apply_kernel.launches += 1
    return out, qs


def nla_reduce_seg_kernel(k, v, mask, seg, n_seg: int, n_head: int):
    """Launch ``csrc/nla_reduce.cu`` (segment form) on PyTorch's current
    stream: ``(kv [F,S,E,E], ksum [F,S,1,E])`` in f32; input types as
    ``nla_reduce_kernel``'s."""
    _check_kv(k, v, mask)
    f, b, lk, e = k.shape
    if seg.dim() != 2 or seg.shape[0] != b:
        raise ValueError(f"seg must be [B={b}, N], got {tuple(seg.shape)}")
    _seg_tile(lk, seg.shape[1], "nla_reduce_seg")
    _check_tensors([k, v, mask], [seg])
    k, v, mask = _reduce_inputs(k, v, mask)
    d = _head_width(e, n_head)
    n = seg.shape[1]
    n_sm = torch.cuda.get_device_properties(k.device).multi_processor_count
    n_split, split_len = reduce_splits(f, b * n, lk // n, e, n_sm)
    opts = dict(device=k.device, dtype=torch.float32)
    partial = torch.empty(f, b * n * n_split, e * e + e, **opts)
    kv = torch.empty(f, n_seg, e, e, **opts)
    ksum = torch.empty(f, n_seg, 1, e, **opts)
    fn = _lib("nla_reduce", "gnot_nla_reduce_seg", 7, 11)
    err = fn(k.data_ptr(), v.data_ptr(), mask.data_ptr(), seg.data_ptr(),
             partial.data_ptr(), kv.data_ptr(), ksum.data_ptr(), f, b, lk, e, d,
             n, n_seg, n_split, split_len, TYPE_CODES[k.dtype], TYPE_CODES[mask.dtype],
             _stream(k))
    _raise_on(err, "nla_reduce_seg")
    nla_reduce_seg_kernel.launches += 1
    return kv, ksum


def nla_apply_seg_kernel(q, kv, ksum, seg, n_head: int):
    """Launch ``csrc/nla_apply.cu`` (segment form) on PyTorch's current
    stream: ``(out [F,B,L,E], qs [B,L,E])`` in q's dtype; Grams as
    ``nla_apply_kernel``'s."""
    _check_apply(q, kv, ksum, kv.shape[1])
    b, l, e = q.shape
    if seg.dim() != 2 or seg.shape[0] != b:
        raise ValueError(f"seg must be [B={b}, N], got {tuple(seg.shape)}")
    _seg_tile(l, seg.shape[1], "nla_apply_seg")
    _check_tensors([q, kv, ksum], [seg])
    kv, ksum = kv.float(), ksum.float()
    d = _head_width(e, n_head)
    f, n_seg = kv.shape[:2]
    out = torch.empty(f, b, l, e, device=q.device, dtype=q.dtype)
    qs = torch.empty(b, l, e, device=q.device, dtype=q.dtype)
    fn = _lib("nla_apply", "gnot_nla_apply_seg", 6, 8)
    err = fn(q.data_ptr(), kv.data_ptr(), ksum.data_ptr(), seg.data_ptr(),
             out.data_ptr(), qs.data_ptr(), f, b, l, e, d, seg.shape[1], n_seg,
             TYPE_CODES[q.dtype], _stream(q))
    _raise_on(err, "nla_apply_seg")
    nla_apply_seg_kernel.launches += 1
    return out, qs


#: Kernel launches so far: each wrapper adds one where it launches.
nla_reduce_kernel.launches = 0
nla_apply_kernel.launches = 0
nla_reduce_seg_kernel.launches = 0
nla_apply_seg_kernel.launches = 0


# --------------------------------------------------------------------------
# Public stages: autograd Functions, the kernel on CUDA tensors.
# --------------------------------------------------------------------------


def _vjp(fn, inputs, cotangents):
    """Gradients of ``fn`` at ``inputs`` along ``cotangents``, recomputed
    through the plain version."""
    with torch.enable_grad():
        xs = [x.detach().requires_grad_(True) for x in inputs]
        return torch.autograd.grad(fn(*xs), xs, cotangents)


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, k, v, mask, n_head):
        ctx.save_for_backward(k, v, mask)
        ctx.n_head = n_head
        if k.is_cuda:
            return nla_reduce_kernel(k, v, mask, n_head)
        return reduce_reference(k, v, mask, n_head)

    @staticmethod
    def backward(ctx, g_kv, g_ksum):
        k, v, mask = ctx.saved_tensors
        dk, dv = _vjp(
            lambda k_, v_: reduce_reference(k_, v_, mask, ctx.n_head), (k, v), (g_kv, g_ksum)
        )
        return dk, dv, None, None


class _Apply(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, kv, ksum, n_head):
        ctx.save_for_backward(q, kv, ksum)
        ctx.n_head = n_head
        if q.is_cuda:
            return nla_apply_kernel(q, kv, ksum, n_head)
        return apply_reference(q, kv, ksum, n_head)

    @staticmethod
    def backward(ctx, g_out, g_qs):
        q, kv, ksum = ctx.saved_tensors
        dq, dkv, dksum = _vjp(
            lambda *a: apply_reference(*a, ctx.n_head), (q, kv, ksum), (g_out, g_qs)
        )
        return dq, dkv, dksum, None


class _ReduceSeg(torch.autograd.Function):
    @staticmethod
    def forward(ctx, k, v, mask, seg, n_seg, n_head):
        ctx.save_for_backward(k, v, mask, seg)
        ctx.n_seg, ctx.n_head = n_seg, n_head
        if k.is_cuda:
            return nla_reduce_seg_kernel(k, v, mask, seg, n_seg, n_head)
        return reduce_seg_reference(k, v, mask, seg, n_seg, n_head)

    @staticmethod
    def backward(ctx, g_kv, g_ksum):
        k, v, mask, seg = ctx.saved_tensors
        dk, dv = _vjp(
            lambda k_, v_: reduce_seg_reference(k_, v_, mask, seg, ctx.n_seg, ctx.n_head),
            (k, v), (g_kv, g_ksum),
        )
        return dk, dv, None, None, None, None


class _ApplySeg(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, kv, ksum, seg, n_head):
        ctx.save_for_backward(q, kv, ksum, seg)
        ctx.n_head = n_head
        if q.is_cuda:
            return nla_apply_seg_kernel(q, kv, ksum, seg, n_head)
        return apply_seg_reference(q, kv, ksum, seg, n_head)

    @staticmethod
    def backward(ctx, g_out, g_qs):
        q, kv, ksum, seg = ctx.saved_tensors
        dq, dkv, dksum = _vjp(
            lambda q_, kv_, ks_: apply_seg_reference(q_, kv_, ks_, seg, ctx.n_head),
            (q, kv, ksum), (g_out, g_qs),
        )
        return dq, dkv, dksum, None, None


def nla_reduce(k, v, mask, n_head: int):
    """Masked Gram accumulation: ``(kv [F,B,E,E], k_sum [F,B,1,E])`` in f32."""
    return _Reduce.apply(k, v, mask, n_head)


def nla_apply(q, kv, ksum, n_head: int):
    """Apply the Gram accumulators to the query stream: ``(out [F,B,L,E],
    q_softmaxed [B,L,E])`` in q's dtype, heads merged."""
    return _Apply.apply(q, kv, ksum, n_head)


def nla_reduce_seg(k, v, mask, seg, n_seg: int, n_head: int):
    """Segment-scattered Gram accumulation over packed key rows: ``seg
    [B, N]`` chunk -> slot ids (``Lk % N == 0``, pad chunks carry
    ``n_seg``). Returns ``(kv [F,S,E,E], k_sum [F,S,1,E])``; empty slots
    are exactly zero."""
    _seg_tile(k.shape[2], seg.shape[1], "nla_reduce_seg")
    return _ReduceSeg.apply(k, v, mask, seg.to(torch.int32), n_seg, n_head)


def nla_apply_seg(q, kv, ksum, seg, n_head: int):
    """Apply per-segment Grams to packed query rows: each chunk gathers its
    own segment's ``kv``/``k_sum``; pad chunks give 0. Returns
    ``(out [F,B,L,E], q_softmaxed [B,L,E])``."""
    _seg_tile(q.shape[1], seg.shape[1], "nla_apply_seg")
    return _ApplySeg.apply(q, kv, ksum, seg.to(torch.int32), n_head)


def fused_nla(q, k, v, mask, n_head: int):
    """Fused normalized linear attention in the merged-head layout:
    ``q [B,L,E]`` raw queries, ``k``/``v [F,B,Lk,E]``, ``mask [F,B,Lk]``
    -> ``(out [F,B,L,E], q_softmaxed [B,L,E])``."""
    kv, ksum = nla_reduce(k, v, mask, n_head)
    return nla_apply(q, kv, ksum, n_head)


def fused_nla_packed(q, k, v, mask, q_seg, kv_seg, n_seg: int, n_head: int):
    """Fused normalized linear attention over packed rows. ``q_seg`` and
    ``kv_seg`` are ``[B, N]`` chunk -> segment tables of the query and key
    rows (the two packings may differ; segment ids are shared). Tokens
    never attend across segment boundaries."""
    kv, ksum = nla_reduce_seg(k, v, mask, kv_seg, n_seg, n_head)
    return nla_apply_seg(q, kv, ksum, q_seg, n_head)


def fused_nla_sp(q, k, v, mask, n_head: int, mesh, *, data_axis: str | None = None,
                 seq_axis: str | None = "seq", model_axis: str | None = None,
                 sp_collective: str = "psum"):
    """Distributed fused attention over a DP x SP x TP rank mesh
    (``gnot_tpu/ops/pallas_attention.py::fused_nla_sp``). Every rank passes
    the whole ``q``, ``k``, ``v``, ``mask`` (the layout of ``fused_nla``) and
    gets back ITS blocks of ``(out [F,B,L,E], qs [B,L,E])``: rows of B by
    ``data_axis``, of L and Lk by ``seq_axis``, lanes of E by ``model_axis``
    (whole head groups). On each rank: ``nla_reduce`` on its key block, the
    sum of the Gram partials and ``k_sum`` over ``seq_axis`` (a fixed ``[F,
    B, E, E]`` payload whatever the sequence length), ``nla_apply`` on its
    query block: the CUDA kernels on CUDA tensors, their plain versions on
    CPU ones. ``sp_collective`` is ``"psum"`` (one all-reduce) or ``"ring"``
    (S-1 neighbour hops, ``ops/collectives.ring_allreduce``); both are
    differentiable, the all-reduce's backward an all-reduce, the ring's the
    ring in reverse. The gradients with respect to the whole inputs are this
    rank's part: their sum over the ranks is the whole gradient."""
    from gnot_tpu_torch.parallel.mesh import shard_tensor

    if sp_collective not in ("psum", "ring"):
        raise ValueError(f"unknown sp_collective {sp_collective!r}")
    model_size = mesh.size(model_axis) if model_axis else 1
    if n_head % model_size:
        raise ValueError(
            f"n_head={n_head} must be divisible by the model axis size "
            f"{model_size} (TP shards whole head groups)"
        )
    local_heads = n_head // model_size

    def block(t, spec):
        # The kernels read contiguous, 16-byte aligned tensors.
        t = shard_tensor(t, spec, mesh)
        return t.clone() if t.is_contiguous() and t.data_ptr() % 16 else t.contiguous()

    q_l = block(q, (data_axis, seq_axis, model_axis))
    k_l = block(k, (None, data_axis, seq_axis, model_axis))
    v_l = block(v, (None, data_axis, seq_axis, model_axis))
    m_l = block(mask, (None, data_axis, seq_axis))
    kv, ksum = nla_reduce(k_l, v_l, m_l, local_heads)
    if seq_axis:
        group = mesh.group(seq_axis)
        reduce = ring_allreduce if sp_collective == "ring" else all_reduce_sum
        kv, ksum = reduce(kv, group), reduce(ksum, group)
    return nla_apply(q_l, kv, ksum, local_heads)
