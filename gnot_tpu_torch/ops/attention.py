"""Normalized (Galerkin-style) linear attention — the GNOT core op.

Port of ``gnot_tpu/ops/attention.py``. The JAX package leaves this work
to XLA einsums, so it stays plain torch here:

* queries AND keys are softmax-normalized over the **feature** (head_dim)
  axis, not the sequence axis;
* the normalizer is ``alpha = 1 / sum_d(q_d * (sum_l k_ld))``;
* the output is ``alpha * q @ (k^T v)``;
* with ``kv_mask`` (masked mode) padded key rows are zeroed after the
  feature softmax, so they drop out of both reductions;
* on a mesh's sequence axis (``seq_group``) each rank holds a block of
  the key rows: ``k_sum`` and ``k^T v`` are sums over them, so each is
  all-reduced over the axis (``ops/collectives.all_reduce_sum``, whose
  backward all-reduces too: every rank's queries read the global Gram);
* operands below float32 (bf16 serving, ``models/precision.py``) take
  the policy branch: the Gram ``k^T v``, ``k_sum`` and the normalizer
  ``1/<q, k_sum>`` are computed in f32 and only the output is cast back
  to q's dtype. The operands are upcast first (exact for bf16): a torch
  matmul of bf16 tensors rounds its result to bf16, where JAX's
  ``preferred_element_type=float32`` keeps it f32. The all-f32 path is
  the historical one, unchanged.

``packed_normalized_linear_attention`` is the same op over packed rows
(several samples per row as chunk-aligned segments): the einsum path the
JAX packed model takes, and the yardstick ``fused_nla_packed`` is held
against.
"""

from __future__ import annotations

import torch

from gnot_tpu_torch.ops.collectives import all_reduce_sum


def feature_softmax(x: torch.Tensor) -> torch.Tensor:
    """Softmax over the trailing (head feature) axis in float32."""
    return torch.softmax(x.float(), dim=-1).to(x.dtype)


def _reduced_precision(*tensors: torch.Tensor) -> bool:
    """True when any operand is below float32: the switch for the
    f32-accumulation branch of the precision policy."""
    return any(t.dtype != torch.float32 for t in tensors)


def normalized_linear_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    kv_mask: torch.Tensor | None = None,
    eps: float = 0.0,
    seq_group=None,
) -> torch.Tensor:
    """Core normalized linear attention.

    Args:
      q: ``[B, H, Lq, D]`` — already feature-softmaxed queries.
      k: ``[..., B, H, Lk, D]`` — already feature-softmaxed keys; leading
        axes (the stacked input functions of cross attention) broadcast
        against ``q``.
      v: ``[..., B, H, Lk, D]`` — values (not normalized).
      kv_mask: optional ``[..., B, Lk]`` 0/1 mask; masked rows are
        removed from both ``k_sum`` and ``k^T v``.
      eps: optional denominator guard (0 matches the reference).
      seq_group: the sequence axis's process group when ``k``/``v`` are
        this rank's block of the key rows (None: all of them).

    Returns:
      ``[..., B, H, Lq, D]`` attention output (pre residual / out-projection),
      in q's dtype.
    """
    if kv_mask is not None:
        k = k * kv_mask[..., None, :, None].to(k.dtype)
    out_dtype = q.dtype
    lowp = _reduced_precision(q, k, v)
    if lowp:
        q, k, v = q.float(), k.float(), v.float()
    k_sum = all_reduce_sum(k.sum(dim=-2), seq_group)  # [..., B, H, D]
    denom = torch.matmul(q, k_sum.unsqueeze(-1)).squeeze(-1)  # [..., B, H, Lq]
    if kv_mask is not None:
        # An all-masked key set (a record with an empty input function)
        # has k_sum == 0 exactly — softmaxed k rows are strictly
        # positive, so any unmasked row makes denom > 0. Select 1 there
        # so the (also exactly zero) numerator gives a clean 0 instead
        # of inf * 0 = nan.
        denom = torch.where(denom == 0.0, torch.ones_like(denom), denom)
    alpha = 1.0 / (denom + eps)
    kv = all_reduce_sum(torch.matmul(k.transpose(-1, -2), v), seq_group)  # [..., B, H, D, D]
    out = torch.matmul(q, kv)  # [..., B, H, Lq, D]
    out = alpha.unsqueeze(-1) * out
    return out.to(out_dtype) if lowp else out


def segment_one_hot(seg: torch.Tensor, n_seg: int) -> torch.Tensor:
    """``[.., N]`` chunk->segment ids -> ``[.., N, S]`` float32 one-hot map;
    the pad id ``n_seg`` (and any id outside ``[0, S)``) maps to a zero
    row."""
    return (seg[..., None] == torch.arange(n_seg, device=seg.device)).float()


def packed_normalized_linear_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    q_seg_oh: torch.Tensor,
    kv_seg_oh: torch.Tensor,
    kv_mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """Normalized linear attention over packed sequences.

    Several samples (segments) share one sequence row, each a contiguous
    chunk-aligned span. ``k_sum`` and ``k^T v`` are sums over the
    sequence, so per-chunk partial Grams scatter-add into per-segment
    Grams through the one-hot maps, and each query chunk gathers its
    segment's Gram back: no token attends across a segment boundary.

    Args:
      q: ``[Bq, H, Lq, D]`` feature-softmaxed queries, ``Lq = Nq * C``.
      k: ``[Bk, H, Lk, D]`` feature-softmaxed keys, ``Lk = Nk * C'``; the
        key rows may be packed differently from the query rows (segment
        ids are shared).
      v: ``[Bk, H, Lk, D]`` values.
      q_seg_oh: ``[Bq, Nq, S]`` one-hot chunk->segment map
        (``segment_one_hot``); pad chunks have all-zero rows.
      kv_seg_oh: ``[Bk, Nk, S]`` likewise for the key/value chunks.
      kv_mask: optional ``[Bk, Lk]`` 0/1 token mask (segment tails that do
        not fill their last chunk).

    Returns:
      ``[Bq, H, Lq, D]``, rows aligned with ``q``, in q's dtype; below
      float32 every contraction and the normalizer are f32.
    """
    bq, h, lq, d = q.shape
    bk, _, lk, _ = k.shape
    nq, nk = q_seg_oh.shape[-2], kv_seg_oh.shape[-2]
    if lq % nq or lk % nk:
        raise ValueError(
            f"sequence lengths {lq}/{lk} not divisible by chunk counts {nq}/{nk}"
        )
    cq, ck = lq // nq, lk // nk
    if kv_mask is not None:
        k = k * kv_mask[:, None, :, None].to(k.dtype)
    out_dtype = q.dtype
    lowp = _reduced_precision(q, k, v)
    if lowp:
        q, k, v = q.float(), k.float(), v.float()
    oh_k = kv_seg_oh.to(k.dtype)
    oh_q = q_seg_oh.to(q.dtype)

    kc = k.reshape(bk, h, nk, ck, d)
    vc = v.reshape(bk, h, nk, ck, d)
    # Per-chunk partial Grams and key sums, then scatter-add per segment.
    kv_chunk = torch.einsum("bhncd,bhnce->bhnde", kc, vc)  # [Bk,H,Nk,D,D]
    ks_chunk = kc.sum(dim=3)  # [Bk,H,Nk,D]
    kv_seg_gram = torch.einsum("bns,bhnde->shde", oh_k, kv_chunk)  # [S,H,D,D]
    ks_seg_sum = torch.einsum("bns,bhnd->shd", oh_k, ks_chunk)  # [S,H,D]
    # Gather each query chunk's segment Gram / key sum.
    kv_q = torch.einsum("bns,shde->bhnde", oh_q, kv_seg_gram)  # [Bq,H,Nq,D,D]
    ks_q = torch.einsum("bns,shd->bhnd", oh_q, ks_seg_sum)  # [Bq,H,Nq,D]

    qc = q.reshape(bq, h, nq, cq, d)
    denom = torch.einsum("bhncd,bhnd->bhnc", qc, ks_q)
    # Pad chunks/tokens and empty segments have denom == 0 exactly (the
    # softmaxed k rows are strictly positive); select 1 for a clean 0.
    denom = torch.where(denom == 0.0, torch.ones_like(denom), denom)
    out = torch.einsum("bhncd,bhnde->bhnce", qc, kv_q)
    out = (out / denom[..., None]).reshape(bq, h, lq, d)
    return out.to(out_dtype) if lowp else out


def split_heads(x: torch.Tensor, n_head: int) -> torch.Tensor:
    """``[..., L, E] -> [..., H, L, E/H]`` (reference model.py:57-58)."""
    *lead, l, e = x.shape
    return x.reshape(*lead, l, n_head, e // n_head).transpose(-3, -2)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """``[..., H, L, D] -> [..., L, H*D]`` (reference model.py:81,83)."""
    *lead, h, l, d = x.shape
    return x.transpose(-3, -2).reshape(*lead, l, h * d)
