"""Normalized (Galerkin-style) linear attention — the GNOT core op.

Port of the float32 branch of ``gnot_tpu/ops/attention.py``. The JAX
package leaves this work to XLA einsums, so it stays plain torch here:

* queries AND keys are softmax-normalized over the **feature** (head_dim)
  axis, not the sequence axis;
* the normalizer is ``alpha = 1 / sum_d(q_d * (sum_l k_ld))``;
* the output is ``alpha * q @ (k^T v)``;
* with ``kv_mask`` (masked mode) padded key rows are zeroed after the
  feature softmax, so they drop out of both reductions.
"""

from __future__ import annotations

import torch


def feature_softmax(x: torch.Tensor) -> torch.Tensor:
    """Softmax over the trailing (head feature) axis in float32."""
    return torch.softmax(x.float(), dim=-1).to(x.dtype)


def normalized_linear_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    kv_mask: torch.Tensor | None = None,
    eps: float = 0.0,
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

    Returns:
      ``[..., B, H, Lq, D]`` attention output (pre residual / out-projection).
    """
    if kv_mask is not None:
        k = k * kv_mask[..., None, :, None].to(k.dtype)
    k_sum = k.sum(dim=-2)  # [..., B, H, D]
    denom = torch.matmul(q, k_sum.unsqueeze(-1)).squeeze(-1)  # [..., B, H, Lq]
    if kv_mask is not None:
        # An all-masked key set (a record with an empty input function)
        # has k_sum == 0 exactly — softmaxed k rows are strictly
        # positive, so any unmasked row makes denom > 0. Select 1 there
        # so the (also exactly zero) numerator gives a clean 0 instead
        # of inf * 0 = nan.
        denom = torch.where(denom == 0.0, torch.ones_like(denom), denom)
    alpha = 1.0 / (denom + eps)
    kv = torch.matmul(k.transpose(-1, -2), v)  # [..., B, H, D, D]
    out = torch.matmul(q, kv)  # [..., B, H, Lq, D]
    return alpha.unsqueeze(-1) * out


def split_heads(x: torch.Tensor, n_head: int) -> torch.Tensor:
    """``[..., L, E] -> [..., H, L, E/H]`` (reference model.py:57-58)."""
    *lead, l, e = x.shape
    return x.reshape(*lead, l, n_head, e // n_head).transpose(-3, -2)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """``[..., H, L, D] -> [..., L, H*D]`` (reference model.py:81,83)."""
    *lead, h, l, d = x.shape
    return x.transpose(-3, -2).reshape(*lead, l, h * d)
