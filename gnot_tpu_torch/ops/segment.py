"""Masked per-graph (per-sample) reductions and losses.

Port of ``gnot_tpu/ops/segment.py``. The reference pools each graph's
nodes with DGL segment sums after unpadding (``loss.py:4-23``); here the
batch stays padded ``[B, L, C]`` and a 0/1 node mask folds the ragged
structure in: the sum over a graph's nodes is the masked sum over its
padded row. In the packed layout a graph is a segment of a shared row,
and the sums run per segment through a token -> segment one-hot
(``PACKED_LOSSES``).
"""

from __future__ import annotations

import torch


def masked_segment_sum(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """``[B, L, C]`` values and a ``[B, L]`` 0/1 mask to per-sample sums
    ``[B, C]`` (DGL ``SumPooling`` over each graph)."""
    return torch.einsum("blc,bl->bc", values, mask.to(values.dtype))


def masked_segment_mean(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Per-sample masked mean over the length axis (DGL ``AvgPooling``)."""
    n = mask.sum(dim=1).to(values.dtype)
    return masked_segment_sum(values, mask) / n[:, None]


def rel_l2_per_sample(predictions, targets, mask) -> torch.Tensor:
    """``[B]`` per-graph relative L2, averaged over channels."""
    num = masked_segment_sum((predictions - targets) ** 2, mask)
    den = masked_segment_sum(targets**2, mask)
    return torch.sqrt(num / den).mean(dim=1)


def mse_per_sample(predictions, targets, mask) -> torch.Tensor:
    """``[B]`` per-graph node-mean squared error, averaged over channels."""
    return masked_segment_mean((predictions - targets) ** 2, mask).mean(dim=1)


def rel_l2_loss(predictions, targets, mask) -> torch.Tensor:
    """``mean_{g,c} sqrt(sum_l (p-t)^2 / sum_l t^2)``, the reference's
    ``RelL2Loss`` (loss.py:19-23)."""
    num = masked_segment_sum((predictions - targets) ** 2, mask)
    den = masked_segment_sum(targets**2, mask)
    return torch.sqrt(num / den).mean()


def mse_loss(predictions, targets, mask) -> torch.Tensor:
    """Per-graph node-mean of squared error, then the mean over graphs and
    channels: the reference's ``MSELoss`` (loss.py:9-12)."""
    return masked_segment_mean((predictions - targets) ** 2, mask).mean()


LOSSES = {"rel_l2": rel_l2_loss, "mse": mse_loss}
PER_SAMPLE_LOSSES = {"rel_l2": rel_l2_per_sample, "mse": mse_per_sample}


# --- Packed layout ("pack, don't pad": several samples per row) ---------


def _token_one_hot(node_seg: torch.Tensor, length: int, n_seg: int, dtype) -> torch.Tensor:
    """``[R, L, S]`` token -> segment one-hot from the ``[R, N]`` chunk
    table; pad chunks (id ``n_seg``) get zero rows."""
    tok_seg = torch.repeat_interleave(node_seg, length // node_seg.shape[1], dim=1)
    return torch.nn.functional.one_hot(tok_seg.long(), n_seg + 1)[..., :n_seg].to(dtype)


def packed_segment_sums(
    values: torch.Tensor, mask: torch.Tensor, node_seg: torch.Tensor, n_seg: int
) -> torch.Tensor:
    """Per-segment masked sums ``[S, C]`` of packed ``[R, L, C]`` values
    under a ``[R, L]`` token mask: the packed ``masked_segment_sum``."""
    oh = _token_one_hot(node_seg, values.shape[1], n_seg, values.dtype)
    oh = oh * mask[..., None].to(values.dtype)
    return torch.einsum("rlc,rls->sc", values, oh)


def _packed_counts(mask: torch.Tensor, node_seg: torch.Tensor, n_seg: int) -> torch.Tensor:
    """``[S]`` real-token counts per segment (0 for empty slots)."""
    oh = _token_one_hot(node_seg, mask.shape[1], n_seg, torch.float32)
    return torch.einsum("rl,rls->s", mask.float(), oh)


def packed_rel_l2_per_seg(
    predictions, targets, mask, node_seg, n_seg: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """``([S] metric, [S] valid)``: per-segment relative L2 and a 0/1
    mask of the slots that hold a sample (an empty slot's metric is 0)."""
    num = packed_segment_sums((predictions - targets) ** 2, mask, node_seg, n_seg)
    den = packed_segment_sums(targets**2, mask, node_seg, n_seg)
    valid = (_packed_counts(mask, node_seg, n_seg) > 0).to(num.dtype)
    # An empty slot has num == den == 0, and sqrt'(0) is inf: masking
    # only the value would still carry 0 * inf = nan into the gradients.
    # Ratio 1 inside the sqrt for empty slots, then the value zeroed.
    ratio = num / torch.where(den == 0.0, torch.ones_like(den), den)
    ratio = torch.where(valid[:, None] > 0, ratio, torch.ones_like(ratio))
    per = torch.sqrt(ratio).mean(dim=1)
    return per * valid, valid


def packed_rel_l2_loss(predictions, targets, mask, node_seg, n_seg: int) -> torch.Tensor:
    """Mean per-sample relative L2 over the samples present in the
    dispatch: the packed ``rel_l2_loss``."""
    per, valid = packed_rel_l2_per_seg(predictions, targets, mask, node_seg, n_seg)
    return per.sum() / torch.clamp(valid.sum(), min=1.0)


def packed_mse_loss(predictions, targets, mask, node_seg, n_seg: int) -> torch.Tensor:
    """The packed ``mse_loss``: per-segment node-mean squared error, mean
    over the present segments and the channels."""
    s = packed_segment_sums((predictions - targets) ** 2, mask, node_seg, n_seg)
    n = _packed_counts(mask, node_seg, n_seg)
    valid = (n > 0).to(s.dtype)
    per = (s / torch.clamp(n, min=1.0)[:, None].to(s.dtype)).mean(dim=1)
    return (per * valid).sum() / torch.clamp(valid.sum(), min=1.0)


PACKED_LOSSES = {"rel_l2": packed_rel_l2_loss, "mse": packed_mse_loss}
