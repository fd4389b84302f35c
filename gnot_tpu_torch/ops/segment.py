"""Masked per-graph (per-sample) reductions and losses.

Port of ``gnot_tpu/ops/segment.py``. The reference pools each graph's
nodes with DGL segment sums after unpadding (``loss.py:4-23``); here the
batch stays padded ``[B, L, C]`` and a 0/1 node mask folds the ragged
structure in: the sum over a graph's nodes is the masked sum over its
padded row. In the packed layout a graph is a segment of a shared row,
and the sums run per segment through a token -> segment one-hot
(``PACKED_LOSSES``).

On a mesh's sequence axis each rank holds a block of every graph's
nodes: the padded losses take ``seq_group`` and sum each graph's pools
over it before the per-graph ratio (``ops/collectives.reduce_from``:
every rank then computes the same loss, so the gradient of each rank's
partial sum is the whole one's).
"""

from __future__ import annotations

import torch

from gnot_tpu_torch.ops.collectives import reduce_from


def masked_segment_sum(values: torch.Tensor, mask: torch.Tensor,
                       seq_group=None) -> torch.Tensor:
    """``[B, L, C]`` values and a ``[B, L]`` 0/1 mask to per-sample sums
    ``[B, C]`` (DGL ``SumPooling`` over each graph), summed over the
    sequence axis's ranks with ``seq_group``."""
    return reduce_from(torch.einsum("blc,bl->bc", values, mask.to(values.dtype)), seq_group)


def masked_segment_mean(values: torch.Tensor, mask: torch.Tensor,
                        seq_group=None) -> torch.Tensor:
    """Per-sample masked mean over the length axis (DGL ``AvgPooling``)."""
    n = reduce_from(mask.sum(dim=1).to(values.dtype), seq_group)
    return masked_segment_sum(values, mask, seq_group) / n[:, None]


def rel_l2_per_sample(predictions, targets, mask, seq_group=None) -> torch.Tensor:
    """``[B]`` per-graph relative L2, averaged over channels."""
    num = masked_segment_sum((predictions - targets) ** 2, mask, seq_group)
    den = masked_segment_sum(targets**2, mask, seq_group)
    return torch.sqrt(num / den).mean(dim=1)


def mse_per_sample(predictions, targets, mask, seq_group=None) -> torch.Tensor:
    """``[B]`` per-graph node-mean squared error, averaged over channels."""
    return masked_segment_mean((predictions - targets) ** 2, mask, seq_group).mean(dim=1)


def rel_l2_loss(predictions, targets, mask, seq_group=None) -> torch.Tensor:
    """``mean_{g,c} sqrt(sum_l (p-t)^2 / sum_l t^2)``, the reference's
    ``RelL2Loss`` (loss.py:19-23)."""
    num = masked_segment_sum((predictions - targets) ** 2, mask, seq_group)
    den = masked_segment_sum(targets**2, mask, seq_group)
    return torch.sqrt(num / den).mean()


def mse_loss(predictions, targets, mask, seq_group=None) -> torch.Tensor:
    """Per-graph node-mean of squared error, then the mean over graphs and
    channels: the reference's ``MSELoss`` (loss.py:9-12)."""
    return masked_segment_mean((predictions - targets) ** 2, mask, seq_group).mean()


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


def packed_rel_l2_sums(predictions, targets, mask, node_seg, n_seg: int):
    """``(sum, count)``: the per-sample relative L2 summed over the samples
    present in the dispatch, and their count."""
    per, valid = packed_rel_l2_per_seg(predictions, targets, mask, node_seg, n_seg)
    return per.sum(), valid.sum()


def packed_mse_sums(predictions, targets, mask, node_seg, n_seg: int):
    """``(sum, count)`` of the packed ``mse_loss``: per-segment node-mean
    squared error (mean over the channels), summed over the present
    segments, and their count."""
    s = packed_segment_sums((predictions - targets) ** 2, mask, node_seg, n_seg)
    n = _packed_counts(mask, node_seg, n_seg)
    valid = (n > 0).to(s.dtype)
    per = (s / torch.clamp(n, min=1.0)[:, None].to(s.dtype)).mean(dim=1)
    return (per * valid).sum(), valid.sum()


def packed_rel_l2_loss(predictions, targets, mask, node_seg, n_seg: int) -> torch.Tensor:
    """Mean per-sample relative L2 over the samples present in the
    dispatch: the packed ``rel_l2_loss``."""
    total, count = packed_rel_l2_sums(predictions, targets, mask, node_seg, n_seg)
    return total / torch.clamp(count, min=1.0)


def packed_mse_loss(predictions, targets, mask, node_seg, n_seg: int) -> torch.Tensor:
    """The packed ``mse_loss``: per-segment node-mean squared error, mean
    over the present segments and the channels."""
    total, count = packed_mse_sums(predictions, targets, mask, node_seg, n_seg)
    return total / torch.clamp(count, min=1.0)


PACKED_LOSSES = {"rel_l2": packed_rel_l2_loss, "mse": packed_mse_loss}
#: The packed losses as ``(sum, count)`` over one rank's segments: on a
#: data axis the loss is the sums over every rank's, divided.
PACKED_LOSS_SUMS = {"rel_l2": packed_rel_l2_sums, "mse": packed_mse_sums}
