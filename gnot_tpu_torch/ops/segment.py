"""Masked per-graph (per-sample) reductions and losses.

Port of ``gnot_tpu/ops/segment.py`` for the padded layout. The reference
pools each graph's nodes with DGL segment sums after unpadding
(``loss.py:4-23``); here the batch stays padded ``[B, L, C]`` and a 0/1
node mask folds the ragged structure in: the sum over a graph's nodes is
the masked sum over its padded row. The packed-layout losses wait for
packed training.
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
