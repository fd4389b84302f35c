"""GNOT — General Neural Operator Transformer (arXiv 2302.14376).

Port of ``gnot_tpu/models/gnot.py`` for masked mode, unpacked, float32
or bfloat16 compute, with the reference's quirks as they are:

* geometry gating is computed on the **raw coordinates only** (before
  the theta concat), softmaxed over experts in f32, and reused by every
  block (model.py:148,155-156,169);
* there is **no LayerNorm anywhere**;
* the residual inside attention adds the softmaxed q (see layers.py).

With ``dtype="bfloat16"`` every block computes in bf16 on its weights
cast to bf16 (bf16 training keeps f32 weights and casts them in each
layer, as flax's ``Dense(dtype=...)``; bf16 serving holds a bf16 copy,
``models/precision.py``), the gate scores stay f32, and the output head
reads f32 input: its weights, bf16 in a served copy as every float
weight is, are promoted to f32 there, as flax's ``dtype=None`` head
promotes JAX's cast tree.

With ``remat`` each block's activations are recomputed in the backward
instead of kept (``torch.utils.checkpoint``), as ``nn.remat(HNABlock)``.

Parity mode, the stacked-layer layout and the packed layout are not
ported yet; the model refuses them.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from gnot_tpu_torch.config import ModelConfig, NotPortedError
from gnot_tpu_torch.models.layers import GatedExpertFfn, LinearAttention, Mlp
from gnot_tpu_torch.models.precision import torch_dtype


class HNABlock(nn.Module):
    """One Heterogeneous Normalized Attention encoder layer
    (reference model.py:118-139): cross-attention -> gated expert FFN ->
    residual, then self-attention -> gated expert FFN -> residual."""

    def __init__(self, cfg: ModelConfig, has_funcs: bool, generator=None):
        super().__init__()
        n_funcs = cfg.n_input_functions if has_funcs else 0
        dtype = model_dtype(cfg)
        ffn = dict(
            in_dim=cfg.n_attn_hidden_dim, ffn_impl=cfg.ffn_impl,
            gelu=cfg.gelu, generator=generator, dtype=dtype,
        )
        self.cross_attention = LinearAttention(
            cfg.n_attn_hidden_dim, cfg.n_head, n_funcs,
            query_dim=cfg.n_input_hidden_dim,
            func_dim=cfg.n_input_hidden_dim,
            generator=generator, dtype=dtype,
        )
        self.ffn1 = GatedExpertFfn(
            cfg.n_expert, cfg.n_mlp_num_layers, cfg.n_mlp_hidden_dim,
            cfg.n_mlp_hidden_dim, **ffn,
        )
        self.self_attention = LinearAttention(
            cfg.n_attn_hidden_dim, cfg.n_head, 0,
            query_dim=cfg.n_input_hidden_dim, generator=generator, dtype=dtype,
        )
        self.ffn2 = GatedExpertFfn(
            cfg.n_expert, cfg.n_mlp_num_layers, cfg.n_mlp_hidden_dim,
            cfg.n_mlp_hidden_dim, **ffn,
        )

    def forward(
        self,
        scores: torch.Tensor,
        query: torch.Tensor,
        input_functions: torch.Tensor | None = None,
        *,
        node_mask: torch.Tensor | None = None,
        func_mask: torch.Tensor | None = None,
    ) -> torch.Tensor:
        cross = self.cross_attention(
            query, input_functions, query_mask=node_mask, func_mask=func_mask
        )
        query = query + self.ffn1(cross, scores)
        self_out = self.self_attention(query, query_mask=node_mask)
        return query + self.ffn2(self_out, scores)


def model_dtype(cfg: ModelConfig) -> torch.dtype | None:
    """The block stack's compute dtype: None (each layer's own, f32) for
    float32 configs, as ``gnot_tpu.models.gnot.model_dtype``."""
    return torch_dtype(cfg.dtype) if cfg.dtype != "float32" else None


def gating_scores(gating_out: torch.Tensor) -> torch.Tensor:
    """Softmax over experts in f32, computed once (model.py:155-156)."""
    return torch.softmax(gating_out.float(), dim=-1)


def query_features(coords: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """theta broadcast along L, concat to coords (model.py:158-159)."""
    theta_b = theta[:, None, :].expand(coords.shape[0], coords.shape[1], theta.shape[-1])
    return torch.cat([coords, theta_b], dim=-1)


class GNOT(nn.Module):
    """Full GNOT model (reference model.py:142-172). Parameter names
    follow the JAX tree: ``gating``, ``x_embed``, ``input_func_mlps``,
    ``block_{i}``, ``out_mlp``."""

    def __init__(self, config: ModelConfig, *, generator: torch.Generator | None = None):
        super().__init__()
        cfg = self.config = config
        if cfg.attention_mode != "masked":
            raise NotPortedError("the port runs masked mode only; parity mode is not ported yet")
        if cfg.scan_layers:
            raise NotPortedError("scan_layers (the stacked-layer layout) is not ported yet")
        has_funcs = cfg.n_input_functions > 0
        dtype = model_dtype(cfg)
        # Module order fixes the order the generator draws weights in.
        self.gating = Mlp(
            cfg.input_dim, cfg.n_mlp_num_layers, cfg.n_mlp_hidden_dim,
            cfg.n_expert, cfg.gelu, generator=generator, dtype=dtype,
        )
        self.x_embed = Mlp(
            cfg.input_dim + cfg.theta_dim, cfg.n_mlp_num_layers,
            cfg.n_input_hidden_dim, cfg.n_input_hidden_dim, cfg.gelu,
            generator=generator, dtype=dtype,
        )
        if has_funcs:
            self.input_func_mlps = Mlp(
                cfg.input_func_dim, cfg.n_mlp_num_layers, cfg.n_mlp_hidden_dim,
                cfg.n_input_hidden_dim, cfg.gelu,
                stack=cfg.n_input_functions, generator=generator, dtype=dtype,
            )
        for i in range(cfg.n_attn_layers):
            self.add_module(f"block_{i}", HNABlock(cfg, has_funcs, generator))
        # The output head computes in the promoted dtype of its f32 input
        # and its weights (dtype None): always f32 (``out_module``).
        self.out_mlp = Mlp(
            cfg.n_input_hidden_dim, cfg.n_mlp_num_layers, cfg.n_mlp_hidden_dim,
            cfg.out_dim, cfg.gelu, generator=generator,
        )

    def forward(
        self,
        coords: torch.Tensor,
        theta: torch.Tensor,
        input_functions: torch.Tensor | None = None,
        *,
        node_mask: torch.Tensor | None = None,
        func_mask: torch.Tensor | None = None,
    ) -> torch.Tensor:
        cfg = self.config
        # Geometry gating on raw coordinates, computed once.
        scores = gating_scores(self.gating(coords))
        query = self.x_embed(query_features(coords, theta))
        funcs = None
        if cfg.n_input_functions > 0:
            if input_functions is None:
                raise ValueError(
                    f"the model was built for {cfg.n_input_functions} input "
                    "functions but was called without them"
                )
            funcs = self.input_func_mlps(input_functions)  # [F, B, Lf, D]
        for i in range(cfg.n_attn_layers):
            block = getattr(self, f"block_{i}")
            args = (scores, query, funcs)
            kw = dict(node_mask=node_mask, func_mask=func_mask)
            if cfg.remat and torch.is_grad_enabled():
                # nn.remat(HNABlock): only the block's inputs are kept for
                # the backward, which runs the block's forward again.
                query = checkpoint(block, *args, use_reentrant=False, **kw)
            else:
                query = block(*args, **kw)
        return self.out_mlp(query.float()).float()


def apply_batch(model: GNOT, batch) -> torch.Tensor:
    """The forward invocation serving uses (the unpacked branch of
    ``gnot_tpu/train/trainer.py::apply_batch``)."""
    return model(
        batch.coords,
        batch.theta,
        batch.funcs,
        node_mask=batch.node_mask,
        func_mask=batch.func_mask,
    )
