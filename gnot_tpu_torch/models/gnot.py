"""GNOT — General Neural Operator Transformer (arXiv 2302.14376).

Port of ``gnot_tpu/models/gnot.py``, float32 or bfloat16 compute, with
the reference's quirks as they are:

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

Two modes (``ModelConfig.attention_mode``), as in the JAX package:

* ``"masked"`` (the default): the ragged structure rides as 0/1 masks
  folded into the attention reductions, so results do not depend on
  pad lengths;
* ``"parity"``: the reference's numerics. The masks are dropped before
  the forward, so padded rows pollute ``k_sum`` and ``k^T v`` as they do
  in the reference, and heads merge by the reference's interleave
  (``layers.LinearAttention``); the GELU is erf. JAX pins full-f32
  contractions for this mode (``precision_scope``); on the card that is
  cuBLAS with TF32 off, which ``device.resolve_device`` sets for every
  entry point, so no scope is needed here.

``node_seg`` / ``func_seg`` / ``n_seg`` select the packed layout ("pack,
don't pad"): several samples share each row as chunk-aligned segments,
theta is per sample ``[S, T]`` and each token gathers its own, and
attention stays exactly per sample through segment Grams. The one-hot
segment maps are computed once per forward and handed to every block as
tensors, so they cross a ``remat`` checkpoint like any other input.
Masked mode only.

``GNOT`` builds the standard layout (``block_{i}`` modules) whatever
``scan_layers`` says, as the JAX module does; the stacked-layer layout is
``parallel/pipeline.py::StackedGNOT``, which shares ``embed``, ``run_block``
and ``head`` with this forward.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from gnot_tpu_torch.config import ModelConfig
from gnot_tpu_torch.data.batch import PackedBatch
from gnot_tpu_torch.models.layers import GatedExpertFfn, LinearAttention, Mlp, gate_stats
from gnot_tpu_torch.models.precision import torch_dtype
from gnot_tpu_torch.ops.attention import segment_one_hot


class HNABlock(nn.Module):
    """One Heterogeneous Normalized Attention encoder layer
    (reference model.py:118-139): cross-attention -> gated expert FFN ->
    residual, then self-attention -> gated expert FFN -> residual."""

    def __init__(self, cfg: ModelConfig, has_funcs: bool, generator=None):
        super().__init__()
        n_funcs = cfg.n_input_functions if has_funcs else 0
        dtype = model_dtype(cfg)
        parity = cfg.attention_mode == "parity"
        ffn = dict(
            in_dim=cfg.n_attn_hidden_dim, ffn_impl=cfg.ffn_impl,
            gelu=cfg.gelu, generator=generator, dtype=dtype,
        )
        self.cross_attention = LinearAttention(
            cfg.n_attn_hidden_dim, cfg.n_head, n_funcs,
            query_dim=cfg.n_input_hidden_dim,
            func_dim=cfg.n_input_hidden_dim,
            parity=parity, generator=generator, dtype=dtype,
        )
        self.ffn1 = GatedExpertFfn(
            cfg.n_expert, cfg.n_mlp_num_layers, cfg.n_mlp_hidden_dim,
            cfg.n_mlp_hidden_dim, **ffn,
        )
        self.self_attention = LinearAttention(
            cfg.n_attn_hidden_dim, cfg.n_head, 0,
            query_dim=cfg.n_input_hidden_dim, parity=parity, generator=generator,
            dtype=dtype,
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
        node_seg_oh: torch.Tensor | None = None,
        func_seg_oh: torch.Tensor | None = None,
    ) -> torch.Tensor:
        cross = self.cross_attention(
            query, input_functions, query_mask=node_mask, func_mask=func_mask,
            q_seg_oh=node_seg_oh, kv_seg_oh=func_seg_oh,
        )
        query = query + self.ffn1(cross, scores)
        self_out = self.self_attention(query, query_mask=node_mask, q_seg_oh=node_seg_oh)
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


def packed_query_features(
    coords: torch.Tensor, theta: torch.Tensor, node_seg: torch.Tensor
) -> torch.Tensor:
    """Packed layout: theta is per sample ``[S, T]`` and each token
    gathers its segment's (pad tokens clip to slot 0; attention sums and
    the loss leave them out, so their value is inert)."""
    tok_seg = torch.repeat_interleave(node_seg, coords.shape[1] // node_seg.shape[1], dim=1)
    th = theta[torch.clamp(tok_seg.long(), 0, theta.shape[0] - 1)]
    return torch.cat([coords, th.to(coords.dtype)], dim=-1)


class GNOT(nn.Module):
    """Full GNOT model (reference model.py:142-172). Parameter names
    follow the JAX tree: ``gating``, ``x_embed``, ``input_func_mlps``,
    ``block_{i}``, ``out_mlp``."""

    def __init__(self, config: ModelConfig, *, generator: torch.Generator | None = None):
        super().__init__()
        cfg = self.config = config
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

    def embed(
        self,
        coords: torch.Tensor,
        theta: torch.Tensor,
        input_functions: torch.Tensor | None = None,
        *,
        node_mask: torch.Tensor | None = None,
        func_mask: torch.Tensor | None = None,
        node_seg: torch.Tensor | None = None,
        func_seg: torch.Tensor | None = None,
        n_seg: int = 0,
    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor | None, dict]:
        """The forward up to the first block: the gate scores, the query
        embedding, the input-function embeddings (or None) and the keyword
        arguments every block takes (masks, segment one-hots)."""
        cfg = self.config
        if node_seg is not None and cfg.attention_mode == "parity":
            raise ValueError(
                "packed layout requires masked mode (attention_mode='masked'): "
                "parity reproduces the reference's per-batch padding "
                "pollution, which has no packed equivalent"
            )
        if cfg.attention_mode == "parity":
            node_mask = func_mask = None
        # Geometry gating on raw coordinates, computed once.
        scores = gating_scores(self.gating(coords))
        if node_seg is not None:
            feats = packed_query_features(coords, theta, node_seg)
        else:
            feats = query_features(coords, theta)
        query = self.x_embed(feats)
        funcs = None
        if cfg.n_input_functions > 0:
            if input_functions is None:
                raise ValueError(
                    f"the model was built for {cfg.n_input_functions} input "
                    "functions but was called without them"
                )
            funcs = self.input_func_mlps(input_functions)  # [F, B, Lf, D]
        # One-hot segment maps, computed once and handed to every block.
        node_seg_oh = func_seg_oh = None
        if node_seg is not None:
            node_seg_oh = segment_one_hot(node_seg, n_seg)
            if func_seg is not None:
                func_seg_oh = segment_one_hot(func_seg, n_seg)
        kw = dict(node_mask=node_mask, func_mask=func_mask,
                  node_seg_oh=node_seg_oh, func_seg_oh=func_seg_oh)
        return scores, query, funcs, kw

    def run_block(self, block, scores, query, funcs, kw: dict) -> torch.Tensor:
        """One block on ``query``; with ``remat`` (while gradients are on)
        only its inputs are kept for the backward, which runs it again
        (``nn.remat(HNABlock)``)."""
        if self.config.remat and torch.is_grad_enabled():
            return checkpoint(block, scores, query, funcs, use_reentrant=False, **kw)
        return block(scores, query, funcs, **kw)

    def head(self, query: torch.Tensor) -> torch.Tensor:
        """The output head on the last block's output, in f32."""
        return self.out_mlp(query.float()).float()

    def forward(
        self,
        coords: torch.Tensor,
        theta: torch.Tensor,
        input_functions: torch.Tensor | None = None,
        *,
        node_mask: torch.Tensor | None = None,
        func_mask: torch.Tensor | None = None,
        node_seg: torch.Tensor | None = None,
        func_seg: torch.Tensor | None = None,
        n_seg: int = 0,
        gates: dict[str, torch.Tensor] | None = None,
    ) -> torch.Tensor:
        """The model's output ``[B, L, out_dim]``. A ``gates`` dict is
        filled with each block's gate health (``layers.gate_stats`` of the
        scores under the node mask the blocks see), under
        ``gate_load/block_{i}`` and ``gate_entropy/block_{i}``, the keys the
        JAX model sows. The stats are taken here, outside ``run_block``,
        so a remat block run again in the backward records nothing twice;
        every block reads the one shared gate, so one computation serves
        them all."""
        scores, query, funcs, kw = self.embed(
            coords, theta, input_functions, node_mask=node_mask, func_mask=func_mask,
            node_seg=node_seg, func_seg=func_seg, n_seg=n_seg,
        )
        stats = gate_stats(scores, kw["node_mask"]) if gates is not None else None
        for i in range(self.config.n_attn_layers):
            if stats is not None:
                for key, value in stats.items():
                    gates[f"{key}/block_{i}"] = value
            query = self.run_block(getattr(self, f"block_{i}"), scores, query, funcs, kw)
        return self.head(query)


def apply_batch(model: GNOT, batch, gates: dict | None = None) -> torch.Tensor:
    """The one forward invocation of training, eval and serving
    (``gnot_tpu/train/trainer.py::apply_batch``): a ``PackedBatch`` takes
    the packed layout. ``gates`` (the standard forward of a ``MeshBatch``
    only) collects the gate stats (``GNOT.forward``)."""
    if isinstance(batch, PackedBatch):
        return model(
            batch.coords,
            batch.theta,
            batch.funcs,
            node_mask=batch.node_mask,
            func_mask=batch.func_mask,
            node_seg=batch.node_seg,
            func_seg=batch.func_seg,
            n_seg=batch.n_seg,
        )
    return model(
        batch.coords,
        batch.theta,
        batch.funcs,
        node_mask=batch.node_mask,
        func_mask=batch.func_mask,
        **({"gates": gates} if gates is not None else {}),
    )
