"""The stacked-layer parameter layout (``scan_layers``).

Port of the layout half of ``gnot_tpu/parallel/pipeline.py``: the block
weights stacked on a leading layer axis, the forward that applies one
block module per layer to slice *i* of each stacked tensor, and the
conversions to and from the standard ``block_{i}`` layout (of the
weights, and of a whole training state with its AdamW moments). The
pipeline schedule over a ``pipe`` mesh axis, which also keeps its blocks
in this layout, waits for the parallelism slice of the port.

In PyTorch the layout compiles nothing: the forward runs the same block
kernels as the standard one, in the same order. What it is for is the
layout itself: a ``--scan_layers`` run trains, checkpoints and resumes in
the JAX package's stacked format.

State-dict names follow the JAX tree: ``block_{i}.X`` of the standard
layout is slice *i* of ``blocks.X``; every other weight keeps its name.
"""

from __future__ import annotations

from typing import Mapping

import torch
from torch.func import functional_call

from gnot_tpu_torch.config import ModelConfig
from gnot_tpu_torch.models.gnot import GNOT

BLOCKS = "blocks."


def stack_params(params: Mapping[str, torch.Tensor], n_layers: int) -> dict[str, torch.Tensor]:
    """Standard layout -> stacked: the ``block_{i}.X`` entries become one
    ``blocks.X`` entry ``[n_layers, ...]``, after every other entry (the
    order of ``StackedGNOT``'s parameters)."""
    out = {k: v for k, v in params.items() if not k.startswith("block_")}
    prefix = "block_0."
    for key in params:
        if key.startswith(prefix):
            leaf = key[len(prefix):]
            out[BLOCKS + leaf] = torch.stack(
                [params[f"block_{i}.{leaf}"] for i in range(n_layers)]
            )
    return out


def unstack_params(params: Mapping[str, torch.Tensor], n_layers: int) -> dict[str, torch.Tensor]:
    """Stacked layout -> standard, in ``GNOT``'s parameter order
    (``block_{i}`` before ``out_mlp``)."""
    rest = {k: v for k, v in params.items() if not k.startswith(BLOCKS)}
    blocks = {k[len(BLOCKS):]: v for k, v in params.items() if k.startswith(BLOCKS)}
    out = {k: v for k, v in rest.items() if not k.startswith("out_mlp.")}
    for i in range(n_layers):
        out.update({f"block_{i}.{leaf}": v[i] for leaf, v in blocks.items()})
    out.update({k: v for k, v in rest.items() if k.startswith("out_mlp.")})
    return out


def is_stacked(params: Mapping[str, torch.Tensor]) -> bool:
    return any(k.startswith(BLOCKS) for k in params)


def convert_state_layout(state: dict, n_layers: int, to: str) -> dict:
    """A trainer state (``Trainer.state_dict()``) moved between the
    standard and the stacked layout: the weights, both AdamW moments and
    the gradient-accumulation mean, so a ``--scan_layers`` checkpoint
    resumes in a standard run and back. No-op when the state is already
    in the target layout."""
    from gnot_tpu_torch.train.trainer import map_param_state

    if to not in ("stacked", "standard"):
        raise ValueError(f"unknown layout {to!r}")
    if is_stacked(state["model"]) == (to == "stacked"):
        return state
    convert = stack_params if to == "stacked" else unstack_params
    return map_param_state(state, lambda p: convert(p, n_layers))


def scan_blocks(model: GNOT, block: torch.nn.Module, scores, query, funcs, kw: dict) -> torch.Tensor:
    """``block`` (a module whose parameters carry the leading layer axis)
    applied once per layer, each time to slice *i* of every stacked
    parameter (``torch.func.functional_call``): the port of
    ``_scan_blocks``. With ``remat`` each layer is checkpointed, as
    ``jax.checkpoint`` wraps the scan body."""
    stacked = dict(block.named_parameters())
    for i in range(model.config.n_attn_layers):
        layer = {name: p[i] for name, p in stacked.items()}

        def apply(scores, q, funcs, layer=layer, **kw):
            return functional_call(block, layer, (scores, q, funcs), kw)

        query = model.run_block(apply, scores, query, funcs, kw)
    return query


class StackedGNOT(GNOT):
    """GNOT in the stacked layout: ``gating``, ``x_embed``,
    ``input_func_mlps`` and ``out_mlp`` as in ``GNOT``, and ``blocks``, one
    ``HNABlock`` whose every parameter is ``[n_attn_layers, ...]``.

    Built as the standard model and then stacked, so the same generator
    draws the same weights as ``GNOT`` (``init_stacked_state``: the
    standard init, stacked). Its forward is the port of
    ``stacked_forward``: the standard embedding, ``scan_blocks``, the
    standard head; parity mode drops the masks in ``embed`` as the
    standard forward does. ``apply_batch`` runs it as it runs ``GNOT``."""

    def __init__(self, config: ModelConfig, *, generator: torch.Generator | None = None):
        super().__init__(config, generator=generator)
        n = config.n_attn_layers
        layers = [getattr(self, f"block_{i}") for i in range(n)]
        for i in range(n):
            delattr(self, f"block_{i}")
        blocks = layers[0]
        with torch.no_grad():
            for name, _ in list(blocks.named_parameters()):
                owner, _, leaf = name.rpartition(".")
                stacked = torch.stack([l.get_parameter(name) for l in layers])
                setattr(blocks.get_submodule(owner), leaf, torch.nn.Parameter(stacked))
        self.blocks = blocks

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
    ) -> torch.Tensor:
        scores, query, funcs, kw = self.embed(
            coords, theta, input_functions, node_mask=node_mask, func_mask=func_mask,
            node_seg=node_seg, func_seg=func_seg, n_seg=n_seg,
        )
        return self.head(scan_blocks(self, self.blocks, scores, query, funcs, kw))
