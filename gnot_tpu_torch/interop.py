"""Weights carried from the JAX package into the port.

``params_from_jax`` takes ``gnot_tpu``'s params as numpy (``jax.device_get``)
in any of its three layouts, the standard tree, the stacked tree of
``scan_layers`` or the flat ``[P]`` vector of ``flat_params``, and returns
the port's standard-layout ``state_dict``. The port names its modules after the JAX tree
(``block_{b}/ffn{n}/experts/dense_{i}`` becomes
``block_{b}.ffn{n}.experts.dense_{i}``) and keeps flax's layouts — Dense
kernels ``[in, out]``, stacked layers with the leading ``[E]`` or ``[F]``
axis — so the map is one to one with no transposes. The JAX side's
torch-reference naming is documented at
``gnot_tpu/interop/torch_oracle.py:9-23``; ``reference_state_dict``
names the port's weights that way (``--export_torch``).
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from gnot_tpu_torch.config import ModelConfig
from gnot_tpu_torch.models.gnot import GNOT


def flatten_tree(tree: Mapping, prefix: str = "") -> dict[str, np.ndarray]:
    """``{"a": {"b": x}}`` -> ``{"a.b": x}``."""
    out: dict[str, np.ndarray] = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, Mapping):
            out.update(flatten_tree(v, name + "."))
        else:
            out[name] = np.asarray(v)
    return out


def _jax_ravel_order(names) -> list[str]:
    """``names`` in the leaf order of ``jax.tree`` (and so of
    ``ravel_pytree``) over the nested dicts they name: sorted key by key."""
    return sorted(names, key=lambda n: tuple(n.split(".")))


def _unravel_jax(flat: np.ndarray, shapes: Mapping[str, tuple[int, ...]]) -> dict[str, np.ndarray]:
    """JAX's ``ravel_pytree`` vector cut into its leaves: back to back, in
    sorted-name order, each in C order."""
    total = sum(int(np.prod(s)) for s in shapes.values())
    if flat.shape != (total,):
        raise ValueError(f"a flat JAX param vector of {total} values expected, got {flat.shape}")
    out, off = {}, 0
    for name in _jax_ravel_order(shapes):
        n = int(np.prod(shapes[name]))
        out[name] = flat[off:off + n].reshape(shapes[name])
        off += n
    return out


def params_from_jax(tree, cfg: ModelConfig, *, template: Mapping | None = None) -> dict[str, torch.Tensor]:
    """The port's standard-layout ``state_dict`` for ``GNOT(cfg)`` from JAX
    params: the standard tree; the stacked tree of ``scan_layers`` (a
    ``blocks`` subtree with a leading layer axis, unstacked here); or the
    flat ``[P]`` vector of ``flat_params`` (``ravel_pytree`` of the
    standard tree), unravelled against ``template``, the JAX param tree
    it came from, or without one against the names and shapes ``cfg``
    gives.

    Every leaf of the tree must land on a port parameter and every port
    parameter must be set, with equal shapes; anything else raises."""
    with torch.device("meta"):
        expected = {k: tuple(v.shape) for k, v in GNOT(cfg).state_dict().items()}
    if isinstance(tree, Mapping):
        flat = flatten_tree(tree)
    else:
        shapes = (expected if template is None
                  else {k: v.shape for k, v in flatten_tree(template).items()})
        flat = _unravel_jax(np.asarray(tree), shapes)
    stacked = {k: v for k, v in flat.items() if k.startswith("blocks.")}
    if stacked:
        flat = {k: v for k, v in flat.items() if not k.startswith("blocks.")}
        for i in range(cfg.n_attn_layers):
            flat.update({f"block_{i}.{k[len('blocks.'):]}": v[i] for k, v in stacked.items()})
    extra = sorted(set(flat) - set(expected))
    missing = sorted(set(expected) - set(flat))
    if extra or missing:
        raise ValueError(
            f"JAX params do not match GNOT({cfg}): leaves with no port "
            f"parameter {extra}; port parameters left unset {missing}"
        )
    bad = [
        (k, flat[k].shape, shape)
        for k, shape in expected.items()
        if tuple(flat[k].shape) != shape
    ]
    if bad:
        raise ValueError(f"shape mismatch (name, jax, port): {bad}")
    return {
        k: torch.from_numpy(np.array(flat[k], dtype=np.float32)) for k in expected
    }


def reference_state_dict(state_dict: Mapping[str, torch.Tensor], cfg: ModelConfig) -> dict:
    """The port's weights as a state_dict the reference PyTorch GNOT loads:
    a copy of the naming of ``gnot_tpu/interop/torch_oracle.py::
    flax_to_state_dict`` (``x.layers.{2i}``, ``blocks.{b}.ffn{n}.{e}.layers.
    {2i}``, ...), each Dense kernel transposed to torch's ``[out, in]`` and
    each stacked layer cut into its ModuleList entries. f32 CPU tensors."""
    sd = {k: v.detach().to("cpu", torch.float32) for k, v in state_dict.items()}
    out: dict[str, torch.Tensor] = {}

    def put_linear(prefix: str, kernel: torch.Tensor, bias: torch.Tensor) -> None:
        out[f"{prefix}.weight"] = kernel.T.contiguous()
        out[f"{prefix}.bias"] = bias.clone()

    def put_mlp(prefix: str, tree: str) -> None:
        for i in range(cfg.n_mlp_num_layers + 1):
            leaf = f"{tree}.dense_{i}"
            put_linear(f"{prefix}.layers.{2 * i}", sd[f"{leaf}.kernel"], sd[f"{leaf}.bias"])

    def put_stacked(prefixes: list[str], leaf: str) -> None:
        for s, prefix in enumerate(prefixes):
            put_linear(prefix, sd[f"{leaf}.kernel"][s], sd[f"{leaf}.bias"][s])

    def put_stacked_mlp(prefixes: list[str], tree: str) -> None:
        for i in range(cfg.n_mlp_num_layers + 1):
            put_stacked([f"{p}.layers.{2 * i}" for p in prefixes], f"{tree}.dense_{i}")

    put_mlp("x", "x_embed")
    put_mlp("gating", "gating")
    put_mlp("out", "out_mlp")
    n_funcs = cfg.n_input_functions
    if n_funcs > 0:
        put_stacked_mlp([f"input_func_mlps.{f}" for f in range(n_funcs)], "input_func_mlps")
    for b in range(cfg.n_attn_layers):
        pb, blk = f"blocks.{b}", f"block_{b}"
        for k in ("query", "fc_out"):
            leaf = f"{blk}.cross_attention.{k}"
            put_linear(f"{pb}.cross_attention.{k}", sd[f"{leaf}.kernel"], sd[f"{leaf}.bias"])
        for k in ("key", "value"):
            leaf = f"{blk}.cross_attention.{k}"
            if n_funcs > 0:
                put_stacked([f"{pb}.cross_attention.{k}.{f}" for f in range(n_funcs)], leaf)
            else:
                put_linear(f"{pb}.cross_attention.{k}", sd[f"{leaf}.kernel"], sd[f"{leaf}.bias"])
        for k in ("query", "key", "value", "fc_out"):
            leaf = f"{blk}.self_attention.{k}"
            put_linear(f"{pb}.self_attention.{k}", sd[f"{leaf}.kernel"], sd[f"{leaf}.bias"])
        for ffn in ("ffn1", "ffn2"):
            put_stacked_mlp([f"{pb}.{ffn}.{e}" for e in range(cfg.n_expert)], f"{blk}.{ffn}.experts")
    return out
