"""Weights carried from the JAX package into the port.

``params_from_jax`` takes ``gnot_tpu``'s param tree as nested dicts of
numpy arrays (``jax.device_get(params)``) and returns the port's
``state_dict``. The port names its modules after the JAX tree
(``block_{b}/ffn{n}/experts/dense_{i}`` becomes
``block_{b}.ffn{n}.experts.dense_{i}``) and keeps flax's layouts — Dense
kernels ``[in, out]``, stacked layers with the leading ``[E]`` or ``[F]``
axis — so the map is one to one with no transposes. The JAX side's
torch-reference naming is documented at
``gnot_tpu/interop/torch_oracle.py:9-23``.
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


def params_from_jax(tree: Mapping, cfg: ModelConfig) -> dict[str, torch.Tensor]:
    """The port's ``state_dict`` for ``GNOT(cfg)`` from a JAX param tree.

    Every leaf of the tree must land on a port parameter and every port
    parameter must be set, with equal shapes; anything else raises."""
    flat = flatten_tree(tree)
    with torch.device("meta"):
        expected = {k: tuple(v.shape) for k, v in GNOT(cfg).state_dict().items()}
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
