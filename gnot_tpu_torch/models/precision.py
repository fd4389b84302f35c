"""Serving precision policy: where reduced precision is allowed, in code.

Port of ``gnot_tpu/models/precision.py``. GNOT's linear attention is
matmul-dominated, but its output is ``alpha * q @ (k^T v)`` with
``alpha = 1 / <q, k_sum>``, so a precision loss in the normalizer
multiplies every output channel. The policy pins, as data the model and
the engine thread through:

* **compute dtype**: the dtype of every block's matmuls and activations
  (the knob ``--serve_dtype`` flips; ``ModelConfig.dtype`` carries it);
* **f32 accumulation**: the attention Gram ``k^T v`` and ``k_sum``
  accumulate in f32 whatever the operands' dtype (``ops/attention.py``);
* **f32 normalizer**: ``<q, k_sum>`` and its reciprocal are f32;
* **f32 output head**: the last MLP reads f32 input (``models/gnot.py``).

Weights stay f32 at rest: the serving engine publishes a cast copy
(``cast_params``) on every publish and never touches the caller's model.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import torch

#: The serving dtypes the stack accepts end to end, and their short tags.
SERVE_DTYPES = ("float32", "bfloat16")
DTYPE_TAGS = {"float32": "f32", "bfloat16": "bf16"}
_TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class PrecisionPolicy:
    """One serving precision mode as explicit per-site dtypes. The
    accumulation, normalizer and head sites are float32 by policy:
    ``__post_init__`` refuses anything else."""

    compute_dtype: str = "float32"  # per-block matmuls + activations
    weights_dtype: str = "float32"  # published (serving) weight copy
    accum_dtype: str = "float32"  # attention Gram and k_sum accumulation
    normalizer_dtype: str = "float32"  # <q, k_sum> and 1/x
    head_dtype: str = "float32"  # output MLP (feeds rel-L2)

    def __post_init__(self) -> None:
        if self.compute_dtype not in SERVE_DTYPES:
            raise ValueError(
                f"unknown serve dtype {self.compute_dtype!r}; one of {SERVE_DTYPES}"
            )
        for site in ("accum_dtype", "normalizer_dtype", "head_dtype"):
            if getattr(self, site) != "float32":
                raise ValueError(
                    f"{site} must stay float32 (the precision policy's point, "
                    f"see models/precision.py); got {getattr(self, site)!r}"
                )

    @property
    def tag(self) -> str:
        """Short dtype tag ("f32" / "bf16")."""
        return DTYPE_TAGS[self.compute_dtype]

    def table(self) -> list[tuple[str, str, str]]:
        """``(site, dtype, why)`` rows, one per policy site."""
        return [
            ("block matmuls + activations", self.compute_dtype,
             "the throughput knob; matmul-dominated, bf16-safe"),
            ("published weight copy", self.weights_dtype,
             "cast once at publish; params stay f32 at rest"),
            ("attention einsum accumulation", self.accum_dtype,
             "Gram/k_sum reductions; bf16 accumulation loses the "
             "normalization property"),
            ("attention normalizer <q,k_sum>, 1/x", self.normalizer_dtype,
             "multiplies every output channel (2105.14995)"),
            ("output head MLP", self.head_dtype, "feeds RelL2 directly"),
        ]


def policy_for(dtype: str) -> PrecisionPolicy:
    """The serving policy for a ``--serve_dtype`` value."""
    if dtype not in SERVE_DTYPES:
        raise ValueError(f"unknown serve dtype {dtype!r}; one of {SERVE_DTYPES}")
    return PrecisionPolicy(compute_dtype=dtype, weights_dtype=dtype)


def torch_dtype(dtype: str) -> torch.dtype:
    """The torch dtype of a serve dtype name."""
    policy_for(dtype)
    return _TORCH_DTYPES[dtype]


def cast_params(
    state_dict: Mapping[str, torch.Tensor], dtype: str
) -> Mapping[str, torch.Tensor]:
    """A ``dtype`` copy of a ``state_dict`` for publishing: float tensors
    cast, others passed through. The same mapping object for float32, so
    the f32 path stays untouched."""
    if dtype == "float32":
        return state_dict
    target = torch_dtype(dtype)
    return {
        k: v.detach().to(target, copy=True) if v.is_floating_point() else v
        for k, v in state_dict.items()
    }


def serve_model(model, dtype: str):
    """The model to serve at ``dtype``: the same architecture computing at
    the policy's dtype, holding a ``cast_params`` copy of ``model``'s
    weights on its device, also when ``model`` already computes at
    ``dtype`` on f32 weights (as bf16 training leaves it): JAX's engine
    publishes ``cast_params`` whatever its model's dtype. ``model`` itself
    for float32; ``model`` is never changed."""
    if dtype == "float32":
        return model
    # Built on the meta device (no weights drawn), then every weight
    # replaced by its cast copy.
    with torch.device("meta"):
        fresh = type(model)(dataclasses.replace(model.config, dtype=dtype))
    fresh.load_state_dict(cast_params(model.state_dict(), dtype), strict=True, assign=True)
    return fresh.eval()
