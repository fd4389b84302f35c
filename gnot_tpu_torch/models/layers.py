"""Core GNOT layers: MLP, heterogeneous normalized linear attention and
the gated expert FFN.

Port of ``gnot_tpu/models/layers.py``. Parameters keep the JAX layout
and names so weights carry across one to one (``interop.params_from_jax``):
a ``Dense`` holds ``kernel [in, out]`` and ``bias [out]``; a stacked
layer (per input function, per expert) holds ``kernel [S, in, out]`` and
``bias [S, out]`` with the stack axis first, the layout the fused FFN
kernel reads without a copy. Initialization matches ``torch.nn.Linear``
(U(+-1/sqrt(fan_in)) for weight and bias), drawn from an explicit
``torch.Generator``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from gnot_tpu_torch.ops.attention import (
    feature_softmax,
    merge_heads,
    normalized_linear_attention,
    split_heads,
)
from gnot_tpu_torch.ops.fused_ffn import fused_gated_ffn


def torch_linear_init(
    shape: tuple[int, ...], fan_in: int, generator: torch.Generator | None
) -> nn.Parameter:
    """torch.nn.Linear init (weight and bias alike): U(+-1/sqrt(fan_in))."""
    bound = 1.0 / fan_in**0.5
    t = torch.empty(shape, dtype=torch.float32)
    t.uniform_(-bound, bound, generator=generator)
    return nn.Parameter(t)


class Dense(nn.Module):
    """``x @ kernel + bias`` with the flax ``Dense`` layout."""

    def __init__(self, in_dim: int, out_dim: int, generator=None):
        super().__init__()
        self.kernel = torch_linear_init((in_dim, out_dim), in_dim, generator)
        self.bias = torch_linear_init((out_dim,), in_dim, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.matmul(x, self.kernel) + self.bias


class StackedDense(nn.Module):
    """``S`` Denses with per-slice params: ``[S, ..., in] -> [S, ..., out]``
    as one batched matmul (flax ``nn.vmap(nn.Dense)``)."""

    def __init__(self, stack: int, in_dim: int, out_dim: int, generator=None):
        super().__init__()
        self.kernel = torch_linear_init((stack, in_dim, out_dim), in_dim, generator)
        self.bias = torch_linear_init((stack, out_dim), in_dim, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = self.kernel.shape[0]
        flat = x.reshape(s, -1, x.shape[-1])
        out = torch.baddbmm(self.bias[:, None, :], flat, self.kernel)
        return out.reshape(*x.shape[:-1], self.kernel.shape[-1])


def _gelu(gelu: str):
    return lambda x: F.gelu(x, approximate="tanh" if gelu == "tanh" else "none")


class Mlp(nn.Module):
    """GELU MLP matching the reference ``MLP`` (model.py:5-18):
    ``num_layers + 1`` Linears with GELU between them, no final
    activation, no norm. ``stack`` > 0 stacks that many independent MLPs
    over a leading input axis (``gnot_tpu``'s vmapped ``Mlp``)."""

    def __init__(
        self,
        in_dim: int,
        num_layers: int,
        hidden_dim: int,
        output_dim: int,
        gelu: str = "erf",
        *,
        stack: int = 0,
        generator=None,
    ):
        super().__init__()
        self.num_layers = num_layers
        self.act = _gelu(gelu)
        dims = [in_dim] + [hidden_dim] * num_layers + [output_dim]
        for i in range(num_layers + 1):
            layer = (
                StackedDense(stack, dims[i], dims[i + 1], generator)
                if stack
                else Dense(dims[i], dims[i + 1], generator)
            )
            self.add_module(f"dense_{i}", layer)

    def layers(self) -> list[nn.Module]:
        return [getattr(self, f"dense_{i}") for i in range(self.num_layers + 1)]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        layers = self.layers()
        for layer in layers[:-1]:
            x = self.act(layer(x))
        return layers[-1](x)


class LinearAttention(nn.Module):
    """Heterogeneous normalized linear attention (model.py:33-107),
    non-parity, unpacked.

    Cross mode (``n_input_functions > 0``): per-input-function K/V
    projections (stacked, one batched matmul), per-function attention
    outputs averaged. Self mode: K/V from the query sequence itself.
    As in the reference, q and k are softmaxed over the feature axis, the
    residual adds the *softmaxed* q, and one ``fc_out`` closes both
    branches.
    """

    def __init__(
        self,
        n_embed: int,
        n_head: int,
        n_input_functions: int = 0,
        *,
        query_dim: int,
        func_dim: int = 0,
        generator=None,
    ):
        super().__init__()
        self.n_head = n_head
        self.n_input_functions = n_input_functions
        self.query = Dense(query_dim, n_embed, generator)
        if n_input_functions > 0:
            self.key = StackedDense(n_input_functions, func_dim, n_embed, generator)
            self.value = StackedDense(n_input_functions, func_dim, n_embed, generator)
        else:
            self.key = Dense(query_dim, n_embed, generator)
            self.value = Dense(query_dim, n_embed, generator)
        self.fc_out = Dense(n_embed, n_embed, generator)

    def forward(
        self,
        query: torch.Tensor,
        input_functions: torch.Tensor | None = None,
        *,
        query_mask: torch.Tensor | None = None,
        func_mask: torch.Tensor | None = None,
    ) -> torch.Tensor:
        h = self.n_head
        q = feature_softmax(split_heads(self.query(query), h))  # [B, H, Lq, D]
        if self.n_input_functions > 0:
            if input_functions is None:
                raise ValueError(
                    "cross-attention layer called without input functions"
                )
            # input_functions: [F, B, Lf, E]; stacked K/V, attention per
            # function, mean over functions (model.py:77-86).
            k = feature_softmax(split_heads(self.key(input_functions), h))
            v = split_heads(self.value(input_functions), h)  # [F, B, H, Lf, D]
            out = normalized_linear_attention(q, k, v, kv_mask=func_mask)
            res = merge_heads(q) + merge_heads(out.mean(dim=0))
        else:
            k = feature_softmax(split_heads(self.key(query), h))
            v = split_heads(self.value(query), h)
            out = normalized_linear_attention(q, k, v, kv_mask=query_mask)
            res = merge_heads(q) + merge_heads(out)
        return self.fc_out(res)


class GatedExpertFfn(nn.Module):
    """Dense soft mixture-of-experts FFN (model.py:123-124,128-131).

    Every expert runs on every token; outputs are combined with the
    geometry-gating ``scores``. The E expert MLPs are stacked
    (``experts.dense_i.kernel [E, in, out]``). ``ffn_impl='xla'`` runs
    them as batched matmuls in plain torch; ``'pallas'`` runs the whole
    expert stack in the fused gated-FFN kernel (ops/fused_ffn.py), which
    on a CUDA tensor launches the Hopper kernel and raises on a width it
    does not take.
    """

    def __init__(
        self,
        n_expert: int,
        num_layers: int,
        hidden_dim: int,
        output_dim: int,
        *,
        in_dim: int,
        ffn_impl: str = "xla",
        gelu: str = "erf",
        generator=None,
    ):
        super().__init__()
        if ffn_impl not in ("xla", "pallas"):
            raise ValueError(f"unknown ffn_impl {ffn_impl!r}")
        self.ffn_impl = ffn_impl
        self.gelu = gelu
        self.experts = Mlp(
            in_dim, num_layers, hidden_dim, output_dim, gelu,
            stack=n_expert, generator=generator,
        )

    def forward(self, x: torch.Tensor, scores: torch.Tensor) -> torch.Tensor:
        if self.ffn_impl == "pallas":
            layers = self.experts.layers()
            return fused_gated_ffn(
                x,
                scores,
                [l.kernel for l in layers],
                [l.bias for l in layers],
                gelu_kind=self.gelu,
            )
        e = scores.shape[-1]
        out = self.experts(x.unsqueeze(0).expand(e, *x.shape))  # [E, B, L, D]
        return torch.einsum("ebld,ble->bld", out, scores.to(out.dtype))
