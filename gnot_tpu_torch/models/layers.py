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

``dtype`` is the compute dtype, as flax's ``Dense(dtype=...)``: input,
kernel and bias are cast to it before the product, whatever dtype the
weights are held in. ``None`` computes in the promoted dtype of the
three, so a head held in bf16 computes in f32 on f32 input (flax's
``dtype=None``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from gnot_tpu_torch.ops.attention import (
    feature_softmax,
    merge_heads,
    normalized_linear_attention,
    packed_normalized_linear_attention,
    split_heads,
)
from gnot_tpu_torch.ops.fused_ffn import fused_gated_ffn, kernel_takes


def torch_linear_init(
    shape: tuple[int, ...], fan_in: int, generator: torch.Generator | None
) -> nn.Parameter:
    """torch.nn.Linear init (weight and bias alike): U(+-1/sqrt(fan_in))."""
    bound = 1.0 / fan_in**0.5
    t = torch.empty(shape, dtype=torch.float32)
    t.uniform_(-bound, bound, generator=generator)
    return nn.Parameter(t)


def _promoted(dtype: torch.dtype | None, *tensors: torch.Tensor) -> list[torch.Tensor]:
    """``tensors`` cast to ``dtype``, or to their promoted dtype when it is
    None (flax's ``promote_dtype``)."""
    if dtype is None:
        dtype = tensors[0].dtype
        for t in tensors[1:]:
            dtype = torch.promote_types(dtype, t.dtype)
    return [t.to(dtype) for t in tensors]


@torch.no_grad()
def gate_stats(scores: torch.Tensor, mask: torch.Tensor | None) -> dict[str, torch.Tensor]:
    """Gate-health scalars of one layer's geometry-gating ``scores``
    ``[B, L, E]`` (``gnot_tpu/models/layers.py::gate_stats``): the
    per-expert load fractions ``[E]`` (masked token mean: a collapsed
    gate shows one expert's load near 1) and the mean per-token gate
    entropy in nats (uniform gating gives log E, collapse 0). f32
    reductions; ``mask=None`` (parity mode) averages every token."""
    s = scores.float()
    ent = -torch.sum(s * torch.log(torch.clamp(s, min=1e-20)), dim=-1)  # [B, L]
    if mask is None:
        return {"gate_load": s.mean(dim=(0, 1)), "gate_entropy": ent.mean()}
    m = mask.float()
    denom = torch.clamp(m.sum(), min=1.0)
    load = torch.einsum("ble,bl->e", s, m) / denom
    return {"gate_load": load, "gate_entropy": torch.sum(ent * m) / denom}


class Dense(nn.Module):
    """``x @ kernel + bias`` with the flax ``Dense`` layout, computed in
    ``dtype``."""

    def __init__(self, in_dim: int, out_dim: int, generator=None, dtype: torch.dtype | None = None):
        super().__init__()
        self.dtype = dtype
        self.kernel = torch_linear_init((in_dim, out_dim), in_dim, generator)
        self.bias = torch_linear_init((out_dim,), in_dim, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, kernel, bias = _promoted(self.dtype, x, self.kernel, self.bias)
        return torch.matmul(x, kernel) + bias


class StackedDense(nn.Module):
    """``S`` Denses with per-slice params: ``[S, ..., in] -> [S, ..., out]``
    as one batched matmul (flax ``nn.vmap(nn.Dense)``), computed in
    ``dtype``."""

    def __init__(
        self, stack: int, in_dim: int, out_dim: int, generator=None,
        dtype: torch.dtype | None = None,
    ):
        super().__init__()
        self.dtype = dtype
        self.kernel = torch_linear_init((stack, in_dim, out_dim), in_dim, generator)
        self.bias = torch_linear_init((stack, out_dim), in_dim, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, kernel, bias = _promoted(self.dtype, x, self.kernel, self.bias)
        flat = x.reshape(kernel.shape[0], -1, x.shape[-1])
        if flat.dtype == torch.float32:
            out = torch.baddbmm(bias[:, None, :], flat, kernel)
        else:  # the product rounded, then the sum: flax's Dense below f32
            out = torch.bmm(flat, kernel) + bias[:, None, :]
        return out.reshape(*x.shape[:-1], kernel.shape[-1])


def _in_dtype(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype``, as JAX rounds a weakly typed
    constant to the array's dtype before the op."""
    return float(torch.tensor(value, dtype=dtype))


def gelu_lowp(x: torch.Tensor, gelu: str) -> torch.Tensor:
    """``jax.nn.gelu`` below f32: its formula op by op in x's dtype, each
    op's result rounded, constants rounded first. ``F.gelu`` in bf16
    computes in f32 and rounds once, which differs from the JAX package
    on ~40% of elements by a bf16 ulp."""
    if gelu == "tanh":
        c, a = _in_dtype(0.7978845608028654, x.dtype), _in_dtype(0.044715, x.dtype)
        return x * (0.5 * (1.0 + torch.tanh(c * (x + a * x**3))))
    return 0.5 * x * torch.special.erfc(-x * _in_dtype(0.7071067811865476, x.dtype))


def _gelu(gelu: str):
    approximate = "tanh" if gelu == "tanh" else "none"

    def act(x: torch.Tensor) -> torch.Tensor:
        if x.dtype == torch.float32:
            return F.gelu(x, approximate=approximate)
        return gelu_lowp(x, gelu)

    return act


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
        dtype: torch.dtype | None = None,
    ):
        super().__init__()
        self.num_layers = num_layers
        self.act = _gelu(gelu)
        dims = [in_dim] + [hidden_dim] * num_layers + [output_dim]
        for i in range(num_layers + 1):
            layer = (
                StackedDense(stack, dims[i], dims[i + 1], generator, dtype)
                if stack
                else Dense(dims[i], dims[i + 1], generator, dtype)
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
    """Heterogeneous normalized linear attention (model.py:33-107).

    Cross mode (``n_input_functions > 0``): per-input-function K/V
    projections (stacked, one batched matmul), per-function attention
    outputs averaged. Self mode: K/V from the query sequence itself.
    As in the reference, q and k are softmaxed over the feature axis, the
    residual adds the *softmaxed* q, and one ``fc_out`` closes both
    branches.

    ``parity=True`` merges heads as the reference does: it reshapes the
    permuted ``[B, H, L, D]`` tensor straight to ``[B, L, H*D]``
    (model.py:81,83,103-104), an interleave that mixes heads and sequence
    positions across output rows, where masked mode transposes them back
    (``merge_heads``). torch's ``reshape`` reads the logical row-major
    order of the non-contiguous tensor, as JAX's does, and copies.

    ``q_seg_oh`` / ``kv_seg_oh`` select the packed layout
    (``packed_normalized_linear_attention``): one-hot chunk->segment maps
    of the query rows and, in cross mode, of the slot-indexed
    input-function rows, one map shared by every function. Masked mode
    only: the interleaved merge mixes rows, so it has no packed form.
    """

    def __init__(
        self,
        n_embed: int,
        n_head: int,
        n_input_functions: int = 0,
        *,
        query_dim: int,
        func_dim: int = 0,
        parity: bool = False,
        generator=None,
        dtype: torch.dtype | None = None,
    ):
        super().__init__()
        self.n_head = n_head
        self.n_input_functions = n_input_functions
        self.parity = parity
        self.query = Dense(query_dim, n_embed, generator, dtype)
        if n_input_functions > 0:
            self.key = StackedDense(n_input_functions, func_dim, n_embed, generator, dtype)
            self.value = StackedDense(n_input_functions, func_dim, n_embed, generator, dtype)
        else:
            self.key = Dense(query_dim, n_embed, generator, dtype)
            self.value = Dense(query_dim, n_embed, generator, dtype)
        self.fc_out = Dense(n_embed, n_embed, generator, dtype)

    def _merge(self, x: torch.Tensor) -> torch.Tensor:
        if self.parity:
            b, h, l, d = x.shape
            return x.reshape(b, l, h * d)
        return merge_heads(x)

    def forward(
        self,
        query: torch.Tensor,
        input_functions: torch.Tensor | None = None,
        *,
        query_mask: torch.Tensor | None = None,
        func_mask: torch.Tensor | None = None,
        q_seg_oh: torch.Tensor | None = None,
        kv_seg_oh: torch.Tensor | None = None,
    ) -> torch.Tensor:
        packed = q_seg_oh is not None
        if packed and self.parity:
            raise ValueError("packed attention requires parity=False")
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
            if packed:
                # The funcs tensor is slot-indexed: one kv_seg_oh serves
                # every function.
                out = torch.stack([
                    packed_normalized_linear_attention(
                        q, k[f], v[f], q_seg_oh=q_seg_oh, kv_seg_oh=kv_seg_oh,
                        kv_mask=None if func_mask is None else func_mask[f],
                    )
                    for f in range(k.shape[0])
                ])  # [F, Bq, H, Lq, D]
            else:
                out = normalized_linear_attention(q, k, v, kv_mask=func_mask)
            res = self._merge(q) + self._merge(out.mean(dim=0))
        else:
            k = feature_softmax(split_heads(self.key(query), h))
            v = split_heads(self.value(query), h)
            if packed:
                out = packed_normalized_linear_attention(
                    q, k, v, q_seg_oh=q_seg_oh, kv_seg_oh=q_seg_oh, kv_mask=query_mask
                )
            else:
                out = normalized_linear_attention(q, k, v, kv_mask=query_mask)
            res = self._merge(q) + self._merge(out)
        return self.fc_out(res)


class GatedExpertFfn(nn.Module):
    """Dense soft mixture-of-experts FFN (model.py:123-124,128-131).

    Every expert runs on every token; outputs are combined with the
    geometry-gating ``scores``. The E expert MLPs are stacked
    (``experts.dense_i.kernel [E, in, out]``). ``ffn_impl='xla'`` runs
    them as batched matmuls in plain torch; ``'pallas'`` runs the whole
    expert stack in the fused gated-FFN kernel (ops/fused_ffn.py) where
    the kernel takes the shapes (``kernel_takes``, as
    ``fits_vmem`` guards the JAX call) and the torch path elsewhere. On
    a CUDA tensor the kernel launches; on a CPU tensor its plain version
    runs. A bf16 model gives the kernel bf16 tokens and f32 gate scores,
    with the weights and biases it holds: bf16 in a served copy (bf16
    serving), the f32 master weights in training (bf16 training), the two
    mixes the JAX model passes its kernel.
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
        dtype: torch.dtype | None = None,
    ):
        super().__init__()
        if ffn_impl not in ("xla", "pallas"):
            raise ValueError(f"unknown ffn_impl {ffn_impl!r}")
        self.ffn_impl = ffn_impl
        self.gelu = gelu
        self.experts = Mlp(
            in_dim, num_layers, hidden_dim, output_dim, gelu,
            stack=n_expert, generator=generator, dtype=dtype,
        )

    def forward(self, x: torch.Tensor, scores: torch.Tensor) -> torch.Tensor:
        if self.ffn_impl == "pallas":
            layers = self.experts.layers()
            kernels = [l.kernel for l in layers]
            biases = [l.bias for l in layers]
            if kernel_takes(x, scores, kernels, biases):
                return fused_gated_ffn(x, scores, kernels, biases, gelu_kind=self.gelu)
        e = scores.shape[-1]
        out = self.experts(x.unsqueeze(0).expand(e, *x.shape))  # [E, B, L, D]
        return torch.einsum("ebld,ble->bld", out, scores.to(out.dtype))
