"""Fused gated soft-MoE expert FFN: the Hopper kernel and its plain version.

Replaces the TPU kernel ``gnot_tpu/ops/pallas_ffn.py::fused_gated_ffn``
(``_ffn_call`` -> ``pallas_call`` -> ``_ffn_kernel``). GNOT's FFN is a
dense soft mixture: E expert MLPs all run on every token and the
geometry gate combines them.

* ``fused_gated_ffn_kernel`` launches ``csrc/fused_gated_ffn.cu`` on
  CUDA tensors. It is bound by arithmetic on the H100: one launch at the
  serving shapes is 8.05 GFLOP against ~12.4 MB of compulsory traffic.
  The TPU kernel kept all 3.9 MB of weights resident in VMEM; a Hopper
  block has 227 KB of shared memory, so this one keeps each 32-row
  tile's activations in shared memory through the whole expert stack
  and streams the weights through it in double-buffered chunks out of
  L2 (the source's header has the layout).
* ``fused_gated_ffn_reference`` is the plain PyTorch version, a port of
  ``_reference_impl``: the CPU tests and the on-card check use it.
* ``fused_gated_ffn`` dispatches on where the tensors lie: the plain
  version for CPU tensors, the kernel for CUDA tensors. On a CUDA tensor
  it launches the kernel or raises; it never falls back. It is a
  ``torch.autograd.Function`` whose backward is autograd through the
  plain version, as the JAX ``custom_vjp`` recomputes ``_reference_impl``
  (``pallas_ffn._fused_bwd``): the JAX package has no backward kernel.

The public layout is the JAX one: x ``[B, L, Din]``, scores ``[B, L, E]``,
per-Linear kernels ``[E, in, out]`` and biases ``[E, out]``.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from gnot_tpu_torch.ops import build

GELU_CODES = {"tanh": 0, "erf": 1}
MAX_LINEARS = 8
MAX_WIDTH = 256


def erf_f32(x: torch.Tensor) -> torch.Tensor:
    """float32 erf as the rational polynomial of ``pallas_ffn._erf_f32``
    (Eigen's ``generic_fast_erf_float``), within ~4e-7 of exact erf. The
    kernel computes the same polynomial."""
    x = torch.clamp(x, -3.832506856900711, 3.832506856900711)
    z = x * x
    alpha = z * -2.72614225801306e-10 + 2.77068142495902e-08
    alpha = alpha * z + -2.10102402082508e-06
    alpha = alpha * z + -5.69250639462346e-05
    alpha = alpha * z + -7.34990630326855e-04
    alpha = alpha * z + -2.95459980854025e-03
    alpha = alpha * z + -1.60960333262415e-02
    beta = z * -1.45660718464996e-05 + -2.13374055278905e-04
    beta = beta * z + -1.68282697438203e-03
    beta = beta * z + -7.37332916720468e-03
    beta = beta * z + -1.42647390514189e-02
    return x * alpha / beta


def gelu(x: torch.Tensor, kind: str) -> torch.Tensor:
    """The FFN kernel's GELU: tanh approximation or polynomial-erf GELU."""
    if kind == "tanh":
        c = 0.7978845608028654  # sqrt(2/pi)
        return 0.5 * x * (1.0 + torch.tanh(c * (x + 0.044715 * x * x * x)))
    return 0.5 * x * (1.0 + erf_f32(x * 0.7071067811865476))


def fused_gated_ffn_reference(
    x: torch.Tensor,
    scores: torch.Tensor,
    kernels: Sequence[torch.Tensor],
    biases: Sequence[torch.Tensor],
    gelu_kind: str = "erf",
) -> torch.Tensor:
    """Plain PyTorch version with the kernel's f32 semantics: per-expert
    MLP over every token, gate-weighted sum over experts."""
    h = x.float().unsqueeze(0).expand(kernels[0].shape[0], *x.shape)  # [E,B,L,D]
    n = len(kernels)
    for i, (k, b) in enumerate(zip(kernels, biases)):
        h = torch.einsum("ebld,edo->eblo", h, k.float()) + b.float()[:, None, None, :]
        if i < n - 1:
            h = gelu(h, gelu_kind)
    return torch.einsum("eblo,ble->blo", h, scores.float()).to(x.dtype)


def _check_kernel_args(x, scores, kernels, biases, gelu_kind) -> list[int]:
    if gelu_kind not in GELU_CODES:
        raise ValueError(f"unknown gelu {gelu_kind!r}; one of {sorted(GELU_CODES)}")
    if not 1 <= len(kernels) <= MAX_LINEARS or len(biases) != len(kernels):
        raise ValueError(
            f"need 1..{MAX_LINEARS} Linears with one bias each, got "
            f"{len(kernels)} kernels and {len(biases)} biases"
        )
    if x.dim() != 3 or scores.dim() != 3 or scores.shape[:2] != x.shape[:2]:
        raise ValueError(
            f"x must be [B, L, Din] and scores [B, L, E], got "
            f"{tuple(x.shape)} and {tuple(scores.shape)}"
        )
    n_expert = scores.shape[-1]
    dims = [x.shape[-1]]
    for i, (k, b) in enumerate(zip(kernels, biases)):
        if k.dim() != 3 or k.shape[0] != n_expert or k.shape[1] != dims[-1]:
            raise ValueError(
                f"kernel {i} must be [{n_expert}, {dims[-1]}, out], got "
                f"{tuple(k.shape)}"
            )
        if tuple(b.shape) != (n_expert, k.shape[2]):
            raise ValueError(
                f"bias {i} must be [{n_expert}, {k.shape[2]}], got {tuple(b.shape)}"
            )
        dims.append(k.shape[2])
    bad = [d for d in dims if d % 16 or not 16 <= d <= MAX_WIDTH]
    if bad:
        raise ValueError(
            f"the fused FFN kernel takes widths that are multiples of 16 "
            f"in [16, {MAX_WIDTH}]; got widths {dims}"
        )
    for t in (x, scores, *kernels, *biases):
        if not t.is_cuda or t.device != x.device:
            raise ValueError("every tensor must lie on the same CUDA device")
        if t.dtype != torch.float32:
            raise ValueError(f"the fused FFN kernel is float32 only, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("the fused FFN kernel needs contiguous tensors")
        if t.data_ptr() % 16:
            raise ValueError("the fused FFN kernel needs 16-byte aligned tensors")
    return dims


def _bind(lib: ctypes.CDLL) -> None:
    fn = lib.gnot_fused_gated_ffn
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int


def fused_gated_ffn_kernel(
    x: torch.Tensor,
    scores: torch.Tensor,
    kernels: Sequence[torch.Tensor],
    biases: Sequence[torch.Tensor],
    gelu_kind: str = "erf",
) -> torch.Tensor:
    """Launch the Hopper kernel on PyTorch's current stream. Raises on
    arguments it does not take and when the launch is refused."""
    dims = _check_kernel_args(x, scores, kernels, biases, gelu_kind)
    lib = build.load("fused_gated_ffn")
    _bind(lib)
    out = torch.empty(*x.shape[:2], dims[-1], device=x.device, dtype=torch.float32)
    n = len(kernels)
    w_ptrs = (ctypes.c_uint64 * n)(*[k.data_ptr() for k in kernels])
    b_ptrs = (ctypes.c_uint64 * n)(*[b.data_ptr() for b in biases])
    dim_arr = (ctypes.c_int * (n + 1))(*dims)
    err = lib.gnot_fused_gated_ffn(
        x.data_ptr(),
        scores.data_ptr(),
        out.data_ptr(),
        ctypes.addressof(w_ptrs),
        ctypes.addressof(b_ptrs),
        ctypes.addressof(dim_arr),
        n,
        scores.shape[-1],
        x.shape[0] * x.shape[1],
        GELU_CODES[gelu_kind],
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"fused_gated_ffn launch failed: cudaError {err}")
    fused_gated_ffn_kernel.launches += 1
    return out


#: Kernel launches so far: the wrapper adds one where it launches.
fused_gated_ffn_kernel.launches = 0


class _FusedGatedFfn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, gelu_kind, n_linears, x, scores, *params):
        ctx.save_for_backward(x, scores, *params)
        ctx.gelu_kind, ctx.n_linears = gelu_kind, n_linears
        kernels, biases = params[:n_linears], params[n_linears:]
        if x.is_cuda:
            return fused_gated_ffn_kernel(x, scores, kernels, biases, gelu_kind)
        return fused_gated_ffn_reference(x, scores, kernels, biases, gelu_kind)

    @staticmethod
    def backward(ctx, g):
        n = ctx.n_linears
        with torch.enable_grad():
            xs = [t.detach().requires_grad_(True) for t in ctx.saved_tensors]
            out = fused_gated_ffn_reference(xs[0], xs[1], xs[2 : 2 + n], xs[2 + n :], ctx.gelu_kind)
            grads = torch.autograd.grad(out, xs, g)
        return (None, None, *grads)


def fused_gated_ffn(
    x: torch.Tensor,
    scores: torch.Tensor,
    kernels: Sequence[torch.Tensor],
    biases: Sequence[torch.Tensor],
    gelu_kind: str = "erf",
) -> torch.Tensor:
    """Fused gated expert FFN: ``[B, L, Din]`` tokens and ``[B, L, E]``
    gate weights to ``[B, L, Dout]``. The kernel on CUDA tensors, the
    plain version on CPU tensors; gradients recompute through the plain
    version."""
    return _FusedGatedFfn.apply(gelu_kind, len(kernels), x, scores, *kernels, *biases)
