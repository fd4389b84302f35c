"""Fused gated soft-MoE expert FFN: the Hopper kernel and its plain version.

Replaces the TPU kernel ``gnot_tpu/ops/pallas_ffn.py::fused_gated_ffn``
(``_ffn_call`` -> ``pallas_call`` -> ``_ffn_kernel``). GNOT's FFN is a
dense soft mixture: E expert MLPs all run on every token and the
geometry gate combines them.

* ``fused_gated_ffn_kernel`` launches ``csrc/fused_gated_ffn.cu`` on
  CUDA tensors. It multiplies on the tensor cores in 3xTF32 (each
  operand split into a TF32 high and low part, three products summed in
  f32), which holds the f32 bar that one TF32 product misses; its bound
  on the H100 is the tensor cores' TF32 rate, 3 x 8.05 GFLOP at the
  serving shapes. A
  cluster of two blocks owns each 64-row tile and keeps its activations
  in shared memory through the whole expert stack (the source's header
  has the design). It takes three dtype mixes (``KERNEL_DTYPES``), all
  with f32 gate scores: f32 x, weights and biases; bf16 ones (bf16
  serving, which publishes bf16 weights); bf16 x with the f32 weights and
  biases (bf16 training, where the model computes in bf16 on its f32
  master weights). It computes in f32 in every mix and writes x's dtype,
  as the TPU kernel does.
* ``pack_weights`` turns one ``[E, in, out]`` kernel into the image the
  CUDA kernel streams (K-major, hi and lo, zero-padded, in wgmma's
  shared-memory order); ``unpack_weights`` inverts it. ``packed_weights``
  caches the image per weight tensor and version, so a serving dispatch
  pays no pack.
* ``fused_gated_ffn_reference`` is the plain PyTorch version, a port of
  ``_reference_impl``, in full f32 whatever the inputs' dtype, returning
  x's dtype: the CPU tests and the on-card check use it.
* ``fused_gated_ffn`` dispatches on where the tensors lie: the plain
  version for CPU tensors, the kernel for CUDA tensors. On a CUDA tensor
  it launches the kernel or raises; it never falls back. It is a
  ``torch.autograd.Function`` whose backward is autograd through the
  plain version, as the JAX ``custom_vjp`` recomputes ``_reference_impl``
  (``pallas_ffn._fused_bwd``): the JAX package has no backward kernel.
  The gradients come back in each input's dtype, as JAX's vjp returns
  them: bf16 for bf16 x, f32 for the scores and f32 weights.

The public layout is the JAX one: x ``[B, L, Din]``, scores ``[B, L, E]``,
per-Linear kernels ``[E, in, out]`` and biases ``[E, out]``.
"""

from __future__ import annotations

import ctypes
import threading
import weakref
from typing import Sequence

import torch

from gnot_tpu_torch.ops import build

GELU_CODES = {"tanh": 0, "erf": 1}
MAX_LINEARS = 8
MAX_WIDTH = 256
# The kernel's weight chunk: 16 K-rows by 128 output columns, one of the
# two column halves of a 256-wide (zero-padded) Linear.
CHUNK_K = 16
HALF_COLS = 128
# Logical K of a chunk, in wgmma order (step kk, k8 index j), to its
# column: thread t4 of the kernel reads columns 4*t4..4*t4+3 as one
# float4 and feeds them as j = t4, t4 + 4 of steps 0 and 1. Column
# 4*(j%4) + 2*kk + j//4 is axis (j%4, kk, j//4) of a [4, 2, 2] view, so
# the pack reorders K with a permute: no index tensor, whose making from
# a list would be a blocking host-to-device copy on every repack.
K_ORDER = [4 * (j % 4) + 2 * kk + j // 4 for kk in range(2) for j in range(8)]


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


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """Round float32 to TF32 (10 mantissa bits), nearest with ties away
    from zero, as the kernel's ``cvt.rna.tf32.f32``: the low 13 bits of
    the result are 0."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``x`` as ``hi + lo``: ``hi`` its TF32 rounding, ``lo`` the TF32
    rounding of the rest, so ``|x - hi - lo| <= 2**-21 |x|``."""
    hi = tf32_round(x)
    return hi, tf32_round(x - hi)


def pack_weights(kernel: torch.Tensor) -> torch.Tensor:
    """The kernel's image of one ``[E, K, N]`` Linear (K a multiple of 16,
    N <= 256): ``[E, 2 halves, K/16 chunks, (hi, lo), 2 steps, 2, 16, 8,
    4]``, flat. Columns are zero-padded to 256 and cut into two halves of
    128, one per block of a cluster; a chunk is 16 K-rows of a half, hi
    then lo; within a k8 step, wgmma's K-major core matrices (8 columns x
    4 K, 128 B) with the two K halves 512 floats apart and neighbouring
    column groups 32 floats apart; K is reordered by ``K_ORDER``."""
    e, k, n = kernel.shape
    nck = k // CHUNK_K
    # f32 for either weight dtype: a bf16 weight widens exactly, and its
    # lo part is then all zeros.
    w = kernel.new_zeros(e, k, 2 * HALF_COLS, dtype=torch.float32)
    w[:, :, :n] = kernel
    # [E, chunk, j%4, kk, j//4, half, n//8, n%8] -> wgmma order
    w = w.view(e, nck, 4, 2, 2, 2, HALF_COLS // 8, 8).permute(0, 5, 1, 3, 4, 6, 7, 2)
    hi, lo = tf32_split(w.contiguous())
    return torch.stack([hi, lo], dim=3).reshape(-1)


def unpack_weights(image: torch.Tensor, shape: Sequence[int]) -> tuple[torch.Tensor, torch.Tensor]:
    """``pack_weights``' inverse: the hi and lo parts of an image of an
    ``[E, K, N]`` kernel, each in the JAX layout."""
    e, k, n = shape
    nck = k // CHUNK_K
    v = image.view(e, 2, nck, 2, 2, 2, HALF_COLS // 8, 8, 4)
    parts = []
    for p in range(2):
        w = v[:, :, :, p].permute(0, 2, 7, 3, 4, 1, 5, 6).reshape(e, k, 2 * HALF_COLS)
        parts.append(w[..., :n].contiguous())
    return parts[0], parts[1]


_pack_lock = threading.Lock()
# id(kernel) -> (weakref to it, (its version, its data pointer), its image).
_pack_cache: dict[int, tuple] = {}


def _drop_pack(key: int, ref: weakref.ref) -> None:
    with _pack_lock:
        if key in _pack_cache and _pack_cache[key][0] is ref:
            del _pack_cache[key]


def packed_weights(kernel: torch.Tensor) -> torch.Tensor:
    """``pack_weights(kernel)``, cached per tensor: the image is made again
    after an in-place update (the tensor's version moves) or for a new
    tensor, even one at a freed tensor's address. In-place writes
    through ``.data`` bypass the version counter and are not seen, nor
    are those of torch's fused AdamW (``fused=True``) on the card; an
    inference tensor has no version counter and is packed on every
    call."""
    if kernel.is_inference():
        image = pack_weights(kernel)
        with _pack_lock:
            packed_weights.packs += 1
        return image
    key = id(kernel)
    version = (kernel._version, kernel.data_ptr())
    with _pack_lock:
        hit = _pack_cache.get(key)
        if hit is not None and hit[0]() is kernel and hit[1] == version:
            return hit[2]
    with torch.no_grad():
        image = pack_weights(kernel.detach())
    ref = weakref.ref(kernel, lambda r, key=key: _drop_pack(key, r))
    with _pack_lock:
        _pack_cache[key] = (ref, version, image)
        packed_weights.packs += 1
    return image


#: Images made so far (cache misses): a served model repacks once per
#: publish, never per dispatch.
packed_weights.packs = 0


#: The dtype mixes the kernel takes, (x and output dtype, weight and bias
#: dtype) -> (the launcher's code, the mix's name): float32 throughout;
#: bfloat16 throughout (bf16 serving); bfloat16 x with float32 weights and
#: biases (bf16 training). The gate scores are float32 in every mix, as
#: the JAX model passes them.
KERNEL_DTYPES = {
    (torch.float32, torch.float32): (0, "f32"),
    (torch.bfloat16, torch.bfloat16): (1, "bf16"),
    (torch.bfloat16, torch.float32): (2, "bf16-x/f32-w"),
}


def _dtype_mix(x, scores, kernels, biases) -> tuple[int, str] | None:
    """The kernel's code and name for these inputs' dtypes, or None for a
    mix it does not take."""
    params = {t.dtype for t in (*kernels, *biases)}
    if scores.dtype != torch.float32 or len(params) != 1:
        return None
    return KERNEL_DTYPES.get((x.dtype, params.pop()))


def _widths_taken(dims: Sequence[int]) -> bool:
    return all(d % 16 == 0 and 16 <= d <= MAX_WIDTH for d in dims)


def kernel_takes(x, scores, kernels, biases) -> bool:
    """Whether the kernel takes these shapes: 1..8 Linears, every width a
    multiple of 16 in [16, 256]. The model's counterpart of ``fits_vmem``
    (``gnot_tpu/ops/pallas_ffn.py``): where it is false the model takes
    its torch path, while the wrapper itself raises. Dtypes are not read
    here: every mix a model gives its FFN (f32 or bf16 compute, on f32
    or bf16 weights, with f32 scores) is one the kernel takes, so any
    other mix is a fault the wrapper raises on."""
    dims = [x.shape[-1]] + [k.shape[-1] for k in kernels]
    return 1 <= len(kernels) <= MAX_LINEARS and _widths_taken(dims)


def _check_kernel_args(x, scores, kernels, biases, gelu_kind) -> tuple[list[int], int, str]:
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
    if not _widths_taken(dims):
        raise ValueError(
            f"the fused FFN kernel takes widths that are multiples of 16 "
            f"in [16, {MAX_WIDTH}]; got widths {dims}"
        )
    mix = _dtype_mix(x, scores, kernels, biases)
    if mix is None:
        raise ValueError(
            "the fused FFN kernel takes float32 x, weights and biases, or "
            "bfloat16 ones, or bfloat16 x with float32 weights and biases, "
            f"with float32 scores; got x {x.dtype}, scores {scores.dtype}, "
            f"weights {sorted({str(t.dtype) for t in (*kernels, *biases)})}"
        )
    for t in (x, scores, *kernels, *biases):
        if not t.is_cuda or t.device != x.device:
            raise ValueError("every tensor must lie on the same CUDA device")
        if not t.is_contiguous():
            raise ValueError("the fused FFN kernel needs contiguous tensors")
        if t.data_ptr() % 16:
            raise ValueError("the fused FFN kernel needs 16-byte aligned tensors")
    return dims, *mix


class _Launcher:
    """The built library, its bound entry point and the argument arrays,
    set up once per process: the host already sets a dispatch's time."""

    def __init__(self, lib: ctypes.CDLL) -> None:
        self.fn = lib.gnot_fused_gated_ffn
        self.fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        self.fn.restype = ctypes.c_int
        self.w = (ctypes.c_uint64 * MAX_LINEARS)()
        self.b = (ctypes.c_uint64 * MAX_LINEARS)()
        self.dims = (ctypes.c_int * (MAX_LINEARS + 1))()
        self.addrs = [ctypes.addressof(a) for a in (self.w, self.b, self.dims)]
        self.lock = threading.Lock()


_launcher: _Launcher | None = None
_launcher_lock = threading.Lock()


def _get_launcher() -> _Launcher:
    global _launcher
    with _launcher_lock:
        if _launcher is None:
            _launcher = _Launcher(build.load("fused_gated_ffn"))
        return _launcher


def fused_gated_ffn_kernel(
    x: torch.Tensor,
    scores: torch.Tensor,
    kernels: Sequence[torch.Tensor],
    biases: Sequence[torch.Tensor],
    gelu_kind: str = "erf",
) -> torch.Tensor:
    """Launch the Hopper kernel on PyTorch's current stream. Raises on
    arguments it does not take and when the launch is refused. The
    weights go in as their cached packed images (``packed_weights``)."""
    out, mix = launch(x, scores, kernels, biases, gelu_kind)
    # Replicas launch from their own worker threads: each count is a
    # read-modify-write, so all three move under one lock.
    with _count_lock:
        fused_gated_ffn_kernel.launches += 1
        by_mix = fused_gated_ffn_kernel.launches_by_dtype
        by_mix[mix] = by_mix.get(mix, 0) + 1
        by_gelu = fused_gated_ffn_kernel.launches_by_gelu
        by_gelu[gelu_kind] = by_gelu.get(gelu_kind, 0) + 1
    return out


def launch(
    x, scores, kernels, biases, gelu_kind, launcher: _Launcher | None = None
) -> tuple[torch.Tensor, str]:
    """One launch through ``launcher``'s library (by default the
    wrapper's; ``gnot_tpu_torch.ffn_probe`` passes variants); counts
    nothing. Returns the output and the name of the dtype mix launched.
    The arguments are checked before anything is built."""
    dims, code, mix = _check_kernel_args(x, scores, kernels, biases, gelu_kind)
    launcher = launcher or _get_launcher()
    images = [packed_weights(k) for k in kernels]
    out = torch.empty(*x.shape[:2], dims[-1], device=x.device, dtype=x.dtype)
    n = len(kernels)
    with launcher.lock:
        for i in range(n):
            launcher.w[i] = images[i].data_ptr()
            launcher.b[i] = biases[i].data_ptr()
        for i, d in enumerate(dims):
            launcher.dims[i] = d
        err = launcher.fn(
            x.data_ptr(),
            scores.data_ptr(),
            out.data_ptr(),
            *launcher.addrs,
            n,
            scores.shape[-1],
            x.shape[0] * x.shape[1],
            GELU_CODES[gelu_kind],
            code,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"fused_gated_ffn launch failed: cudaError {err}")
    return out, mix


#: Kernel launches so far: the wrapper adds one where it launches, to the
#: total, to the count of its dtype mix ("f32", "bf16", "bf16-x/f32-w")
#: and to the count of its GELU ("tanh", "erf"), under ``_count_lock``.
_count_lock = threading.Lock()
fused_gated_ffn_kernel.launches = 0
fused_gated_ffn_kernel.launches_by_dtype = {}
fused_gated_ffn_kernel.launches_by_gelu = {}


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
