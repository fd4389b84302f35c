"""The port's fused gated-FFN module against the JAX Pallas kernel:
forward and, through its autograd wrapper, gradients; the CUDA kernel's
packed weight image, its cache, and a plain-torch emulation of its
3xTF32 arithmetic against JAX's reference.

On the CPU the JAX kernel runs in Pallas interpret mode (as
tests/test_pallas_ffn.py runs it) and the port's wrapper takes its plain
version; the hand-written CUDA kernel runs only on a card
(tests/test_torch_cuda.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

from gnot_tpu.ops.pallas_ffn import _erf_f32, fused_gated_ffn as jax_fused_gated_ffn
from gnot_tpu.ops.pallas_ffn import _reference_impl as jax_reference_impl
from gnot_tpu_torch.ops import fused_ffn


def _inputs(seed, b=2, l=12, din=16, hid=24, dout=16, e=3, n_layers=2):
    """FFN inputs from a numpy seed, at tests/test_pallas_ffn.py's
    widths (the kernel takes multiples of 16 only)."""
    rng = np.random.default_rng(seed)
    dims = [din] + [hid] * n_layers + [dout]
    kernels = [
        (rng.standard_normal((e, dims[i], dims[i + 1])) * 0.3).astype(np.float32)
        for i in range(n_layers + 1)
    ]
    biases = [
        rng.standard_normal((e, dims[i + 1])).astype(np.float32)
        for i in range(n_layers + 1)
    ]
    x = rng.standard_normal((b, l, din)).astype(np.float32)
    logits = rng.standard_normal((b, l, e)).astype(np.float32)
    scores = (np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)).astype(np.float32)
    return x, scores, kernels, biases


def _torch(x, scores, kernels, biases, device="cpu"):
    t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    return t(x), t(scores), [t(k) for k in kernels], [t(b) for b in biases]


@pytest.mark.parametrize("gelu", ["tanh", "erf"])
@pytest.mark.parametrize("l", [12, 300])  # 300 is not a multiple of the tile
def test_reference_matches_jax_kernel(gelu, l):
    x, scores, kernels, biases = _inputs(0, l=l)
    want = jax_fused_gated_ffn(
        jnp.asarray(x), jnp.asarray(scores),
        [jnp.asarray(k) for k in kernels], [jnp.asarray(b) for b in biases],
        None, gelu,
    )
    got = fused_ffn.fused_gated_ffn_reference(*_torch(x, scores, kernels, biases), gelu)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("gelu", ["tanh", "erf"])
def test_wrapper_takes_plain_version_for_cpu_tensors(gelu):
    args = _torch(*_inputs(1, l=20))
    before = fused_ffn.fused_gated_ffn_kernel.launches
    got = fused_ffn.fused_gated_ffn(*args, gelu_kind=gelu)
    want = fused_ffn.fused_gated_ffn_reference(*args, gelu_kind=gelu)
    assert torch.equal(got, want)
    assert fused_ffn.fused_gated_ffn_kernel.launches == before


def test_kernel_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA device"):
        fused_ffn.fused_gated_ffn_kernel(*_torch(*_inputs(2, hid=32)))


@pytest.mark.parametrize(
    "mutate,match",
    [
        (lambda a: (a[0], a[1], a[2][:1], a[3]), "one bias each"),
        (lambda a: (a[0][..., :8], a[1], a[2], a[3]), "kernel 0 must be"),
        (lambda a: (a[0], a[1][..., :2], a[2], a[3]), "kernel 0 must be"),
        (lambda a: (a[0], a[1], a[2], [b[:, :4] for b in a[3]]), "bias 0 must be"),
    ],
)
def test_kernel_wrapper_checks_shapes(mutate, match):
    with pytest.raises(ValueError, match=match):
        fused_ffn.fused_gated_ffn_kernel(*mutate(_torch(*_inputs(3))))


def test_kernel_wrapper_refuses_unsupported_widths():
    args = _torch(*_inputs(4, din=24, hid=24, dout=24))
    with pytest.raises(ValueError, match="multiples of 16"):
        fused_ffn.fused_gated_ffn_kernel(*args)


def test_erf_polynomial_matches_jax():
    x = np.linspace(-5, 5, 2001, dtype=np.float32)
    got = fused_ffn.erf_f32(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(_erf_f32(jnp.asarray(x))), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(got, np.asarray(jax.scipy.special.erf(x)), atol=1e-6)



@pytest.mark.parametrize("gelu", ["tanh", "erf"])
def test_gradients_match_jax(gelu):
    """The autograd wrapper's gradients (backward recomputes the plain
    version) against jax.grad of the JAX kernel's custom_vjp, at
    tests/test_pallas_ffn.py's shapes, for every input. The loss is linear
    in the output with a fixed cotangent from the seed, so both sides
    run their backward on the same cotangent and the comparison is of
    the backward alone (a loss of the output's square would feed each
    side its own forward's rounding)."""
    x, scores, kernels, biases = _inputs(5, l=12, hid=24)
    cot = np.random.default_rng(6).standard_normal((2, 12, 16)).astype(np.float32)
    args = _torch(x, scores, kernels, biases)
    leaves = [args[0], args[1], *args[2], *args[3]]
    for t in leaves:
        t.requires_grad_(True)
    (fused_ffn.fused_gated_ffn(*args, gelu_kind=gelu) * torch.from_numpy(cot)).sum().backward()

    def loss(x_, s_, k_, b_):
        return jnp.sum(jax_fused_gated_ffn(x_, s_, k_, b_, None, gelu) * cot)

    want = jax.grad(loss, argnums=(0, 1, 2, 3))(
        jnp.asarray(x), jnp.asarray(scores),
        [jnp.asarray(k) for k in kernels], [jnp.asarray(b) for b in biases],
    )
    # torch and XLA sum the backward's contractions in other orders: a few
    # ulp of O(10) gradients. The bar is the JAX package's own for its FFN
    # kernel's gradients (tests/test_pallas_ffn.py:52-55).
    for got, w in zip(leaves, jax.tree.leaves(want)):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(w), rtol=1e-4, atol=5e-6)


# -- the kernel's weight image and its 3xTF32 arithmetic -------------------


def _model_inputs(seed, b, l, dims, e):
    """FFN inputs at the model's init (U(+-1/sqrt(fan_in)) weights and
    biases, as chip_smoke.py makes them), from a numpy seed."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, l, dims[0]), dtype=np.float32)
    logits = rng.standard_normal((b, l, e), dtype=np.float32)
    scores = (np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)).astype(np.float32)
    kernels, biases = [], []
    for i in range(len(dims) - 1):
        bound = 1.0 / np.sqrt(dims[i])
        kernels.append(rng.uniform(-bound, bound, (e, dims[i], dims[i + 1])).astype(np.float32))
        biases.append(rng.uniform(-bound, bound, (e, dims[i + 1])).astype(np.float32))
    return x, scores, kernels, biases


FULL_WIDTH = [256] * 6  # five 256-wide Linears, as the reference model
TOOL_WIDTHS = [32, 64, 64, 32]  # tools/validate_tpu_kernels.py's FFN


def _emulate(x, scores, kernels, biases, gelu, three=True):
    """Plain torch of the CUDA kernel's arithmetic, through the packed
    images: each Linear as a_lo @ w_hi + a_hi @ w_lo + a_hi @ w_hi
    (3xTF32, f32 sums), or as one TF32 product (``three=False``); bias,
    GELU and the gate-weighted sum in f32."""
    e = scores.shape[-1]
    h = x.reshape(1, -1, x.shape[-1]).expand(e, -1, -1)
    for i, (k, b) in enumerate(zip(kernels, biases)):
        w_hi, w_lo = fused_ffn.unpack_weights(fused_ffn.pack_weights(k), k.shape)
        if three:
            a_hi, a_lo = fused_ffn.tf32_split(h)
            h = a_lo @ w_hi + a_hi @ w_lo + a_hi @ w_hi
        else:
            h = fused_ffn.tf32_round(h) @ w_hi
        h = h + b[:, None, :]
        if i < len(kernels) - 1:
            h = fused_ffn.gelu(h, gelu)
    out = torch.einsum("ero,re->ro", h, scores.reshape(-1, e))
    return out.reshape(*x.shape[:2], -1)


def _f64(x, scores, kernels, biases, gelu):
    """The FFN in float64: the yardstick the f32 and TF32 forms are
    measured against."""
    h = x.double().unsqueeze(0).expand(kernels[0].shape[0], *x.shape)
    for i, (k, b) in enumerate(zip(kernels, biases)):
        h = torch.einsum("ebld,edo->eblo", h, k.double()) + b.double()[:, None, None, :]
        if i < len(kernels) - 1:
            h = fused_ffn.gelu(h, gelu)
    return torch.einsum("eblo,ble->blo", h, scores.double())


@pytest.mark.parametrize("shape", [(3, 256, 256), (2, 48, 16), (1, 32, 64), (4, 16, 256), (1, 256, 48)])
def test_pack_roundtrip_split_and_padding(shape):
    rng = np.random.default_rng(sum(shape))
    w = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
    image = fused_ffn.pack_weights(w)
    e, k, n = shape
    assert image.numel() == e * 2 * k * 2 * fused_ffn.HALF_COLS  # hi and lo of 256 columns
    hi, lo = fused_ffn.unpack_weights(image, shape)
    want_hi, want_lo = fused_ffn.tf32_split(w)
    assert torch.equal(hi, want_hi) and torch.equal(lo, want_lo)  # exactly the JAX layout back
    for part in (hi, lo):  # TF32: the low 13 mantissa bits are 0
        assert not (part.view(torch.int32) & 0x1FFF).any()
    assert ((w - hi - lo).abs() <= 2.0**-21 * w.abs()).all()
    # Every padded column of the image is 0, in hi and in lo.
    hi_all, lo_all = fused_ffn.unpack_weights(image, (e, k, 256))
    assert not hi_all[..., n:].any() and not lo_all[..., n:].any()
    assert torch.equal(hi_all[..., :n], hi)


def test_pack_chunk_order_is_wgmma_core_matrices():
    """One chunk of the image by hand: step kk, K half j // 4, column
    group n // 8, then (n % 8, j % 4), K permuted by K_ORDER."""
    w = torch.arange(2 * 32 * 256, dtype=torch.float32).reshape(2, 32, 256) / 1024.0
    image = fused_ffn.pack_weights(w).view(2, 2, 2, 2, 2, 2, 16, 8, 4)
    e, half, c, kk, jh, nh, nl, jl = 1, 1, 1, 1, 0, 3, 5, 2
    j = 4 * jh + jl
    k = 16 * c + fused_ffn.K_ORDER[8 * kk + j]
    col = 128 * half + 8 * nh + nl
    hi, lo = fused_ffn.tf32_split(w[e, k, col].reshape(1))
    assert image[e, half, c, 0, kk, jh, nh, nl, jl] == hi[0]
    assert image[e, half, c, 1, kk, jh, nh, nl, jl] == lo[0]


@pytest.mark.parametrize("gelu", ["tanh", "erf"])
@pytest.mark.parametrize("dims", [FULL_WIDTH, TOOL_WIDTHS], ids=["full_width", "tool"])
def test_3xtf32_emulation_matches_jax_reference(gelu, dims):
    """The kernel's split arithmetic over its packed weights holds the
    port's kernel bar (rtol 1e-4 / atol 1e-5, chip_smoke.py) against
    JAX's ``_reference_impl`` at full width and at the tool's shape."""
    x, scores, kernels, biases = _model_inputs(11, 2, 256, dims, 3)
    want = jax_reference_impl(
        jnp.asarray(x), jnp.asarray(scores),
        [jnp.asarray(k) for k in kernels], [jnp.asarray(b) for b in biases], gelu,
    )
    got = _emulate(*_torch(x, scores, kernels, biases), gelu)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("gelu", ["tanh", "erf"])
def test_one_tf32_product_is_100x_worse_than_3xtf32(gelu):
    """Why three products: at full width, against a float64 forward, one
    TF32 product's max error is at least 100x that of 3xTF32, which is
    within a few times that of f32. (The single-product error sits near
    the bar itself, so the ratio, not a pass/fail at the bar, is held.)"""
    args = _torch(*_model_inputs(12, 2, 256, FULL_WIDTH, 3))
    exact = _f64(*args, gelu)
    err = lambda got: (got.double() - exact).abs().max().item()  # noqa: E731
    err_f32 = err(fused_ffn.fused_gated_ffn_reference(*args, gelu))
    err_3x = err(_emulate(*args, gelu))
    err_1x = err(_emulate(*args, gelu, three=False))
    assert err_1x >= 100 * err_3x, (err_1x, err_3x)
    assert err_3x <= 4 * err_f32, (err_3x, err_f32)


def test_pack_cache_repacks_after_in_place_update():
    k = torch.nn.Parameter(torch.from_numpy(_model_inputs(13, 1, 1, [32, 48], 2)[2][0]))
    first = fused_ffn.packed_weights(k)
    assert fused_ffn.packed_weights(k) is first  # no pack on a repeat call
    with torch.no_grad():
        k.mul_(-2.0)
    second = fused_ffn.packed_weights(k)
    assert second is not first
    assert torch.equal(second, fused_ffn.pack_weights(k.detach()))
    assert fused_ffn.packed_weights(k) is second


def test_pack_cache_repacks_a_new_tensor_at_a_recycled_address():
    """A freed tensor's address (and id) may come back with version 0:
    the cache keys on the live tensor itself, so it packs the new one."""
    buf = np.zeros((2, 32, 48), dtype=np.float32)
    buf[:] = _model_inputs(14, 1, 1, [32, 48], 2)[2][0]
    a = torch.from_numpy(buf)
    old = fused_ffn.packed_weights(a)
    ptr, key = a.data_ptr(), id(a)
    del a
    assert key not in fused_ffn._pack_cache  # dropped with its tensor
    buf *= 3.0
    b = torch.from_numpy(buf)  # same memory, a fresh version counter
    assert b.data_ptr() == ptr and b._version == 0
    new = fused_ffn.packed_weights(b)
    assert not torch.equal(new, old)
    assert torch.equal(new, fused_ffn.pack_weights(b))


def test_pack_cache_packs_inference_tensors_every_call():
    """An inference tensor has no version counter, so nothing vouches for
    a cached image of it: it is packed anew on every call."""
    with torch.inference_mode():
        k = torch.from_numpy(_model_inputs(15, 1, 1, [16, 32], 1)[2][0]).clone()
        first = fused_ffn.packed_weights(k)
        k.mul_(2.0)
        second = fused_ffn.packed_weights(k)
    assert not torch.equal(first, second)
    assert torch.equal(second, fused_ffn.pack_weights(k))


def test_ffn_probe_variants_apply_to_the_kernel_source():
    """Every variant of gnot_tpu_torch/ffn_probe.py edits lines that the
    kernel source still has (the probe builds them only on the card)."""
    from gnot_tpu_torch import ffn_probe
    from gnot_tpu_torch.ops import build

    source = ffn_probe.SOURCE.read_text()
    for name, edits in ffn_probe.VARIANTS.items():
        text = build.variant_source("fused_gated_ffn", edits)
        assert (text == source) == (not edits), name
