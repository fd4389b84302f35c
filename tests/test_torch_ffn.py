"""The port's fused gated-FFN module against the JAX Pallas kernel.

On the CPU the JAX kernel runs in Pallas interpret mode (as
tests/test_pallas_ffn.py runs it) and the port's wrapper takes its plain
version; the hand-written CUDA kernel runs only on a card
(tests/test_torch_cuda.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnot_tpu.ops.pallas_ffn import _erf_f32, fused_gated_ffn as jax_fused_gated_ffn
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

