"""Card-only tests of the port's CUDA kernels (``cuda`` marker).

Each test skips itself when torch finds no card. This file imports
neither JAX nor the JAX package, so it also runs on a machine without
them, past the suite's JAX-configuring conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from gnot_tpu_torch.config import ModelConfig
from gnot_tpu_torch.data import datasets
from gnot_tpu_torch.data.batch import collate
from gnot_tpu_torch.device import resolve_device
from gnot_tpu_torch.models.gnot import GNOT, apply_batch
from gnot_tpu_torch.ops import fused_ffn


def _card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return resolve_device("cuda")


def _ffn_inputs(seed, b, l, din=16, hid=32, dout=16, e=3, n_layers=2, device="cuda"):
    rng = np.random.default_rng(seed)
    dims = [din] + [hid] * n_layers + [dout]
    kernels = [
        (rng.standard_normal((e, dims[i], dims[i + 1])) * 0.3).astype(np.float32)
        for i in range(n_layers + 1)
    ]
    biases = [rng.standard_normal((e, dims[i + 1])).astype(np.float32) for i in range(n_layers + 1)]
    x = rng.standard_normal((b, l, din)).astype(np.float32)
    logits = rng.standard_normal((b, l, e)).astype(np.float32)
    scores = (np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)).astype(np.float32)
    t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    return t(x), t(scores), [t(k) for k in kernels], [t(bb) for bb in biases]


@pytest.mark.cuda
@pytest.mark.parametrize("gelu", ["tanh", "erf"])
@pytest.mark.parametrize("b,l", [(2, 12), (3, 1000)])  # 3,000 rows: a ragged last tile
def test_kernel_matches_plain_version_on_card(gelu, b, l):
    _card()
    args = _ffn_inputs(5, b, l)
    before = fused_ffn.fused_gated_ffn_kernel.launches
    got = fused_ffn.fused_gated_ffn(*args, gelu_kind=gelu)
    want = fused_ffn.fused_gated_ffn_reference(*args, gelu_kind=gelu)
    torch.cuda.synchronize()
    assert fused_ffn.fused_gated_ffn_kernel.launches == before + 1
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
def test_kernel_refuses_unsupported_width_on_card():
    _card()
    args = _ffn_inputs(6, 2, 12, hid=24)
    with pytest.raises(ValueError, match="multiples of 16"):
        fused_ffn.fused_gated_ffn(*args)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["elasticity", "inductor2d"])
def test_model_on_card_matches_cpu(name):
    """The whole GNOT with the kernel on the card against the same
    weights on the CPU (the kernel's plain version there)."""
    device = _card()
    samples = datasets.SYNTHETIC[name](3, seed=4, base_points=40)
    cfg = ModelConfig(
        **datasets.infer_model_dims(samples), n_attn_layers=2, n_attn_hidden_dim=32,
        n_mlp_num_layers=2, n_mlp_hidden_dim=32, n_input_hidden_dim=32,
        n_expert=2, n_head=4, ffn_impl="pallas",
    )
    cpu_model = GNOT(cfg, generator=torch.Generator().manual_seed(1)).eval()
    with torch.inference_mode():
        want = apply_batch(cpu_model, collate(samples)).numpy()
        got = apply_batch(cpu_model.to(device), collate(samples, device=device)).cpu().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
