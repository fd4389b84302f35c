"""The port's layers against the JAX modules, weights carried across.

JAX params (``jax.device_get``) flatten to the port's ``state_dict``
names one to one (``gnot_tpu_torch.interop.flatten_tree``); inputs are
numpy arrays from a seed, handed to both."""

import jax
import numpy as np
import pytest
import torch

from gnot_tpu.models import layers as jl
from gnot_tpu_torch.interop import flatten_tree
from gnot_tpu_torch.models import layers as tl

RTOL, ATOL = 1e-5, 1e-6


def _load(module: torch.nn.Module, jax_params) -> torch.nn.Module:
    flat = flatten_tree(jax.device_get(jax_params))
    state = {k: torch.from_numpy(np.array(v)) for k, v in flat.items()}
    module.load_state_dict(state, strict=True)
    return module.eval()


def _rng_arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


@pytest.mark.parametrize("gelu", ["tanh", "erf"])
@pytest.mark.parametrize("num_layers", [1, 3])
def test_mlp_matches(gelu, num_layers):
    (x,) = _rng_arrays(0, (2, 9, 5))
    jmod = jl.Mlp(num_layers, 32, 7, gelu=gelu)
    params = jmod.init(jax.random.key(0), x)["params"]
    want = jmod.apply({"params": params}, x)
    port = _load(tl.Mlp(5, num_layers, 32, 7, gelu), params)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def _masks(seed, b, lq, n_funcs, lf, empty_slab):
    rng = np.random.default_rng(seed)
    qmask = (rng.uniform(size=(b, lq)) < 0.8).astype(np.float32)
    qmask[:, 0] = 1.0
    fmask = (rng.uniform(size=(n_funcs, b, lf)) < 0.7).astype(np.float32)
    fmask[..., 0] = 1.0
    if empty_slab:
        fmask[-1, 0] = 0.0  # one record with an empty input function
    return qmask, fmask


@pytest.mark.parametrize(
    "n_funcs,empty_slab",
    [(0, False), (1, False), (3, False), (3, True)],
    ids=["self", "cross_f1", "cross_f3", "cross_f3_empty_slab"],
)
def test_linear_attention_matches(n_funcs, empty_slab):
    b, lq, lf, dq, df, e, h = 2, 11, 7, 16, 12, 32, 4
    query, funcs = _rng_arrays(1, (b, lq, dq), (max(n_funcs, 1), b, lf, df))
    qmask, fmask = _masks(2, b, lq, max(n_funcs, 1), lf, empty_slab)
    jmod = jl.LinearAttention(e, h, n_funcs)
    if n_funcs:
        args, kw = (query, funcs), dict(query_mask=qmask, func_mask=fmask)
    else:
        args, kw = (query,), dict(query_mask=qmask)
    params = jmod.init(jax.random.key(1), *args, **kw)["params"]
    want = np.asarray(jmod.apply({"params": params}, *args, **kw))
    port = _load(tl.LinearAttention(e, h, n_funcs, query_dim=dq, func_dim=df), params)
    with torch.no_grad():
        got = port(
            *[torch.from_numpy(a) for a in args],
            **{k: torch.from_numpy(v) for k, v in kw.items()},
        ).numpy()
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("ffn_impl", ["xla", "pallas"])
@pytest.mark.parametrize("gelu", ["tanh", "erf"])
def test_gated_expert_ffn_matches(ffn_impl, gelu):
    x, logits = _rng_arrays(3, (2, 13, 32), (2, 13, 3))
    scores = np.array(jax.nn.softmax(logits, axis=-1))
    jmod = jl.GatedExpertFfn(3, 2, 32, 32, ffn_impl=ffn_impl, gelu=gelu)
    params = jmod.init(jax.random.key(2), x, scores)["params"]
    want = np.asarray(jmod.apply({"params": params}, x, scores))
    port = _load(
        tl.GatedExpertFfn(3, 2, 32, 32, in_dim=32, ffn_impl=ffn_impl, gelu=gelu),
        params,
    )
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(scores)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_expert_weights_stay_stacked_for_the_kernel():
    port = tl.GatedExpertFfn(3, 2, 32, 16, in_dim=48, ffn_impl="pallas")
    shapes = {k: tuple(v.shape) for k, v in port.state_dict().items()}
    assert shapes["experts.dense_0.kernel"] == (3, 48, 32)
    assert shapes["experts.dense_2.kernel"] == (3, 32, 16)
    assert shapes["experts.dense_2.bias"] == (3, 16)
    assert all(p.is_contiguous() for p in port.parameters())


def test_torch_linear_init_bounds_and_generator():
    g1 = torch.Generator().manual_seed(3)
    g2 = torch.Generator().manual_seed(3)
    a = tl.Dense(64, 8, generator=g1)
    b = tl.Dense(64, 8, generator=g2)
    assert torch.equal(a.kernel, b.kernel) and torch.equal(a.bias, b.bias)
    assert a.kernel.abs().max().item() <= 1 / 8 and a.bias.abs().max().item() <= 1 / 8
