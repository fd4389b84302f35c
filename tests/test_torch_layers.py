"""The port's layers against the JAX modules, weights carried across.

JAX params (``jax.device_get``) flatten to the port's ``state_dict``
names one to one (``gnot_tpu_torch.interop.flatten_tree``); inputs are
numpy arrays from a seed, handed to both."""

import jax
import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

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


def _ffn_args(dims, e=3, b=1, l=5, seed=0):
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(a.astype(np.float32))  # noqa: E731
    x = t(rng.standard_normal((b, l, dims[0])))
    scores = torch.softmax(t(rng.standard_normal((b, l, e))), -1)
    kernels = [t(rng.standard_normal((e, dims[i], dims[i + 1])) * 0.1) for i in range(len(dims) - 1)]
    biases = [t(rng.standard_normal((e, dims[i + 1])) * 0.1) for i in range(len(dims) - 1)]
    return x, scores, kernels, biases


@pytest.mark.parametrize(
    "dims,takes",
    [([256] * 6, True), ([32, 64, 64, 32], True), ([16, 16], True),
     ([256, 512, 512, 256], False), ([256, 17, 17, 256], False), ([32] * 10, False),
     ([256] * 10, False), ([16] * 9, True), ([8, 16], False)],
    ids=["defaults", "tool", "one_linear", "width_512", "width_17", "nine_linears_32",
         "nine_linears_256", "eight_linears", "width_8"],
)
def test_kernel_takes_only_the_shapes_it_runs(dims, takes):
    """The model-level predicate of the FFN kernel (``fits_vmem``'s
    counterpart): 1..8 Linears, every width a multiple of 16 in [16, 256]."""
    from gnot_tpu_torch.ops import fused_ffn

    assert fused_ffn.kernel_takes(*_ffn_args(dims)) is takes


@pytest.mark.parametrize("hidden,num_layers", [(512, 2), (17, 2), (32, 8), (256, 4)],
                         ids=["width_512", "width_17", "nine_linears", "defaults"])
def test_gated_ffn_takes_the_torch_path_where_the_kernel_does_not_fit(hidden, num_layers, monkeypatch):
    """``ffn_impl="pallas"`` calls the kernel only where it takes the
    shapes; elsewhere it runs the torch path, as the JAX model does, and
    gives exactly the ``xla`` module's output."""
    calls = []

    def recording(*args, **kw):
        calls.append(1)
        return fused_gated_ffn(*args, **kw)

    from gnot_tpu_torch.ops.fused_ffn import fused_gated_ffn

    monkeypatch.setattr(tl, "fused_gated_ffn", recording)
    gen = torch.Generator().manual_seed(0)
    kernel = tl.GatedExpertFfn(3, num_layers, hidden, 32, in_dim=32, ffn_impl="pallas",
                               gelu="tanh", generator=gen)
    xla = tl.GatedExpertFfn(3, num_layers, hidden, 32, in_dim=32, ffn_impl="xla", gelu="tanh")
    xla.load_state_dict(kernel.state_dict())
    x, scores, _, _ = _ffn_args([32], seed=1)
    with torch.no_grad():
        got, want = kernel(x, scores), xla(x, scores)
    fits = hidden == 256
    assert len(calls) == int(fits)
    if fits:
        torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
    else:
        assert torch.equal(got, want)
