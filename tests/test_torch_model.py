"""The port's whole GNOT against the JAX GNOT, weights carried across
with ``params_from_jax``."""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

from gnot_tpu.config import ModelConfig as JaxModelConfig
from gnot_tpu.data import datasets
from gnot_tpu.data.batch import collate as jax_collate
from gnot_tpu.models.gnot import GNOT as JaxGNOT
from gnot_tpu_torch.config import ModelConfig
from gnot_tpu_torch.data.batch import PackedLoader, collate
from gnot_tpu_torch.interop import flatten_tree, params_from_jax
from gnot_tpu_torch.models.gnot import GNOT, apply_batch

RTOL, ATOL = 1e-4, 1e-5  # tests/test_pallas_ffn.py's model-level bar

SMALL = dict(
    n_attn_layers=2,
    n_attn_hidden_dim=32,
    n_mlp_num_layers=2,
    n_mlp_hidden_dim=32,
    n_input_hidden_dim=32,
    n_expert=2,
    n_head=4,
)


def _samples(name):
    if name == "elasticity":
        return datasets.synth_elasticity(4, seed=3, base_points=40)
    return datasets.synth_inductor2d(3, seed=4, base_points=40)


def _jax_model(samples, **kw):
    """JAX GNOT + its params for ``samples``' dims."""
    mc = dict(SMALL, **datasets.infer_model_dims(samples), **kw)
    batch = jax_collate(samples)
    model = JaxGNOT(JaxModelConfig(**mc))
    params = model.init(
        jax.random.key(0), batch.coords, batch.theta, batch.funcs,
        node_mask=batch.node_mask, func_mask=batch.func_mask,
    )["params"]
    return mc, model, jax.device_get(params)


def _port_model(mc, params) -> GNOT:
    cfg = ModelConfig(**mc)
    port = GNOT(cfg)
    port.load_state_dict(params_from_jax(params, cfg), strict=True)
    return port.eval()


@pytest.mark.parametrize("ffn_impl", ["xla", "pallas"])
@pytest.mark.parametrize("name", ["elasticity", "inductor2d"])
def test_gnot_matches_jax(name, ffn_impl):
    samples = _samples(name)
    mc, jmodel, params = _jax_model(samples, ffn_impl=ffn_impl)
    jb = jax_collate(samples)
    want = np.asarray(
        jmodel.apply(
            {"params": params}, jb.coords, jb.theta, jb.funcs,
            node_mask=jb.node_mask, func_mask=jb.func_mask,
        )
    )
    port = _port_model(mc, params)
    with torch.inference_mode():
        got = apply_batch(port, collate(samples)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_port_ffn_impls_agree():
    """The port's pallas path (the kernel's plain version on the CPU)
    against its xla path, from the same weights."""
    samples = _samples("inductor2d")
    mc, _, params = _jax_model(samples)
    xla = _port_model(dict(mc, ffn_impl="xla"), params)
    pallas = _port_model(dict(mc, ffn_impl="pallas"), params)
    batch = collate(samples)
    with torch.inference_mode():
        np.testing.assert_allclose(
            apply_batch(pallas, batch).numpy(), apply_batch(xla, batch).numpy(),
            rtol=RTOL, atol=ATOL,
        )


@pytest.mark.parametrize("ffn_impl", ["xla", "pallas"])
def test_masked_pad_invariance(ffn_impl):
    """Outputs at real rows must not change when the pad length changes
    (tests/test_model.py:76)."""
    samples = _samples("elasticity")
    mc = dict(SMALL, **datasets.infer_model_dims(samples), ffn_impl=ffn_impl)
    port = GNOT(ModelConfig(**mc), generator=torch.Generator().manual_seed(0)).eval()
    short = collate(samples, bucket=False)
    long = collate(samples, pad_nodes=short.coords.shape[1] + 37, pad_funcs=short.funcs.shape[2] + 21)
    # Garbage, not zeros, in the pad rows: the masks alone must hide them.
    rng = np.random.default_rng(9)
    pad_nodes = long.node_mask == 0
    long.coords[pad_nodes] = torch.from_numpy(
        rng.normal(size=(int(pad_nodes.sum()), long.coords.shape[-1])).astype(np.float32)
    )
    pad_funcs = long.func_mask == 0
    long.funcs[pad_funcs] = torch.from_numpy(
        rng.normal(size=(int(pad_funcs.sum()), long.funcs.shape[-1])).astype(np.float32)
    )
    with torch.inference_mode():
        a = apply_batch(port, short).numpy()
        b = apply_batch(port, long).numpy()
    for i, s in enumerate(samples):
        n = s.coords.shape[0]
        np.testing.assert_allclose(b[i, :n], a[i, :n], rtol=RTOL, atol=ATOL)


def test_params_from_jax_every_leaf_lands_both_ways():
    samples = _samples("inductor2d")
    mc, _, params = _jax_model(samples)
    cfg = ModelConfig(**mc)
    state = params_from_jax(params, cfg)
    port_keys = set(GNOT(cfg).state_dict())
    assert set(state) == port_keys == set(flatten_tree(params))
    # Expert weights stay stacked [E, in, out]: no transpose, no copy layout change.
    k = params["block_0"]["ffn1"]["experts"]["dense_0"]["kernel"]
    assert state["block_0.ffn1.experts.dense_0.kernel"].numpy().tobytes() == np.asarray(k).tobytes()

    extra = dict(params, stray={"kernel": np.zeros((2, 2), np.float32)})
    with pytest.raises(ValueError, match="stray.kernel"):
        params_from_jax(extra, cfg)
    missing = {k: v for k, v in params.items() if k != "out_mlp"}
    with pytest.raises(ValueError, match="out_mlp.dense_0.kernel"):
        params_from_jax(missing, cfg)
    wrong = dataclasses.replace(cfg, n_expert=3)
    with pytest.raises(ValueError):
        params_from_jax(params, wrong)


def _loss_and_grads(model, batch) -> tuple[float, dict[str, np.ndarray]]:
    """sum(out^2) over real rows and its gradients, as numpy."""
    model.zero_grad(set_to_none=True)
    out = apply_batch(model, batch)
    loss = torch.sum(out**2 * batch.node_mask[..., None])
    loss.backward()
    return float(loss), {n: p.grad.numpy().copy() for n, p in model.named_parameters()}


@pytest.mark.parametrize("ffn_impl", ["xla", "pallas"])
def test_remat_gradients_equal_no_remat_and_jax_remat(ffn_impl, monkeypatch):
    """``remat=True`` (``torch.utils.checkpoint`` around each block, as
    ``nn.remat(HNABlock)``) changes what the backward keeps, not what it
    computes: the loss and gradients of the same weights without remat
    (rtol 1e-6), and the JAX ``remat=True`` model's (the model-level
    bar). Each block's two FFNs run once more in the recompute: 4 FFN
    forwards without remat and 8 with it over 2 blocks, and the backward
    recomputes each FFN through the plain version in both (4 more)."""
    from gnot_tpu_torch.ops import fused_ffn

    samples = _samples("elasticity")
    mc, jmodel, params = _jax_model(samples, ffn_impl=ffn_impl, remat=True)
    assert jmodel.config.remat
    jb = jax_collate(samples)

    def jax_loss(p):
        out = jmodel.apply({"params": p}, jb.coords, jb.theta, jb.funcs,
                           node_mask=jb.node_mask, func_mask=jb.func_mask)
        return jax.numpy.sum(out**2 * jb.node_mask[..., None])

    want_loss, want_grads = jax.value_and_grad(jax_loss)(params)
    want_grads = flatten_tree(jax.device_get(want_grads))
    calls = []
    plain = fused_ffn.fused_gated_ffn_reference
    monkeypatch.setattr(fused_ffn, "fused_gated_ffn_reference",
                        lambda *a, **k: calls.append(1) or plain(*a, **k))
    batch = collate(samples)
    runs = {}
    for remat in (False, True):
        calls.clear()
        runs[remat] = _loss_and_grads(_port_model(dict(mc, remat=remat), params), batch)
        if ffn_impl == "pallas":
            assert len(calls) == 2 * SMALL["n_attn_layers"] * (3 if remat else 2)
    (loss, grads), (loss_r, grads_r) = runs[False], runs[True]
    np.testing.assert_allclose(loss_r, loss, rtol=1e-6)
    np.testing.assert_allclose(loss_r, float(want_loss), rtol=RTOL, atol=ATOL)
    for name, g in grads_r.items():
        np.testing.assert_allclose(g, grads[name], rtol=1e-6, atol=1e-12, err_msg=name)
        np.testing.assert_allclose(g, want_grads[name], rtol=RTOL, atol=ATOL, err_msg=name)


@pytest.mark.parametrize("kwargs", [dict(attention_mode="parity", packed=True)])
def test_gnot_refuses_unported_modes(kwargs):
    """The packed layout in parity mode has no equivalent in either
    package (tests/test_model.py:507)."""
    kwargs = dict(kwargs)
    packed = kwargs.pop("packed", False)
    samples = _samples("elasticity")
    with pytest.raises(ValueError, match="not ported|masked mode"):
        model = GNOT(ModelConfig(**SMALL, **datasets.infer_model_dims(samples), **kwargs))
        if packed:
            apply_batch(model, PackedLoader(samples, batch_size=4, chunk=16).probe_batch())
