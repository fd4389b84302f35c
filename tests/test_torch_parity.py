"""Parity mode (``attention_mode="parity"``): the reference's numerics in
the port against the JAX package's parity-mode model, weights carried
across with ``params_from_jax``.

Parity mode drops the masks before the forward, so padded rows pollute
the attention sums, and merges heads by the reference's interleave
(``x.reshape(b, l, h*d)`` of the permuted ``[B, H, L, D]`` tensor). Each
case runs a ragged batch, where both effects show, and holds the port to
the model-level bar (tests/test_pallas_ffn.py:80-115); a masked-mode
model of the same weights is the control that must differ.
"""

import jax
import numpy as np
import pytest
import torch

from gnot_tpu.config import ModelConfig as JaxModelConfig
from gnot_tpu.config import OptimConfig as JaxOptimConfig
from gnot_tpu.data import datasets as jax_datasets
from gnot_tpu.data.batch import Loader as JaxLoader
from gnot_tpu.data.batch import collate as jax_collate
from gnot_tpu.models.gnot import GNOT as JaxGNOT
from gnot_tpu.models.layers import LinearAttention as JaxLinearAttention
from gnot_tpu.train import trainer as jax_trainer
from gnot_tpu_torch import main as port_main
from gnot_tpu_torch.config import Config, DataConfig, ModelConfig, TrainConfig
from gnot_tpu_torch.data import datasets
from gnot_tpu_torch.data.batch import Loader, collate
from gnot_tpu_torch.device import resolve_device
from gnot_tpu_torch.interop import flatten_tree, params_from_jax
from gnot_tpu_torch.models.gnot import GNOT, apply_batch
from gnot_tpu_torch.models.layers import LinearAttention
from gnot_tpu_torch.train.trainer import Trainer

RTOL, ATOL = 1e-4, 1e-5  # the model-level bar

SMALL = dict(
    n_attn_layers=2,
    n_attn_hidden_dim=32,
    n_mlp_num_layers=2,
    n_mlp_hidden_dim=32,
    n_input_hidden_dim=32,
    n_expert=2,
    n_head=4,
)


def _attention_state(params):
    """A JAX LinearAttention param tree as the port module's state_dict."""
    return {k: torch.from_numpy(np.asarray(v)) for k, v in flatten_tree(params).items()}


@pytest.mark.parametrize("n_funcs", [0, 2], ids=["self", "cross"])
def test_linear_attention_parity_merge_matches_jax(n_funcs):
    """The interleaved head merge of ``LinearAttention(parity=True)``
    against JAX's on a ragged-length input, self and cross; the
    transpose merge of masked mode (same weights) is the control."""
    rng = np.random.default_rng(4)
    b, lq, lf, d_in, e, h = 3, 21, 13, 8, 16, 4
    query = rng.standard_normal((b, lq, d_in)).astype(np.float32)
    funcs = rng.standard_normal((n_funcs, b, lf, d_in)).astype(np.float32) if n_funcs else None
    jmod = JaxLinearAttention(e, h, n_funcs, parity=True)
    params = jax.device_get(jmod.init(jax.random.key(1), query, funcs)["params"])
    want = np.asarray(jmod.apply({"params": params}, query, funcs))
    got = {}
    for parity in (True, False):
        port = LinearAttention(e, h, n_funcs, query_dim=d_in, func_dim=d_in, parity=parity)
        port.load_state_dict(_attention_state(params), strict=True)
        with torch.no_grad():
            got[parity] = port(
                torch.from_numpy(query), None if funcs is None else torch.from_numpy(funcs)
            ).numpy()
    np.testing.assert_allclose(got[True], want, rtol=RTOL, atol=ATOL)
    assert np.max(np.abs(got[False] - want)) > 1e-2  # the merge ran


def _ragged_samples():
    """Elasticity meshes of 28 to 52 points: every row but the longest is
    padded, so the unmasked pad rows pollute the shared Grams."""
    return datasets.synth_elasticity(4, seed=3, base_points=40)


def _jax_parity_model(samples, **kw):
    mc = dict(SMALL, **datasets.infer_model_dims(samples), attention_mode="parity", **kw)
    jb = jax_collate(samples, bucket=False)
    jmodel = JaxGNOT(JaxModelConfig(**mc))
    params = jmodel.init(
        jax.random.key(0), jb.coords, jb.theta, jb.funcs,
        node_mask=jb.node_mask, func_mask=jb.func_mask,
    )["params"]
    return mc, jmodel, jax.device_get(params)


def _port(mc, params) -> GNOT:
    cfg = ModelConfig(**mc)
    port = GNOT(cfg)
    port.load_state_dict(params_from_jax(params, cfg), strict=True)
    return port.eval()


@pytest.mark.parametrize("ffn_impl", ["xla", "pallas"])
def test_parity_gnot_matches_jax_on_a_ragged_batch(ffn_impl):
    """The parity forward against JAX's on a ragged batch, masks passed
    and ignored (tests/test_model.py:120,218): the same output with and
    without the masks, JAX's within the model-level bar, the padded
    samples polluted against their solo forwards, and a masked model of
    the same weights outside the bar on every padded sample."""
    samples = _ragged_samples()
    lengths = [s.coords.shape[0] for s in samples]
    assert len(set(lengths)) == len(lengths)  # ragged
    mc, jmodel, params = _jax_parity_model(samples, ffn_impl=ffn_impl)
    jb = jax_collate(samples, bucket=False)
    want = np.asarray(jmodel.apply(
        {"params": params}, jb.coords, jb.theta, jb.funcs,
        node_mask=jb.node_mask, func_mask=jb.func_mask,
    ))
    port = _port(mc, params)
    assert port.config.gelu == "erf"
    batch = collate(samples, bucket=False)
    with torch.no_grad():
        got = apply_batch(port, batch).numpy()
        unmasked = port(batch.coords, batch.theta, batch.funcs).numpy()
        masked = apply_batch(_port(dict(mc, attention_mode="masked"), params), batch).numpy()
        solo = [apply_batch(port, collate([s], bucket=False)).numpy()[0] for s in samples]
    np.testing.assert_array_equal(got, unmasked)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    # The padding pollutes: a padded sample's rows differ from its solo
    # forward, the longest's do not. The control: on every padded sample
    # the masked model's rows lie outside the bar the parity model meets.
    for i, n in enumerate(lengths):
        if n == max(lengths):
            np.testing.assert_allclose(got[i, :n], solo[i], rtol=RTOL, atol=ATOL)
        else:
            assert not np.allclose(got[i, :n], solo[i], rtol=RTOL, atol=ATOL), i
            assert not np.allclose(masked[i, :n], got[i, :n], rtol=RTOL, atol=ATOL), i


def test_params_from_jax_carries_a_parity_tree():
    """The parameter tree is the same in every mode: a parity-mode JAX
    tree lands on every parameter of a parity-mode port model."""
    samples = _ragged_samples()
    mc, _, params = _jax_parity_model(samples)
    cfg = ModelConfig(**mc)
    state = params_from_jax(params, cfg)
    assert set(state) == set(GNOT(cfg).state_dict()) == set(flatten_tree(params))


@pytest.mark.parametrize("ffn_impl", ["xla", "pallas"])
def test_three_parity_train_steps_match_jax(ffn_impl):
    """Three AdamW steps of the parity model on ragged batches padded to
    the per-batch max (parity turns bucketing off): each step's loss, the
    step-1 gradients and every parameter after step 3 at the model-level
    bar. The loss stays masked: the reference unpads before pooling."""
    samples = datasets.synth_elasticity(12, seed=7, base_points=70)
    jax_samples = jax_datasets.synth_elasticity(12, seed=7, base_points=70)
    mc = dict(SMALL, **datasets.infer_model_dims(samples), ffn_impl=ffn_impl,
              attention_mode="parity")
    jbatches = list(JaxLoader(jax_samples, 4, shuffle=True, seed=2, bucket=False))
    lrs = [1e-3, 8e-4, 5e-4]
    jmodel = JaxGNOT(JaxModelConfig(**mc))
    state = jax_trainer.init_state(jmodel, JaxOptimConfig(), jbatches[0], seed=0)
    params0 = jax.tree.map(np.array, jax.device_get(state.params))
    grads1 = flatten_tree(jax.device_get(jax.grad(
        lambda p: jax_trainer.batch_loss(jmodel, p, jbatches[0], "rel_l2"))(state.params)))
    step = jax_trainer.make_train_step(jmodel, JaxOptimConfig(), "rel_l2")
    want_losses = []
    for batch, lr in zip(jbatches, lrs):
        state, loss = step(state, batch, np.float32(lr))
        want_losses.append(float(loss))
    want_params = flatten_tree(jax.device_get(state.params))

    cfg = Config(data=DataConfig(n_train=12, bucket=False), train=TrainConfig(epochs=1))
    port = Trainer(cfg, ModelConfig(**mc), samples, [], device="cpu")
    port.initialize()
    port.model.load_state_dict(params_from_jax(params0, port.model_cfg), strict=True)
    got_losses = []
    loader = Loader(samples, 4, shuffle=True, seed=2, bucket=False)
    for i, (batch, lr) in enumerate(zip(loader, lrs)):
        got_losses.append(float(port.train_step(batch, lr)))
        if i == 0:
            for name, p in port.model.named_parameters():
                np.testing.assert_allclose(p.grad.numpy(), grads1[name], rtol=RTOL, atol=ATOL,
                                           err_msg=f"step-1 gradient {name}")
    np.testing.assert_allclose(got_losses, want_losses, rtol=RTOL, atol=ATOL)
    for name, p in port.model.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want_params[name], rtol=RTOL, atol=ATOL,
                                   err_msg=f"parameter {name} after step 3")


def test_cli_parity_mode_turns_bucketing_off_and_trains(capsys):
    """``--attention_mode parity`` reaches the model (erf GELU) and pads
    batches to the per-batch max as ``gnot_tpu/main.py:576`` does, and a
    run prints the reference's lines."""
    argv = ["--device", "cpu", "--synthetic", "darcy2d", "--synth_size", "8", "--n_train", "8",
            "--n_test", "4", "--epochs", "1", "--attention_mode", "parity",
            "--n_attn_layers", "1", "--n_attn_hidden_dim", "32", "--n_mlp_num_layers", "1",
            "--n_mlp_hidden_dim", "32", "--n_input_hidden_dim", "32", "--n_head", "4",
            "--ffn_impl", "pallas"]
    args = port_main.build_parser().parse_args(argv)
    assert not port_main.data_config(args).bucket
    trainer = port_main.run_train(args)
    assert trainer.model_cfg.attention_mode == "parity" and trainer.model_cfg.gelu == "erf"
    assert not trainer.train_loader.bucket and not trainer.test_loader.bucket
    assert np.isfinite(trainer.best_metric)
    out = capsys.readouterr().out
    assert "Epoch 0, Loss: " in out and "Best Test Metric: " in out
    masked = port_main.build_parser().parse_args([])
    assert masked.attention_mode == "masked" and port_main.data_config(masked).bucket


def test_parity_forward_leaves_tf32_off(monkeypatch):
    """JAX pins full-f32 contractions for parity (``precision_scope``);
    on the card that is cuBLAS with TF32 off, which ``resolve_device``
    sets for every entry point. A parity forward leaves it off."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", torch.backends.cudnn.allow_tf32)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    resolve_device("cuda")
    assert torch.backends.cuda.matmul.allow_tf32 is False
    samples = _ragged_samples()
    mc, _, params = _jax_parity_model(samples)
    with torch.no_grad():
        apply_batch(_port(mc, params), collate(samples, bucket=False))
    assert torch.backends.cuda.matmul.allow_tf32 is False
