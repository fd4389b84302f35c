"""The flat and the stacked parameter layouts of the port's trainer, and
the command line of the training loop's options: each layout against the
standard one and against the JAX package's run, the flat layout's
alignment, padding and weight versions, the state conversions with the
AdamW moments and the accumulation state, the checkpoint layout
warning, the composition refusals with JAX's messages, the flags parsed
as JAX parses them, and serving from a flat or a stacked checkpoint."""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from gnot_tpu import main as jax_main
from gnot_tpu.config import ModelConfig as JaxModelConfig
from gnot_tpu.config import OptimConfig as JaxOptimConfig
from gnot_tpu.data import datasets as jax_datasets
from gnot_tpu.data.batch import Loader as JaxLoader
from gnot_tpu.models.gnot import GNOT as JaxGNOT
from gnot_tpu.parallel import pipeline as jax_pipeline
from gnot_tpu.train import trainer as jax_trainer
from gnot_tpu.train.checkpoint import Checkpointer as JaxCheckpointer
from gnot_tpu_torch import main as port_main
from gnot_tpu_torch.config import Config, DataConfig, ModelConfig, OptimConfig, TrainConfig
from gnot_tpu_torch.data import datasets
from gnot_tpu_torch.data.batch import Loader, collate
from gnot_tpu_torch.interop import flatten_tree, params_from_jax
from gnot_tpu_torch.models import layers
from gnot_tpu_torch.models.gnot import GNOT, apply_batch
from gnot_tpu_torch.ops import fused_ffn
from gnot_tpu_torch.parallel import pipeline
from gnot_tpu_torch.train.checkpoint import Checkpointer
from gnot_tpu_torch.train.trainer import (
    FLAT_ALIGN,
    Trainer,
    batch_loss,
    convert_flat_state,
    state_layout,
)

RTOL, ATOL = 1e-4, 1e-5  # the model-level bar of the port against JAX
SMALL = dict(n_attn_layers=2, n_attn_hidden_dim=32, n_mlp_num_layers=2, n_mlp_hidden_dim=32,
             n_input_hidden_dim=32, n_expert=2, n_head=4)


def _trainer(samples, mc=None, *, optim=None, train=None, data=None, test=(), **kw):
    cfg = Config(optim=OptimConfig(**(optim or {})), data=DataConfig(**(data or {})),
                 train=TrainConfig(**(train or {})))
    mc = ModelConfig(**(mc or SMALL), **datasets.infer_model_dims(samples))
    return Trainer(cfg, mc, samples, list(test), device="cpu", **kw)


def _darcy(n=8, seed=0):
    return datasets.synth_darcy2d(n, seed=seed, grid_n=8)


def _assert_params_close(got: dict, want: dict, rtol, atol):
    assert list(got) == list(want)
    for name, v in want.items():
        np.testing.assert_allclose(np.asarray(got[name].detach()), np.asarray(v.detach()),
                                   rtol=rtol, atol=atol, err_msg=name)


def _ffn_weights(model) -> list[torch.Tensor]:
    return [t for m in model.modules() if isinstance(m, layers.GatedExpertFfn)
            for l in m.experts.layers() for t in (l.kernel, l.bias)]


# -- the flat layout ---------------------------------------------------------

def test_flat_layout_is_aligned_and_its_padding_stays_zero():
    """Every leaf at a multiple of 4 elements of one buffer (every weight
    16-byte aligned, sharing the buffer's storage, its gradient a view of
    the gradient buffer), and the padding between leaves still exactly 0
    in the weights, gradients and both moments after clipped,
    weight-decayed steps."""
    samples = _darcy()
    t = _trainer(samples, dict(SMALL, ffn_impl="pallas"),
                 optim=dict(flat_params=True, grad_clip_norm=0.1, weight_decay=0.5))
    t.initialize()
    layout = t.flat.layout
    assert all(o % FLAT_ALIGN == 0 for o in layout.offsets)
    assert list(layout.names) == [n for n, _ in GNOT(t.model_cfg).named_parameters()]
    buf, grad = t.flat.param, t.flat.param.grad
    for name, p in t.model.named_parameters():
        assert p.data_ptr() % 16 == 0, name
        assert p.untyped_storage().data_ptr() == buf.untyped_storage().data_ptr(), name
        assert p.grad.untyped_storage().data_ptr() == grad.untyped_storage().data_ptr(), name
    pad = torch.ones(layout.size, dtype=torch.bool)
    for n, s, o in zip(layout.names, layout.shapes, layout.offsets):
        pad[o:o + int(np.prod(s))] = False
    assert pad.sum() > 0  # the 1-wide output bias leaves 3 pad elements at least
    for batch in list(Loader(samples, 4))[:2] * 2:
        t.train_step(batch, 1e-2)
    moments = t.optimizer.state_dict()["state"][0]
    for part in (buf.detach(), grad, moments["exp_avg"], moments["exp_avg_sq"]):
        assert torch.count_nonzero(part[pad]) == 0
    assert torch.count_nonzero(grad[~pad]) > 0


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_flat_update_moves_every_ffn_weight_version(grad_accum):
    """AdamW's write of the flat buffer moves every FFN weight's and bias's
    ``(_version, data_ptr)`` key, so the kernel's images are made again,
    equal to a fresh pack; a micro-step that takes no update moves none."""
    samples = _darcy()
    t = _trainer(samples, dict(SMALL, ffn_impl="pallas"),
                 optim=dict(flat_params=True, grad_accum=grad_accum))
    t.initialize()
    weights = _ffn_weights(t.model)
    assert len(weights) == 2 * 2 * SMALL["n_attn_layers"] * (SMALL["n_mlp_num_layers"] + 1)
    key = lambda w: (w._version, w.data_ptr())  # noqa: E731
    kernels = [w for w in weights if w.dim() == 3]
    batches = list(Loader(samples, 4))
    for micro, batch in enumerate(batches[:grad_accum]):
        before = [key(w) for w in weights]
        images = [fused_ffn.packed_weights(k) for k in kernels]
        t.train_step(batch, 1e-3)
        moved = [key(w) != b for w, b in zip(weights, before)]
        if micro < grad_accum - 1:
            assert not any(moved)
            assert all(fused_ffn.packed_weights(k) is i for k, i in zip(kernels, images))
        else:
            assert all(moved)
            for k, image in zip(kernels, images):
                fresh = fused_ffn.packed_weights(k)
                assert fresh is not image and not torch.equal(fresh, image)
                assert torch.equal(fresh, fused_ffn.pack_weights(k.detach()))


@pytest.mark.parametrize("ffn_impl", ["xla", "pallas"])
def test_flat_steps_match_the_tree_layout(ffn_impl):
    """Three steps on one batch from the same weights: the losses and the
    weights of the flat layout and the tree layout (tests/test_trainer.py:392,
    its bars)."""
    samples = _darcy()
    batch = next(iter(Loader(samples, 4)))
    tree = _trainer(samples, dict(SMALL, ffn_impl=ffn_impl))
    flat = _trainer(samples, dict(SMALL, ffn_impl=ffn_impl), optim=dict(flat_params=True))
    for t in (tree, flat):
        t.initialize()
    for _ in range(3):
        np.testing.assert_allclose(float(flat.train_step(batch, 1e-3)),
                                   float(tree.train_step(batch, 1e-3)), rtol=1e-6)  # graftlint: disable=GL001 — the port's Trainer.train_step donates nothing
    _assert_params_close(flat.standard_params(), tree.standard_params(), 1e-5, 1e-6)


def test_flat_fit_matches_the_tree_layout(capsys):
    """``fit`` end to end with the flat layout: the same epoch losses and
    metrics, final weights and predictions (tests/test_trainer.py:437)."""
    samples, test = _darcy(16), _darcy(8, seed=1)

    def run(flat):
        t = _trainer(samples, dict(SMALL, ffn_impl="pallas"), optim=dict(flat_params=flat),
                     train=dict(epochs=3), test=test)
        best = t.fit()
        capsys.readouterr()
        return t, best

    (tree, b_tree), (flat, b_flat) = run(False), run(True)
    np.testing.assert_allclose(b_flat, b_tree, rtol=1e-5)
    for a, b in zip(flat.history, tree.history):
        np.testing.assert_allclose(a.train_loss, b.train_loss, rtol=1e-5)
        np.testing.assert_allclose(a.test_metric, b.test_metric, rtol=1e-5)
    _assert_params_close(flat.standard_params(), tree.standard_params(), RTOL, ATOL)
    for a, b in zip(flat.predict(test[:3]), tree.predict(test[:3])):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)


def test_flat_run_matches_jax_flat_run():
    """Three steps of JAX's flat layout (``init_flat_state``,
    ``flat_loss_fn``) and of the port's, the port's weights carried from
    JAX's ``[P]`` vector: each loss, then the weights, at the model bar."""
    samples = datasets.synth_elasticity(12, seed=7, base_points=40)
    jax_samples = jax_datasets.synth_elasticity(12, seed=7, base_points=40)
    mc = dict(SMALL, **datasets.infer_model_dims(samples))
    jmodel = JaxGNOT(JaxModelConfig(**mc))
    jbatches = list(JaxLoader(jax_samples, 4, shuffle=True, seed=2))
    state, unravel = jax_trainer.init_flat_state(jmodel, JaxOptimConfig(), jbatches[0], seed=0)
    flat0 = np.array(state.params)
    step = jax_trainer.make_train_step(
        jmodel, JaxOptimConfig(), "rel_l2",
        loss_fn=jax_trainer.flat_loss_fn(jmodel, unravel, "rel_l2"))
    lrs = [1e-3, 8e-4, 5e-4]
    want = []
    for batch, lr in zip(jbatches, lrs):
        state, loss = step(state, batch, np.float32(lr))
        want.append(float(loss))
    want_params = flatten_tree(jax.device_get(unravel(state.params)))

    port = _trainer(samples, optim=dict(flat_params=True))
    port.initialize()
    port.load_standard_params(params_from_jax(flat0, port.model_cfg))
    got = [float(port.train_step(b, lr))
           for b, lr in zip(Loader(samples, 4, shuffle=True, seed=2), lrs)]
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    for name, p in port.standard_params().items():
        np.testing.assert_allclose(p.numpy(), want_params[name], rtol=RTOL, atol=ATOL,
                                   err_msg=name)


def test_flat_grad_accum_matches_the_tree_layout():
    """grad_accum=2 over two windows: the flat layout's losses and weights
    against the tree layout's (tests/test_trainer.py:542)."""
    samples = datasets.synth_ns2d(4, n_points=32, seed=3)
    micros = [collate(samples[:2], bucket=False), collate(samples[2:], bucket=False)]
    tree = _trainer(samples, optim=dict(grad_accum=2))
    flat = _trainer(samples, optim=dict(grad_accum=2, flat_params=True))
    for t in (tree, flat):
        t.initialize()
    for b in micros * 2:
        np.testing.assert_allclose(float(flat.train_step(b, 1e-3)),
                                   float(tree.train_step(b, 1e-3)), rtol=1e-6)  # graftlint: disable=GL001 — the port's Trainer.train_step donates nothing
    assert flat.gradient_step == tree.gradient_step == 2
    _assert_params_close(flat.standard_params(), tree.standard_params(), 1e-5, 1e-6)


def test_convert_flat_state_round_trips_and_training_continues():
    """A flat state after two steps, converted to the tree layout, round
    trips exactly and, loaded into a tree trainer, continues as the
    all-tree run does; a tree state goes the other way
    (tests/test_trainer.py:590)."""
    samples = _darcy()
    batch = next(iter(Loader(samples, 4)))
    tree = _trainer(samples)
    flat = _trainer(samples, optim=dict(flat_params=True))
    for t in (tree, flat):
        t.initialize()
        for _ in range(2):
            t.train_step(batch, 1e-3)
    template = GNOT(tree.model_cfg).state_dict()
    as_tree = convert_flat_state(flat.state_dict(), template, "tree")
    assert state_layout(as_tree) == "standard" and list(as_tree["model"]) == list(template)
    back = convert_flat_state(as_tree, template, "flat")
    got, want = back, flat.state_dict()
    assert torch.equal(got["model"]["flat"], want["model"]["flat"])
    for k in ("exp_avg", "exp_avg_sq", "step"):
        assert torch.equal(got["optimizer"]["state"][0][k], want["optimizer"]["state"][0][k])
    assert convert_flat_state(want, template, "flat") is want  # already flat

    resumed = _trainer(samples)
    resumed.initialize()
    resumed.load_state_dict(as_tree)
    np.testing.assert_allclose(float(resumed.train_step(batch, 1e-3)),  # graftlint: disable=GL001 — the port's Trainer.train_step donates nothing
                               float(tree.train_step(batch, 1e-3)), rtol=1e-6)  # graftlint: disable=GL001 — the port's Trainer.train_step donates nothing
    _assert_params_close(resumed.standard_params(), tree.standard_params(), 1e-5, 1e-6)
    # And a tree state resumes in the flat layout.
    into_flat = _trainer(samples, optim=dict(flat_params=True))
    into_flat.initialize()
    into_flat.load_state_dict(convert_flat_state(tree.state_dict(), template, "flat"))
    _assert_params_close(into_flat.standard_params(), tree.standard_params(), 0, 0)
    with pytest.raises(ValueError, match="standard parameter layout but this trainer holds "
                                         "the flat layout"):
        into_flat.load_state_dict(tree.state_dict())


def test_convert_flat_state_carries_the_accumulation_state():
    """Mid-window (one micro-step of two), the accumulation mean is non-zero
    and crosses layouts with the weights and moments; the round trip is
    exact (tests/test_trainer.py:650)."""
    samples = _darcy()
    flat = _trainer(samples, optim=dict(flat_params=True, grad_accum=2, grad_clip_norm=1.0))
    flat.initialize()
    flat.train_step(next(iter(Loader(samples, 4))), 1e-3)
    state = flat.state_dict()
    assert state["accum"]["mini_step"] == 1 and torch.count_nonzero(state["accum"]["acc"]["flat"])
    template = GNOT(flat.model_cfg).state_dict()
    tree = convert_flat_state(state, template, "tree")
    assert list(tree["accum"]["acc"]) == list(template)
    assert all("flat" not in part for part in (tree["model"], tree["accum"]["acc"]))
    back = convert_flat_state(tree, template, "flat")
    assert torch.equal(back["accum"]["acc"]["flat"], state["accum"]["acc"]["flat"])
    assert torch.equal(back["model"]["flat"], state["model"]["flat"])
    assert back["accum"]["mini_step"] == 1 and back["step"] == 1
    resumed = _trainer(samples, optim=dict(grad_accum=2, grad_clip_norm=1.0))
    resumed.initialize()
    resumed.load_state_dict(tree)
    assert resumed.mini_step == 1


def test_flat_checkpoint_resumes_and_a_layout_mismatch_warns_with_jax_s_text(tmp_path, capsys):
    """A flat run's ``latest`` resumes into a flat run exactly; restoring it
    into a tree run prints the JAX checkpointer's warning word for word,
    then fails, as the JAX restore does (tests/test_trainer.py:499, :520);
    and the other way round."""
    samples, test = _darcy(), _darcy(4, seed=1)
    ck = str(tmp_path / "ck")
    flat_meta = Checkpointer(ck, extra_meta={"flat_params": True})
    t1 = _trainer(samples, optim=dict(flat_params=True), test=test,
                  train=dict(epochs=2, checkpoint_dir=ck, checkpoint_every=1),
                  checkpointer=flat_meta)
    t1.fit()
    t2 = _trainer(samples, optim=dict(flat_params=True), test=test,
                  train=dict(epochs=2, checkpoint_dir=ck, resume=True),
                  checkpointer=Checkpointer(ck, extra_meta={"flat_params": True}))
    t2.initialize()
    assert t2.start_epoch == 2 and torch.equal(t2.flat.param, t1.flat.param)
    capsys.readouterr()

    tree = _trainer(samples)
    tree.initialize()
    state = Checkpointer(ck, extra_meta={"flat_params": False}).restore_latest()[0]
    port_line = capsys.readouterr().out
    JaxCheckpointer(str(tmp_path / "jax"), extra_meta={"flat_params": False})._warn_numerics(
        "latest", {"flat_params": True})
    jax_line = capsys.readouterr().out
    assert port_line == jax_line and "--flat_params" in port_line and "layout" in port_line
    with pytest.raises(Exception):
        tree.load_state_dict(state)
    # A tree checkpoint (no flat_params recorded) restored by a flat run.
    Checkpointer(str(tmp_path / "tree")).save_latest(tree.state_dict(), 1, 0.5)
    state = Checkpointer(str(tmp_path / "tree"), extra_meta={"flat_params": True}).restore_latest()[0]
    port_line = capsys.readouterr().out
    JaxCheckpointer(str(tmp_path / "jax"), extra_meta={"flat_params": True})._warn_numerics(
        "latest", {})
    assert port_line == capsys.readouterr().out and "drop --flat_params" in port_line
    with pytest.raises(ValueError):
        t2.load_state_dict(state)


# -- the stacked layout --------------------------------------------------------

@pytest.mark.parametrize("mode", ["masked", "parity"])
def test_stacked_forward_matches_standard_and_jax(mode):
    """The stacked forward (one block module per layer on slice i of the
    stacked weights) against the standard forward of the same weights on
    a ragged batch (tests/test_pipeline.py:257, its bar), and against JAX's
    ``stacked_forward`` of the same weights at the model bar."""
    samples = datasets.synth_elasticity(4, seed=0, base_points=48)
    jax_samples = jax_datasets.synth_elasticity(4, seed=0, base_points=48)
    mc = dict(SMALL, n_attn_layers=3, attention_mode=mode, **datasets.infer_model_dims(samples))
    jmodel = JaxGNOT(JaxModelConfig(**mc))
    jbatch = next(iter(JaxLoader(jax_samples, 4)))
    params = jax.device_get(jax_trainer.init_params(jmodel, jbatch, 0))
    stacked_tree = jax_pipeline.stack_params(params, 3)
    want = np.asarray(jax.jit(lambda p, b: jax_pipeline.stacked_forward(
        JaxModelConfig(**mc), p, b))(stacked_tree, jbatch))

    cfg = ModelConfig(**mc)
    standard = GNOT(cfg)
    standard.load_state_dict(params_from_jax(params, cfg))
    stacked = pipeline.StackedGNOT(cfg)
    stacked.load_state_dict(pipeline.stack_params(standard.state_dict(), 3))
    batch = next(iter(Loader(samples, 4)))
    with torch.no_grad():
        out_std = apply_batch(standard, batch).numpy()
        out = apply_batch(stacked, batch).numpy()
    np.testing.assert_allclose(out, out_std, rtol=2e-5, atol=2e-6)
    np.testing.assert_allclose(out, want, rtol=RTOL, atol=ATOL)


def test_stacked_remat_gradients_equal_the_plain_ones():
    """With remat each stacked layer is checkpointed: the same loss and
    gradients as without it, and as the standard layout with remat."""
    samples = datasets.synth_elasticity(4, seed=1, base_points=40)
    cfg = ModelConfig(**SMALL, **datasets.infer_model_dims(samples))
    batch = next(iter(Loader(samples, 4)))
    gen = lambda: torch.Generator().manual_seed(0)  # noqa: E731
    models = {"stacked": pipeline.StackedGNOT(cfg, generator=gen()),
              "stacked_remat": pipeline.StackedGNOT(dataclasses.replace(cfg, remat=True),
                                                    generator=gen()),
              "standard_remat": GNOT(dataclasses.replace(cfg, remat=True), generator=gen())}
    grads = {}
    for name, m in models.items():
        loss = batch_loss(m, batch, "rel_l2")
        loss.backward()
        g = {n: p.grad.clone() for n, p in m.named_parameters()}
        grads[name] = g if name != "standard_remat" else pipeline.stack_params(
            g, cfg.n_attn_layers)
    for name in ("stacked_remat", "standard_remat"):
        _assert_params_close(grads[name], grads["stacked"], 1e-6, 1e-9)


@pytest.mark.parametrize("remat", [False, True])
def test_fit_with_scan_layers_matches_the_standard_run(remat, capsys):
    """``fit`` in the stacked layout against the standard run from the same
    seed: epoch losses and metrics (tests/test_pipeline.py:284, its bar),
    its checkpoint in the stacked layout, and predictions through the
    unstacked weights."""
    samples = datasets.synth_ns2d(8, n_points=64)
    test = datasets.synth_ns2d(4, seed=1, n_points=64)

    def run(scan):
        t = _trainer(samples, dict(SMALL, scan_layers=scan, remat=remat),
                     train=dict(epochs=2), test=test)
        t.fit()
        capsys.readouterr()
        return t

    std, scan = run(False), run(True)
    for a, b in zip(scan.history, std.history):
        np.testing.assert_allclose(a.step_losses, b.step_losses, rtol=1e-5)
        np.testing.assert_allclose(a.test_metric, b.test_metric, rtol=1e-5)
    state = scan.state_dict()
    assert state_layout(state) == "stacked"
    assert state["model"]["blocks.ffn1.experts.dense_0.kernel"].shape[0] == 2
    _assert_params_close(scan.standard_params(), std.standard_params(), RTOL, ATOL)
    for a, b in zip(scan.predict(samples[:2]), std.predict(samples[:2])):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)


def test_stack_unstack_and_convert_state_layout_round_trip():
    """``stack_params``/``unstack_params`` invert each other;
    ``convert_state_layout`` carries the weights, both moments and the
    accumulation mean into the stacked layout and back exactly, and the
    converted state trains on as the standard run does."""
    samples = _darcy()
    batch = next(iter(Loader(samples, 4)))
    std = _trainer(samples, optim=dict(grad_accum=3))
    std.initialize()
    for _ in range(4):  # one update, then one micro-step into the next window
        std.train_step(batch, 1e-3)
    state = std.state_dict()
    n = std.model_cfg.n_attn_layers
    stacked = pipeline.convert_state_layout(state, n, "stacked")
    assert state_layout(stacked) == "stacked"
    assert pipeline.convert_state_layout(stacked, n, "stacked") is stacked
    back = pipeline.convert_state_layout(stacked, n, "standard")
    for part in ("model",):
        _assert_params_close(back[part], state[part], 0, 0)
    _assert_params_close(back["accum"]["acc"], state["accum"]["acc"], 0, 0)
    for i, s in state["optimizer"]["state"].items():
        for k, v in s.items():
            assert torch.equal(back["optimizer"]["state"][i][k], v), (i, k)
    assert list(pipeline.unstack_params(pipeline.stack_params(state["model"], n), n)) == list(
        state["model"])

    scan = _trainer(samples, dict(SMALL, scan_layers=True), optim=dict(grad_accum=3))
    scan.initialize()
    scan.load_state_dict(stacked)
    assert (scan.mini_step, scan.host_step) == (1, 4)
    for _ in range(2):
        np.testing.assert_allclose(float(scan.train_step(batch, 1e-3)),  # graftlint: disable=GL001 — the port's Trainer.train_step donates nothing
                                   float(std.train_step(batch, 1e-3)), rtol=1e-6)  # graftlint: disable=GL001 — the port's Trainer.train_step donates nothing
    _assert_params_close(scan.standard_params(), std.standard_params(), 1e-5, 1e-6)
    with pytest.raises(ValueError, match="stacked parameter layout"):
        std.load_state_dict(scan.state_dict())


def test_params_from_jax_takes_the_stacked_tree_and_the_flat_vector():
    """JAX's standard tree, its stacked tree and its ``ravel_pytree`` vector
    (with the tree as template, and rebuilt from the config) carry the same
    weights into the port."""
    samples = datasets.synth_elasticity(4, seed=0, base_points=40)
    jax_samples = jax_datasets.synth_elasticity(4, seed=0, base_points=40)
    mc = dict(SMALL, n_attn_layers=3, **datasets.infer_model_dims(samples))
    params = jax.device_get(jax_trainer.init_params(
        JaxGNOT(JaxModelConfig(**mc)), next(iter(JaxLoader(jax_samples, 4))), 0))
    cfg = ModelConfig(**mc)
    want = params_from_jax(params, cfg)
    flat, _ = ravel_pytree(params)
    for got in (params_from_jax(jax_pipeline.stack_params(params, 3), cfg),
                params_from_jax(np.asarray(flat), cfg),
                params_from_jax(np.asarray(flat), cfg, template=params)):
        assert list(got) == list(want)
        assert all(torch.equal(got[k], v) for k, v in want.items())
    with pytest.raises(ValueError, match="flat JAX param vector"):
        params_from_jax(np.asarray(flat)[:-1], cfg)


# -- refusals and the command line ------------------------------------------

TINY = ["--synthetic", "darcy2d", "--synth_size", "8", "--n_train", "8", "--n_test", "4",
        "--epochs", "1", "--n_attn_layers", "2", "--n_attn_hidden_dim", "32",
        "--n_mlp_num_layers", "1", "--n_mlp_hidden_dim", "32", "--n_input_hidden_dim", "32",
        "--n_expert", "2", "--n_head", "4"]


@pytest.mark.parametrize(
    "flags",
    [["--packed", "--scan_layers"], ["--packed", "--flat_params"],
     ["--flat_params", "--scan_layers"], ["--packed", "--attention_mode", "parity"],
     ["--packed", "--flat_params", "--scan_layers"]],
    ids=["packed_scan", "packed_flat", "flat_scan", "packed_parity", "packed_flat_scan"],
)
def test_composition_refusals_have_jax_s_messages(flags):
    argv = TINY + ["--synthetic", "elasticity", "--synth_size", "40"] + flags
    jargs = jax_main.build_parser().parse_args(argv)
    jcfg = jax_main.config_from_args(jargs)
    jtrain, jtest = jax_datasets.load(jcfg.data)
    with pytest.raises(ValueError) as jax_err:
        jax_trainer.Trainer(jcfg, jax_main.model_config(jcfg, jargs, jtrain), jtrain, jtest)
    with pytest.raises(ValueError) as port_err:
        port_main.main(argv + ["--device", "cpu"])
    assert str(port_err.value) == str(jax_err.value)


@pytest.mark.parametrize(
    "flags",
    [[], ["--grad_accum", "3"], ["--steps_per_dispatch", "4"], ["--flat_params"],
     ["--scan_layers"], ["--grad_accum", "2", "--steps_per_dispatch", "2", "--flat_params"],
     ["--scan_layers", "--grad_accum", "2", "--steps_per_dispatch", "3", "--remat"]],
    ids=["defaults", "grad_accum", "steps_per_dispatch", "flat_params", "scan_layers",
         "flat_accum_dispatch", "scan_accum_dispatch"],
)
def test_flags_parse_to_jax_s_config_fields(flags):
    argv = TINY + flags
    jargs = jax_main.build_parser().parse_args(argv)
    jcfg = jax_main.config_from_args(jargs)
    args = port_main.build_parser().parse_args(argv)
    cfg = port_main.train_config(args)
    samples = _darcy(2)
    jmc, mc = jax_main.model_config(jcfg, jargs, samples), port_main.model_config(args, samples)
    assert (cfg.optim.grad_accum, cfg.optim.flat_params, cfg.train.steps_per_dispatch,
            mc.scan_layers, mc.remat) == (
        jcfg.optim.grad_accum, jcfg.optim.flat_params, jcfg.train.steps_per_dispatch,
        jmc.scan_layers, jmc.remat)
    for name in ("grad_accum", "flat_params"):
        assert getattr(cfg.optim, name) == getattr(jcfg.optim, name)


@pytest.mark.parametrize(
    "flags",
    [["--grad_accum", "2"], ["--steps_per_dispatch", "2"], ["--flat_params"],
     ["--scan_layers", "--ffn_impl", "xla"],
     ["--flat_params", "--grad_accum", "2", "--steps_per_dispatch", "2"],
     ["--scan_layers", "--ffn_impl", "xla", "--grad_accum", "3", "--steps_per_dispatch", "2",
      "--remat"],
     ["--packed", "--synthetic", "elasticity", "--synth_size", "40", "--grad_accum", "2",
      "--steps_per_dispatch", "2"]],
    ids=["grad_accum", "steps_per_dispatch", "flat_params", "scan_layers",
         "flat_accum_dispatch", "scan_accum_dispatch_remat", "packed_accum_dispatch"],
)
def test_cli_trains_with_each_option_the_jax_package_accepts(flags, capsys):
    best = port_main.main(["--device", "cpu", "--ffn_impl", "pallas"] + TINY + flags)
    out = capsys.readouterr().out
    assert np.isfinite(best) and out.rstrip().endswith(f"Best Test Metric: {best}")


@pytest.mark.parametrize("layout", ["flat", "stacked"])
def test_serving_a_flat_or_stacked_checkpoint_answers_as_the_tree_checkpoint(
        layout, tmp_path, capsys):
    """``--serve`` from a ``--flat_params`` or ``--scan_layers`` run's
    checkpoint returns exactly what it returns from a tree checkpoint of
    the same weights; without the layout flag it refuses."""
    flag = ["--flat_params"] if layout == "flat" else ["--scan_layers"]
    base = ["--device", "cpu", "--ffn_impl", "xla"] + TINY
    ck, tree_ck = tmp_path / "ck", tmp_path / "tree"
    trainer = port_main.run_train(port_main.build_parser().parse_args(
        base + flag + ["--checkpoint_dir", str(ck)]))
    state, epoch, best = Checkpointer(str(ck)).restore_best()
    assert state_layout(state) == layout
    template = GNOT(trainer.model_cfg).state_dict()
    tree_state = (convert_flat_state(state, template, "tree") if layout == "flat"
                  else pipeline.convert_state_layout(state, trainer.model_cfg.n_attn_layers,
                                                     "standard"))
    Checkpointer(str(tree_ck)).save_best(tree_state, epoch, best)
    capsys.readouterr()
    served = port_main.run_serve(port_main.build_parser().parse_args(
        base + flag + ["--serve", "--checkpoint_dir", str(ck)]))
    want = port_main.run_serve(port_main.build_parser().parse_args(
        base + ["--serve", "--checkpoint_dir", str(tree_ck)]))
    assert served.summary["restored"] == want.summary["restored"] == "best"
    assert len(served.results) == len(want.results) == 4
    for a, b in zip(served.results, want.results):
        assert a.ok and b.ok
        np.testing.assert_array_equal(a.output, b.output)
    with pytest.raises(ValueError, match=f"holds the {layout} parameter layout"):
        port_main.run_serve(port_main.build_parser().parse_args(
            base + ["--serve", "--checkpoint_dir", str(ck)]))
    json.dumps(served.summary)
