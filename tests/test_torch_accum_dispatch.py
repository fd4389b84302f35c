"""Gradient accumulation and K steps per dispatch in the port's trainer,
against the JAX package's ``optax.MultiSteps`` trainer and against the
port's own single steps: the accumulation's weights, AdamW moments and
counts, its learning-rate schedule, its warning, a resume in the middle
of a window, the dispatch grouping, and K-step groups bitwise equal to K
single steps."""

import dataclasses
import logging

import jax
import numpy as np
import optax
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

from gnot_tpu import make_config
from gnot_tpu.config import ModelConfig as JaxModelConfig
from gnot_tpu.config import OptimConfig as JaxOptimConfig
from gnot_tpu.data import datasets as jax_datasets
from gnot_tpu.data.batch import Loader as JaxLoader
from gnot_tpu.models.gnot import GNOT as JaxGNOT
from gnot_tpu.train import trainer as jax_trainer
from gnot_tpu.train.schedule import make_lr_fn as jax_make_lr_fn
from gnot_tpu_torch.config import Config, DataConfig, ModelConfig, OptimConfig, TrainConfig
from gnot_tpu_torch.data import datasets
from gnot_tpu_torch.data.batch import Loader, collate
from gnot_tpu_torch.interop import flatten_tree, params_from_jax
from gnot_tpu_torch.models import layers
from gnot_tpu_torch.ops import fused_ffn
from gnot_tpu_torch.train.checkpoint import Checkpointer
from gnot_tpu_torch.train.schedule import make_lr_fn
from gnot_tpu_torch.train.trainer import Trainer, group_batches, stack_batches

RTOL, ATOL = 1e-4, 1e-5  # the model-level bar of the port against JAX

# tests/test_trainer.py's accumulation model.
MICRO = dict(n_attn_layers=1, n_attn_hidden_dim=16, n_mlp_num_layers=1, n_mlp_hidden_dim=16,
             n_input_hidden_dim=16, n_expert=2, n_head=2)
SMALL = dict(n_attn_layers=2, n_attn_hidden_dim=32, n_mlp_num_layers=2, n_mlp_hidden_dim=32,
             n_input_hidden_dim=32, n_expert=2, n_head=4)


def _trainer(samples, mc: dict, *, optim=None, train=None, data=None, test=()):
    cfg = Config(optim=OptimConfig(**(optim or {})), data=DataConfig(**(data or {})),
                 train=TrainConfig(**(train or {})))
    mc = ModelConfig(**mc, **datasets.infer_model_dims(samples))
    return Trainer(cfg, mc, samples, list(test), device="cpu")


def _weights(trainer) -> dict[str, np.ndarray]:
    return {k: v.detach().numpy().copy() for k, v in trainer.standard_params().items()}


@pytest.mark.parametrize("ffn_impl", ["xla", "pallas"])
def test_grad_accum_two_micro_batches_equal_one_full_batch(ffn_impl):
    """grad_accum=2 over two micro-batches of B/2 makes the update one step
    over B makes (equal micro sizes: the mean of the micro gradients is
    the gradient of the batch-mean loss); after the first micro-batch no
    weight has moved (tests/test_trainer.py:175, its bar)."""
    samples = datasets.synth_ns2d(4, n_points=32, seed=3)
    mc = dict(MICRO, ffn_impl=ffn_impl)
    full = _trainer(samples, mc)
    full.initialize()
    acc = _trainer(samples, mc, optim=dict(grad_accum=2))
    acc.initialize()
    w0 = _weights(full)
    assert all(np.array_equal(v, w0[k]) for k, v in _weights(acc).items())
    full.train_step(collate(samples, bucket=False), 1e-3)
    acc.train_step(collate(samples[:2], bucket=False), 1e-3)
    for k, v in _weights(acc).items():
        np.testing.assert_array_equal(v, w0[k], err_msg=k)
    assert acc.optimizer.state == {} and (acc.mini_step, acc.host_step) == (1, 1)
    acc.train_step(collate(samples[2:], bucket=False), 1e-3)
    assert (acc.mini_step, acc.gradient_step, acc.host_step) == (0, 1, 2)
    want = _weights(full)
    for k, v in _weights(acc).items():
        np.testing.assert_allclose(v, want[k], rtol=2e-4, atol=1e-6, err_msg=k)


def _adam_state(opt_state) -> optax.ScaleByAdamState:
    is_adam = lambda x: isinstance(x, optax.ScaleByAdamState)  # noqa: E731
    found = [x for x in jax.tree_util.tree_leaves(opt_state, is_leaf=is_adam) if is_adam(x)]
    assert len(found) == 1
    return found[0]


@pytest.mark.parametrize("clip", [0.0, 0.05], ids=["clip_off", "clip_on"])
@pytest.mark.parametrize("k", [2, 3])
def test_grad_accum_matches_jax_multisteps(k, clip):
    """2k+1 micro-steps on ragged elasticity batches (two full windows and
    one micro-step of a third) from the same weights, at a different
    learning rate each: every micro-step's loss, then the weights, AdamW's
    moments and count, and MultiSteps' mean and counts, at the model-level
    bar. The clip bar is below the mean gradient's norm, so it clips."""
    n = 2 * k + 1
    samples = datasets.synth_elasticity(4 * n, seed=7, base_points=40)
    jax_samples = jax_datasets.synth_elasticity(4 * n, seed=7, base_points=40)
    mc = dict(MICRO, **datasets.infer_model_dims(samples))
    lrs = [1e-3 * (1 - 0.1 * i) for i in range(n)]
    jopt = JaxOptimConfig(grad_accum=k, grad_clip_norm=clip)
    jmodel = JaxGNOT(JaxModelConfig(**mc))
    jbatches = list(JaxLoader(jax_samples, 4, shuffle=True, seed=2))
    state = jax_trainer.init_state(jmodel, jopt, jbatches[0], seed=0)
    params0 = jax.tree.map(np.array, jax.device_get(state.params))
    step = jax_trainer.make_train_step(jmodel, jopt, "rel_l2")
    want_losses = []
    for batch, lr in zip(jbatches, lrs):
        state, loss = step(state, batch, np.float32(lr))
        want_losses.append(float(loss))
    opt_state = jax.device_get(state.opt_state)
    adam = _adam_state(opt_state)

    port = _trainer(samples, MICRO, optim=dict(grad_accum=k, grad_clip_norm=clip))
    port.initialize()
    port.load_standard_params(params_from_jax(params0, port.model_cfg))
    got_losses = [float(port.train_step(b, lr))
                  for b, lr in zip(Loader(samples, 4, shuffle=True, seed=2), lrs)]
    np.testing.assert_allclose(got_losses, want_losses, rtol=RTOL, atol=ATOL)
    assert (port.host_step, port.mini_step, port.gradient_step) == (
        int(state.step), int(opt_state.mini_step), int(opt_state.gradient_step)) == (n, 1, 2)
    names = [name for name, _ in port.model.named_parameters()]
    per = port.optimizer.state_dict()["state"]
    want = {"weights": flatten_tree(jax.device_get(state.params)),
            "exp_avg": flatten_tree(adam.mu), "exp_avg_sq": flatten_tree(adam.nu),
            "acc": flatten_tree(opt_state.acc_grads)}
    for i, name in enumerate(names):
        got = {"weights": port.model.get_parameter(name).detach().numpy(),
               "exp_avg": per[i]["exp_avg"].numpy(), "exp_avg_sq": per[i]["exp_avg_sq"].numpy(),
               "acc": port.acc[i].numpy()}
        assert int(per[i]["step"]) == int(adam.count) == 2
        for part, value in got.items():
            np.testing.assert_allclose(value, want[part][name], rtol=RTOL, atol=ATOL,
                                       err_msg=f"{part} {name}")


@pytest.mark.parametrize("parity", [True, False], ids=["parity_schedule", "per_update"])
@pytest.mark.parametrize("k", [1, 2, 3])
def test_lr_fn_matches_jax_with_grad_accum(k, parity):
    for steps_per_epoch, epochs in [(16, 100), (5, 3), (1, 1)]:
        port = make_lr_fn(OptimConfig(grad_accum=k, parity_schedule_bug=parity),
                          steps_per_epoch=steps_per_epoch, epochs=epochs)
        ref = jax_make_lr_fn(JaxOptimConfig(grad_accum=k, parity_schedule_bug=parity),
                             steps_per_epoch=steps_per_epoch, epochs=epochs)
        for step in range(steps_per_epoch * epochs + 2):
            epoch = step // steps_per_epoch
            assert port(step, epoch) == ref(step, epoch), (step, epoch)
    # Per update: the k micro-steps of a window share one learning rate.
    lr = make_lr_fn(OptimConfig(grad_accum=k, parity_schedule_bug=False),
                    steps_per_epoch=12, epochs=4)
    assert len({lr(s, 0) for s in range(k)}) == 1
    assert lr(k, 0) != lr(0, 0)


def test_grad_accum_divisibility_warning_is_jax_s(caplog):
    """4 steps an epoch with grad_accum=3: both trainers log the same
    warning; with grad_accum=2 neither does."""
    samples = datasets.synth_darcy2d(16, seed=0, grid_n=8)
    mc = dict(SMALL, **datasets.infer_model_dims(samples))
    jcfg = make_config(**{"train.graceful_preempt": False})
    for accum, expect in ((3, [WARNING]), (2, [])):
        caplog.clear()
        with caplog.at_level(logging.WARNING):
            jax_trainer.Trainer(
                dataclasses.replace(jcfg, optim=JaxOptimConfig(grad_accum=accum)),
                JaxModelConfig(**mc), samples, [])
        want = [r.getMessage() for r in caplog.records if "grad_accum" in r.getMessage()]
        caplog.clear()
        with caplog.at_level(logging.WARNING):
            _trainer(samples, SMALL, optim=dict(grad_accum=accum))
        got = [r.getMessage() for r in caplog.records if "grad_accum" in r.getMessage()]
        assert got == want == expect


WARNING = ("steps_per_epoch=4 is not divisible by grad_accum=3: accumulation windows "
           "straddle epoch boundaries and the final partial window is discarded")


def _accum_trainer(tmp_path, name, **train):
    """grad_accum=3 over 2 steps an epoch: every epoch ends mid-window."""
    cfg = Config(
        optim=OptimConfig(grad_accum=3, grad_clip_norm=0.5),
        data=DataConfig(synthetic="elasticity", synth_size=40, n_train=8, n_test=4),
        train=TrainConfig(epochs=3, checkpoint_dir=str(tmp_path / name), checkpoint_every=1,
                          **train),
    )
    train_s, test_s = datasets.load(cfg.data)
    mc = ModelConfig(**SMALL, **datasets.infer_model_dims(train_s), ffn_impl="pallas")
    return Trainer(cfg, mc, train_s, test_s, device="cpu",
                   checkpointer=Checkpointer(cfg.train.checkpoint_dir))


@pytest.mark.parametrize("stop_after", [0, 1])
def test_checkpoint_mid_window_resumes_bitwise(tmp_path, capsys, stop_after):
    """A run stopped after epoch 0 (2 of a window's 3 micro-steps taken) or
    after epoch 1 (1 of 3) and resumed from ``latest`` replays the
    continuous run bit for bit: step losses, metrics, weights, AdamW
    state and the accumulation state."""
    continuous = _accum_trainer(tmp_path, "a")
    continuous.fit()
    first = _accum_trainer(tmp_path, "b")
    first.initialize()
    for epoch in range(stop_after + 1):
        first.run_epoch(epoch)
    first.checkpointer.wait()  # a stopped run's exit publishes its last save
    assert first.mini_step == (2 * (stop_after + 1)) % 3 != 0
    resumed = _accum_trainer(tmp_path, "b", resume=True)
    resumed.initialize()
    assert (resumed.start_epoch, resumed.host_step, resumed.mini_step) == (
        stop_after + 1, first.host_step, first.mini_step)
    resumed.fit()
    for got, want in zip(resumed.history, continuous.history[stop_after + 1:]):
        np.testing.assert_array_equal(got.step_losses, want.step_losses)
        assert got.test_metric == want.test_metric
    want, got = continuous.state_dict(), resumed.state_dict()
    for name, p in want["model"].items():
        assert torch.equal(got["model"][name], p), name
    for pid, s in want["optimizer"]["state"].items():
        for k, v in s.items():
            assert torch.equal(got["optimizer"]["state"][pid][k], v), (pid, k)
    for name, a in want["accum"]["acc"].items():
        assert torch.equal(got["accum"]["acc"][name], a), name
    assert got["accum"]["mini_step"] == want["accum"]["mini_step"] == 0
    assert got["accum"]["gradient_step"] == want["accum"]["gradient_step"] == 2
    assert got["step"] == want["step"] == 6
    capsys.readouterr()


def test_accumulating_micro_steps_reuse_the_weight_images():
    """The FFN kernel's weight images (cached per tensor version) survive
    the micro-steps that take no update and are made again after the one
    that does: every expert kernel keeps its image for k-1 micro-steps and
    gets a new one, equal to a fresh pack, after the k-th."""
    samples = datasets.synth_ns2d(12, n_points=32, seed=3)
    port = _trainer(samples, dict(MICRO, ffn_impl="pallas"), optim=dict(grad_accum=3))
    port.initialize()
    kernels = [l.kernel for m in port.model.modules() if isinstance(m, layers.GatedExpertFfn)
               for l in m.experts.layers()]
    assert len(kernels) == 2 * MICRO["n_attn_layers"] * (MICRO["n_mlp_num_layers"] + 1)
    batches = list(Loader(samples, 2))
    for window in range(2):
        images = [fused_ffn.packed_weights(k) for k in kernels]
        packs = fused_ffn.packed_weights.packs
        for micro in range(3):
            port.train_step(batches[3 * window + micro], 1e-3)  # graftlint: disable=GL001 — the port's Trainer.train_step donates nothing
            fresh = [fused_ffn.packed_weights(k) for k in kernels]
            if micro < 2:
                assert all(a is b for a, b in zip(fresh, images))
                assert fused_ffn.packed_weights.packs == packs
            else:
                assert not any(a is b for a, b in zip(fresh, images))
                assert fused_ffn.packed_weights.packs == packs + len(kernels)
                for k, image in zip(kernels, fresh):
                    assert torch.equal(image, fused_ffn.pack_weights(k.detach()))


# -- K steps per dispatch ---------------------------------------------------

@pytest.mark.parametrize("k", [2, 3])
def test_group_batches_is_jax_s(k):
    """Ragged elasticity with bucketing: the port's grouping of its loader
    yields JAX's sequence of groups and singles, batch shapes included."""
    samples = datasets.synth_elasticity(40, seed=5, base_points=70)
    jax_samples = jax_datasets.synth_elasticity(40, seed=5, base_points=70)
    shapes = lambda b: tuple(tuple(t.shape) for t in (b.coords, b.y, b.funcs))  # noqa: E731
    port = [(kind, [shapes(b) for b in (item if kind == "group" else [item])])
            for kind, item in group_batches(Loader(samples, 4, shuffle=True, seed=1), k)]
    want = [(kind, [shapes(b) for b in (item if kind == "group" else [item])])
            for kind, item in jax_trainer.group_batches(
                JaxLoader(jax_samples, 4, shuffle=True, seed=1), k)]
    assert port == want
    kinds = {kind for kind, _ in port}
    assert kinds == {"group", "single"}
    assert [kind for kind, _ in group_batches(range(3), 1)] == ["single"] * 3


@pytest.mark.parametrize("ffn_impl", ["xla", "pallas"])
def test_k_step_group_equals_k_single_steps_bitwise(ffn_impl):
    """One ``multi_train_step`` over 4 stacked batches against 4
    ``train_step`` calls from the same weights: the same losses and the
    same weights, bit for bit; then ``multi_eval_step`` against 4
    ``eval_step`` calls."""
    samples = datasets.synth_ns2d(16, n_points=48, seed=4)
    batches = list(Loader(samples, 4, shuffle=True, seed=3))
    lrs = [1e-3, 9e-4, 8e-4, 7e-4]
    single = _trainer(samples, dict(SMALL, ffn_impl=ffn_impl))
    single.initialize()
    multi = _trainer(samples, dict(SMALL, ffn_impl=ffn_impl))
    multi.initialize()
    want = torch.stack([single.train_step(b, lr) for b, lr in zip(batches, lrs)])
    stacked = stack_batches(batches)
    assert stacked.coords.shape == (4, *batches[0].coords.shape)
    got = multi.multi_train_step(stacked, lrs)
    assert got.shape == (4,) and torch.equal(got, want)
    assert multi.host_step == single.host_step == 4
    for name, p in single.model.state_dict().items():
        assert torch.equal(multi.model.state_dict()[name], p), name
    want_eval = torch.stack([single.eval_step(b) for b in batches])
    assert torch.equal(multi.multi_eval_step(stacked), want_eval)  # graftlint: disable=GL001 — the port's Trainer.train_step donates nothing


def _fit(samples, test, capsys, batch_size=4, **options):
    optim = {k: options.pop(k) for k in ("grad_accum", "flat_params") if k in options}
    t = _trainer(samples, dict(SMALL, ffn_impl="pallas"), optim=optim,
                 train=dict(epochs=2, **options), data=dict(batch_size=batch_size), test=test)
    t.fit()
    capsys.readouterr()
    return t


def test_fit_with_three_steps_per_dispatch_is_the_single_step_run(capsys):
    """``fit`` with K=3 on ragged elasticity (two buckets, groups and
    singles) is the K=1 run bit for bit: step losses, test metrics (the
    test batches grouped the same way) and weights
    (tests/test_trainer.py:331)."""
    samples = datasets.synth_elasticity(24, seed=0, base_points=56)
    test = datasets.synth_elasticity(14, seed=3, base_points=56)
    one = _fit(samples, test, capsys, batch_size=2)
    three = _fit(samples, test, capsys, batch_size=2, steps_per_dispatch=3)
    for epoch in range(2):
        three.train_loader.set_epoch(epoch)
        kinds = [kind for kind, _ in group_batches(three.train_loader, 3)]
        assert "group" in kinds and "single" in kinds
    for a, b in zip(one.history, three.history):
        np.testing.assert_array_equal(a.step_losses, b.step_losses)
        assert a.test_metric == b.test_metric
    assert one.best_metric == three.best_metric
    for name, p in one.model.state_dict().items():
        assert torch.equal(three.model.state_dict()[name], p), name


@pytest.mark.parametrize("option", ["grad_accum", "flat_params"])
def test_steps_per_dispatch_composes_bitwise(option, capsys):
    """K=2 with grad_accum=2 and with the flat layout is the K=1 run of
    the same option bit for bit (tests/test_trainer.py:465)."""
    samples = datasets.synth_ns2d(12, n_points=48, seed=4)
    test = datasets.synth_ns2d(8, n_points=48, seed=5)
    value = {"grad_accum": 2, "flat_params": True}[option]
    one = _fit(samples, test, capsys, **{option: value})
    two = _fit(samples, test, capsys, steps_per_dispatch=2, **{option: value})
    for a, b in zip(one.history, two.history):
        np.testing.assert_array_equal(a.step_losses, b.step_losses)
        assert a.test_metric == b.test_metric
    for name, p in one.standard_params().items():
        assert torch.equal(two.standard_params()[name], p), name
