"""The port's training path against the JAX package's: train steps from
carried weights, a whole ``Trainer.fit``, resume from a checkpoint, the
FFN kernel's weight images after an optimizer step, the refusals, and
the CLI's train mode."""

import dataclasses

import jax
import numpy as np
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
from gnot_tpu_torch import main as port_main
from gnot_tpu_torch.config import (
    Config,
    DataConfig,
    ModelConfig,
    OptimConfig,
    TrainConfig,
)
from gnot_tpu_torch.data import datasets
from gnot_tpu_torch.data.batch import Loader
from gnot_tpu_torch.interop import flatten_tree, params_from_jax
from gnot_tpu_torch.ops import fused_ffn
from gnot_tpu_torch.train.checkpoint import Checkpointer
from gnot_tpu_torch.train.trainer import Trainer

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


def _carry(trainer: Trainer, jax_params) -> None:
    """Load a JAX param tree into the port trainer's model."""
    trainer.model.load_state_dict(params_from_jax(jax_params, trainer.model_cfg), strict=True)


@pytest.mark.parametrize("ffn_impl", ["xla", "pallas"])
def test_three_train_steps_match_jax(ffn_impl):
    """Three AdamW steps on ragged elasticity batches from the same
    weights: each step's loss, the step-1 gradients and every parameter
    after step 3, at the model-level bar. JAX's Pallas FFN runs in
    interpret mode; the port's FFN runs its kernel's plain version."""
    samples = datasets.synth_elasticity(12, seed=7, base_points=70)
    jax_samples = jax_datasets.synth_elasticity(12, seed=7, base_points=70)
    mc = dict(SMALL, **datasets.infer_model_dims(samples), ffn_impl=ffn_impl)
    jbatches = list(JaxLoader(jax_samples, 4, shuffle=True, seed=2))
    lrs = [1e-3, 8e-4, 5e-4]

    jmodel = JaxGNOT(JaxModelConfig(**mc))
    state = jax_trainer.init_state(jmodel, JaxOptimConfig(), jbatches[0], seed=0)
    params0 = jax.tree.map(np.array, jax.device_get(state.params))  # by value: step donates
    grads1 = jax.device_get(
        jax.grad(lambda p: jax_trainer.batch_loss(jmodel, p, jbatches[0], "rel_l2"))(state.params)
    )
    step = jax_trainer.make_train_step(jmodel, JaxOptimConfig(), "rel_l2")
    want_losses = []
    for batch, lr in zip(jbatches, lrs):
        state, loss = step(state, batch, np.float32(lr))
        want_losses.append(float(loss))
    want_params = flatten_tree(jax.device_get(state.params))

    cfg = Config(data=DataConfig(n_train=12), train=TrainConfig(epochs=1))
    port = Trainer(cfg, ModelConfig(**mc), samples, [], device="cpu")
    port.initialize()
    _carry(port, params0)
    got_losses = []
    for i, (batch, lr) in enumerate(zip(Loader(samples, 4, shuffle=True, seed=2), lrs)):
        got_losses.append(float(port.train_step(batch, lr)))
        if i == 0:
            want_grads = flatten_tree(grads1)
            for name, p in port.model.named_parameters():
                np.testing.assert_allclose(p.grad.numpy(), want_grads[name], rtol=RTOL, atol=ATOL,
                                           err_msg=f"step-1 gradient {name}")
    np.testing.assert_allclose(got_losses, want_losses, rtol=RTOL, atol=ATOL)
    assert port.host_step == 3
    for name, p in port.model.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want_params[name], rtol=RTOL, atol=ATOL,
                                   err_msg=f"parameter {name} after step 3")


class _ListSink:
    def __init__(self):
        self.records = []

    def log(self, **record):
        self.records.append(record)


def _fit_configs():
    """The same 2-epoch elasticity run for both packages: ragged meshes
    in two buckets (64 and 96 points), 8 train samples, 6 test samples
    (a short last eval batch)."""
    data = dict(synthetic="elasticity", synth_size=70, n_train=8, n_test=6, batch_size=4)
    jcfg = make_config(
        **{f"data.{k}": v for k, v in data.items()},
        **{"train.epochs": 2, "train.graceful_preempt": False},
    )
    cfg = Config(data=DataConfig(**data), train=TrainConfig(epochs=2))
    return jcfg, cfg


def test_fit_matches_jax_trainer(capsys):
    jcfg, cfg = _fit_configs()
    train, test = datasets.load(cfg.data)
    jtrain, jtest = jax_datasets.load(jcfg.data)
    assert len({s.coords.shape[0] > 64 for s in train}) == 2  # both buckets
    mc = dict(SMALL, **datasets.infer_model_dims(train))
    sink = _ListSink()
    jt = jax_trainer.Trainer(
        dataclasses.replace(jcfg, model=JaxModelConfig(**mc)), JaxModelConfig(**mc),
        jtrain, jtest, metrics_sink=sink,
    )
    jt.initialize()
    params0 = jax.tree.map(np.array, jax.device_get(jt.state.params))  # by value: fit donates
    want_best = jt.fit()
    want = [r for r in sink.records if "test_metric" in r]
    jax_out = capsys.readouterr().out

    port = Trainer(cfg, ModelConfig(**mc), train, test, device="cpu")
    _carry(port, params0)
    got_best = port.fit()
    out = capsys.readouterr().out
    assert [r.epoch for r in port.history] == [0, 1]
    assert [len(r.step_losses) for r in port.history] == [2, 2]
    np.testing.assert_allclose([r.train_loss for r in port.history],
                               [r["train_loss"] for r in want], rtol=RTOL)
    np.testing.assert_allclose([r.test_metric for r in port.history],
                               [r["test_metric"] for r in want], rtol=RTOL)
    np.testing.assert_allclose(got_best, want_best, rtol=RTOL)
    assert got_best == min(r.test_metric for r in port.history)
    # The same console lines, in the same order.
    shape = lambda text: [line.split(":")[0] for line in text.splitlines() if line]  # noqa: E731
    assert shape(out) == shape(jax_out)
    assert out.rstrip().endswith(f"Best Test Metric: {got_best}")


def _small_trainer(tmp_path, name, **train):
    cfg = Config(
        data=DataConfig(synthetic="elasticity", synth_size=40, n_train=8, n_test=4),
        train=TrainConfig(epochs=2, checkpoint_dir=str(tmp_path / name), checkpoint_every=1, **train),
    )
    train_s, test_s = datasets.load(cfg.data)
    mc = ModelConfig(**SMALL, **datasets.infer_model_dims(train_s), ffn_impl="pallas")
    return Trainer(cfg, mc, train_s, test_s, device="cpu",
                   checkpointer=Checkpointer(cfg.train.checkpoint_dir))


def test_resume_after_epoch_one_reproduces_the_continuous_run(tmp_path, capsys):
    continuous = _small_trainer(tmp_path, "a")
    continuous.fit()

    first = _small_trainer(tmp_path, "b")
    first.initialize()
    first.run_epoch(0)  # then stopped: `latest` holds epoch 1's start
    first.checkpointer.wait()  # the stopped run's exit publishes its last save
    resumed = _small_trainer(tmp_path, "b", resume=True)
    resumed.initialize()
    assert (resumed.start_epoch, resumed.host_step) == (1, 2)
    assert resumed.best_metric == continuous.history[0].test_metric
    resumed.fit()
    assert [r.epoch for r in resumed.history] == [1]
    np.testing.assert_array_equal(resumed.history[0].step_losses, continuous.history[1].step_losses)
    assert resumed.history[0].test_metric == continuous.history[1].test_metric
    assert resumed.best_metric == continuous.best_metric
    want = continuous.state_dict()
    got = resumed.state_dict()
    for name, p in want["model"].items():
        np.testing.assert_array_equal(got["model"][name].numpy(), p.numpy(), err_msg=name)
    for pid, s in want["optimizer"]["state"].items():
        for k, v in s.items():
            np.testing.assert_array_equal(got["optimizer"]["state"][pid][k].numpy(), v.numpy())
    assert got["step"] == want["step"] == 4
    # `best` holds the epoch with the lowest metric; a run whose latest
    # checkpoint is missing starts from scratch.
    best = torch.load(Checkpointer(str(tmp_path / "a")).path("best"), weights_only=True)
    assert best["best_metric"] == continuous.best_metric
    assert continuous.history[best["epoch"]].test_metric == best["best_metric"]
    assert set(best["state"]) == {"model", "optimizer", "step"}
    assert Checkpointer(str(tmp_path / "empty")).restore_latest() is None
    assert not [p for p in (tmp_path / "a").iterdir() if p.name.startswith(".")]


@pytest.mark.parametrize("foreach", [True, False])
def test_packed_weights_are_fresh_after_an_adamw_step(foreach):
    """The kernel's cached weight image follows AdamW's in-place update,
    for the foreach and the for-loop implementations."""
    rng = np.random.default_rng(11)
    kernel = torch.nn.Parameter(torch.from_numpy(rng.uniform(-0.2, 0.2, (2, 32, 48)).astype(np.float32)))
    before = fused_ffn.packed_weights(kernel)
    assert fused_ffn.packed_weights(kernel) is before  # cached while unchanged
    version = kernel._version
    opt = torch.optim.AdamW([kernel], lr=1e-2, foreach=foreach)
    kernel.grad = torch.from_numpy(rng.standard_normal((2, 32, 48)).astype(np.float32))
    opt.step()
    assert kernel._version > version
    after = fused_ffn.packed_weights(kernel)
    assert after is not before
    assert not torch.equal(after, before)
    assert torch.equal(after, fused_ffn.pack_weights(kernel.detach()))


def test_the_trainers_adamw_is_the_foreach_implementation():
    """``make_optimizer`` runs torch's foreach AdamW (multi-tensor ops over
    all the weights at once), neither the for-loop implementation (one op
    per weight, which ``fused=False`` alone selects) nor the fused one."""
    from torch.profiler import ProfilerActivity, profile

    from gnot_tpu_torch.train.trainer import make_optimizer

    params = [torch.nn.Parameter(torch.ones(3, 4)), torch.nn.Parameter(torch.ones(5))]
    opt = make_optimizer(OptimConfig(), params)
    assert (opt.defaults["foreach"], opt.defaults["fused"]) == (True, False)
    for p in params:
        p.grad = torch.full_like(p, 0.5)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        opt.step()
    ops = {evt.key for evt in prof.key_averages()}
    assert any(op.startswith("aten::_foreach_") for op in ops), sorted(ops)
    assert params[0]._version > 0


def test_the_trainers_optimizer_moves_every_expert_weight_version():
    """After one train step every FFN expert kernel the fused kernel
    reads has a new version, so each is repacked for the next forward."""
    samples = datasets.synth_elasticity(4, seed=8, base_points=40)
    cfg = Config(data=DataConfig(n_train=4), train=TrainConfig(epochs=1))
    mc = ModelConfig(**SMALL, **datasets.infer_model_dims(samples), ffn_impl="pallas")
    port = Trainer(cfg, mc, samples, [], device="cpu")
    port.initialize()
    kernels = [p for n, p in port.model.named_parameters() if ".experts." in n and n.endswith("kernel")]
    assert len(kernels) == 2 * SMALL["n_attn_layers"] * (SMALL["n_mlp_num_layers"] + 1)
    images = [fused_ffn.packed_weights(k) for k in kernels]
    port.train_step(next(iter(port.train_loader)), 1e-3)
    for k, image in zip(kernels, images):
        fresh = fused_ffn.packed_weights(k)
        assert fresh is not image
        assert torch.equal(fresh, fused_ffn.pack_weights(k.detach()))


def test_invalid_training_options_are_errors():
    with pytest.raises(ValueError, match="grad_accum must be >= 1"):
        OptimConfig(grad_accum=0)
    with pytest.raises(ValueError, match="unknown loss"):
        TrainConfig(loss="l1")


def test_cli_train_mode_prints_the_reference_lines(capsys):
    argv = ["--device", "cpu", "--synthetic", "darcy2d", "--n_train", "12", "--n_test", "4",
            "--epochs", "2", "--n_attn_layers", "2", "--n_attn_hidden_dim", "32",
            "--n_mlp_num_layers", "2", "--n_mlp_hidden_dim", "32", "--n_input_hidden_dim", "32",
            "--n_head", "4", "--synth_size", "12"]
    best = port_main.main(argv)
    lines = capsys.readouterr().out.splitlines()
    losses = [float(l.split(": ")[1]) for l in lines if l.startswith("Epoch") and "Loss" in l]
    metrics = [float(l.split(": ")[1]) for l in lines if "Test Metric" in l and l.startswith("Epoch")]
    assert [l.split(",")[0] for l in lines if l.startswith("Epoch")] == ["Epoch 0"] * 2 + ["Epoch 1"] * 2
    assert len(losses) == len(metrics) == 2 and all(np.isfinite(losses + metrics))
    assert lines[-1] == f"Best Test Metric: {best}" and best == min(metrics)
    args = port_main.build_parser().parse_args([])
    assert (args.epochs, args.n_train, args.lr, args.loss, args.schedule, args.serve) == (
        100, 64, 1e-3, "rel_l2", "parity", False)


def test_cli_trains_on_reference_pickles(tmp_path, capsys):
    """``--train_data`` / ``--test_data`` read reference-schema pickles
    ([X, Y, theta, (f...)] records) instead of a synthetic split."""
    import pickle

    paths = []
    for name, seed, n in (("train", 1, 6), ("test", 2, 3)):
        records = [[s.coords, s.y, s.theta, s.funcs]
                   for s in datasets.synth_elasticity(n, seed=seed, base_points=40)]
        paths.append(tmp_path / f"{name}.pkl")
        paths[-1].write_bytes(pickle.dumps(records))
    argv = ["--device", "cpu", "--train_data", str(paths[0]), "--test_data", str(paths[1]),
            "--epochs", "1", "--n_attn_layers", "1", "--n_attn_hidden_dim", "32",
            "--n_mlp_num_layers", "1", "--n_mlp_hidden_dim", "32", "--n_input_hidden_dim", "32",
            "--n_head", "4"]
    trainer = port_main.run_train(port_main.build_parser().parse_args(argv))
    assert len(trainer.train_loader.samples) == 6 and len(trainer.test_loader.samples) == 3
    assert trainer.model_cfg.out_dim == 2 and trainer.host_step == 2
    assert np.isfinite(trainer.best_metric)
    assert "Epoch 0, Test Metric: " in capsys.readouterr().out


# -- the rest of the train-mode command line --------------------------------

CLI_SMALL = ["--device", "cpu", "--synthetic", "elasticity", "--synth_size", "40", "--n_train", "8",
             "--n_test", "4", "--n_attn_layers", "2", "--n_attn_hidden_dim", "32",
             "--n_mlp_num_layers", "2", "--n_mlp_hidden_dim", "32", "--n_input_hidden_dim", "32",
             "--n_expert", "2", "--n_head", "4", "--ffn_impl", "pallas"]


@pytest.mark.parametrize("gelu,want", [("", "tanh"), ("erf", "erf"), ("tanh", "tanh")])
def test_cli_gelu_dtype_and_remat_reach_the_model_config(gelu, want):
    argv = CLI_SMALL + (["--gelu", gelu] if gelu else []) + ["--dtype", "bfloat16", "--remat"]
    args = port_main.build_parser().parse_args(argv)
    mc = port_main.model_config(args, datasets.synth_elasticity(2, seed=0, base_points=40))
    assert (mc.gelu, mc.dtype, mc.remat) == (want, "bfloat16", True)
    jax_mc = JaxModelConfig(gelu=gelu)
    assert ModelConfig(gelu=gelu).gelu == jax_mc.gelu == want
    defaults = port_main.build_parser().parse_args([])
    assert (defaults.gelu, defaults.dtype, defaults.remat, defaults.eval_only,
            defaults.predict_out, defaults.export_torch) == ("", "float32", False, False, "", "")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cli_eval_only_evaluates_the_best_checkpoint(dtype, tmp_path, capsys):
    """``--eval_only`` restores ``best`` and evaluates it: JAX's printed
    line, and the metric the training run recorded for that epoch."""
    ck = str(tmp_path / "ck")
    argv = CLI_SMALL + ["--dtype", dtype, "--checkpoint_dir", ck]
    trained = port_main.run_train(port_main.build_parser().parse_args(argv + ["--epochs", "2"]))
    capsys.readouterr()
    best_epoch = min(trained.history, key=lambda r: r.test_metric).epoch
    got = port_main.main(argv + ["--eval_only"])
    out = capsys.readouterr().out.splitlines()
    # The restore names the file, as JAX's restore names its directory.
    assert out == [f"Restored 'best' checkpoint from best.{best_epoch}.pt (epoch {best_epoch})",
                   f"Eval (best checkpoint from epoch {best_epoch}): {got}"]
    assert got == trained.best_metric


def test_eval_only_raises_jax_errors(tmp_path):
    with pytest.raises(ValueError, match="eval-only mode needs --checkpoint_dir"):
        port_main.main(CLI_SMALL + ["--eval_only"])
    empty = tmp_path / "empty"
    with pytest.raises(FileNotFoundError, match="no best checkpoint under"):
        port_main.main(CLI_SMALL + ["--eval_only", "--checkpoint_dir", str(empty)])
    jcfg, cfg = _fit_configs()
    train, test = datasets.load(cfg.data)
    mc = dict(SMALL, **datasets.infer_model_dims(train))
    jt = jax_trainer.Trainer(dataclasses.replace(jcfg, model=JaxModelConfig(**mc)),
                             JaxModelConfig(**mc), train, test)
    with pytest.raises(ValueError, match="eval-only mode needs --checkpoint_dir"):
        jt.evaluate_from_checkpoint()


def _carried_trainers():
    """A JAX trainer and the port's holding the same initial weights."""
    jcfg, cfg = _fit_configs()
    train, test = datasets.load(cfg.data)
    mc = dict(SMALL, **datasets.infer_model_dims(train))
    jt = jax_trainer.Trainer(dataclasses.replace(jcfg, model=JaxModelConfig(**mc)),
                             JaxModelConfig(**mc), train, test)
    jt.initialize()
    params = jax.device_get(jt.state.params)
    port = Trainer(cfg, ModelConfig(**mc), train, test, device="cpu")
    _carry(port, params)
    return jt, port, params, test


def test_predict_matches_jax_predict():
    jt, port, _, test = _carried_trainers()
    want, got = jt.predict(test), port.predict(test)
    assert [g.shape for g in got] == [w.shape for w in want] == [s.y.shape for s in test]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)


def test_reference_state_dict_is_jax_flax_to_state_dict():
    """``--export_torch``'s naming: the same keys as the JAX package's
    ``flax_to_state_dict`` of the same weights, every tensor bitwise."""
    from gnot_tpu.interop.torch_oracle import flax_to_state_dict
    from gnot_tpu_torch.interop import reference_state_dict

    _, port, params, _ = _carried_trainers()
    want = flax_to_state_dict(params, JaxModelConfig(**dataclasses.asdict(port.model_cfg)))
    got = reference_state_dict(port.model.state_dict(), port.model_cfg)
    assert sorted(got) == sorted(want)
    for name, t in want.items():
        assert got[name].dtype == t.dtype == torch.float32, name
        assert torch.equal(got[name], t), name


def test_cli_predict_out_and_export_torch_use_the_best_checkpoint(tmp_path, capsys):
    """``--predict_out`` and ``--export_torch`` after a run with
    ``--checkpoint_dir``: the records read back by both packages' readers
    give the same arrays, equal to the best checkpoint's predictions; the
    exported state_dict is the best checkpoint's weights under the
    reference's names. Without ``--checkpoint_dir`` JAX's note is printed."""
    from gnot_tpu_torch.interop import reference_state_dict

    ck, pred, pth = tmp_path / "ck", tmp_path / "pred.pkl", tmp_path / "model.pth"
    argv = CLI_SMALL + ["--epochs", "2", "--checkpoint_dir", str(ck), "--predict_out", str(pred),
                        "--export_torch", str(pth)]
    trainer = port_main.run_train(port_main.build_parser().parse_args(argv))
    out = capsys.readouterr().out
    assert f"Exported torch state_dict to {pth}" in out
    assert f"Wrote 4 predictions to {pred}" in out
    best = Checkpointer(str(ck)).restore_best()[0]["model"]
    for name, p in trainer.model.state_dict().items():
        assert torch.equal(p, best[name]), name  # the best weights, restored
    _, test = datasets.load(trainer.config.data)
    want = trainer.predict(test)
    port_read, jax_read = datasets.load_pickle(str(pred)), jax_datasets.load_pickle(str(pred))
    assert len(port_read) == len(jax_read) == len(test)
    for s, p, j, w in zip(test, port_read, jax_read, want):
        for field in ("coords", "theta"):
            np.testing.assert_array_equal(getattr(p, field), getattr(s, field))
            np.testing.assert_array_equal(getattr(j, field), getattr(s, field))
        np.testing.assert_array_equal(p.y, w)
        np.testing.assert_array_equal(j.y, w)
        for pf, jf, sf in zip(p.funcs, j.funcs, s.funcs):
            np.testing.assert_array_equal(pf, sf)
            np.testing.assert_array_equal(jf, sf)
    exported = torch.load(pth, weights_only=True)
    ref = reference_state_dict(best, trainer.model_cfg)
    assert sorted(exported) == sorted(ref)
    for name, t in ref.items():
        assert torch.equal(exported[name], t), name

    port_main.run_train(port_main.build_parser().parse_args(
        CLI_SMALL + ["--epochs", "1", "--export_torch", str(tmp_path / "final.pth")]))
    assert "note: no --checkpoint_dir, so export/predict artifacts use the FINAL-epoch weights" \
        in capsys.readouterr().out
