"""The port's parallel training and serving against the JAX package's on
the CPU.

One launch of 8 gloo ranks (``torch_ranks.py``) runs every multi-rank
scenario of this file: the sharded train step on four meshes, gradient
accumulation, the multi step, the flat layout on ``data4 x seq2``, the
pipeline schedule on three pipe meshes, packed batches and the stacked
layout on ``data4 x model2``, parity mode on ``data2 x seq2 x model2`` and
``data2 x model2 x pipe2``, the ragged-tail eval (GSPMD and pipelined),
telemetry on a mesh, the stop agreement (on a seq and on a pipe mesh),
the restore-walk agreement, and serving over ``data2 x seq2 x model2``
(a hot reload, bf16, a SIGTERM to a follower alone and one to rank 0).
Each training case is held against JAX's single-device step from the
same carried weights at ``tests/test_sharding.py``'s and
``tests/test_pipeline.py``'s bars, and serving against JAX's
``Trainer.inference_engine()`` on the same mesh of 8 host devices. The
mesh checks and refusals run in this process, and the CLI tests hold
``torchrun`` over 4 ranks (and over 2, with a pipe axis, and 2 serving)
against JAX's ``main --distributed`` on 4 (and 2) host devices.

What JAX serves on a one-process mesh (``main --serve --distributed
--mesh_data 2 --mesh_seq 2 --mesh_model 2`` on 8 host devices, each flag
run): warm-up, ``--serve_dtype bfloat16``, ``--serve_packed``,
``--scan_layers``, ``--serve_reload_every``, ``--serve_rollout_steps``,
the tenant flags, ``--metrics_interval_s``, and the expert and pipe axes;
``--flat_params`` on the data and seq axes. What it refuses, and the port
with its words: several processes, ``--serve_replicas`` / ``--autoscale``
/ ``--hosts`` on the mesh, bf16 with ``--scan_layers`` or
``--flat_params``, ``--flat_params`` with a split weight, ``--ffn_impl
pallas``, parity mode on seq (its bucketing is off, and seq needs
bucketed lengths)."""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ranks
from gnot_tpu.config import ModelConfig as JaxModelConfig
from gnot_tpu.config import OptimConfig as JaxOptimConfig
from gnot_tpu.data import datasets as jax_datasets
from gnot_tpu.data.batch import Loader as JaxLoader
from gnot_tpu.models.gnot import GNOT as JaxGNOT
from gnot_tpu.data import batch as jax_batch
from gnot_tpu.parallel import mesh as jax_mesh
from gnot_tpu.parallel import multihost as jax_multihost
from gnot_tpu.parallel import pipeline as jax_pipeline
from gnot_tpu.train import trainer as jax_trainer
from gnot_tpu_torch import main as port_main
from gnot_tpu_torch.config import (
    Config,
    DataConfig,
    MeshConfig,
    ModelConfig,
    NotPortedError,
    TrainConfig,
)
from gnot_tpu_torch.data import datasets
from gnot_tpu_torch.data.batch import Loader, fixed_pad_lengths
from gnot_tpu_torch.interop import flatten_tree, params_from_jax
from gnot_tpu_torch.parallel import mesh as mesh_lib
from gnot_tpu_torch.parallel import multihost, pipeline
from gnot_tpu_torch.train.checkpoint import Checkpointer
from gnot_tpu_torch.train.trainer import Trainer, stack_batches

# tests/test_sharding.py's SMALL with 4 experts, so one model serves the
# expert axes (of 4, and of 2) as well as the others.
SMALL = dict(input_dim=2, theta_dim=1, input_func_dim=3, out_dim=1, n_input_functions=1,
             n_attn_layers=2, n_attn_hidden_dim=32, n_mlp_num_layers=2, n_mlp_hidden_dim=32,
             n_input_hidden_dim=32, n_head=4, n_expert=4)
LRS = [1e-3, 8e-4]
ROOT = torch_ranks.ROOT
DS2M2 = dict(data=2, seq=2, model=2)
PARITY = dict(attention_mode="parity", gelu="erf")
D2M2P2 = dict(data=2, model=2, pipe=2)
# The pipe meshes follow tests/test_pipeline.py:76-82 on a batch of 8:
# M = S with 1 block a stage, M = 2 with DP, M > S with 2 blocks a stage.
PIPE_CASES = {
    "pipe_data2_model2_pipe2": dict(mesh=D2M2P2, steps="single", roundtrip=True),
    "pipe_data4_pipe2_micro2": dict(mesh=dict(data=4, pipe=2, microbatches=2),
                                    steps="single"),
    "pipe_data2_model2_pipe2_layers4_micro4": dict(
        mesh=dict(D2M2P2, microbatches=4), steps="single", over=dict(n_attn_layers=4)),
}
CASES = {
    **PIPE_CASES,
    "packed_data4_model2": dict(mesh=dict(data=4, model=2), steps="single",
                                over=dict(packed=True)),
    "scan_data4_model2": dict(mesh=dict(data=4, model=2), steps="single",
                              over=dict(scan_layers=True)),
    "data2_seq2_model2": dict(mesh=DS2M2, steps="single", telemetry=True),
    "seq4_model2": dict(mesh=dict(data=1, seq=4, model=2), steps="single"),
    "data2_expert4": dict(mesh=dict(data=2, expert=4), steps="single"),
    "data2_model2_expert2": dict(mesh=dict(data=2, model=2, expert=2), steps="single",
                                 roundtrip=True),
    "grad_accum": dict(mesh=DS2M2, steps="two", over=dict(grad_accum=2)),
    "multi_step": dict(mesh=DS2M2, steps="multi", over=dict(steps_per_dispatch=2)),
    "flat_data4_seq2": dict(mesh=dict(data=4, seq=2), steps="single",
                            over=dict(flat_params=True)),
    "parity_data2_seq2_model2": dict(mesh=DS2M2, steps="single", over=dict(PARITY)),
    "parity_data2_model2_pipe2": dict(mesh=D2M2P2, steps="single", over=dict(PARITY)),
}


def _jax_params(batch, n_layers=2):
    """JAX's model and its params from seed 0, built under one ``jax.jit``
    (bitwise flax's eager init, a third of the time)."""
    model = JaxGNOT(JaxModelConfig(**dict(SMALL, n_attn_layers=n_layers)))
    params = jax.jit(lambda b: jax_trainer.init_params(model, b, 0))(batch)
    return model, jax.tree.map(np.array, jax.device_get(params))


def _jax_steps(step, params, optim, batches, stacked_layers=0):
    """Losses and params after JAX's single-device steps from ``params``,
    one per batch (``step`` donates the state it is given); with
    ``stacked_layers`` the params are JAX's stacked layout of that many
    layers, unstacked for the comparison."""
    params = jax.tree.map(jnp.asarray, params)
    tx = jax_trainer.make_optimizer(optim, optim.lr)
    state = jax_trainer.TrainState(params=params, opt_state=tx.init(params),
                                   step=jnp.zeros((), jnp.int32))
    losses = []
    for batch, lr in zip(batches, LRS):
        state, loss = step(state, batch, np.float32(lr))
        losses.append(float(loss))
    after = jax.device_get(state.params)
    if stacked_layers:
        after = jax_pipeline.unstack_params(after, stacked_layers)
    return losses, flatten_tree(after)


def _jax_references(jbatches, model, params, optim):
    """JAX's single-device references of the pipe, packed and stacked
    cases: the 4-layer model's step (its weights from seed 0), the packed
    step on the packed cases' first dispatch, the stacked step."""
    want = {}
    model4, params4 = _jax_params(jbatches[0], 4)
    want["single4"] = _jax_steps(jax_trainer.make_train_step(model4, optim, "rel_l2"), params4,
                                 optim, jbatches[:1])
    packed = jax_batch.PackedLoader(torch_ranks.packed_samples(jax_datasets), 8,
                                    chunk=torch_ranks.PACK_CHUNK, row_multiple=4).probe_batch()
    step = jax_trainer.make_train_step(model, optim, "rel_l2",
                                       loss_fn=jax_trainer.packed_loss_fn(model, "rel_l2"))
    want["packed"] = _jax_steps(step, params, optim, [packed])
    mc = JaxModelConfig(**dict(SMALL, scan_layers=True))
    step = jax_trainer.make_train_step(model, optim, "rel_l2",
                                       loss_fn=jax_trainer.stacked_loss_fn(mc, "rel_l2"))
    want["stacked"] = _jax_steps(step, jax_pipeline.stack_params(params, 2), optim,
                                 jbatches[:1], stacked_layers=2)
    return params4, want


def _jax_mesh_serving(param_sets: list) -> list[list[np.ndarray]]:
    """JAX's ``Trainer.inference_engine()`` on the serving scenarios' mesh
    (data2 x seq2 x model2 of this process's 8 host devices, the trainer's
    fixed pad lengths), its ``predict`` of the requests under each weight
    set in turn, each placed with the trainer's own param shardings. The
    trainer's state is built with ``init_params`` under one ``jax.jit``."""
    from gnot_tpu.config import Config as JaxConfig
    from gnot_tpu.config import DataConfig as JaxDataConfig
    from gnot_tpu.config import MeshConfig as JaxMeshConfig
    from gnot_tpu.config import TrainConfig as JaxTrainConfig

    train, reqs = torch_ranks.serve_samples(jax_datasets)
    cfg = JaxConfig(data=JaxDataConfig(batch_size=4), train=JaxTrainConfig(distributed=True),
                    mesh=JaxMeshConfig(**torch_ranks.SERVE_MESH))
    trainer = jax_trainer.Trainer(cfg, JaxModelConfig(**SMALL), train, reqs)
    eager = jax_trainer.init_params
    jax_trainer.init_params = lambda model, batch, seed: jax.jit(
        lambda b: eager(model, b, seed))(batch)
    try:
        trainer.initialize()
    finally:
        jax_trainer.init_params = eager
    outs = []
    for params in param_sets:
        placed = jax.tree.map(lambda old, new: jax.device_put(new, old.sharding),
                              trainer.state.params, params)
        trainer.state = trainer.state.replace(params=placed)
        outs.append(trainer.inference_engine().predict(reqs))
    return outs


def _diverge_dirs(root):
    """Checkpoint directories whose restore walks diverge on rank 3: another
    ``latest`` file name ("candidate"), or none at all ("exhausted")."""
    dirs = {}
    for which, odd in (("candidate", "latest.1.pt"), ("exhausted", None)):
        common, other = root / f"{which}_a", root / f"{which}_b"
        common.mkdir()
        other.mkdir()
        (common / "latest.2.pt").write_bytes(b"x")
        if odd:
            (other / odd).write_bytes(b"x")
        dirs[which] = [str(other if r == 3 else common) for r in range(8)]
    return dirs


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The 8-rank launch and the CLI test's two runs, started together; JAX's
    references computed while they run. Every process is killed at the end
    of the module, whatever became of it."""
    tmp = tmp_path_factory.mktemp("parallel")
    # JAX's CLI runs are the longest: they start first; the ranks start
    # before their payload (JAX's weights) is written, and wait for it.
    cli = [_start_jax_cli(CLI, 4), _start_jax_cli(PIPE_CLI, 2),
           _start_jax_cli(SERVE_CLI + ["--metrics_path", str(tmp / "jax_serve" / "m.jsonl")], 2)]
    launch = torch_ranks.Launch("train", 8, tmp / "payload.pt", tmp / "out")
    try:
        jbatches = list(JaxLoader(jax_datasets.synth_ns2d(16, n_points=64), 8))
        optim = JaxOptimConfig()
        model, params = _jax_params(jbatches[0])
        params4, want = _jax_references(jbatches, model, params, optim)
        reload = jax.tree.map(lambda a: a * np.float32(0.9), params)
        payload = dict(model=SMALL, lrs=LRS, cases=CASES, stop_dir=str(tmp / "stop"),
                       pipe_stop_dir=str(tmp / "pipe_stop"), diverge=_diverge_dirs(tmp),
                       params={2: params_from_jax(params, ModelConfig(**SMALL)),
                               4: params_from_jax(params4, ModelConfig(
                                   **dict(SMALL, n_attn_layers=4)))},
                       serve_reload=params_from_jax(reload, ModelConfig(**SMALL)))
        torch_ranks.write_payload(payload, tmp / "payload.pt")
        cli.append(_start_port_cli(tmp / "cli", payload["params"][2]))
        cli.append(_start_port_cli(tmp / "pipe_cli", payload["params"][2], pipe=True))
        cli.append(_popen([sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", "2",
                           "--master_port", str(torch_ranks.free_port()), "-m",
                           "gnot_tpu_torch.main", *SERVE_CLI, "--device", "cpu",
                           "--metrics_path", str(tmp / "port_serve" / "m.jsonl")]))
        parity = JaxGNOT(JaxModelConfig(**SMALL, **PARITY))
        want["parity"] = _jax_steps(jax_trainer.make_train_step(parity, optim, "rel_l2"), params,
                                    optim, jbatches[:1])
        want["serve"] = _jax_mesh_serving([params, reload])
        step = jax_trainer.make_train_step(model, optim, "rel_l2")
        want["single"] = _jax_steps(step, params, optim, jbatches[:1])
        want["two"] = _jax_steps(step, params, optim, jbatches)
        accum = JaxOptimConfig(grad_accum=2)
        want["accum"] = _jax_steps(jax_trainer.make_train_step(model, accum, "rel_l2"),
                                   params, accum, jbatches)
        evaluate = jax_trainer.make_eval_step(model, "rel_l2")
        tests = jax_datasets.synth_ns2d(6, seed=5, n_points=64)
        want["eval"] = float(np.mean([float(evaluate(params, b)) for b in JaxLoader(tests, 4)]))
        results = launch.wait(timeout_s=240)
        # The finale's records (rank 7 died in it and wrote none).
        dead = [torch.load(tmp / "out" / f"dead{r}.pt", weights_only=False) for r in range(7)]
        yield dict(results=results, want=want, payload=payload, cli=cli, cli_dir=tmp, dead=dead)
    finally:
        launch.kill()
        for p in cli:
            if p.poll() is None:
                p.kill()
                p.wait()


def _assert_params(got: dict, want: dict, rtol: float, atol: float, what: str) -> None:
    assert set(got) == set(want)
    for name, value in got.items():
        np.testing.assert_allclose(value.numpy(), want[name], rtol=rtol, atol=atol,
                                   err_msg=f"{what}: {name}")


@pytest.mark.parametrize("case", ["data2_seq2_model2", "seq4_model2", "data2_expert4",
                                  "data2_model2_expert2", "flat_data4_seq2"])
def test_sharded_step_matches_jax_single_device(ranks, case):
    """One step on the mesh == JAX's single-device step, at
    ``tests/test_sharding.py``'s bars: loss rtol 1e-5, every param after the
    step rtol 2e-4 / atol 2e-5. Every rank reports the same loss."""
    want_losses, want_params = ranks["want"]["single"]
    losses = [r["cases"][case]["losses"] for r in ranks["results"]]
    assert all(l == losses[0] for l in losses)
    np.testing.assert_allclose(losses[0], want_losses, rtol=1e-5)
    _assert_params(ranks["results"][0]["cases"][case]["params"], want_params, 2e-4, 2e-5, case)


@pytest.mark.parametrize("case", list(PIPE_CASES))
def test_pipelined_step_matches_jax_single_device(ranks, case):
    """One step of the pipeline schedule == JAX's single-device step from
    the same weights, at ``tests/test_pipeline.py``'s bars: loss rtol 1e-5,
    every param rtol 2e-4 / atol 2e-5; every rank reports the same loss.
    data2 x model2 x pipe2 with M = S, data4 x pipe2 with M = 2, and 4
    layers (2 blocks a stage) with M = 4 > S."""
    layers = CASES[case].get("over", {}).get("n_attn_layers", 2)
    want_losses, want_params = ranks["want"]["single" if layers == 2 else "single4"]
    losses = [r["cases"][case]["losses"] for r in ranks["results"]]
    assert all(l == losses[0] for l in losses)
    np.testing.assert_allclose(losses[0], want_losses, rtol=1e-5)
    _assert_params(ranks["results"][0]["cases"][case]["params"], want_params, 2e-4, 2e-5, case)


def test_pipelined_eval_with_a_repeat_padded_tail_matches_jax(ranks):
    """The ragged-tail eval through the pipeline (data2 x model2 x pipe2,
    M = S): 6 samples in batches of 4, the tail filled with repeats and
    scored per sample on its real rows; every rank gets JAX's
    single-device metric."""
    got = [r["pipe_eval"] for r in ranks["results"]]
    assert all(g == got[0] for g in got)
    np.testing.assert_allclose(got[0], ranks["want"]["eval"], rtol=1e-5)


def test_packed_step_on_a_mesh_matches_jax(ranks):
    """``--packed`` on data4 x model2: the packed rows split over the data
    ranks, which hold different numbers of samples, and the step's loss
    (the mean over the whole dispatch's samples) and weights are JAX's
    single-device packed step's: loss 1e-5 / 1e-6, weights 2e-4 / 2e-5."""
    got = ranks["results"][0]["cases"]["packed_data4_model2"]
    counts = [r["cases"]["packed_data4_model2"]["segments"] for r in ranks["results"]]
    assert len(set(counts)) > 1, counts
    want_losses, want_params = ranks["want"]["packed"]
    np.testing.assert_allclose(got["losses"], want_losses, rtol=1e-5, atol=1e-6)
    _assert_params(got["params"], want_params, 2e-4, 2e-5, "packed")


def test_scan_layers_step_on_a_mesh_matches_jax(ranks):
    """``--scan_layers`` on data4 x model2 (the stacked blocks split over
    model behind an unsplit layer dim) == JAX's single-device stacked
    step, at ``tests/test_pipeline.py:314-356``'s bars."""
    got = ranks["results"][0]["cases"]["scan_data4_model2"]
    want_losses, want_params = ranks["want"]["stacked"]
    np.testing.assert_allclose(got["losses"], want_losses, rtol=1e-5)
    _assert_params(got["params"], want_params, 2e-4, 2e-5, "scan_layers")


def test_grad_accum_on_a_mesh_matches_jax(ranks):
    """Two micro-steps of ``grad_accum=2`` on data2 x seq2 x model2 (one
    update on the mean gradient) == JAX's MultiSteps, at 1e-5 / 1e-6."""
    want_losses, want_params = ranks["want"]["accum"]
    got = ranks["results"][0]["cases"]["grad_accum"]
    np.testing.assert_allclose(got["losses"], want_losses, rtol=1e-5, atol=1e-6)
    _assert_params(got["params"], want_params, 1e-5, 1e-6, "grad_accum")


def test_multi_step_on_a_mesh_matches_jax(ranks):
    """One dispatch of two steps (``multi_train_step``) on the mesh == two
    JAX single-device steps; its multi eval is every rank's mean."""
    want_losses, want_params = ranks["want"]["two"]
    got = ranks["results"][0]["cases"]["multi_step"]
    np.testing.assert_allclose(got["losses"], want_losses, rtol=1e-5)
    _assert_params(got["params"], want_params, 2e-4, 2e-5, "multi_step")
    evals = [r["cases"]["multi_step"]["multi_eval"] for r in ranks["results"]]
    assert len(evals[0]) == 2 and all(e == evals[0] for e in evals)


def test_ragged_tail_eval_on_a_mesh_matches_jax(ranks):
    """6 test samples in batches of 4 on data2 x seq2 x model2: the tail is
    filled with repeats and scored on its 2 real rows, so the metric is
    JAX's single-device mean over the full and the short batch."""
    got = [r["eval"] for r in ranks["results"]]
    assert all(g == got[0] for g in got)
    np.testing.assert_allclose(got[0], ranks["want"]["eval"], rtol=1e-5)


def test_mesh_telemetry_matches_the_single_device_step(ranks):
    """Telemetry of a data2 x seq2 x model2 step (norms over every rank's
    shards, gate stats and padding over every rank's tokens) == the port's
    single-device step's (which rank 0 also ran)."""
    got = ranks["results"][0]["cases"]["data2_seq2_model2"]["telemetry"]
    telem = ranks["results"][0]["single_telemetry"]
    assert set(got) == set(telem)
    for key, value in telem.items():
        np.testing.assert_allclose(got[key].numpy(), value.numpy(), rtol=1e-5, atol=1e-6,
                                   err_msg=key)


def _assert_stopped_and_resumed(stops: list[dict]) -> None:
    assert {s["stop_step"] for s in stops} == {3}
    assert {s["stop_epochs"] for s in stops} == {1}
    assert stops[0]["latest"]["epoch"] == 1
    for s in stops:
        assert s["resumed"]["host_step"] == s["carried_on"]["host_step"] == 5
        assert s["resumed"]["loss"] == s["carried_on"]["loss"]
        for name, value in s["resumed"]["params"].items():
            assert torch.equal(value, s["carried_on"]["params"][name]), name


def test_a_stop_on_one_rank_stops_every_rank_at_the_same_step(ranks):
    """SIGTERM on rank 5 alone: every rank stops after step 3, rank 0 saves
    ``latest`` at epoch 1, and a run resumed from it ends on the weights and
    losses of the stopped run carried on in memory, bitwise."""
    _assert_stopped_and_resumed([r["stop"] for r in ranks["results"]])


def test_a_stop_on_one_rank_of_a_pipe_mesh_resumes_bitwise(ranks):
    """The same on data2 x model2 x pipe2: every stage stops after step 3,
    the checkpoint holds the stacked layout whole (gathered from the
    stages and the model shards), and the resume (each rank keeping its
    stage's shards again) is bitwise the stopped run carried on."""
    stops = [r["pipe_stop"] for r in ranks["results"]]
    shapes = stops[0]["saved_shapes"]
    assert shapes["blocks.ffn1.experts.dense_0.kernel"] == (2, 4, 32, 32)
    assert not any(name.startswith("block_") for name in shapes)
    _assert_stopped_and_resumed(stops)


@pytest.mark.parametrize("which", ["candidate", "exhausted"])
def test_a_diverged_restore_walk_raises_on_every_rank(ranks, which):
    """Rank 3 sees another ``latest`` candidate, or none: every rank raises
    JAX's RuntimeError rather than restoring different weights or waiting."""
    for r in ranks["results"]:
        assert "restore walk diverged" in r["diverge"][which]


def test_a_sharded_checkpoint_state_round_trips_bitwise(ranks):
    """On data2 x model2 x expert2, the gathered checkpoint state loaded into
    a fresh trainer (each rank keeping its shards) gathers back bitwise:
    weights, AdamW moments, step counts."""
    assert all(r["cases"]["data2_model2_expert2"]["roundtrip"] for r in ranks["results"])


def test_a_pipe_sharded_checkpoint_state_round_trips_bitwise(ranks):
    """On data2 x model2 x pipe2, the checkpoint state (the stacked blocks
    gathered from the stages and the model shards) loaded into a fresh
    trainer gathers back bitwise."""
    assert all(r["cases"]["pipe_data2_model2_pipe2"]["roundtrip"] for r in ranks["results"])


def test_every_rank_knows_its_place(ranks):
    assert [r["process"] for r in ranks["results"]] == [(i, 8) for i in range(8)]


# -- in one process: the mesh's checks, the refusals, multihost's pure parts --


def test_mesh_validation_has_jax_messages():
    assert mesh_lib.mesh_shape(MeshConfig(seq=2, model=2), 8) == dict(
        data=2, seq=2, model=2, expert=1, pipe=1)
    with pytest.raises(ValueError, match="does not cover 8 devices"):
        mesh_lib.mesh_shape(MeshConfig(data=3, seq=2), 8)
    with pytest.raises(ValueError, match="pipe > 1 composes with the data and model"):
        mesh_lib.mesh_shape(MeshConfig(seq=2, pipe=2), 8)
    shape = mesh_lib.mesh_shape(MeshConfig(data=2, expert=4), 8)
    mesh = mesh_lib.Mesh(shape, mesh_lib.rank_coords(shape, 0), {})
    with pytest.raises(ValueError, match=r"n_expert=3 must be divisible by the mesh expert axis \(4\)"):
        mesh_lib._validate_gspmd(ModelConfig(**dict(SMALL, n_expert=3)), mesh)
    with pytest.raises(ValueError, match="ffn_impl='pallas' is single-device/DP only"):
        mesh_lib._validate_gspmd(ModelConfig(**dict(SMALL, ffn_impl="pallas")), mesh)
    # Parity mode runs on the seq and model axes, as JAX's GSPMD does.
    for axes in (dict(data=4, seq=2), dict(data=4, model=2), dict(data=2, model=2, pipe=2)):
        mesh_lib.validate_layers(ModelConfig(**dict(SMALL, **PARITY)), _mesh(**axes))


def _mesh(**axes):
    """A mesh of 8 ranks by its axis sizes, as rank 0 sees it (no groups):
    what the pipeline's checks read."""
    shape = mesh_lib.mesh_shape(MeshConfig(**axes), 8)
    return mesh_lib.Mesh(shape, mesh_lib.rank_coords(shape, 0), {})


def _port_trainer(train=None, mesh=None, data=None, **model):
    """A port trainer on one rank (its refusals come before any mesh)."""
    cfg = Config(data=DataConfig(**(data or {})),
                 train=TrainConfig(distributed=True, **(train or {})),
                 mesh=MeshConfig(**(mesh or {})))
    Trainer(cfg, ModelConfig(**dict(SMALL, **model)), datasets.synth_ns2d(4, n_points=64), [],
            device="cpu").initialize()


def _jax_trainer(train=None, mesh=None, data=None, **model):
    from gnot_tpu.config import Config as JaxConfig
    from gnot_tpu.config import DataConfig as JaxDataConfig
    from gnot_tpu.config import MeshConfig as JaxMeshConfig
    from gnot_tpu.config import TrainConfig as JaxTrainConfig

    cfg = JaxConfig(data=JaxDataConfig(**(data or {})),
                    train=JaxTrainConfig(distributed=True, **(train or {})),
                    mesh=JaxMeshConfig(**(mesh or {})))
    jax_trainer.Trainer(cfg, JaxModelConfig(**dict(SMALL, **model)),
                        jax_datasets.synth_ns2d(4, n_points=64), [])


def _pipe_check(fn, *args):
    """``fn`` of the port's pipeline module and of JAX's, on one mesh."""
    from gnot_tpu.parallel import pipeline as jax_pipe

    def call(module, mc_cls):
        args_ = [mc_cls(**a) if isinstance(a, dict) else a for a in args]
        getattr(module, fn)(*args_)

    return (lambda: call(pipeline, ModelConfig), lambda: call(jax_pipe, JaxModelConfig))


REFUSALS = {
    "telemetry_with_pipe": (lambda: _port_trainer(dict(telemetry=True), dict(pipe=2)),
                            lambda: _jax_trainer(dict(telemetry=True), dict(pipe=2))),
    "steps_per_dispatch_with_pipe": (
        lambda: _port_trainer(dict(steps_per_dispatch=2), dict(pipe=2)),
        lambda: jax_mesh._reject_pipe_multi(_mesh(pipe=2))),
    "packed_with_seq": (lambda: _port_trainer(mesh=dict(seq=2), data=dict(packed=True)),
                        lambda: _jax_trainer(mesh=dict(seq=2), data=dict(packed=True))),
    "packed_with_pipe": (lambda: _port_trainer(mesh=dict(pipe=2), data=dict(packed=True)),
                         lambda: _jax_trainer(mesh=dict(pipe=2), data=dict(packed=True))),
    "packed_with_scan_layers": (
        lambda: _port_trainer(data=dict(packed=True), scan_layers=True),
        lambda: _jax_trainer(data=dict(packed=True), scan_layers=True)),
    "layers_not_divisible_by_pipe": _pipe_check("_validate", dict(SMALL, n_attn_layers=3),
                                                _mesh(pipe=2)),
    "ffn_kernel_with_pipe": _pipe_check("_validate", dict(SMALL, ffn_impl="pallas"),
                                        _mesh(pipe=2)),
    "negative_microbatches": _pipe_check("resolve_microbatches", _mesh(pipe=2), -1),
    "batch_does_not_split": _pipe_check("validate_local_batch", _mesh(pipe=2), 8, 4),
}


@pytest.mark.parametrize("what", list(REFUSALS))
def test_unported_parts_are_refused_by_name(what):
    """What JAX still refuses of parallel training, the port refuses with
    JAX's message, word for word: telemetry and more than one step a
    dispatch with a pipe axis, packed batches with the seq or pipe axis or
    the stacked layout, a layer count the pipe axis does not divide, the
    FFN kernel in a pipeline, negative microbatches, and a batch that does
    not split into data shards x microbatches. (The pipeline, packed
    batches and the stacked layout on a mesh, which this test refused by
    name while they were not ported, all run now.)"""
    port, jax_call = REFUSALS[what]
    with pytest.raises(ValueError) as want:
        jax_call()
    with pytest.raises(ValueError) as got:
        port()
    assert not isinstance(got.value, NotPortedError)
    assert str(got.value) == str(want.value)


def test_a_mesh_of_one_and_flat_params_on_a_sharded_mesh():
    """Alone, ``distributed`` is a mesh of one; ``flat_params`` with the
    model or expert axis is refused with JAX's message, before any rank
    is needed; a mesh that needs more ranks than there are is JAX's error."""
    samples = datasets.synth_ns2d(4, n_points=64)
    trainer = Trainer(Config(train=TrainConfig(distributed=True)),
                      ModelConfig(**dict(SMALL, n_expert=3)), samples, [], device="cpu")
    assert trainer.mesh.shape == dict(data=1, seq=1, model=1, expert=1, pipe=1)
    flat = dataclasses.replace(Config().optim, flat_params=True)
    for mesh in (MeshConfig(model=2), MeshConfig(expert=3)):
        with pytest.raises(ValueError, match="flat_params keeps the params as one replicated"):
            Trainer(Config(optim=flat, train=TrainConfig(distributed=True), mesh=mesh),
                    ModelConfig(**dict(SMALL, n_expert=3)), samples, [], device="cpu")
    with pytest.raises(ValueError, match="does not cover 1 devices"):
        Trainer(Config(train=TrainConfig(distributed=True), mesh=MeshConfig(model=2)),
                ModelConfig(**dict(SMALL, n_expert=3)), samples, [], device="cpu")


def test_param_rules_are_jax_s():
    """``_param_pspec`` gives JAX's spec for every param of the JAX tree."""
    model = JaxGNOT(JaxModelConfig(**SMALL))
    batch = next(iter(JaxLoader(jax_datasets.synth_ns2d(2, n_points=64), 2)))
    params = jax.eval_shape(lambda b: jax_trainer.init_params(model, b, 0), batch)
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        name = jax_mesh._path_str(path)
        assert mesh_lib._param_pspec(name, leaf.ndim) == tuple(
            jax_mesh._param_pspec(name, leaf)), name
    port = mesh_lib.param_specs(
        __import__("gnot_tpu_torch.models.gnot", fromlist=["GNOT"]).GNOT(
            ModelConfig(**SMALL)))
    assert port["block_0.ffn1.experts.dense_0.kernel"] == ("expert", None, "model")
    assert port["block_1.cross_attention.fc_out.kernel"] == ("model", None)
    assert port["gating.dense_0.kernel"] == (None, None)


def test_shard_samples_and_a_world_of_one_are_jax_s():
    samples = list(range(10))
    for i in range(3):
        assert multihost.shard_samples(samples, process_index=i, process_count=3) == \
            jax_multihost.shard_samples(samples, process_index=i, process_count=3)
    assert multihost.shard_samples(samples) == samples  # one node: the identity
    assert multihost.initialize("cpu") is None  # no torchrun environment
    assert (multihost.process_count(), multihost.process_index()) == (1, 0)
    assert multihost.sync_flag(True) and not multihost.sync_flag(False)
    assert multihost.all_agree("anything")
    np.testing.assert_array_equal(multihost.per_host_gauge(2.5), [2.5])
    assert multihost.backend_for("cpu", 4, 0) == "gloo"
    assert multihost.backend_for("cuda", 1, 1) == "nccl"
    assert multihost.backend_for("cuda", 2, 1) == "gloo"  # ranks share the card


def test_a_rank_s_block_of_the_batch_is_batch_pspecs_block():
    """``shard_batch`` (and ``global_batch``) keeps JAX's ``batch_pspecs``
    block of a node's batch: rows by the data coordinate within the node,
    mesh and function points by the seq coordinate; a stacked batch keeps
    its step axis whole."""
    batch = next(iter(Loader(datasets.synth_ns2d(8, n_points=64), 8)))
    shape = mesh_lib.mesh_shape(MeshConfig(data=4, seq=2), 8)
    for rank in range(8):
        # Two nodes of 4 ranks: data 4 = 2 nodes x 2 rows-blocks a node.
        mesh = mesh_lib.Mesh(shape, mesh_lib.rank_coords(shape, rank), {}, nodes=2)
        d, s = mesh.coords["data"] % 2, mesh.coords["seq"]
        got = multihost.global_batch(mesh, batch)
        rows, pts = slice(4 * d, 4 * d + 4), slice(32 * s, 32 * s + 32)
        assert torch.equal(got.coords, batch.coords[rows, pts])
        assert torch.equal(got.theta, batch.theta[rows])
        assert torch.equal(got.y, batch.y[rows, pts])
        assert torch.equal(got.node_mask, batch.node_mask[rows, pts])
        fpts = slice(32 * s, 32 * s + 32)  # funcs padded to 64 points
        assert torch.equal(got.funcs, batch.funcs[:, rows, fpts])
        assert torch.equal(got.func_mask, batch.func_mask[:, rows, fpts])
    stacked = stack_batches([batch, batch])
    got = mesh_lib.shard_batch(mesh, stacked, stacked=True)
    assert got.coords.shape == (2, 4, 32, 2)
    with pytest.raises(ValueError, match="does not split over 2 ranks"):
        mesh_lib.shard_batch(mesh, dataclasses.replace(batch, coords=batch.coords[:, :63]))


def test_node_sharding_keeps_every_node_s_strided_shard(monkeypatch):
    """On 2 nodes each keeps its strided shard of both splits, padded to the
    whole dataset's lengths; a split that does not divide is JAX's error."""
    args = port_main.build_parser().parse_args(["--distributed", "--synthetic", "elasticity"])
    cfg = port_main.train_config(args)
    train = datasets.synth_elasticity(8, seed=1)
    test = datasets.synth_elasticity(4, seed=2)
    monkeypatch.setattr(multihost, "node_count", lambda: 2)
    monkeypatch.setattr(multihost, "node_index", lambda: 1)
    got_cfg, got_train, got_test = port_main._node_shard(cfg, train, test)
    assert got_train == train[1::2] and got_test == test[1::2]
    assert (got_cfg.data.pad_nodes, got_cfg.data.pad_funcs) == fixed_pad_lengths(train + test)
    with pytest.raises(ValueError, match="n_test=3 must be divisible by the 2 processes"):
        port_main._node_shard(cfg, train, test[:3])


def test_a_managed_job_without_torchrun_env_is_refused(monkeypatch):
    monkeypatch.setenv("SLURM_NTASKS", "4")
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="SLURM_NTASKS=4"):
        multihost.initialize("cpu")


def test_device_id_and_serve_do_not_compose_with_distributed(capsys, monkeypatch):
    """``--device_id`` with ``--distributed`` is refused as before; ``--serve
    --distributed`` serves on one node (the serving tests below), and what
    JAX refuses of it raises JAX's ValueError, word for word, before any
    rank waits: several nodes (JAX: several processes), and replicas, the
    elastic pool or the federation on the trainer's mesh. JAX's messages
    come from its own ``_run_serve``, stopped at each check."""
    import types

    from gnot_tpu import main as jax_main
    from gnot_tpu.config import Config as JaxConfig
    from gnot_tpu.config import ServeConfig as JaxServeConfig

    with pytest.raises(SystemExit):
        port_main.main(["--distributed", "--device_id", "0", "--device", "cpu"])
    assert "--device_id pins a single device; drop --distributed" in capsys.readouterr().err

    def jax_refusal(processes: int, **serve) -> str:
        cfg = JaxConfig(serve=JaxServeConfig(**serve))
        trainer = types.SimpleNamespace(initialize=lambda: None, mesh="mesh")
        with monkeypatch.context() as m:
            m.setattr(jax, "process_count", lambda: processes)
            with pytest.raises(ValueError) as err:
                jax_main._run_serve(None, cfg, trainer, [], None, None)
        return str(err.value)

    base = ["--serve", "--distributed", "--device", "cpu"]
    cases = [(dict(processes=1, replicas=2), ["--serve_replicas", "2"]),
             (dict(processes=1, autoscale=True), ["--autoscale"]),
             (dict(processes=1, replicas=2, hosts=2), ["--serve_replicas", "2", "--hosts", "2"])]
    for serve, flags in cases:
        with pytest.raises(ValueError) as got:
            port_main.main(base + flags)
        assert not isinstance(got.value, NotPortedError)
        assert str(got.value) == jax_refusal(**serve)
    monkeypatch.setattr(multihost, "node_count", lambda: 2)
    with pytest.raises(ValueError) as got:
        port_main.main(base)
    assert not isinstance(got.value, NotPortedError)
    assert str(got.value) == jax_refusal(2)


def test_a_world_of_one_serves_bitwise_the_run_without_distributed():
    """``--serve --distributed`` alone is a serving mesh of one: its
    outputs are bitwise the run without ``--distributed`` (one pad shape:
    the NS2d graphs all have 64 points), with one dispatch shape and the
    mesh's counters in the summary; bf16 with the stacked layout is JAX's
    refusal."""
    argv = ["--serve", "--device", "cpu", "--synthetic", "ns2d", "--synth_size", "64",
            "--n_train", "4", "--n_test", "6", "--n_attn_layers", "1",
            "--n_attn_hidden_dim", "16", "--n_mlp_num_layers", "1", "--n_mlp_hidden_dim", "16",
            "--n_input_hidden_dim", "16", "--n_expert", "2", "--n_head", "2"]
    plain = port_main.run(argv)
    mesh = port_main.run(argv + ["--distributed"])
    assert [r.ok for r in mesh.results] == [True] * 6
    for a, b in zip(plain.results, mesh.results):
        assert np.array_equal(a.output, b.output)
    assert mesh.summary["compiled_shapes"] == 1
    assert mesh.summary["mesh"]["shape"] == dict(data=1, seq=1, model=1, expert=1, pipe=1)
    assert mesh.summary["mesh"]["weights"] == 1
    with pytest.raises(ValueError, match="serves the standard param layout only; drop "
                                         r"--scan_layers/--flat_params \(or serve float32\)"):
        port_main.run(argv + ["--distributed", "--scan_layers", "--serve_dtype", "bfloat16"])


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def test_mesh_serving_matches_jax_s_mesh_engine(ranks):
    """Serving on data2 x seq2 x model2: 16 requests all answered, each
    output within 1e-4 / 1e-5 of JAX's ``inference_engine()`` on the same
    mesh from the same weights, before and after a hot reload; one
    dispatch shape (the fixed pads); every rank ran every dispatch and
    both weight publishes."""
    res = [r["serve"] for r in ranks["results"]]
    got = res[0]
    want, want_reload = ranks["want"]["serve"]
    assert got["ok"] == [True] * 16 and got["reloaded"]
    for o, w in zip(got["outputs"], want):
        np.testing.assert_allclose(o, w, rtol=1e-4, atol=1e-5)
    for o, w in zip(got["reload_outputs"], want_reload):
        np.testing.assert_allclose(o, w, rtol=1e-4, atol=1e-5)
    assert max(_rel(a, b) for a, b in zip(want, want_reload)) > 1e-2  # the reload changed them
    summary = got["summary"]
    assert (summary["completed"], summary["compiled_shapes"], summary["reloads"]) == (16, 1, 1)
    assert got["stats"]["dispatches"] == summary["dispatches"] + 1  # and the warm-up
    assert got["stats"]["weights"] == 2
    for r in res[1:]:
        assert r["f32"]["dispatches"] == got["stats"]["dispatches"]
        assert r["f32"]["weights"] == 2


def test_a_sigterm_to_a_follower_alone_does_not_end_it(ranks):
    """Rank 3 got a SIGTERM after its second op: it recorded it, ran every
    later dispatch and left on rank 0's stop op, as every other follower."""
    follows = [r["serve"]["f32"] for r in ranks["results"][1:]]
    assert [f["sigterm"] for f in follows] == [i == 2 for i in range(7)]
    assert len({f["dispatches"] for f in follows}) == 1


def test_bf16_serving_on_a_mesh(ranks):
    """bf16 on data2 x seq2 x model2 (a cast copy of each rank's shards)
    against the port's single-device bf16 engine on the same pads and
    weights, and against the single-device f32 one at JAX's bf16 serving
    bar (2e-2 relative, ``tests/test_serve.py:1468``)."""
    got = ranks["results"][0]["serve"]
    for a, b, c in zip(got["bf16"], got["bf16_single"], got["f32_single"]):
        assert _rel(a, b) < BF16_MESH_REL
        assert _rel(a, c) < 2e-2


def test_packed_serving_on_a_mesh(ranks):
    """Packed dispatches on data2 x seq2 x model2 (the plan's rows a
    multiple of the data ranks, split over them; each seq rank holds every
    point of its rows) against the port's single-device packed engine, at
    the model bar; every follower ran them."""
    got = ranks["results"][0]["serve"]
    assert got["packed_rows"] % 2 == 0 and len(got["packed"]) == 8
    for a, b in zip(got["packed"], got["packed_single"]):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)
    assert {r["serve"]["packed"]["dispatches"] for r in ranks["results"][1:]} == {2}


def test_a_sigterm_to_rank_0_drains_every_rank(ranks):
    """``main --serve --distributed`` on every rank with a SIGTERM to rank
    0 as it submits its third request: rank 0 submits no more, answers the
    three, drains and sends the stop op; every follower ran every dispatch
    and returned."""
    res = [r["serve_sigterm"] for r in ranks["results"]]
    summary = res[0]["summary"]
    assert (summary["requests"], summary["completed"]) == (3, 3)
    for r in res[1:]:
        assert r["follower"]["dispatches"] == summary["mesh"]["dispatches"]


def test_a_dead_follower_makes_rank_0_raise_not_wait(ranks):
    """Rank 7 of a serving mesh dies after the weights op: rank 0's next
    dispatch raises (the lost connection, well inside the group's 60 s
    timeout), every later op raises at once without touching the group,
    and the other followers' waits end with an error, not at the
    timeout."""
    dead = ranks["dead"]
    assert dead[0]["dispatched"] == 0 and dead[0]["raised"] is not None
    assert dead[0]["raised_after_s"] < 30
    assert dead[0]["then"].startswith("the serving mesh failed earlier")
    for d in dead[1:]:
        assert d["raised"] is not None and d["after_s"] < 30


@pytest.mark.parametrize("case", ["parity_data2_seq2_model2", "parity_data2_model2_pipe2"])
def test_parity_step_on_a_mesh_matches_jax_single_device(ranks, case):
    """Parity mode (the reference's interleaved head merge, erf GELU, no
    masks) on data2 x seq2 x model2 and on data2 x model2 x pipe2: the merge
    gathers every head and point of a row, so one step is JAX's
    single-device parity step at ``tests/test_sharding.py``'s bars."""
    want_losses, want_params = ranks["want"]["parity"]
    losses = [r["cases"][case]["losses"] for r in ranks["results"]]
    assert all(l == losses[0] for l in losses)
    np.testing.assert_allclose(losses[0], want_losses, rtol=1e-5)
    _assert_params(ranks["results"][0]["cases"][case]["params"], want_params, 2e-4, 2e-5, case)


# -- the CLI: torchrun over 4 (2) ranks against JAX's main on 4 (2) devices --

BASE_CLI = ["--synthetic", "ns2d", "--synth_size", "64", "--n_train", "8", "--n_test", "8",
            "--batch_size", "4", "--epochs", "1", "--n_attn_layers", "2",
            "--n_attn_hidden_dim", "32", "--n_mlp_num_layers", "2", "--n_mlp_hidden_dim", "32",
            "--n_input_hidden_dim", "32", "--n_head", "4", "--n_expert", "4", "--no_preempt",
            "--distributed"]
CLI = BASE_CLI + ["--mesh_seq", "2", "--mesh_model", "2"]
PIPE_CLI = BASE_CLI + ["--mesh_pipe", "2"]
SERVE_CLI = ["--serve", "--distributed", "--mesh_data", "2", "--synthetic", "ns2d",
             "--synth_size", "64", "--n_train", "8", "--n_test", "8", "--batch_size", "4",
             "--n_attn_layers", "1", "--n_attn_hidden_dim", "16", "--n_mlp_num_layers", "1",
             "--n_mlp_hidden_dim", "16", "--n_input_hidden_dim", "16", "--n_expert", "2",
             "--n_head", "2"]
# bf16 serving on the mesh against the single-device bf16 engine: the
# model axis splits the hidden sums and the seq axis the Grams, each part
# rounded to bf16 where one device rounds the whole sum. Sound runs read
# 2.0e-3 to 2.6e-3 per request, as far as the single-device bf16 engine
# is from f32 (2.7e-3 to 3.2e-3).
BF16_MESH_REL = 1e-2
# The serve summary's keys that only the port's server writes.
PORT_SUMMARY_KEYS = {"dispatch_ms_p50", "dispatch_ms_max"}


# JAX's ``main`` with its ``init_params`` under one ``jax.jit``: bitwise the
# eager init (flax's init op by op compiles ~160 programs, ~15 s here).
JAX_MAIN = """
import runpy, sys
import jax
from gnot_tpu.train import trainer
eager = trainer.init_params
trainer.init_params = lambda model, batch, seed: jax.jit(lambda b: eager(model, b, seed))(batch)
sys.argv[0] = "gnot_tpu.main"
runpy.run_module("gnot_tpu.main", run_name="__main__")
"""


def _epoch_record(path):
    recs = [json.loads(l) for l in open(path)]
    return [r for r in recs if "train_loss" in r][-1]


def _console_epoch(out: str) -> dict:
    """The last epoch's train loss and test metric from the reference's
    console lines."""
    loss = [l for l in out.splitlines() if l.startswith("Epoch ") and ", Loss: " in l][-1]
    metric = [l for l in out.splitlines() if ", Test Metric: " in l][-1]
    return {"train_loss": float(loss.split(": ")[-1]),
            "test_metric": float(metric.split(": ")[-1])}


def _port_start(ckpt_dir, params, cli=CLI, stacked=False) -> list[str]:
    """A port ``latest`` checkpoint at epoch 0 holding JAX's initial weights
    for the CLI's model (what JAX's ``main`` draws from ``--seed``) and a
    fresh AdamW, in the stacked layout for a pipeline: the port's
    ``--resume`` then starts where JAX's run does. Returns the flags that
    read it."""
    args = port_main.build_parser().parse_args([*cli, "--device", "cpu"])
    samples = datasets.synth_ns2d(8, n_points=64)
    mc = port_main.model_config(args, samples)
    assert mc == ModelConfig(**SMALL, gelu="tanh")
    mc = dataclasses.replace(mc, scan_layers=stacked)
    trainer = Trainer(Config(), mc, samples, [], device="cpu")
    trainer.initialize()
    trainer.load_standard_params(params)
    ck = Checkpointer(str(ckpt_dir), extra_meta=port_main.checkpoint_meta(args, mc))
    ck.save_latest(trainer.checkpoint_state(), 0, float("inf"))
    ck.wait()
    return ["--checkpoint_dir", str(ckpt_dir), "--resume"]


def _popen(cmd, devices=4):
    env = dict(os.environ, OMP_NUM_THREADS="1", GNOT_DIST_TIMEOUT_S="60",
               JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={devices}")
    return subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _start_jax_cli(cli, devices):
    """JAX's ``main --distributed`` on ``devices`` host devices. Its console
    lines are read, not a metrics file: its ``run.json`` records package
    versions, which costs seconds."""
    return _popen([sys.executable, "-c", JAX_MAIN, *cli], devices)


def _start_port_cli(tmp_path, params, pipe=False):
    """``torchrun`` over the port's ranks with the same flags and JAX's
    initial weights, its metrics under ``tmp_path``: 4 ranks of ``CLI``, or
    2 of ``PIPE_CLI``."""
    cli, n = (PIPE_CLI, 2) if pipe else (CLI, 4)
    return _popen([sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", str(n),
                   "--master_port", str(torch_ranks.free_port()), "-m", "gnot_tpu_torch.main",
                   *cli, "--device", "cpu", "--metrics_path", str(tmp_path / "port" / "m.jsonl"),
                   *_port_start(tmp_path / "ck", params, cli, stacked=pipe)])


def _cli_outputs(procs: list) -> list[str]:
    outs = [p.communicate(timeout=180)[0] for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    return outs


def test_torchrun_cli_matches_jax_main_distributed(ranks):
    """``torchrun --nproc_per_node 4 -m gnot_tpu_torch.main --distributed
    --mesh_seq 2 --mesh_model 2 --device cpu`` against JAX's ``main
    --distributed`` with the same flags on 4 host devices (both meshes
    1 x 2 x 2): the final train loss and test metric at rtol 1e-5."""
    cli, tmp_path = ranks["cli"], ranks["cli_dir"] / "cli"
    jax_out, port_out = _cli_outputs([cli[0], cli[3]])
    assert "Distributed: backend=gloo ranks=4 nodes=1 device=cpu" in port_out
    want = _console_epoch(jax_out)
    got = _epoch_record(tmp_path / "port" / "m.jsonl")
    np.testing.assert_allclose(got["train_loss"], want["train_loss"], rtol=1e-5)
    np.testing.assert_allclose(got["test_metric"], want["test_metric"], rtol=1e-5)
    manifest = json.load(open(tmp_path / "port" / "run.json"))
    assert manifest["mesh"] == dict(data=1, seq=2, model=2, expert=1, pipe=1)
    assert (manifest["devices"]["process_count"], manifest["devices"]["process_index"]) == (4, 0)


def test_torchrun_pipe_cli_matches_jax_main_distributed(ranks):
    """``torchrun --nproc_per_node 2 -m gnot_tpu_torch.main --distributed
    --mesh_pipe 2`` against JAX's ``main --distributed --mesh_pipe 2`` on 2
    host devices (one block a stage, M = S = 2): the epoch's train loss and
    test metric within 1e-5."""
    cli, tmp_path = ranks["cli"], ranks["cli_dir"] / "pipe_cli"
    jax_out, port_out = _cli_outputs([cli[1], cli[4]])
    assert "Distributed: backend=gloo ranks=2 nodes=1 device=cpu" in port_out
    want = _console_epoch(jax_out)
    got = _epoch_record(tmp_path / "port" / "m.jsonl")
    np.testing.assert_allclose(got["train_loss"], want["train_loss"], rtol=1e-5)
    np.testing.assert_allclose(got["test_metric"], want["test_metric"], rtol=1e-5)
    manifest = json.load(open(tmp_path / "port" / "run.json"))
    assert manifest["mesh"] == dict(data=1, seq=1, model=1, expert=1, pipe=2)


def test_torchrun_serving_cli_matches_jax_main(ranks):
    """``torchrun --nproc_per_node 2 -m gnot_tpu_torch.main --serve
    --distributed --mesh_data 2 --device cpu`` against JAX's ``main --serve
    --distributed --mesh_data 2`` on 2 host devices: the same ``Serve: N/M
    ok`` count, the same key set of the ``serve_summary`` record (but the
    port's own two, ``server.py``'s ``dispatch_ms_*``), and the port's rank
    1 printing no summary of its own."""
    cli, tmp = ranks["cli"], ranks["cli_dir"]
    jax_out, port_out = _cli_outputs([cli[2], cli[5]])

    def served(out):
        (line,) = [l for l in out.splitlines() if l.startswith("Serve: ")]
        return line.split(",")[0]

    assert served(port_out) == served(jax_out) == "Serve: 8/8 ok"
    assert port_out.count('{"serve_summary"') == 1

    def summary(path):
        (rec,) = [r for r in map(json.loads, open(path)) if r.get("event") == "serve_summary"]
        return rec

    port_keys = set(summary(tmp / "port_serve" / "m.jsonl"))
    jax_keys = set(summary(tmp / "jax_serve" / "m.jsonl"))
    assert port_keys - PORT_SUMMARY_KEYS == jax_keys
    assert json.load(open(tmp / "port_serve" / "run.json"))["mesh"]["data"] == 2
