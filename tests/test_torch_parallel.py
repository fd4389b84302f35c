"""The port's parallel training against the JAX package's on the CPU.

One launch of 8 gloo ranks (``torch_ranks.py``) runs every multi-rank
scenario of this file: the sharded train step on four meshes, gradient
accumulation, the multi step, the flat layout on ``data4 x seq2``, the
ragged-tail eval, telemetry on a mesh, the stop agreement and the
restore-walk agreement. Each is held against JAX's single-device step from
the same carried weights at ``tests/test_sharding.py``'s bars. The mesh
checks and refusals run in this process, and the CLI test holds
``torchrun`` over 4 ranks against JAX's ``main --distributed`` on 4 host
devices."""

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
from gnot_tpu.parallel import multihost as jax_multihost
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
from gnot_tpu_torch.parallel import multihost
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
CASES = {
    "data2_seq2_model2": dict(mesh=DS2M2, steps="single", telemetry=True),
    "seq4_model2": dict(mesh=dict(data=1, seq=4, model=2), steps="single"),
    "data2_expert4": dict(mesh=dict(data=2, expert=4), steps="single"),
    "data2_model2_expert2": dict(mesh=dict(data=2, model=2, expert=2), steps="single",
                                 roundtrip=True),
    "grad_accum": dict(mesh=DS2M2, steps="two", over=dict(grad_accum=2)),
    "multi_step": dict(mesh=DS2M2, steps="multi", over=dict(steps_per_dispatch=2)),
    "flat_data4_seq2": dict(mesh=dict(data=4, seq=2), steps="single",
                            over=dict(flat_params=True)),
}


def _jax_params(batch):
    """JAX's model and its params from seed 0, built under one ``jax.jit``
    (bitwise flax's eager init, a third of the time)."""
    model = JaxGNOT(JaxModelConfig(**SMALL))
    params = jax.jit(lambda b: jax_trainer.init_params(model, b, 0))(batch)
    return model, jax.tree.map(np.array, jax.device_get(params))


def _jax_steps(step, params, optim, batches):
    """Losses and params after JAX's single-device steps from ``params``,
    one per batch (``step`` donates the state it is given)."""
    params = jax.tree.map(jnp.asarray, params)
    tx = jax_trainer.make_optimizer(optim, optim.lr)
    state = jax_trainer.TrainState(params=params, opt_state=tx.init(params),
                                   step=jnp.zeros((), jnp.int32))
    losses = []
    for batch, lr in zip(batches, LRS):
        state, loss = step(state, batch, np.float32(lr))
        losses.append(float(loss))
    return losses, flatten_tree(jax.device_get(state.params))


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
    # JAX's CLI run is the longest: it starts first; the ranks start before
    # their payload (JAX's weights) is written, and wait for it.
    cli = [_start_jax_cli()]
    launch = torch_ranks.Launch("train", 8, tmp / "payload.pt", tmp / "out")
    try:
        jbatches = list(JaxLoader(jax_datasets.synth_ns2d(16, n_points=64), 8))
        optim = JaxOptimConfig()
        model, params = _jax_params(jbatches[0])
        payload = dict(model=SMALL, lrs=LRS, cases=CASES, stop_dir=str(tmp / "stop"),
                       diverge=_diverge_dirs(tmp),
                       params=params_from_jax(params, ModelConfig(**SMALL)))
        torch_ranks.write_payload(payload, tmp / "payload.pt")
        cli.append(_start_port_cli(tmp / "cli", payload["params"]))
        want = {}
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
        yield dict(results=results, want=want, payload=payload, cli=cli, cli_dir=tmp / "cli")
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


def test_a_stop_on_one_rank_stops_every_rank_at_the_same_step(ranks):
    """SIGTERM on rank 5 alone: every rank stops after step 3, rank 0 saves
    ``latest`` at epoch 1, and a run resumed from it ends on the weights and
    losses of the stopped run carried on in memory, bitwise."""
    stops = [r["stop"] for r in ranks["results"]]
    assert {s["stop_step"] for s in stops} == {3}
    assert {s["stop_epochs"] for s in stops} == {1}
    assert stops[0]["latest"]["epoch"] == 1
    for s in stops:
        assert s["resumed"]["host_step"] == s["carried_on"]["host_step"] == 5
        assert s["resumed"]["loss"] == s["carried_on"]["loss"]
        for name, value in s["resumed"]["params"].items():
            assert torch.equal(value, s["carried_on"]["params"][name]), name


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
    with pytest.raises(NotPortedError, match="parity"):
        mesh_lib._validate_gspmd(
            ModelConfig(**dict(SMALL, attention_mode="parity", gelu="erf")),
            mesh_lib.Mesh(dict(shape, data=4, expert=1, seq=2), mesh_lib.rank_coords(shape, 0),
                          {}))


@pytest.mark.parametrize("what, mesh, over, match", [
    ("pipe", MeshConfig(pipe=2), {}, "--mesh_pipe 2"),
    ("microbatches", MeshConfig(microbatches=4), {}, "--microbatches 4"),
    ("packed", MeshConfig(), dict(packed=True), "--packed on a mesh"),
    ("scan_layers", MeshConfig(), dict(scan_layers=True), "--scan_layers on a GSPMD mesh"),
])
def test_unported_parts_are_refused_by_name(what, mesh, over, match):
    """The pipeline mesh, packed batches and the stacked layout on a mesh:
    NotPortedError naming the flag, the JAX lines and the ROADMAP item."""
    data = DataConfig(packed=over.get("packed", False))
    mc = ModelConfig(**dict(SMALL, scan_layers=over.get("scan_layers", False)))
    cfg = Config(data=data, train=TrainConfig(distributed=True), mesh=mesh)
    with pytest.raises(NotPortedError, match=match) as err:
        Trainer(cfg, mc, datasets.synth_ns2d(4, n_points=64), [], device="cpu")
    assert "ROADMAP.md" in str(err.value) and "gnot_tpu/" in str(err.value)


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
    from gnot_tpu.parallel import mesh as jax_mesh

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


def test_device_id_and_serve_do_not_compose_with_distributed(capsys):
    with pytest.raises(SystemExit):
        port_main.main(["--distributed", "--device_id", "0", "--device", "cpu"])
    assert "--device_id pins a single device; drop --distributed" in capsys.readouterr().err
    with pytest.raises(NotPortedError, match="--serve with --distributed"):
        port_main.main(["--distributed", "--serve", "--device", "cpu"])


# -- the CLI: torchrun over 4 ranks against JAX's main on 4 host devices -----

CLI = ["--synthetic", "ns2d", "--synth_size", "64", "--n_train", "8", "--n_test", "8",
       "--batch_size", "4", "--epochs", "1", "--n_attn_layers", "2", "--n_attn_hidden_dim",
       "32", "--n_mlp_num_layers", "2", "--n_mlp_hidden_dim", "32", "--n_input_hidden_dim",
       "32", "--n_head", "4", "--n_expert", "4", "--no_preempt", "--distributed",
       "--mesh_seq", "2", "--mesh_model", "2"]


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


def _port_start(ckpt_dir, params) -> list[str]:
    """A port ``latest`` checkpoint at epoch 0 holding JAX's initial weights
    for the CLI's model (what JAX's ``main`` draws from ``--seed``) and a
    fresh AdamW: the port's ``--resume`` then starts where JAX's run does.
    Returns the flags that read it."""
    args = port_main.build_parser().parse_args([*CLI, "--device", "cpu"])
    samples = datasets.synth_ns2d(8, n_points=64)
    mc = port_main.model_config(args, samples)
    assert mc == ModelConfig(**SMALL, gelu="tanh")
    trainer = Trainer(Config(), mc, samples, [], device="cpu")
    trainer.initialize()
    trainer.load_standard_params(params)
    ck = Checkpointer(str(ckpt_dir), extra_meta=port_main.checkpoint_meta(args, mc))
    ck.save_latest(trainer.checkpoint_state(), 0, float("inf"))
    ck.wait()
    return ["--checkpoint_dir", str(ckpt_dir), "--resume"]


def _popen(cmd):
    env = dict(os.environ, OMP_NUM_THREADS="1", GNOT_DIST_TIMEOUT_S="60",
               JAX_PLATFORMS="cpu", XLA_FLAGS="--xla_force_host_platform_device_count=4")
    return subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _start_jax_cli():
    """JAX's ``main --distributed`` on 4 host devices. Its console lines are
    read, not a metrics file: its ``run.json`` records package versions,
    which costs seconds."""
    return _popen([sys.executable, "-c", JAX_MAIN, *CLI])


def _start_port_cli(tmp_path, params):
    """``torchrun`` over 4 port ranks with the same flags and JAX's initial
    weights, its metrics under ``tmp_path``."""
    return _popen([sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", "4",
                   "--master_port", str(torch_ranks.free_port()), "-m", "gnot_tpu_torch.main",
                   *CLI, "--device", "cpu", "--metrics_path", str(tmp_path / "port" / "m.jsonl"),
                   *_port_start(tmp_path / "ck", params)])


def test_torchrun_cli_matches_jax_main_distributed(ranks):
    """``torchrun --nproc_per_node 4 -m gnot_tpu_torch.main --distributed
    --mesh_seq 2 --mesh_model 2 --device cpu`` against JAX's ``main
    --distributed`` with the same flags on 4 host devices (both meshes
    1 x 2 x 2): the final train loss and test metric at rtol 1e-5."""
    procs, tmp_path = ranks["cli"], ranks["cli_dir"]
    outs = [p.communicate(timeout=180)[0] for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    assert "Distributed: backend=gloo ranks=4 nodes=1 device=cpu" in outs[1]
    want = _console_epoch(outs[0])
    got = _epoch_record(tmp_path / "port" / "m.jsonl")
    np.testing.assert_allclose(got["train_loss"], want["train_loss"], rtol=1e-5)
    np.testing.assert_allclose(got["test_metric"], want["test_metric"], rtol=1e-5)
    manifest = json.load(open(tmp_path / "port" / "run.json"))
    assert manifest["mesh"] == dict(data=1, seq=2, model=2, expert=1, pipe=1)
    assert (manifest["devices"]["process_count"], manifest["devices"]["process_index"]) == (4, 0)
