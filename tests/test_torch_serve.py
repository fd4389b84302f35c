"""The port's serving path: engine against the JAX engine, the server
core, and the CLI entry point in-process on the CPU."""

import json
import threading

import jax
import numpy as np
import pytest
import torch

from gnot_tpu.config import ModelConfig as JaxModelConfig
from gnot_tpu.data import datasets
from gnot_tpu.data.batch import collate as jax_collate
from gnot_tpu.models.gnot import GNOT as JaxGNOT
from gnot_tpu.serve.engine import InferenceEngine as JaxEngine
from gnot_tpu_torch import main as port_main
from gnot_tpu_torch.config import ModelConfig
from gnot_tpu_torch.interop import params_from_jax
from gnot_tpu_torch.models.gnot import GNOT
from gnot_tpu_torch.serve.batcher import Batcher
from gnot_tpu_torch.serve.engine import InferenceEngine
from gnot_tpu_torch.serve.server import InferenceServer

RTOL, ATOL = 1e-4, 1e-5
MAX_BATCH = 4
SMALL = dict(
    n_attn_layers=2,
    n_attn_hidden_dim=32,
    n_mlp_num_layers=2,
    n_mlp_hidden_dim=32,
    n_input_hidden_dim=32,
    n_expert=2,
    n_head=4,
)


def _two_bucket_samples():
    """ns2d meshes of 40 and 100 points: buckets (64, 64) and (128, 64)."""
    small = datasets.synth_ns2d(5, seed=1, n_points=40)
    large = datasets.synth_ns2d(4, seed=2, n_points=100)
    return [s for pair in zip(small, large) for s in pair] + small[4:]


def _engines(samples, ffn_impl):
    mc = dict(SMALL, **datasets.infer_model_dims(samples), ffn_impl=ffn_impl)
    jmodel = JaxGNOT(JaxModelConfig(**mc))
    b = jax_collate(samples[:2])
    params = jmodel.init(
        jax.random.key(0), b.coords, b.theta, b.funcs,
        node_mask=b.node_mask, func_mask=b.func_mask,
    )["params"]
    cfg = ModelConfig(**mc)
    port = GNOT(cfg)
    port.load_state_dict(params_from_jax(jax.device_get(params), cfg), strict=True)
    return (
        JaxEngine(jmodel, params, batch_size=MAX_BATCH),
        InferenceEngine(port, batch_size=MAX_BATCH),
    )


@pytest.mark.parametrize("ffn_impl", ["xla", "pallas"])
def test_engine_infer_and_predict_match_jax(ffn_impl):
    samples = _two_bucket_samples()
    jeng, peng = _engines(samples, ffn_impl)
    # One bucket per dispatch; short batches pad to MAX_BATCH rows.
    for group in (samples[0:1], samples[1:7:2]):
        key = peng.bucket_key(group[0])
        assert key == jeng.bucket_key(group[0])
        want = jeng.infer(group, pad_nodes=key[0], pad_funcs=key[1], rows=MAX_BATCH)
        got = peng.infer(group, pad_nodes=key[0], pad_funcs=key[1], rows=MAX_BATCH)
        assert len(got) == len(group)
        for g, w, s in zip(got, want, group):
            assert g.shape == (s.coords.shape[0], 1)
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)
    for g, w in zip(peng.predict(samples), jeng.predict(samples)):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)


def test_engine_validates_warms_and_swaps():
    samples = _two_bucket_samples()
    _, eng = _engines(samples, "xla")
    assert eng.warmup(samples, rows=MAX_BATCH) == 2
    assert eng.dispatch_shapes == 2
    key = eng.bucket_key(samples[0])
    a = eng.infer(samples[:1], pad_nodes=key[0], pad_funcs=key[1])[0]
    zeros = {k: torch.zeros_like(v) for k, v in eng.model.state_dict().items()}
    eng.swap_params(zeros)
    b = eng.infer(samples[:1], pad_nodes=key[0], pad_funcs=key[1])[0]
    assert not np.allclose(a, b)
    bad = samples[1]
    bad.coords = bad.coords.copy()
    bad.coords[3, 0] = np.inf
    with pytest.raises(ValueError, match="sample 0 has non-finite"):
        eng.validate([bad])


def test_batcher_flushes_by_size_and_age():
    b = Batcher(max_batch=2, max_wait_ms=10.0, key_fn=lambda r: r[0])
    b.add(("a", 1), 0.0)
    b.add(("b", 1), 0.001)
    assert b.pop_ready(0.002) == []
    b.add(("a", 2), 0.003)
    assert b.pop_ready(0.004) == [("a", [("a", 1), ("a", 2)])]
    assert b.next_flush_in(0.005) == pytest.approx(0.006)
    assert b.pop_ready(0.012) == [("b", [("b", 1)])]
    assert len(b) == 0 and b.next_flush_in(1.0) is None


def test_server_serves_two_buckets_without_mixing():
    samples = _two_bucket_samples()
    _, eng = _engines(samples, "pallas")
    batches = []
    infer = eng.infer

    def recording_infer(reqs, *, pad_nodes, pad_funcs, rows=None):
        batches.append(((pad_nodes, pad_funcs), [eng.bucket_key(s) for s in reqs]))
        return infer(reqs, pad_nodes=pad_nodes, pad_funcs=pad_funcs, rows=rows)

    eng.infer = recording_infer
    server = InferenceServer(eng, max_batch=MAX_BATCH, max_wait_ms=5.0, queue_limit=64).start()
    futures = [server.submit(s) for s in samples]
    results = [f.result(timeout=60) for f in futures]
    summary = server.drain(timeout_s=60)
    assert all(r.ok and r.reason == "ok" for r in results), [r.detail for r in results]
    assert summary["requests"] == summary["completed"] == len(samples)
    assert summary["dispatches"] == len(batches)
    for key, members in batches:
        assert all(m == key for m in members)
        assert len(members) <= MAX_BATCH
    assert {k for k, _ in batches} == {(64, 64), (128, 64)}
    assert summary["compiled_shapes"] <= 2
    for r, want in zip(results, eng.predict(samples)):
        np.testing.assert_allclose(r.output, want, rtol=1e-5, atol=1e-6)


def test_server_warms_up_on_its_worker_thread():
    samples = _two_bucket_samples()
    _, eng = _engines(samples, "xla")
    threads = []
    infer = eng.infer

    def recording_infer(reqs, **kw):
        threads.append(threading.current_thread().name)
        return infer(reqs, **kw)

    eng.infer = recording_infer
    server = InferenceServer(eng, max_batch=MAX_BATCH).start(warmup=samples)
    assert server.warmed == 2 and eng.dispatch_shapes == 2
    assert threads == ["gnot-torch-serve-worker"] * 2
    assert server.submit(samples[0]).result(timeout=60).ok
    assert server.drain(timeout_s=60)["dispatches"] == 1

    broken = InferenceServer(eng, max_batch=MAX_BATCH)
    eng.infer = lambda reqs, **kw: 1 / 0
    with pytest.raises(ZeroDivisionError):
        broken.start(warmup=samples[:1])
    # The worker is gone: a request admitted now resolves at drain.
    fut = broken.submit(samples[0])
    assert broken.drain(timeout_s=5)["completed"] == 0
    assert fut.result(timeout=5).reason == "rejected_draining"


def test_server_admission_fast_fails():
    samples = _two_bucket_samples()
    _, eng = _engines(samples, "xla")
    server = InferenceServer(eng, max_batch=MAX_BATCH, max_wait_ms=1.0, queue_limit=2)
    # Not started: the first two requests fill the queue, the third sheds.
    futures = [server.submit(s) for s in samples[:3]]
    assert futures[2].result(timeout=5).reason == "shed_queue_full"
    bad = samples[3]
    bad.theta = np.array([np.nan], np.float32)
    invalid = server.submit(bad).result(timeout=5)
    assert invalid.reason == "rejected_invalid" and "sample 0" in invalid.detail
    summary = server.drain(timeout_s=5)
    assert [f.result(timeout=5).reason for f in futures[:2]] == ["rejected_draining"] * 2
    assert server.submit(samples[0]).result(timeout=5).reason == "rejected_draining"
    assert summary["shed"]["shed_queue_full"] == 1
    assert summary["completed"] == 0


def test_main_serves_in_process_on_cpu(capsys):
    argv = [
        "--serve", "--device", "cpu", "--synthetic", "elasticity",
        "--synth_size", "40", "--n_test", "5", "--ffn_impl", "pallas",
        "--n_attn_layers", "2", "--n_attn_hidden_dim", "32",
        "--n_mlp_num_layers", "2", "--n_mlp_hidden_dim", "32",
        "--n_input_hidden_dim", "32", "--n_expert", "2", "--n_head", "4",
    ]
    assert port_main.main(argv) == 1.0
    out = capsys.readouterr().out
    # No --checkpoint_dir: fresh weights without the reference's note,
    # which it prints only for a directory that holds no checkpoint.
    assert "no restorable checkpoint" not in out
    line = out.strip().splitlines()[-1]
    summary = json.loads(line)["serve_summary"]
    assert summary["requests"] == summary["completed"] == 5
    assert summary["device"] == "cpu"
    assert summary["compiled_shapes"] <= summary["warmed_buckets"]


SERVE_SMALL = [
    "--n_attn_layers", "1", "--n_attn_hidden_dim", "16", "--n_mlp_num_layers", "1",
    "--n_mlp_hidden_dim", "16", "--n_input_hidden_dim", "16", "--n_expert", "2",
    "--n_head", "2", "--ffn_impl", "pallas", "--device", "cpu",
]


@pytest.mark.parametrize("data", ["synthetic", "pickle"])
def test_serve_serves_the_trained_checkpoint(data, tmp_path, capsys):
    """``--serve --checkpoint_dir D`` after a one-epoch training run into D
    serves the trained weights on the test split of ``datasets.load``
    (pickles included): every output equals the trained model's
    ``predict`` within the f32 model bar. Without a checkpoint it says
    so and serves fresh weights."""
    import pickle

    from gnot_tpu_torch.data.batch import MeshSample

    if data == "pickle":
        paths = []
        for name, seed, n in (("train", 1, 6), ("test", 2, 5)):
            records = [[s.coords, s.y, s.theta, s.funcs]
                       for s in datasets.synth_elasticity(n, seed=seed, base_points=40)]
            paths.append(tmp_path / f"{name}.pkl")
            paths[-1].write_bytes(pickle.dumps(records))
        data_argv = ["--train_data", str(paths[0]), "--test_data", str(paths[1])]
    else:
        data_argv = ["--synthetic", "elasticity", "--synth_size", "40",
                     "--n_train", "6", "--n_test", "5"]
    ck = tmp_path / "ck"
    argv = SERVE_SMALL + data_argv + ["--checkpoint_dir", str(ck)]
    trainer = port_main.run_train(port_main.build_parser().parse_args(argv + ["--epochs", "1"]))
    assert (ck / "best.pt").is_file()
    test_samples = trainer.test_loader.samples
    want = InferenceEngine(trainer.model, batch_size=MAX_BATCH).predict(test_samples)
    capsys.readouterr()

    run = port_main.run_serve(port_main.build_parser().parse_args(argv + ["--serve"]))
    assert run.summary["restored"] == "best"
    assert "no restorable checkpoint" not in capsys.readouterr().out
    assert len(run.results) == len(test_samples) == 5
    for r, s, t, w in zip(run.results, run.samples, test_samples, want):
        assert isinstance(s, MeshSample) and np.array_equal(s.coords, t.coords)
        assert r.ok, r.detail
        np.testing.assert_allclose(r.output, w, rtol=RTOL, atol=ATOL)

    fresh_argv = SERVE_SMALL + data_argv + ["--serve", "--checkpoint_dir", str(tmp_path / "none")]
    fresh = port_main.run_serve(port_main.build_parser().parse_args(fresh_argv))
    assert "note: no restorable checkpoint — serving fresh weights" in capsys.readouterr().out
    assert fresh.summary["restored"] == ""
    assert not np.allclose(fresh.results[0].output, want[0], rtol=RTOL, atol=ATOL)


def test_serve_restores_latest_when_there_is_no_best(tmp_path):
    from gnot_tpu_torch.train.checkpoint import Checkpointer

    ck = Checkpointer(str(tmp_path))
    assert ck.restore_best() is None and ck.restore_latest() is None
    ck.save_latest({"model": {"w": torch.ones(2)}}, 3, 0.5)
    assert ck.restore_best() is None
    ck.save_best({"model": {"w": torch.zeros(2)}}, 1, 0.25)
    state, epoch, best = ck.restore_best()
    assert (epoch, best) == (1, 0.25) and torch.equal(state["model"]["w"], torch.zeros(2))
    state, epoch, _ = ck.restore_latest()
    assert epoch == 3 and torch.equal(state["model"]["w"], torch.ones(2))


def test_main_serves_bf16_in_process_on_cpu(capsys):
    """``--serve_dtype bfloat16``: the summary names the dtype, every
    request completes with f32 outputs."""
    argv = SERVE_SMALL + ["--serve", "--synthetic", "elasticity", "--synth_size", "40",
                          "--n_test", "5", "--serve_dtype", "bfloat16"]
    args = port_main.build_parser().parse_args(argv)
    assert port_main.build_parser().parse_args([]).serve_dtype == "float32"
    run = port_main.run_serve(args)
    assert run.summary["dtype"] == "bfloat16"
    assert run.summary["completed"] == 5
    assert all(r.output.dtype == np.float32 for r in run.results)
    assert run.model.config.dtype == "float32"  # the caller's model stays f32
    with pytest.raises(SystemExit):
        port_main.build_parser().parse_args(["--serve_dtype", "float16"])


@pytest.mark.parametrize("serve_dtype", ["float32", "bfloat16"])
def test_serve_dtype_flag_reaches_the_model_as_in_jax_main(serve_dtype):
    """``--serve --dtype bfloat16``: the model config carries the compute
    dtype into the engine, as JAX's trainer config carries it into
    ``serve_model``. Served at float32, the bf16 model computes on its f32
    weights (the same forward as ``Trainer.predict``); served at bfloat16,
    on a bf16 copy of them. The caller's model keeps f32 weights."""
    from gnot_tpu_torch.models import precision

    argv = SERVE_SMALL + ["--serve", "--synthetic", "elasticity", "--synth_size", "40",
                          "--n_test", "4", "--dtype", "bfloat16", "--serve_dtype", serve_dtype]
    run = port_main.run_serve(port_main.build_parser().parse_args(argv))
    assert run.model.config.dtype == "bfloat16"
    assert {p.dtype for p in run.model.parameters()} == {torch.float32}
    assert run.summary["completed"] == 4 and run.summary["dtype"] == serve_dtype
    served = precision.serve_model(run.model, serve_dtype)
    assert (served is run.model) == (serve_dtype == "float32")
    want = InferenceEngine(run.model, batch_size=4, dtype=serve_dtype).predict(run.samples)
    for r, w in zip(run.results, want):
        np.testing.assert_allclose(r.output, w, rtol=1e-5, atol=1e-6)
