"""The port's training telemetry, tracing, sink and manifest against the
JAX package's: step records from the same carried weights and batches,
the key set of each parameter layout, training unchanged by telemetry,
a whole CLI run with all six observability flags against ``gnot_tpu.main``'s
(records, span tree, ``run.json``, ``tools/trace_report.py``), the NaN
watchdog, and the serving events and request spans."""

import dataclasses
import importlib.util
import json
import os

import jax
import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

from gnot_tpu import main as jax_main
from gnot_tpu import make_config
from gnot_tpu.config import ModelConfig as JaxModelConfig
from gnot_tpu.config import OptimConfig as JaxOptimConfig
from gnot_tpu.data import datasets as jax_datasets
from gnot_tpu.data.batch import Loader as JaxLoader
from gnot_tpu.models.gnot import GNOT as JaxGNOT
from gnot_tpu.obs import events as jax_events
from gnot_tpu.obs import telemetry as jax_telemetry
from gnot_tpu.obs import tracing as jax_tracing
from gnot_tpu.train import trainer as jax_trainer
from gnot_tpu_torch import main as port_main
from gnot_tpu_torch.config import Config, DataConfig, ModelConfig, OptimConfig, TrainConfig
from gnot_tpu_torch.data import datasets
from gnot_tpu_torch.data.batch import Loader
from gnot_tpu_torch.interop import params_from_jax
from gnot_tpu_torch.models.gnot import GNOT
from gnot_tpu_torch.obs.telemetry import TelemetryBuffer
from gnot_tpu_torch.obs.tracing import Tracer
from gnot_tpu_torch.serve.engine import InferenceEngine
from gnot_tpu_torch.serve.server import InferenceServer
from gnot_tpu_torch.train.trainer import Trainer, stack_batches
from gnot_tpu_torch.utils.metrics import MetricsSink

RTOL, ATOL = 1e-4, 1e-5  # the model-level bar (tests/test_pallas_ffn.py)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TINY = dict(
    n_attn_layers=2,
    n_attn_hidden_dim=16,
    n_mlp_num_layers=1,
    n_mlp_hidden_dim=16,
    n_input_hidden_dim=16,
    n_expert=3,
    n_head=2,
)
TINY_ARGS = [
    "--n_attn_layers", "2", "--n_attn_hidden_dim", "16",
    "--n_mlp_num_layers", "1", "--n_mlp_hidden_dim", "16",
    "--n_input_hidden_dim", "16", "--n_expert", "3", "--n_head", "2",
    "--synthetic", "elasticity", "--synth_size", "40",
    "--n_train", "8", "--n_test", "4", "--epochs", "2",
]
OBS_FLAGS = ["--telemetry", "--log_every", "1"]


class ListSink:
    def __init__(self):
        self.records = []

    def log(self, **record):
        self.records.append(record)

    def flush(self):
        pass


def read_jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def _step_records(records):
    return [{k: v for k, v in r.items() if k != "ts"} for r in records if "grad_norm" in r]


def _assert_records_close(got, want):
    assert [sorted(r) for r in got] == [sorted(r) for r in want]
    for g, w in zip(got, want):
        assert (g["step"], g["epoch"]) == (w["step"], w["epoch"])
        for key in g:
            np.testing.assert_allclose(np.asarray(g[key], np.float64), np.asarray(w[key], np.float64),
                                       rtol=RTOL, atol=ATOL, err_msg=f"step {g['step']} {key}")


# --- step records against JAX's telemetry step ---------------------------

# Each case is one JAX compile, so the axes share cases: the FFN kernel
# path (xla / pallas), masked / parity, --grad_accum 2, --steps_per_dispatch 2.
CASES = {
    "pallas_masked": ({"ffn_impl": "pallas"}, {}, 1),
    "xla_grad_accum_2": ({}, {"grad_accum": 2}, 1),
    "parity_steps_per_dispatch_2": ({"attention_mode": "parity"}, {}, 2),
}


@pytest.mark.parametrize("case", list(CASES))
def test_step_records_match_jax(case):
    """Four micro-steps on ragged elasticity batches (one bucket, 28-50
    points) from the same carried weights, at a different learning rate
    each: every step record of the port's TelemetryBuffer (loss, lr, the
    three norms, padding waste, each block's gate load and entropy)
    against JAX's buffer fed by JAX's telemetry step, at rtol 1e-4 / atol
    1e-5. JAX's Pallas FFN runs in interpret mode, the port's FFN its
    kernel's plain version. With --grad_accum 2 update_norm is 0 on the
    first micro-step of each window; with --steps_per_dispatch 2 each
    dispatch appends a stacked pair."""
    model_kw, optim_kw, k = CASES[case]
    samples = datasets.synth_elasticity(16, seed=7, base_points=40)
    jsamples = jax_datasets.synth_elasticity(16, seed=7, base_points=40)
    mc = dict(TINY, **datasets.infer_model_dims(samples), **model_kw)
    lrs = [1e-3, 8e-4, 5e-4, 3e-4]
    jbatches = list(JaxLoader(jsamples, 4, shuffle=True, seed=2))
    pbatches = list(Loader(samples, 4, shuffle=True, seed=2))
    assert len({b.signature() for b in pbatches}) == 1

    jmodel = JaxGNOT(JaxModelConfig(**mc))
    jopt = JaxOptimConfig(**optim_kw)
    state = jax_trainer.init_state(jmodel, jopt, jbatches[0], seed=0)
    params0 = jax.tree.map(np.array, jax.device_get(state.params))
    jsink = ListSink()
    jbuf = jax_telemetry.TelemetryBuffer(jsink, log_every=1)
    if k == 1:
        step = jax_telemetry.make_train_step(jmodel, jopt, "rel_l2")
        for i, (b, lr) in enumerate(zip(jbatches, lrs)):
            state, (loss, telem) = step(state, b, np.float32(lr))
            jbuf.append(steps=[i + 1], epoch=0, lrs=[lr], loss=loss, telem=telem, batches=[None])
    else:
        multi = jax_telemetry.make_multi_train_step(jmodel, jopt, "rel_l2")
        for g in (0, 2):
            state, (loss, telem) = multi(state, jax_trainer.stack_batches(jbatches[g:g + 2]),
                                         np.asarray(lrs[g:g + 2], np.float32))
            jbuf.append(steps=[g + 1, g + 2], epoch=0, lrs=lrs[g:g + 2], loss=loss,
                        telem=telem, batches=[None, None])
    jbuf.drain()

    cfg = Config(optim=OptimConfig(**optim_kw), data=DataConfig(n_train=16),
                 train=TrainConfig(epochs=1))
    port = Trainer(cfg, ModelConfig(**mc), samples, [], device="cpu")
    port.initialize()
    port.load_standard_params(params_from_jax(params0, port.model_cfg))
    psink = ListSink()
    pbuf = TelemetryBuffer(psink, log_every=1)
    if k == 1:
        for i, (b, lr) in enumerate(zip(pbatches, lrs)):
            telem = {}
            loss = port.train_step(b, lr, telem)
            pbuf.append(steps=[i + 1], epoch=0, lrs=[lr], loss=loss, telem=telem, batches=[None])
    else:
        for g in (0, 2):
            telem = {}
            loss = port.multi_train_step(stack_batches(pbatches[g:g + 2]), lrs[g:g + 2], telem)
            pbuf.append(steps=[g + 1, g + 2], epoch=0, lrs=lrs[g:g + 2], loss=loss,
                        telem=telem, batches=[None, None])
    pbuf.drain()

    got, want = _step_records(psink.records), _step_records(jsink.records)
    assert len(got) == 4 and "gate_load/block_1" in got[0]
    _assert_records_close(got, want)
    for r in got:
        np.testing.assert_allclose(sum(r["gate_load/block_0"]), 1.0, rtol=1e-5)
    if optim_kw.get("grad_accum") == 2:
        assert [r["update_norm"] == 0.0 for r in got] == [True, False, True, False]


LAYOUTS = {
    "flat": ({"optim.flat_params": True}, {}),
    "packed": ({"data.packed": True, "data.pack_chunk": 32}, {}),
    "stacked": ({}, {"scan_layers": True}),
}


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_layouts_give_jax_s_key_sets(layout):
    """The flat, packed and stacked layouts run an overridden forward in
    JAX, whose telemetry has the norm and padding keys only (its step's
    output structure, read with jax.eval_shape); one port step in the
    same layout gives the same keys."""
    fields, model_kw = LAYOUTS[layout]
    data = {"data.synthetic": "elasticity", "data.synth_size": 40, "data.n_train": 4,
            "data.n_test": 0}
    jcfg = make_config(**data, **fields, **{"train.telemetry": True, "train.epochs": 1,
                                            "train.graceful_preempt": False})
    train, _ = jax_datasets.load(jcfg.data)
    mc = dict(TINY, n_attn_layers=1, **datasets.infer_model_dims(train), **model_kw)
    jt = jax_trainer.Trainer(dataclasses.replace(jcfg, model=JaxModelConfig(**mc)),
                             JaxModelConfig(**mc), train, [])
    jt.initialize()
    _, (_, jtelem) = jax.eval_shape(jt.train_step, jt.state, next(iter(jt.train_loader)),
                                    np.float32(1e-3))

    cfg = Config(optim=OptimConfig(flat_params=layout == "flat"),
                 data=DataConfig(synthetic="elasticity", synth_size=40, n_train=4, n_test=0,
                                 packed=layout == "packed", pack_chunk=32))
    port_train, _ = datasets.load(cfg.data)
    port = Trainer(cfg, ModelConfig(**mc), port_train, [], device="cpu")
    port.initialize()
    telem = {}
    port.train_step(next(iter(port.train_loader)), 1e-3, telem)
    assert set(telem) == set(jtelem) == {"grad_norm", "update_norm", "param_norm",
                                         "padding_waste"}


# --- the CLI with all six flags, against gnot_tpu.main ---------------------


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """The same two-epoch training command through both packages with
    --telemetry --log_every 1 --metrics_path --trace_path --profile_dir
    and a checkpoint every epoch (ffn_impl xla)."""
    out = {}
    for name, entry in (("jax", jax_main.main), ("port", port_main.run)):
        d = tmp_path_factory.mktemp(name)
        argv = TINY_ARGS + OBS_FLAGS + [
            "--metrics_path", str(d / "m.jsonl"), "--trace_path", str(d / "t.json"),
            "--profile_dir", str(d / "prof"), "--checkpoint_dir", str(d / "ck"),
            "--checkpoint_every", "1",
        ] + (["--device", "cpu"] if name == "port" else [])
        out[f"{name}_result"] = entry(argv)
        out[name] = d
    return out


def test_telemetry_does_not_change_training(cli_runs, tmp_path, capsys):
    """The observed CLI run against the same command without the
    observability flags: every step loss, test metric and weight bitwise
    equal."""
    observed = cli_runs["port_result"]
    plain = port_main.run(TINY_ARGS + ["--device", "cpu", "--checkpoint_dir",
                                       str(tmp_path / "ck"), "--checkpoint_every", "1"])
    assert len(plain.history) == len(observed.history) == 2
    for a, b in zip(plain.history, observed.history):
        assert np.array_equal(a.step_losses, b.step_losses) and a.test_metric == b.test_metric
    for name, p in plain.model.state_dict().items():
        assert torch.equal(p, observed.model.state_dict()[name]), name
    assert plain._telemetry is None and observed._telemetry.drains == 4
    capsys.readouterr()


def test_cli_records_validate_under_jax_s_registry_with_jax_s_kinds(cli_runs):
    """Every record of the port's run validates under JAX's
    events.validate_record, and the record kinds and the key set of each
    kind equal those of the gnot_tpu.main run, apart from ts and values."""
    def shape(d):
        recs = read_jsonl(d / "m.jsonl")
        for r in recs:
            assert jax_events.validate_record(r) == [], r
        kinds = {}
        for r in recs:
            kind = r.get("event") or ("step" if "grad_norm" in r else "epoch")
            kinds.setdefault(kind, set()).add(frozenset(r) - {"ts"})
        return kinds, len(recs)

    assert shape(cli_runs["port"]) == shape(cli_runs["jax"])


def _tree(path):
    """One (name, parent name, which) per span in file order, per epoch."""
    events = json.load(open(path))["traceEvents"]
    by_id = {e["args"]["span_id"]: e for e in events}
    return [(e["name"], by_id[e["args"]["parent_id"]]["name"] if "parent_id" in e["args"] else None,
             e["args"].get("which"), e["args"]["trace_id"]) for e in events]


def test_cli_span_tree_is_jax_s(cli_runs):
    """Every span name is in JAX's SPANS; the span tree of each epoch
    (names, parents, the checkpoint's `which`, trace ids) equals JAX's."""
    got, want = _tree(cli_runs["port"] / "t.json"), _tree(cli_runs["jax"] / "t.json")
    assert {name for name, *_ in got} <= set(jax_events.SPANS)
    assert got == want
    assert [n for n, parent, *_ in got if parent is None] == ["epoch", "epoch"]
    assert {"data_iter", "step", "host_to_device", "step_dispatch", "telemetry_drain",
            "eval", "checkpoint_save"} <= {n for n, *_ in got}


def test_trace_report_reads_the_port_s_trace(cli_runs, capsys):
    spec = importlib.util.spec_from_file_location(
        "gnot_tool_trace_report", os.path.join(REPO, "tools", "trace_report.py"))
    trace_report = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(trace_report)
    path = str(cli_runs["port"] / "t.json")
    assert trace_report.main([path]) == 0
    rep = trace_report.report(path)
    assert rep["kinds"]["step"]["count"] == 4
    assert rep["critical_path"]["kind"] == "step"
    assert "critical path" in capsys.readouterr().out


def test_cli_run_json_and_profile(cli_runs):
    """run.json has JAX's top-level keys and names the run; the profile
    of epoch trace_at (1) is a Chrome trace with the trainer's ranges."""
    got = json.load(open(cli_runs["port"] / "run.json"))
    want = json.load(open(cli_runs["jax"] / "run.json"))
    assert set(got) == set(want)
    assert got["kind"] == "train" and got["devices"]["platform"] == "cpu"
    assert got["config"]["train"]["telemetry"] is True
    assert got["metrics_path"] == str(cli_runs["port"] / "m.jsonl")
    prof = json.load(open(cli_runs["port"] / "prof" / "epoch_1.trace.json"))
    names = {e.get("name") for e in prof["traceEvents"]}
    assert {"train_epoch", "eval_epoch", "step_dispatch", "data_iter"} <= names
    assert os.listdir(cli_runs["port"] / "prof") == ["epoch_1.trace.json"]


@pytest.mark.parametrize("flags,match", [
    (["--log_every", "2"], "--log_every needs --metrics_path"),
    (["--trace_sample_rate", "1.5"], "trace_sample_rate must be in"),
    (["--attention_impl", "pallas"], "attention_impl='pallas' was retired"),
])
def test_cli_refusals_are_jax_s(flags, match, capsys):
    with pytest.raises((SystemExit, ValueError)) as port_err:
        port_main.main(TINY_ARGS + flags + ["--device", "cpu"])
    with pytest.raises((SystemExit, ValueError)) as jax_err:
        jax_main.main(TINY_ARGS + flags)
    assert type(port_err.value) is type(jax_err.value)
    said = capsys.readouterr().err + str(port_err.value)
    assert match in said


def test_device_id_pins_a_card_and_is_refused_with_the_cpu(monkeypatch):
    with pytest.raises(ValueError, match="--device_id pins a CUDA device; drop --device cpu"):
        port_main.main(TINY_ARGS + ["--device_id", "0", "--device", "cpu"])
    args = port_main.build_parser().parse_args(["--device_id", "1"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="--device_id 1 out of range: 1 device"):
        port_main.run_device(args)


def test_cli_flags_have_jax_s_defaults():
    port = port_main.build_parser().parse_args([])
    ref = jax_main.build_parser().parse_args([])
    for flag in ("metrics_path", "log_every", "telemetry", "profile_dir", "trace_path",
                 "trace_sample_rate", "device_id", "attention_impl"):
        assert getattr(port, flag) == getattr(ref, flag), flag
    assert port.device == "cuda"


# --- the NaN watchdog (tests/test_obs.py:200, against the port) -------------


def test_nan_watchdog_localizes_and_records(tmp_path):
    """First non-finite loss: the re-run names the first module whose
    output is NaN, the sink gets the event record, the run stops."""
    train = datasets.synth_ns2d(8, n_points=16, seed=0)
    train[2].coords[0, 0] = np.nan  # poison one sample of batch 0
    test = datasets.synth_ns2d(4, n_points=16, seed=1)
    mp = str(tmp_path / "metrics.jsonl")
    cfg = Config(data=DataConfig(n_train=8, n_test=4, shuffle_train=False),
                 train=TrainConfig(epochs=1, telemetry=True, log_every=2, metrics_path=mp))
    mc = ModelConfig(n_attn_layers=1, n_attn_hidden_dim=16, n_mlp_num_layers=1,
                     n_mlp_hidden_dim=16, n_input_hidden_dim=16, n_expert=2, n_head=2,
                     **datasets.infer_model_dims(train))
    with MetricsSink(mp) as sink:
        trainer = Trainer(cfg, mc, train, test, metrics_sink=sink, device="cpu")
        with pytest.raises(FloatingPointError, match="epoch 0, step 1 .*gating.*: nan"):
            trainer.fit()
    recs = read_jsonl(mp)
    events = [r for r in recs if r.get("event") == "non_finite_loss"]
    assert len(events) == 1
    assert events[0]["step"] == 1 and events[0]["loss"] is None
    assert events[0]["detail"].startswith("gating.") and events[0]["detail"].endswith(": nan")
    for rec in recs:
        assert jax_events.validate_record(rec) == [], rec


# --- serving ---------------------------------------------------------------


def _server(sink=None, tracer=None, queue_limit=64):
    samples = datasets.synth_darcy2d(6, seed=0, grid_n=8)
    mc = ModelConfig(**TINY, **datasets.infer_model_dims(samples), ffn_impl="pallas")
    engine = InferenceEngine(GNOT(mc, generator=torch.Generator().manual_seed(0)), batch_size=2)
    return samples, InferenceServer(engine, max_batch=2, max_wait_ms=5.0, queue_limit=queue_limit,
                                    sink=sink, tracer=tracer)


def test_served_events_validate_and_chains_follow_jax_s_order(tmp_path):
    """shed (an invalid request, a full queue), queue_depth per dispatch
    and serve_summary at drain, each valid under JAX's registry; every
    completed request's spans are JAX's chain, in JAX's order, under one
    trace id, with queue_wait + dispatch equal to its latency; the
    queue_depth tokens add up to the summary's."""
    tracer = Tracer(path=str(tmp_path / "t.json"))
    mp = str(tmp_path / "serve.jsonl")
    with MetricsSink(mp) as sink:
        samples, server = _server(sink, tracer)
        server.start(warmup=samples[:1])
        futures = [server.submit(s) for s in samples]
        bad = dataclasses.replace(samples[0], coords=samples[0].coords * np.nan)
        assert server.submit(bad).result(timeout=60).reason == "rejected_invalid"
        results = [f.result(timeout=60) for f in futures]
        summary = server.drain(timeout_s=60)
    assert all(r.ok for r in results)
    recs = read_jsonl(mp)
    for r in recs:
        assert jax_events.validate_record(r) == [], r
    kinds = [r["event"] for r in recs]
    assert kinds.count("shed") == 1 and kinds[-1] == "serve_summary"
    depth = [r for r in recs if r["event"] == "queue_depth"]
    assert len(depth) == summary["dispatches"]
    buckets = summary["pad_waste_by_bucket"].values()
    assert sum(r["real_tokens"] for r in depth) == sum(b["real_tokens"] for b in buckets)
    assert sum(r["capacity_tokens"] for r in depth) == sum(b["capacity_tokens"] for b in buckets)
    chains = {}
    for s in tracer.snapshot():
        chains.setdefault(s.trace_id, []).append(s)
    assert len(chains) == len(samples) + 1
    for r, (trace, spans) in zip(results, sorted(chains.items())):
        # JAX's chain; by start time the dispatch span opens before the
        # phases it encloses (tests/test_tracing.py's relations).
        names = [s.name for s in sorted(spans, key=lambda s: (s.start, s.end))]
        assert sorted(names) == sorted(jax_tracing.SERVE_SPANS)
        assert names == ["admission", "queue_wait", "dispatch", "batch_assembly", "device",
                         "unpad", "resolve"]
        by = {s.name: s for s in spans}
        assert by["queue_wait"].start == by["admission"].start
        assert by["queue_wait"].end == by["dispatch"].start
        assert by["device"].end <= by["unpad"].end <= by["dispatch"].end == by["resolve"].start
        assert trace in by["dispatch"].args["member_trace_ids"]
        assert by["queue_wait"].duration_ms + by["dispatch"].duration_ms == pytest.approx(
            r.latency_ms, rel=1e-6, abs=1e-6)
    (rejected,) = [s for s in chains[max(chains)]]
    assert (rejected.name, rejected.args["reason"]) == ("admission", "rejected_invalid")
    assert summary["trace"]["kept"] == len(samples) + 1
    assert summary["queue_device_by_bucket"]


def test_the_drained_summary_is_a_valid_serve_summary():
    """The summary has every field JAX's serve_summary requires, under
    JAX's names, and the shed event of a full queue carries its depth."""
    sink = ListSink()
    samples, server = _server(sink, queue_limit=1)
    first = server.submit(samples[0])  # never dispatched: no worker yet
    assert server.submit(samples[1]).result(timeout=5).reason == "shed_queue_full"
    summary = server.drain(timeout_s=5)
    assert first.result(timeout=5).reason == "rejected_draining"
    assert jax_events.validate_record({"event": "serve_summary", **summary}) == []
    assert (summary["requests"], summary["admitted"], summary["completed"]) == (2, 1, 0)
    assert summary["shed"] == {"shed_queue_full": 1, "rejected_draining": 1}
    assert (summary["reloads"], summary["breaker_trips"]) == (0, 0)
    shed = [r for r in sink.records if r["event"] == "shed"]
    assert shed == [{"event": "shed", "reason": "shed_queue_full", "depth": 1, "limit": 1}]


def test_cli_serve_writes_events_and_a_trace(tmp_path, capsys):
    mp, tp = str(tmp_path / "m.jsonl"), str(tmp_path / "t.json")
    port_main.main(["--serve", "--device", "cpu", "--synthetic", "darcy2d", "--synth_size", "8",
                    "--n_test", "4", *TINY_ARGS[:14], "--metrics_path", mp, "--trace_path", tp])
    out = capsys.readouterr().out
    assert "Wrote 28 spans to" in out
    recs = read_jsonl(mp)
    for r in recs:
        assert jax_events.validate_record(r) == [], r
    assert [r["event"] for r in recs][-2:] == ["serve_summary", "trace_flush"]
    assert json.load(open(tmp_path / "run.json"))["kind"] == "serve"
