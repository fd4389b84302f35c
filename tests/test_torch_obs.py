"""The port's observability units against the JAX package's: the event
registry, the metrics sink, ``run.json``, the span tracer, the health
monitors, the gate stats, the update norm and the telemetry buffer."""

import json
import math
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnot_tpu.models.layers import gate_stats as jax_gate_stats
from gnot_tpu.obs import events as jax_events
from gnot_tpu.obs import manifest as jax_manifest
from gnot_tpu.obs import tracing as jax_tracing
from gnot_tpu.obs.health import SlowStepMonitor as JaxSlowStepMonitor
from gnot_tpu.obs.telemetry import TelemetryBuffer as JaxTelemetryBuffer
from gnot_tpu_torch.models.layers import gate_stats
from gnot_tpu_torch.obs import events, health, manifest, tracing
from gnot_tpu_torch.obs.telemetry import TelemetryBuffer, adamw_update_norm, global_norm
from gnot_tpu_torch.utils.metrics import MetricsSink

RTOL, ATOL = 1e-4, 1e-5  # the model-level bar (tests/test_pallas_ffn.py)


def read_jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


class FakeClock:
    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def tick(self, dt: float) -> float:
        self.t += dt
        return self.t


# --- the registry (obs/events.py) ----------------------------------------


def test_event_specs_are_jax_s():
    """Every kind the port emits is JAX's kind, with JAX's required and
    optional fields; every span the port records has JAX's name; the
    tracer's taxonomy tuples are JAX's."""
    for kind, spec in events.EVENTS.items():
        want = jax_events.EVENTS[kind]
        assert (spec.fields, spec.optional) == (want.fields, want.optional), kind
        assert spec.module.startswith("gnot_tpu_torch/")
    # The server's rollout sessions and tenant quotas emit these three.
    assert {"rollout_step", "session_snapshot", "tenant_quota_shed"} <= set(events.EVENTS)
    # Every JAX kind but the two with no eager-PyTorch meaning (AOT
    # snapshots, jit recompiles); native_packer is emitted at serve start.
    assert set(jax_events.EVENTS) - set(events.EVENTS) == {"aot_prewarm", "recompile"}
    assert set(events.SPANS) <= set(jax_events.SPANS)
    assert tracing.SERVE_SPANS == jax_tracing.SERVE_SPANS
    assert tracing.TRAIN_SPANS == jax_tracing.TRAIN_SPANS
    # Besides the request and train chains, the server's reload span and
    # the router's replica_warm span (both on the tracer's "r" stream, as
    # JAX's), and the federation controller's three cluster spans.
    assert set(events.SPANS) == (set(tracing.SERVE_SPANS + tracing.TRAIN_SPANS)
                                 | {"reload", "replica_warm", "placement",
                                    "cluster_request", "cluster_rollout"})


@pytest.mark.parametrize("record", [
    {"step": 1, "loss": 0.5},
    {"event": "shed", "reason": "shed_queue_full"},
    {"event": "shed"},
    {"event": "recompile", "epoch": 0},
    {"event": "trace_flush", "path": "t.json", "spans": 3},
], ids=["metric", "valid", "missing", "not_emitted", "missing_dropped"])
def test_validate_record_agrees_with_jax(record):
    got = events.validate_record(record)
    want = jax_events.validate_record(record)
    if record.get("event") == "recompile":  # a kind the port never emits
        assert got == ["unknown event kind 'recompile'"] and want == []
    else:
        assert got == want


# --- the sink (utils/metrics.py), mirroring tests/test_obs.py:521-546 ----


def test_metrics_sink_context_manager_closes_on_error(tmp_path):
    path = str(tmp_path / "m.jsonl")
    with pytest.raises(RuntimeError):
        with MetricsSink(path) as sink:
            sink.log(a=1)
            raise RuntimeError("mid-run crash")
    assert sink._fh.closed
    assert read_jsonl(path)[0]["a"] == 1
    sink.close()  # idempotent


def test_metrics_sink_coerces_arrays_tensors_and_nonfinite(tmp_path):
    path = str(tmp_path / "m.jsonl")
    with MetricsSink(path) as sink:
        sink.log(
            vec=np.asarray([1.0, np.nan, np.inf]),
            scalar0d=np.asarray(2.5),
            tensor=torch.tensor([0.5, 1.5]),
            tensor0d=torch.tensor(float("inf")),
            nested=[np.float32(1.0), float("nan"), {"n": np.int64(3)}],
        )
    rec = read_jsonl(path)[0]
    assert rec["vec"] == [1.0, None, None]
    assert rec["scalar0d"] == 2.5
    assert rec["tensor"] == [0.5, 1.5]
    assert rec["tensor0d"] is None
    assert rec["nested"] == [1.0, None, {"n": 3}]
    assert isinstance(rec["ts"], float)


# --- run.json (obs/manifest.py) ----------------------------------------


def test_manifest_has_jax_s_top_level_keys(tmp_path):
    from gnot_tpu_torch.config import Config, ModelConfig

    got = manifest.write_manifest(str(tmp_path / "run.json"), config=Config(),
                                  model_config=ModelConfig(), device="cpu", argv=["--x"])
    want = jax_manifest.build_manifest(config=None, argv=[])
    assert set(got) == set(want)
    assert json.load(open(tmp_path / "run.json"))["argv"] == ["--x"]
    assert got["devices"]["platform"] == "cpu" and got["mesh"] is None
    assert set(got["versions"]) == {"torch", "cuda", "numpy"}
    assert got["compile_cache"]["dir"].endswith(os.path.join("build", "gnot_tpu_torch"))
    assert got["config"]["train"]["trace_sample_rate"] == 1.0
    assert "rev" in got["git"] and "dirty" in got["git"]


def test_manifest_does_not_clobber_other_runs(tmp_path):
    """tests/test_obs.py::test_manifest_does_not_clobber_other_runs, run
    against the port: a second run in the directory writes
    <metrics-stem>.run.json; a re-run of the same metrics file keeps
    run.json."""
    mp1 = str(tmp_path / "train.jsonl")
    p1 = manifest.manifest_path_for(mp1)
    assert os.path.basename(p1) == "run.json"
    manifest.write_manifest(p1, device="cpu", extra={"metrics_path": mp1, "kind": "train"})
    assert manifest.manifest_path_for(mp1) == p1
    mp2 = str(tmp_path / "bench.jsonl")
    p2 = manifest.manifest_path_for(mp2)
    assert os.path.basename(p2) == "bench.run.json"
    assert jax_manifest.manifest_path_for(mp2) == p2  # the same rule
    manifest.write_manifest(p2, device="cpu", extra={"metrics_path": mp2, "kind": "bench"})
    assert json.load(open(p1))["kind"] == "train"
    assert json.load(open(p2))["kind"] == "bench"


# --- the tracer (obs/tracing.py) -----------------------------------------


@pytest.mark.parametrize("rate", [1.0, 0.25, 0.4, 0.0])
def test_head_sampling_keeps_jax_s_trace_ids(rate):
    """Two interleaved streams at one rate: the port keeps exactly the
    trace ids JAX's Tracer keeps."""
    port, ref = tracing.Tracer(sample_rate=rate), jax_tracing.Tracer(sample_rate=rate)
    streams = ["t", "t", "r", "t", "r", "t", "t", "t", "r", "t", "t", "t", "t"]
    got = [port.start_trace(stream=s) for s in streams]
    assert got == [ref.start_trace(stream=s) for s in streams]
    assert port.coverage() == ref.coverage()


def test_spans_nest_export_and_flush_as_jax_s(tmp_path):
    """The same span program on both tracers with fake clocks: the same
    Chrome trace events (names, times, ids, parents, args), and the flush
    writes a registry-valid trace_flush event."""
    docs = []
    for mod in (tracing, jax_tracing):
        clk = FakeClock()
        tr = mod.Tracer(path=str(tmp_path / f"{mod.__name__}.json"), clock=clk)
        t = tr.start_trace()
        with tr.span("epoch", trace=t, args={"epoch": 0}):
            for _ in tr.timed_iter([1, 2], "data_iter", trace=t):
                clk.tick(0.001)
                with tr.span("step", args={"step": 1}):
                    with tr.span("host_to_device"):
                        clk.tick(0.002)
        tr.add_span("queue_wait", 1.0, 1.5, trace=t, args={"bucket": "64x64"})
        mp = str(tmp_path / f"{mod.__name__}.jsonl")
        with MetricsSink(mp) as sink:
            tr.flush(sink=sink)
        (flush,) = read_jsonl(mp)
        assert jax_events.validate_record(flush) == []
        doc = json.load(open(tr.path))
        for e in doc["traceEvents"]:
            e.pop("tid"), e.pop("pid")
        docs.append(doc)
    assert docs[0]["traceEvents"] == docs[1]["traceEvents"]
    assert {k: v for k, v in docs[0]["otherData"].items() if k != "generator"} == {
        k: v for k, v in docs[1]["otherData"].items() if k != "generator"}


def test_bounded_buffer_and_unsampled_spans():
    tr = tracing.Tracer(max_spans=2, clock=FakeClock(), sample_rate=0.5)
    assert tr.start_trace() is None
    with tr.span("x", trace=None) as s:
        assert s is None
    t = tr.start_trace()
    for _ in range(5):
        tr.add_span("s", 0.0, 1.0, trace=t)
    assert len(tr.snapshot()) == 2 and tr.dropped == 3
    with pytest.raises(ValueError, match="sample_rate"):
        tracing.Tracer(sample_rate=1.5)


def test_percentiles_are_jax_s():
    rng = np.random.default_rng(0)
    for values in ([], [3.0], list(rng.exponential(5.0, 37))):
        assert tracing.percentiles(values) == jax_tracing.percentiles(values)


def test_annotate_marks_each_span_in_the_profile():
    from torch.profiler import ProfilerActivity, profile

    tr = tracing.Tracer(annotate=True)
    t = tr.start_trace()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tr.span("epoch", trace=t):
            with tr.span("step_dispatch"):
                torch.ones(4).sum()
    names = {e.key for e in prof.key_averages()}
    assert {"epoch", "step_dispatch"} <= names


# --- health (obs/health.py) ----------------------------------------------


def test_slow_step_monitor_flags_outliers_as_jax_s():
    """tests/test_obs.py:466, and the same series through JAX's monitor."""
    series = [50.0] + [0.1] * 10 + [1.0, 0.1, 0.35, 0.29]
    port, ref = health.SlowStepMonitor(factor=3.0, warmup=5), JaxSlowStepMonitor(3.0, 5)
    got = [port.observe(dt) for dt in series]
    assert got == [ref.observe(dt) for dt in series]
    assert all(o is None for o in got[:11])
    assert got[11]["slowdown"] > 3.0 and got[11]["median_s"] == pytest.approx(0.1)
    assert got[12] is None
    defaults = health.SlowStepMonitor()
    assert (defaults.factor, defaults.warmup, defaults.window) == (3.0, 10, 256)
    with pytest.raises(ValueError, match="factor"):
        health.SlowStepMonitor(factor=1.0)


def test_localize_nan_names_the_first_non_finite_module():
    model = torch.nn.Sequential(torch.nn.Linear(2, 3), torch.nn.Tanh(), torch.nn.Linear(3, 1))

    def loss_fn(x):
        return model(x).pow(2).mean()

    assert health.localize_nan(model, loss_fn, torch.ones(4, 2)) is None
    x = torch.ones(4, 2)
    x[1, 0] = float("nan")
    assert health.localize_nan(model, loss_fn, x) == "0: nan"
    x[1, 0] = float("inf")
    with torch.no_grad():
        model[0].weight.fill_(1.0)
    assert health.localize_nan(model, loss_fn, x) == "0: inf"
    assert health.localize_nan(model, lambda x: model(x).sum() * float("nan"),
                               torch.ones(4, 2)) == "loss: nan"


# --- gate stats and norms --------------------------------------------------


def test_gate_stats_uniform_and_masked():
    """tests/test_obs.py:34-57 against the port."""
    e = 4
    out = gate_stats(torch.full((2, 8, e), 1.0 / e), None)
    np.testing.assert_allclose(out["gate_load"].numpy(), np.full(e, 1 / e), rtol=1e-6)
    assert float(out["gate_entropy"]) == pytest.approx(math.log(e), rel=1e-6)
    out = gate_stats(torch.tensor([[[1.0, 0.0], [0.0, 1.0]]]), torch.tensor([[1.0, 0.0]]))
    np.testing.assert_allclose(out["gate_load"].numpy(), [1.0, 0.0], atol=1e-6)
    assert float(out["gate_entropy"]) == pytest.approx(0.0, abs=1e-5)


@pytest.mark.parametrize("masked", [True, False], ids=["masked", "parity"])
def test_gate_stats_match_jax(masked):
    """Random softmaxed scores [3, 17, 3] with a ragged mask (or none):
    the load vector and the entropy at the model-level bar."""
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((3, 17, 3)).astype(np.float32) * 3
    scores = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    mask = (np.arange(17)[None] < np.array([[17], [9], [1]])).astype(np.float32)
    got = gate_stats(torch.from_numpy(scores), torch.from_numpy(mask) if masked else None)
    want = jax_gate_stats(jnp.asarray(scores), jnp.asarray(mask) if masked else None)
    for key in ("gate_load", "gate_entropy"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=RTOL, atol=ATOL)


def test_adamw_update_norm_is_the_transform_s_update():
    """The update norm read from the optimizer's state against the
    transform's update (what optax returns, before it is added to the
    weights), computed in float64 from the same f32 state, after each of
    three steps with weight decay. ``p_new - p_old`` reads the update
    after its rounding into unit-scale f32 weights instead: at this
    learning rate (the OneCycle start, 1e-3 / 25) that is up to ~4e-4
    off, beyond the model-level bar, so the port reads the state."""
    torch.manual_seed(0)
    params = [torch.nn.Parameter(torch.randn(64, 32)), torch.nn.Parameter(torch.randn(32))]
    lr, wd = 4e-5, 0.01
    opt = torch.optim.AdamW(params, lr=lr, weight_decay=wd, foreach=True, fused=False)
    rounding = []
    for step in range(1, 4):
        for p in params:
            p.grad = torch.randn_like(p)
        old = [p.detach().clone() for p in params]
        opt.step()
        bc1, bc2 = 1 - 0.9**step, 1 - 0.999**step
        want = math.sqrt(sum(
            float(((lr * wd * o.double() + lr / bc1 * st["exp_avg"].double()
                    / (st["exp_avg_sq"].double().sqrt() / math.sqrt(bc2) + 1e-8)) ** 2).sum())
            for o, st in ((o, opt.state[p]) for o, p in zip(old, params))))
        got = float(adamw_update_norm(opt))
        rounded = float(global_norm([p.detach() - o for p, o in zip(params, old)]))
        assert got == pytest.approx(want, rel=1e-6)
        rounding.append(abs(rounded - want) / want)
    assert max(rounding) > RTOL


# --- the buffer (obs/telemetry.py) ------------------------------------------


def test_telemetry_buffer_drains_on_window_and_flush(tmp_path):
    """tests/test_obs.py:499 against the port, beside JAX's buffer fed the
    same values: the same records."""
    recs = []
    for mod, arr in ((TelemetryBuffer, torch.tensor), (JaxTelemetryBuffer, jnp.asarray)):
        mp = str(tmp_path / f"{mod.__module__}.jsonl")
        with MetricsSink(mp) as sink:
            buf = mod(sink, log_every=2)
            for s in range(1, 4):
                buf.append(steps=[s], epoch=0, lrs=[1e-3], loss=arr(float(s)),
                           telem={"grad_norm": arr(0.5), "gate_load/block_0": arr([0.25, 0.75])},
                           batches=[None])
            # 3 appended, window 2: steps 1-2 drained, step 3 pending.
            assert [r["step"] for r in read_jsonl(mp)] == [2]
            buf.drain()  # the epoch-end flush
        recs.append([{k: v for k, v in r.items() if k != "ts"} for r in read_jsonl(mp)])
    assert recs[0] == recs[1] == [{"step": 2, "epoch": 0, "loss": 2.0, "lr": 1e-3,
                                   "grad_norm": 0.5, "gate_load/block_0": [0.25, 0.75]}]


def test_telemetry_buffer_unstacks_a_k_step_dispatch_and_fires_the_watchdog(tmp_path):
    fired = []
    mp = str(tmp_path / "m.jsonl")
    with MetricsSink(mp) as sink:
        buf = TelemetryBuffer(sink, log_every=1, on_nonfinite=lambda *a: fired.append(a))
        buf.append(steps=[1, 2], epoch=3, lrs=[1e-3, 2e-3],
                   loss=torch.tensor([0.5, float("nan")]),
                   telem={"grad_norm": torch.tensor([1.0, 2.0]),
                          "gate_load/block_0": torch.tensor([[0.5, 0.5], [1.0, 0.0]])},
                   batches=["b1", "b2"])
    recs = read_jsonl(mp)
    assert [(r["step"], r["loss"], r["lr"], r["grad_norm"], r["gate_load/block_0"])
            for r in recs] == [(1, 0.5, 1e-3, 1.0, [0.5, 0.5]), (2, None, 2e-3, 2.0, [1.0, 0.0])]
    assert len(fired) == 1 and fired[0][0] == 2 and fired[0][1] == 3
    assert math.isnan(fired[0][2]) and fired[0][3] == "b2"
    assert buf.drains == 1


def test_the_metrics_registry_tap_is_refused_by_name():
    """The registry tap is ported: a registry gets JAX's two series by
    name; an object that is no registry is refused, as JAX's buffer
    refuses it."""
    from gnot_tpu.obs.metrics import MetricsRegistry as JaxRegistry
    from gnot_tpu_torch.obs.metrics import MetricsRegistry

    names = {}
    for buf_cls, reg in ((TelemetryBuffer, MetricsRegistry()),
                         (JaxTelemetryBuffer, JaxRegistry())):
        buf_cls(None, 1, metrics=reg)
        names[buf_cls] = sorted(reg.snapshot())
        with pytest.raises(AttributeError, match="histogram"):
            buf_cls(None, 1, metrics=object())
    assert names[TelemetryBuffer] == names[JaxTelemetryBuffer] == [
        "train_slow_steps_total", "train_step_time_ms"]
