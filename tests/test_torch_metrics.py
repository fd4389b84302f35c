"""The port's live metrics plane (``gnot_tpu_torch/obs/metrics.py``) against
the JAX package's: the same observations give the same histogram states
and percentiles, merges, deltas, exposition text, SLO edges, publisher
rows and summary checks; the serve summary's latency percentiles are the
histogram's (fault 7); and the training loop's tap."""

import math
import os

import numpy as np
import pytest

from gnot_tpu.obs import metrics as jax_metrics
from gnot_tpu.serve.server import InferenceServer as JaxServer
from gnot_tpu_torch.obs import metrics
from gnot_tpu_torch.serve.server import InferenceServer

PACKAGES = {"jax": jax_metrics, "port": metrics}


class FakeClock:
    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


class ListSink:
    def __init__(self):
        self.records = []

    def log(self, **record):
        self.records.append(record)

    def flush(self):
        pass


class StubEngine:
    """An engine without a model: one-bucket requests whose forward takes
    ``next_ms`` on the fake clock and returns zeros of the sample's shape."""

    dtype = "float32"
    compiled_shapes = dispatch_shapes = 1

    def __init__(self, clock: FakeClock):
        self.clock = clock
        self.next_ms = 0.0

    def validate(self, samples):
        pass

    @staticmethod
    def bucket_key(sample):
        return (64, 64)

    def warmup(self, samples, rows=None):
        return 0

    def infer(self, samples, *, pad_nodes, pad_funcs, rows=None, timings=None, clock=None):
        self.clock.t += self.next_ms / 1e3
        return [np.zeros((s.coords.shape[0], 1), np.float32) for s in samples]


def _sample():
    from gnot_tpu_torch.data.batch import MeshSample

    return MeshSample(coords=np.zeros((8, 2), np.float32), y=np.zeros((8, 1), np.float32),
                      theta=np.zeros((1,), np.float32), funcs=[])


#: Ten completed latencies (ms): the nearest rank gives p50 = 14, p99 = 400.
FAULT7_MS = [10.0, 11.0, 12.0, 13.0, 14.0, 15.0, 16.0, 17.0, 18.0, 400.0]


def _serve_latencies(server_cls, start_kw) -> tuple[dict, list[float]]:
    """Submit-and-wait each request of FAULT7_MS through a server on a fake
    clock, the stub forward taking that many ms."""
    clock = FakeClock()
    engine = StubEngine(clock)
    server = server_cls(engine, max_batch=1, max_wait_ms=0.0, clock=clock).start(**start_kw)
    lats = []
    for ms in FAULT7_MS:
        engine.next_ms = ms
        r = server.submit(_sample()).result(timeout=30)
        assert r.ok, r
        lats.append(r.latency_ms)
    return server.drain(timeout_s=30), lats


def test_fault7_summary_latency_percentiles_are_jax_s_histogram_estimates():
    """The serve summary's p50 / p99 of ten completed latencies are JAX's
    ``LogHistogram`` estimates, exactly (the port read ``np.percentile``,
    which interpolates: p50 14.5, p99 365.62, 8.6% from the nearest rank
    400, outside JAX's own 5.93% bound)."""
    got, lats = _serve_latencies(InferenceServer, {})
    want, jax_lats = _serve_latencies(JaxServer, {})
    assert lats == jax_lats
    h = jax_metrics.LogHistogram()
    for v in lats:
        h.record(v)
    assert got["latency_p50_ms"] == h.percentile(0.50) == want["latency_p50_ms"]
    assert got["latency_p99_ms"] == h.percentile(0.99) == want["latency_p99_ms"]
    assert got["latency_p50_ms"] == pytest.approx(13.335, abs=1e-3)
    assert got["latency_p99_ms"] == pytest.approx(400.0, rel=1e-9)
    assert abs(got["latency_p99_ms"] - 400.0) / 400.0 <= jax_metrics.REL_ERROR


# --- LogHistogram, Reservoir, the registry ---------------------------------


def _lognormal(seed: int, n: int = 10_000) -> np.ndarray:
    rng = np.random.default_rng(seed)
    # Latencies over ~3 decades, a few beyond the bounds on either side.
    v = np.exp(rng.normal(loc=1.5, scale=1.5, size=n))
    v[:3] = [1e-4, 2e7, 0.0]
    return v


def test_constants_and_bounds_are_jax_s():
    assert metrics.DEFAULT_BOUNDS == jax_metrics.DEFAULT_BOUNDS
    assert metrics.REL_ERROR == jax_metrics.REL_ERROR
    assert metrics.SLO_KINDS == jax_metrics.SLO_KINDS
    assert metrics.RESERVOIR_SIZE == jax_metrics.RESERVOIR_SIZE


def test_histogram_states_and_percentiles_equal_jax_s_on_10k_values():
    values = _lognormal(0)
    hs = {}
    for name, mod in PACKAGES.items():
        h = mod.LogHistogram()
        for v in values:
            h.record(v)
        hs[name] = h
    assert hs["port"].state() == hs["jax"].state()
    assert hs["port"].count == 10_000
    for q in (0.01, 0.25, 0.5, 0.9, 0.99, 0.999, 1.0):
        assert hs["port"].percentile(q) == hs["jax"].percentile(q), q
    exact = np.sort(values)[int(np.ceil(0.5 * len(values))) - 1]
    assert abs(hs["port"].percentile(0.5) - exact) / exact <= metrics.REL_ERROR


def test_merge_and_delta_equal_jax_s():
    a_vals, b_vals = _lognormal(1, 3000), _lognormal(2, 2000)
    out = {}
    for name, mod in PACKAGES.items():
        a, b = mod.LogHistogram(), mod.LogHistogram()
        for v in a_vals:
            a.record(v)
        then = a.state()
        for v in b_vals:
            b.record(v)
        merged = a.copy().merge(b)
        delta = mod.LogHistogram.delta(merged.state(), then)
        out[name] = (merged.state(), delta.state(), delta.percentile(0.99),
                     mod.LogHistogram.from_state(merged.state()).percentile(0.5))
    assert out["port"] == out["jax"]
    with pytest.raises(ValueError, match="different bounds"):
        metrics.LogHistogram().merge(metrics.LogHistogram(bounds=(1.0, 2.0)))


def test_reservoir_keeps_jax_s_sample():
    out = {}
    for name, mod in PACKAGES.items():
        r = mod.Reservoir(size=50, seed=3)
        for v in range(500):
            r.add(float(v))
        out[name] = (r.seen, r.values())
    assert out["port"] == out["jax"]


def _fill_registry(mod):
    reg = mod.MetricsRegistry()
    reg.counter("serve_requests_total").inc(12)
    reg.counter("serve_shed_total", reason="shed_deadline").inc(2)
    reg.counter("serve_shed_total", reason="rejected_breaker_open").inc(3)
    reg.counter("serve_completed_total").inc(7)
    reg.gauge("serve_queue_depth", fn=lambda: 5)
    reg.gauge("serve_breaker_open").set(1.0)
    for bucket, vals in (("64x64", _lognormal(4, 40)), ("128x64", _lognormal(5, 25))):
        for v in vals:
            reg.histogram("serve_request_latency_ms").record(v)
            reg.histogram("serve_bucket_latency_ms", bucket=bucket).record(v)
    return reg


def test_registry_snapshot_pool_block_and_exposition_text_equal_jax_s():
    """Byte-identical Prometheus text, the same snapshot rows and pool
    rollup, for the same registry contents."""
    regs = {name: _fill_registry(mod) for name, mod in PACKAGES.items()}
    snaps = {name: reg.snapshot() for name, reg in regs.items()}
    assert snaps["port"] == snaps["jax"]
    assert metrics.exposition_text(snaps["port"]) == jax_metrics.exposition_text(snaps["jax"])
    assert metrics.pool_block(snaps["port"]) == jax_metrics.pool_block(snaps["jax"])
    port, jax = regs["port"], regs["jax"]
    assert port.aggregate_counter("serve_shed_total") == jax.aggregate_counter("serve_shed_total")
    assert (port.aggregate_histogram("serve_bucket_latency_ms").state()
            == jax.aggregate_histogram("serve_bucket_latency_ms").state())
    with pytest.raises(ValueError, match="already registered"):
        port.gauge("serve_requests_total")


# --- SLO evaluation: the same snapshot sequence, the same edges -------------


def _slo_fire_clear(mod):
    """tests/test_metrics_plane.py's fire, hold, clear, fire-again shape."""
    reg = mod.MetricsRegistry()
    reqs = reg.counter("serve_requests_total")
    shed = reg.counter("serve_shed_total", reason="shed_deadline")
    ev = mod.SLOEvaluator([mod.SLOObjective("shed_fraction", "shed_frac", 0.10,
                                            fast_window_s=2.0, slow_window_s=6.0)])
    edges, t = [], 0.0
    for n_shed in [0] * 6 + [10] * 3 + [0] * 4 + [10] * 3:
        reqs.inc(10)
        shed.inc(n_shed)
        edges += ev.observe(t, reg.snapshot())
        t += 1.0
    return edges


def _slo_blip(mod):
    """One bad interval whose slow-window burn stays under 1: no edge."""
    reg = mod.MetricsRegistry()
    reqs = reg.counter("serve_requests_total")
    shed = reg.counter("serve_shed_total", reason="shed_deadline")
    ev = mod.SLOEvaluator([mod.SLOObjective("shed_fraction", "shed_frac", 0.20,
                                            fast_window_s=1.0, slow_window_s=10.0)])
    edges = []
    for i in range(12):
        reqs.inc(100)
        shed.inc(30 if i == 6 else 0)
        edges += ev.observe(float(i), reg.snapshot())
    return edges


def _slo_gauges(mod):
    """Queue depth and session loss fire on reaching the threshold and
    clear once their windows hold no breach."""
    reg = mod.MetricsRegistry()
    depth = reg.gauge("serve_queue_depth")
    lost = reg.counter("rollout_sessions_lost_total")
    ev = mod.SLOEvaluator([
        mod.SLOObjective("queue", "queue_depth", 8.0, fast_window_s=1.0, slow_window_s=2.0),
        mod.SLOObjective("sessions", "session_loss", 1.0, fast_window_s=1.0, slow_window_s=2.0),
    ])
    edges = ev.observe(0.0, reg.snapshot())
    depth.set(20.0)
    lost.inc(1)
    edges += ev.observe(1.0, reg.snapshot())
    depth.set(0.0)
    for t in (2.0, 3.0, 4.0):
        edges += ev.observe(t, reg.snapshot())
    return edges


def _slo_latency_hysteresis(mod):
    """A p99 objective with clear_frac 0.5: a recovery to 0.7 of the
    threshold holds the alert; one below 0.5 clears it; the breaker gauge
    fires beside it."""
    reg = mod.MetricsRegistry()
    lat = reg.histogram("serve_request_latency_ms")
    breaker = reg.gauge("serve_breaker_open")
    ev = mod.SLOEvaluator([
        mod.SLOObjective("latency_p99", "p99_latency_ms", 10.0, fast_window_s=1.0,
                         slow_window_s=3.0, clear_frac=0.5),
        mod.SLOObjective("breaker_open", "breaker_open", 1.0, fast_window_s=1.0,
                         slow_window_s=3.0),
    ])
    edges = []
    for t, ms, open_ in [(0, 2.0, 0), (1, 30.0, 0), (2, 30.0, 1), (3, 7.0, 1), (4, 7.0, 0),
                         (5, 4.0, 0), (6, 4.0, 0), (7, 3.0, 0), (8, 3.0, 0)]:
        for _ in range(20):
            lat.record(ms)
        breaker.set(open_)
        edges += ev.observe(float(t), reg.snapshot())
    return edges


SLO_CASES = {"fire_clear": _slo_fire_clear, "blip": _slo_blip, "gauges": _slo_gauges,
             "latency_hysteresis": _slo_latency_hysteresis}


@pytest.mark.parametrize("case", list(SLO_CASES))
def test_slo_evaluator_gives_jax_s_edges(case):
    got = SLO_CASES[case](metrics)
    want = SLO_CASES[case](jax_metrics)
    assert got == want
    if case == "blip":
        assert got == []
    else:
        states = [e["state"] for e in got]
        assert "fire" in states and "clear" in states, states


def test_default_objectives_are_jax_s():
    from gnot_tpu.config import ServeConfig as JaxServeConfig
    from gnot_tpu_torch.config import ServeConfig

    kw = dict(slo_p99_ms=25.0, slo_shed_frac=0.1, slo_fast_window_s=2.0,
              slo_slow_window_s=8.0, queue_limit=10)
    got = metrics.default_objectives(ServeConfig(**kw))
    want = jax_metrics.default_objectives(JaxServeConfig(**kw))
    fields = ("name", "kind", "threshold", "fast_window_s", "slow_window_s", "clear_frac")
    assert ([[getattr(o, f) for f in fields] for o in got]
            == [[getattr(o, f) for f in fields] for o in want])
    tenants = metrics.tenant_objectives(ServeConfig(**kw), ["a", "b"])
    assert [o.name for o in tenants] == [o.name for o in jax_metrics.tenant_objectives(
        JaxServeConfig(**kw), ["a", "b"])]


# --- the publisher and the summary check ----------------------------------


def _publish(mod, tmp_path, name):
    clock = FakeClock(100.0)
    reg = mod.MetricsRegistry()
    reqs = reg.counter("serve_requests_total")
    done = reg.counter("serve_completed_total")
    hist = reg.histogram("serve_request_latency_ms")
    sink = ListSink()
    pub = mod.MetricsPublisher(
        reg, interval_s=0.5, sink=sink, series_path=str(tmp_path / f"{name}.series.jsonl"),
        exposition_path=str(tmp_path / f"{name}.prom"), clock=clock,
        evaluator=mod.SLOEvaluator([mod.SLOObjective(
            "latency_p99", "p99_latency_ms", 5.0, fast_window_s=0.5, slow_window_s=1.0)]),
    )
    rows = []
    for ms in (2.0, 9.0, 9.0, 1.0, 1.0, 1.0):
        reqs.inc(4)
        done.inc(4)
        for _ in range(4):
            hist.record(ms)
        clock.t += 0.5
        rows.append(pub.tick())
    final = pub.close()
    assert pub.close() is final  # idempotent
    prom = open(tmp_path / f"{name}.prom").read()
    series = [line for line in open(tmp_path / f"{name}.series.jsonl")]
    return rows, final, sink.records, pub.stats(), prom, series


def test_publisher_rows_files_and_events_equal_jax_s(tmp_path):
    """``tick()`` under a fake clock: the same rows (but for the wall-clock
    ``ts``), the same exposition file, the same ``metrics_snapshot`` and
    ``slo_alert`` events; ``close()`` takes one final tick."""
    got = _publish(metrics, tmp_path, "port")
    want = _publish(jax_metrics, tmp_path, "jax")

    def strip(rows):
        return [{k: v for k, v in r.items() if k != "ts"} for r in rows]

    assert strip(got[0]) == strip(want[0])
    assert strip([got[1]]) == strip([want[1]])
    assert got[2] == [{**r, **({"series_path": r["series_path"].replace("jax", "port")}
                               if "series_path" in r else {})} for r in want[2]]
    assert got[3]["snapshots"] == want[3]["snapshots"] == 7
    assert got[3]["alerts"] == want[3]["alerts"] >= 2
    assert got[4] == want[4]
    assert len(got[5]) == 7
    kinds = [r["event"] for r in got[2]]
    assert kinds.count("metrics_snapshot") == 7 and "slo_alert" in kinds


def test_publisher_thread_ticks_and_closes_with_a_final_row(tmp_path):
    reg = metrics.MetricsRegistry()
    reg.counter("serve_requests_total").inc()
    pub = metrics.MetricsPublisher(reg, interval_s=0.01,
                                   series_path=str(tmp_path / "s.jsonl")).start()
    with pytest.raises(RuntimeError, match="already started"):
        pub.start()
    import time

    time.sleep(0.05)
    final = pub.close()
    assert final["seq"] == pub.seq >= 2
    assert final["pool"]["requests"] == 1
    with pytest.raises(ValueError, match="interval_s"):
        metrics.MetricsPublisher(reg, interval_s=0)


@pytest.mark.parametrize("tamper", [None, "requests", "p99"])
def test_summary_agrees_is_jax_s(tamper):
    reg = metrics.MetricsRegistry()
    reg.counter("serve_requests_total").inc(5)
    reg.counter("serve_completed_total").inc(4)
    reg.counter("serve_shed_total", reason="shed_deadline").inc(1)
    h = reg.histogram("serve_request_latency_ms")
    for v in (3.0, 4.0, 5.0, 80.0):
        h.record(v)
    row = {"pool": metrics.pool_block(reg.snapshot())}
    summary = {"requests": 5, "completed": 4, "shed": {"shed_deadline": 1},
               "latency_p50_ms": h.percentile(0.5), "latency_p99_ms": h.percentile(0.99)}
    if tamper == "requests":
        summary["requests"] = 6
    elif tamper == "p99":
        summary["latency_p99_ms"] *= 1.5
    got = metrics.summary_agrees(summary, row)
    assert got == jax_metrics.summary_agrees(summary, row)
    assert (got == []) == (tamper is None)


# --- the training loop's tap -------------------------------------------------


def test_telemetry_buffer_tap_times_every_interval_like_jax():
    """``TelemetryBuffer(metrics=)``: each drained dispatch interval lands
    in ``train_step_time_ms`` (the first append of a window has no prior
    stamp, so N appends time N - 1 intervals), as JAX's buffer does."""
    import jax.numpy as jnp
    import torch

    from gnot_tpu.obs.telemetry import TelemetryBuffer as JaxTelemetryBuffer
    from gnot_tpu_torch.obs.telemetry import TelemetryBuffer

    counts = {}
    for name, buf_cls, mod, val in (("port", TelemetryBuffer, metrics, torch.tensor),
                                    ("jax", JaxTelemetryBuffer, jax_metrics, jnp.asarray)):
        reg = mod.MetricsRegistry()
        buf = buf_cls(None, 0, metrics=reg)
        for s in range(1, 4):
            buf.append(steps=[s], epoch=0, lrs=[1e-3], loss=val(float(s)), telem={},
                       batches=[None])
        buf.drain()
        counts[name] = (reg.aggregate_histogram("train_step_time_ms").count,
                        reg.counter("train_slow_steps_total").value)
    assert counts["port"] == counts["jax"] == (2, 0)


def test_a_telemetry_training_run_records_its_step_times(tmp_path):
    """``main --telemetry --metrics_interval_s``: the run's registry gets
    one ``train_step_time_ms`` record per timed step (each epoch's drain
    window starts untimed: 2 epochs of 3 steps give 4), streamed to the
    series and exposition files, with ``run.json``'s ``metrics`` block."""
    import json

    from gnot_tpu_torch import main as port_main

    mp = tmp_path / "m.jsonl"
    argv = ["--synthetic", "darcy2d", "--synth_size", "8", "--n_train", "6", "--n_test", "2",
            "--batch_size", "2", "--epochs", "2", "--n_attn_layers", "1",
            "--n_attn_hidden_dim", "16", "--n_mlp_num_layers", "1", "--n_mlp_hidden_dim", "16",
            "--n_input_hidden_dim", "16", "--n_expert", "2", "--n_head", "2",
            "--ffn_impl", "pallas", "--device", "cpu", "--telemetry",
            "--metrics_interval_s", "0.05", "--metrics_path", str(mp)]
    trainer = port_main.run(argv)
    steps = sum(len(r.step_losses) for r in trainer.history)
    assert steps == 6
    series = [json.loads(line) for line in open(tmp_path / "m.series.jsonl")]
    final = series[-1]["series"]["train_step_time_ms"]
    assert final["count"] == steps - len(trainer.history)
    assert "train_step_time_ms" in open(tmp_path / "m.prom").read()
    manifest = json.load(open(tmp_path / "run.json"))
    assert manifest["metrics"]["snapshots"] == len(series) >= 1
    recs = [json.loads(line) for line in open(mp)]
    assert any(r.get("event") == "metrics_snapshot" for r in recs)
    assert not any(r.get("event") == "slo_alert" for r in recs)
    assert os.path.getsize(tmp_path / "m.prom") > 0 and math.isfinite(trainer.best_metric)
