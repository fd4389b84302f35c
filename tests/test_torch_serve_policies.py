"""The port's single-server failure handling (``gnot_tpu_torch/serve/``:
``policies.py``, the server's deadlines, breaker, fault hooks, hot reload,
SIGTERM drain, drain timeout and registry) against the JAX package's.

Each scenario runs the same script through JAX's ``InferenceServer`` and
the port's, submit-and-wait so the dispatch groups are deterministic, at
``tests/test_serve.py::setup``'s size with the JAX weights carried over
(``interop.params_from_jax``), f32 on the CPU. Held equal: each request's
reason, the event kinds in order with their fields (times excluded), the
summary's counters; outputs at the model-level bar 1e-4 / 1e-5."""

import os
import signal
import threading
import time

import jax
import numpy as np
import pytest

from gnot_tpu import main as jax_main
from gnot_tpu.config import ModelConfig as JaxModelConfig
from gnot_tpu.data import datasets as jax_datasets
from gnot_tpu.data.batch import collate as jax_collate
from gnot_tpu.models.gnot import GNOT as JaxGNOT
from gnot_tpu.obs import metrics as jax_metrics
from gnot_tpu.resilience import faults as jax_faults
from gnot_tpu.resilience.preemption import PreemptionHandler as JaxPreemptionHandler
from gnot_tpu.serve import CheckpointReloader as JaxReloader
from gnot_tpu.serve import InferenceEngine as JaxEngine
from gnot_tpu.serve import InferenceServer as JaxServer
from gnot_tpu.serve import policies as jax_policies
from gnot_tpu.train.checkpoint import Checkpointer as JaxCheckpointer
from gnot_tpu.train.trainer import init_params
from gnot_tpu_torch import main as port_main
from gnot_tpu_torch.config import ModelConfig
from gnot_tpu_torch.data import datasets
from gnot_tpu_torch.interop import params_from_jax
from gnot_tpu_torch.models.gnot import GNOT
from gnot_tpu_torch.obs import metrics
from gnot_tpu_torch.resilience import faults
from gnot_tpu_torch.resilience.preemption import PreemptionHandler
from gnot_tpu_torch.serve import policies
from gnot_tpu_torch.serve.engine import InferenceEngine
from gnot_tpu_torch.serve.server import CheckpointReloader, InferenceServer
from gnot_tpu_torch.train.checkpoint import Checkpointer

RTOL, ATOL = 1e-4, 1e-5
MAX_BATCH = 2
TINY = dict(n_attn_layers=1, n_attn_hidden_dim=16, n_mlp_num_layers=1, n_mlp_hidden_dim=16,
            n_input_hidden_dim=16, n_expert=2, n_head=2)


class ListSink:
    def __init__(self):
        self.records = []

    def log(self, **record):
        self.records.append(record)

    def flush(self):
        pass


class OffsetClock:
    """The monotonic clock plus an offset a test moves forward instead of
    sleeping (a breaker cooldown passes at once)."""

    def __init__(self):
        self.offset = 0.0

    def __call__(self) -> float:
        return time.monotonic() + self.offset


# -- the policy objects, step for step -----------------------------------------


def _breaker_script(mod):
    clk = [0.0]
    cb = mod.CircuitBreaker(threshold=2, cooldown_s=1.0, clock=lambda: clk[0])
    trace = []

    def step(name, value):
        trace.append((name, value, cb.state, cb.trips))

    step("allow", cb.allow())
    step("failure", cb.record_failure())
    step("failure", cb.record_failure())  # the threshold: tripped
    step("allow", cb.allow())  # cooling
    clk[0] = 0.9
    step("failure", cb.record_failure())  # open already: the cooldown restarts
    clk[0] = 1.5
    step("allow", cb.allow())  # 0.6 s after the restart: still open
    clk[0] = 2.0
    step("allow", cb.allow())  # half-open trial
    step("allow", cb.allow())  # one trial at a time
    step("success", cb.record_success())  # recovered
    step("failure", cb.record_failure())
    step("failure", cb.record_failure())
    clk[0] = 3.5
    step("allow", cb.allow())
    step("failure", cb.record_failure())  # the trial failed: open again
    step("allow", cb.allow())
    step("success", cb.record_success())
    return trace


def test_breaker_trips_half_opens_and_reopens_step_for_step_as_jax():
    got = _breaker_script(policies)
    assert got == _breaker_script(jax_policies)
    assert got[-1] == ("success", False, "closed", 3)
    with pytest.raises(ValueError, match="threshold"):
        policies.CircuitBreaker(threshold=0)


def test_deadline_and_admission_are_jax_s():
    for mod in (policies, jax_policies):
        d = mod.Deadline(10.0)
        assert (d.expired(9.9), d.expired(10.0), d.remaining_s(9.5), d.remaining_ms(11.0)) == (
            False, True, 0.5, 0.0)
        adm = mod.AdmissionController(2)
        assert adm.try_admit() and adm.try_admit() and not adm.try_admit()
        adm.release()
        assert adm.depth == 1 and adm.try_admit()
        with pytest.raises(ValueError):
            mod.AdmissionController(0)
        fresh = mod.AdmissionController(1)
        with pytest.raises(RuntimeError, match="without a matching admit"):
            fresh.release()


# -- the two servers over the same weights --------------------------------------


@pytest.fixture(scope="module")
def setup():
    """``tests/test_serve.py::setup``: 12 Darcy meshes of 64 points and a
    tiny model; the JAX engine's (2, 64, 64) program compiles once here."""
    jsamples = jax_datasets.synth_darcy2d(12, seed=0, grid_n=8)
    psamples = datasets.synth_darcy2d(12, seed=0, grid_n=8)
    mc = dict(TINY, **jax_datasets.infer_model_dims(jsamples))
    jmodel = JaxGNOT(JaxModelConfig(**mc))
    params = init_params(jmodel, jax_collate(jsamples[:4]), 0)
    jengine = JaxEngine(jmodel, params, batch_size=MAX_BATCH)
    jengine.warmup(jsamples[:1], rows=MAX_BATCH)
    cfg = ModelConfig(**mc)
    host = jax.device_get(params)
    return dict(jmodel=jmodel, params=params, jengine=jengine, jsamples=jsamples,
                psamples=psamples, cfg=cfg, host=host)


def _port_model(setup, scale: float = 1.0) -> GNOT:
    model = GNOT(setup["cfg"])
    model.load_state_dict(
        params_from_jax(jax.tree.map(lambda x: x * scale, setup["host"]), setup["cfg"]),
        strict=True)
    return model


PACKAGES = {
    "jax": dict(server=JaxServer, faults=jax_faults, preempt=JaxPreemptionHandler,
                metrics=jax_metrics),
    "port": dict(server=InferenceServer, faults=faults, preempt=PreemptionHandler,
                 metrics=metrics),
}


def _engine(setup, pkg: str, *, fresh: bool = False):
    """The package's engine over the setup's weights; ``fresh`` for a
    scenario that swaps them."""
    if pkg == "port":
        return InferenceEngine(_port_model(setup), batch_size=MAX_BATCH)
    if not fresh:
        return setup["jengine"]
    return JaxEngine(setup["jmodel"], setup["params"], batch_size=MAX_BATCH)


def _server(setup, pkg: str, sink, *, engine=None, **kw):
    engine = engine or _engine(setup, pkg)
    return PACKAGES[pkg]["server"](engine, max_batch=MAX_BATCH,
                                   max_wait_ms=kw.pop("max_wait_ms", 5.0), sink=sink, **kw)


def _samples(setup, pkg: str):
    return setup["jsamples" if pkg == "jax" else "psamples"]


#: Time-valued fields, left out of the comparison.
TIMES = {"ts", "duration_ms", "waited_ms", "latency_p50_ms", "latency_p99_ms",
         "dispatch_ms_p50", "dispatch_ms_max"}


def _events(records) -> list[dict]:
    """The sink's events with their fields, times excluded; the reload's
    file name without the port's ``.pt`` and its skipped files counted."""
    out = []
    for r in records:
        if r.get("event") == "serve_summary":
            out.append({"event": "serve_summary"})
            continue
        e = {k: v for k, v in r.items() if k not in TIMES}
        if e.get("event") == "reload":
            e.pop("requested_skipped", None)  # the port's record names the skipped files
            if "dir" in e:
                e["dir"] = e["dir"].removesuffix(".pt")
            if "skipped" in e:
                e["skipped"] = len(e["skipped"])
            if "error" in e:
                e["error"] = e["error"].split(":")[0]
        out.append(e)
    return out


def _counters(summary: dict) -> dict:
    return {k: summary[k] for k in ("shed", "breaker_trips", "reloads", "dispatches",
                                    "completed", "requests", "admitted")}


def _assert_same(got: dict, want: dict) -> None:
    assert [r.reason for r in got["results"]] == [r.reason for r in want["results"]]
    assert got["events"] == want["events"]
    assert got["counters"] == want["counters"]
    for g, w in zip(got["results"], want["results"]):
        assert g.ok == w.ok
        if g.ok:
            np.testing.assert_allclose(g.output, w.output, rtol=RTOL, atol=ATOL)


def _outcome(results, sink, summary) -> dict:
    return dict(results=results, events=_events(sink.records), counters=_counters(summary))


# -- the scenarios: one function, run through each package ----------------------


def _slow_request(setup, pkg, tmp_path, registry=None):
    """``slow_request@1`` under a 50 ms deadline: the victim's dispatch
    (it and its batchmate) sheds ``shed_deadline`` before the forward,
    with no ``queue_depth`` for it; the next pair is served."""
    sink = ListSink()
    srv = _server(setup, pkg, sink, max_wait_ms=10_000, default_deadline_ms=50.0,
                  faults=PACKAGES[pkg]["faults"].FaultInjector.from_spec("slow_request@1"),
                  metrics=registry)
    srv.start()
    s = _samples(setup, pkg)
    futs = [srv.submit(x) for x in s[:2]]
    results = [f.result(timeout=30) for f in futs]
    futs = [srv.submit(x, deadline_ms=10_000) for x in s[2:4]]
    results += [f.result(timeout=30) for f in futs]
    summary = srv.drain(timeout_s=30)
    return _outcome(results, sink, summary), summary


def _breaker(setup, pkg, tmp_path):
    """``nan_output@1,nan_output@2`` with threshold 2: two failed
    dispatches trip the breaker, the next request is rejected with no
    dispatch, and after the cooldown a half-open trial closes it."""
    sink, clock = ListSink(), OffsetClock()
    srv = _server(setup, pkg, sink, breaker_threshold=2, breaker_cooldown_s=0.2, clock=clock,
                  faults=PACKAGES[pkg]["faults"].FaultInjector.from_spec(
                      "nan_output@1,nan_output@2"))
    srv.start()
    s = _samples(setup, pkg)
    results = [srv.submit(x).result(timeout=30) for x in s[:3]]
    clock.offset += 1.0  # past the cooldown, without sleeping
    results += [srv.submit(x).result(timeout=30) for x in s[3:5]]
    return _outcome(results, sink, srv.drain(timeout_s=30))


def _checkpoint(setup, pkg, d, saves):
    """A checkpointer under ``d`` holding ``saves``: (name, scale, epoch)."""
    ck = (JaxCheckpointer if pkg == "jax" else Checkpointer)(str(d))
    for name, scale, epoch in saves:
        if pkg == "jax":
            state = jax.tree.map(lambda x: x * scale, setup["params"])
        else:
            state = {"model": _port_model(setup, scale).state_dict()}
        getattr(ck, f"save_{name}")(state, epoch, 0.5)
        ck.wait()
    return ck


RELOADS = {
    "swap": ([("latest", 0.5, 3)], ""),
    "corrupt_latest_falls_back_to_best": ([("best", 0.25, 1), ("latest", 2.0, 2)],
                                          "reload_corrupt@1"),
    "empty_dir_keeps_serving": ([], ""),
}


def _reload(setup, pkg, tmp_path, case):
    """A request, a reload, a request: the swap serves the new weights, a
    ``reload_corrupt`` walks on to ``best``, an empty directory fails the
    reload and keeps the old weights serving."""
    saves, spec = RELOADS[case]
    ck = _checkpoint(setup, pkg, tmp_path / pkg / "ck", saves)
    engine = _engine(setup, pkg, fresh=True)
    template = setup["params"] if pkg == "jax" else engine.model
    reloader = (JaxReloader if pkg == "jax" else CheckpointReloader)(ck, template)
    sink = ListSink()
    srv = _server(setup, pkg, sink, engine=engine, reload_fn=reloader,
                  faults=PACKAGES[pkg]["faults"].FaultInjector.from_spec(spec))
    srv.start()
    s = _samples(setup, pkg)
    results = [srv.submit(s[0]).result(timeout=30)]
    ok = srv.reload(deadline_ms=5_000)
    results.append(srv.submit(s[0]).result(timeout=30))
    return dict(_outcome(results, sink, srv.drain(timeout_s=30)), ok=ok)


def _sigterm(setup, pkg, tmp_path):
    """SIGTERM while four requests wait in a partial bucket: the worker
    drains, every admitted request completes, later ones are refused."""
    sink = ListSink()
    with PACKAGES[pkg]["preempt"]() as preempt:
        srv = _server(setup, pkg, sink, preempt=preempt, max_wait_ms=10_000)
        srv.start()
        s = _samples(setup, pkg)
        futs = [srv.submit(x) for x in s[:3]]
        os.kill(os.getpid(), signal.SIGTERM)
        results = [f.result(timeout=30) for f in futs]
        deadline = time.monotonic() + 10
        while srv._worker.is_alive() and time.monotonic() < deadline:
            time.sleep(0.01)
        results.append(srv.submit(s[3]).result(timeout=30))
        summary = srv.drain(timeout_s=30)
    return _outcome(results, sink, summary)


class BlockingEngine:
    """An engine whose forward waits for ``release``: a wedged dispatch."""

    dtype = "float32"
    compiled_shapes = dispatch_shapes = 1

    def __init__(self):
        self.release = threading.Event()
        self.entered = threading.Event()

    def validate(self, samples):
        pass

    @staticmethod
    def bucket_key(sample):
        return (64, 64)

    def warmup(self, samples, rows=None):
        return 0

    def infer(self, samples, *, pad_nodes, pad_funcs, rows=None, timings=None, clock=None):
        self.entered.set()
        self.release.wait(30)
        return [np.zeros((s.coords.shape[0], 1), np.float32) for s in samples]


def _drain_timeout(setup, pkg, tmp_path):
    """A dispatch wedged past the drain budget: ``drain_timeout``, the
    summary of what is known, and the request still resolves once the
    dispatch returns; a second drain writes the settled summary."""
    sink, engine = ListSink(), BlockingEngine()
    srv = PACKAGES[pkg]["server"](engine, max_batch=1, max_wait_ms=0.0, sink=sink)
    srv.start()
    fut = srv.submit(_samples(setup, pkg)[0])
    assert engine.entered.wait(30)
    first = srv.drain(timeout_s=0.05)
    engine.release.set()
    results = [fut.result(timeout=30)]
    second = srv.drain(timeout_s=30)
    assert (first["completed"], second["completed"]) == (0, 1)
    return _outcome(results, sink, second)


SCENARIOS = {"slow_request": lambda *a: _slow_request(*a)[0], "breaker": _breaker,
             "sigterm": _sigterm, "drain_timeout": _drain_timeout}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_the_scenario_runs_as_in_jax(name, setup, tmp_path):
    want = SCENARIOS[name](setup, "jax", tmp_path)
    got = SCENARIOS[name](setup, "port", tmp_path)
    _assert_same(got, want)
    reasons = [r.reason for r in got["results"]]
    kinds = [e["event"] for e in got["events"]]
    if name == "slow_request":
        assert reasons == ["shed_deadline"] * 2 + ["ok"] * 2
        assert kinds.count("queue_depth") == 1
        assert got["counters"]["shed"] == {"shed_deadline": 2}
    elif name == "breaker":
        assert reasons == ["error_nan_output"] * 2 + ["rejected_breaker_open", "ok", "ok"]
        assert [k for k in kinds if k.startswith("breaker")] == ["breaker_open", "breaker_close"]
        assert kinds.index("breaker_open") < kinds.index("breaker_close")
        assert got["counters"]["breaker_trips"] == 1
    elif name == "sigterm":
        assert reasons == ["ok"] * 3 + ["rejected_draining"]
        assert kinds[-1] == "serve_summary"
    else:
        assert reasons == ["ok"]
        assert kinds == ["queue_depth", "drain_timeout", "serve_summary", "serve_summary"]


@pytest.mark.parametrize("n_requests", [0, 3])
def test_fault8_summary_key_set_is_jax_s(n_requests, setup):
    """Fault 8: after an empty and after a busy drain the port's summary
    has JAX's keys (``jit_fallbacks`` always, ``pad_waste_by_bucket`` only
    once a dispatch ran) and two of its own, the dispatch host times,
    which JAX's event spec allows."""
    keys = {}
    for pkg in ("jax", "port"):
        srv = _server(setup, pkg, ListSink())
        srv.start()
        futs = [srv.submit(x) for x in _samples(setup, pkg)[:n_requests]]
        assert all(f.result(timeout=30).ok for f in futs)
        summary = srv.drain(timeout_s=30)
        keys[pkg] = set(summary)
        assert summary["jit_fallbacks"] == 0
    assert keys["port"] - keys["jax"] == {"dispatch_ms_p50", "dispatch_ms_max"}
    assert keys["jax"] <= keys["port"]
    assert ("pad_waste_by_bucket" in keys["port"]) == (n_requests > 0)


@pytest.mark.parametrize("case", list(RELOADS))
def test_a_reload_runs_as_in_jax(case, setup, tmp_path):
    want = _reload(setup, "jax", tmp_path, case)
    got = _reload(setup, "port", tmp_path, case)
    _assert_same(got, want)
    assert got["ok"] == want["ok"] == (case != "empty_dir_keeps_serving")
    [rel] = [e for e in got["events"] if e["event"] == "reload"]
    assert all(r.ok for r in got["results"])
    before, after = (r.output for r in got["results"])
    if case == "swap":
        assert (rel["epoch"], rel["fallback"]) == (3, False)
        assert not np.allclose(before, after)
    elif case == "corrupt_latest_falls_back_to_best":
        assert (rel["name"], rel["epoch"], rel["fallback"]) == ("best", 1, True)
    else:
        assert not rel["ok"] and np.array_equal(before, after)
    assert got["counters"]["reloads"] == 1


def test_a_fallback_reload_serves_best_s_weights_bitwise(setup, tmp_path):
    """After ``reload_corrupt`` the engine's outputs are those of a fresh
    engine on ``best``'s weights, bit for bit."""
    ck = _checkpoint(setup, "port", tmp_path / "ck", RELOADS["corrupt_latest_falls_back_to_best"][0])
    engine = _engine(setup, "port")
    srv = InferenceServer(engine, max_batch=MAX_BATCH, max_wait_ms=1.0,
                          reload_fn=CheckpointReloader(ck, engine.model),
                          faults=faults.FaultInjector.from_spec("reload_corrupt@1")).start()
    assert srv.reload()
    s = setup["psamples"][:2]
    got = [srv.submit(x).result(timeout=30) for x in s]
    srv.drain(timeout_s=30)
    fresh = InferenceEngine(_port_model(setup, 0.25), batch_size=MAX_BATCH)
    key = fresh.bucket_key(s[0])
    for r, x in zip(got, s):
        want = fresh.infer([x], pad_nodes=key[0], pad_funcs=key[1], rows=MAX_BATCH)[0]
        assert np.array_equal(r.output, want)


def test_a_layout_conflict_fails_the_reload_with_restore_for_serving_s_error(setup, tmp_path):
    ck = _checkpoint(setup, "port", tmp_path / "ck", [("latest", 1.0, 1)])
    engine = _engine(setup, "port")
    reloader = CheckpointReloader(ck, engine.model, layout="flat")
    with pytest.raises(ValueError, match="holds the standard parameter layout"):
        reloader()
    sink = ListSink()
    srv = InferenceServer(engine, max_batch=MAX_BATCH, sink=sink, reload_fn=reloader)
    assert not srv.reload()
    [rel] = [r for r in sink.records if r["event"] == "reload"]
    assert not rel["ok"] and rel["error"].startswith("ValueError: the 'latest' checkpoint")
    srv.drain(timeout_s=5)


def test_the_registry_holds_jax_s_series_and_agrees_with_the_summary(setup, tmp_path):
    """The same storm (a deadline shed and two served) through both
    servers with a registry: the same series keys, the same counts and
    gauge values (but for JAX's jit-fallback count), and the final
    snapshot agrees with each
    summary (``summary_agrees`` empty); ``pad_waste_by_bucket`` is read
    back from the registry's counters."""
    keys, summaries = {}, {}
    for pkg in ("jax", "port"):
        reg = PACKAGES[pkg]["metrics"].MetricsRegistry()
        _, summary = _slow_request(setup, pkg, tmp_path, registry=reg)
        final = PACKAGES[pkg]["metrics"].MetricsPublisher(reg, interval_s=1.0).close()
        assert PACKAGES[pkg]["metrics"].summary_agrees(summary, final) == []
        snap = final["series"]
        keys[pkg] = sorted(snap)
        summaries[pkg] = {k: (v.get("value"), v.get("count")) for k, v in snap.items()}
        assert summary["pad_waste_by_bucket"]["64x64"]["dispatches"] == snap[
            "serve_bucket_dispatches_total{bucket=64x64}"]["value"] == 1
    assert keys["port"] == keys["jax"]
    # JAX counts each dispatch its engine ran jitted (no AOT table here);
    # eager PyTorch has no such fallback, and the port's counter stays 0.
    jit = "serve_jit_fallback_total"
    assert summaries["jax"].pop(jit) == (summaries["jax"]["serve_dispatches_total"][0], None)
    assert summaries["port"].pop(jit) == (0, None)
    assert summaries["port"] == summaries["jax"]
    assert "serve_shed_total{reason=shed_deadline}" in keys["port"]
    assert summaries["port"]["serve_resident_sessions"] == (0.0, None)


# -- the command line ---------------------------------------------------------

FLAGS = ["serve_deadline_ms", "serve_breaker_threshold", "serve_breaker_cooldown_s",
         "drain_timeout_s", "serve_inject_fault", "serve_reload_every", "metrics_interval_s",
         "slo_p99_ms", "slo_shed_frac", "slo_fast_window_s", "slo_slow_window_s"]


def test_the_eleven_flags_take_jax_s_defaults_and_refusals():
    want = vars(jax_main.build_parser().parse_args([]))
    got = vars(port_main.build_parser().parse_args([]))
    assert {f: got[f] for f in FLAGS} == {f: want[f] for f in FLAGS}
    argv = ["--serve_deadline_ms", "150", "--serve_breaker_threshold", "2",
            "--serve_breaker_cooldown_s", "0.2", "--drain_timeout_s", "5",
            "--serve_inject_fault", "nan_output@1", "--serve_reload_every", "4",
            "--metrics_interval_s", "0.05", "--slo_p99_ms", "1", "--slo_shed_frac", "0.1",
            "--slo_fast_window_s", "0.1", "--slo_slow_window_s", "0.2"]
    _, port = port_main.configs_from_args(port_main.build_parser().parse_args(argv))
    jax_sc = jax_main.config_from_args(jax_main.build_parser().parse_args(argv)).serve
    for field in ("deadline_ms", "breaker_threshold", "breaker_cooldown_s", "drain_timeout_s",
                  "inject_fault", "metrics_interval_s", "slo_p99_ms", "slo_shed_frac",
                  "slo_fast_window_s", "slo_slow_window_s"):
        assert getattr(port, field) == getattr(jax_sc, field), field
    for bad in (["--serve_breaker_threshold", "0"], ["--metrics_interval_s", "-1"],
                ["--slo_p99_ms", "-2"], ["--slo_shed_frac", "1.5"],
                ["--slo_fast_window_s", "40"], ["--slo_fast_window_s", "0"]):
        with pytest.raises(ValueError) as want_err:
            jax_main.config_from_args(jax_main.build_parser().parse_args(bad))
        with pytest.raises(ValueError) as got_err:
            port_main.configs_from_args(port_main.build_parser().parse_args(bad))
        assert str(got_err.value) == str(want_err.value)
    with pytest.raises(ValueError, match="bad fault spec") as got_err:
        faults.FaultInjector.from_spec("slow_request@x")
    with pytest.raises(ValueError) as want_err:
        jax_faults.FaultInjector.from_spec("slow_request@x")
    assert str(got_err.value) == str(want_err.value)


def test_main_reloads_under_faults_and_streams_the_metrics_plane(tmp_path, capsys):
    """``main --serve`` with a checkpoint, ``--serve_reload_every 2``,
    ``reload_corrupt@2`` and the metrics plane: every request served,
    four reloads (the second and later walk on to ``best``), snapshot
    events, the series and exposition files, a ``slo_alert`` fire on an
    unmeetable p99, and ``run.json``'s ``metrics.summary_agrees``."""
    import json

    small = ["--n_attn_layers", "1", "--n_attn_hidden_dim", "16", "--n_mlp_num_layers", "1",
             "--n_mlp_hidden_dim", "16", "--n_input_hidden_dim", "16", "--n_expert", "2",
             "--n_head", "2", "--ffn_impl", "pallas", "--device", "cpu", "--synthetic",
             "darcy2d", "--synth_size", "8"]
    ck = str(tmp_path / "ck")
    port_main.run_train(port_main.build_parser().parse_args(
        small + ["--n_train", "4", "--n_test", "2", "--epochs", "2", "--checkpoint_dir", ck,
                 "--checkpoint_every", "1"]))
    mp = tmp_path / "m.jsonl"
    run = port_main.run(small + [
        "--serve", "--n_test", "8", "--checkpoint_dir", ck, "--serve_reload_every", "2",
        "--serve_inject_fault", "reload_corrupt@2", "--metrics_interval_s", "0.02",
        "--slo_p99_ms", "0.001", "--slo_fast_window_s", "0.02", "--slo_slow_window_s", "0.04",
        "--metrics_path", str(mp)])
    assert [r.reason for r in run.results] == ["ok"] * 8
    recs = [json.loads(line) for line in open(mp)]
    reloads = [r for r in recs if r.get("event") == "reload"]
    assert [(r["ok"], r["fallback"]) for r in reloads] == [(True, False)] + [(True, True)] * 3
    assert run.summary["reloads"] == 4
    assert any(r.get("event") == "metrics_snapshot" for r in recs)
    alerts = [r for r in recs if r.get("event") == "slo_alert"]
    assert ("latency_p99", "fire") in {(a["objective"], a["state"]) for a in alerts}
    assert run.metrics["summary_agrees"] is True
    assert json.load(open(tmp_path / "run.json"))["metrics"]["summary_agrees"] is True
    assert (tmp_path / "m.prom").stat().st_size > 0
    series = [json.loads(line) for line in open(tmp_path / "m.series.jsonl")]
    assert series[-1]["pool"]["completed"] == 8
