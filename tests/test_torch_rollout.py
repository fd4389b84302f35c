"""The port's rollout sessions (``gnot_tpu_torch/serve/rollout.py`` and the
server's session path) against the JAX package's.

The pieces alone: ``advance_sample`` bitwise JAX's, ``RolloutSession``'s
state machine step for step, ``SessionStore`` files read across both
packages, ``offline_rollout`` at the model-level bar. Then the same
scripts through JAX's ``InferenceServer`` and the port's (mirroring
``tests/test_serve.py``'s rollout tests without the router's), on
``tests/test_serve.py::setup``'s traffic (64-point Darcy meshes, one
bucket, 2-row dispatches, so JAX compiles once) and a width-16, 2-layer
model whose JAX weights the port loads through ``interop.params_from_jax``,
f32 on the CPU. Each script is deterministic: its requests are submitted
before the worker starts, or one session runs alone, or a step callback
drives the drain; the rollout deadline moves an injected clock. Held
equal: each session's reason, step counts and ``drained_at_step``, the
event stream (times left out), the summary's counters and ``sessions``
block; outputs at 1e-4 / 1e-5 per step, and each served trajectory within
1e-5 of its own ``offline_rollout``. Last, ``main --serve
--serve_rollout_steps`` on the CPU and its three flags against JAX's."""

import json
import os
import signal
import threading
import time

import jax
import numpy as np
import pytest

from gnot_tpu import main as jax_main
from gnot_tpu.config import ModelConfig as JaxModelConfig
from gnot_tpu.config import make_config
from gnot_tpu.data import datasets as jax_datasets
from gnot_tpu.data.batch import collate as jax_collate
from gnot_tpu.models.gnot import GNOT as JaxGNOT
from gnot_tpu.obs import metrics as jax_metrics
from gnot_tpu.resilience import faults as jax_faults
from gnot_tpu.resilience.preemption import PreemptionHandler as JaxPreemptionHandler
from gnot_tpu.serve import InferenceEngine as JaxEngine
from gnot_tpu.serve import InferenceServer as JaxServer
from gnot_tpu.serve import policies as jax_policies
from gnot_tpu.serve import rollout as jax_rollout
from gnot_tpu.train.trainer import init_params
from gnot_tpu_torch import main as port_main
from gnot_tpu_torch.config import ModelConfig, ServeConfig
from gnot_tpu_torch.data import datasets
from gnot_tpu_torch.interop import params_from_jax
from gnot_tpu_torch.models.gnot import GNOT
from gnot_tpu_torch.obs import metrics
from gnot_tpu_torch.resilience import faults
from gnot_tpu_torch.resilience.preemption import PreemptionHandler
from gnot_tpu_torch.serve import policies, rollout
from gnot_tpu_torch.serve.engine import InferenceEngine
from gnot_tpu_torch.serve.server import InferenceServer

RTOL, ATOL = 1e-4, 1e-5
PARITY = 1e-5  # a served trajectory against its own offline rollout, per step
MAX_BATCH = 2
SMALL = dict(n_attn_layers=2, n_attn_hidden_dim=16, n_mlp_num_layers=1, n_mlp_hidden_dim=16,
             n_input_hidden_dim=16, n_expert=2, n_head=2)


class ListSink:
    def __init__(self):
        self.records = []

    def log(self, **record):
        self.records.append(record)

    def flush(self):
        pass


class OffsetClock:
    """The monotonic clock plus an offset a test moves instead of sleeping."""

    def __init__(self):
        self.offset = 0.0

    def __call__(self) -> float:
        return time.monotonic() + self.offset


@pytest.fixture(scope="module")
def setup():
    jsamples = jax_datasets.synth_darcy2d(8, seed=0, grid_n=8)
    psamples = datasets.synth_darcy2d(8, seed=0, grid_n=8)
    mc = dict(SMALL, **jax_datasets.infer_model_dims(jsamples))
    jmodel = JaxGNOT(JaxModelConfig(**mc))
    params = init_params(jmodel, jax_collate(jsamples[:4]), 0)
    jengine = JaxEngine(jmodel, params, batch_size=MAX_BATCH)
    jengine.warmup(jsamples[:1], rows=MAX_BATCH)
    cfg = ModelConfig(**mc)
    model = GNOT(cfg)
    model.load_state_dict(params_from_jax(jax.device_get(params), cfg), strict=True)
    pengine = InferenceEngine(model, batch_size=MAX_BATCH)
    return {"jax": dict(engine=jengine, samples=jsamples, server=JaxServer, faults=jax_faults,
                        preempt=JaxPreemptionHandler, rollout=jax_rollout, metrics=jax_metrics,
                        policies=jax_policies),
            "port": dict(engine=pengine, samples=psamples, server=InferenceServer, faults=faults,
                         preempt=PreemptionHandler, rollout=rollout, metrics=metrics,
                         policies=policies)}


def _server(pkg: dict, sink, **kw):
    return pkg["server"](pkg["engine"], max_batch=MAX_BATCH, max_wait_ms=kw.pop("max_wait_ms", 1.0),
                         sink=sink, **kw)


#: Time-valued fields, left out of the comparison.
TIMES = {"ts", "waited_ms", "latency_ms", "latency_p50_ms", "latency_p99_ms",
         "step_latency_p50_ms", "step_latency_p99_ms", "dispatch_ms_p50", "dispatch_ms_max"}


def _events(records) -> list[dict]:
    return [{"event": "serve_summary"} if r.get("event") == "serve_summary"
            else {k: v for k, v in r.items() if k not in TIMES} for r in records]


def _summary(summary: dict) -> dict:
    keep = ("requests", "admitted", "completed", "shed", "dispatches", "breaker_trips")
    out = {k: summary[k] for k in keep}
    for block in ("sessions", "tenants"):
        if block in summary:
            out[block] = {k: ({kk: vv for kk, vv in v.items() if kk not in TIMES}
                              if isinstance(v, dict) else v)
                          for k, v in summary[block].items() if k not in TIMES}
    return out


def _session(r) -> tuple:
    return (r.ok, r.reason, r.session, r.steps, r.steps_completed, r.drained_at_step,
            len(r.outputs), r.migrations)


def _assert_same(got: dict, want: dict) -> None:
    assert [_session(r) for r in got["results"]] == [_session(r) for r in want["results"]]
    assert got["events"] == want["events"]
    assert got["summary"] == want["summary"]
    for g, w in zip(got["results"], want["results"]):
        for a, b in zip(g.outputs, w.outputs):
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)


def _outcome(results, sink, summary, **extra) -> dict:
    return dict(results=results, events=_events(sink.records), summary=_summary(summary), **extra)


def _hold_to_offline(pkg: dict, results, samples) -> None:
    """Each served prefix within ``PARITY`` of the package's own offline
    rollout of the same sample (``parity_check``)."""
    for r, s in zip(results, samples):
        if r.outputs:
            want = pkg["rollout"].offline_rollout(pkg["engine"], s, len(r.outputs), rows=MAX_BATCH)
            assert pkg["rollout"].parity_check(r.outputs, want) <= PARITY


# -- the pieces alone ----------------------------------------------------------


def test_advance_sample_is_jax_s_bitwise(setup):
    rng = np.random.default_rng(0)
    for pkg_samples in zip(setup["jax"]["samples"][:3], setup["port"]["samples"][:3]):
        out = rng.standard_normal((64, 1)).astype(np.float32)
        want = jax_rollout.advance_sample(pkg_samples[0], out, dt=0.25)
        got = rollout.advance_sample(pkg_samples[1], out, dt=0.25)
        for f in ("coords", "y", "theta"):
            assert np.array_equal(getattr(got, f), getattr(want, f)), f
            assert getattr(got, f).dtype == getattr(want, f).dtype == np.float32
        assert len(got.funcs) == len(want.funcs)
        for a, b in zip(got.funcs, want.funcs):
            assert a.shape == b.shape and np.array_equal(a, b)
        # A fresh copy: the step's input is never written.
        assert not np.shares_memory(got.funcs[0], pkg_samples[1].funcs[0])
    assert (rollout.ROLLOUT_DT, rollout.ROLLOUT_REASONS) == (
        jax_rollout.ROLLOUT_DT, jax_rollout.ROLLOUT_REASONS)


def _session_script(mod, sample):
    """A session's state machine, step by step: commits, the snapshot
    cadence, a restore, the once-per-step stream, the idempotent resolve,
    and ``snapshot_state`` / ``from_state``."""
    streamed = []
    s = mod.RolloutSession("run:1", sample, 5, snapshot_every=2, tenant="alice",
                           on_step=lambda sid, k, o: streamed.append((sid, k)))
    trace = []

    def state(tag):
        trace.append((tag, s.cursor, s.finished, s.snapshot_due(), s.migrations,
                      float(s.sample.theta[0])))

    out = np.full((64, 1), 0.5, np.float32)
    for _ in range(3):
        k = s.record_step(out)
        s.publish_step(k, out)
        state(f"step{k}")
        if s.snapshot_due():
            trace.append(("snapshot", s.take_snapshot()))
    trace.append(("restore", s.restore_from_snapshot()))
    state("restored")
    k = s.record_step(out)
    s.publish_step(k, out)  # a replayed step is not streamed twice
    state("replayed")
    snap = s.snapshot_state()
    trace.append(("state", snap["cursor"], len(snap["outputs"]), snap["tenant"], snap["dt"]))
    back = mod.RolloutSession.from_state(snap, snapshot_every=3)
    trace.append(("from_state", back.cursor, back.named, back.tenant, back.snapshot_due()))
    trace.append(("resolve", s.resolve(False, "drained", drained_at_step=3),
                  s.resolve(True, "ok")))
    res = s.future.result(timeout=1)
    trace.append(("result", res.ok, res.reason, res.steps_completed, res.drained_at_step,
                  res.migrations, len(res.outputs)))
    trace.append(("stream", [k for k, _ in s.future.iter_steps(timeout=1)], streamed))
    for bad in (dict(steps=0), dict(snapshot_every=0)):
        with pytest.raises(ValueError):
            mod.RolloutSession("x", sample, bad.get("steps", 2),
                               snapshot_every=bad.get("snapshot_every", 1))
    return trace


def test_rollout_session_state_machine_is_jax_s_step_for_step(setup):
    got = _session_script(rollout, setup["port"]["samples"][0])
    want = _session_script(jax_rollout, setup["jax"]["samples"][0])
    assert got == want
    assert ("restore", 2) in got and got[-1][1] == [1, 2, 3]


def test_session_store_files_read_across_both_packages(setup, tmp_path):
    """A file the port writes loads in JAX's store and the other way
    round, under the same file name, with the same state."""
    out = np.arange(64, dtype=np.float32).reshape(64, 1)
    for writer, reader, pkg in ((rollout, jax_rollout, "port"), (jax_rollout, rollout, "jax")):
        d = tmp_path / pkg
        s = writer.RolloutSession("client/run:7", setup[pkg]["samples"][1], 4, tenant="batch")
        s.named = True
        s.record_step(out)
        s.record_step(out * 2)
        s.take_snapshot()
        path = writer.SessionStore(str(d)).save(s)
        store = reader.SessionStore(str(d))
        assert os.path.basename(path) == os.path.basename(store._path("client/run:7"))
        assert os.path.basename(path).startswith("client_run_7-")
        assert store.names() == ["client/run:7"]
        state = store.load("client/run:7")
        want = s.snapshot_state()
        assert {k: state[k] for k in ("sid", "steps", "cursor", "dt", "tenant")} == {
            k: want[k] for k in ("sid", "steps", "cursor", "dt", "tenant")}
        for f in ("coords", "y", "theta"):
            assert np.array_equal(getattr(state["sample"], f), getattr(want["sample"], f))
        assert all(np.array_equal(a, b) for a, b in zip(state["sample"].funcs,
                                                        want["sample"].funcs))
        assert all(np.array_equal(a, b) for a, b in zip(state["outputs"], want["outputs"]))
        back = reader.RolloutSession.from_state(state)
        assert (back.cursor, back.tenant, back.named) == (2, "batch", True)
        store.delete("client/run:7")
        assert store.load("client/run:7") is None and store.names() == []


def test_offline_rollout_matches_jax_s_per_step(setup):
    for i in range(2):
        got = rollout.offline_rollout(setup["port"]["engine"], setup["port"]["samples"][i], 4,
                                      rows=MAX_BATCH)
        want = jax_rollout.offline_rollout(setup["jax"]["engine"], setup["jax"]["samples"][i], 4,
                                           rows=MAX_BATCH)
        assert len(got) == len(want) == 4
        for a, b in zip(got, want):
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
        # The steps differ: the carry feeds each prediction forward.
        assert not np.allclose(got[0], got[1])
    with pytest.raises(ValueError, match="steps >= 1"):
        rollout.offline_rollout(setup["port"]["engine"], setup["port"]["samples"][0], 0)
    assert rollout.parity_check(got, got) == 0.0
    with pytest.raises(ValueError, match="3 steps"):
        rollout.parity_check(got[:3], got)


# -- the servers: one script, run through each package ---------------------------


def _completed(pkg, tmp_path):
    """One 4-step session with snapshots every 2 steps: streamed by the
    iterator and the callback in order, one ``rollout_step`` a step, the
    step-2 snapshot, the sessions block; the registry's rollout series."""
    sink, reg = ListSink(), pkg["metrics"].MetricsRegistry()
    srv = _server(pkg, sink, session_snapshot_every=2, metrics=reg).start()
    pushed = []
    fut = srv.submit_rollout(pkg["samples"][0], 4, on_step=lambda sid, k, o: pushed.append(k))
    streamed = [k for k, _ in fut.iter_steps(timeout=30)]
    res = fut.result(timeout=30)
    summary = srv.drain(30)
    snap = pkg["metrics"].MetricsPublisher(reg, interval_s=1.0).close()["series"]
    series = {k: v.get("value", v.get("count")) for k, v in snap.items()
              if k.startswith(("rollout", "serve_resident", "serve_requests", "serve_completed"))}
    assert streamed == pushed == [1, 2, 3, 4]
    probes = (len(srv.step_latencies_ms()), srv.step_latency_histogram().count,
              srv.resident_sessions(), srv.has_session(res.session))
    return _outcome([res], sink, summary, series=series, probes=probes)


def _drain(pkg, tmp_path):
    """A drain mid-rollout (asked for at step 2's callback): the session
    resolves ``drained`` with ``drained_at_step`` 2 and its prefix."""
    sink = ListSink()
    srv = _server(pkg, sink).start()
    done = {}

    def on_step(sid, k, out):
        if k == 2:
            t = threading.Thread(target=lambda: done.update(summary=srv.drain(30)))
            t.start()
            done["thread"] = t
            while not srv._draining.is_set():
                time.sleep(0.001)

    res = srv.submit_rollout(pkg["samples"][0], 50, on_step=on_step).result(timeout=30)
    done["thread"].join(30)
    return _outcome([res], sink, done["summary"])


def _sigterm(pkg, tmp_path):
    """SIGTERM at step 2's callback: the step already chained runs, then
    both sessions resolve ``drained`` at step 3; none stays resident."""
    sink = ListSink()
    with pkg["preempt"]() as preempt:
        srv = _server(pkg, sink, preempt=preempt)

        def on_step(sid, k, out):
            if k == 2 and sid == "s0001":
                os.kill(os.getpid(), signal.SIGTERM)
                deadline = time.monotonic() + 10
                while not preempt.triggered and time.monotonic() < deadline:
                    time.sleep(0.001)

        futs = [srv.submit_rollout(s, 25, on_step=on_step) for s in pkg["samples"][:2]]
        srv.start()
        results = [f.result(timeout=30) for f in futs]
        summary = srv.drain(30)
    return _outcome(results, sink, summary)


def _step_deadline(pkg, tmp_path):
    """``slow_request@1`` under a 150 ms per-step deadline: the session is
    shed at step 1 with no output."""
    sink = ListSink()
    srv = _server(pkg, sink, default_deadline_ms=150.0,
                  faults=pkg["faults"].FaultInjector.from_spec("slow_request@1")).start()
    res = srv.submit_rollout(pkg["samples"][0], 4).result(timeout=30)
    return _outcome([res], sink, srv.drain(30))


def _rollout_deadline(pkg, tmp_path):
    """The whole-rollout budget (1 s) spent at step 2 (the clock moves 10
    s in its callback): the session is shed before step 3 is enqueued."""
    sink, clock = ListSink(), OffsetClock()
    srv = _server(pkg, sink, clock=clock).start()

    def on_step(sid, k, out):
        if k == 2:
            clock.offset += 10.0

    res = srv.submit_rollout(pkg["samples"][0], 6, rollout_deadline_ms=1_000.0,
                             on_step=on_step).result(timeout=30)
    return _outcome([res], sink, srv.drain(30))


def _stale(pkg, tmp_path):
    """``stale_session@2`` on a standalone server: step 2 fails and, with
    nobody to migrate it, the session ends lost."""
    sink, reg = ListSink(), pkg["metrics"].MetricsRegistry()
    srv = _server(pkg, sink, metrics=reg,
                  faults=pkg["faults"].FaultInjector.from_spec("stale_session@2")).start()
    res = srv.submit_rollout(pkg["samples"][0], 4).result(timeout=30)
    summary = srv.drain(30)
    lost = reg.counter("rollout_sessions_lost_total").value
    return _outcome([res], sink, summary, lost=lost)


def _rollout_nan(pkg, tmp_path):
    """Two sessions in lockstep, ``rollout_nan@3``: their second shared
    dispatch is poisoned whole, both fail ``error_nan_output`` (lost)."""
    sink = ListSink()
    srv = _server(pkg, sink, faults=pkg["faults"].FaultInjector.from_spec("rollout_nan@3"))
    futs = [srv.submit_rollout(s, 4) for s in pkg["samples"][:2]]
    srv.start()
    results = [f.result(timeout=30) for f in futs]
    return _outcome(results, sink, srv.drain(30))


def _replica_kill(pkg, tmp_path):
    """``replica_kill@3``: the worker dies before the second dispatch;
    both sessions resolve ``error_replica_dead`` and the worker exits."""
    sink = ListSink()
    srv = _server(pkg, sink, faults=pkg["faults"].FaultInjector.from_spec("replica_kill@3"))
    futs = [srv.submit_rollout(s, 4) for s in pkg["samples"][:2]]
    srv.start()
    results = [f.result(timeout=30) for f in futs]
    srv._worker.join(10)
    alive = srv._worker.is_alive()
    return _outcome(results, sink, srv.drain(30), alive=alive)


def _mixed(pkg, tmp_path):
    """Two one-shot requests and two 3-step sessions in one bucket: every
    dispatch is one of the bucket's, the one-shots are served as alone."""
    sink = ListSink()
    srv = _server(pkg, sink)
    s = pkg["samples"]
    ones = [srv.submit(x) for x in s[2:4]]
    futs = [srv.submit_rollout(x, 3) for x in s[:2]]
    srv.start()
    results = [f.result(timeout=30) for f in futs]
    one = [f.result(timeout=30) for f in ones]
    key = pkg["engine"].bucket_key(s[2])
    alone = pkg["engine"].infer(s[2:4], pad_nodes=key[0], pad_funcs=key[1], rows=MAX_BATCH)
    assert all(r.ok and np.array_equal(r.output, a) for r, a in zip(one, alone))
    return _outcome(results, sink, srv.drain(30), one=[r.output for r in one])


SCENARIOS = {"completed_streamed": _completed, "drain_mid_rollout": _drain, "sigterm": _sigterm,
             "step_deadline": _step_deadline, "rollout_deadline": _rollout_deadline,
             "stale_session": _stale, "rollout_nan": _rollout_nan,
             "replica_kill": _replica_kill, "mixed_with_one_shot": _mixed}

EXPECT = {
    "completed_streamed": [(True, "ok", 4, None)],
    "drain_mid_rollout": [(False, "drained", 2, 2)],
    "sigterm": [(False, "drained", 3, 3)] * 2,
    "step_deadline": [(False, "shed_deadline", 0, None)],
    "rollout_deadline": [(False, "shed_deadline", 2, None)],
    "stale_session": [(False, "error_stale_session", 1, None)],
    "rollout_nan": [(False, "error_nan_output", 1, None)] * 2,
    "replica_kill": [(False, "error_replica_dead", 1, None)] * 2,
    "mixed_with_one_shot": [(True, "ok", 3, None)] * 2,
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_the_rollout_script_runs_as_in_jax(name, setup, tmp_path):
    got = SCENARIOS[name](setup["port"], tmp_path / "port")
    want = SCENARIOS[name](setup["jax"], tmp_path / "jax")
    _assert_same(got, want)
    assert [(r.ok, r.reason, r.steps_completed, r.drained_at_step)
            for r in got["results"]] == EXPECT[name]
    _hold_to_offline(setup["port"], got["results"], setup["port"]["samples"])
    sessions = got["summary"]["sessions"]
    assert sessions["resident"] == 0
    if name == "completed_streamed":
        assert got["series"] == want["series"]
        assert got["series"]["rollout_steps_total"] == 4
        assert got["series"]["rollout_sessions_total{outcome=completed}"] == 1
        assert got["series"]["rollout_step_latency_ms"] == 4
        assert [e.get("step") for e in got["events"] if e["event"] == "session_snapshot"] == [2]
        assert got["probes"] == want["probes"] == (4, 4, 0, False)
    if name in ("stale_session",):
        assert got["lost"] == want["lost"] == 1
    if name == "replica_kill":
        assert not got["alive"] and not want["alive"]
        assert got["summary"]["shed"] == {"error_replica_dead": 2}
    if name == "mixed_with_one_shot":
        for a, b in zip(got["one"], want["one"]):
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)


def _resume(pkg, tmp_path):
    """A named, tagged session drained at step 2 persists its snapshot
    before it resolves; a fresh server resumes it from the store to the
    end, under its tenant; the store is left empty."""
    store = pkg["rollout"].SessionStore(str(tmp_path / "sessions"))
    pol = pkg["policies"].TenantPolicy(weights={"alice": 2})
    sink = ListSink()
    srv = _server(pkg, sink, session_store=store, tenants=pol).start()
    done = {}

    def on_step(sid, k, out):
        if k == 2:
            t = threading.Thread(target=lambda: done.update(summary=srv.drain(30)))
            t.start()
            done["thread"] = t
            while not srv._draining.is_set():
                time.sleep(0.001)

    first = srv.submit_rollout(pkg["samples"][0], 5, name="tagged-run", tenant="alice",
                               on_step=on_step).result(timeout=30)
    done["thread"].join(30)
    persisted = store.names()
    sink2 = ListSink()
    srv2 = _server(pkg, sink2, session_store=store, tenants=pol).start()
    with pytest.raises(KeyError):
        srv2.resume_rollout("no-such-run")
    fut = srv2.resume_rollout("tagged-run")
    streamed = [k for k, _ in fut.iter_steps(timeout=30)]
    second = fut.result(timeout=30)
    summary = srv2.drain(30)
    return dict(results=[first, second], persisted=persisted, left=store.names(),
                streamed=streamed, events=_events(sink.records) + _events(sink2.records),
                summary=[_summary(done["summary"]), _summary(summary)])


def test_a_drained_session_resumes_from_the_store_as_in_jax(setup, tmp_path):
    got = _resume(setup["port"], tmp_path / "port")
    want = _resume(setup["jax"], tmp_path / "jax")
    assert [_session(r) for r in got["results"]] == [_session(r) for r in want["results"]]
    assert (got["events"], got["summary"]) == (want["events"], want["summary"])
    assert got["persisted"] == ["tagged-run"] and got["left"] == [] == want["left"]
    assert got["streamed"] == want["streamed"] == [3, 4, 5]
    first, second = got["results"]
    assert (first.reason, first.drained_at_step, second.ok, len(second.outputs)) == (
        "drained", 2, True, 5)
    # The drain's snapshot is persisted before the session resolves.
    snaps = [e for e in got["events"] if e["event"] == "session_snapshot"]
    assert {"event": "session_snapshot", "session": "tagged-run", "step": 2,
            "persisted": True} in snaps
    assert got["summary"][1]["tenants"]["alice"]["completed"] == 3
    # The prefix joined to the resumed steps is the uninterrupted trajectory.
    pkg = setup["port"]
    offline = rollout.offline_rollout(pkg["engine"], pkg["samples"][0], 5, rows=MAX_BATCH)
    assert rollout.parity_check(second.outputs, offline) <= PARITY
    for a, b in zip(second.outputs, want["results"][1].outputs):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)


def _persisted_cursors(server, sample, store) -> list:
    """Drive one named 3-step session through a started ``server`` with
    ``persist_snapshots`` and a store, reading the store's cursor at each
    step's callback (which runs before that step's own snapshot is
    written); the session must complete and leave no file behind."""
    seen = []
    fut = server.submit_rollout(
        sample, 3, name="kept",
        on_step=lambda sid, step, out: seen.append((step, (store.load(sid) or {}).get("cursor"))))
    assert fut.result(timeout=30).ok
    server.drain(5)
    assert store.names() == []
    return seen


def test_the_server_refuses_what_waits_for_the_router(setup, tmp_path):
    """With ``persist_snapshots`` and a store (JAX's rolling persistence,
    the federation's migration substrate) each due snapshot of a named
    session is on disk before the session ends; the checks the server
    still makes, as JAX's."""
    pkg = setup["port"]
    store = rollout.SessionStore(str(tmp_path / "store"))
    persisting = InferenceServer(pkg["engine"], max_batch=MAX_BATCH, session_store=store,
                                 persist_snapshots=True).start()
    assert _persisted_cursors(persisting, pkg["samples"][0], store) == [(1, None), (2, 1), (3, 2)]
    with pytest.raises(ValueError, match="session_snapshot_every"):
        InferenceServer(pkg["engine"], session_snapshot_every=0)
    srv = InferenceServer(pkg["engine"], max_batch=MAX_BATCH)
    with pytest.raises(RuntimeError, match="no session store"):
        srv.resume_rollout("x")
    with pytest.raises(ValueError, match="needs"):
        srv.submit_rollout(pkg["samples"][0])
    fut = srv.submit_rollout(pkg["samples"][0], 2, name="x")
    assert srv.has_session("x") and srv.resident_sessions() == 1
    with pytest.raises(ValueError, match="already resident"):
        srv.submit_rollout(pkg["samples"][1], 2, name="x")
    srv.drain(5)
    assert fut.result(timeout=5).reason == "drained" and srv.resident_sessions() == 0


def test_a_failed_step_hands_the_session_to_its_migrate_cb(setup):
    """With a ``migrate_cb`` (the router's hand-over) a step failing on a
    server signal passes the session on instead of ending it."""
    pkg = setup["port"]
    handed = []
    session = rollout.RolloutSession("m1", pkg["samples"][0], 3)
    session.migrate_cb = lambda *args: handed.append(args)
    srv = InferenceServer(pkg["engine"], max_batch=MAX_BATCH, max_wait_ms=1.0,
                          faults=faults.FaultInjector.from_spec("stale_session@2")).start()
    srv.submit_rollout(session=session)
    deadline = time.monotonic() + 30
    while not handed and time.monotonic() < deadline:
        time.sleep(0.01)
    summary = srv.drain(30)
    [(s, reason, detail, replica)] = handed
    assert (s is session, reason, replica, session.cursor) == (
        True, "error_stale_session", None, 1)
    assert not session.future.done() and summary["sessions"]["failed"] == 0


# -- the command line -----------------------------------------------------------

FLAGS = ["serve_rollout_steps", "session_snapshot_every", "session_dir"]


def test_the_three_rollout_flags_take_jax_s_defaults_help_and_refusals():
    jp, pp = jax_main.build_parser(), port_main.build_parser()
    assert {f: getattr(pp.parse_args([]), f) for f in FLAGS} == {
        f: getattr(jp.parse_args([]), f) for f in FLAGS}
    helps = lambda p: {a.dest: a.help for a in p._actions if a.dest in FLAGS}  # noqa: E731
    assert helps(pp) == helps(jp) and len(helps(pp)) == 3
    argv = ["--serve_rollout_steps", "8", "--session_snapshot_every", "2", "--session_dir", "d"]
    _, port = port_main.configs_from_args(pp.parse_args(argv))
    jax_sc = jax_main.config_from_args(jp.parse_args(argv)).serve
    for field in ("rollout_steps", "session_snapshot_every", "session_dir"):
        assert getattr(port, field) == getattr(jax_sc, field)
    for field, bad in (("rollout_steps", -1), ("session_snapshot_every", 0)):
        with pytest.raises(ValueError) as want:
            make_config(**{f"serve.{field}": bad})
        with pytest.raises(ValueError) as got:
            ServeConfig(**{field: bad})
        assert str(got.value) == str(want.value)


def test_main_serves_rollout_sessions_on_the_cpu(tmp_path, capsys):
    """``main --serve --serve_rollout_steps 3`` with snapshots every 2
    steps: four sessions complete, 12 steps, the Serve line's sessions
    clause; main returns the completed fraction."""
    argv = ["--serve", "--device", "cpu", "--synthetic", "darcy2d", "--n_test", "4",
            "--n_attn_layers", "2", "--n_attn_hidden_dim", "16", "--n_mlp_num_layers", "1",
            "--n_mlp_hidden_dim", "16", "--n_input_hidden_dim", "16", "--n_expert", "2",
            "--n_head", "2", "--ffn_impl", "pallas", "--serve_rollout_steps", "3",
            "--session_snapshot_every", "2", "--session_dir", str(tmp_path / "s"),
            "--metrics_path", str(tmp_path / "m.jsonl")]
    assert port_main.main(argv) == 1.0
    out = capsys.readouterr().out
    [line] = [ln for ln in out.splitlines() if ln.startswith("Serve:")]
    assert "sessions=4/4 complete (migrated=0, lost=0)" in line and "12/12 ok" in line
    recs = [json.loads(ln) for ln in open(tmp_path / "m.jsonl")]
    steps = [r for r in recs if r.get("event") == "rollout_step"]
    assert len(steps) == 12 and {r["steps"] for r in steps} == {3}
    assert [r["step"] for r in recs if r.get("event") == "session_snapshot"] == [2] * 4
    [summary] = [r for r in recs if r.get("event") == "serve_summary"]
    assert summary["sessions"]["completed"] == 4 and summary["sessions"]["steps"] == 12
    assert os.listdir(tmp_path / "s") == []  # unnamed sessions never persist
