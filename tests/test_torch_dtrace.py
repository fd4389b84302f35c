"""The port's cluster tracing (``gnot_tpu_torch/obs/dtrace.py``, the
receiving side of ``obs/tracing.py``) and its lock guard
(``gnot_tpu_torch/utils/lockguard.py``) against the JAX package's.

Held equal: ``TraceContext`` wire dicts and the decoding of malformed
ones; ``ClockSync`` offsets and round trips (the least-RTT exchange
trusted, a retrograde one discarded, the window evicting); the merged
trace of ``merge_traces``; the ``FlightRecorder`` ring's evictions and
dump; the ``FlightRecorderSink`` triggers; ``Tracer.adopt``'s ids and
coverage with and without a recorder, shadow ids at rate 0 included. A
stitched two-host trace of the port's federation on a fake clock is read
by ``tools/trace_report.py``, run as it is. The lock guard: off mode
leaves ``threading.Lock`` the factory it found, and a witnessed inversion
dumps the recorder's ring; the factories are restored afterwards.
"""

import importlib.util
import json
import os
import threading
import warnings

import numpy as np
import pytest

from gnot_tpu.obs import dtrace as jax_dtrace
from gnot_tpu.obs import tracing as jax_tracing
from gnot_tpu_torch.config import ModelConfig
from gnot_tpu_torch.data import datasets
from gnot_tpu_torch.models.gnot import GNOT
from gnot_tpu_torch.obs import dtrace, tracing
from gnot_tpu_torch.serve.federation import build_local_federation
from gnot_tpu_torch.serve.replica import build_replicas
from gnot_tpu_torch.serve.rollout import SessionStore
from gnot_tpu_torch.utils import lockguard

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = {"jax": (jax_dtrace, jax_tracing), "port": (dtrace, tracing)}


class FakeClock:
    def __init__(self, t: float = 10.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


# -- trace context ---------------------------------------------------------------

WIRE_INPUTS = [
    None, "t000001", {}, {"trace_id": ""}, {"trace_id": "t000003"},
    {"trace_id": "!t000004", "sampled": False}, {"trace_id": 7, "span_id": 9, "tenant": 3},
    {"trace_id": "r000002", "span_id": None, "sampled": 0, "tenant": "alice"},
]


@pytest.mark.parametrize("d", WIRE_INPUTS, ids=range(len(WIRE_INPUTS)))
def test_trace_contexts_decode_and_encode_as_jax_s(d):
    got, want = dtrace.TraceContext.from_wire(d), jax_dtrace.TraceContext.from_wire(d)
    assert (got is None) == (want is None)
    if got is not None:
        assert got.to_wire() == want.to_wire()
        assert dtrace.TraceContext.from_wire(got.to_wire()) == got
    ctx = dtrace.TraceContext("t1", span_id="s2", sampled=False, tenant="bob")
    assert ctx.to_wire() == jax_dtrace.TraceContext("t1", span_id="s2", sampled=False,
                                                    tenant="bob").to_wire()


# -- clock alignment --------------------------------------------------------------

#: (host, t_send, t_recv, remote_t): a slow exchange, a faster one, a
#: retrograde one (discarded), then more than the window of 3.
CLOCK_OBS = [
    ("h0", 1.0, 1.2, 6.3), ("h0", 2.0, 2.02, 7.1), ("h1", 1.0, 1.1, 0.2),
    ("h0", 3.0, 2.9, 9.0), ("h1", 2.0, 2.001, 1.0005), ("h0", 4.0, 4.5, 9.3),
    ("h0", 5.0, 5.3, 10.1), ("h0", 6.0, 6.1, 11.05),
]


def _clock_trace(mod) -> list:
    cs = mod.ClockSync(window=3)
    out = [cs.offset("h0"), cs.rtt_ms("h0")]
    for i, obs in enumerate(CLOCK_OBS):
        cs.observe(*obs)
        out.append((i, cs.offset(obs[0]), cs.rtt_ms(obs[0])))
    out.append(cs.snapshot())
    return out


def test_clock_sync_estimates_as_jax_s():
    got = _clock_trace(dtrace)
    assert got == _clock_trace(jax_dtrace)
    assert got[-1]["h0"]["samples"] == 3 and got[-1]["h1"]["samples"] == 2
    with pytest.raises(ValueError):
        dtrace.ClockSync(window=0)


# -- stitching -------------------------------------------------------------------


def _exports(trmod):
    """Three tracers' exports on fake clocks with different epochs."""
    out = {}
    for source, t0 in (("controller", 100.0), ("host0", 5.0), ("host1", 50.0)):
        clock = FakeClock(t0)
        tr = trmod.Tracer(clock=clock)
        tid = tr.start_trace()
        sid = tr.add_span("placement", t0, t0 + 0.001, trace=tid, args={"host": "host0"})
        tr.add_span("dispatch", t0 + 0.002, t0 + 0.01, trace=tid, parent_id=sid)
        out[source] = tr.export()
        for ev in out[source]["traceEvents"]:
            ev["pid"] = 1  # the process id differs between runs, not packages
    return out


def test_merge_traces_stitches_as_jax_s(tmp_path):
    offsets = {"host0": (-95.0, 0.001), "host1": (-50.0, 0.002)}
    got = dtrace.merge_traces(_exports(tracing), offsets=offsets)
    want = jax_dtrace.merge_traces(_exports(jax_tracing), offsets=offsets)
    assert got["otherData"].pop("generator") == "gnot_tpu_torch.obs.dtrace"
    want["otherData"].pop("generator")
    assert got == want
    names = [e["args"]["name"] for e in got["traceEvents"] if e["ph"] == "M"]
    assert names == ["controller", "host0", "host1"]
    spans = [e for e in got["traceEvents"] if e["ph"] == "X"]
    assert {e["args"].get("host") for e in spans} == {None, "host0", "host1"}
    path = dtrace.write_trace(str(tmp_path / "m" / "t.json"), got)
    assert json.load(open(path)) == got and not os.path.exists(path + ".tmp")


# -- the flight recorder ------------------------------------------------------------


def _recorder_script(dmod, trmod, d) -> dict:
    clock = FakeClock(0.0)
    rec = dmod.FlightRecorder(str(d), window_s=1.0, max_items=5, clock=clock, host="h0")
    tr = trmod.Tracer(clock=clock, recorder=rec, sample_rate=0.5)
    sink = dmod.FlightRecorderSink(None, rec)
    for i in range(6):
        clock.t = 0.3 * i
        tid = tr.start_trace()
        tr.add_span("dispatch", clock.t, clock.t + 0.1, trace=tid, tid=1)
        sink.log(event="queue_depth", depth=i)
    clock.t = 2.0
    sink.log(event="breaker_open", reason="nan", replica=0)
    snap = rec.snapshot()
    dump = json.load(open(rec.dumps[0]))
    return dict(snap=snap, dump=dump, files=[os.path.basename(p) for p in rec.dumps],
                kept=[s.trace_id for s in tr.snapshot()], cov=tr.coverage())


def test_the_flight_recorder_keeps_and_dumps_as_jax_s(tmp_path):
    got = _recorder_script(dtrace, tracing, tmp_path / "port")
    want = _recorder_script(jax_dtrace, jax_tracing, tmp_path / "jax")
    assert got == want
    assert got["files"] == ["flight_001_breaker_open.json"]
    assert got["dump"]["trigger"] == {"kind": "breaker_open", "t": 2.0, "reason": "nan"}
    assert got["snap"]["evicted"] > 0 and len(got["snap"]["entries"]) == 5
    # Sampled-out traces recorded shadow spans in the ring only.
    ring_ids = {e["trace_id"] for e in got["dump"]["entries"] if e["type"] == "span"}
    assert any(t.startswith("!") for t in ring_ids)
    assert got["kept"] and not any(t.startswith("!") for t in got["kept"])
    with pytest.raises(ValueError):
        dtrace.FlightRecorder(str(tmp_path), window_s=0)


@pytest.mark.parametrize("record", [
    {"event": "slo_alert", "state": "fire", "objective": "latency_p99"},
    {"event": "slo_alert", "state": "clear"}, {"event": "breaker_open", "replica": 1},
    {"event": "host_dead", "host": "host0", "reason": "lease_expired"},
    {"event": "non_finite_loss", "step": 3}, {"event": "shed", "reason": "x"}, {"step": 1},
])
def test_the_sink_triggers_on_jax_s_records(tmp_path, record):
    dumps = {}
    for name, (dmod, _) in PACKAGES.items():
        rec = dmod.FlightRecorder(str(tmp_path / name), clock=FakeClock())
        inner = []

        class Inner:
            def log(self, **f):
                inner.append(f)

        dmod.FlightRecorderSink(Inner(), rec).log(**record)
        dumps[name] = ([json.load(open(p))["trigger"] for p in rec.dumps], inner)
    assert dumps["port"] == dumps["jax"]
    assert set(dtrace.TRIGGER_EVENTS) == set(jax_dtrace.TRIGGER_EVENTS)


# -- adoption ------------------------------------------------------------------------

CTXS = [("t000001", True, None), ("t000001", True, None), ("!t000002", False, "a"),
        ("t000003", False, None), ("r000001", True, "b"), ("!t000002", False, "a")]


@pytest.mark.parametrize("recorder,rate", [(False, 1.0), (True, 1.0), (True, 0.0),
                                           (False, 0.0)])
def test_adopt_returns_jax_s_ids(tmp_path, recorder, rate):
    out = {}
    for name, (dmod, trmod) in PACKAGES.items():
        rec = dmod.FlightRecorder(str(tmp_path / name)) if recorder else None
        tr = trmod.Tracer(sample_rate=rate, recorder=rec)
        ids = [tr.adopt(dmod.TraceContext(t, sampled=s, tenant=ten)) for t, s, ten in CTXS]
        ids += [tr.adopt(None), tr.start_trace(), tr.start_trace("r")]
        for tid in ids:
            tr.add_span("dispatch", 0.0, 1.0, trace=tid)
        out[name] = (ids, tr.coverage(), [s.trace_id for s in tr.snapshot()],
                     rec.snapshot()["entries"] if rec else None)
    assert out["port"][:3] == out["jax"][:3]
    if recorder:
        strip = lambda es: [{k: v for k, v in e.items() if k not in ("tid", "span_id")}  # noqa
                            for e in es]
        assert strip(out["port"][3]) == strip(out["jax"][3])
    ids, cov, exported, _ = out["port"]
    assert cov["adopted"] == 4 and ids[0] == ids[1] == "t000001"
    assert not any(t.startswith("!") for t in exported)
    if recorder and rate == 0.0:
        assert ids[-2:] == ["!t000001", "!r000001"]


# -- a stitched two-host trace on the fake clock ------------------------------------


def test_a_stitched_two_host_trace_reads_in_trace_report(tmp_path, capsys):
    """The port's federation with a cluster tracer and a tracer per host, on
    a fake clock (heartbeats give each host a clock offset of 0 +/- 0):
    each request is one chain under one trace id across the controller and
    a host, the merged file has three sources, and
    ``tools/trace_report.py`` reads it."""
    samples = datasets.synth_darcy2d(4, seed=0, grid_n=8)
    cfg = ModelConfig(n_attn_layers=1, n_attn_hidden_dim=8, n_mlp_num_layers=1,
                      n_mlp_hidden_dim=8, n_input_hidden_dim=8, n_expert=2, n_head=2,
                      **datasets.infer_model_dims(samples))
    import torch

    model = GNOT(cfg, generator=torch.Generator().manual_seed(0))
    groups = [[r] for r in build_replicas(model, 2, batch_size=2)]
    clock = FakeClock(100.0)
    path = str(tmp_path / "t.json")
    cluster, agents = build_local_federation(
        groups, clock=clock, session_store=SessionStore(str(tmp_path / "s")),
        cluster_tracer=tracing.Tracer(clock=clock),
        tracer_factory=lambda h: tracing.Tracer(clock=clock), trace_path=path,
        router_kwargs=dict(max_batch=2, max_wait_ms=0.0))
    try:
        for a in agents.values():
            a.router.start()
        cluster.tick()
        ones = [f.result(timeout=30) for f in [cluster.submit(s) for s in samples[:2]]]
        ses = cluster.submit_rollout(samples[2], 2, name="traced").result(timeout=30)
        summary = cluster.drain(10.0)
    finally:
        for a in agents.values():
            a.router.drain(10.0)
    assert all(r.ok for r in ones) and ses.ok
    merged = json.load(open(path))
    assert sorted(merged["otherData"]["hosts"]) == ["controller", "host0", "host1"]
    assert set(summary["trace_coverage"]) == {"controller", "host0", "host1"}
    source = {e["pid"]: e["args"]["name"] for e in merged["traceEvents"] if e["ph"] == "M"}
    by_trace: dict = {}
    for e in merged["traceEvents"]:
        if e["ph"] == "X":
            by_trace.setdefault(e["args"]["trace_id"], set()).add((source[e["pid"]], e["name"]))
    assert len(by_trace) == 3
    for tid, names in by_trace.items():
        roots = {"cluster_request"} if tid.startswith("t") else {"cluster_rollout"}
        assert {("controller", "placement")} | {("controller", r) for r in roots} <= names
        assert any(h.startswith("host") and n == "dispatch" for h, n in names), tid
    spec = importlib.util.spec_from_file_location(
        "gnot_tool_trace_report", os.path.join(REPO, "tools", "trace_report.py"))
    trace_report = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(trace_report)
    assert trace_report.main([path]) == 0
    out = capsys.readouterr().out
    assert "cluster_request" in out and "host1" in out


# -- the lock guard ---------------------------------------------------------------------


@pytest.fixture
def restored_factories(monkeypatch):
    """The lock factories and the guard's mode as found (the JAX package's
    guard may be installed in this process), restored after the test."""
    lock, rlock = threading.Lock, threading.RLock
    monkeypatch.setattr(lockguard, "on_report", None)
    yield
    threading.Lock, threading.RLock = lock, rlock
    lockguard._mode = "off"
    lockguard.reset()


def test_the_lock_guard_off_leaves_the_factories(monkeypatch, restored_factories):
    monkeypatch.setenv("GNOT_LOCK_GUARD", "0")
    found = threading.Lock
    assert lockguard.install() == "off" == lockguard.installed_mode()
    assert threading.Lock is found is lockguard._ORIG_LOCK
    assert threading.RLock is lockguard._ORIG_RLOCK
    assert lockguard.guard_mode() == "off"
    monkeypatch.setenv("GNOT_LOCK_GUARD", "strict")
    assert lockguard.guard_mode() == "strict"


def test_a_witnessed_inversion_dumps_the_flight_recorder(monkeypatch, tmp_path,
                                                         restored_factories):
    monkeypatch.setenv("GNOT_LOCK_GUARD", "witness")
    lockguard.reset()
    assert lockguard.install() == "witness"
    # Two construction sites under tests/, so both are wrapped; made through
    # a local name, so the repository's static lock census does not count
    # this deliberate inversion as a cycle of the code.
    make = threading.Lock
    a = make()
    b = make()
    assert "lockguard" in repr(a)
    rec = dtrace.FlightRecorder(str(tmp_path), clock=FakeClock())
    rec.watch_lockguard()
    with a:
        with b:
            pass
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        with b:
            with a:
                pass
    assert len(lockguard.inversions()) == 1 and caught
    assert [os.path.basename(p) for p in rec.dumps] == ["flight_001_lockguard_warning.json"]
    trigger = json.load(open(rec.dumps[0]))["trigger"]
    assert trigger["kind"] == "lockguard_warning" and "inversion" in trigger["message"]
    # a -> b, b -> a, and b -> the recorder's own lock (its dump ran while
    # b was held, after the graph's lock was released).
    np.testing.assert_equal(lockguard.edge_count(), 3)
