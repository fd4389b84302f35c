"""The port's federation (``gnot_tpu_torch/serve/federation.py``) against the
JAX package's (``gnot_tpu/serve/federation.py``).

* **Protocol**: the same byte streams through both ``FrameDecoder``s (one
  byte at a time, truncated, garbage, a zero-length prefix, oversize) give
  the same messages and counters; ``encode_frame``, ``MESSAGES``,
  ``PROTOCOL_VERSION``, ``MAX_FRAME_BYTES``, ``topology_key`` and
  ``encode_sample`` agree.
* **Detector and fault hooks**: one fake-clock script of probes, acks and
  sweeps gives both ``FailureDetector``s the same edges; one spec gives
  both injectors' federation hooks the same firing ordinals.
* **Across the wire**: JAX's ``ClusterRouter`` drives a port ``HostAgent``
  over JAX's ``InProcLink``; every frame the port sends passes JAX's
  ``validate_message``.
* **End to end**: two hosts of one replica each on a fake clock with
  in-proc links, through each package (the tiny width-16 model, f32, the
  JAX weights carried over by ``params_from_jax``; JAX's two engines share
  one jitted forward): one-shots within 1e-4 / 1e-5 of JAX's, rollouts step
  by step within that bar and bitwise the port's own ``offline_rollout``,
  a ``host_kill`` re-migrating with the same ``session_remigrate`` as JAX's
  and none lost, ``msg_drop`` / ``msg_delay`` with no false death, a
  partition that heals and reconciles, an idempotent drain, JAX's
  ``cluster_summary`` key set. One run over loopback TCP.
* **The command line**: the six flags and the config checks are JAX's; a
  tiny ``--hosts 2`` serve prints JAX's ``Federated serve:`` line.

Every wait is bounded in the test itself; every federation is drained and
its agents stopped on every exit path.
"""

import contextlib
import json
import re
import socket
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
from gnot_tpu.obs.tracing import Tracer as JaxTracer
from gnot_tpu.resilience import faults as jax_faults
from gnot_tpu.serve import EngineReplica as JaxReplica
from gnot_tpu.serve import InferenceEngine as JaxEngine
from gnot_tpu.serve import federation as jax_fed
from gnot_tpu.serve import rollout as jax_rollout
from gnot_tpu.train import trainer as jax_trainer
from gnot_tpu.train.trainer import apply_batch as jax_apply_batch
from gnot_tpu.train.trainer import init_params
from gnot_tpu_torch import main as port_main
from gnot_tpu_torch.config import ModelConfig, NotPortedError, ServeConfig
from gnot_tpu_torch.data import datasets
from gnot_tpu_torch.interop import params_from_jax
from gnot_tpu_torch.models.gnot import GNOT
from gnot_tpu_torch.obs import events
from gnot_tpu_torch.obs.tracing import Tracer
from gnot_tpu_torch.resilience import faults
from gnot_tpu_torch.serve import federation as fed
from gnot_tpu_torch.serve import rollout
from gnot_tpu_torch.serve.replica import EngineReplica, build_replicas
from gnot_tpu_torch.serve.router import ReplicaRouter

RTOL, ATOL = 1e-4, 1e-5
MAX_BATCH = 2
TINY = dict(n_attn_layers=1, n_attn_hidden_dim=16, n_mlp_num_layers=1, n_mlp_hidden_dim=16,
            n_input_hidden_dim=16, n_expert=2, n_head=2)
#: Router knobs of every federation here: no batching wait (the fake clock
#: never ages a queue), and no wedge verdict while the clock jumps.
ROUTER_KW = dict(max_batch=MAX_BATCH, max_wait_ms=0.0, wedge_after_s=600.0)


class ListSink:
    def __init__(self):
        self.records = []

    def log(self, **record):
        self.records.append(record)

    def flush(self):
        pass


class FakeClock:
    """A manual clock; ``run_free()`` lets it follow wall time from then on
    (a drain's deadline must pass even when a script failed midway)."""

    def __init__(self):
        self.t = 100.0
        self._free_at = None

    def __call__(self) -> float:
        if self._free_at is not None:
            return self.t + time.monotonic() - self._free_at
        return self.t

    def tick(self, dt: float) -> None:
        self.t += dt

    def run_free(self) -> None:
        if self._free_at is None:
            self._free_at = time.monotonic()


def _wait_for(cond, what: str, timeout: float = 30.0) -> None:
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.002)


@pytest.fixture(scope="module")
def setup():
    jsamples = jax_datasets.synth_darcy2d(8, seed=0, grid_n=8)
    psamples = datasets.synth_darcy2d(8, seed=0, grid_n=8)
    mc = dict(TINY, **jax_datasets.infer_model_dims(jsamples))
    jmodel = JaxGNOT(JaxModelConfig(**mc))
    params = jax.jit(lambda b: init_params(jmodel, b, 0))(jax_collate(jsamples[:2]))
    # One jitted forward for both JAX engines: each program compiles once.
    forward = jax.jit(lambda p, b: jax_apply_batch(jmodel, p, b))
    jengines = [JaxEngine(jmodel, params, batch_size=MAX_BATCH, forward=forward)
                for _ in range(2)]
    jengines[0].warmup(jsamples[:1], rows=MAX_BATCH)
    cfg = ModelConfig(**mc)
    model = GNOT(cfg)
    model.load_state_dict(params_from_jax(jax.device_get(params), cfg), strict=True)
    pengines = [r.engine for r in build_replicas(model, 2, batch_size=MAX_BATCH)]
    return {
        "jax": dict(fed=jax_fed, Replica=JaxReplica, rollout=jax_rollout, faults=jax_faults,
                    engines=jengines, samples=jsamples, Tracer=JaxTracer),
        "port": dict(fed=fed, Replica=EngineReplica, rollout=rollout, faults=faults,
                     engines=pengines, samples=psamples, Tracer=Tracer),
        "model": model,
    }


@contextlib.contextmanager
def _federation(pkg, tmp_path, *, store: bool = True, **kw):
    """Two hosts of one replica each (a fresh ``EngineReplica`` around each
    engine), started; on exit the cluster drains, every host the cluster
    could not drain drains locally, and the agents stop."""
    clock = kw.pop("clock", None) or FakeClock()
    sink = ListSink()
    session_store = pkg["rollout"].SessionStore(str(tmp_path / "sessions")) if store else None
    groups = [[pkg["Replica"](0, e)] for e in pkg["engines"]]
    kw.setdefault("router_kwargs", dict(ROUTER_KW))
    cluster, agents = pkg["fed"].build_local_federation(
        groups, sink=sink, clock=clock, session_store=session_store, **kw)
    try:
        for a in agents.values():
            a.router.start()
        yield cluster, agents, sink, clock
    finally:
        clock.run_free()
        summary = cluster.drain(10.0)
        for host_id, a in agents.items():
            if host_id not in summary.get("per_host", {}):
                a.router.drain(timeout_s=10.0)
            a.stop()
        if hasattr(cluster, "close"):  # the port's: TcpLink readers join
            cluster.close()


# -- the wire protocol ----------------------------------------------------------

def _streams(pkgfed):
    """Named byte streams of frames built by ``pkgfed``."""
    msgs = [pkgfed.wire("heartbeat", seq=i) for i in range(4)]
    whole = b"".join(pkgfed.encode_frame(m) for m in msgs)
    hello = pkgfed.encode_frame(pkgfed.wire("hello", version=1))
    return {
        "byte_at_a_time": [whole[i:i + 1] for i in range(len(whole))],
        "truncated": [hello[:3], hello[3:7], hello[7:-1], hello[-1:]],
        "garbage": [b"\x00\x00\x00\x05notjs" + (4).to_bytes(4, "big") + b"[1] " + hello],
        "zero_length": [b"\x00\x00\x00\x00" + hello],
        "oversize": [(9 * 1024 * 1024).to_bytes(4, "big") + b"z" * 1024,
                     b"z" * (9 * 1024 * 1024 - 1024), hello],
    }


@pytest.mark.parametrize("stream", ["byte_at_a_time", "truncated", "garbage", "zero_length",
                                    "oversize"])
def test_frame_decoders_read_the_same_stream_alike(stream):
    chunks = _streams(jax_fed)[stream]
    assert chunks == _streams(fed)[stream]
    got, want = fed.FrameDecoder(), jax_fed.FrameDecoder()
    got_msgs = [m for c in chunks for m in got.feed(c)]
    want_msgs = [m for c in chunks for m in want.feed(c)]
    assert got_msgs == want_msgs
    assert (got.garbage, got.oversize) == (want.garbage, want.oversize)
    assert got_msgs, stream  # every stream ends in a readable frame
    if stream in ("garbage", "zero_length", "oversize"):
        assert got.garbage + got.oversize >= 1


def test_the_wire_is_jax_s(setup):
    assert fed.PROTOCOL_VERSION == jax_fed.PROTOCOL_VERSION == 1
    assert fed.MAX_FRAME_BYTES == jax_fed.MAX_FRAME_BYTES == 8 * 1024 * 1024
    assert {k: (s.fields, s.optional) for k, s in fed.MESSAGES.items()} == {
        k: (s.fields, s.optional) for k, s in jax_fed.MESSAGES.items()}
    msg = {"kind": "submit", "id": "q00001", "sample": {"b64": "AAAA"}, "tenant": "t"}
    assert fed.encode_frame(msg) == jax_fed.encode_frame(msg)
    assert fed.topology_key(2, 3) == jax_fed.topology_key(2, 3) == "h2r3"
    for js, ps in zip(setup["jax"]["samples"][:2], setup["port"]["samples"][:2]):
        enc = fed.encode_sample(ps)
        assert enc == jax_fed.encode_sample(js)
        back = fed.decode_sample(enc)
        assert all(np.array_equal(a, b) for a, b in zip(
            (back.coords, back.y, back.theta, *back.funcs),
            (ps.coords, ps.y, ps.theta, *ps.funcs)))
    for bad in ({"kind": "nope"}, {"kind": "heartbeat"}, {"kind": "result", "id": "x"}):
        with pytest.raises(fed.ProtocolError) as got:
            fed.validate_message(bad)
        with pytest.raises(jax_fed.ProtocolError) as want:
            jax_fed.validate_message(bad)
        assert str(got.value) == str(want.value)
    with pytest.raises(fed.ProtocolError, match="exceeds MAX_FRAME_BYTES"):
        fed.encode_frame({"kind": "x", "pad": "z" * fed.MAX_FRAME_BYTES})


# -- the failure detector and the fault hooks ----------------------------------

#: (op, host, dt before it): a lease script with an idle gap, a dwell, a
#: flapping host, a death and a revival.
DETECTOR_SCRIPT = [
    ("register", "h0", 0.0), ("register", "h1", 0.0), ("probe", "h0", 5.0),
    ("probe", "h1", 0.0), ("ack", "h1", 0.1), ("sweep", None, 0.0), ("probe", "h1", 0.2),
    ("sweep", None, 1.8), ("ack", "h1", 0.1), ("sweep", None, 0.5), ("probe", "h1", 0.0),
    ("sweep", None, 3.0), ("ack", "h1", 0.1), ("sweep", None, 0.1), ("ack", "h0", 1.0),
    ("sweep", None, 0.0), ("probe", "h0", 0.0), ("sweep", None, 7.0), ("probe", "h1", 0.0),
    ("sweep", None, 0.0),
]


def _detector_trace(pkgfed) -> list:
    clock = FakeClock()
    det = pkgfed.FailureDetector(suspect_after_s=2.0, dead_after_s=6.0, clock=clock)
    out = []
    for op, host, dt in DETECTOR_SCRIPT:
        clock.tick(dt)
        if op == "sweep":
            out.append(("sweep", det.sweep(), {h: det.state(h) for h in ("h0", "h1")}))
        elif op == "ack":
            out.append(("ack", det.ack(host), round(det.silent_s(host), 9)))
        else:
            getattr(det, op)(host)
    return out


def test_the_detector_makes_jax_s_transitions():
    got = _detector_trace(fed)
    assert got == _detector_trace(jax_fed)
    edges = [e for op, es, *_ in got if op == "sweep" for e in es]
    assert ("h1", "alive", "suspect") in edges and ("h0", "alive", "dead") in edges
    for bad in ((2.0, 2.0), (0.0, 1.0)):
        with pytest.raises(ValueError) as g:
            fed.FailureDetector(suspect_after_s=bad[0], dead_after_s=bad[1])
        with pytest.raises(ValueError) as w:
            jax_fed.FailureDetector(suspect_after_s=bad[0], dead_after_s=bad[1])
        assert str(g.value) == str(w.value)


def _hook_fires(mod, spec: str) -> dict:
    fi = mod.FaultInjector.from_spec(spec)
    fires = {k: [n for n in range(1, 9) if getattr(fi, f"maybe_{k}")(n)]
             for k in ("host_kill", "net_partition", "msg_drop")}
    fires["msg_delay"] = [fi.maybe_msg_delay() for _ in range(4)]
    return fires


@pytest.mark.parametrize("spec", ["host_kill@3", "net_partition@2,msg_drop@5,msg_drop@6",
                                  "msg_delay@50,msg_delay@20,host_kill@1"])
def test_the_fault_hooks_fire_at_jax_s_ordinals(spec):
    got = _hook_fires(faults, spec)
    assert got == _hook_fires(jax_faults, spec)
    assert sum(map(len, list(got.values())[:3])) == sum(
        k != "msg_delay" for k in (e.split("@")[0] for e in spec.split(",")))


# -- a JAX controller drives a port host ---------------------------------------


def test_a_jax_controller_drives_a_port_host_across_the_wire(setup):
    """JAX's ``ClusterRouter`` (its tracer the sampling authority) over
    JAX's ``InProcLink`` to a port ``HostAgent``: one one-shot and one
    3-step rollout come back as the port's engine computes them, every
    frame the port sends is valid by JAX's registry, and the host's spans
    carry JAX's trace ids."""
    pkg = setup["port"]
    host_tracer = Tracer()
    router = ReplicaRouter([EngineReplica(0, pkg["engines"][0])], tracer=host_tracer,
                           **ROUTER_KW).start()
    agent = fed.HostAgent("host0", router, tracer=host_tracer)
    link = jax_fed.InProcLink(agent)
    sent = []
    reply = link._reply

    def checked_reply(msg):
        jax_fed.validate_message(msg)
        sent.append(msg["kind"])
        reply(msg)

    link._reply = checked_reply
    ctrl_tracer = JaxTracer()
    cluster = jax_fed.ClusterRouter(tracer=ctrl_tracer)
    try:
        cluster.add_host("host0", link)
        cluster.tick()
        s = pkg["samples"]
        one = cluster.submit(s[0]).result(timeout=30)
        ses = cluster.submit_rollout(s[1], 3, name="across").result(timeout=30)
        summary = cluster.drain(10.0)
    finally:
        router.drain(10.0)
    key = pkg["engines"][0].bucket_key(s[0])
    want = pkg["engines"][0].infer([s[0]], pad_nodes=key[0], pad_funcs=key[1], rows=MAX_BATCH)[0]
    assert one.ok and np.array_equal(one.output, want)
    offline = rollout.offline_rollout(pkg["engines"][0], s[1], 3, rows=MAX_BATCH)
    assert ses.ok and all(np.array_equal(a, b) for a, b in zip(ses.outputs, offline, strict=True))
    assert summary["completed"] == 2 and summary["protocol_errors"] == 0
    assert {"hello_ok", "heartbeat_ack", "result", "placed", "step", "rollout_done",
            "drain_ok", "trace_ok"} <= set(sent)
    jax_ids = {s.trace_id for s in ctrl_tracer.snapshot()}
    host_ids = {s.trace_id for s in host_tracer.snapshot()}
    assert host_ids and host_ids <= jax_ids
    assert host_tracer.coverage()["adopted"] == 2


class _StubRouter:
    def pool(self):
        return []


def test_a_port_host_refuses_prewarm_and_goes_on():
    agent = fed.HostAgent("h0", _StubRouter())
    got = []
    agent.handle(fed.wire("prewarm", manifest={}), got.append)
    agent.handle({"kind": "no_such_kind"}, got.append)
    agent.handle(fed.wire("hello", version=fed.PROTOCOL_VERSION), got.append)
    assert [m["kind"] for m in got] == ["error", "error", "hello_ok"]
    assert got[0]["bad_kind"] == "prewarm" and "not ported" in got[0]["reason"]
    assert agent.errors == 2
    with pytest.raises(NotPortedError, match="manifests"):
        fed.ClusterRouter(manifests={"h2r1": {}})
    with pytest.raises(NotPortedError, match="manifests"):
        fed.build_local_federation([], manifests={"h2r1": {}})


# -- end to end, two hosts on a fake clock -------------------------------------


def _serve_both(pkg, tmp_path):
    """Four one-shots, then two 3-step rollouts, then two drains."""
    with _federation(pkg, tmp_path) as (cluster, agents, sink, clock):
        cluster.tick()
        s = pkg["samples"]
        ones = [f.result(timeout=30) for f in [cluster.submit(x) for x in s[:4]]]
        sess = [f.result(timeout=30) for f in [
            cluster.submit_rollout(x, 3, name=f"sess-{i}") for i, x in enumerate(s[4:6])]]
        summary = cluster.drain(10.0)
        again = cluster.drain(10.0)
        left = agents["host0"].session_store.names()
    recs = [r for r in sink.records if r.get("event") == "cluster_summary"]
    return dict(ones=ones, sess=sess, summary=summary, again=again, recs=recs, left=left)


def test_a_federated_storm_serves_as_jax_s(setup, tmp_path):
    got = _serve_both(setup["port"], tmp_path / "port")
    want = _serve_both(setup["jax"], tmp_path / "jax")
    for g, w in zip(got["ones"], want["ones"], strict=True):
        assert g.ok and w.ok
        np.testing.assert_allclose(g.output, w.output, rtol=RTOL, atol=ATOL)
    pkg = setup["port"]
    for g, w, x in zip(got["sess"], want["sess"], pkg["samples"][4:6], strict=True):
        assert g.ok and w.ok and len(g.outputs) == len(w.outputs) == 3
        for a, b in zip(g.outputs, w.outputs):
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
        offline = rollout.offline_rollout(pkg["engines"][0], x, 3, rows=MAX_BATCH)
        assert all(np.array_equal(a, b) for a, b in zip(g.outputs, offline))
    keys = lambda s: {k: v for k, v in s.items() if k != "per_host"}  # noqa: E731
    assert keys(got["summary"]) == keys(want["summary"])
    assert got["summary"]["completed"] == 6 and got["summary"]["lost"] == 0
    assert set(got["summary"]["per_host"]) == {"host0", "host1"}
    # Idempotent: one cluster_summary, the second drain's ledger the first's.
    assert keys(got["again"]) == keys(got["summary"])
    assert len(got["recs"]) == len(want["recs"]) == 1
    assert set(got["recs"][0]) == set(want["recs"][0])
    assert events.validate_record(got["recs"][0]) == []
    assert got["left"] == want["left"] == []


def _host_kill(pkg, tmp_path):
    """Two 6-step sessions, one a host; host0's step-2 callback holds its
    worker while ``host_kill@3`` takes host0 at its first heartbeat; the
    fake clock moves host0 through SUSPECT to DEAD, its session re-migrates
    to host1 from the snapshot host0 persisted at step 1, and only then
    is host0's worker let go."""
    fi = pkg["faults"].FaultInjector.from_spec("host_kill@3")
    reached, gate = threading.Event(), threading.Event()

    def on_step(name, step, out):
        if name == "s0" and step == 2:
            reached.set()
            gate.wait(timeout=30)

    with _federation(pkg, tmp_path, host_faults={"host0": fi, "host1": fi},
                     suspect_after_s=0.2, dead_after_s=0.5) as (cluster, agents, sink, clock):
        try:
            futs = [cluster.submit_rollout(x, 6, name=f"s{i}", on_step=on_step)
                    for i, x in enumerate(pkg["samples"][:2])]
            assert reached.wait(timeout=30), "host0's session never reached step 2"
            edges = []
            for _ in range(5):
                edges += cluster.tick()
                if cluster.host_state("host0") == "dead":
                    break
                clock.tick(0.3)
            assert not agents["host0"].alive and agents["host1"].alive
        finally:
            gate.set()
        results = [f.result(timeout=60) for f in futs]
        summary = cluster.drain(10.0)
    kinds = lambda k: [{f: v for f, v in r.items() if f != "ts"}  # noqa: E731
                       for r in sink.records if r.get("event") == k]
    return dict(results=results, summary=summary, edges=edges,
                remigrate=kinds("session_remigrate"), dead=kinds("host_dead"))


def test_a_killed_host_s_sessions_remigrate_as_in_jax(setup, tmp_path):
    got = _host_kill(setup["port"], tmp_path / "port")
    want = _host_kill(setup["jax"], tmp_path / "jax")
    assert got["edges"] == want["edges"] == [("host0", "alive", "suspect"),
                                             ("host0", "suspect", "dead")]
    assert got["remigrate"] == want["remigrate"] == [{
        "event": "session_remigrate", "session": "s0", "from_host": "host0",
        "to_host": "host1", "at_step": 2, "replay_from": 1, "reason": "host_dead"}]
    assert got["dead"] == want["dead"]
    for key in ("remigrated", "hosts_dead", "lost", "completed", "sessions"):
        assert got["summary"][key] == want["summary"][key], key
    assert (got["summary"]["remigrated"], got["summary"]["lost"]) == (1, 0)
    pkg = setup["port"]
    for r, x in zip(got["results"], pkg["samples"][:2], strict=True):
        assert r.ok and len(r.outputs) == 6
        offline = rollout.offline_rollout(pkg["engines"][1], x, 6, rows=MAX_BATCH)
        assert all(np.array_equal(a, b) for a, b in zip(r.outputs, offline, strict=True))
    assert got["results"][0].migrations == 1


def _noisy_links(pkg, tmp_path, spec: str, **kw):
    """Heartbeats through links armed with ``spec``, then four one-shots
    while the clock moves; with ``heal`` the partitioned host0 dwells in
    SUSPECT (its one-shots hedged) and is healed before the dead bound."""
    heal = kw.pop("heal", False)
    fi = pkg["faults"].FaultInjector.from_spec(spec)
    link_faults = {"host0": fi} if heal else {"host0": fi, "host1": fi}
    with _federation(pkg, tmp_path, store=False, link_faults=link_faults,
                     **kw) as (cluster, agents, sink, clock):
        states = []
        if not heal:
            for _ in range(8):
                cluster.tick()
                clock.tick(0.1)
        futs = [cluster.submit(x) for x in pkg["samples"][:4]]
        link = cluster._hosts["host0"].link
        for _ in range(10):
            edges = cluster.tick()
            states += [e[2] for e in edges]
            clock.tick(0.1)
            if heal and cluster.host_state("host0") == "suspect":
                break
        if heal:
            assert link.partitioned
            link.heal_partition()
        results = [f.result(timeout=30) for f in futs]
        for _ in range(3):
            states += [e[2] for e in cluster.tick()]
            clock.tick(0.1)
        final = cluster.host_state("host0")
        summary = cluster.drain(10.0)
    return dict(results=results, summary=summary, states=states, final=final)


@pytest.mark.parametrize("case", ["drop_and_delay", "partition"])
def test_lossy_links_cause_no_false_death_as_in_jax(setup, tmp_path, case):
    kw = (dict(spec="msg_drop@3,msg_delay@50", suspect_after_s=0.3, dead_after_s=5.0)
          if case == "drop_and_delay" else
          dict(spec="net_partition@3", suspect_after_s=0.2, dead_after_s=30.0, heal=True))
    got = _noisy_links(setup["port"], tmp_path / "port", **kw)
    want = _noisy_links(setup["jax"], tmp_path / "jax", **kw)
    for g, w in zip(got["results"], want["results"], strict=True):
        assert g.ok and w.ok
        np.testing.assert_allclose(g.output, w.output, rtol=RTOL, atol=ATOL)
    for key in ("hosts_dead", "lost", "completed", "requests"):
        assert got["summary"][key] == want["summary"][key], key
    assert (got["summary"]["hosts_dead"], got["summary"]["lost"]) == (0, 0)
    assert "dead" not in got["states"] and got["final"] == want["final"] == "alive"
    if case == "partition":
        # The healed link's next ack revives host0 (ack, not a sweep edge).
        assert got["states"] == want["states"] == ["suspect"]


def _free_port_pair() -> int:
    """A port p >= 1024 with p and p + 1 both free on loopback."""
    for _ in range(50):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            p = s.getsockname()[1]
        if p < 1024 or p + 1 > 65535:
            continue
        with socket.socket() as s2:
            try:
                s2.bind(("127.0.0.1", p + 1))
            except OSError:
                continue
        return p
    raise AssertionError("no free loopback port pair")


def test_two_hosts_over_loopback_tcp(setup, tmp_path):
    """The same federation over real sockets (the TCP readers deliver on
    their own threads), bounded in the test: two one-shots and one 2-step
    rollout, then the drain, the agents' stop and the links' close."""
    pkg = setup["port"]
    base = _free_port_pair()
    with _federation(pkg, tmp_path, clock=FakeClock(), tcp_base_port=base) as (
            cluster, agents, sink, clock):
        clock.run_free()
        cluster.tick()
        _wait_for(lambda: all(h.rtt_ms is not None for h in cluster._hosts.values()),
                  "heartbeat acks over TCP", timeout=10)
        ones = [f.result(timeout=30) for f in [cluster.submit(x) for x in pkg["samples"][:2]]]
        ses = cluster.submit_rollout(pkg["samples"][2], 2, name="tcp").result(timeout=30)
        summary = cluster.drain(10.0)
        assert set(summary["per_host"]) == {"host0", "host1"}
    assert all(r.ok for r in ones) and ses.ok and len(ses.outputs) == 2
    assert summary["protocol_errors"] == 0 and summary["hosts_dead"] == 0
    with pytest.raises(ValueError, match="in-proc chaos hooks"):
        fed.build_local_federation([], tcp_base_port=base, link_faults={"host0": None})


# -- the command line -----------------------------------------------------------

FLAGS = ["hosts", "federation_port", "heartbeat_interval_s", "suspect_after_s",
         "dead_after_s", "flight_recorder_s"]
TINY_ARGV = ["--serve", "--synthetic", "darcy2d", "--n_test", "8", "--n_train", "4",
             "--n_attn_layers", "1", "--n_attn_hidden_dim", "16", "--n_mlp_num_layers", "1",
             "--n_mlp_hidden_dim", "16", "--n_input_hidden_dim", "16", "--n_expert", "2",
             "--n_head", "2", "--serve_max_batch", "4", "--serve_replicas", "2", "--hosts", "2"]


@pytest.mark.parametrize("field,bad", [
    ("hosts", 0), ("federation_port", 80), ("heartbeat_interval_s", 0.0),
    ("suspect_after_s", 6.0), ("flight_recorder_s", -1.0)])
def test_the_federation_config_checks_are_jax_s(field, bad):
    extra = {"replicas": 2} if field == "hosts" else {}
    with pytest.raises(ValueError) as want:
        make_config(**{f"serve.{field}": bad, **{f"serve.{k}": v for k, v in extra.items()}})
    with pytest.raises(ValueError) as got:
        ServeConfig(**{field: bad, **extra})
    assert str(got.value) == str(want.value)


def test_the_six_flags_and_the_refusals_are_jax_s():
    jp, pp = jax_main.build_parser(), port_main.build_parser()
    actions = lambda p: {a.dest: (a.type, a.default, a.help) for a in p._actions  # noqa: E731
                         if a.dest in FLAGS}
    assert actions(pp) == actions(jp) and len(actions(pp)) == 6
    argv = ["--serve_replicas", "4", "--hosts", "2", "--federation_port", "9100",
            "--heartbeat_interval_s", "0.1", "--suspect_after_s", "0.5", "--dead_after_s", "1.5",
            "--flight_recorder_s", "5"]
    _, port = port_main.configs_from_args(pp.parse_args(argv))
    jax_sc = jax_main.config_from_args(jp.parse_args(argv)).serve
    assert {f: getattr(port, f) for f in FLAGS} == {f: getattr(jax_sc, f) for f in FLAGS}
    for bad in ({"replicas": 3, "hosts": 2}, {"replicas": 2, "hosts": 2, "autoscale": True}):
        with pytest.raises(ValueError) as want:
            make_config(**{f"serve.{k}": v for k, v in bad.items()})
        with pytest.raises(ValueError) as got:
            ServeConfig(**bad)
        assert str(got.value) == str(want.value)


def test_main_serves_through_two_hosts_as_jax_s(tmp_path, capsys, monkeypatch):
    """``main --serve --serve_replicas 2 --hosts 2`` on the CPU and
    ``gnot_tpu.main`` with the same flags: JAX's ``Federated serve:`` line
    with the same counts, every request answered, and the cluster summary
    in run.json."""
    init = jax_trainer.init_params
    # JAX's weight init under one jax.jit (bitwise its eager result).
    monkeypatch.setattr(jax_trainer, "init_params", lambda model, batch, seed: jax.jit(
        lambda b: init(model, b, seed))(batch))
    lines = {}
    for pkg, mod, extra in (("jax", jax_main, []), ("port", port_main, ["--device", "cpu"])):
        path = tmp_path / pkg / "m.jsonl"
        assert mod.main(TINY_ARGV + extra + ["--metrics_path", str(path)]) == 1.0
        out = capsys.readouterr().out
        [lines[pkg]] = [ln for ln in out.splitlines() if ln.startswith("Federated serve:")]
        recs = [json.loads(ln) for ln in open(path)]
        assert sum(r.get("event") == "cluster_summary" for r in recs) == 1, pkg
    assert lines["port"] == lines["jax"]
    assert re.fullmatch(r"Federated serve: 2 hosts x 1 replicas \(in-proc\), 8/8 ok, shed=0, "
                        r"sessions=0 \(remigrated=0, lost=0\), hosts_dead=0, "
                        r"protocol_errors=0", lines["port"])
    run_json = json.loads((tmp_path / "port" / "run.json").read_text())
    assert run_json["federation"]["completed"] == 8
