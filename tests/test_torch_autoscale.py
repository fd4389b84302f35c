"""The port's autoscaler (``gnot_tpu_torch/serve/autoscaler.py``, the
``--autoscale*`` flags and ``ServeConfig`` fields, the router's ``pool()``
/ ``assess()`` probes) against the JAX package's.

JAX's fake-clock controller scripts (``tests/test_autoscale.py``: cooldown
and surge, hysteresis and down ticks, the flap suppressor, replacing dead
and wedged replicas, the replica-seconds ledger) and the tenants' batch
deferral veto and alert attribution run through both
``AutoscaleController``s, each over a fresh copy of one stub router with
one injected clock: the same decision records, events, stats and ledger.
One real-pool script runs through each package's ``ReplicaRouter`` at
``tests/test_torch_serve_policies.py``'s size (64-point Darcy meshes, the
width-16 one-block model, 2-row dispatches, the JAX weights carried over
by ``interop.params_from_jax``, f32 on the CPU): a burst scales the pool
out (the new replica warmed before its first route), then with one
resident session on each replica the calm scales it in, the victim's
session migrating at a step boundary, none lost, each trajectory within
1e-5 of its package's ``offline_rollout`` and the two packages' at the
model bar 1e-4 / 1e-5. The controllers there tick by hand on a fake
clock; the pools serve on the real one. No test sleeps."""

import json

import jax
import numpy as np
import pytest

from gnot_tpu import main as jax_main
from gnot_tpu.config import ModelConfig as JaxModelConfig
from gnot_tpu.config import make_config
from gnot_tpu.data import datasets as jax_datasets
from gnot_tpu.data.batch import collate as jax_collate
from gnot_tpu.models.gnot import GNOT as JaxGNOT
from gnot_tpu.serve import AutoscaleController as JaxController
from gnot_tpu.serve import EngineReplica as JaxReplica
from gnot_tpu.serve import InferenceEngine as JaxEngine
from gnot_tpu.serve import ReplicaRouter as JaxRouter
from gnot_tpu.serve import autoscaler as jax_autoscaler
from gnot_tpu.serve import rollout as jax_rollout
from gnot_tpu.serve.policies import HealthVerdict
from gnot_tpu.train.trainer import apply_batch as jax_apply_batch
from gnot_tpu.train.trainer import init_params
from gnot_tpu_torch import main as port_main
from gnot_tpu_torch.config import ModelConfig, NotPortedError, ServeConfig
from gnot_tpu_torch.data import datasets
from gnot_tpu_torch.interop import params_from_jax
from gnot_tpu_torch.models.gnot import GNOT
from gnot_tpu_torch.obs import events
from gnot_tpu_torch.serve import autoscaler, rollout
from gnot_tpu_torch.serve.autoscaler import AutoscaleController
from gnot_tpu_torch.serve.replica import EngineReplica, build_replicas
from gnot_tpu_torch.serve.router import ReplicaRouter

RTOL, ATOL = 1e-4, 1e-5
PARITY = 1e-5
MAX_BATCH = 2
TINY = dict(n_attn_layers=1, n_attn_hidden_dim=16, n_mlp_num_layers=1, n_mlp_hidden_dim=16,
            n_input_hidden_dim=16, n_expert=2, n_head=2)
CONTROLLERS = {"jax": JaxController, "port": AutoscaleController}


class ListSink:
    def __init__(self):
        self.records = []

    def log(self, **record):
        self.records.append(record)

    def flush(self):
        pass


# -- the stub router (tests/test_autoscale.py) -------------------------------------------


class FakeServer:
    def __init__(self):
        self.depth_v = 0
        self.sessions_v = 0
        self.alive = True
        self.verdict = "ok"

    def depth(self):
        return self.depth_v

    def resident_sessions(self):
        return self.sessions_v

    def worker_alive(self):
        return self.alive


class FakeReplica:
    def __init__(self, rid):
        self.replica_id = rid
        self.server = FakeServer()
        self.retiring = False
        self.warm_stats = {"source": "compile"}


class FakeRouter:
    """The controller-facing surface of ReplicaRouter."""

    def __init__(self, n):
        self.replicas = [FakeReplica(i) for i in range(n)]
        self.removed = []
        self.added = []

    def pool(self):
        return list(self.replicas)

    def add_replica(self, replica):
        self.replicas.append(replica)
        self.added.append(replica.replica_id)
        return replica

    def remove_replica(self, rid, *, timeout_s=30.0, reason="scale_in"):
        self.replicas = [r for r in self.replicas if r.replica_id != rid]
        self.removed.append((rid, reason))
        return {"requests": 0, "completed": 0}

    def assess(self, r):
        if not r.server.alive:
            return HealthVerdict(False, "dead")
        if r.server.verdict != "ok":
            return HealthVerdict(False, r.server.verdict)
        return HealthVerdict(True, "ok")

    def set_load(self, per_replica):
        for r in self.replicas:
            r.server.depth_v = per_replica


class FakeEvaluator:
    def __init__(self):
        self.on: dict = {}

    def active(self):
        return dict(self.on)


class FakeTenants:
    def priority(self, tenant):
        return "batch" if tenant.startswith("batch") else "interactive"


class Run:
    """One script's run through one package's controller: every tick's
    decision, the events, and the stub router's membership calls."""

    def __init__(self, pkg: str, n: int, **kw):
        self.clk = [0.0]
        self.router = FakeRouter(n)
        self.sink = ListSink()
        kw.setdefault("min_replicas", 1)
        kw.setdefault("max_replicas", 4)
        kw.setdefault("cooldown_s", 2.0)
        kw.setdefault("up_load", 8.0)
        kw.setdefault("down_load", 1.0)
        kw.setdefault("down_ticks", 3)
        kw.setdefault("heal_after_s", 5.0)
        self.c = CONTROLLERS[pkg](self.router, replica_factory=lambda rid, slot: FakeReplica(rid),
                                  clock=lambda: self.clk[0], sink=self.sink, **kw)
        self.decisions = []

    def tick(self, n: int = 1):
        for _ in range(n):
            self.decisions.append(self.c.tick())
        return self.decisions[-1]

    def outcome(self) -> dict:
        return dict(decisions=self.decisions, events=self.sink.records, added=self.router.added,
                    removed=self.router.removed, stats=self.c.close(),
                    replica_seconds=self.c.replica_seconds(),
                    pool=[r.replica_id for r in self.router.pool()])


def _scale_up_cooldown_and_surge(pkg):
    run = Run(pkg, 1)
    run.tick()  # idle
    run.router.set_load(10)
    run.tick(2)  # grow once, then the cooldown holds
    run.clk[0] = 2.5
    run.tick()  # past the cooldown
    run.router.set_load(100)
    run.tick(3)  # surge bypasses the cooldown, then at_max once (an edge)
    return run.outcome()


def _hysteresis_down_ticks_and_down_cooldown(pkg):
    run = Run(pkg, 3, flap_suppress_s=0.0)
    run.router.set_load(4)
    run.tick(5)  # mid-band: nothing, and the calm streak resets
    run.router.set_load(0)
    run.tick()
    run.router.set_load(4)
    run.tick()
    run.router.set_load(0)
    run.tick(3)  # three consecutive calm ticks: shrink
    run.clk[0] += 0.5
    run.tick(3)  # the down cooldown holds
    run.clk[0] += 5.0
    run.tick()  # shrink to the floor
    run.tick(5)  # at the floor calm wants nothing
    return run.outcome()


def _flap_suppressor(pkg):
    run = Run(pkg, 1, cooldown_s=1.0)  # flap window 3 s
    run.router.set_load(10)
    run.tick()
    run.router.set_load(0)
    run.clk[0] = 1.5
    run.tick(4)  # flap_suppressed
    run.clk[0] = 3.5
    run.tick(4)  # the shrink lands
    return run.outcome()


def _replace_dead_and_wedged(pkg):
    run = Run(pkg, 2)
    run.router.replicas[0].server.alive = False
    run.tick()  # dead: replaced at once, fresh id on the freed slot
    run.clk[0] = 10.0
    run.router.replicas[0].server.verdict = "wedged"
    run.tick()  # dwell started
    run.clk[0] = 12.0
    run.tick()
    run.clk[0] = 16.0
    run.tick()  # past heal_after_s: replaced
    run.router.replicas[1].server.verdict = "breaker_open"
    run.clk[0] = 17.0
    run.tick()
    run.clk[0] = 23.0
    run.tick()  # heal cooldown long past: replaced
    return run.outcome()


def _last_replica_and_below_min(pkg):
    run = Run(pkg, 1, min_replicas=1, max_replicas=2)
    run.router.replicas[0].server.alive = False
    run.tick(2)  # the last replica is never removed: an edge hold, once
    run.router.replicas[0].server.alive = True
    run.router.replicas = []  # a pool below its floor restores it
    run.clk[0] = 5.0
    run.tick()
    return run.outcome()


def _replica_seconds_ledger(pkg):
    run = Run(pkg, 2)
    run.tick()
    run.clk[0] = 10.0
    run.tick()
    run.router.set_load(10)
    run.tick()  # -> 3 replicas at t=10
    run.clk[0] = 20.0
    return run.outcome()


def _tenant_veto_and_attribution(pkg):
    """Pressure owned entirely by batch-class tenants is held
    (``batch_deferral``); an interactive tenant's alert scales out under
    its name; raw load over up_load scales out whoever burns."""
    ev = FakeEvaluator()
    run = Run(pkg, 1, evaluator=ev, tenants=FakeTenants(), cooldown_s=0.0)
    ev.on = {"latency_p99:batch_a": True, "shed_fraction:batch_b": True, "wedged": False}
    run.tick(2)  # held once (an edge)
    ev.on = {"latency_p99:batch_a": True, "latency_p99:alice": True}
    run.tick()  # slo:latency_p99:alice
    ev.on = {"queue_saturation": True}
    run.tick()  # pool-level pressure: slo:queue_saturation
    ev.on = {"latency_p99:batch_a": True}
    run.router.set_load(9)
    run.tick()  # load over up_load: the veto does not apply
    ev.on = {"breaker_open": True}
    run.router.set_load(0)
    run.tick(4)  # a health alert is not pressure, and it blocks the calm
    return run.outcome()


SCRIPTS = {f.__name__.lstrip("_"): f for f in (
    _scale_up_cooldown_and_surge, _hysteresis_down_ticks_and_down_cooldown, _flap_suppressor,
    _replace_dead_and_wedged, _last_replica_and_below_min, _replica_seconds_ledger,
    _tenant_veto_and_attribution)}


@pytest.mark.parametrize("name", list(SCRIPTS))
def test_the_controller_script_decides_as_in_jax(name):
    got, want = SCRIPTS[name]("port"), SCRIPTS[name]("jax")
    assert got == want
    assert any(d["action"] != "none" for d in got["decisions"])
    for rec in got["events"]:
        assert events.validate_record(rec) == []


def test_the_controller_s_checks_and_constants_are_jax_s():
    assert autoscaler.PRESSURE_OBJECTIVES == jax_autoscaler.PRESSURE_OBJECTIVES
    assert autoscaler.HEAL_REASONS == jax_autoscaler.HEAL_REASONS
    bad = [dict(min_replicas=0), dict(min_replicas=3, max_replicas=2), dict(interval_s=0.0),
           dict(cooldown_s=-1.0), dict(up_load=1.0, down_load=2.0), dict(down_ticks=0),
           dict(heal_after_s=0.0)]
    for kw in bad:
        msgs = []
        for Controller in (AutoscaleController, JaxController):
            with pytest.raises(ValueError) as err:
                Controller(FakeRouter(1), replica_factory=lambda r, s: None, **kw)
            msgs.append(str(err.value))
        assert msgs[0] == msgs[1], kw
    with pytest.raises(NotPortedError, match="prewarm_manifest"):
        AutoscaleController(FakeRouter(1), replica_factory=lambda r, s: None,
                            prewarm_manifest={"per_replica": {}})


# -- the flags and ServeConfig ------------------------------------------------------------

FLAGS = ["autoscale", "autoscale_min", "autoscale_max", "autoscale_cooldown_s",
         "autoscale_interval_s", "autoscale_up_load", "autoscale_down_load",
         "autoscale_down_ticks", "autoscale_heal_after_s"]


def test_the_nine_flags_and_their_checks_are_jax_s():
    jp, pp = jax_main.build_parser(), port_main.build_parser()
    assert {f: getattr(pp.parse_args([]), f) for f in FLAGS} == {
        f: getattr(jp.parse_args([]), f) for f in FLAGS}
    helps = lambda p: {a.dest: (a.help, a.type, a.default) for a in p._actions  # noqa: E731
                       if a.dest in FLAGS}
    port_helps, jax_helps = helps(pp), helps(jp)
    assert len(port_helps) == 9
    # Types and defaults are JAX's. Two help texts are the port's own:
    # JAX's describe device-slot partitioning, AOT manifests and a docs
    # page, none of which the one-card port has.
    own_help = {"autoscale", "autoscale_max"}
    assert {f: h[1:] for f, h in port_helps.items()} == {f: h[1:] for f, h in jax_helps.items()}
    assert {f: h for f, h in port_helps.items() if f not in own_help} == {
        f: h for f, h in jax_helps.items() if f not in own_help}
    assert all(port_helps[f][0] != jax_helps[f][0] for f in own_help)
    assert all(w not in port_helps[f][0] for f in own_help for w in ("AOT", "docs/", "prewarm"))
    argv = ["--autoscale", "--autoscale_min", "1", "--autoscale_max", "3",
            "--autoscale_cooldown_s", "0.5", "--autoscale_interval_s", "0.1",
            "--autoscale_up_load", "4", "--autoscale_down_load", "0.5",
            "--autoscale_down_ticks", "2", "--autoscale_heal_after_s", "1.5"]
    _, port = port_main.configs_from_args(pp.parse_args(argv))
    jax_sc = jax_main.config_from_args(jp.parse_args(argv)).serve
    assert {f: getattr(port, f) for f in FLAGS} == {f: getattr(jax_sc, f) for f in FLAGS}
    assert ServeConfig().autoscale_max == make_config().serve.autoscale_max == 4
    for fields in (dict(autoscale_min=5), dict(autoscale_min=0), dict(autoscale_down_load=8.0),
                   dict(autoscale_down_ticks=0), dict(autoscale=True, replicas=8),
                   dict(autoscale_interval_s=0.0), dict(autoscale_cooldown_s=-1.0),
                   dict(autoscale_heal_after_s=0.0)):
        with pytest.raises(ValueError) as want:
            make_config(**{f"serve.{k}": v for k, v in fields.items()})
        with pytest.raises(ValueError) as got:
            ServeConfig(**fields)
        assert str(got.value) == str(want.value), fields
    ServeConfig(autoscale=True, replicas=2, autoscale_max=3)


# -- the real pool ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def setup():
    jsamples = jax_datasets.synth_darcy2d(4, seed=0, grid_n=8)
    psamples = datasets.synth_darcy2d(4, seed=0, grid_n=8)
    mc = dict(TINY, **jax_datasets.infer_model_dims(jsamples))
    jmodel = JaxGNOT(JaxModelConfig(**mc))
    params = jax.jit(lambda b: init_params(jmodel, b, 0))(jax_collate(jsamples[:2]))
    # One jitted forward for the JAX engines: the bucket compiles once.
    forward = jax.jit(lambda p, b: jax_apply_batch(jmodel, p, b))
    jengines = [JaxEngine(jmodel, params, batch_size=MAX_BATCH, forward=forward)
                for _ in range(2)]
    cfg = ModelConfig(**mc)
    model = GNOT(cfg)
    model.load_state_dict(params_from_jax(jax.device_get(params), cfg), strict=True)
    pengines = [r.engine for r in build_replicas(model, 2, batch_size=MAX_BATCH)]
    return {
        "jax": dict(Router=JaxRouter, Replica=JaxReplica, Controller=JaxController,
                    engines=jengines, samples=jsamples, rollout=jax_rollout),
        "port": dict(Router=ReplicaRouter, Replica=EngineReplica, Controller=AutoscaleController,
                     engines=pengines, samples=psamples, rollout=rollout),
    }


STEPS = 12  # each session's rollout: long enough to still be resident at the scale-in


def _elastic_pool(P: dict) -> dict:
    """``test_autoscale_controller_scales_real_pool`` with sessions: a burst
    of 16 requests grows the pool from 1 to 2 (the joining replica wraps
    the package's second engine, warmed before it joins); two sessions go
    in, one a replica (round robin), and the calm past the flap window
    retires one replica, its session handed to the sibling."""
    sink, clk = ListSink(), [0.0]
    r0 = P["Replica"](0, P["engines"][0])
    r0.warm(P["samples"][:1], rows=MAX_BATCH)
    router = P["Router"]([r0], sink=sink, max_batch=MAX_BATCH, max_wait_ms=2.0,
                         route_policy="round_robin", wedge_after_s=60.0).start()
    c = P["Controller"](router,
                        replica_factory=lambda rid, slot: P["Replica"](rid, P["engines"][slot]),
                        min_replicas=1, max_replicas=2, cooldown_s=0.0, flap_suppress_s=1.0,
                        up_load=4.0, down_load=2.0, down_ticks=2,
                        warm_samples=P["samples"][:1], sink=sink, clock=lambda: clk[0])
    s = P["samples"]
    burst = [router.submit(s[i % 4]) for i in range(16)]
    up = c.tick()  # the burst in flight: load over up_load
    results = [f.result(timeout=60) for f in burst]
    sessions = [router.submit_rollout(s[i], STEPS) for i in range(2)]
    clk[0] = 2.0  # past the flap window
    down = [c.tick(), c.tick()]  # two calm ticks: the second retires one
    outs = [f.result(timeout=60) for f in sessions]
    summary = router.drain()
    return dict(up=up, down=down, results=results, sessions=outs, summary=summary,
                records=sink.records, stats=c.close())


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_the_elastic_pool_scales_out_and_in_losing_nothing(pkg, setup):
    out = _elastic_pool(setup[pkg])
    assert out["up"]["action"] == "scale_up" and out["up"]["warm_source"] == "compile"
    assert [d["action"] for d in out["down"]] == ["none", "scale_down"]
    assert all(r.ok for r in out["results"]) and all(r.ok for r in out["sessions"])
    sessions = out["summary"]["sessions"]
    assert (sessions["started"], sessions["completed"], sessions["lost"]) == (2, 2, 0)
    migrated = [r for r in out["records"] if r["event"] == "session_migrate"]
    assert [r["reason"] for r in migrated] == ["scale_in"] and sessions["migrated"] == 1
    assert out["summary"]["shed"] == {} and out["summary"]["completed"] == 16 + 2 * STEPS
    assert out["summary"]["routing"]["removed"] == 1
    kinds = [r["event"] for r in out["records"]]
    assert {"scale_up", "scale_down", "replica_remove", "autoscale_decision"} <= set(kinds)
    # Warm before join: replica 1's replica_warm precedes its first route.
    warm = next(i for i, r in enumerate(out["records"])
                if r["event"] == "replica_warm" and r["replica"] == 1)
    first = next(i for i, r in enumerate(out["records"])
                 if r["event"] == "route" and r["replica"] == 1)
    assert warm < first
    # Each trajectory is its package's offline rollout of its sample.
    P = setup[pkg]
    for r, sample in zip(out["sessions"], P["samples"]):
        want = P["rollout"].offline_rollout(P["engines"][0], sample, STEPS, rows=MAX_BATCH)
        assert P["rollout"].parity_check(r.outputs, want) <= PARITY
    assert (out["stats"]["scale_ups"], out["stats"]["scale_downs"]) == (1, 1)
    setup.setdefault("outputs", {})[pkg] = [r.outputs for r in out["sessions"]] + [
        [r.output] for r in out["results"]]
    if len(setup["outputs"]) == 2:
        for a, b in zip(setup["outputs"]["port"], setup["outputs"]["jax"]):
            for x, y in zip(a, b):
                np.testing.assert_allclose(x, y, rtol=RTOL, atol=ATOL)
    for rec in out["records"]:
        assert events.validate_record(rec) == []


def test_main_serves_an_elastic_pool(tmp_path, capsys):
    """``main --serve --autoscale`` from one replica on the CPU: eight
    8-step sessions hold the load over ``--autoscale_up_load`` while the
    controller ticks every 10 ms, so it scales out; every session
    completes; JAX's ``Autoscale: pool [...]`` line; run.json's
    ``autoscale`` block with ``replica_seconds``; every event valid."""
    path = tmp_path / "m.jsonl"
    argv = ["--serve", "--device", "cpu", "--synthetic", "darcy2d", "--n_test", "8",
            "--n_train", "4", "--n_attn_layers", "1", "--n_attn_hidden_dim", "16",
            "--n_mlp_num_layers", "1", "--n_mlp_hidden_dim", "16", "--n_input_hidden_dim", "16",
            "--n_expert", "2", "--n_head", "2", "--serve_max_batch", "2",
            "--serve_rollout_steps", "8", "--autoscale", "--autoscale_max", "2",
            "--autoscale_interval_s", "0.01", "--autoscale_cooldown_s", "0",
            "--autoscale_up_load", "2", "--autoscale_down_load", "0",
            "--wedge_after_s", "60", "--metrics_path", str(path)]
    assert port_main.main(argv) == 1.0
    out = capsys.readouterr().out
    assert "Autoscale: pool [1, 2], " in out and "replica-seconds" in out
    manifest = json.loads((tmp_path / "run.json").read_text())
    block = manifest["autoscale"]
    assert block["scale_ups"] >= 1 and block["errors"] == 0 and block["replica_seconds"] > 0
    recs = [json.loads(ln) for ln in open(path)]
    assert any(r.get("event") == "scale_up" for r in recs)
    for r in recs:
        assert events.validate_record(r) == []
