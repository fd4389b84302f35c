"""The port's replicas and router (``gnot_tpu_torch/serve/replica.py``,
``serve/router.py``, ``policies.ReplicaHealthPolicy`` and the server's
replica half) against the JAX package's.

Each script runs through JAX's ``ReplicaRouter``, its replicas on the
forced host devices (``tests/conftest.py``), and through the port's, its
replicas sharing the CPU device, at ``tests/test_torch_serve_policies.py``'s
size (64-point Darcy meshes, the width-16 one-block model, 2-row
dispatches) with the JAX weights carried over by
``interop.params_from_jax``, f32 on the CPU. Each package's three replica
engines are built and warmed once for the module (JAX compiles each
forward there once); a script wraps them in fresh ``EngineReplica``s and
leaves their weights as it found them.

The scripts are JAX's router tests made deterministic: requests go in
before a worker starts, or one at a time, a replica's worker starts when
the script says, and a clock offset stands in for sleeping past a
cooldown or a wedge bound. Held equal: each request's reason and each
session's outcome, the router's events (``route``, ``replica_health``,
``rolling_reload``, ``session_migrate``, ``replica_warm``,
``replica_remove``) in order with their fields, each replica's own events
where its dispatch groups are fixed, and the pool summary's counters,
``per_replica`` and ``routing``. Left out: times, and JAX's compile-cache
``hits`` / ``misses`` of ``replica_warm`` and ``warmup_cache`` (eager
PyTorch has no compile cache, so the port's warm stats do not carry them).
Outputs at the model-level bar 1e-4 / 1e-5; a migrated session within
1e-5 of its package's ``offline_rollout`` at every step."""

import json
import threading
import time

import jax
import numpy as np
import pytest

from gnot_tpu import main as jax_main
from gnot_tpu.config import ModelConfig as JaxModelConfig
from gnot_tpu.config import make_config
from gnot_tpu.data import datasets as jax_datasets
from gnot_tpu.data.batch import MeshSample as JaxMeshSample
from gnot_tpu.data.batch import collate as jax_collate
from gnot_tpu.models.gnot import GNOT as JaxGNOT
from gnot_tpu.obs import events as jax_events
from gnot_tpu.obs import metrics as jax_metrics
from gnot_tpu.obs.tracing import Tracer as JaxTracer
from gnot_tpu.resilience import faults as jax_faults
from gnot_tpu.serve import CheckpointReloader as JaxReloader
from gnot_tpu.serve import EngineReplica as JaxReplica
from gnot_tpu.serve import ReplicaRouter as JaxRouter
from gnot_tpu.serve import SessionStore as JaxSessionStore
from gnot_tpu.serve import TenantPolicy as JaxTenantPolicy
from gnot_tpu.serve import build_replicas as jax_build_replicas
from gnot_tpu.serve import policies as jax_policies
from gnot_tpu.serve import rollout as jax_rollout
from gnot_tpu.train import trainer as jax_trainer
from gnot_tpu.train.checkpoint import Checkpointer as JaxCheckpointer
from gnot_tpu.train.trainer import init_params
from gnot_tpu_torch import main as port_main
from gnot_tpu_torch.config import ModelConfig, NotPortedError, ServeConfig
from gnot_tpu_torch.data import datasets
from gnot_tpu_torch.data.batch import MeshSample
from gnot_tpu_torch.interop import params_from_jax
from gnot_tpu_torch.models.gnot import GNOT
from gnot_tpu_torch.obs import events
from gnot_tpu_torch.obs import metrics
from gnot_tpu_torch.obs.tracing import Tracer
from gnot_tpu_torch.resilience import faults
from gnot_tpu_torch.serve import policies, rollout
from gnot_tpu_torch.serve.policies import TenantPolicy
from gnot_tpu_torch.serve.catalog import ProgramCatalog
from gnot_tpu_torch.serve.replica import EngineReplica, build_replica, build_replicas
from gnot_tpu_torch.serve.rollout import SessionStore
from gnot_tpu_torch.serve.router import ReplicaRouter
from gnot_tpu_torch.serve.server import CheckpointReloader
from gnot_tpu_torch.train.checkpoint import Checkpointer

RTOL, ATOL = 1e-4, 1e-5
PARITY = 1e-5  # a served trajectory against its own offline rollout, per step
MAX_BATCH = 2
TINY = dict(n_attn_layers=1, n_attn_hidden_dim=16, n_mlp_num_layers=1, n_mlp_hidden_dim=16,
            n_input_hidden_dim=16, n_expert=2, n_head=2)
#: Every script's wedge bound but the wedge script's: long enough that a
#: loaded machine's slow thread never reads as wedged.
NO_WEDGE = 60.0
#: The breaker script's cooldown: long enough that a loaded machine's six
#: requests never outlast it, so only the clock's jump past it opens the
#: trial (well under NO_WEDGE, so the jump reads no replica as wedged).
BREAKER_COOLDOWN_S = 20.0


class ListSink:
    def __init__(self):
        self.records = []

    def log(self, **record):
        self.records.append(record)

    def flush(self):
        pass


class OffsetClock:
    """The monotonic clock plus an offset a script moves instead of sleeping."""

    def __init__(self):
        self.offset = 0.0

    def __call__(self) -> float:
        return time.monotonic() + self.offset


def _wait_for(cond, what: str, timeout: float = 30.0) -> None:
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.002)


def _jitted_init(init):
    """JAX's ``init_params`` under one ``jax.jit``: bitwise its eager
    params (flax's init op by op compiles ~150 programs), in a third of
    the time."""
    return lambda model, batch, seed: jax.jit(lambda b: init(model, b, seed))(batch)


@pytest.fixture(scope="module")
def setup():
    jsamples = jax_datasets.synth_darcy2d(12, seed=0, grid_n=8)
    psamples = datasets.synth_darcy2d(12, seed=0, grid_n=8)
    mc = dict(TINY, **jax_datasets.infer_model_dims(jsamples))
    jmodel = JaxGNOT(JaxModelConfig(**mc))
    params = _jitted_init(init_params)(jmodel, jax_collate(jsamples[:4]), 0)
    jengines = [r.engine for r in jax_build_replicas(jmodel, params, 3, batch_size=MAX_BATCH,
                                                     devices=jax.devices()[:3])]
    cfg = ModelConfig(**mc)
    host = jax.device_get(params)
    model = GNOT(cfg)
    model.load_state_dict(params_from_jax(host, cfg), strict=True)
    pengines = [r.engine for r in build_replicas(model, 3, batch_size=MAX_BATCH)]
    for e in jengines:
        e.warmup(jsamples[:1], rows=MAX_BATCH)
    for e in pengines:
        e.warmup(psamples[:1], rows=MAX_BATCH)

    def port_weights(scale: float = 1.0) -> dict:
        return params_from_jax(jax.tree.map(lambda x: x * scale, host), cfg)

    return {
        "jax": dict(name="jax", Router=JaxRouter, Replica=JaxReplica, faults=jax_faults,
                    engines=jengines, samples=jsamples, MeshSample=JaxMeshSample,
                    Tenants=JaxTenantPolicy, Store=JaxSessionStore, rollout=jax_rollout,
                    metrics=jax_metrics, policies=jax_policies,
                    weights=lambda scale=1.0: jax.tree.map(lambda x: x * scale, params),
                    save=lambda w: w, reloader=lambda ck: JaxReloader(ck, params),
                    Checkpointer=JaxCheckpointer, Tracer=JaxTracer),
        "port": dict(name="port", Router=ReplicaRouter, Replica=EngineReplica, faults=faults,
                     engines=pengines, samples=psamples, MeshSample=MeshSample,
                     Tenants=TenantPolicy, Store=SessionStore, rollout=rollout,
                     metrics=metrics, policies=policies, weights=port_weights,
                     save=lambda w: {"model": w},
                     reloader=lambda ck: CheckpointReloader(ck, model),
                     Checkpointer=Checkpointer, Tracer=Tracer),
        "model": model,
    }


# -- what is compared ------------------------------------------------------------

ROUTER_KINDS = ("route", "replica_health", "rolling_reload", "session_migrate",
                "replica_warm", "replica_remove")
#: Time-valued fields (these and every ``*_ms``); JAX's compile-cache
#: counters; and ``jit_fallbacks``, where JAX counts each timed dispatch that
#: ran its jitted forward instead of an AOT executable (with a registry or a
#: tracer, every dispatch here) and the port, which has neither, writes 0.
LEFT_OUT = {"ts", "seconds", "dispatch_ms_p50", "dispatch_ms_max", "hits", "misses",
            "jit_fallbacks"}


def _norm(value):
    """A record, summary block or value with the left-out keys dropped and
    a reload event's file provenance in JAX's terms (as
    ``tests/test_torch_serve_policies.py`` reads it)."""
    if isinstance(value, dict):
        out = {k: _norm(v) for k, v in value.items()
               if k not in LEFT_OUT and not k.endswith("_ms")}
        if out.get("event") == "reload":
            out.pop("requested_skipped", None)
            if "dir" in out:
                out["dir"] = out["dir"].removesuffix(".pt")
            if "skipped" in out:
                out["skipped"] = len(out["skipped"])
            if "error" in out:
                out["error"] = out["error"].split(":")[0]
        return out
    if isinstance(value, list):
        return [_norm(v) for v in value]
    return value


def _router_events(records) -> list[dict]:
    return [_norm(r) for r in records if r.get("event") in ROUTER_KINDS]


def _server_events(records) -> dict:
    """Each replica's own events in order, its serve_summary included."""
    out: dict = {}
    for r in records:
        if r.get("event") not in ROUTER_KINDS and "replica" in r:
            out.setdefault(r["replica"], []).append(_norm(r))
    return out


def _pool_summary(summary: dict) -> dict:
    keep = ("dtype", "requests", "admitted", "completed", "shed", "dispatches", "reloads",
            "breaker_trips", "compiled_shapes", "per_replica", "routing", "sessions", "tenants",
            "pad_waste_by_bucket")
    return {k: _norm(summary[k]) for k in keep if k in summary}


def _result(r) -> tuple:
    if hasattr(r, "outputs"):
        return (r.ok, r.reason, r.session, r.steps, r.steps_completed, r.drained_at_step,
                len(r.outputs), r.migrations)
    return (r.ok, r.reason)


def _outputs(r) -> list:
    if hasattr(r, "outputs"):
        return list(r.outputs)
    return [r.output] if r.ok else []


def _outcome(results, sink, summary, *, servers: bool = True, **extra) -> dict:
    return dict(results=list(results), router=_router_events(sink.records),
                servers=_server_events(sink.records) if servers else None,
                summary=_pool_summary(summary), **extra)


def _assert_same(got: dict, want: dict) -> None:
    assert [_result(r) for r in got["results"]] == [_result(r) for r in want["results"]]
    assert got["router"] == want["router"]
    assert got["servers"] == want["servers"]
    assert got["summary"] == want["summary"]
    for g, w in zip(got["results"], want["results"]):
        for a, b in zip(_outputs(g), _outputs(w)):
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)


def _hold_to_offline(P: dict, results, samples, engine) -> None:
    """Each trajectory within ``PARITY`` of the package's own
    ``offline_rollout`` of its sample, step by step."""
    for r, s in zip(results, samples):
        want = P["rollout"].offline_rollout(engine, s, len(r.outputs), rows=MAX_BATCH)
        assert P["rollout"].parity_check(r.outputs, want) <= PARITY


# -- building a pool ---------------------------------------------------------------

def _pool(P: dict, n: int, *, ids=None, warm: bool = True) -> list:
    """``n`` fresh replicas over the package's first ``n`` engines."""
    ids = list(ids) if ids is not None else list(range(n))
    reps = [P["Replica"](rid, P["engines"][i]) for i, rid in enumerate(ids)]
    if warm:
        for r in reps:
            r.warm(P["samples"][:1], rows=MAX_BATCH)
    return reps


def _router(P: dict, reps, sink, **kw):
    kw.setdefault("max_wait_ms", 2.0)
    kw.setdefault("wedge_after_s", NO_WEDGE)
    return P["Router"](reps, sink=sink, max_batch=MAX_BATCH, **kw)


def _faults(P: dict, spec: str):
    return P["faults"].FaultInjector.from_spec(spec)


def _ragged(P: dict, sizes, seed: int) -> list:
    """``tests/test_serve.py::_ragged_traffic``: small meshes of the Darcy
    schema with ``sizes`` points."""
    base = P["samples"][0]
    rng = np.random.default_rng(seed)
    f_dim = base.funcs[0].shape[-1]
    return [P["MeshSample"](
        coords=rng.uniform(0, 1, size=(m, 2)).astype(np.float32),
        y=np.zeros((m, 1), np.float32), theta=base.theta,
        funcs=(rng.uniform(0, 1, size=(max(4, m // 4), f_dim)).astype(np.float32),))
        for m in sizes]


# -- the health policy ---------------------------------------------------------------

HEALTH_TABLE = [
    dict(breaker_state="closed", warming=False, progress_age_s=0.1, depth=3),
    dict(breaker_state="open", warming=False, progress_age_s=0.0, depth=0),
    dict(breaker_state="open", warming=False, progress_age_s=0.0, depth=0, breaker_trial_due=True),
    dict(breaker_state="closed", warming=True, progress_age_s=0.0, depth=0),
    dict(breaker_state="closed", warming=False, progress_age_s=5.0, depth=2),
    dict(breaker_state="closed", warming=False, progress_age_s=5.0, depth=0),
    dict(breaker_state="closed", warming=False, progress_age_s=0.0, depth=0, worker_alive=False),
    dict(breaker_state="closed", warming=False, progress_age_s=0.0, depth=0, retiring=True),
    dict(breaker_state="open", warming=True, progress_age_s=9.0, depth=1, retiring=True,
         worker_alive=False),
    dict(breaker_state="open", warming=True, progress_age_s=9.0, depth=1, retiring=True),
    dict(breaker_state="open", warming=False, progress_age_s=9.0, depth=1, breaker_trial_due=True),
]


@pytest.mark.parametrize("case", range(len(HEALTH_TABLE)))
def test_replica_health_policy_verdicts_are_jax_s(case):
    """``test_serve.py::test_replica_health_policy_verdicts``'s table and
    the orderings between its signals, through both policies."""
    got = policies.ReplicaHealthPolicy(wedge_after_s=1.0).assess(**HEALTH_TABLE[case])
    want = jax_policies.ReplicaHealthPolicy(wedge_after_s=1.0).assess(**HEALTH_TABLE[case])
    assert (got.healthy, got.reason) == (want.healthy, want.reason)
    expected = ["ok", "breaker_open", "trial", "warming", "wedged", "ok", "dead", "retiring",
                "dead", "retiring", "wedged"]
    assert got.reason == expected[case]
    if case == 0:
        assert policies.ROUTE_POLICIES == jax_policies.ROUTE_POLICIES
        for mod in (policies, jax_policies):
            with pytest.raises(ValueError, match="wedge_after_s"):
                mod.ReplicaHealthPolicy(wedge_after_s=0.0)


# -- the scripts: one function, run through each package -------------------------------

def _cold_assign(P, tmp_path):
    """``test_router_affinity_cold_assign_sticks``: four requests of an
    unseen bucket, one at a time: the first is assigned to one replica and
    the rest follow it; that replica alone adds the bucket's shape."""
    sink = ListSink()
    router = _router(P, _pool(P, 2, warm=False), sink, max_wait_ms=5.0).start()
    results = [router.submit(s).result(timeout=60) for s in _ragged(P, [100] * 4, seed=3)]
    return _outcome(results, sink, router.drain())


def _breaker(P, tmp_path):
    """``test_router_routes_around_open_breaker``: replica 0's breaker
    tripped, six requests go to replica 1; past the cooldown a trial goes
    back to replica 0 and closes it; four more follow."""
    sink, clock = ListSink(), OffsetClock()
    reps = _pool(P, 2)
    router = _router(P, reps, sink, breaker_cooldown_s=BREAKER_COOLDOWN_S, clock=clock).start()
    for _ in range(3):
        reps[0].server.breaker.record_failure()
    s = P["samples"]
    results = [router.submit(x).result(timeout=60) for x in s[:6]]
    clock.offset += BREAKER_COOLDOWN_S + 0.1  # past the cooldown, without sleeping
    results.append(router.submit(s[0]).result(timeout=60))
    closed = reps[0].server.breaker.state
    results += [router.submit(x).result(timeout=60) for x in s[:4]]
    return _outcome(results, sink, router.drain(), closed=closed)


def _wedged(P, tmp_path):
    """``test_router_wedged_replica_drains_to_siblings``: replica 0's first
    dispatch stalls past its victim's deadline (``slow_request@1``); with
    the clock moved past the wedge bound, four requests go to replica 1."""
    sink, clock = ListSink(), OffsetClock()
    reps = _pool(P, 2)
    router = _router(P, reps, sink, wedge_after_s=0.2, clock=clock,
                     faults={0: _faults(P, "slow_request@1")}).start()
    s = P["samples"]
    victim = router.submit(s[0], deadline_ms=800)
    srv = reps[0].server
    _wait_for(lambda: srv._inbound.empty() and len(srv.batcher) == 0, "the victim's dispatch")
    time.sleep(0.05)  # its worker has stamped its progress and is stalling
    clock.offset += 1.0
    late = [router.submit(x).result(timeout=60) for x in s[1:5]]
    return _outcome(late + [victim.result(timeout=60)], sink, router.drain())


def _spill(P, tmp_path):
    """``test_router_spill_when_affinity_target_full``: workers not
    started, the bucket assigned to replica 0 of queue limit 2: the third
    request spills to replica 1; the drain refuses all three."""
    sink = ListSink()
    reps = _pool(P, 2, warm=False)
    router = _router(P, reps, sink, queue_limit=2)
    key, _ = router._bucket_of(P["samples"][0])
    reps[0].note_bucket(key)
    futs = [router.submit(x) for x in P["samples"][:3]]
    summary = router.drain()
    return _outcome([f.result(timeout=5) for f in futs], sink, summary)


def _load_accounting(P, tmp_path):
    """``test_router_load_accounting_counts_resident_sessions``: workers
    not started, least-loaded: a session on replica 0 makes both later
    requests prefer replica 1."""
    sink = ListSink()
    router = _router(P, _pool(P, 2, warm=False), sink, route_policy="least_loaded")
    s = P["samples"]
    futs = [router.submit_rollout(s[0], 5), router.submit(s[1]), router.submit(s[2])]
    summary = router.drain()
    return _outcome([f.result(timeout=5) for f in futs], sink, summary)


def _dtype(P, tmp_path):
    """``test_router_reports_dtype_on_routes_and_summary`` on f32 replicas:
    every route and the pool summary name the pool's dtype; eight requests
    in before the workers start alternate between the replicas."""
    sink = ListSink()
    router = _router(P, _pool(P, 2), sink, max_wait_ms=10_000)
    futs = [router.submit(x) for x in P["samples"][:8]]
    router.start()
    results = [f.result(timeout=60) for f in futs]
    return _outcome(results, sink, router.drain())


def _events_validate(P, tmp_path):
    """``test_obs.py::test_router_events_validate_against_registry``: four
    requests, a rolling reload from a source that always succeeds, the
    drain; every record is checked against both registries in the test."""
    sink = ListSink()
    same = P["weights"]()
    reps = _pool(P, 2)
    router = _router(P, reps, sink, reload_fn=lambda deadline_ms=None: (same, {})).start()
    results = [router.submit(x).result(timeout=60) for x in P["samples"][:4]]
    ok = router.reload()
    return _outcome(results, sink, router.drain(), ok=ok, records=sink.records)


def _pool_merge(P, tmp_path):
    """``test_metrics_plane.py::test_router_pool_merge_equals_sum_of_replicas``:
    round robin over 2 replicas into one registry, eight requests in
    before the workers start: the pool histogram is the sum of the
    replicas' series, one route counted per placement."""
    sink, reg = ListSink(), P["metrics"].MetricsRegistry()
    router = _router(P, _pool(P, 2), sink, route_policy="round_robin", metrics=reg,
                     max_wait_ms=10_000)
    futs = [router.submit(x) for x in P["samples"][:8]]
    router.start()
    results = [f.result(timeout=60) for f in futs]
    summary = router.drain()
    per = [reg.histogram("serve_request_latency_ms", replica=i).count for i in range(2)]
    agg = reg.aggregate_histogram("serve_request_latency_ms")
    merged = (agg.count, agg.percentile(0.99) == summary["latency_p99_ms"],
              agg.percentile(0.50) == summary["latency_p50_ms"])
    return _outcome(results, sink, summary, per=per, merged=merged,
                    routes=reg.aggregate_counter("router_routes_total"),
                    wedged=[reg.gauge("serve_wedged", replica=i).read() for i in range(2)])


def _add_replica(P, tmp_path):
    """Scale-out with a replica readied by ``warm()``: it joins with a
    ``replica_warm`` event and span and takes the second of three
    requests; its id cannot join twice. Every span carries its replica."""
    sink, tracer = ListSink(), P["Tracer"]()
    router = _router(P, _pool(P, 1), sink, max_wait_ms=10_000, tracer=tracer).start()
    (fresh,) = [P["Replica"](1, P["engines"][1])]
    fresh.warm(P["samples"][:1], rows=MAX_BATCH)
    router.add_replica(fresh)
    with pytest.raises(ValueError, match="already in the pool"):
        router.add_replica(P["Replica"](1, P["engines"][1]))
    futs = [router.submit(x) for x in P["samples"][:3]]
    done = [futs[0].result(timeout=60), futs[2].result(timeout=60)]
    summary = router.drain()  # flushes replica 1's lone request
    spans = sorted((sp.name, json.dumps(sp.args, sort_keys=True, default=str))
                   for sp in tracer.snapshot() if sp.name in ("replica_warm", "resolve"))
    return _outcome(done + [futs[1].result(timeout=5)], sink, summary,
                    pool=[r.replica_id for r in router.replicas], spans=spans,
                    span_replicas=sorted({(sp.args or {}).get("replica")
                                          for sp in tracer.snapshot()}, key=str))


def _rolling_reload(P, tmp_path):
    """``test_rolling_reload_corrupt_replica_keeps_pool_serving``: three
    replicas, ``best`` at 0.25x and ``latest`` at 0.5x the weights; replica
    1's first reload truncates ``latest``, so replicas 1 and 2 fall back to
    ``best`` while replica 0 took ``latest``; a second rollout serves
    ``best`` everywhere. Requests before, between and after: none shed."""
    d = tmp_path / P["name"] / "ck"
    ck = P["Checkpointer"](str(d))
    for name, scale, epoch in (("best", 0.25, 1), ("latest", 0.5, 2)):
        getattr(ck, f"save_{name}")(P["save"](P["weights"](scale)), epoch, 0.5)
        ck.wait()
    sink = ListSink()
    reps = _pool(P, 3)
    router = _router(P, reps, sink, reload_fn=P["reloader"](ck),
                     faults={1: _faults(P, "reload_corrupt@1")}).start()
    s = P["samples"]

    def per_replica():
        key = reps[0].engine.bucket_key(s[0])
        return [r.engine.infer(s[:1], pad_nodes=key[0], pad_funcs=key[1], rows=MAX_BATCH)[0]
                for r in reps]

    try:
        results = [router.submit(x).result(timeout=60) for x in s[:3]]
        ok1 = router.reload()
        first = per_replica()
        results += [router.submit(x).result(timeout=60) for x in s[3:6]]
        ok2 = router.reload()
        second = per_replica()
        results += [router.submit(x).result(timeout=60) for x in s[6:9]]
        summary = router.drain()
    finally:
        for r in reps:
            r.engine.swap_params(P["weights"]())
    return _outcome(results, sink, summary, ok=(ok1, ok2), first=first, second=second)


def _migrate(P, tmp_path, spec: str, tenant: str | None = None):
    """``test_rollout_replica_kill_migrates_and_matches_offline`` (and with
    a tenant, ``test_rollout_session_tenant_inherited_across_migration``)
    or ``test_rollout_breaker_trip_mid_session_migrates``: four 4-step
    sessions in before the workers start (two a replica); replica 0 runs
    alone and fails at its first dispatch (``replica_kill@2`` or
    ``rollout_nan@2`` under a threshold-1 breaker), its two sessions move
    to replica 1 from their snapshots; then replica 1 runs all four."""
    sink = ListSink()
    reps = _pool(P, 2)
    kw = dict(breaker_threshold=1, breaker_cooldown_s=30.0) if "nan" in spec else {}
    router = _router(P, reps, sink, max_wait_ms=10_000, session_snapshot_every=2,
                     faults={0: _faults(P, spec)},
                     tenants=P["Tenants"].from_specs(weights="interactive:3,batch:1")
                     if tenant else None, **kw)
    s = P["samples"]
    futs = [router.submit_rollout(x, 4, tenant=tenant) for x in s[:4]]
    reps[0].server.start()
    _wait_for(lambda: reps[1].server.resident_sessions() == 4, "the migrations")
    reps[1].server.start()
    results = [f.result(timeout=60) for f in futs]
    summary = router.drain()
    _hold_to_offline(P, results, s[:4], reps[1].engine)
    return _outcome(results, sink, summary)


def _remove_history(P, tmp_path):
    """``test_autoscale.py::test_remove_replica_keeps_history_in_pool_rollup``:
    eight requests in before the workers start (four a replica); replica 0
    removed, the last replica refused, four more on replica 1; the pool
    summary keeps replica 0's history; a retired id cannot rejoin."""
    sink = ListSink()
    reps = _pool(P, 2)
    router = _router(P, reps, sink, max_wait_ms=10_000)
    s = P["samples"]
    futs = [router.submit(x) for x in s[:8]]
    router.start()
    results = [f.result(timeout=60) for f in futs]
    removed = router.remove_replica(0, timeout_s=10.0)
    with pytest.raises(ValueError, match="not in the pool"):
        router.remove_replica(0)
    with pytest.raises(ValueError, match="last replica"):
        router.remove_replica(1)
    futs = [router.submit(x) for x in s[8:12]]
    results += [f.result(timeout=60) for f in futs]
    summary = router.drain()
    with pytest.raises(ValueError, match="retired"):
        router.add_replica(P["Replica"](0, P["engines"][0]))
    return _outcome(results, sink, summary, removed=_pool_summary(removed))


class GatedEngine:
    """An engine whose dispatches wait for ``gate``: a replica's worker
    held inside its first dispatch until a script lets it go."""

    def __init__(self, engine):
        self._engine = engine
        self.gate = threading.Event()

    def __getattr__(self, name):
        return getattr(self._engine, name)

    def infer(self, *args, **kw):
        assert self.gate.wait(30)
        return self._engine.infer(*args, **kw)


def _scale_in(P, tmp_path, kill: bool):
    """``test_autoscale.py::test_scale_in_migrates_resident_sessions_zero_lost``
    (and with ``replica_kill@3``, ``::test_scale_in_survives_replica_kill_mid_drain``):
    six sessions in before the workers start (three a replica); replica 0
    runs alone, held inside its first dispatch while its removal starts;
    let go, its two sessions of that dispatch hand over at step 1
    (``scale_in``, no replay), and the third at its own first step, or,
    killed at that dispatch, through the failure path; then replica 1
    runs all six. Zero lost."""
    sink = ListSink()
    gated = GatedEngine(P["engines"][0])
    reps = [P["Replica"](0, gated), P["Replica"](1, P["engines"][1])]
    for r in reps:
        r.warm(P["samples"][:1], rows=MAX_BATCH)
    router = _router(P, reps, sink, max_wait_ms=50.0, session_snapshot_every=2,
                     faults={0: _faults(P, "replica_kill@3")} if kill else None)
    s = P["samples"]
    steps = 5 if kill else 8
    futs = [router.submit_rollout(x, steps) for x in s[:6]]
    reps[0].server.start()
    done = {}
    remover = threading.Thread(
        target=lambda: done.update(summary=router.remove_replica(0, timeout_s=30.0)))
    remover.start()
    _wait_for(lambda: reps[0].server._evict_cb is not None, "the eviction")
    gated.gate.set()
    remover.join(60)
    assert not remover.is_alive()
    reps[1].server.start()
    results = [f.result(timeout=60) for f in futs]
    summary = router.drain()
    _hold_to_offline(P, results, s[:6], reps[1].engine)
    return _outcome(results, sink, summary, removed=_pool_summary(done["summary"]))


def _resume(P, tmp_path):
    """``test_autoscale.py::test_named_session_resumes_across_router_restart``:
    a named session drained after its first step persists its snapshot;
    a new pool (replicas 10 and 11) resumes it to the end."""
    store = P["Store"](str(tmp_path / P["name"] / "sessions"))
    sink = ListSink()
    reps = _pool(P, 2)
    router = _router(P, reps, sink, max_wait_ms=1.0, session_store=store).start()
    drainer = {}

    def on_step(sid, k, out):
        if k == 1:
            t = drainer["thread"] = threading.Thread(target=lambda: router.drain(10.0))
            t.start()
            _wait_for(lambda: reps[0].server._draining.is_set(), "the drain")

    s = P["samples"]
    first = router.submit_rollout(s[1], 6, name="restartable", on_step=on_step).result(timeout=60)
    drainer["thread"].join(30)
    stored = store.names()
    sink2 = ListSink()
    router2 = _router(P, _pool(P, 2, ids=[10, 11]), sink2, max_wait_ms=1.0,
                      session_store=store).start()
    with pytest.raises(KeyError):
        router2.resume_rollout("never-existed")
    second = router2.resume_rollout("restartable").result(timeout=60)
    summary = router2.drain(10.0)
    want = P["rollout"].offline_rollout(reps[0].engine, s[1], 6, rows=MAX_BATCH)
    assert P["rollout"].parity_check(second.outputs, want) <= PARITY
    out = _outcome([first, second], sink2, summary, stored=stored)
    out["router"] = _router_events(sink.records) + out["router"]
    return out


def _removed_between_place_and_submit(P, tmp_path):
    """Phase 16 (c)'s window on the card, forced by a hook instead of
    timing: the router places a request on replica 0, then the heal's
    removal (reason ``heal_dead``) drains replica 0 before the submit lands
    there. A request placed after the removal goes to replica 1."""
    sink = ListSink()
    reps = _pool(P, 2)
    router = _router(P, reps, sink).start()
    s = P["samples"]
    results = [router.submit(s[0]).result(timeout=60)]
    place = router._place

    def place_then_remove(key):
        replica, reason = place(key)
        router._place = place
        router.remove_replica(replica.replica_id, timeout_s=10.0, reason="heal_dead")
        return replica, reason

    router._place = place_then_remove
    results += [router.submit(x).result(timeout=60) for x in s[1:3]]
    summary = router.drain()
    return _outcome(results, sink, summary)


SCRIPTS = {
    "cold_assign": _cold_assign,
    "breaker": _breaker,
    "wedged": _wedged,
    "spill": _spill,
    "load_accounting": _load_accounting,
    "dtype": _dtype,
    "add_replica": _add_replica,
    "remove_history": _remove_history,
    "resume": _resume,
    "kill_migrates": lambda P, t: _migrate(P, t, "replica_kill@2"),
    "kill_migrates_tenant": lambda P, t: _migrate(P, t, "replica_kill@2", tenant="batch"),
    "breaker_migrates": lambda P, t: _migrate(P, t, "rollout_nan@2"),
    "scale_in": lambda P, t: _scale_in(P, t, kill=False),
    "scale_in_kill": lambda P, t: _scale_in(P, t, kill=True),
    "removed_between_place_and_submit": _removed_between_place_and_submit,
}


def _routes(out) -> list:
    return [(e["replica"], e["reason"]) for e in out["router"] if e["event"] == "route"]


def _kinds(out, kind: str) -> list:
    return [e for e in out["router"] if e["event"] == kind]


@pytest.mark.parametrize("name", list(SCRIPTS))
def test_the_router_script_runs_as_in_jax(name, setup, tmp_path):
    want = SCRIPTS[name](setup["jax"], tmp_path)
    got = SCRIPTS[name](setup["port"], tmp_path)
    _assert_same(got, want)
    reasons = [_result(r)[1] for r in got["results"]]
    summary = got["summary"]
    if name == "cold_assign":
        assert _routes(got) == [(0, "cold_assign")] + [(0, "affinity")] * 3
        assert [p["compiled_shapes"] for p in summary["per_replica"].values()][0] > [
            p["compiled_shapes"] for p in summary["per_replica"].values()][1]
    elif name == "breaker":
        routes = _routes(got)
        assert {r for r, _ in routes[:6]} == {1} and routes[6][0] == 0
        assert got["closed"] == "closed" and set(reasons) == {"ok"}
        assert ("breaker_open" in [e["reason"] for e in _kinds(got, "replica_health")])
    elif name == "wedged":
        assert reasons == ["ok"] * 4 + ["shed_deadline"]
        assert [r for r, _ in _routes(got)] == [0, 1, 1, 1, 1]
        assert any(e["reason"] == "wedged" for e in _kinds(got, "replica_health"))
    elif name == "spill":
        assert _routes(got) == [(0, "affinity"), (0, "affinity"), (1, "spill")]
        assert reasons == ["rejected_draining"] * 3 and summary["routing"]["spills"] == 1
    elif name == "load_accounting":
        assert [r for r, _ in _routes(got)] == [0, 1, 1]
        assert _kinds(got, "route")[0]["session"] and reasons[0] == "drained"
    elif name == "dtype":
        assert [r for r, _ in _routes(got)] == [0, 1] * 4
        assert {e["dtype"] for e in _kinds(got, "route")} == {"float32"} == {summary["dtype"]}
    elif name == "add_replica":
        [warm] = _kinds(got, "replica_warm")
        assert (warm["replica"], warm["source"], warm["programs"]) == (1, "compile", 1)
        assert [r for r, _ in _routes(got)] == [0, 1, 0] and got["pool"] == [0, 1]
        assert got["span_replicas"] == want["span_replicas"] == [0, 1]
        assert [json.loads(a) for n, a in got["spans"] if n == "replica_warm"] == [
            {"replica": 1, "source": "compile", "programs": 1}]
    elif name == "remove_history":
        assert set(reasons) == {"ok"} and summary["requests"] == summary["completed"] == 12
        assert summary["per_replica"]["0"]["retired"] and summary["routing"]["removed"] == 1
        [rm] = _kinds(got, "replica_remove")
        assert (rm["replica"], rm["reason"], rm["pool"]) == (0, "scale_in", 1)
        assert got["removed"]["requests"] == 4
    elif name == "resume":
        assert reasons == ["drained", "ok"] and got["stored"] == ["restartable"]
        assert got["results"][1].steps_completed == 6
        assert any(e.get("session") == "restartable" and e["replica"] in (10, 11)
                   for e in _kinds(got, "route"))
    elif name == "removed_between_place_and_submit":
        # Neither router places the request again: both answer it
        # rejected_draining, the reason the card's check must admit for a
        # request in flight at a heal's removal.
        assert reasons == ["ok", "rejected_draining", "ok"]
        assert [r for r, _ in _routes(got)] == [0, 0, 1]
        [rm] = _kinds(got, "replica_remove")
        assert (rm["replica"], rm["reason"]) == (0, "heal_dead")
    elif name.startswith("scale_in"):
        assert set(reasons) == {"ok"} and summary["sessions"]["lost"] == 0
        moves = [(m["session"], m["reason"], m["at_step"], m["replay_from"])
                 for m in _kinds(got, "session_migrate")]
        assert all((m["from_replica"], m["to_replica"]) == (0, 1)
                   for m in _kinds(got, "session_migrate"))
        last = ("r00005", "scale_in", 1, 1) if name == "scale_in" else (
            "r00005", "error_replica_dead", 0, 0)
        assert moves == [("r00001", "scale_in", 1, 1), ("r00003", "scale_in", 1, 1), last]
        assert [e["reason"] for e in _kinds(got, "replica_health")
                if e["replica"] == 0][-1] == ("retiring" if name == "scale_in" else "dead")
    else:
        assert set(reasons) == {"ok"} and summary["sessions"]["lost"] == 0
        moves = _kinds(got, "session_migrate")
        assert len(moves) == 2 and all(m["to_replica"] == 1 for m in moves)
        if name.startswith("kill"):
            assert {m["reason"] for m in moves} == {"error_replica_dead"}
            assert any(e["reason"] == "dead" and e["replica"] == 0
                       for e in _kinds(got, "replica_health"))
        else:
            assert summary["breaker_trips"] == 1
        if name == "kill_migrates_tenant":
            assert set(summary["tenants"]) == {"batch"}
            assert summary["tenants"]["batch"]["completed"] == 4 * 4


def test_a_rolling_reload_runs_as_in_jax(setup, tmp_path):
    want = _rolling_reload(setup["jax"], tmp_path)
    got = _rolling_reload(setup["port"], tmp_path)
    _assert_same(got, want)
    assert got["ok"] == want["ok"] == (3, 3)
    assert got["summary"]["shed"] == {} and got["summary"]["reloads"] == 6
    rolling = [(e["rollout"], e["step"], e["replica"], e["ok"])
               for e in _kinds(got, "rolling_reload")]
    assert rolling == [(1, 1, 0, True), (1, 2, 1, True), (1, 3, 2, True),
                       (2, 1, 0, True), (2, 2, 1, True), (2, 3, 2, True)]
    # One replica warming at a time: each warming edge is followed by its
    # own return to ok before the next replica warms.
    edges = [(e["replica"], e["reason"]) for e in _kinds(got, "replica_health")
             if e["reason"] in ("warming", "ok")]
    warming = [i for i, (_, reason) in enumerate(edges) if reason == "warming"]
    for i in warming:
        assert edges[i + 1] == (edges[i][0], "ok")
    for tag in ("first", "second"):
        for a, b in zip(got[tag], want[tag]):
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
    # After the corrupted rollout replica 0 serves latest, 1 and 2 best.
    assert not np.allclose(got["first"][0], got["first"][1])
    assert np.array_equal(got["first"][1], got["first"][2])
    assert all(np.array_equal(got["second"][0], x) for x in got["second"])


def test_the_pool_merge_and_events_are_jax_s(setup, tmp_path):
    """The registry's pool merge and the router's event stream against
    both registries (``test_metrics_plane.py``, ``test_obs.py``)."""
    want = _pool_merge(setup["jax"], tmp_path)
    got = _pool_merge(setup["port"], tmp_path)
    _assert_same(got, want)
    for key in ("per", "merged", "routes", "wedged"):
        assert got[key] == want[key], key
    assert got["per"] == [4, 4] and got["merged"] == (8, True, True) and got["routes"] == 8
    want = _events_validate(setup["jax"], tmp_path)
    got = _events_validate(setup["port"], tmp_path)
    _assert_same(got, want)
    assert got["ok"] == want["ok"] == 2
    kinds = {r["event"] for r in got["records"]}
    assert {"route", "rolling_reload", "replica_health", "serve_summary"} <= kinds
    for rec in got["records"]:
        assert events.validate_record(rec) == [] == jax_events.validate_record(rec), rec
    [pool] = [r for r in got["records"] if r["event"] == "serve_summary" and "per_replica" in r]
    assert pool["requests"] == 4
    assert all("replica" in r for r in got["records"] if r["event"] == "queue_depth")


def test_replicas_share_the_device_and_keep_their_own_weights(setup, tmp_path):
    """``build_replicas`` on the CPU: each replica its own copy of the
    weights (the model itself untouched), no stream, JAX's refusals; a
    replica's outputs equal the served model's; ``prewarm_from`` is
    refused, a catalog is taken, and ``persist_snapshots`` reaches the
    replica's server: a due snapshot of a named session is on disk before
    the session ends, as in JAX."""
    model = setup["model"]
    reps = build_replicas(model, 2, batch_size=MAX_BATCH)
    assert [r.replica_id for r in reps] == [0, 1]
    a, b = (dict(r.engine.model.named_parameters()) for r in reps)
    for name, p in model.named_parameters():
        assert a[name].data_ptr() != p.data_ptr() != b[name].data_ptr()
        assert np.array_equal(a[name].detach().numpy(), p.detach().numpy())
    assert all(r.engine.stream is None and r.engine.device.type == "cpu" for r in reps)
    one = build_replica(model, 7, "cpu", batch_size=MAX_BATCH)
    s = setup["port"]["samples"][:2]
    key = one.engine.bucket_key(s[0])
    got = one.engine.infer(s, pad_nodes=key[0], pad_funcs=key[1], rows=MAX_BATCH)
    want = setup["port"]["engines"][0].infer(s, pad_nodes=key[0], pad_funcs=key[1],
                                            rows=MAX_BATCH)
    for x, y in zip(got, want):
        assert np.array_equal(x, y)
    with pytest.raises(ValueError, match="n_replicas"):
        build_replicas(model, 0, batch_size=MAX_BATCH)
    with pytest.raises(ValueError, match="at least one device"):
        build_replicas(model, 3, batch_size=MAX_BATCH, devices=["cpu", "cpu"])
    with pytest.raises(NotPortedError, match="prewarm"):
        one.prewarm_from({})
    # A catalog is taken (it came with the autoscaler's slice): the one
    # catalog reaches the replica's server and, through it, its engine.
    catalog = ProgramCatalog()
    shared = ReplicaRouter([one], catalog=catalog)
    assert one.server._catalog is catalog and one.engine.catalog is catalog
    assert shared.pool() == [one]
    store = SessionStore(str(tmp_path / "store"))
    persisting = ReplicaRouter([one], max_batch=MAX_BATCH, session_store=store,
                               persist_snapshots=True).start()
    seen = []
    fut = persisting.submit_rollout(
        s[0], 3, name="kept",
        on_step=lambda sid, step, out: seen.append((step, (store.load(sid) or {}).get("cursor"))))
    assert fut.result(timeout=30).ok
    persisting.drain(5)
    # Each step's callback runs before its own snapshot is written.
    assert seen == [(1, None), (2, 1), (3, 2)] and store.names() == []


# -- the command line -------------------------------------------------------------

FLAGS = ["serve_replicas", "route_policy", "wedge_after_s"]
# 4-row dispatches: JAX's replicas each take 4 of the 8 forced host devices.
TINY_ARGV = ["--serve", "--synthetic", "darcy2d", "--n_test", "8", "--n_train", "4",
             "--n_attn_layers", "1", "--n_attn_hidden_dim", "16", "--n_mlp_num_layers", "1",
             "--n_mlp_hidden_dim", "16", "--n_input_hidden_dim", "16", "--n_expert", "2",
             "--n_head", "2", "--serve_max_batch", "4", "--serve_max_wait_ms", "1000"]


def test_the_three_replica_flags_take_jax_s_defaults_help_and_refusals(tmp_path):
    jp, pp = jax_main.build_parser(), port_main.build_parser()
    assert {f: getattr(pp.parse_args([]), f) for f in FLAGS} == {
        f: getattr(jp.parse_args([]), f) for f in FLAGS}
    helps = lambda p: {a.dest: (a.help, a.choices) for a in p._actions  # noqa: E731
                       if a.dest in FLAGS}
    assert helps(pp) == helps(jp) and len(helps(pp)) == 3
    assert pp.parse_args([]).serve_prewarm == jp.parse_args([]).serve_prewarm == ""
    argv = ["--serve_replicas", "3", "--route_policy", "round_robin", "--wedge_after_s", "0.5"]
    _, port = port_main.configs_from_args(pp.parse_args(argv))
    jax_sc = jax_main.config_from_args(jp.parse_args(argv)).serve
    assert ((port.replicas, port.route_policy, port.wedge_after_s)
            == (jax_sc.replicas, jax_sc.route_policy, jax_sc.wedge_after_s) == (3, "round_robin", 0.5))
    for field, bad in (("replicas", 0), ("route_policy", "sticky"), ("wedge_after_s", 0.0)):
        with pytest.raises(ValueError) as want:
            make_config(**{f"serve.{field}": bad})
        with pytest.raises(ValueError) as got:
            ServeConfig(**{field: bad})
        assert str(got.value) == str(want.value)
    base = TINY_ARGV + ["--device", "cpu"]
    with pytest.raises(NotPortedError, match="--serve_prewarm"):
        port_main.run(base + ["--serve_prewarm", str(tmp_path / "m.json")])
    for layout in ("--flat_params", "--scan_layers"):
        with pytest.raises(ValueError, match="standard param layout only; drop "
                           "--scan_layers/--flat_params for replicated serving"):
            port_main.run(base + ["--serve_replicas", "2", layout])


def test_main_serves_through_two_replicas_as_jax_s(tmp_path, capsys, monkeypatch):
    """``main --serve --serve_replicas 2`` on the CPU and ``gnot_tpu.main``
    with the same flags: the same routes, counters, ``per_replica`` and
    ``routing``; each replica warmed once and serving four requests. (JAX's
    weight init runs jitted, bitwise its eager result: the two runs' weights
    differ anyway, each drawn by its own package from the seed.)"""
    monkeypatch.setattr(jax_trainer, "init_params", _jitted_init(jax_trainer.init_params))
    pools = {}
    for pkg, mod, extra in (("jax", jax_main, []), ("port", port_main, ["--device", "cpu"])):
        path = tmp_path / pkg / "m.jsonl"
        # No wedge verdicts: a replica's progress stamp dates from its
        # server's construction, before the warm-up, in both packages.
        assert mod.main(TINY_ARGV + extra + ["--serve_replicas", "2", "--wedge_after_s", "60",
                                             "--metrics_path", str(path)]) == 1.0
        recs = [json.loads(ln) for ln in open(path)]
        [pool] = [r for r in recs if r.get("event") == "serve_summary" and "per_replica" in r]
        pools[pkg] = _pool_summary(pool)
        pools[pkg + "_routes"] = [(r["replica"], r["reason"]) for r in recs
                                  if r.get("event") == "route"]
    assert pools["port"] == pools["jax"]
    assert pools["port_routes"] == pools["jax_routes"] == [(0, "affinity"), (1, "affinity")] * 4
    per = pools["port"]["per_replica"]
    assert [(p["routed"], p["completed"], p["warmup_cache"]["programs"]) for p in per.values()] == [
        (4, 4, 1), (4, 4, 1)]
    out = capsys.readouterr().out
    assert "replicas=2 policy=affinity spills=0" in out
