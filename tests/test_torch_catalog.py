"""The port's program catalog and cost count (``gnot_tpu_torch/serve/catalog.py``,
``obs/costs.py``, the engine's ``attach_catalog``, the server's and the
router's ``catalog=``) against the JAX package's.

JAX's ``tests/test_capacity.py`` catalog scripts run through both
``ProgramCatalog``s with the same inputs: the same return values, the
same events in order, the same ``capacity_model`` dicts and ``program_*``
registry series. A mixed padded-and-packed storm runs through each
package's ``InferenceServer`` and through each ``ReplicaRouter`` of two
replicas (round robin), one request at a time so the dispatch groups are fixed, at
``tests/test_torch_serve_policies.py``'s size (64-point Darcy meshes and
small ragged ones, the width-16 one-block model, 2-row dispatches) with
the JAX weights carried over by ``interop.params_from_jax``, f32 on the
CPU: per program and replica the same dispatches, requests, real and
capacity tokens (device time left out), one ``program_catalog`` event a
program and one ``capacity_snapshot``. JAX's engines share one jitted
forward, so each program compiles once for the module.

The port counts costs where JAX reads XLA's analysis of the compiled
program: ``flops`` must equal ``FlopCounterMode``'s count of the port's
plain forward at the program's shape exactly and lie at 0.80-1.00 of
XLA's (the rest of XLA's count is elementwise work); ``transcendentals``,
``argument_bytes`` and ``output_bytes`` must equal XLA's, the argument
bytes shown tensor by tensor."""

import jax
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from gnot_tpu.config import ModelConfig as JaxModelConfig
from gnot_tpu.data import datasets as jax_datasets
from gnot_tpu.data.batch import MeshSample as JaxMeshSample
from gnot_tpu.data.batch import PackPlan as JaxPackPlan
from gnot_tpu.data.batch import collate as jax_collate
from gnot_tpu.models.gnot import GNOT as JaxGNOT
from gnot_tpu.obs import costs as jax_costs
from gnot_tpu.obs import metrics as jax_metrics
from gnot_tpu.serve import EngineReplica as JaxReplica
from gnot_tpu.serve import InferenceEngine as JaxEngine
from gnot_tpu.serve import InferenceServer as JaxServer
from gnot_tpu.serve import ReplicaRouter as JaxRouter
from gnot_tpu.serve import catalog as jax_catalog
from gnot_tpu.train.trainer import apply_batch as jax_apply_batch
from gnot_tpu.train.trainer import init_params
from gnot_tpu_torch.config import ModelConfig
from gnot_tpu_torch.data import datasets
from gnot_tpu_torch.data.batch import MeshSample, PackPlan, collate, pack_collate, pack_prefix
from gnot_tpu_torch.interop import params_from_jax
from gnot_tpu_torch.models.gnot import GNOT, apply_batch
from gnot_tpu_torch.obs import costs, events, metrics
from gnot_tpu_torch.serve import catalog
from gnot_tpu_torch.serve.replica import EngineReplica, build_replicas
from gnot_tpu_torch.serve.router import ReplicaRouter
from gnot_tpu_torch.serve.server import InferenceServer

MAX_BATCH = 2
TINY = dict(n_attn_layers=1, n_attn_hidden_dim=16, n_mlp_num_layers=1, n_mlp_hidden_dim=16,
            n_input_hidden_dim=16, n_expert=2, n_head=2)
#: The traffic-count fields the storms compare (device time is a time).
COUNTS = ("dispatches", "requests", "real_tokens", "capacity_tokens")
#: XLA's flops over the port's product count: its elementwise work on top.
FLOPS_SHARE = (0.80, 1.00)


class ListSink:
    def __init__(self):
        self.records = []

    def log(self, **record):
        self.records.append(record)

    def flush(self):
        pass


def _ragged(mesh_sample, base, sizes, seed: int) -> list:
    """``tests/test_capacity.py::_ragged``: small Darcy-schema meshes."""
    rng = np.random.default_rng(seed)
    f_dim = base.funcs[0].shape[-1]
    return [mesh_sample(
        coords=rng.uniform(0, 1, size=(m, 2)).astype(np.float32),
        y=np.zeros((m, 1), np.float32), theta=base.theta,
        funcs=(rng.uniform(0, 1, size=(max(4, m // 4), f_dim)).astype(np.float32),))
        for m in sizes]


@pytest.fixture(scope="module")
def setup():
    jsamples = jax_datasets.synth_darcy2d(4, seed=0, grid_n=8)
    psamples = datasets.synth_darcy2d(4, seed=0, grid_n=8)
    mc = dict(TINY, **jax_datasets.infer_model_dims(jsamples))
    jmodel = JaxGNOT(JaxModelConfig(**mc))
    params = jax.jit(lambda b: init_params(jmodel, b, 0))(jax_collate(jsamples[:2]))
    # One jitted forward for both JAX engines: each program compiles once.
    forward = jax.jit(lambda p, b: jax_apply_batch(jmodel, p, b))
    jengines = [JaxEngine(jmodel, params, batch_size=MAX_BATCH, forward=forward)
                for _ in range(2)]
    cfg = ModelConfig(**mc)
    model = GNOT(cfg)
    model.load_state_dict(params_from_jax(jax.device_get(params), cfg), strict=True)
    pengines = [r.engine for r in build_replicas(model, 2, batch_size=MAX_BATCH)]
    packages = {}
    for name, MS, Plan, base, engines in (
            ("jax", JaxMeshSample, JaxPackPlan, jsamples, jengines),
            ("port", MeshSample, PackPlan, psamples, pengines)):
        small = _ragged(MS, base[0], [16, 40, 24, 64, 8, 32], seed=0)
        plan = Plan.from_samples(small, chunk=8, batch_size=MAX_BATCH)
        oversize = _ragged(MS, base[0], [plan.row_len + 8], seed=5)[0]
        # Mixed: packed small meshes, the Darcy 64-point meshes (which fit
        # the plan too) and one oversize mesh on its padded bucket.
        traffic = [small[0], base[0], oversize, small[1], small[2], base[1], small[3],
                   oversize, small[4], small[5]]
        packages[name] = dict(engines=engines, samples=base, traffic=traffic, plan=plan,
                              oversize=oversize)
    packages["jax"].update(Server=JaxServer, Router=JaxRouter, Replica=JaxReplica,
                           catalog=jax_catalog, costs=jax_costs, metrics=jax_metrics)
    packages["port"].update(Server=InferenceServer, Router=ReplicaRouter, Replica=EngineReplica,
                            catalog=catalog, costs=costs, metrics=metrics)
    packages["model"] = model
    return packages


# -- the catalog scripts (tests/test_capacity.py), pure Python ------------------------------

KEY = "bucket:64x64@2@f32"


def _record_upgrade(pkg):
    """``test_catalog_record_upgrade_and_event``: first sight wins with one
    event, a thinner re-record is refused, a fuller one upgrades without a
    second event, a downgrade is refused."""
    sink = ListSink()
    cat = pkg["catalog"].ProgramCatalog(sink=sink)
    thin = pkg["costs"].unavailable_costs("manifest predates costs")
    full = {f: 1 for f in pkg["costs"].COST_FIELDS}
    returns = [cat.record(KEY, thin, source="manifest"), cat.record(KEY, thin, source="manifest"),
               cat.record(KEY, full, source="compile"), cat.get(KEY),
               cat.record(KEY, thin, source="hydrate"), cat.record("packed:1x128@f32", None,
                                                                   source="compile"),
               cat.has(KEY), cat.entries()]
    return returns, sink.records, cat.capacity_model()


def _backlog_replay(pkg):
    """``test_catalog_attach_outputs_replays_backlog``: entries recorded
    before a sink attaches replay into it; a second sink is not taken."""
    cat = pkg["catalog"].ProgramCatalog()
    cat.record(KEY, {f: 1 for f in pkg["costs"].COST_FIELDS}, source="hydrate")
    cat.record("packed:1x128@f32", pkg["costs"].unavailable_costs("x"), source="compile")
    sink, late = ListSink(), ListSink()
    cat.attach_outputs(sink=sink)
    cat.attach_outputs(sink=late)
    cat.record("bucket:128x64@2@f32", None, source="compile")
    return [], sink.records + [{"late": r} for r in late.records], cat.capacity_model()


def _capacity_model(pkg):
    """``test_capacity_model_rates_and_retired_replica_merge``: rates,
    pool capacity additive over replicas (replica 1 retired: its rows
    stay), a never-recorded program surfaced with the marker, the
    ``program_*`` series and one ``capacity_snapshot``."""
    registry, sink = pkg["metrics"].MetricsRegistry(), ListSink()
    cat = pkg["catalog"].ProgramCatalog(metrics=registry, sink=sink)
    c = {f: None for f in pkg["costs"].COST_FIELDS}
    c["flops"] = 1000
    cat.record(KEY, c, source="compile")
    for replica, dev in ((0, 0.5), (1, 0.25), (0, 0.125)):
        cat.note_dispatch(KEY, requests=2, real_tokens=100, capacity_tokens=128, device_s=dev,
                          replica=replica)
    cat.note_dispatch("bucket:999x64@2@f32", requests=1, real_tokens=10, capacity_tokens=64,
                      device_s=None, replica=0)
    cat.note_dispatch(KEY, requests=1, real_tokens=0, capacity_tokens=64, device_s=0.0)
    summary: dict = {}
    first = cat.emit_snapshot(summary)
    returns = [first, cat.emit_snapshot(), summary]
    series = {(r["name"], tuple(sorted(r["labels"].items()))): r.get("value", r.get("count"))
              for r in registry.snapshot().values()}
    return returns + [series], sink.records, cat.capacity_model()


SCRIPTS = {"record_upgrade": _record_upgrade, "backlog_replay": _backlog_replay,
           "capacity_model": _capacity_model}


@pytest.mark.parametrize("name", list(SCRIPTS))
def test_the_catalog_script_runs_as_in_jax(name, setup):
    got = SCRIPTS[name](setup["port"])
    want = SCRIPTS[name](setup["jax"])
    assert got == want
    returns, records, model = got
    assert model["programs"]
    for r in records:
        r = r.get("late", r)
        assert events.validate_record(r) == []


# -- the storms --------------------------------------------------------------------------


def _storm(pkg, kind: str) -> dict:
    """The mixed traffic through a server (engine 0) or a router of two
    replicas, each with one shared catalog; one request at a time."""
    sink = ListSink()
    cat = pkg["catalog"].ProgramCatalog(sink=sink)
    for e in pkg["engines"]:
        e.attach_catalog(None)
    common = dict(max_batch=MAX_BATCH, max_wait_ms=1.0, sink=sink, pack_plan=pkg["plan"],
                  catalog=cat)
    if kind == "server":
        tier = pkg["Server"](pkg["engines"][0], **common).start()
    else:
        reps = [pkg["Replica"](i, e) for i, e in enumerate(pkg["engines"])]
        # Round robin: one request at a time, so both replicas serve.
        tier = pkg["Router"](reps, route_policy="round_robin", wedge_after_s=60.0,
                             **common).start()
    results = [tier.submit(s).result(timeout=60) for s in pkg["traffic"]]
    summary = tier.drain()
    for e in pkg["engines"]:
        e.attach_catalog(None)
    model = summary["capacity_model"]
    return dict(
        ok=[r.ok for r in results], outputs=[r.output for r in results], catalog=cat,
        dispatches=summary["dispatches"],
        programs={k: {**{f: p[f] for f in COUNTS + ("source",)},
                      "per_replica": {rid: {f: t[f] for f in COUNTS}
                                      for rid, t in p["per_replica"].items()}}
                  for k, p in model["programs"].items()},
        pool={k: v for k, v in model["pool"].items() if k in COUNTS + ("replicas", "programs")},
        rates={k: (p["device_s"] > 0, p["tokens_per_device_s"] is not None)
               for k, p in model["programs"].items()},
        catalog_events=[(r["key"], r["source"]) for r in sink.records
                        if r["event"] == "program_catalog"],
        snapshots=sum(r["event"] == "capacity_snapshot" for r in sink.records),
        records=sink.records)


@pytest.fixture(scope="module")
def storms(setup):
    return {kind: {pkg: _storm(setup[pkg], kind) for pkg in ("jax", "port")}
            for kind in ("server", "router")}


@pytest.mark.parametrize("kind", ["server", "router"])
def test_a_mixed_storm_is_attributed_as_in_jax(kind, storms):
    got, want = storms[kind]["port"], storms[kind]["jax"]
    assert got["ok"] == want["ok"] == [True] * len(got["ok"])
    for a, b in zip(got["outputs"], want["outputs"]):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)
    for field in ("programs", "pool", "rates", "catalog_events", "snapshots"):
        assert got[field] == want[field], field
    # One program_catalog event a program, a packed and a padded program
    # dispatched, every dispatch attributed, every record valid.
    assert got["snapshots"] == 1
    assert sorted(k for k, _ in got["catalog_events"]) == sorted(got["programs"])
    assert {k.split(":")[0] for k in got["programs"]} == {"bucket", "packed"}
    assert got["pool"]["dispatches"] == got["dispatches"]
    assert got["pool"]["replicas"] == (1 if kind == "server" else 2)
    for r in got["records"]:
        assert events.validate_record(r) == []


def test_the_costs_are_xla_s_where_the_port_counts_them(setup, storms):
    """Each program's count against ``FlopCounterMode`` (exact) and against
    XLA's analysis of the JAX engine's compiled program of the same key."""
    port, jax_pkg = setup["port"], setup["jax"]
    model = setup["model"]
    got = storms["server"]["port"]["catalog"].entries()
    want = storms["server"]["jax"]["catalog"].entries()
    assert set(got) == set(want)
    plan, over = port["plan"], port["oversize"]
    pn, pf = port["engines"][0].bucket_key(over)
    placements = pack_prefix([s.coords.shape[0] for s in port["traffic"][:2]], plan)
    batches = {
        catalog.bucket_program_key(pn, pf, MAX_BATCH, "float32"):
            collate([over] * MAX_BATCH, bucket=False, pad_nodes=pn, pad_funcs=pf),
        catalog.packed_program_key(plan, "float32"): pack_collate(
            port["traffic"][:2], placements, n_rows=plan.n_rows, row_len=plan.row_len,
            chunk=plan.chunk, n_slots=plan.n_slots, pad_funcs=plan.pad_funcs),
    }
    assert set(batches) == set(got)
    weights = sum(p.numel() * p.element_size() for p in model.parameters())
    for key, batch in batches.items():
        c, x = got[key]["costs"], want[key]["costs"]
        assert got[key]["source"] == want[key]["source"] == "compile"
        with FlopCounterMode(display=False) as fc, torch.inference_mode():
            out = apply_batch(model, batch)
        assert c["flops"] == fc.get_total_flops(), key
        assert FLOPS_SHARE[0] <= c["flops"] / x["flops"] <= FLOPS_SHARE[1], (key, c, x)
        assert c["transcendentals"] == x["transcendentals"], key
        # Tensor by tensor: the weights, then every batch field the forward
        # reads; ``y`` (the targets) is not read, and XLA drops it too.
        read = {n: t for n, t in vars(batch).items()
                if isinstance(t, torch.Tensor) and n != "y"}
        assert c["argument_bytes"] == weights + sum(
            t.numel() * t.element_size() for t in read.values()) == x["argument_bytes"], key
        assert c["output_bytes"] == out.numel() * 4 == x["output_bytes"], key
        assert c["unavailable"] == sorted(costs.UNCOUNTED_FIELDS)
        assert all(c[f] is None for f in costs.UNCOUNTED_FIELDS)
        assert "unavailable" not in x and all(x[f] is not None for f in costs.COST_FIELDS)
    assert set(costs.COST_FIELDS) == set(jax_pkg["costs"].COST_FIELDS)
    assert costs.COST_FIELDS == jax_pkg["costs"].COST_FIELDS
    assert costs.unavailable_costs("r") == jax_pkg["costs"].unavailable_costs("r")


def test_a_failed_count_records_the_marker_and_serves(setup, monkeypatch):
    """A cost count that raises records JAX's ``capture failed`` marker,
    once per program, and the dispatch still answers; a second engine
    dispatching the same program adds no entry."""
    from gnot_tpu_torch.serve import engine as engine_mod

    def boom(*a, **k):
        raise RuntimeError("no count")

    monkeypatch.setattr(engine_mod, "program_costs", boom)
    port = setup["port"]
    cat = catalog.ProgramCatalog()
    e0, e1 = port["engines"]
    s = port["samples"][0]
    pn, pf = e0.bucket_key(s)
    try:
        e0.attach_catalog(cat)
        e1.attach_catalog(cat)
        outs = [e.infer([s], pad_nodes=pn, pad_funcs=pf, rows=MAX_BATCH) for e in (e0, e1, e0)]
    finally:
        e0.attach_catalog(None)
        e1.attach_catalog(None)
    assert all(np.isfinite(o[0]).all() for o in outs)
    [(key, entry)] = cat.entries().items()
    assert key == catalog.bucket_program_key(pn, pf, MAX_BATCH, "float32")
    assert entry["costs"] == costs.unavailable_costs("capture failed: RuntimeError")
