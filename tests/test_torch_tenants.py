"""The port's tenant plane (``parse_tenant_spec``, ``ServeConfig``'s tenant
fields, ``serve/policies.py::TenantPolicy``, the batcher's WFQ mode, the
server's quota gate and per-tenant accounting) against the JAX package's.

The policy and the batcher run the same scripts as JAX's: fixed ones
mirroring ``tests/test_serve.py``'s tenant tests, and seeded random
arrival scripts (tenants, weights, priorities, ages, a packed
``take_fn``), whose ``pop_ready`` sequences must be identical request for
request. The servers run the same scripts on a stub engine (no model: the
forward returns zeros and logs each dispatch's requests; the accounting,
not the numbers, is under test here; ``tests/test_torch_rollout.py`` holds
the served numbers), each request submitted before the worker starts, so
the dispatch groups are deterministic. Held equal: each request's reason,
the dispatch order, the event stream (times left out), the summary's
counters and ``tenants`` block, the registry's tenant series and the
tenant SLO edges. Last, the three tenant flags against JAX's."""

import os
import signal
import time

import numpy as np
import pytest

from gnot_tpu import main as jax_main
from gnot_tpu.config import make_config
from gnot_tpu.config import parse_tenant_spec as jax_parse
from gnot_tpu.obs import metrics as jax_metrics
from gnot_tpu.resilience.preemption import PreemptionHandler as JaxPreemptionHandler
from gnot_tpu.serve import InferenceServer as JaxServer
from gnot_tpu.serve import batcher as jax_batcher
from gnot_tpu.serve import policies as jax_policies
from gnot_tpu_torch import main as port_main
from gnot_tpu_torch.config import ServeConfig, parse_tenant_spec
from gnot_tpu_torch.data.batch import MeshSample
from gnot_tpu_torch.obs import metrics
from gnot_tpu_torch.resilience.preemption import PreemptionHandler
from gnot_tpu_torch.serve import batcher, policies
from gnot_tpu_torch.serve.server import InferenceServer

PACKAGES = {
    "jax": dict(server=JaxServer, policies=jax_policies, batcher=jax_batcher,
                metrics=jax_metrics, preempt=JaxPreemptionHandler),
    "port": dict(server=InferenceServer, policies=policies, batcher=batcher,
                 metrics=metrics, preempt=PreemptionHandler),
}


# -- the spec grammar, the config and the policy ----------------------------------

SPECS = ["", "a:1", "a:3,b:1", " a : 2 , b:7 ", "a:1,,b:2", "a", "a:", ":1", "a:1,a:2",
         "a:1;b:2", "interactive:interactive,batch:batch"]


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("what", ["weight", "quota", "priority"])
def test_parse_tenant_spec_is_jax_s(spec, what):
    try:
        want = jax_parse(spec, what=what)
    except ValueError as err:
        with pytest.raises(ValueError) as got:
            parse_tenant_spec(spec, what=what)
        assert str(got.value) == str(err)
        return
    got = parse_tenant_spec(spec, what=what)
    assert got == want and list(got) == list(want)


BAD = [("tenant_weights", "a:0"), ("tenant_weights", "a:x"), ("tenant_weights", "a:1.5"),
       ("tenant_weights", "a"), ("tenant_quotas", "a:none"), ("tenant_quotas", "a:0"),
       ("tenant_quotas", "a:1,a:2"), ("tenant_priorities", "a:urgent"),
       ("tenant_priorities", "a:")]


@pytest.mark.parametrize("field,value", BAD)
def test_serve_config_refuses_a_bad_tenant_spec_with_jax_s_message(field, value):
    with pytest.raises(ValueError) as want:
        make_config(**{f"serve.{field}": value})
    with pytest.raises(ValueError) as got:
        ServeConfig(**{field: value})
    assert str(got.value) == str(want.value)


def test_serve_config_takes_jax_s_tenant_fields():
    good = dict(tenant_weights="interactive:3,batch:1", tenant_quotas="batch:4",
                tenant_priorities="interactive:interactive,batch:batch")
    want = make_config(**{f"serve.{k}": v for k, v in good.items()}).serve
    got = ServeConfig(**good)
    assert {k: getattr(got, k) for k in good} == {k: getattr(want, k) for k in good}
    fresh, jax_fresh = ServeConfig(), make_config().serve
    six = ("rollout_steps", "session_snapshot_every", "session_dir", *good)
    assert {k: getattr(fresh, k) for k in six} == {k: getattr(jax_fresh, k) for k in six}


def _policy_script(mod):
    trace = [mod.TenantPolicy.from_specs() is None, mod.DEFAULT_TENANT, mod.PRIORITY_CLASSES]
    pol = mod.TenantPolicy.from_specs(weights="interactive:3,batch:1", quotas="batch:2",
                                      priorities="bulk:batch")
    trace.append(pol.tenants)
    for t in ("interactive", "batch", "bulk", "unlisted", "default"):
        trace.append((t, pol.weight(t), pol.priority(t), pol.quota(t), pol.in_system(t)))
    trace.append([pol.try_admit("batch") for _ in range(3)] + [pol.try_admit("interactive")])
    trace.append(pol.in_system("batch"))
    pol.release("batch")
    pol.release("interactive")  # no quota: a no-op
    trace.append((pol.try_admit("batch"), pol.in_system("batch")))
    for kw in (dict(weights={"a": 0}), dict(priorities={"a": "urgent"}), dict(quotas={"a": 0})):
        with pytest.raises(ValueError) as err:
            mod.TenantPolicy(**kw)
        trace.append(str(err.value))
    return trace


def test_tenant_policy_is_jax_s_step_for_step():
    got = _policy_script(policies)
    assert got == _policy_script(jax_policies)
    assert got[4:6] == [("interactive", 3, "interactive", None, 0), ("batch", 1, "batch", 2, 0)]


# -- the WFQ batcher, against JAX's -------------------------------------------------


def _pops(mod, script, tenants_kw, *, max_batch, max_wait_ms, take=None):
    """Run one arrival script (``("add", key, tenant, id, now)`` and
    ``("pop", now, flush_all)`` steps) through a Batcher of ``mod``; return
    every pop's batches as (key, [(tenant, id)]) plus the length and the
    next flush after each step."""
    pol = mod["policies"].TenantPolicy(**tenants_kw) if tenants_kw is not None else None
    b = mod["batcher"].Batcher(max_batch=max_batch, max_wait_ms=max_wait_ms,
                               key_fn=lambda r: r[0], tenants=pol, tenant_fn=lambda r: r[1],
                               take_fn=take)
    out = []
    for step in script:
        if step[0] == "add":
            b.add(step[1:4], now=step[4])
        else:
            out.append([(k, [r[1:] for r in reqs])
                        for k, reqs in b.pop_ready(step[1], flush_all=step[2])])
        out.append((len(b), b.next_flush_in(step[-2] if step[0] == "pop" else step[4]),
                    sorted(r[1:] for r in b.requests())))
    return out


def _random_script(seed: int):
    rng = np.random.default_rng(seed)
    tenants = [f"t{i}" for i in range(int(rng.integers(2, 6)))] + ["batch", "default"]
    weights = {t: int(rng.integers(1, 5)) for t in tenants if rng.random() < 0.7}
    prios = {t: str(rng.choice(["interactive", "batch"])) for t in tenants if rng.random() < 0.5}
    script, now, n = [], 0.0, 0
    for _ in range(int(rng.integers(30, 60))):
        now += float(rng.exponential(0.004))
        if rng.random() < 0.75:
            n += 1
            script.append(("add", str(rng.choice(["k1", "k2"])), str(rng.choice(tenants)), n,
                           round(now, 6)))
        else:
            script.append(("pop", round(now, 6), bool(rng.random() < 0.15)))
    script.append(("pop", now + 1.0, True))
    return script, dict(weights=weights, priorities=prios)


def _packed_take(key, reqs):
    """A first-fit stand-in for bucket "k1" (the packed bucket): the prefix
    whose sizes (id mod 5 + 1) fit 9; None (max_batch) for "k2"."""
    if key != "k1":
        return None
    total = 0
    for i, r in enumerate(reqs):
        total += r[2] % 5 + 1
        if total > 9:
            return i
    return len(reqs)


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("packed", [False, True], ids=["padded", "packed"])
def test_wfq_pop_ready_sequences_are_jax_s_request_for_request(seed, packed):
    script, kw = _random_script(seed)
    opts = dict(max_batch=int(3 + seed % 3), max_wait_ms=10.0,
                take=_packed_take if packed else None)
    got = _pops(PACKAGES["port"], script, kw, **opts)
    assert got == _pops(PACKAGES["jax"], script, kw, **opts)
    assert got[-1][0] == 0  # the final flush empties it
    # The untagged batcher on the same script is JAX's too.
    assert _pops(PACKAGES["port"], script, None, **opts) == _pops(
        PACKAGES["jax"], script, None, **opts)


def _fixed_scripts(mod):
    """``tests/test_serve.py``'s four tenant batcher scripts."""
    out = {}
    pol = mod["policies"].TenantPolicy(weights={"alice": 3, "bob": 1},
                                    priorities={"alice": "interactive", "bob": "interactive"})
    b = mod["batcher"].Batcher(max_batch=4, max_wait_ms=50, key_fn=lambda r: "k", tenants=pol,
                               tenant_fn=lambda r: r[0])
    for i in range(8):
        b.add(("bob", i), now=0.001 * (2 * i))
        b.add(("alice", i), now=0.001 * (2 * i + 1))
    out["weighted"] = [reqs for _, reqs in b.pop_ready(1.0, flush_all=True)]
    b = mod["batcher"].Batcher(max_batch=2, max_wait_ms=50, key_fn=lambda r: "k",
                               tenants=mod["policies"].TenantPolicy(), tenant_fn=lambda r: r[0])
    b.add(("batch", 0), now=0.0)
    b.add(("batch", 1), now=0.0)
    first = b.pop_ready(0.001)
    for i in range(2, 6):
        b.add(("batch", i), now=0.002)
    for i in range(4):
        b.add(("interactive", i), now=0.003)
    out["tiers"] = [first, b.pop_ready(1.0, flush_all=True)]
    b = mod["batcher"].Batcher(max_batch=8, max_wait_ms=100, key_fn=lambda r: "k",
                               tenants=mod["policies"].TenantPolicy(weights={"alice": 9, "bob": 1}),
                               tenant_fn=lambda r: r[0])
    b.add(("bob", 0), now=0.0)
    b.add(("alice", 0), now=0.09)
    aged = [b.pop_ready(0.05), b.next_flush_in(0.05), b.pop_ready(0.1), len(b)]
    for i in range(9):
        b.add(("alice", i), now=0.2)
    b.add(("bob", 1), now=0.2)
    aged += [b.pop_ready(0.201), b.next_flush_in(0.25), b.pop_ready(0.301)]
    out["aged"] = aged
    seen = []
    b = mod["batcher"].Batcher(max_batch=2, max_wait_ms=100, key_fn=lambda r: r[0],
                               tenant_fn=lambda r: seen.append(r) or "x")
    b.add(("a", 1), now=0.0)
    b.add(("a", 2), now=0.01)
    out["untagged"] = [b.pop_ready(0.02), seen]
    return out


def test_the_tenant_batcher_scripts_of_jax_s_tests_run_alike():
    got = _fixed_scripts(PACKAGES["port"])
    assert got == _fixed_scripts(PACKAGES["jax"])
    assert [[t for t, _ in reqs].count("alice") for reqs in got["weighted"]] == [3, 3, 2, 0]
    assert [t for _, reqs in got["tiers"][1] for t, _ in reqs] == ["interactive"] * 4 + ["batch"] * 4
    assert got["aged"][0] == [] and got["aged"][1] == pytest.approx(0.05)
    assert got["untagged"] == [[("a", [("a", 1), ("a", 2)])], []]


# -- the servers: one script, run through each package (stub engine) --------------


class ListSink:
    def __init__(self):
        self.records = []

    def log(self, **record):
        self.records.append(record)

    def flush(self):
        pass


class StubEngine:
    """An engine without a model: one bucket, zeros for outputs, and a log
    of each dispatch's request ids (``theta[0]``)."""

    dtype = "float32"
    compiled_shapes = dispatch_shapes = 1

    def __init__(self):
        self.dispatched = []

    def validate(self, samples):
        for s in samples:
            if not np.all(np.isfinite(s.coords)):
                raise ValueError("sample 0: non-finite coords")

    @staticmethod
    def bucket_key(sample):
        return (8, 0)

    def warmup(self, samples, rows=None):
        return 0

    def infer(self, samples, *, pad_nodes, pad_funcs, rows=None, timings=None, clock=None):
        self.dispatched.append([int(s.theta[0]) for s in samples])
        return [np.zeros((s.coords.shape[0], 1), np.float32) for s in samples]


def _sample(i: int) -> MeshSample:
    return MeshSample(coords=np.zeros((8, 2), np.float32), y=np.zeros((8, 1), np.float32),
                      theta=np.full((1,), i, np.float32), funcs=())


TIMES = {"ts", "waited_ms", "latency_ms", "latency_p50_ms", "latency_p99_ms",
         "dispatch_ms_p50", "dispatch_ms_max", "value", "burn_fast", "burn_slow"}


def _tenant_block(summary: dict):
    if "tenants" not in summary:
        return None
    return {t: {k: v for k, v in st.items() if k not in TIMES} | {
        "p99_is_set": st["latency_p99_ms"] is not None}
        for t, st in summary["tenants"].items()}


def _run(pkg: str, submissions, *, policy=None, max_batch=2, sigterm=False, registry=False,
         after=None):
    """Submit ``submissions`` (``(id, tenant)``) to a server that has not
    started, start it (``sigterm``: a SIGTERM first, so the worker drains
    at once), resolve everything, drain. Returns what is compared."""
    mod = PACKAGES[pkg]
    pol = mod["policies"].TenantPolicy(**policy) if policy is not None else None
    engine, sink = StubEngine(), ListSink()
    reg = mod["metrics"].MetricsRegistry() if registry else None
    slo = None
    if registry:
        sc = make_config(**{"serve.slo_p99_ms": 1e-6, "serve.slo_shed_frac": 0.05,
                            "serve.slo_fast_window_s": 1.0,
                            "serve.slo_slow_window_s": 2.0}).serve
        slo = mod["metrics"].SLOEvaluator(
            mod["metrics"].default_objectives(sc)
            + mod["metrics"].tenant_objectives(sc, pol.tenants if pol is not None else []))
        slo.observe(0.0, reg.snapshot())
    with mod["preempt"]() as preempt:
        srv = mod["server"](engine, max_batch=max_batch, max_wait_ms=10_000, sink=sink,
                            tenants=pol, metrics=reg, preempt=preempt)
        futs = [srv.submit(_sample(i), tenant=t) for i, t in submissions]
        if sigterm:
            os.kill(os.getpid(), signal.SIGTERM)
            deadline = time.monotonic() + 10
            while not preempt.triggered and time.monotonic() < deadline:
                time.sleep(0.001)
        srv.start()
        if after is not None:
            after(srv)
        summary = srv.drain(30)
        results = [f.result(timeout=30) for f in futs]
        rollup = srv.tenant_rollup()
    out = dict(
        reasons=[r.reason for r in results], dispatched=engine.dispatched,
        events=[{k: v for k, v in r.items() if k not in TIMES} if r["event"] != "serve_summary"
                else {"event": "serve_summary"} for r in sink.records],
        counters={k: summary[k] for k in ("requests", "admitted", "completed", "shed",
                                          "dispatches")},
        tenants=_tenant_block(summary), policy=pol,
        rollup=(rollup["counts"], {t: h.count for t, h in rollup["hists"].items()}))
    if registry:
        snap = reg.snapshot()
        out["series"] = {k: v.get("value", v.get("count")) for k, v in snap.items()
                         if k.startswith("tenant")}
        edges = slo.observe(1.0, snap) + slo.observe(2.0, reg.snapshot())
        out["edges"] = [{k: v for k, v in e.items() if k not in TIMES} for e in edges]
    return out


SERVER_SCRIPTS = {
    # tests/test_serve.py::test_tenant_quota_exhaustion_never_blocks_sibling:
    # the batch tenant's overflow fast-fails at its own door, interactive
    # dispatches first, the quota frees on completion.
    "quota_never_blocks_sibling": dict(
        submissions=[(0, "batch"), (1, "batch"), (2, "batch"), (3, "batch"), (4, "batch"),
                     (5, "interactive"), (6, "interactive"), (7, "interactive"),
                     (8, "interactive")],
        policy=dict(quotas={"batch": 2})),
    # ::test_tenant_sigterm_drain_resolves_with_tenant_summaries.
    "sigterm_with_tenant_summaries": dict(
        submissions=[(i, ("interactive", "batch")[i % 2]) for i in range(6)],
        policy=dict(weights={"interactive": 3, "batch": 1}), sigterm=True),
    # ::test_untagged_traffic_coexists_with_policy (untagged rides default).
    "untagged_coexists_with_policy": dict(
        submissions=[(0, None), (1, None), (2, None), (3, "batch"), (4, "batch")],
        policy=dict(quotas={"batch": 1})),
    # ::test_tenant_summary_absent_without_policy.
    "no_policy_no_tags": dict(submissions=[(0, None), (1, None), (2, None)]),
    # Tags without a policy: counted per tenant, never limited, FIFO.
    "tags_without_policy": dict(submissions=[(0, "a"), (1, "b"), (2, "a"), (3, "b")]),
    # WFQ at the server: 3:1 weights over 8 + 8 interleaved requests, and the
    # global queue full behind a quota'd tenant's sheds.
    "wfq_dispatch_order": dict(
        submissions=[(i, ("bob", "alice")[i % 2]) for i in range(16)],
        policy=dict(weights={"alice": 3, "bob": 1}), max_batch=4, registry=True),
}


@pytest.mark.parametrize("name", list(SERVER_SCRIPTS))
def test_the_tenant_script_runs_as_in_jax(name):
    kw = SERVER_SCRIPTS[name]
    got, want = _run("port", **kw), _run("jax", **kw)
    for key in ("reasons", "dispatched", "events", "counters", "tenants", "rollup"):
        assert got[key] == want[key], key
    if "series" in got:
        assert got["series"] == want["series"] and got["edges"] == want["edges"]
    if name == "quota_never_blocks_sibling":
        assert got["reasons"] == ["ok"] * 2 + ["shed_tenant_quota"] * 3 + ["ok"] * 4
        assert got["dispatched"] == [[5, 6], [7, 8], [0, 1]]
        quota = [e for e in got["events"] if e["event"] == "tenant_quota_shed"]
        assert quota == [{"event": "tenant_quota_shed", "tenant": "batch", "quota": 2,
                          "in_system": 2}] * 3
        assert got["tenants"]["batch"]["shed"] == {"shed_tenant_quota": 3}
        assert got["tenants"]["interactive"]["shed"] == {}
        assert got["policy"].try_admit("batch")  # released on completion
    if name == "sigterm_with_tenant_summaries":
        assert got["reasons"] == ["ok"] * 6
        assert (got["tenants"]["interactive"]["completed"], got["tenants"]["batch"]["completed"]
                ) == (3, 3)
    if name == "untagged_coexists_with_policy":
        assert set(got["tenants"]) == {"batch"} and got["counters"]["completed"] == 4
    if name == "no_policy_no_tags":
        assert got["tenants"] is None
        for e in got["events"]:
            assert "tenant" not in e and "tenant" not in e["event"]
    if name == "wfq_dispatch_order":
        mixes = [sum(i % 2 for i in d) for d in got["dispatched"]]
        assert mixes == [3, 3, 2, 0]
        assert got["series"]["tenant_completed_total{tenant=alice}"] == 8
        assert any(e.get("tenant") == "alice" and e["state"] == "fire" for e in got["edges"])


def test_a_quota_shed_rollout_step_ends_its_session_as_in_jax():
    """A tagged session whose tenant is at its quota: its first step is
    shed at the door, the session ends ``shed_tenant_quota`` with a
    ``tenant_quota_shed`` event naming it."""

    def script(pkg):
        mod = PACKAGES[pkg]
        sink = ListSink()
        srv = mod["server"](StubEngine(), max_batch=2, max_wait_ms=10_000, sink=sink,
                            tenants=mod["policies"].TenantPolicy(quotas={"bulk": 1}))
        held = srv.submit(_sample(0), tenant="bulk")
        fut = srv.submit_rollout(_sample(1), 3, tenant="bulk")
        res = fut.result(timeout=5)
        srv.start()
        summary = srv.drain(30)
        return ((res.ok, res.reason, res.steps_completed, held.result(timeout=5).reason),
                [{k: v for k, v in r.items() if k not in TIMES} for r in sink.records
                 if r["event"] != "serve_summary"], summary["sessions"]["shed"],
                _tenant_block(summary))

    got = script("port")
    assert got == script("jax")
    assert got[0] == (False, "shed_tenant_quota", 0, "ok")
    assert {"event": "tenant_quota_shed", "tenant": "bulk", "quota": 1, "in_system": 1,
            "session": "s0001"} in got[1]


# -- the command line ---------------------------------------------------------------

FLAGS = ["tenant_weights", "tenant_quotas", "tenant_priorities"]


def test_the_three_tenant_flags_take_jax_s_defaults_help_and_refusals():
    jp, pp = jax_main.build_parser(), port_main.build_parser()
    assert {f: getattr(pp.parse_args([]), f) for f in FLAGS} == {
        f: getattr(jp.parse_args([]), f) for f in FLAGS}
    helps = lambda p: {a.dest: a.help for a in p._actions if a.dest in FLAGS}  # noqa: E731
    assert helps(pp) == helps(jp) and len(helps(pp)) == 3
    argv = ["--tenant_weights", "interactive:3,batch:1", "--tenant_quotas", "batch:4",
            "--tenant_priorities", "batch:batch"]
    _, port = port_main.configs_from_args(pp.parse_args(argv))
    jax_sc = jax_main.config_from_args(jp.parse_args(argv)).serve
    assert {f: getattr(port, f) for f in FLAGS} == {f: getattr(jax_sc, f) for f in FLAGS}
    bad = ["--tenant_quotas", "batch:0"]
    with pytest.raises(ValueError) as want:
        jax_main.config_from_args(jp.parse_args(bad))
    with pytest.raises(ValueError) as got:
        port_main.configs_from_args(pp.parse_args(bad))
    assert str(got.value) == str(want.value)


def test_main_serves_under_a_tenant_policy_on_the_cpu(tmp_path, capsys):
    """``main --serve`` with the three tenant flags and the metrics plane:
    the storm's untagged requests ride the default tenant, all served."""
    argv = ["--serve", "--device", "cpu", "--synthetic", "darcy2d", "--n_test", "4",
            "--n_attn_layers", "1", "--n_attn_hidden_dim", "16", "--n_mlp_num_layers", "1",
            "--n_mlp_hidden_dim", "16", "--n_input_hidden_dim", "16", "--n_expert", "2",
            "--n_head", "2", "--tenant_weights", "interactive:3,batch:1", "--tenant_quotas",
            "batch:4", "--tenant_priorities", "batch:batch", "--metrics_interval_s", "0.05",
            "--slo_p99_ms", "1", "--metrics_path", str(tmp_path / "m.jsonl")]
    assert port_main.main(argv) == 1.0
    [line] = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("Serve:")]
    assert line.startswith("Serve: 4/4 ok, shed={}") and "sessions=" not in line
