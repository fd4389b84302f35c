"""The port's operator tools (``gnot_tpu_torch/tools/``) against the repo's
``tools/`` scripts they port, each JAX tool loaded by its path.

* Readers: ``trace_report`` and ``metrics_report`` return JAX's dicts,
  exit codes and text exactly, on the committed serve and federated
  example traces and on tiny port serving runs (a two-replica run with the
  metrics plane and an SLO that fires, a two-host federated run, and the
  smoke's tenant storm with the metrics plane).
* Capacity fold: ``capacity_report``'s pure parts equal JAX's on
  ``tests/test_capacity.py``'s synthetic model and on a port ``--capacity``
  storm; its ``main`` writes JAX's record shapes.
* Smoke: ``serve_smoke.run`` at the argv of JAX's smoke tests
  (``tests/test_serve.py``, ``tests/test_tracing.py``,
  ``tests/test_capacity.py``), plus ``--hosts 2`` and the metrics plane,
  gives ``failures == []`` and the summary key set of JAX's smoke at the
  same argv; ``--prewarm`` raises ``NotPortedError`` by name.
* Lock map: JAX's record shapes over the port's tree, no cycle.
* No JAX: each module runs as ``python -m`` in a process where importing
  ``jax``, ``jaxlib``, ``flax`` or ``gnot_tpu`` raises, and tries none
  (``chip_smoke.NO_JAX``, the runner phase 22 reads the card's files with).

Each JAX smoke runs once, in a module-scoped fixture per mode; the port
runs at ``--device cpu``."""

import importlib.util
import json
import os
import subprocess
import sys

import pytest
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

from chip_smoke import NO_JAX

from gnot_tpu_torch import main as port_main
from gnot_tpu_torch.config import NotPortedError
from gnot_tpu_torch.tools import (
    capacity_report,
    lockmap_report,
    metrics_report,
    serve_smoke,
    trace_report,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARTIFACTS = os.path.join(REPO, "docs", "artifacts")
TINY_SERVE = [
    "--serve", "--device", "cpu", "--synthetic", "darcy2d", "--synth_size", "8",
    "--n_train", "4", "--n_test", "8", "--serve_max_batch", "4",
    "--n_attn_layers", "1", "--n_attn_hidden_dim", "16", "--n_mlp_num_layers", "1",
    "--n_mlp_hidden_dim", "16", "--n_input_hidden_dim", "16", "--n_expert", "2",
    "--n_head", "2", "--serve_replicas", "2",
]
#: The argv of each JAX smoke test (the metrics path is appended), and two
#: modes no JAX test drives: the federation and the metrics plane.
SMOKE_MODES = {
    "default": ["--n", "10"],  # tests/test_serve.py::test_serve_smoke_tool
    "replicas": ["--n", "10", "--replicas", "2", "--inject_fault", "none"],
    "rollout": ["--n", "6", "--rollout", "3", "--replicas", "2"],
    "tenants": ["--tenants", "--n", "24"],
    "trace": ["--n", "8"],  # tests/test_tracing.py; --trace_path appended
    "capacity": ["--n", "6", "--mesh_lo", "80", "--mesh_hi", "200", "--inject_fault",
                 "none", "--deadline_ms", "10000", "--capacity"],
    "hosts": ["--n", "8", "--hosts", "2", "--replicas", "2", "--inject_fault", "none"],
    "metrics": ["--n", "8", "--metrics_interval_s", "0.05"],
}

_JAX_TOOLS: dict = {}


def jax_tool(name: str):
    """The repo's ``tools/<name>.py``, loaded by its path once."""
    if name not in _JAX_TOOLS:
        spec = importlib.util.spec_from_file_location(
            f"gnot_tool_{name}", os.path.join(REPO, "tools", f"{name}.py"))
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        _JAX_TOOLS[name] = module
    return _JAX_TOOLS[name]


def read_jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


@pytest.fixture(scope="module")
def port_runs(tmp_path_factory):
    """The port's serving runs the readers read: ``pool`` (two replicas,
    the metrics plane and a p99 objective no run meets), ``federated``
    (two loopback hosts of one replica each, the merged trace) and
    ``tenants`` (the smoke's two-tenant storm with the metrics plane)."""
    out = {}
    for name, flags in (
        ("pool", ["--metrics_interval_s", "0.01", "--slo_p99_ms", "1",
                  "--slo_fast_window_s", "0.1", "--slo_slow_window_s", "0.2"]),
        ("federated", ["--hosts", "2", "--metrics_interval_s", "0.05"]),
    ):
        d = tmp_path_factory.mktemp(name)
        run = port_main.run(TINY_SERVE + flags + [
            "--trace_path", str(d / "t.json"), "--metrics_path", str(d / "m.jsonl")])
        assert run.summary["completed"] == 8
        out[name] = d
    d = tmp_path_factory.mktemp("tenants")
    summary = serve_smoke.run(["--tenants", "--n", "24", "--device", "cpu",
                               "--metrics_interval_s", "0.05",
                               "--metrics_path", str(d / "m.jsonl")])
    assert summary["failures"] == []
    out["tenants"] = d
    return out


def _trace_paths(port_runs):
    return {
        "serve_example": os.path.join(ARTIFACTS, "serve_trace_example.json"),
        "federated_example": os.path.join(ARTIFACTS, "federated_trace_example.json"),
        "port_pool": str(port_runs["pool"] / "t.json"),
        "port_federated": str(port_runs["federated"] / "t.json"),
    }


@pytest.mark.parametrize(
    "which", ["serve_example", "federated_example", "port_pool", "port_federated"])
def test_trace_report_equals_jax_s(which, port_runs, capsys):
    """``report`` and every view of it equal JAX's dict for dict, and
    ``main`` prints the same text and the same ``--json`` document."""
    path = _trace_paths(port_runs)[which]
    jax_tr = jax_tool("trace_report")
    got, want = trace_report.report(path), jax_tr.report(path)
    assert got == want
    spans = trace_report.load_spans(path)
    assert spans == jax_tr.load_spans(path)
    for fn in ("kind_stats", "bucket_breakdown", "replica_breakdown", "tenant_breakdown",
               "host_breakdown", "critical_path"):
        assert getattr(trace_report, fn)(spans) == getattr(jax_tr, fn)(spans), fn
    capsys.readouterr()
    for argv in ([path], [path, "--json"]):
        assert trace_report.main(argv) == jax_tr.main(argv) == 0
        out = capsys.readouterr().out
        half = len(out) // 2
        assert out[:half] == out[half:], argv
    if which.startswith("port"):
        assert got["critical_path"]["kind"] == "request"
        assert got["replicas"] if which == "port_pool" else got["hosts"]


def test_trace_report_refuses_a_missing_file(tmp_path, capsys):
    missing = str(tmp_path / "none.json")
    assert trace_report.main([missing]) == jax_tool("trace_report").main([missing]) == 2


@pytest.mark.parametrize("which", ["pool", "federated", "tenants"])
def test_metrics_report_equals_jax_s(which, port_runs, capsys):
    """Every function of ``metrics_report`` returns JAX's value on the
    port run's series and events, and ``run`` exits and prints alike."""
    d = port_runs[which]
    series, metrics = str(d / "m.series.jsonl"), str(d / "m.jsonl")
    jax_mr = jax_tool("metrics_report")
    rows, events = metrics_report.load_rows(series), metrics_report.load_rows(metrics)
    assert rows == jax_mr.load_rows(series)
    for fn, arg in (("series_history", rows), ("pool_size_series", rows),
                    ("host_breakdown", rows), ("breach_intervals", events),
                    ("tenant_breakdown", events), ("cluster_crosscheck", events)):
        assert getattr(metrics_report, fn)(arg) == getattr(jax_mr, fn)(arg), fn
    pool = metrics_report.pool_size_series(rows)
    assert metrics_report.replica_seconds(pool) == jax_mr.replica_seconds(pool)
    capsys.readouterr()
    argv = [series, "--metrics", metrics]
    assert metrics_report.run(argv) == jax_mr.run(argv) == 0
    out = capsys.readouterr().out
    half = len(out) // 2
    assert out[:half] == out[half:]
    # What each run is there to exercise.
    if which == "pool":
        assert pool and {p["replicas"] for p in pool} == {2}
        assert metrics_report.breach_intervals(events)[0]
        assert "final snapshot agrees with serve_summary" in out
    elif which == "federated":
        assert set(metrics_report.host_breakdown(rows)) == {"host0", "host1"}
        assert metrics_report.cluster_crosscheck(events)[1] == []
        assert "cluster_summary agrees" in out
    else:
        assert metrics_report.tenant_breakdown(events)["batch"]["quota_shed_events"] >= 1


def test_breach_intervals_flag_a_broken_edge_stream_as_jax_does():
    """A second fire without a clear, a clear without a fire and an unknown
    state: the same intervals and problems as JAX's."""
    def alert(state, objective="latency_p99", ts=0.0):
        return {"event": "slo_alert", "objective": objective, "state": state,
                "kind": "latency_p99", "burn_fast": 2.0, "ts": ts}

    events = [alert("fire", ts=1.0), alert("fire", ts=2.0), alert("clear", ts=3.0),
              alert("clear", "shed_fraction", 4.0), alert("flap", ts=5.0),
              alert("fire", "shed_fraction", 6.0)]
    got = metrics_report.breach_intervals(events)
    assert got == jax_tool("metrics_report").breach_intervals(events)
    assert len(got[1]) == 3 and got[0][-1]["cleared_ts"] is None


def _synthetic_capacity_model():
    """``tests/test_capacity.py::test_capacity_report_recommendation_and_agreement``'s
    model and summary."""
    def prog(dispatches, requests, real, cap):
        return {
            "source": "compile", "costs": {},
            "dispatches": dispatches, "requests": requests,
            "real_tokens": real, "capacity_tokens": cap,
            "device_s": 0.01, "per_replica": {},
            "useful_token_frac": real / cap,
            "tokens_per_device_s": real / 0.01,
            "requests_per_device_s": requests / 0.01,
            "device_us_per_token": 1e4 / real, "flops_per_s": None,
        }

    model = {
        "programs": {
            "bucket:64x64@4@f32": prog(5, 17, 1080, 1280),
            "bucket:192x64@4@f32": prog(2, 5, 810, 1536),
        },
        "pool": {
            "replicas": 1, "programs": 2, "dispatches": 7,
            "requests": 22, "real_tokens": 1890,
            "capacity_tokens": 2816, "device_s": 0.02,
            "sustainable_requests_per_s": 1100.0,
            "sustainable_tokens_per_s": 94500.0,
            "useful_token_frac": 1890 / 2816, "per_replica": {},
        },
    }
    summary = {
        "dispatches": 7,
        "pad_waste_by_bucket": {
            "64x64": {"dispatches": 5, "real_tokens": 1080, "capacity_tokens": 1280},
            "192x64": {"dispatches": 2, "real_tokens": 810, "capacity_tokens": 1536},
        },
    }
    return model, summary


def _assert_capacity_parts_equal(model, summary, baseline):
    jax_cr = jax_tool("capacity_report")
    assert capacity_report.program_rows(model) == jax_cr.program_rows(model)
    assert capacity_report.agreement(summary, model) == jax_cr.agreement(summary, model)
    assert capacity_report.capacity_row(summary, model) == jax_cr.capacity_row(summary, model)
    for chunk in (32, 64):
        assert (capacity_report.reconstruct_sizes(model, chunk)
                == jax_cr.reconstruct_sizes(model, chunk))
        got = capacity_report.pack_recommendation(model, chunk, 4, baseline)
        assert got == jax_cr.pack_recommendation(model, chunk, 4, baseline)
    return got


def test_capacity_pure_parts_equal_jax_s_on_the_synthetic_model():
    model, summary = _synthetic_capacity_model()
    baseline_path = os.path.join(ARTIFACTS, "pack_ab.jsonl")
    baseline = capacity_report.load_baseline(baseline_path)
    assert baseline == jax_tool("capacity_report").load_baseline(baseline_path) is not None
    rec = _assert_capacity_parts_equal(model, summary, baseline)
    assert rec["real_tokens"] == 1890 and rec["projected_pad_waste"] < rec["observed_pad_waste"]
    assert capacity_report.agreement(summary, model)["problems"] == []
    summary["dispatches"] = 8  # drift is flagged, not smoothed
    assert capacity_report.agreement(summary, model)["problems"]
    _assert_capacity_parts_equal(model, summary, None)


@pytest.fixture(scope="module")
def port_capacity_storm(tmp_path_factory):
    d = tmp_path_factory.mktemp("capacity")
    summary = serve_smoke.run(SMOKE_MODES["capacity"] + [
        "--mesh_lo", "40", "--device", "cpu", "--metrics_path", str(d / "m.jsonl")])
    assert summary["failures"] == []
    return summary, read_jsonl(d / "m.jsonl")


def test_capacity_pure_parts_equal_jax_s_on_a_port_storm(port_capacity_storm):
    """The fold of a port ``--capacity`` storm, from the returned summary
    and from the ``serve_summary`` event (no wall time there), equals
    JAX's fold of the same model, and the two views agree."""
    summary, events = port_capacity_storm
    model = summary["capacity_model"]
    assert model["pool"]["dispatches"] > 0
    rec = _assert_capacity_parts_equal(model, summary, 0.5)
    assert rec["plan"] is not None
    [event] = [e for e in events if e.get("event") == "serve_summary"]
    _assert_capacity_parts_equal(event["capacity_model"], event, None)
    assert capacity_report.agreement(event, event["capacity_model"])["problems"] == []
    assert capacity_report.capacity_row(event, event["capacity_model"])["offered_requests_per_s"] is None


def test_capacity_report_main_writes_jax_s_record_shapes(tmp_path, capsys):
    """``main`` on the CPU: exit 0, and each record kind with the keys of
    the committed ``docs/artifacts/capacity_snapshot.jsonl``."""
    out = tmp_path / "cap.jsonl"
    assert capacity_report.main(["--device", "cpu", "--n", "12", "--out", str(out)]) == 0
    capsys.readouterr()

    def shapes(recs):
        return {r.get("record", r.get("summary")): set(r) for r in recs}

    got, want = shapes(read_jsonl(out)), shapes(read_jsonl(
        os.path.join(ARTIFACTS, "capacity_snapshot.jsonl")))
    assert got == want
    summary = read_jsonl(out)[-1]
    assert summary["platform"] == "cpu" and summary["agreement_problems"] == []


@pytest.fixture(scope="module", params=list(SMOKE_MODES))
def smoke_pair(request, tmp_path_factory):
    """One mode's summaries: JAX's smoke and the port's at the same argv."""
    mode = request.param
    out = {}
    for pkg in ("jax", "port"):
        d = tmp_path_factory.mktemp(f"smoke_{mode}_{pkg}")
        argv = SMOKE_MODES[mode] + ["--metrics_path", str(d / "serve.jsonl")]
        if mode == "trace":
            argv += ["--trace_path", str(d / "smoke_trace.json")]
        if pkg == "jax":
            out[pkg] = jax_tool("serve_smoke").run(argv)
        else:
            out[pkg] = serve_smoke.run(argv + ["--device", "cpu"])
    return mode, out["jax"], out["port"]


def test_serve_smoke_passes_with_jax_s_summary_keys(smoke_pair, capsys):
    mode, jax_summary, summary = smoke_pair
    capsys.readouterr()
    assert jax_summary["failures"] == []
    assert summary["failures"] == []
    assert set(summary) == set(jax_summary)
    # The assertions of JAX's test of the mode.
    if mode == "default":
        assert summary["shed"].get("shed_deadline", 0) >= 1
    elif mode == "replicas":
        assert summary["routing"]["replicas"] == 2
    elif mode == "rollout":
        assert summary["sessions"]["completed"] == 6 and summary["sessions"]["lost"] == 0
    elif mode == "tenants":
        assert summary["tenants"]["batch"]["shed"]["shed_tenant_quota"] >= 1
    elif mode == "trace":
        assert summary["queue_device_by_bucket"]
    elif mode == "capacity":
        assert summary["capacity_model"]["pool"]["dispatches"] > 0
    elif mode == "hosts":
        assert summary["hosts"] == 2 and summary["lost"] == 0


def test_serve_smoke_refuses_prewarm_by_name():
    with pytest.raises(NotPortedError, match="--prewarm"):
        serve_smoke.run(["--prewarm", "--device", "cpu"])
    assert serve_smoke.main(["--n", "4", "--inject_fault", "none", "--device", "cpu"]) == 0


def test_serve_smoke_mixed_traffic_is_jax_s():
    """The storm's samples, bitwise the JAX tool's."""
    got = serve_smoke.mixed_traffic(9, seed=1, mesh_lo=40, mesh_hi=200)
    want = jax_tool("serve_smoke").mixed_traffic(9, seed=1, mesh_lo=40, mesh_hi=200)
    assert len(got) == len(want) == 9
    for a, b in zip(got, want):
        for f in ("coords", "y", "theta"):
            assert (getattr(a, f) == getattr(b, f)).all() and getattr(a, f).dtype == getattr(b, f).dtype
        assert len(a.funcs) == len(b.funcs) and all((x == y).all() for x, y in zip(a.funcs, b.funcs))


def test_lockmap_has_jax_s_record_shapes_and_no_cycle(tmp_path):
    assert lockmap_report.main(["--out", str(tmp_path / "lockmap.jsonl")]) == 0
    got = read_jsonl(tmp_path / "lockmap.jsonl")
    want = read_jsonl(os.path.join(ARTIFACTS, "lockmap.jsonl"))

    def shapes(recs):
        return {r["record"]: set(r) for r in recs}

    assert shapes(got) == shapes(want)
    summary = got[-1]
    assert summary["record"] == "summary" and summary["cycles"] == []
    assert summary["locks"] == sum(summary["census"].values()) > 0
    assert {r["file"] for r in got if r["record"] == "node"} <= {
        os.path.relpath(os.path.join(dp, f), REPO)
        for dp, _, fs in os.walk(os.path.join(REPO, "gnot_tpu_torch")) for f in fs}


@pytest.mark.parametrize("tool", ["trace_report", "metrics_report", "serve_smoke",
                                  "capacity_report", "lockmap_report"])
def test_each_tool_runs_without_jax(tool, port_runs, tmp_path):
    d = port_runs["pool"]
    args = {
        "trace_report": [str(d / "t.json")],
        "metrics_report": [str(d / "m.series.jsonl"), "--metrics", str(d / "m.jsonl")],
        "serve_smoke": ["--device", "cpu", "--metrics_path", str(tmp_path / "m.jsonl")],
        "capacity_report": ["--device", "cpu", "--n", "12", "--out", str(tmp_path / "c.jsonl")],
        "lockmap_report": [],
    }[tool]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    proc = subprocess.run(
        [sys.executable, "-c", NO_JAX, f"gnot_tpu_torch.tools.{tool}", *args],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    # The runner's last line names the JAX imports it refused and any loaded.
    assert "no-jax: refused [] loaded [] in " in proc.stderr, proc.stderr[-2000:]
    assert proc.stdout.strip()
