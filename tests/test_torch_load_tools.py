"""The port's open-loop serving load tools (``gnot_tpu_torch/tools/``:
``loadgen``, ``serve_bench``, ``lowprec_ab``, ``tenant_ab``,
``autoscale_ab``) against the repo's ``tools/`` scripts they port.

* ``loadgen``: bitwise ``tools/loadgen.py`` (numpy only, imported
  directly) for several seeds, rates, shapes and tenant streams, its
  replay schedule on a fake clock, and the trace digest ``chip_smoke.py``
  holds the card host's numpy to.
* Flags: each tool's ``add_argument`` calls, read with ``ast`` from both
  files, name for name, type, default, action and required; the port adds
  ``--device`` only.
* Records: each tool runs once at ``--quick --device cpu`` (``serve_bench``
  further cut to ``tests/test_serve.py``'s argv) in a process where
  importing ``jax``, ``jaxlib``, ``flax`` or ``gnot_tpu`` raises
  (``chip_smoke.NO_JAX``), the four side by side: its record kinds and each
  record's key set are those of JAX's committed ``docs/artifacts/*.jsonl``,
  and its summary is JAX's arithmetic over its records. Each runs through
  ``run()``, as JAX's own tests run ``serve_bench`` and ``lowprec_ab``, with
  ``chip_smoke.LOAD_RUN``, which writes the returned ``failures`` beside
  ``--out``: the correctness bars of ``tenant_ab`` and ``autoscale_ab``
  hold at ``--quick``, and no entry of ``failures`` names another bar than
  the capacity bar (a p99 under an SLO set from one idle dispatch, saved
  replica-seconds) that the records show missed. Those depend on the
  host's load, as the tools' sustained rates and the packer's gain do, so
  no test asserts them.
* Exit rules: each ``main`` against JAX's on the same summaries.
"""

import ast
import importlib.util
import json
import os
import subprocess
import sys

import pytest
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

from chip_smoke import LOAD_RUN, LOADGEN_DIGEST, NO_JAX, loadgen_digest
from gnot_tpu_torch.tools import autoscale_ab, loadgen, lowprec_ab, serve_bench, tenant_ab

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARTIFACTS = os.path.join(REPO, "docs", "artifacts")
#: Each tool's committed JAX artifact and its argv (``--device cpu`` and
#: ``--out`` are appended): ``--quick``, serve_bench cut as
#: tests/test_serve.py::test_serve_bench_quick_smoke cuts it.
TOOLS = {
    "serve_bench": ("serve_bench.jsonl",
                    ["--quick", "--replicas", "2", "--n_traffic", "8", "--duration_s", "1.0",
                     "--hidden", "16", "--layers", "1", "--mesh_lo", "100", "--mesh_hi", "200"]),
    "lowprec_ab": ("lowprec_ab.jsonl", ["--quick"]),
    "tenant_ab": ("tenant_ab.jsonl", ["--quick"]),
    "autoscale_ab": ("autoscale_ab.jsonl", ["--quick"]),
}
MODULES = {"serve_bench": serve_bench, "lowprec_ab": lowprec_ab, "tenant_ab": tenant_ab,
           "autoscale_ab": autoscale_ab}


def read_jsonl(path) -> list[dict]:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def record_kind(rec: dict) -> str:
    for key in ("arm", "probe", "summary"):
        if key in rec:
            return f"{key}:{rec[key]}"
    raise AssertionError(f"record of no kind: {rec}")


def flags(path: str) -> dict[str, dict]:
    """Every ``add_argument`` call in the file: flag -> its type, default,
    action and required, as source text."""
    tree = ast.parse(open(path).read())
    out = {}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "add_argument"):
            kw = {k.arg: ast.unparse(k.value) for k in node.keywords
                  if k.arg in ("type", "default", "action", "required")}
            out[node.args[0].value] = kw
    return out


def jax_tool(name: str):
    """A module of the repo's ``tools/``, loaded from its file; its
    ``sys.path`` inserts are undone."""
    saved = list(sys.path)
    try:
        sys.path.insert(0, os.path.join(REPO, "tools"))
        spec = importlib.util.spec_from_file_location(
            f"gnot_load_tool_{name}", os.path.join(REPO, "tools", f"{name}.py"))
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
    finally:
        sys.path[:] = saved
    return module


def status_keys() -> set[str]:
    """The keys of the JAX package's ``native.status()`` dict, read from
    its source (its committed ``lowprec_ab`` artifact predates two)."""
    tree = ast.parse(open(os.path.join(REPO, "gnot_tpu", "native", "__init__.py")).read())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "status")
    ret = next(n for n in ast.walk(fn) if isinstance(n, ast.Return))
    return {k.value for k in ret.value.keys}


@pytest.fixture(scope="module")
def jax_loadgen():
    return jax_tool("loadgen")


@pytest.fixture(scope="module")
def port_runs(tmp_path_factory):
    """The four tools at their argv with ``--device cpu``, side by side,
    each through ``run()`` in a process without JAX, and loadgen's digest in
    one more: ``{tool: (returncode, stdout, stderr, records, failures)}``."""
    tmp = tmp_path_factory.mktemp("load_tools")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    procs = {}
    for tool, (_, argv) in TOOLS.items():
        out = tmp / f"{tool}.jsonl"
        procs[tool] = (subprocess.Popen(
            [sys.executable, "-c", NO_JAX, "-c", LOAD_RUN.format(name=tool), *argv,
             "--device", "cpu", "--out", str(out)],
            cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True), out)
    procs["loadgen"] = (subprocess.Popen(
        [sys.executable, "-c", NO_JAX, "-c",
         "from chip_smoke import loadgen_digest\nfrom gnot_tpu_torch.tools import loadgen\n"
         "print(loadgen_digest(loadgen))\n"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True), None)
    runs = {}
    try:
        for tool, (proc, out) in procs.items():
            stdout, stderr = proc.communicate(timeout=300)
            recs = read_jsonl(out) if out is not None and out.exists() else []
            fail = out and out.with_name(out.name + ".failures.json")
            runs[tool] = (proc.returncode, stdout, stderr, recs,
                          json.loads(fail.read_text()) if fail and fail.exists() else None)
    finally:
        for proc, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return runs


# -- loadgen -------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_loadgen_traces_are_bitwise_jax_s(seed, jax_loadgen):
    shapes = [{}, {"peak_mult": 2.5, "bursts": 3, "burst_mult": 4.0, "burst_frac": 0.1},
              {"peak_mult": 1.0, "bursts": 0, "burst_mult": 1.0, "burst_frac": 0.5}]
    assert loadgen.PATTERNS == jax_loadgen.PATTERNS
    n = 0
    for pattern in loadgen.PATTERNS:
        for base_rps, duration_s in ((5.0, 10.0), (80.0, 3.0), (333.3, 1.7)):
            for shape in shapes:
                kw = dict(base_rps=base_rps, duration_s=duration_s, seed=seed, **shape)
                got = loadgen.trace_times(pattern, **kw)
                want = jax_loadgen.trace_times(pattern, **kw)
                assert got == want and all(type(t) is float for t in got)
                assert loadgen.ramp_split(got, duration_s) == jax_loadgen.ramp_split(
                    want, duration_s)
                rate, peak = loadgen.rate_fn(pattern, base_rps=base_rps,
                                             duration_s=duration_s, **shape)
                jrate, jpeak = jax_loadgen.rate_fn(pattern, base_rps=base_rps,
                                                   duration_s=duration_s, **shape)
                assert peak == jpeak
                assert all(rate(t) == jrate(t) for t in got[:50])
                n += len(got)
    assert n > 1000


def test_loadgen_multi_stream_and_ramp_are_bitwise_jax_s(jax_loadgen):
    streams = {
        "interactive": {"pattern": "steady", "base_rps": 40.0},
        "batch": {"pattern": "bursty", "base_rps": 120.0, "burst_mult": 3.0},
        "nightly": {"pattern": "diurnal", "base_rps": 10.0, "peak_mult": 4.0, "seed": 99},
    }
    for seed in (0, 3):
        got = loadgen.multi_stream_times(streams, duration_s=6.0, seed=seed)
        want = jax_loadgen.multi_stream_times(streams, duration_s=6.0, seed=seed)
        assert got == want and {t for _, t in got} == set(streams)
    assert loadgen.ramp_split([], 4.0) == jax_loadgen.ramp_split([], 4.0) == 0
    assert loadgen.ramp_split([1.0, 2.0], 4.0) == jax_loadgen.ramp_split([1.0, 2.0], 4.0) == 2
    for bad in ({"base_rps": 0.0, "duration_s": 1.0}, {"base_rps": 1.0, "duration_s": 1.0,
                                                        "peak_mult": 0.5},
                {"base_rps": 1.0, "duration_s": 1.0, "burst_frac": 1.0}):
        with pytest.raises(ValueError) as port_err:
            loadgen.rate_fn("steady", **bad)
        with pytest.raises(ValueError) as jax_err:
            jax_loadgen.rate_fn("steady", **bad)
        assert str(port_err.value) == str(jax_err.value)
    with pytest.raises(ValueError, match="unknown pattern"):
        loadgen.trace_times("weekly", base_rps=1.0, duration_s=1.0)
    with pytest.raises(ValueError, match="at least one stream"):
        loadgen.multi_stream_times({}, duration_s=1.0)


def test_loadgen_replay_is_open_loop_like_jax_s(jax_loadgen):
    """On a fake clock that advances only by sleeps (and by 0.5 s inside
    submit 2), both replays sleep the same lags and submit late arrivals at
    once."""
    def drive(module):
        now, log = [0.0], []

        def submit(i):
            log.append(("submit", i, now[0]))
            if i == 2:
                now[0] += 0.5  # a slow submit: the next arrivals are late
            return i * 10

        def sleep(s):
            log.append(("sleep", round(s, 12)))
            now[0] += s

        out = module.replay(submit, [0.1, 0.2, 0.3, 0.4, 1.5], clock=lambda: now[0],
                            sleep=sleep)
        return out, log

    got, want = drive(loadgen), drive(jax_loadgen)
    assert got == want
    assert got[0] == [0, 10, 20, 30, 40]
    assert [e for e in got[1] if e[0] == "submit"][3][2] == pytest.approx(0.8)


def test_loadgen_digest_is_chip_smoke_s_constant(jax_loadgen, port_runs):
    assert loadgen_digest(loadgen) == loadgen_digest(jax_loadgen) == LOADGEN_DIGEST
    rc, stdout, stderr, *_ = port_runs["loadgen"]
    assert rc == 0 and stdout.strip() == LOADGEN_DIGEST, stderr[-2000:]


# -- the tools: flags, runs without JAX, records -------------------------------


@pytest.mark.parametrize("tool", list(TOOLS))
def test_flags_are_jax_s_plus_device(tool):
    port = flags(os.path.join(REPO, "gnot_tpu_torch", "tools", f"{tool}.py"))
    jax_flags = flags(os.path.join(REPO, "tools", f"{tool}.py"))
    assert port.pop("--device") == {"type": "str", "default": "'cuda'"}
    assert port == jax_flags


@pytest.mark.parametrize("tool", [*TOOLS, "loadgen"])
def test_each_load_tool_runs_without_jax(tool, port_runs):
    rc, stdout, stderr, *_ = port_runs[tool]
    assert rc == 0, stdout[-2000:] + stderr[-4000:]
    # The runner's last line names the JAX imports it refused and any loaded.
    assert "no-jax: refused [] loaded [] in " in stderr, stderr[-2000:]


@pytest.mark.parametrize("tool", list(TOOLS))
def test_records_have_jax_s_kinds_and_key_sets(tool, port_runs):
    """Each record's key set is that of JAX's committed record of its kind
    (the ``native_packer`` probe's: JAX's ``status()`` keys today). At
    ``--quick`` the ladders, datasets and replica counts are shorter, so the
    kinds compare as sets, serve_bench's N-replica arm by its pattern."""
    recs = port_runs[tool][3]
    want = {}
    for r in read_jsonl(os.path.join(ARTIFACTS, TOOLS[tool][0])):
        want.setdefault(record_kind(r), set(r))
    if tool == "lowprec_ab":
        want["probe:native_packer"] = {"probe"} | status_keys()
    got = {}
    for r in recs:
        kind = record_kind(r)
        if tool == "serve_bench" and kind.startswith("arm:replicas_") and kind != "arm:replicas_1":
            assert kind == "arm:replicas_2"
            kind = "arm:replicas_4"
        got.setdefault(kind, set())
        assert set(r) == want[kind], kind
        got[kind] = set(r)
    assert set(got) == set(want)
    assert [record_kind(r) for r in recs][-1] == f"summary:{tool}"


# -- the summaries: JAX's arithmetic and bars ------------------------------------


def sustained(runs: list[dict], slo: float, max_shed: float) -> dict | None:
    ok = [r for r in runs if r["shed_frac"] <= max_shed and r["p99_ms"] is not None
          and r["p99_ms"] <= slo]
    return max(ok, key=lambda r: r["achieved_rps"], default=None)


def test_serve_bench_quick_is_jax_s_arithmetic(port_runs):
    recs = port_runs["serve_bench"][3]
    *runs, s = recs
    assert (s["quick"], s["replicas_n"], s["bar_speedup"], s["bar_numeric"]) == (True, 2, 2.5, 1e-5)
    assert s["slo_p99_ms"] == round(12 * s["dispatch_ms"], 1) or abs(
        s["slo_p99_ms"] - 12 * s["dispatch_ms"]) < 0.06
    cap1 = 4 / (s["dispatch_ms"] / 1e3)
    loads = [0.6, 2.4]
    assert [(r["arm"], r["load_mult"]) for r in runs] == [
        (f"replicas_{n}", m) for m in loads for n in (1, 2)]
    for r in runs:
        li = loads.index(r["load_mult"])
        assert r["offered_rps"] == pytest.approx(r["load_mult"] * cap1, rel=1e-3)
        times = loadgen.trace_times("steady", base_rps=r["offered_rps"], duration_s=1.0, seed=li)
        assert r["submitted"] == len(times)
        assert r["completed"] + sum(r["shed"].values()) == r["submitted"]
        assert r["warm_cache_hits"] is None and r["warm_cache_misses"] is None
        assert r["duration_s"] == 1.0 and r["dispatches"] >= 1
    for n in (1, 2):
        best = sustained([r for r in runs if r["replicas"] == n], s["slo_p99_ms"],
                         s["max_shed_frac"])
        assert s[f"sustained_rps_{n if n == 1 else 'n'}"] == (best and best["achieved_rps"])
    if s["sustained_rps_1"] and s["sustained_rps_n"]:
        assert s["speedup"] == round(s["sustained_rps_n"] / s["sustained_rps_1"], 3)
    else:
        assert s["speedup"] is None
    assert s["max_abs_diff"] <= s["bar_numeric"]


def test_lowprec_ab_quick_is_jax_s_arithmetic(port_runs):
    recs = port_runs["lowprec_ab"][3]
    by = {}
    for r in recs:
        by.setdefault(record_kind(r), []).append(r)
    [s] = by["summary:lowprec_ab"]
    [parity] = by["probe:parity"]
    assert (s["quick"], s["replicas"], s["parity_datasets"]) == (True, 2, ["darcy64"])
    assert (parity["dataset"], parity["epochs"], parity["n_test"]) == ("darcy64", 2, 6)
    assert parity["delta"] == round(parity["rel_l2_bf16"] - parity["rel_l2_f32"], 6) or abs(
        parity["delta"] - (parity["rel_l2_bf16"] - parity["rel_l2_f32"])) < 2e-6
    assert s["parity_max_delta"] == abs(parity["delta"]) <= s["parity_bar"] == 0.01
    assert by["probe:native_packer"][0]["impl"] == s["native_packer"]
    [python], [native] = by["arm:host_python"], by["arm:host_native"]
    assert python["requests"] == native["requests"] == 16
    before = python["batch_assembly_trimmed_ms"] + python["unpad_trimmed_ms"]
    after = native["batch_assembly_trimmed_ms"] + native["unpad_trimmed_ms"]
    assert s["host_phase_trimmed_ms_python"] == round(before, 4)
    assert s["host_phase_trimmed_ms_native"] == round(after, 4)
    assert s["host_reduction_frac"] == round(1.0 - after / before, 4)
    f32, bf16 = by["arm:serve_f32"], by["arm:serve_bf16"]
    assert [r["load_mult"] for r in f32] == [r["load_mult"] for r in bf16] == [0.3, 0.5]
    assert {r["dtype"] for r in f32} == {"float32"} and {r["dtype"] for r in bf16} == {"bfloat16"}
    for a, b in zip(f32, bf16):  # one trace a rung, both arms
        assert (a["offered_rps"], a["submitted"]) == (b["offered_rps"], b["submitted"])
    b32 = sustained(f32, s["slo_p99_ms"], 0.02)
    b16 = sustained(bf16, s["slo_p99_ms"], 0.02)
    assert s["sustained_rps_f32"] == (b32 and b32["achieved_rps"])
    assert s["sustained_rps_bf16"] == (b16 and b16["achieved_rps"])
    if b32 and b16:
        assert s["req_s_ratio"] == round(b16["achieved_rps"] / b32["achieved_rps"], 3)
    [micro] = by["probe:device_microbench"]
    assert micro["bf16_dispatch_slowdown"] == round(
        micro["dispatch_ms_bf16"] / micro["dispatch_ms_f32"], 3) or abs(
        micro["bf16_dispatch_slowdown"] - micro["dispatch_ms_bf16"] / micro["dispatch_ms_f32"]
    ) < 2e-3
    assert s["bf16_dispatch_slowdown_cpu"] == micro["bf16_dispatch_slowdown"]
    assert s["cpu_proxy_note"] == micro["note"] and micro["note"].startswith("measured on cpu")


def test_tenant_ab_quick_holds_jax_s_correctness_bars(port_runs):
    """The isolation, quota, rollup and default-path bars hold; the one
    entry ``failures`` may hold is the isolated interactive p99 over its
    SLO, exactly when the records show it over."""
    recs, failures = port_runs["tenant_ab"][3:]
    iso, open_, pin, s = recs
    it, bt = iso["tenants"]["interactive"], iso["tenants"]["batch"]
    assert (s["quick"], s["weights"], s["batch_quota"]) == (True, "interactive:3,batch:1", 8)
    assert s["flood_factor"] == 3.6 >= s["bar_flood_factor"] == 3.0
    assert it["shed_total"] == s["isolated_interactive_shed"] == 0
    assert it["p99_ms"] == s["isolated_interactive_p99_ms"]
    p99_over = s["isolated_interactive_p99_ms"] > s["slo_p99_ms"]
    assert len(failures) == int(p99_over), failures
    assert all(f.startswith("isolated arm interactive p99") for f in failures), failures
    assert bt["shed"].get("shed_tenant_quota", 0) == s["isolated_batch_quota_sheds"] >= 1
    assert s["pin_tenant_footprint"] == pin["tenant_named_events"] + pin["tenant_fields"] + int(
        pin["summary_has_tenants"]) == 0
    for arm in (iso, open_):  # both arms replay the one trace
        assert arm["submitted"] == s["arrivals"] == sum(
            t["submitted"] for t in arm["tenants"].values())
        for t in arm["tenants"].values():
            assert t["completed"] + t["shed_total"] == t["submitted"]
    assert (iso["tagged"], open_["tagged"], open_["policy"]) == (True, False, None)
    assert s["open_breached"] == bool(
        (s["open_interactive_p99_ms"] or 0) > s["slo_p99_ms"] or s["open_interactive_shed"] > 0)


def test_autoscale_ab_quick_holds_jax_s_correctness_bars(port_runs):
    """The chaos scale-in loses nothing and matches the offline rollouts,
    and the pool scales out; the one entry ``failures`` may hold is the
    replica-seconds bar, exactly when the records show none saved."""
    recs, failures = port_runs["autoscale_ab"][3:]
    static, auto, chaos, s = recs
    assert (s["quick"], s["duration_s"], chaos["sessions"], chaos["steps"]) == (True, 8.0, 6, 4)
    assert (static["replicas_founding"], auto["replicas_founding"]) == (4, 2)
    assert static["submitted"] == auto["submitted"] == s["arrivals"]
    assert s["replica_seconds_saved_frac"] == round(
        1.0 - auto["replica_seconds"] / static["replica_seconds"], 3)
    none_saved = auto["replica_seconds"] >= static["replica_seconds"]
    assert len(failures) == int(none_saved), failures
    assert all(f.startswith("autoscaled pool did not save") for f in failures), failures
    assert s["scale_ups"] == auto["autoscale_stats"]["scale_ups"] >= 1
    assert chaos["lost_sessions"] == s["chaos_lost_sessions"] == 0
    assert chaos["lost_requests"] == s["chaos_lost_requests"] == 0
    assert chaos["completed"] == 6 and chaos["max_abs_diff"] <= chaos["bar_numeric"] == 1e-5
    assert chaos["kill_at_step"] == 4 and chaos["removed_replica"] == 0
    assert s["p99_ratio"] == round(auto["p99_ms"] / static["p99_ms"], 3)


# -- the exit rules ---------------------------------------------------------------


SERVE_BENCH_SUMMARIES = [
    {"speedup": 1.1, "bar_speedup": 2.5, "max_abs_diff": 0.0, "bar_numeric": 1e-5},
    {"speedup": 2.6, "bar_speedup": 2.5, "max_abs_diff": 0.0, "bar_numeric": 1e-5},
    {"speedup": None, "bar_speedup": 2.5, "max_abs_diff": 0.0, "bar_numeric": 1e-5},
    {"speedup": 3.0, "bar_speedup": 2.5, "max_abs_diff": 2e-5, "bar_numeric": 1e-5},
]
LOWPREC_SUMMARIES = [
    {"parity_max_delta": 1e-3, "parity_bar": 0.01, "host_reduction_frac": 0.2,
     "sustained_rps_bf16": 90.0},
    {"parity_max_delta": 0.02, "parity_bar": 0.01, "host_reduction_frac": 0.2,
     "sustained_rps_bf16": 90.0},
    {"parity_max_delta": 1e-3, "parity_bar": 0.01, "host_reduction_frac": 0.0,
     "sustained_rps_bf16": 90.0},
    {"parity_max_delta": 1e-3, "parity_bar": 0.01, "host_reduction_frac": None,
     "sustained_rps_bf16": 90.0},
    {"parity_max_delta": 1e-3, "parity_bar": 0.01, "host_reduction_frac": 0.2,
     "sustained_rps_bf16": None},
]


@pytest.mark.parametrize("tool,summary", [
    *[("serve_bench", s) for s in SERVE_BENCH_SUMMARIES],
    *[("lowprec_ab", s) for s in LOWPREC_SUMMARIES],
    *[(t, {"failures": f}) for t in ("tenant_ab", "autoscale_ab") for f in ([], ["a bar"])],
])
def test_main_exit_rule_is_jax_s(tool, summary, monkeypatch, capsys):
    """Each ``main`` on a summary its ``run`` returned, against JAX's
    ``main`` on the same summary: a summary that misses ``bar_speedup`` (one
    card's case) exits 1 in both."""
    jax_module = jax_tool(tool)
    port_module = MODULES[tool]
    monkeypatch.setattr(jax_module, "run", lambda argv=None: dict(summary))
    monkeypatch.setattr(port_module, "run", lambda argv=None: dict(summary))
    assert port_module.main([]) == jax_module.main([])
    if tool == "serve_bench":
        assert port_module.main([]) == (0 if summary is SERVE_BENCH_SUMMARIES[1] else 1)


def test_serve_bench_trace_path_prints_the_per_replica_breakdown(tmp_path, capsys):
    """``--trace_path``'s re-run (``_traced_run``) writes a Chrome trace of
    the N-replica pool and prints ``trace_report``'s tables, the
    per-replica one among them."""
    import argparse

    args = argparse.Namespace(max_batch=4, layers=1, hidden=16, seed=0, device="cpu",
                              queue_limit=256, duration_s=0.5,
                              trace_path=str(tmp_path / "t.json"))
    from gnot_tpu_torch.tools import serve_smoke, trace_report

    model = serve_bench._build_model(args)
    traffic = serve_smoke.mixed_traffic(4, seed=0, mesh_lo=100, mesh_hi=200)
    replicas, _ = serve_bench.make_replicas(model, 2, max_batch=4, traffic=traffic)
    serve_bench._traced_run(args, replicas, traffic, {"load_mult": 0.5}, 40.0)
    out = capsys.readouterr().out
    assert "per replica" in out and "critical path" in out
    spans = trace_report.load_spans(args.trace_path)
    assert {s["name"] for s in spans} >= {"queue_wait", "device", "dispatch"}
