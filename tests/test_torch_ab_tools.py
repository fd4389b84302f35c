"""The port's overhead and chaos A/B tools (``gnot_tpu_torch/tools/``:
``telemetry_ab``, ``tracing_ab``, ``metrics_ab``, ``capacity_ab``,
``dtrace_ab``, ``rollout_ab``, ``federation_ab``) against the repo's
``tools/`` scripts they port.

* Flags: each tool's ``add_argument`` calls, read with ``ast`` from both
  files (JAX builds its parsers inside ``main`` / ``run``), name for name,
  type, default, action and required; the port adds ``--device`` only.
* Records: each tool runs once, tiny, with ``--device cpu`` in a process
  where importing ``jax``, ``jaxlib``, ``flax`` or ``gnot_tpu`` raises
  (``chip_smoke.NO_JAX``); its arm names and each record's key set are
  those of JAX's committed ``docs/artifacts/*.jsonl`` for that tool, and
  its summary is JAX's arithmetic over its arm records.
* Bars: ``rollout_ab`` and ``federation_ab`` at ``--quick`` hold JAX's
  correctness bars (no failures, none lost with migration or failover,
  some lost by each twin, parity within 1e-5, the single-host pin
  byte-identical).
* JAX's own ``telemetry_ab``, ``tracing_ab`` and ``metrics_ab`` run
  in-process at the same tiny argv (JAX compiles only the micro-bench
  step and the smoke's tiny engine): equal deterministic fields. JAX's
  ``rollout_ab`` and ``federation_ab`` run at ``--quick`` in processes of
  their own (~20-35 s each on the CPU), started before the port's tools
  so the two sets overlap: equal storm sizes, kill step, snapshot
  cadence, steps committed where no session is lost, and the pin.
"""

import ast
import contextlib
import importlib.util
import io
import json
import os
import subprocess
import sys

import pytest
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

from chip_smoke import NO_JAX
from gnot_tpu_torch.tools.capacity_ab import iq_mean

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARTIFACTS = os.path.join(REPO, "docs", "artifacts")
#: Each tool's committed JAX artifact and its tiny argv (``--device cpu``
#: and ``--out`` are appended).
TOOLS = {
    "telemetry_ab": ("telemetry_overhead_ab.jsonl",
                     ["--n_points", "64", "--batch_size", "2", "--steps", "2", "--repeats", "1"]),
    "tracing_ab": ("tracing_overhead_ab.jsonl",
                   ["--n_points", "64", "--batch_size", "2", "--steps", "2", "--repeats", "1"]),
    "metrics_ab": ("metrics_overhead_ab.jsonl", ["--n", "12", "--repeats", "1"]),
    "capacity_ab": ("capacity_overhead_ab.jsonl", ["--n", "12", "--repeats", "2"]),
    "dtrace_ab": ("dtrace_overhead_ab.jsonl", ["--n", "4", "--repeats", "1"]),
    "rollout_ab": ("rollout_ab.jsonl", ["--quick"]),
    "federation_ab": ("federation_ab.jsonl", ["--quick"]),
}
#: The JAX tools run here in-process, at the port's tiny argv.
JAX_RUNS = ("telemetry_ab", "tracing_ab", "metrics_ab")
#: Per record kind, the fields that do not depend on timing.
DETERMINISTIC = {
    "telemetry_ab": ("arm", "platform", "n_points", "batch_size", "steps", "log_every", "repeats"),
    "tracing_ab": ("arm", "platform", "n_points", "batch_size", "steps", "sample_rate", "repeats"),
    "metrics_ab": ("arm", "requests", "platform", "max_batch", "interval_s", "repeats"),
}
#: The chaos A/Bs run by JAX's scripts at ``--quick``, and per record kind
#: the fields that do not depend on where the kill lands in the storm.
JAX_CHAOS = ("rollout_ab", "federation_ab")
CHAOS_STORM = ("sessions", "steps", "snapshot_every")
CHAOS_DETERMINISTIC = {
    "arm:migration": (*CHAOS_STORM, "killed_replica", "kill_at_step", "completed", "lost",
                      "steps_committed"),
    "arm:no_migration": (*CHAOS_STORM, "killed_replica", "kill_at_step"),
    "probe:parity": ("sessions_checked", "steps", "bar"),
    "summary:rollout_ab": ("quick", *CHAOS_STORM, "kill_at_step", "lost_migration",
                           "bar_numeric", "bar_lost_migration"),
    "arm:chaos": ("hosts", "failover", *CHAOS_STORM, "completed", "lost",
                  "hosts_dead", "protocol_errors", "steps_committed"),
    "arm:no_failover": ("hosts", "failover", *CHAOS_STORM, "hosts_dead", "protocol_errors"),
    "probe:single_host_pin": ("requests", "byte_identical", "summary_match", "summary_fields",
                              "ledger"),
    "summary:federation_ab": ("quick", "hosts", *CHAOS_STORM, "lost_chaos",
                              "single_host_byte_identical", "bar_numeric", "bar_lost_chaos"),
}
#: Runs ``federation_ab`` (``argv``: the federation module, then the tool's
#: module or script and its flags) with two lines of the cluster's own
#: ledger appended to ``$FEDERATION_LEDGER`` per storm: the host each
#: ``HostAgent.kill`` stopped, then the live hosts whose drain summaries
#: ``ClusterRouter.drain`` collected and its ``hosts_dead``.
LEDGER_HOOK = r"""
import importlib, json, os, runpy, sys
fed = importlib.import_module(sys.argv[1])
target, sys.argv = sys.argv[2], sys.argv[2:]

def log(**rec):
    with open(os.environ["FEDERATION_LEDGER"], "a") as f:
        f.write(json.dumps(rec) + "\n")

kill, drain = fed.HostAgent.kill, fed.ClusterRouter.drain

def logged_kill(self):
    log(killed=self.host_id)
    kill(self)

def logged_drain(self, *args, **kwargs):
    summary = drain(self, *args, **kwargs)
    log(live=sorted(summary["per_host"]), hosts_dead=summary["hosts_dead"])
    return summary

fed.HostAgent.kill, fed.ClusterRouter.drain = logged_kill, logged_drain
if target.endswith(".py"):
    sys.path.insert(0, os.path.dirname(os.path.abspath(target)))
    runpy.run_path(target, run_name="__main__")
else:
    runpy.run_module(target, run_name="__main__", alter_sys=True)
"""


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
            name = node.args[0].value
            kw = {k.arg: ast.unparse(k.value) for k in node.keywords
                  if k.arg in ("type", "default", "action", "required")}
            out[name] = kw
    return out


@pytest.fixture(scope="module")
def ledger_dir(tmp_path_factory):
    """Where each package's ``federation_ab`` run writes its cluster ledger
    (``LEDGER_HOOK``): ``port.jsonl`` and ``jax.jsonl``."""
    return tmp_path_factory.mktemp("federation_ledger")


@pytest.fixture(scope="module")
def jax_chaos_procs(tmp_path_factory, ledger_dir):
    """JAX's ``rollout_ab`` and ``federation_ab`` at ``--quick`` on the CPU,
    started (8 host devices, as their usage asks; ``federation_ab`` under
    ``LEDGER_HOOK``): ``{tool: (Popen, out)}``, killed at the module's end
    if still running."""
    tmp = tmp_path_factory.mktemp("jax_chaos")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               FEDERATION_LEDGER=str(ledger_dir / "jax.jsonl"))
    procs = {}
    for tool in JAX_CHAOS:
        out = tmp / f"{tool}.jsonl"
        hook = ["-c", LEDGER_HOOK, "gnot_tpu.serve.federation"] if tool == "federation_ab" else []
        procs[tool] = (subprocess.Popen(
            [sys.executable, *hook, os.path.join("tools", f"{tool}.py"), "--quick",
             "--out", str(out)],
            cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), out)
    yield procs
    for proc, _ in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.wait()


@pytest.fixture(scope="module")
def port_runs(tmp_path_factory, jax_chaos_procs, ledger_dir):
    """Each tool once, tiny, ``--device cpu``, in a process without JAX
    (JAX's chaos A/Bs already running beside them; ``federation_ab`` under
    ``LEDGER_HOOK``): ``{tool: (CompletedProcess, records)}``."""
    tmp = tmp_path_factory.mktemp("ab_tools")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(OMP_NUM_THREADS="1", FEDERATION_LEDGER=str(ledger_dir / "port.jsonl"))
    runs = {}
    for tool, (_, argv) in TOOLS.items():
        out = tmp / f"{tool}.jsonl"
        hook = (["-c", LEDGER_HOOK, "gnot_tpu_torch.serve.federation"]
                if tool == "federation_ab" else [])
        proc = subprocess.run(
            [sys.executable, "-c", NO_JAX, *hook, f"gnot_tpu_torch.tools.{tool}", *argv,
             "--device", "cpu", "--out", str(out)],
            cwd=REPO, env=env, capture_output=True, text=True, timeout=180)
        runs[tool] = (proc, read_jsonl(out) if out.exists() else [])
    return runs


@pytest.fixture(scope="module")
def jax_runs():
    """JAX's ``telemetry_ab``, ``tracing_ab`` and ``metrics_ab`` at the same
    tiny argv, in this process: ``{tool: records}``."""
    sys.path.insert(0, os.path.join(REPO, "tools"))  # metrics_ab imports serve_smoke
    runs = {}
    try:
        for tool in JAX_RUNS:
            spec = importlib.util.spec_from_file_location(
                f"gnot_ab_tool_{tool}", os.path.join(REPO, "tools", f"{tool}.py"))
            module = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(module)
            saved = sys.argv
            sys.argv = [tool, *TOOLS[tool][1]]
            try:
                with contextlib.redirect_stdout(io.StringIO()) as out:
                    module.main()
            finally:
                sys.argv = saved
            runs[tool] = [json.loads(line) for line in out.getvalue().splitlines() if line.strip()]
    finally:
        sys.path.remove(os.path.join(REPO, "tools"))
    return runs


@pytest.fixture(scope="module")
def jax_chaos_runs(jax_chaos_procs):
    """``{tool: records}`` of JAX's chaos A/Bs, once each has exited 0."""
    runs = {}
    for tool, (proc, out) in jax_chaos_procs.items():
        stdout, _ = proc.communicate(timeout=300)
        assert proc.returncode == 0, f"JAX's {tool}: {stdout[-3000:]}"
        runs[tool] = read_jsonl(out)
    return runs


@pytest.mark.parametrize("tool", list(TOOLS))
def test_flags_are_jax_s_plus_device(tool):
    port = flags(os.path.join(REPO, "gnot_tpu_torch", "tools", f"{tool}.py"))
    jax_flags = flags(os.path.join(REPO, "tools", f"{tool}.py"))
    assert port.pop("--device") == {"type": "str", "default": "'cuda'"}
    assert port == jax_flags


@pytest.mark.parametrize("tool", list(TOOLS))
def test_each_tool_runs_without_jax_and_writes_jax_s_record_shapes(tool, port_runs):
    proc, recs = port_runs[tool]
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    # The runner's last line names the JAX imports it refused and any loaded.
    assert "no-jax: refused [] loaded [] in " in proc.stderr, proc.stderr[-2000:]
    want = read_jsonl(os.path.join(ARTIFACTS, TOOLS[tool][0]))
    assert [record_kind(r) for r in recs] == [record_kind(r) for r in want]
    for got, ref in zip(recs, want):
        assert set(got) == set(ref), record_kind(got)
    assert all(r["platform"] == "cpu" for r in recs if "platform" in r)


@pytest.mark.parametrize("tool", ["telemetry_ab", "tracing_ab", "metrics_ab", "capacity_ab",
                                  "dtrace_ab"])
def test_overhead_summary_is_jax_s_arithmetic(tool, port_runs):
    off, on, summary = port_runs[tool][1]
    assert summary["bar"] == read_jsonl(os.path.join(ARTIFACTS, TOOLS[tool][0]))[-1]["bar"]
    if tool in ("metrics_ab", "capacity_ab"):
        assert summary["overhead_frac"] == round(
            1.0 - on["requests_per_s"] / off["requests_per_s"], 4)
        assert (summary["requests_per_s_off"], summary["requests_per_s_on"]) == (
            off["requests_per_s"], on["requests_per_s"])
        assert summary["snapshots_on"] == on["snapshots"] >= 1
        for r in (off, on):  # both rounded from one window time
            slack = 5e-5 + r["requests"] * 0.005 / r["requests_per_s"] ** 2 + 1e-9
            assert abs(r["requests"] / r["requests_per_s"] - r["seconds"]) <= slack
    else:
        key = "ms_per_request" if tool == "dtrace_ab" else "ms_per_step"
        assert summary["overhead_frac"] == round(on[key] / off[key] - 1.0, 4)
        assert (summary[f"{key}_off"], summary[f"{key}_on"]) == (off[key], on[key])
    if tool == "capacity_ab":
        assert on["windows"] == off["windows"] == 2 and on["programs"] == 1
        assert summary["attributed_dispatches"] == on["attributed_dispatches"] > 0
        assert off["seconds_min"] <= off["seconds"] and on["seconds_min"] <= on["seconds"]


def test_iq_mean_trims_a_quarter_each_end():
    """capacity_ab's estimator, JAX's inline ``iq_mean``."""
    assert iq_mean([5.0]) == 5.0
    assert iq_mean([4.0, 1.0, 3.0]) == pytest.approx(8.0 / 3.0)
    assert iq_mean([9.0, 1.0, 2.0, 3.0]) == 2.5
    assert iq_mean([100.0, 1.0, 2.0, 3.0, 4.0, 5.0, 6.0, -50.0]) == pytest.approx(3.5)


def test_rollout_ab_quick_holds_jax_s_bars(port_runs):
    arms = {r["arm"]: r for r in port_runs["rollout_ab"][1] if "arm" in r}
    parity, summary = port_runs["rollout_ab"][1][-2:]
    mig, nomig = arms["migration"], arms["no_migration"]
    assert (summary["quick"], summary["sessions"], summary["steps"]) == (True, 6, 4)
    assert mig["lost"] == 0 and mig["completed"] == 6 and mig["migrated"] >= 1
    assert nomig["lost"] >= 1 and nomig["lost_reasons"] == ["error_replica_dead"]
    assert parity["max_abs_diff"] <= parity["bar"] == 1e-5
    assert parity["sessions_checked"] == 6
    assert (summary["lost_migration"], summary["lost_no_migration"], summary["migrated"]) == (
        mig["lost"], nomig["lost"], mig["migrated"])
    assert mig["steps_committed"] == 6 * 4


def test_federation_ab_quick_holds_jax_s_bars(port_runs):
    recs = port_runs["federation_ab"][1]
    arms = {r["arm"]: r for r in recs if "arm" in r}
    probes = {r["probe"]: r for r in recs if "probe" in r}
    summary = recs[-1]
    chaos, nofail = arms["chaos"], arms["no_failover"]
    assert (summary["quick"], summary["sessions"], summary["steps"]) == (True, 4, 8)
    assert chaos["lost"] == 0 and chaos["completed"] == 4 and chaos["remigrated"] >= 1
    assert chaos["hosts_dead"] == nofail["hosts_dead"] == 1
    assert chaos["protocol_errors"] == 0
    assert nofail["lost"] >= 1 and nofail["lost_reasons"] == ["host_dead"]
    assert probes["parity"]["max_abs_diff"] <= 1e-5
    pin = probes["single_host_pin"]
    assert pin["byte_identical"] is True and pin["summary_match"] is True
    assert pin["ledger"]["requests"] == pin["ledger"]["completed"] == 4
    assert summary["single_host_byte_identical"] is True
    assert (summary["lost_chaos"], summary["lost_no_failover"], summary["remigrated"]) == (
        chaos["lost"], nofail["lost"], chaos["remigrated"])


@pytest.mark.parametrize("tool", JAX_RUNS)
def test_jax_s_tool_at_the_same_argv_gives_the_same_deterministic_fields(
        tool, port_runs, jax_runs):
    got, want = port_runs[tool][1], jax_runs[tool]
    assert [record_kind(r) for r in got] == [record_kind(r) for r in want]
    for g, w in zip(got[:2], want[:2]):
        assert {k: g[k] for k in DETERMINISTIC[tool]} == {k: w[k] for k in DETERMINISTIC[tool]}
        assert set(g) == set(w)
    assert {k: got[2][k] for k in ("summary", "config", "bar")} == {
        k: want[2][k] for k in ("summary", "config", "bar")}


@pytest.mark.parametrize("tool", JAX_CHAOS)
def test_jax_s_chaos_tool_at_quick_gives_the_same_deterministic_fields(
        tool, port_runs, jax_chaos_runs):
    """The port's ``--quick`` storm is JAX's: the same sizes, kill step and
    snapshot cadence, every session of the failover arm committed, the
    parity probe over the same sessions and the single-host pin's ledger
    field for field. How many sessions the twin loses depends on where the
    kill lands, so only its storm is compared. Which host is killed (the
    owner of the first session seen mid-trajectory) depends on the
    sessions' progress: each package's run is held to its own ledger in
    ``test_each_federation_arm_records_the_host_it_killed``."""
    got, want = port_runs[tool][1], jax_chaos_runs[tool]
    assert [record_kind(r) for r in got] == [record_kind(r) for r in want]
    for g, w in zip(got, want):
        fields = CHAOS_DETERMINISTIC[record_kind(g)]
        assert {k: g[k] for k in fields} == {k: w[k] for k in fields}, record_kind(g)
        assert set(g) == set(w), record_kind(g)


@pytest.mark.parametrize("package", ["port", "jax"])
def test_each_federation_arm_records_the_host_it_killed(
        package, ledger_dir, port_runs, jax_chaos_runs):
    """Each ``federation_ab`` arm (both packages, ``--quick``) killed one
    host: the one its record names, and the one the cluster's drain found
    dead (every other host drained live)."""
    recs = port_runs["federation_ab"][1] if package == "port" else jax_chaos_runs["federation_ab"]
    arms = [r for r in recs if "arm" in r]
    ledger = read_jsonl(ledger_dir / f"{package}.jsonl")
    assert [sorted(e) for e in ledger] == [["killed"], ["hosts_dead", "live"]] * len(arms)
    for arm, kill, drain in zip(arms, ledger[::2], ledger[1::2]):
        hosts = {f"host{i}" for i in range(arm["hosts"])}
        assert arm["killed_host"] == kill["killed"], arm["arm"]
        assert hosts - set(drain["live"]) == {arm["killed_host"]}, arm["arm"]
        assert drain["hosts_dead"] == arm["hosts_dead"] == 1, arm["arm"]


def test_a_resume_whose_snapshot_vanishes_after_the_agent_read_still_resumes(tmp_path):
    """The race ``federation_ab`` met on the card: the survivor's agent reads
    a re-migrated session's snapshot, then its dead-but-running owner
    finishes the session and deletes the snapshot. The agent reads the
    snapshot once and hands it to the router, so the session resumes from
    that read's cursor and completes, where a second read found nothing
    and the agent held the session forever. A session never persisted
    answers ``no_snapshot``."""
    import threading

    from gnot_tpu_torch.serve import federation as fed
    from gnot_tpu_torch.serve.replica import build_replica
    from gnot_tpu_torch.serve.rollout import RolloutSession, SessionStore
    from gnot_tpu_torch.tools import serve_smoke

    engine = serve_smoke.build_engine(max_batch=2, device="cpu")
    sample = serve_smoke.mixed_traffic(1, seed=7)[0]
    store = SessionStore(str(tmp_path))
    session = RolloutSession("s000", sample, 4)
    store.save(session)
    real_load = store.load

    def load_then_vanish(name):
        state = real_load(name)
        store.delete(name)  # the owner finished between the two reads
        return state

    store.load = load_then_vanish
    cluster, agents = fed.build_local_federation(
        [[build_replica(engine.model, 0, "cpu", batch_size=2)]], session_store=store)
    agent = agents["host0"]
    agent.router.start()
    got, done = [], threading.Event()

    def reply(msg):
        got.append(msg)
        if msg["kind"] == fed.ROLLOUT_DONE:
            done.set()

    agent.handle(fed.wire(fed.SUBMIT_ROLLOUT, id="r1", steps=4, name="s000", resume=True),
                 reply)
    assert done.wait(60)
    kinds = [m["kind"] for m in got]
    assert kinds == [fed.PLACED, *[fed.STEP] * 4, fed.ROLLOUT_DONE], kinds
    assert got[0]["at_step"] == 0
    assert got[-1]["ok"] is True and got[-1]["steps_completed"] == 4
    assert agent._inflight == set() and agent.errors == 0
    # Nothing persisted: the agent answers no_snapshot and holds nothing.
    none = []
    agent.handle(fed.wire(fed.SUBMIT_ROLLOUT, id="r2", steps=4, name="s001", resume=True),
                 none.append)
    assert [(m["kind"], m.get("reason")) for m in none] == [(fed.ROLLOUT_DONE, "no_snapshot")]
    assert agent._inflight == set()
    # The server resolves a finished session before it deletes the
    # session's snapshot (JAX's order, gnot_tpu/serve/server.py): the
    # drain joins the worker, so the delete has happened when it returns.
    agent.router.drain(10.0)
    # The store itself: a missing snapshot reads as none, never raises.
    assert store.load("s000") is None and real_load("never_written") is None
    cluster.close()
