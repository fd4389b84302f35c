"""The port's bench (``gnot_tpu_torch/bench.py``) and the three tools built
on it (``gnot_tpu_torch/tools/honest_probe.py``, ``profile_step.py``,
``pack_ab.py``) against the repo-root ``bench.py`` and JAX's tools.

* Batches: for each of the five configs, and ns2d ``--packed``, the port's
  bench batch is bitwise JAX's, with JAX's ``n_real_points`` and model
  dims.
* The step: with JAX's params carried over, two f32 steps of the port's
  ``build`` step give JAX's ``build`` step's losses and params at the
  model-level bar.
* ``main``: the printed key set is JAX's on the same argv, and
  ``--metrics_path`` writes the sink schema and ``run.json`` as JAX's does
  (``tests/test_obs.py::test_bench_metrics_path_emits_sink_schema``).
* The estimators agree on the CPU; the refusals; the flop count (one count
  for both FFN paths, products only: below JAX's count, never above).
* The tools end to end on the CPU, and with JAX unimportable.

JAX's params are built by ``jax.jit`` of ``init_params`` (bitwise its eager
params, in a third of the time), and ``main`` runs JAX's ``TINY`` model of
``tests/test_benchmarks_e2e.py`` through ``_model_config`` in both
packages, so JAX compiles no full-width program here."""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

import bench as jax_bench
from chip_smoke import BENCH_KEYS, NO_JAX
from gnot_tpu.data.batch import PackedLoader as JaxPackedLoader
from gnot_tpu.train import trainer as jax_trainer
from gnot_tpu_torch import bench
from gnot_tpu_torch.config import NotPortedError
from gnot_tpu_torch.interop import flatten_tree, params_from_jax
from gnot_tpu_torch.tools import honest_probe, pack_ab, profile_step

REPO = Path(__file__).resolve().parents[1]
RTOL, ATOL = 1e-4, 1e-5  # the model-level bar (ROADMAP's North star)
# JAX's TINY model (tests/test_benchmarks_e2e.py:19).
TINY = dict(
    n_attn_layers=1,
    n_attn_hidden_dim=16,
    n_mlp_num_layers=1,
    n_mlp_hidden_dim=16,
    n_input_hidden_dim=16,
    n_expert=2,
    n_head=2,
)
CONFIGS = ["ns2d", "darcy2d", "elasticity", "inductor2d", "heatsink3d"]
PADDED_FIELDS = ("coords", "theta", "y", "node_mask", "funcs", "func_mask")
PACKED_FIELDS = PADDED_FIELDS + ("node_seg", "func_seg")
DIMS = ("input_dim", "theta_dim", "input_func_dim", "out_dim", "n_input_functions")
# The main() argv of tests/test_obs.py::test_bench_metrics_path_emits_sink_schema.
MAIN_ARGV = ["--timing", "persstep", "--steps", "2", "--warmup", "1", "--repeats", "1",
             "--cpu_steps", "0", "--n_points", "64", "--batch_size", "2",
             "--dtype", "float32"]


def _jitted_init(init):
    return lambda model, batch, seed: jax.jit(lambda b: init(model, b, seed))(batch)


def _tiny_model_config(module, monkeypatch):
    """``module._model_config`` with ``TINY`` as its overrides."""
    real = module._model_config
    monkeypatch.setattr(module, "_model_config",
                        lambda s, d, a, f, r, o: real(s, d, a, f, r, TINY))


@pytest.fixture(scope="module")
def jax_tiny():
    """JAX's ``bench.build`` at ``TINY``: ns2d, 64 points, batch 2, f32."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_trainer, "init_params", _jitted_init(jax_trainer.init_params))
        step, state, batch, mc = jax_bench.build("float32", n_points=64, batch_size=2,
                                                 model_overrides=TINY)
    return step, state, batch, mc


def _port_tiny(**kw):
    return bench.build(kw.pop("dtype", "float32"), n_points=64, batch_size=2,
                       model_overrides=TINY, device="cpu", **kw)


def _assert_bitwise(got, want, fields):
    for field in fields:
        w, g = getattr(want, field), getattr(got, field)
        if w is None:
            assert g is None, field
            continue
        w, g = np.asarray(w), g.numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, field
        assert g.tobytes() == w.tobytes(), field


@pytest.mark.parametrize("config,packed", [(c, False) for c in CONFIGS] + [("ns2d", True)])
def test_bench_batches_are_bitwise_jax(config, packed):
    """The bench's batch for each config (and ns2d packed): JAX's arrays
    bit for bit, JAX's ``n_real_points`` and JAX's model dims; ``build``
    hands the trainer the same batch ``build_data`` gives."""
    jbatch, jmc = jax_bench.build_data("float32", 64, 2, config)
    _, state, batch, mc = _port_tiny(config=config, packed=packed)
    if packed:
        want = JaxPackedLoader(jax_bench._gen_samples(config, 64, 2), 2, chunk=128).probe_batch()
        _assert_bitwise(batch, want, PACKED_FIELDS)
        assert batch.n_seg == want.n_seg
    else:
        want = jbatch
        _assert_bitwise(batch, want, PADDED_FIELDS)
        data_batch, data_mc = bench.build_data("float32", 64, 2, config)
        _assert_bitwise(data_batch, want, PADDED_FIELDS)
        assert {k: getattr(data_mc, k) for k in DIMS} == {k: getattr(jmc, k) for k in DIMS}
    assert batch.n_real_points == want.n_real_points > 0
    assert {k: getattr(mc, k) for k in DIMS} == {k: getattr(jmc, k) for k in DIMS}
    assert state.config.data.packed is packed


def test_two_f32_bench_steps_match_jax(jax_tiny):
    """Two steps of the port's bench step from JAX's params: the losses and
    every parameter after them within the model-level bar of JAX's bench
    step on the same batch."""
    jstep, jstate, jbatch, _ = jax_tiny
    params0 = jax.tree.map(np.array, jax.device_get(jstate.params))
    state = jax.tree.map(jnp.copy, jstate)  # the JAX step donates its state
    lr = jnp.asarray(1e-3, jnp.float32)
    want = []
    for _ in range(2):
        state, loss = jstep(state, jbatch, lr)
        want.append(float(loss))
    want_params = flatten_tree(jax.device_get(state.params))

    step, pstate, batch, mc = _port_tiny()
    pstate.model.load_state_dict(params_from_jax(params0, mc), strict=True)
    got = []
    for _ in range(2):
        pstate, loss = step(pstate, batch, 1e-3)
        got.append(float(loss))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert pstate.host_step == 2
    for name, p in pstate.model.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want_params[name], rtol=RTOL, atol=ATOL,
                                   err_msg=f"parameter {name} after step 2")


def test_main_prints_jax_keys_and_writes_the_sink_schema(tmp_path, monkeypatch, capsys):
    """``main`` on the argv of JAX's metrics-path test: JAX's key set, then
    that test's checks of the JSONL record and ``run.json``."""
    _tiny_model_config(jax_bench, monkeypatch)
    _tiny_model_config(bench, monkeypatch)
    monkeypatch.setattr(jax_trainer, "init_params", _jitted_init(jax_trainer.init_params))
    monkeypatch.setattr("sys.argv", ["bench.py", *MAIN_ARGV])
    jax_bench.main()
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])

    mp = str(tmp_path / "bench.jsonl")
    result = bench.main([*MAIN_ARGV, "--device", "cpu", "--metrics_path", mp])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == result
    assert set(printed) == set(want) == BENCH_KEYS  # chip_smoke.py's phase 24 checks these
    assert printed["metric"] == want["metric"] == "ns2d_mesh_points_per_sec_per_chip"
    assert printed["timing"] == "persstep" and printed["dtype"] == "float32"
    assert printed["value"] > 0 and printed["vs_baseline"] == 1.0 and printed["mfu"] is None
    recs = [json.loads(line) for line in open(mp)]
    assert len(recs) == 1 and recs[0]["kind"] == "bench"
    assert recs[0]["metric"] == printed["metric"]
    assert recs[0]["value"] == printed["value"]
    assert "ts" in recs[0]  # the sink's timestamp, as on the trainer's records
    man = json.load(open(tmp_path / "run.json"))
    assert man["kind"] == "bench" and man["config"]["n_points"] == 64
    assert man["config"]["device"] == "cpu" and man["devices"]["platform"] == "cpu"


def test_scan_marginal_matches_persstep_on_cpu():
    """The marginal estimator against the per-step loop on the CPU, where
    both time the same eager steps: medians of independent estimates
    within 0.2-5x (tests/test_benchmarks_e2e.py's bar), and the state
    each started from held again afterwards."""
    step, state, batch, _ = _port_tiny()
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    scans, steps = [], []
    for _ in range(3):
        try:
            scans.append(bench.time_scan_marginal(step, state, batch, 1e-3, "cpu", 4, 16, 2))
        except RuntimeError:
            pass  # a degenerate window; the median of the rest decides
        steps.append(bench.time_steps(step, state, batch, 1e-3, 2, 16, "cpu", repeats=2))
    assert scans, "every scan-marginal window degenerated"
    per_scan, per_step = float(np.median(scans)), float(np.median(steps))
    assert per_scan > 0 and np.isfinite(per_scan) and per_step > 0
    assert 0.2 < per_scan / per_step < 5.0
    assert state.host_step == 0 and not state.optimizer.state
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_refusals_in_jax_words(capsys):
    step, state, batch, _ = _port_tiny()
    with pytest.raises(ValueError, match=r"need k2 > k1, got k1=5 k2=5"):
        bench.time_scan_marginal(step, state, batch, 1e-3, "cpu", 5, 5, 1)
    with pytest.raises(ValueError) as want:
        jax_bench.build("float32", packed=True, flat_params=True)
    with pytest.raises(ValueError) as got:
        bench.build("float32", packed=True, flat_params=True, device="cpu")
    assert str(got.value) == str(want.value)
    with pytest.raises(NotPortedError, match="--baseline torch"):
        bench.main(["--device", "cpu", "--baseline", "torch"])
    assert bench.peak_flops("NVIDIA H100 80GB HBM3", "bfloat16") == 989e12
    assert bench.peak_flops("NVIDIA H100 80GB HBM3", "float32") == 67e12
    capsys.readouterr()
    for kind in ("cpu", "NVIDIA A100-SXM4-80GB"):
        assert bench.peak_flops(kind, "bfloat16") is None
        assert f"no peak-FLOPs entry for device_kind={kind!r}" in capsys.readouterr().err


def test_flop_count_is_one_for_both_ffn_paths_and_leaves_the_state(jax_tiny):
    """``step_flops``: the same count for ``xla`` and ``pallas`` (the FFN
    is counted on its ``xla`` path), the state as it was, and products
    only: 0.5 < port / JAX <= 1 against XLA's count, which adds the
    elementwise work (0.838 at ``TINY`` when written)."""
    counts = {}
    for impl in ("xla", "pallas"):
        step, state, batch, _ = _port_tiny(ffn_impl=impl)
        before = {k: v.clone() for k, v in state.model.state_dict().items()}
        counts[impl] = bench.step_flops(step, state, batch, 1e-3)
        assert state.host_step == 0 and not state.optimizer.state
        assert all(torch.equal(v, before[k]) for k, v in state.model.state_dict().items())
        ffn_impls = {m.ffn_impl for m in state.model.modules() if hasattr(m, "ffn_impl")}
        assert ffn_impls == {impl}
    assert counts["xla"] == counts["pallas"] > 0
    jstep, jstate, jbatch, _ = jax_tiny
    jax_count = jax_bench.step_flops(jstep, jstate, jbatch, jnp.asarray(1e-3, jnp.float32))
    assert 0.5 < counts["xla"] / jax_count <= 1.0, (counts["xla"], jax_count)


def test_mem_stats_keys_are_jax_and_null_on_the_cpu(capsys):
    assert bench.mem_stats("cpu") == dict.fromkeys(
        ("peak_bytes_in_use", "bytes_in_use", "largest_alloc_size"))
    assert "largest_alloc_size" in capsys.readouterr().err


def test_honest_probe_prints_its_line(capsys):
    line = honest_probe.main(["--device", "cpu", "--n_points", "16", "--batch_size", "2",
                              "--k1", "1", "--k2", "5", "--windows", "1",
                              "--n_attn_layers", "1", "--flat_params"])
    assert capsys.readouterr().out.strip() == line
    assert line.startswith("bfloat16 attn=xla ffn=xla ns2d layers=1 flat: ")
    assert line.endswith("M pts/s") and " ms/step  " in line


def test_pack_ab_records_are_jax_s_and_packed_matches_solo(tmp_path, capsys):
    """JAX's record keys (its committed artifact's), the numerics bar, and
    ``--out`` written only where asked, equal to stdout."""
    out = tmp_path / "ab.jsonl"
    records = pack_ab.main(["--device", "cpu", "--n_points", "32", "--batch_size", "4",
                            "--steps", "1", "--repeats", "1", "--serve_n", "8",
                            "--out", str(out)])
    printed = capsys.readouterr().out
    lines = [line for line in printed.splitlines() if line.startswith("{")]
    assert [json.loads(line) for line in lines] == records
    assert out.read_text() == "\n".join(lines) + "\n"
    with open(REPO / "docs" / "artifacts" / "pack_ab.jsonl") as f:
        want = [json.loads(line) for line in f if line.strip()]
    assert [set(r) for r in records] == [set(r) for r in want]
    summary = records[-1]
    assert summary["platform"] == "cpu" and summary["max_abs_diff"] <= 1e-5
    assert records[0]["real_tokens"] > 0 and records[2]["dispatches"] > 0


def test_profile_step_family_and_breakdown():
    assert profile_step.family(
        "void at::native::vectorized_elementwise_kernel<4, at::native::FillFunctor<float>, "
        "at::detail::Array<char*, 1> >(int, at::native::FillFunctor<float>, "
        "at::detail::Array<char*, 1>)") == "at::native::vectorized_elementwise_kernel"
    assert profile_step.family(
        "void (anonymous namespace)::softmax_warp_forward<float, float, 5>(float*, int)"
    ) == "(anonymous namespace)::softmax_warp_forward"
    assert profile_step.family("Memcpy DtoH (Device -> Pinned)") == "Memcpy DtoH"
    assert profile_step.family("fused_gated_ffn_kernel") == "fused_gated_ffn_kernel"
    assert profile_step.family("sm90_xmma_gemm_f32f32_tn_n_kernel.12") == \
        "sm90_xmma_gemm_f32f32_tn_n_kernel"

    def ev(cat, name, ts, dur, corr):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
                "args": {"correlation": corr}}

    events = [
        ev("cuda_runtime", "cudaLaunchKernel", 0, 1, 1),
        ev("cuda_runtime", "cudaLaunchKernelExC", 1, 1, 2),
        ev("cuda_driver", "cuLaunchKernel", 2, 1, 3),
        ev("cuda_runtime", "cudaMemcpyAsync", 3, 1, 4),
        ev("kernel", "void gemm<1>(float*)", 10, 4, 1),  # overlaps the next
        ev("kernel", "fused_gated_ffn_kernel(float*)", 12, 4, 2),
        ev("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 20, 2, 4),
        ev("cpu_op", "aten::mm", 0, 50, 0),
        {"ph": "i", "cat": "kernel", "name": "marker", "ts": 0},
    ]
    table = profile_step.breakdown(events, k=2)
    assert table["ops_total_ms_per_step"] == pytest.approx(10e-3 / 2)
    assert table["module_total_ms_per_step"] == pytest.approx(8e-3 / 2)  # 10-16, 20-22
    assert table["while_wrapper_ms_per_step"] is None
    assert "while_wrapper_ms_per_step" in table["unavailable"]
    assert (table["kernel_records"], table["launch_calls"], table["records_lost"]) == (2, 3, 1)
    assert table["ffn_kernel_records"] == 1
    fams = {f["family"]: f for f in table["op_families"]}
    assert set(fams) == {"gemm", "fused_gated_ffn_kernel", "Memcpy DtoH"}
    assert fams["gemm"]["ms_per_step"] == 0.002 and fams["gemm"]["pct_of_ops"] == 40.0
    assert fams["Memcpy DtoH"]["count_per_step"] == 0.5
    assert set(fams["gemm"]) == {"family", "ms_per_step", "pct_of_ops", "count_per_step",
                                 "example_hlo"}


def test_profile_step_refuses_the_cpu():
    with pytest.raises(SystemExit, match="no CUDA device plane"):
        profile_step.main(["--device", "cpu"])


@pytest.mark.parametrize("module,args", [
    ("gnot_tpu_torch.bench", ["--device", "cpu", "--timing", "persstep", "--steps", "1",
                              "--warmup", "1", "--repeats", "1", "--cpu_steps", "0",
                              "--n_points", "16", "--batch_size", "1", "--dtype", "float32"]),
    ("gnot_tpu_torch.tools.honest_probe", ["--device", "cpu", "--n_points", "16",
                                           "--batch_size", "1", "--k1", "1", "--k2", "3",
                                           "--windows", "1", "--n_attn_layers", "1"]),
])
def test_entry_points_run_without_jax(module, args):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    proc = subprocess.run([sys.executable, "-c", NO_JAX, module, *args], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    assert "no-jax: refused [] loaded [] in " in proc.stderr, proc.stderr[-2000:]
    assert proc.stdout.strip()
