"""The profiler slice's arithmetic on a hand-made Chrome trace."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parents[1]))

from benchmark import costs, devtrace, readers  # noqa: E402

FFN = "void fused_gated_ffn_kernel<0, float, float>(FfnArgs<float, float>)"


def _events():
    x = lambda name, cat, ts, dur, corr=None: {  # noqa: E731
        "ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
        **({"args": {"correlation": corr}} if corr is not None else {})}
    return [
        x("cudaLaunchKernel", "cuda_runtime", 900.0, 5.0, 9),  # before the slice
        x(FFN, "kernel", 950.0, 30.0, 9),
        x("bench.anchor", "user_annotation", 1000.0, 2.0),
        x("bench.step.4", "user_annotation", 1010.0, 100.0),
        x("bench.step.5", "user_annotation", 1120.0, 100.0),
        x("cudaLaunchKernelExC", "cuda_runtime", 1020.0, 5.0, 1),
        x("cudaLaunchKernel", "cuda_runtime", 1030.0, 5.0, 2),
        x("cudaLaunchKernelExC", "cuda_runtime", 1130.0, 5.0, 3),
        x(FFN, "kernel", 1040.0, 40.0, 1),
        x("void at::native::elementwise_kernel<128, 2>(int)", "kernel", 1070.0, 20.0, 2),
        x(FFN, "kernel", 1150.0, 60.0, 3),
        x("Memcpy HtoD (Pinned -> Device)", "gpu_memcpy", 1210.0, 10.0),
        x("bench.anchor", "user_annotation", 1300.0, 2.0),
    ]


def test_parse_union_gaps_and_breakdown():
    data = devtrace.parse(_events(), (0.001, 0.0013))
    assert data.begin == 1001.0 and data.end == 1301.0
    assert data.offset_us == pytest.approx(1.0)  # the anchors read 1,000 and 1,300 us
    assert data.launch_calls == 3  # the launch and the record before the slice are out
    assert len(data.device) == 4
    # Busy: 1040-1090 (two records overlap), 1150-1220.
    assert data.busy_s == pytest.approx(120e-6)
    assert data.gaps() == [(1001.0, 1040.0), (1090.0, 1150.0), (1220.0, 1301.0)]
    ops = dict(devtrace.device_ops(data))
    assert ops["fused_gated_ffn_kernel"] == pytest.approx(100e-6)
    assert ops["at::native::elementwise_kernel"] == pytest.approx(20e-6)
    spans = [("bench.step", a, b) for n, a, b in data.annotations]
    gaps = dict(devtrace.idle_gaps(data, spans))
    assert gaps["bench.step"] == pytest.approx((39 + 60) * 1e-6)
    assert gaps["no span"] == pytest.approx(81e-6)


def test_the_ffn_roofline_reads_each_records_rows_by_its_launch():
    data = devtrace.parse(_events(), (0.001, 0.0013))
    model = {"n_expert": 3, "n_attn_hidden_dim": 256, "n_mlp_num_layers": 4,
             "n_mlp_hidden_dim": 256, "dtype": "float32"}
    ctx = {"kind": "train", "trace": data, "config": {"model": model},
           "step_rows": {4: 49152, 5: 98304}}
    least = sum(costs.least_seconds(*costs.ffn_kernel_cost(model, r, "float32"), "float32")
                for r in (49152, 98304))
    assert readers.ffn_roofline_pct(ctx, "train") == pytest.approx(100 * least / 100e-6)
    assert readers.ffn_roofline_pct(ctx, "serve") is None
    assert readers.idle_pct(ctx, "train") == pytest.approx(100 * (1 - 120 / 300))
    assert readers.idle_pct(dict(ctx, trace=None), "train") is None


def test_a_reader_finds_nothing_without_a_slice():
    ctx = {"kind": "train", "trace": None, "slice_steps": []}
    assert readers.launches_per(ctx, "train") is None
    assert readers.ffn_roofline_pct(ctx, "train") is None
