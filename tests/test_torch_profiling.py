"""The port's readers of the card's reports, on made-up reports: kernel
times from a profile (``profiling.kernel_times``) and registers and
spills from ``-Xptxas -v`` (``build.ptxas_summary``)."""

from __future__ import annotations

from types import SimpleNamespace

import pytest
import torch

from gnot_tpu_torch import profiling
from gnot_tpu_torch.ops import build


def _fake_profiles(monkeypatch, profiles):
    """``torch.profiler.profile`` handing back ``profiles`` in turn, each
    a list of ``(key, count, self device us)``; no card needed."""
    queue = list(profiles)

    class Profile:
        def __init__(self, **_):
            self.events = queue.pop(0)

        def __enter__(self):
            return self

        def __exit__(self, *_):
            return False

        def key_averages(self):
            return [SimpleNamespace(key=k, count=n, self_device_time_total=us, device_type="CUDA")
                    for k, n, us in self.events]

    monkeypatch.setattr(torch.profiler, "profile", Profile)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *_: None)


def test_kernel_times_is_the_total_over_the_calls_and_flags_lost_records(monkeypatch):
    _fake_profiles(monkeypatch, [
        [("void apply_kernel<32>(ApplyArgs)", 20, 200.0), ("memcpy", 40, 40.0)],
        [("void apply_kernel<32>(ApplyArgs)", 18, 180.0)],
    ])
    logs = []
    times = profiling.kernel_times(lambda: None, iters=20, names=("apply_kernel",), log=logs.append)
    assert times == pytest.approx({"apply_kernel": 0.01, "memcpy": 0.002})
    assert logs == []
    # 18 records over 20 calls: still the total over the calls, and said so.
    times = profiling.kernel_times(lambda: None, iters=20, names=("apply_kernel",), log=logs.append)
    assert times == pytest.approx({"apply_kernel": 0.009})
    assert len(logs) == 1 and "18 records of apply_kernel over 20 calls" in logs[0]


def test_kernel_times_profiles_again_and_gives_up(monkeypatch):
    _fake_profiles(monkeypatch, [[], [("reduce_combine", 20, 20.0)], [("x", 20, 1.0)]])
    logs = []
    assert profiling.kernel_times(lambda: None, attempts=2, names=("reduce_partial",),
                                  log=logs.append) is None
    assert len(logs) == 2 and all("no device time for reduce_partial" in m for m in logs)
    assert profiling.kernel_times(lambda: None, attempts=1, log=logs.append) == pytest.approx(
        {"x": 0.00005})


def test_ptxas_summary_reads_registers_and_spills():
    report = (
        "ptxas info    : Compiling entry function '_Z12apply_kernelILi32EEv9ApplyArgs'\n"
        "ptxas info    : Used 80 registers, used 1 barriers, 50688 bytes smem\n"
        "ptxas info    : 0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 64 registers, used 1 barriers\n"
        "ptxas info    : 16 bytes stack frame, 8 bytes spill stores, 12 bytes spill loads\n"
    )
    assert build.ptxas_summary(report) == ([80, 64], 20)
    assert build.ptxas_summary("") == ([], 0)
