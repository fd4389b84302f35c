"""A run with its timed path broken underneath reads ``correct: false``.

Each case skips the look for a card and drives the rest of a run of a
tiny fixture cell on the CPU (``run.measure``), once sound and once with
each fault the cell can have: a step that leaves the state unchanged and
half of each batch left out with the mean over the rest (training), an
answer altered where the engine produces it (serving). The cells run on
one chip, so no exchange between chips can be left out.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import pytest
import torch

HERE = Path(__file__).resolve().parent
FIXTURES = HERE / "fixtures"
sys.path.insert(0, str(HERE.parents[1]))

from benchmark import run as run_mod  # noqa: E402
from benchmark import spec  # noqa: E402


def _half_batch(batch_loss):
    def broken(model, batch, loss_name, gates=None, **kw):
        h = max(1, batch.coords.shape[0] // 2)
        cut = type(batch)(coords=batch.coords[:h], theta=batch.theta[:h], y=batch.y[:h],
                          node_mask=batch.node_mask[:h], funcs=batch.funcs[:, :h],
                          func_mask=batch.func_mask[:, :h])
        return batch_loss(model, cut, loss_name, gates, **kw)

    return broken


def _altered(infer):
    def broken(self, samples, **kw):
        outs = infer(self, samples, **kw)
        outs[0] = outs[0] * 1.01
        return outs

    return broken


def _fault(monkeypatch, fault: str) -> None:
    import gnot_tpu_torch.train.trainer as trainer_mod
    from gnot_tpu_torch.serve.engine import InferenceEngine

    if fault == "state_unchanged":
        monkeypatch.setattr(torch.optim.AdamW, "step", lambda self, closure=None: None)
    elif fault == "half_batch":
        monkeypatch.setattr(trainer_mod, "batch_loss", _half_batch(trainer_mod.batch_loss))
    elif fault == "answer_altered":
        monkeypatch.setattr(InferenceEngine, "infer", _altered(InferenceEngine.infer))


@pytest.mark.parametrize("workload,fault", [
    ("tiny.train", None), ("tiny.train", "state_unchanged"), ("tiny.train", "half_batch"),
    ("tiny.serve", None), ("tiny.serve", "answer_altered"),
])
def test_a_broken_timed_path_reads_not_correct(workload, fault, monkeypatch, capsys):
    cell = spec.cell(workload, bench=FIXTURES / "BENCHMARK.json", root=FIXTURES)
    monkeypatch.setattr("benchmark.common.device_info",
                        lambda device, chips: {"platform": "gpu", "kind": "cpu", "count": chips})
    if fault:
        _fault(monkeypatch, fault)
    rc = run_mod.measure(cell, 2**31 + 99, 1.0, False, "cpu", time.perf_counter())
    out, err = capsys.readouterr()
    assert rc == 0
    line = json.loads(out.strip().splitlines()[-1])
    assert line["correct"] is (fault is None), line["checks"]
    assert list(line)[-1] == "checks"
    assert err.strip().splitlines()[-1].startswith("check ")
