"""The control reads ``correct: false``: the reference put in the program's
place with its products in TF32, held to the float32 reference under the
cell's own limits. On the card only, at smaller meshes than the cells
time (``python3 benchmark/calibrate.py`` reads it at their sizes)."""

from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parents[1]))

from benchmark import common, meshes, serve_cell, spec, train_cell  # noqa: E402
from benchmark.reference import gnot as ref  # noqa: E402

SEEDS = (2**31 + 501, 2**31 + 502, 2**31 + 503)


def _small(cell):
    """The cell with meshes of 1.5-2k points and a pool of 12."""
    data = dict(cell.config["data"], nodes=[1500, 2000], func_points=[120, 160])
    return dataclasses.replace(cell, config=dict(cell.config, data=data),
                               traffic=dict(cell.traffic, pool=12))


def _card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS)
def test_the_tf32_control_fails_the_training_cell(seed):
    device = _card()
    cell = _small(spec.cell("ns2d_ref.train"))
    pool = meshes.pool(cell.config["data"], cell.traffic["pool"], seed)
    weights = common.make_weights(cell.config["model"], seed, device)
    batch = cell.traffic["batch"]
    batches = [pool[k * batch:(k + 1) * batch] for k in range(train_cell.CHECKED_STEPS)]
    r32 = train_cell.ref_readings(cell, weights, batches, device)
    tf32 = train_cell.ref_readings(cell, weights, batches, device, tf32=True)
    numbers, _ = train_cell.compare(tf32, r32)
    correct, checks = common.judge(numbers, cell.limits)
    assert not correct, checks


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS)
def test_the_tf32_control_fails_the_serving_cell(seed):
    device = _card()
    cell = _small(spec.cell("ns2d_ref.serve"))
    model_cfg = cell.config["model"]
    pool = meshes.pool(cell.config["data"], cell.traffic["pool"], seed)
    weights = common.make_weights(model_cfg, seed, device)
    with ref.precision(True):
        done = [(i, 0.0, 0.0, True, ref.predict(weights, model_cfg, m, device).cpu().numpy())
                for i, m in enumerate(pool)]
    numbers, _ = serve_cell.check(done, pool, weights, model_cfg, len(pool), seed, device)
    correct, checks = common.judge(numbers, cell.limits)
    assert not correct, checks
