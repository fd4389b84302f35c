"""The plain reference against the port at a tiny width, on the CPU: the
same seeded weights and meshes, the port on padded, masked batches and the
reference one mesh at a time."""

from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest
import torch

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parents[1]))

from benchmark import common, meshes  # noqa: E402
from benchmark.reference import gnot as ref  # noqa: E402
from gnot_tpu_torch.config import ModelConfig  # noqa: E402
from gnot_tpu_torch.data.batch import MeshSample, collate  # noqa: E402
from gnot_tpu_torch.models.gnot import GNOT, apply_batch  # noqa: E402
from gnot_tpu_torch.train.trainer import batch_loss  # noqa: E402

SEED = 2**31 + 11
TINY = json.loads((HERE / "fixtures" / "configs" / "tiny.json").read_text())


def _setup(ffn_impl: str, n: int = 3, **model):
    cfg = dict(TINY["model"], ffn_impl=ffn_impl, **model)
    pool = meshes.pool(TINY["data"], 6, SEED)[:n]
    weights = common.make_weights(cfg, SEED, "cpu")
    net = GNOT(ModelConfig(**cfg))
    common.load_weights(net, weights)
    batch = collate([MeshSample(coords=m.coords, y=m.y, theta=m.theta, funcs=m.funcs)
                     for m in pool], device="cpu")
    return cfg, pool, weights, net, batch


@pytest.mark.parametrize("ffn_impl", ["xla", "pallas"])
def test_forward_matches_the_port_on_a_padded_masked_batch(ffn_impl):
    cfg, pool, weights, net, batch = _setup(ffn_impl)
    assert batch.coords.shape[1] > max(m.coords.shape[0] for m in pool)  # padded
    with torch.no_grad():
        out = apply_batch(net, batch)
    for i, m in enumerate(pool):
        want = ref.predict(weights, cfg, m, "cpu")
        torch.testing.assert_close(out[i, : m.coords.shape[0]], want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("ffn_impl", ["xla", "pallas"])
def test_loss_and_gradients_match_the_port(ffn_impl):
    cfg, pool, weights, net, batch = _setup(ffn_impl)
    loss = batch_loss(net, batch, "rel_l2")
    loss.backward()
    want, grads = ref.batch_loss_and_grads(weights, cfg, pool, "cpu")
    assert abs(float(loss.detach()) - want) <= 1e-6 * abs(want)
    for name, p in net.named_parameters():
        torch.testing.assert_close(p.grad, grads[name], rtol=1e-4, atol=1e-7)


def test_adamw_follows_torch():
    gen = torch.Generator().manual_seed(3)
    params = {"a": torch.randn(5, 4, generator=gen), "b": torch.randn(4, generator=gen)}
    theirs = {k: torch.nn.Parameter(v.clone()) for k, v in params.items()}
    opt = torch.optim.AdamW(theirs.values(), lr=1e-3, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=0.01, foreach=True)
    mine = ref.AdamW({k: v.clone() for k, v in params.items()}, lr=1e-3, b1=0.9, b2=0.999,
                     eps=1e-8, weight_decay=0.01)
    for _ in range(3):
        grads = {k: torch.randn(v.shape, generator=gen) for k, v in params.items()}
        for k, p in theirs.items():
            p.grad = grads[k].clone()
        opt.step()
        mine.step(grads)
    for k in params:
        torch.testing.assert_close(mine.params[k], theirs[k].detach(), rtol=1e-6, atol=1e-7)


def test_the_reference_follows_three_steps_of_the_trainer():
    from benchmark import spec, train_cell

    fx = HERE / "fixtures"
    cell = spec.cell("tiny.train", bench=fx / "BENCHMARK.json", root=fx)
    st = train_cell.prepare(cell, SEED, "cpu")
    st["feed"].close()
    reading = train_cell.ref_readings(cell, st["weights"], st["checked"], "cpu")
    numbers, _ = train_cell.compare(st["prog"], reading)
    assert numbers["loss_gap"] < 1e-5 and numbers["grad_gap"] < 1e-4
    assert numbers["change_gap_median"] < 1e-3
