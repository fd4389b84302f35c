"""The port's packing code (``PackPlan``, ``pack_prefix``, ``pack_collate``)
against the JAX package: bitwise on synthetic elasticity and NS2d samples.
The segment tables it makes are the ones the segment attention kernels
take."""

import numpy as np
import pytest

from gnot_tpu.data import batch as jax_batch
from gnot_tpu.data import datasets as jax_datasets
from gnot_tpu_torch.data import batch as port_batch
from gnot_tpu_torch.data import datasets as port_datasets

PLAN_FIELDS = ("row_len", "chunk", "n_rows", "n_slots", "pad_funcs")
BATCH_FIELDS = ("coords", "theta", "y", "node_mask", "node_seg", "funcs", "func_mask", "func_seg")


def _plans(samples_p, samples_j, **kw):
    plan_p = port_batch.PackPlan.from_samples(samples_p, **kw)
    plan_j = jax_batch.PackPlan.from_samples(samples_j, **kw)
    return plan_p, plan_j


@pytest.mark.parametrize(
    "name,n,kw",
    [
        ("elasticity", 16, dict(chunk=128, batch_size=4)),
        ("elasticity", 9, dict(chunk=64, batch_size=3)),
        ("ns2d", 6, dict(chunk=128, batch_size=4)),
        ("ns2d", 5, dict(chunk=256, batch_size=2, n_rows=3)),
        ("elasticity", 7, dict(chunk=128, batch_size=4, row_len=1024)),
    ],
)
def test_plan_prefix_and_collate_bitwise_equal(name, n, kw):
    # NS2d at 300 points keeps the samples small; elasticity is ragged.
    kwargs = {"elasticity": {}, "ns2d": {"n_points": 300}}[name]
    samples_p = port_datasets.SYNTHETIC[name](n, seed=0, **kwargs)
    samples_j = jax_datasets.SYNTHETIC[name](n, seed=0, **kwargs)
    plan_p, plan_j = _plans(samples_p, samples_j, **kw)
    assert [getattr(plan_p, f) for f in PLAN_FIELDS] == [getattr(plan_j, f) for f in PLAN_FIELDS]
    assert plan_p.capacity_tokens == plan_j.capacity_tokens
    sizes = [s.coords.shape[0] for s in samples_p]
    placed_p = port_batch.pack_prefix(sizes, plan_p)
    placed_j = jax_batch.pack_prefix(sizes, plan_j)
    assert placed_p == placed_j and placed_p
    geometry = dict(n_rows=plan_p.n_rows, row_len=plan_p.row_len, chunk=plan_p.chunk,
                    n_slots=plan_p.n_slots, pad_funcs=plan_p.pad_funcs)
    got = port_batch.pack_collate(samples_p[: len(placed_p)], placed_p, **geometry)
    want = jax_batch.pack_collate(samples_j[: len(placed_j)], placed_j, **geometry)
    for field in BATCH_FIELDS:
        a, b = getattr(got, field).numpy(), np.asarray(getattr(want, field))
        assert a.dtype == b.dtype and a.shape == b.shape, field
        np.testing.assert_array_equal(a, b, err_msg=field)
    assert got.n_seg == want.n_seg == plan_p.n_slots
    assert got.n_real_points == want.n_real_points == sum(sizes[: len(placed_p)])


def test_plan_aligned_and_packable_match():
    samples = port_datasets.synth_elasticity(8, seed=3)
    plan_p, plan_j = _plans(samples, jax_datasets.synth_elasticity(8, seed=3), chunk=128)
    for n in (1, 127, 128, 129, 700):
        assert plan_p.aligned(n) == plan_j.aligned(n)
    big = port_batch.MeshSample(
        coords=np.zeros((plan_p.row_len + 1, 2), np.float32),
        y=np.zeros((plan_p.row_len + 1, 2), np.float32), theta=np.ones(2, np.float32),
        funcs=(np.zeros((4, 3), np.float32),),
    )
    wide = port_batch.MeshSample(
        coords=np.zeros((10, 2), np.float32), y=np.zeros((10, 2), np.float32),
        theta=np.ones(2, np.float32), funcs=(np.zeros((plan_p.pad_funcs + 1, 3), np.float32),),
    )
    assert [plan_p.packable(s) for s in (samples[0], big, wide)] == [True, False, False]


def test_prefix_stops_at_the_first_misfit_and_at_the_slot_count():
    plan = port_batch.PackPlan(row_len=512, chunk=128, n_rows=2, n_slots=3, pad_funcs=0)
    # 384 + 384 fill two rows; 256 fits nowhere, so 100 behind it waits.
    assert port_batch.pack_prefix([300, 300, 200, 100], plan) == [(0, 0), (1, 0)]
    assert port_batch.pack_prefix([100] * 8, plan) == [(0, 0), (0, 128), (0, 256)]


@pytest.mark.parametrize(
    "kw,match",
    [(dict(chunk=0), "chunk must be"), (dict(row_len=300), "multiple of chunk"),
     (dict(n_rows=0), "must be >= 1")],
)
def test_plan_refuses_bad_geometry(kw, match):
    args = dict(row_len=512, chunk=128, n_rows=2, n_slots=8, pad_funcs=0) | kw
    with pytest.raises(ValueError, match=match):
        port_batch.PackPlan(**args)
    with pytest.raises(ValueError, match=match):
        jax_batch.PackPlan(**args)
