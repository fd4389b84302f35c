"""The port's training pieces against the JAX package's, one by one:
masked losses, the OneCycle schedule, the epoch loader and one AdamW
update, from the same numpy inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gnot_tpu.config import OptimConfig as JaxOptimConfig
from gnot_tpu.data import datasets as jax_datasets
from gnot_tpu.data.batch import Loader as JaxLoader
from gnot_tpu.ops import segment as jax_segment
from gnot_tpu.train.schedule import make_lr_fn as jax_make_lr_fn
from gnot_tpu.train.trainer import make_optimizer as jax_make_optimizer
from gnot_tpu_torch.config import OptimConfig
from gnot_tpu_torch.data import datasets
from gnot_tpu_torch.data.batch import Loader
from gnot_tpu_torch.ops import segment
from gnot_tpu_torch.train.schedule import make_lr_fn
from gnot_tpu_torch.train.trainer import clip_by_global_norm_, make_optimizer

LOSS_RTOL = 1e-6  # f32 sums of <= 40 terms in another order


def _ragged(seed, b=5, length=40, c=3):
    """Predictions, targets and a ragged 0/1 mask (lengths 1..L)."""
    rng = np.random.default_rng(seed)
    pred = rng.standard_normal((b, length, c)).astype(np.float32)
    tgt = rng.standard_normal((b, length, c)).astype(np.float32)
    lengths = rng.integers(1, length + 1, size=b)
    lengths[0] = length
    mask = (np.arange(length)[None, :] < lengths[:, None]).astype(np.float32)
    return pred, tgt, mask


@pytest.mark.parametrize("name", ["rel_l2", "mse"])
@pytest.mark.parametrize("seed", [0, 1])
def test_losses_match_jax(name, seed):
    pred, tgt, mask = _ragged(seed)
    t = [torch.from_numpy(a) for a in (pred, tgt, mask)]
    j = [jnp.asarray(a) for a in (pred, tgt, mask)]
    np.testing.assert_allclose(
        segment.LOSSES[name](*t).numpy(), np.asarray(jax_segment.LOSSES[name](*j)),
        rtol=LOSS_RTOL,
    )
    np.testing.assert_allclose(
        segment.PER_SAMPLE_LOSSES[name](*t).numpy(),
        np.asarray(jax_segment.PER_SAMPLE_LOSSES[name](*j)),
        rtol=LOSS_RTOL,
    )
    # The batch mean of the per-sample form is the scalar loss.
    np.testing.assert_allclose(
        segment.PER_SAMPLE_LOSSES[name](*t).mean().numpy(),
        segment.LOSSES[name](*t).numpy(), rtol=LOSS_RTOL,
    )


def test_segment_reductions_match_jax_and_ignore_padding():
    pred, _, mask = _ragged(2)
    v, m = torch.from_numpy(pred), torch.from_numpy(mask)
    for port_fn, jax_fn in [
        (segment.masked_segment_sum, jax_segment.masked_segment_sum),
        (segment.masked_segment_mean, jax_segment.masked_segment_mean),
    ]:
        got = port_fn(v, m).numpy()
        np.testing.assert_allclose(
            got, np.asarray(jax_fn(jnp.asarray(pred), jnp.asarray(mask))), rtol=LOSS_RTOL
        )
        garbage = v.clone()
        garbage[m == 0] = 1e6
        np.testing.assert_array_equal(port_fn(garbage, m).numpy(), got)


@pytest.mark.parametrize("parity", [True, False])
def test_lr_schedule_matches_jax(parity):
    """Every (step, epoch) of a grid of run lengths, both schedule modes."""
    for lr, steps_per_epoch, epochs in [(1e-3, 1, 1), (1e-3, 4, 2), (3e-4, 16, 100), (1e-2, 7, 13)]:
        port = make_lr_fn(OptimConfig(lr=lr, parity_schedule_bug=parity),
                          steps_per_epoch=steps_per_epoch, epochs=epochs)
        ref = jax_make_lr_fn(JaxOptimConfig(lr=lr, parity_schedule_bug=parity),
                             steps_per_epoch=steps_per_epoch, epochs=epochs)
        for epoch in range(epochs):
            for step in range(epoch * steps_per_epoch, (epoch + 1) * steps_per_epoch):
                np.testing.assert_allclose(port(step, epoch), ref(step, epoch), rtol=1e-12)
    # The parity bug: the whole first epoch runs at max_lr / div_factor.
    first = make_lr_fn(OptimConfig(), steps_per_epoch=16, epochs=100)
    lrs = {first(s, 0) for s in range(16)}
    assert len(lrs) == 1 and lrs.pop() == pytest.approx(1e-3 / 25, rel=1e-12)


@pytest.mark.parametrize("drop_remainder", [False, True])
@pytest.mark.parametrize("shuffle", [True, False])
def test_loader_matches_jax(shuffle, drop_remainder):
    """Three epochs: the same sample order and bitwise-equal batches."""
    samples = datasets.synth_elasticity(10, seed=5, base_points=70)
    jax_samples = jax_datasets.synth_elasticity(10, seed=5, base_points=70)
    kw = dict(shuffle=shuffle, seed=3, drop_remainder=drop_remainder)
    port, ref = Loader(samples, 4, **kw), JaxLoader(jax_samples, 4, **kw)
    assert len(port) == len(ref) == (2 if drop_remainder else 3)
    orders = []
    for epoch in range(3):
        port.set_epoch(epoch)
        ref.set_epoch(epoch)
        want_idx = ref._epoch_indices()
        got_idx = port.epoch_indices()
        assert [list(i) for i in got_idx] == [list(i) for i in want_idx]
        orders.append(np.concatenate(got_idx).tolist())
        port.set_epoch(epoch)
        ref.set_epoch(epoch)
        batches = list(zip(port, ref, strict=True))
        assert len(batches) == len(port)
        for got, want in batches:
            for field in ("coords", "theta", "y", "node_mask", "funcs", "func_mask"):
                g, w = getattr(got, field).numpy(), np.asarray(getattr(want, field))
                assert g.dtype == w.dtype and g.shape == w.shape, field
                assert g.tobytes() == w.tobytes(), field
    if shuffle:
        assert orders[0] != orders[1] != orders[2]
    else:
        assert orders[0] == orders[1] == list(range(len(orders[0])))


def test_loader_surfaces_collate_errors_and_resumes_order():
    samples = datasets.synth_elasticity(9, seed=6, base_points=30)
    loader = Loader(samples, 2, shuffle=True, seed=1, pad_nodes=8)  # meshes too long
    with pytest.raises(ValueError, match="exceeds max_len"):
        list(loader)
    a = Loader(samples, 2, shuffle=True, seed=1)
    for _ in range(3):
        a.epoch_indices()
    b = Loader(samples, 2, shuffle=True, seed=1)
    b.set_epoch(3)
    assert [list(i) for i in a.epoch_indices()] == [list(i) for i in b.epoch_indices()]


def _params_and_grads(seed):
    rng = np.random.default_rng(seed)
    shapes = {"a": (3, 16, 8), "b": (8,), "c": (5, 7)}
    params = {k: rng.uniform(-0.5, 0.5, s).astype(np.float32) for k, s in shapes.items()}
    grads = [
        {k: (rng.standard_normal(s) * scale).astype(np.float32) for k, s in shapes.items()}
        for scale in (1.0, 0.3, 2.0)
    ]
    return params, grads


@pytest.mark.parametrize("clip", [0.0, 1.5])
def test_adamw_step_matches_optax(clip):
    """Three AdamW updates from the same params and gradients, with and
    without global-norm clipping (the gradients' norms are ~2-15, so
    every update is clipped), against the JAX package's optimizer."""
    params, grads = _params_and_grads(4)
    lr = 1e-3
    cfg = OptimConfig(grad_clip_norm=clip)
    tx = jax_make_optimizer(JaxOptimConfig(grad_clip_norm=clip), lr)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = tx.init(jparams)
    tparams = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    opt = make_optimizer(cfg, tparams.values())
    for g in grads:
        updates, jstate = tx.update({k: jnp.asarray(v) for k, v in g.items()}, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for k, p in tparams.items():
            p.grad = torch.from_numpy(g[k].copy())
        if clip:
            clip_by_global_norm_([p.grad for p in tparams.values()], clip)
        for group in opt.param_groups:
            group["lr"] = lr
        opt.step()
        for k, p in tparams.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jparams[k]), rtol=0, atol=1e-7)


def test_clip_matches_optax_formula():
    _, grads = _params_and_grads(5)
    g = grads[2]
    want, _ = optax.clip_by_global_norm(1.0).update({k: jnp.asarray(v) for k, v in g.items()}, None)
    got = {k: torch.from_numpy(v.copy()) for k, v in g.items()}
    clip_by_global_norm_(list(got.values()), 1.0)
    norm = float(jnp.sqrt(sum(jnp.sum(jnp.square(v)) for v in jax.tree.leaves(want))))
    assert norm == pytest.approx(1.0, rel=1e-6)
    for k in g:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6, atol=1e-9)
    # Below the threshold the gradients pass through untouched.
    small = {k: torch.from_numpy(v.copy()) for k, v in g.items()}
    clip_by_global_norm_(list(small.values()), 1e6)
    for k in g:
        assert small[k].numpy().tobytes() == g[k].tobytes()
