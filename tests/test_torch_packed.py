"""The packed layout ("pack, don't pad") in the port against the JAX
package: the plan and the loader's dispatches bitwise, the packed forward,
losses and train steps at the model-level bar, each packed output against
its own solo dispatch, the engine's ``infer_packed`` in f32 and bf16, and
the packed server end to end.

Several samples share each row as chunk-aligned segments; the segment
one-hot maps keep attention and the losses exactly per sample.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

from gnot_tpu import make_config
from gnot_tpu.config import ModelConfig as JaxModelConfig
from gnot_tpu.config import OptimConfig as JaxOptimConfig
from gnot_tpu.data import batch as jax_batch
from gnot_tpu.data import datasets as jax_datasets
from gnot_tpu.models import precision as jax_precision
from gnot_tpu.models.gnot import GNOT as JaxGNOT
from gnot_tpu.models.layers import LinearAttention as JaxLinearAttention
from gnot_tpu.ops import attention as jax_attention
from gnot_tpu.ops import segment as jax_segment
from gnot_tpu.serve.engine import InferenceEngine as JaxEngine
from gnot_tpu.train import trainer as jax_trainer
from gnot_tpu_torch import main as port_main
from gnot_tpu_torch.config import Config, DataConfig, ModelConfig, ServeConfig, TrainConfig
from gnot_tpu_torch.data import batch as port_batch
from gnot_tpu_torch.data import datasets
from gnot_tpu_torch.data.batch import MeshSample, PackedLoader, PackPlan, collate
from gnot_tpu_torch.interop import flatten_tree, params_from_jax
from gnot_tpu_torch.models.gnot import GNOT, apply_batch
from gnot_tpu_torch.models.layers import LinearAttention
from gnot_tpu_torch.ops import attention, segment
from gnot_tpu_torch.serve.batcher import Batcher
from gnot_tpu_torch.serve.engine import InferenceEngine
from gnot_tpu_torch.serve.server import InferenceServer
from gnot_tpu_torch.train.trainer import Trainer

RTOL, ATOL = 1e-4, 1e-5  # the model-level bar
SOLO_RTOL, SOLO_ATOL = 1e-5, 1e-5  # packed vs solo dispatch (tests/test_serve.py:644)
#: bf16 engine vs JAX's bf16 engine run eagerly, per request (the bf16
#: serving bar, tests/test_torch_lowprec.py::ENGINE_REL_BAR).
BF16_ENGINE_REL = 1e-5
MAX_BATCH = 4

SMALL = dict(
    n_attn_layers=2,
    n_attn_hidden_dim=32,
    n_mlp_num_layers=2,
    n_mlp_hidden_dim=32,
    n_input_hidden_dim=32,
    n_expert=2,
    n_head=4,
)
FIELDS = ("coords", "theta", "y", "node_mask", "node_seg", "funcs", "func_mask", "func_seg")


def _f32(a) -> np.ndarray:
    """A torch tensor or a JAX-side array of any float dtype as f32 numpy."""
    if isinstance(a, torch.Tensor):
        return a.float().numpy() if a.is_floating_point() else a.numpy()
    a = np.asarray(a)
    return a if a.dtype == np.int32 else a.astype(np.float32)


def _assert_batches_equal(got, want):
    for name in FIELDS:
        g, w = getattr(got, name), getattr(want, name)
        if w is None:
            assert g is None, name
            continue
        assert tuple(g.shape) == w.shape, name
        np.testing.assert_array_equal(_f32(g), _f32(w), err_msg=name)
    assert got.n_seg == want.n_seg


def _samples(name, n=6, seed=1):
    if name == "elasticity":
        return datasets.synth_elasticity(n, seed=seed, base_points=40)
    return datasets.synth_inductor2d(n, seed=seed, base_points=40)


def _models(samples, **kw):
    """JAX GNOT with params from a packed init, and the port's holding them."""
    mc = dict(SMALL, **datasets.infer_model_dims(samples), **kw)
    jmodel = JaxGNOT(JaxModelConfig(**mc))
    pb = jax_batch.PackedLoader(samples, batch_size=4, chunk=16).probe_batch()
    params = jax.device_get(jax_trainer.init_params(jmodel, pb, 0))
    cfg = ModelConfig(**mc)
    port = GNOT(cfg)
    port.load_state_dict(params_from_jax(params, cfg), strict=True)
    return mc, jmodel, params, port.eval()


def _jax_packed_forward(jmodel, params, pb):
    return np.asarray(jmodel.apply(
        {"params": params}, pb.coords, pb.theta, pb.funcs,
        node_mask=pb.node_mask, func_mask=pb.func_mask,
        node_seg=pb.node_seg, func_seg=pb.func_seg, n_seg=pb.n_seg,
    ))


# -- data -------------------------------------------------------------------------


@pytest.mark.parametrize("per_devices", [1, 3])
def test_pack_plan_for_slices_matches_jax(per_devices):
    samples = datasets.synth_elasticity(9, seed=4)
    kw = dict(chunk=64, batch_size=4, per_devices=per_devices)
    got, want = PackPlan.for_slices(samples, **kw), jax_batch.PackPlan.for_slices(samples, **kw)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.n_rows % per_devices == 0


@pytest.mark.parametrize(
    "name,n,kw",
    [("elasticity", 37, dict(batch_size=8, chunk=128, shuffle=True, seed=1)),
     ("inductor2d", 11, dict(batch_size=4, chunk=64, shuffle=True, seed=5, row_multiple=2)),
     ("elasticity", 9, dict(batch_size=3, chunk=32))],
)
def test_packed_loader_dispatches_bitwise_equal_to_jax(name, n, kw):
    """Over two epochs the port's loader packs the same dispatches as
    JAX's (placements, then every collated array bitwise), every sample
    once per epoch (tests/test_data.py:345); its length and probe batch
    are JAX's, and the probe moves no epoch."""
    samples = datasets.SYNTHETIC[name](n, seed=2)
    port, jax_l = PackedLoader(samples, **kw), jax_batch.PackedLoader(samples, **kw)
    for attr in ("row_len", "n_rows", "n_slots", "pad_funcs", "chunk"):
        assert getattr(port, attr) == getattr(jax_l, attr), attr
    assert len(port) == len(jax_l)
    _assert_batches_equal(port.probe_batch(), jax_l.probe_batch())
    for epoch in (0, 1):
        port.set_epoch(epoch)
        jax_l.set_epoch(epoch)
        got = list(port)
        want_d = jax_l._epoch_dispatches()
        port.set_epoch(epoch)
        assert port.epoch_dispatches() == want_d
        assert sorted(i for idx, _ in want_d for i in idx) == list(range(n))
        assert len(got) == len(want_d)
        for g, d in zip(got, want_d):
            _assert_batches_equal(g, jax_l._collate_at(d))
            assert g.n_real_points == sum(samples[i].coords.shape[0] for i in d[0])


def test_pack_collate_bf16_is_bitwise_jax():
    samples = datasets.synth_inductor2d(5, seed=3, base_points=60)
    plan = PackPlan.from_samples(samples, chunk=32, batch_size=4)
    placements = port_batch.pack_prefix([s.coords.shape[0] for s in samples], plan)
    geometry = dict(n_rows=plan.n_rows, row_len=plan.row_len, chunk=plan.chunk,
                    n_slots=plan.n_slots, pad_funcs=plan.pad_funcs)
    n = len(placements)
    got = port_batch.pack_collate(samples[:n], placements, dtype="bfloat16", **geometry)
    want = jax_batch.pack_collate(samples[:n], placements, dtype="bfloat16", **geometry)
    assert got.coords.dtype == torch.bfloat16 and got.node_seg.dtype == torch.int32
    _assert_batches_equal(got, want)
    with pytest.raises(ValueError, match="float32|bfloat16"):
        port_batch.pack_collate(samples[:n], placements, dtype="float16", **geometry)


# -- attention and the model ----------------------------------------------------------


@pytest.mark.parametrize("n_funcs", [0, 3], ids=["self", "cross"])
def test_packed_linear_attention_matches_jax(n_funcs):
    """The packed branch of ``LinearAttention`` against JAX's, self mode
    and cross mode with three functions sharing one slot map."""
    rng = np.random.default_rng(6)
    r, length, chunk, s, lf, d, e, h = 2, 48, 8, 5, 7, 8, 16, 4
    seg = np.full((r, length // chunk), s, np.int32)
    seg[0, :2], seg[0, 2:5], seg[1, :3], seg[1, 3] = 0, 1, 2, 3
    mask = np.repeat((seg < s).astype(np.float32), chunk, axis=1)
    mask[0, 13:16] = 0.0  # a segment tail short of its last chunk
    query = rng.standard_normal((r, length, d)).astype(np.float32)
    funcs = fmask = fseg = None
    if n_funcs:
        funcs = rng.standard_normal((n_funcs, s, lf, d)).astype(np.float32)
        fmask = (rng.uniform(size=(n_funcs, s, lf)) > 0.3).astype(np.float32)
        fseg = np.array([[0], [1], [2], [3], [s]], np.int32)  # the last slot empty
    q_oh = np.asarray(jax_attention.segment_one_hot(seg, s))
    kv_oh = np.asarray(jax_attention.segment_one_hot(fseg, s)) if n_funcs else None
    jmod = JaxLinearAttention(e, h, n_funcs)
    kw = dict(query_mask=mask, func_mask=fmask, q_seg_oh=q_oh, kv_seg_oh=kv_oh)
    params = jax.device_get(jmod.init(jax.random.key(2), query, funcs, **kw)["params"])
    want = np.asarray(jmod.apply({"params": params}, query, funcs, **kw))
    port = LinearAttention(e, h, n_funcs, query_dim=d, func_dim=d)
    port.load_state_dict({k: torch.from_numpy(np.asarray(v))
                          for k, v in flatten_tree(params).items()}, strict=True)
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    with torch.no_grad():
        got = port(t(query), t(funcs), query_mask=t(mask), func_mask=t(fmask),
                   q_seg_oh=attention.segment_one_hot(t(seg), s),
                   kv_seg_oh=None if fseg is None else attention.segment_one_hot(t(fseg), s))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    assert np.all(np.isfinite(got.numpy()))


@pytest.mark.parametrize("ffn_impl", ["xla", "pallas"])
@pytest.mark.parametrize("name", ["elasticity", "inductor2d"])
def test_packed_gnot_matches_jax(name, ffn_impl):
    """The packed GNOT forward against JAX's on every dispatch of an
    epoch: one input function (elasticity) and several (inductor2d)."""
    samples = _samples(name)
    mc, jmodel, params, port = _models(samples, ffn_impl=ffn_impl)
    port_l = PackedLoader(samples, batch_size=3, chunk=16)
    jax_l = jax_batch.PackedLoader(samples, batch_size=3, chunk=16)
    for pb, jpb in zip(port_l, jax_l):
        with torch.no_grad():
            got = apply_batch(port, pb).numpy()
        want = _jax_packed_forward(jmodel, params, jpb)
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("ffn_impl", ["xla", "pallas"])
def test_packed_forward_matches_each_solo_forward(ffn_impl):
    """Each sample's rows of a packed forward against its own unpacked
    masked forward (tests/test_model.py:436): segments never mix, theta
    and the input functions route per slot."""
    samples = _samples("elasticity")
    _, _, _, port = _models(samples, ffn_impl=ffn_impl)
    loader = PackedLoader(samples, batch_size=6, chunk=16)
    checked = 0
    for idx, placements in loader.epoch_dispatches():
        pb = loader.collate_at((idx, placements))
        with torch.no_grad():
            out = apply_batch(port, pb).numpy()
            for i, (r, off) in zip(idx, placements):
                n = samples[i].coords.shape[0]
                solo = apply_batch(port, collate([samples[i]], bucket=False)).numpy()
                np.testing.assert_allclose(out[r, off:off + n], solo[0, :n], rtol=2e-4,
                                           atol=2e-5, err_msg=f"sample {i}")
                checked += 1
        pad = pb.node_mask.numpy() == 0
        assert np.all(np.isfinite(out[pad]))  # the pad tail stays finite
    assert checked == len(samples)


def test_packed_parity_is_refused():
    """Parity's interleaved merge mixes rows, so it has no packed form:
    the model, the attention layer and the trainer refuse it
    (tests/test_model.py:507, tests/test_trainer.py:754)."""
    samples = _samples("elasticity", n=2)
    mc = dict(SMALL, **datasets.infer_model_dims(samples), attention_mode="parity")
    pb = PackedLoader(samples, batch_size=2, chunk=16).probe_batch()
    with pytest.raises(ValueError, match="packed"):
        apply_batch(GNOT(ModelConfig(**mc)), pb)
    layer = LinearAttention(8, 2, query_dim=4, parity=True)
    seg_oh = attention.segment_one_hot(torch.zeros(1, 1, dtype=torch.int32), 1)
    with pytest.raises(ValueError, match="packed attention requires parity=False"):
        layer(torch.zeros(1, 8, 4), q_seg_oh=seg_oh)
    cfg = Config(data=DataConfig(packed=True))
    with pytest.raises(ValueError, match="masked"):
        Trainer(cfg, ModelConfig(**mc), samples, samples, device="cpu")


@pytest.mark.parametrize("ffn_impl", ["xla", "pallas"])
def test_packed_remat_gradients_equal_no_remat(ffn_impl):
    """Packed + remat: the segment maps cross the checkpoint as tensors,
    and the loss and every gradient equal the run without remat
    (tests/test_model.py:534)."""
    samples = _samples("elasticity", n=4, seed=0)
    mc, _, params, _ = _models(samples, ffn_impl=ffn_impl)
    pb = PackedLoader(samples, batch_size=4, chunk=16).probe_batch()
    runs = {}
    for remat in (False, True):
        cfg = ModelConfig(**dict(mc, remat=remat))
        model = GNOT(cfg)
        model.load_state_dict(params_from_jax(params, cfg), strict=True)
        loss = segment.packed_rel_l2_loss(apply_batch(model, pb), pb.y, pb.node_mask,
                                          pb.node_seg, pb.n_seg)
        loss.backward()
        runs[remat] = float(loss), {n: p.grad.clone() for n, p in model.named_parameters()}
    np.testing.assert_allclose(runs[True][0], runs[False][0], rtol=1e-6)
    for name, g in runs[True][1].items():
        np.testing.assert_allclose(g.numpy(), runs[False][1][name].numpy(), rtol=1e-6,
                                   atol=1e-12, err_msg=name)


@pytest.mark.parametrize("loss", ["rel_l2", "mse"])
def test_packed_losses_match_jax(loss):
    """``PACKED_LOSSES`` and their gradients against JAX's on a dispatch
    with an empty slot and pad chunks, and the per-segment metric: the
    mean runs over the present samples, an empty slot divides by
    nothing and its gradient stays finite."""
    samples = datasets.synth_elasticity(3, seed=9, base_points=40)
    loader = PackedLoader(samples, batch_size=3, chunk=16)
    pb = loader.probe_batch()
    assert pb.n_seg > len(samples)  # empty slots
    rng = np.random.default_rng(3)
    preds = rng.standard_normal(tuple(pb.y.shape)).astype(np.float32)
    args = (pb.y.numpy(), pb.node_mask.numpy(), pb.node_seg.numpy(), pb.n_seg)
    want, want_g = jax.value_and_grad(
        lambda p: jax_segment.PACKED_LOSSES[loss](p, *args))(preds)
    p = torch.from_numpy(preds).requires_grad_(True)
    got = segment.PACKED_LOSSES[loss](p, pb.y, pb.node_mask, pb.node_seg, pb.n_seg)
    got.backward()
    np.testing.assert_allclose(float(got), float(want), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(want_g), rtol=RTOL, atol=1e-7)
    assert np.all(np.isfinite(p.grad.numpy()))
    per, valid = segment.packed_rel_l2_per_seg(p.detach(), *(pb.y, pb.node_mask,
                                                              pb.node_seg, pb.n_seg))
    jper, jvalid = jax_segment.packed_rel_l2_per_seg(preds, *args)
    np.testing.assert_allclose(per.numpy(), np.asarray(jper), rtol=RTOL, atol=ATOL)
    assert valid.numpy().tolist() == np.asarray(jvalid).tolist()
    assert int(valid.sum()) == len(samples)


# -- training ------------------------------------------------------------------------


@pytest.mark.parametrize("ffn_impl", ["xla", "pallas"])
def test_three_packed_train_steps_match_jax(ffn_impl):
    """Three AdamW steps on the packed loader's shuffled dispatches from
    the same weights: each step's loss, the step-1 gradients and every
    parameter after step 3 against JAX's packed trainer step."""
    samples = datasets.synth_elasticity(10, seed=7, base_points=50)
    mc = dict(SMALL, **datasets.infer_model_dims(samples), ffn_impl=ffn_impl)
    jloader = jax_batch.PackedLoader(samples, 4, chunk=32, shuffle=True, seed=2)
    jbatches = list(jloader)[:3]
    assert len(jbatches) == 3
    lrs = [1e-3, 8e-4, 5e-4]
    jmodel = JaxGNOT(JaxModelConfig(**mc))
    loss_fn = jax_trainer.packed_loss_fn(jmodel, "rel_l2")
    state = jax_trainer.init_state(jmodel, JaxOptimConfig(), jbatches[0], seed=0)
    params0 = jax.tree.map(np.array, jax.device_get(state.params))
    grads1 = flatten_tree(jax.device_get(jax.grad(loss_fn)(state.params, jbatches[0])))
    step = jax_trainer.make_train_step(jmodel, JaxOptimConfig(), "rel_l2", loss_fn=loss_fn)
    want_losses = []
    for batch, lr in zip(jbatches, lrs):
        state, loss = step(state, batch, np.float32(lr))
        want_losses.append(float(loss))
    want_params = flatten_tree(jax.device_get(state.params))

    cfg = Config(data=DataConfig(packed=True, pack_chunk=32, seed=2),
                 train=TrainConfig(epochs=1))
    port = Trainer(cfg, ModelConfig(**mc), samples, [], device="cpu")
    assert isinstance(port.train_loader, PackedLoader)
    port.initialize()
    port.model.load_state_dict(params_from_jax(params0, port.model_cfg), strict=True)
    got_losses = []
    for i, (batch, lr) in enumerate(zip(port.train_loader, lrs)):
        got_losses.append(float(port.train_step(batch, lr)))
        if i == 0:
            for name, p in port.model.named_parameters():
                np.testing.assert_allclose(p.grad.numpy(), grads1[name], rtol=RTOL, atol=ATOL,
                                           err_msg=f"step-1 gradient {name}")
    np.testing.assert_allclose(got_losses, want_losses, rtol=RTOL, atol=ATOL)
    for name, p in port.model.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want_params[name], rtol=RTOL, atol=ATOL,
                                   err_msg=f"parameter {name} after step 3")


def test_packed_eval_matches_jax_and_is_close_to_unpacked_eval():
    """The packed eval metric (the mean over dispatches of the mean over
    the samples each carries) against JAX's packed trainer on the same
    weights at the model-level bar, and within rtol 0.05 of the unpacked
    eval, which groups the same per-sample metric by batch
    (tests/test_trainer.py:727)."""
    data = dict(synthetic="elasticity", synth_size=50, n_train=4, n_test=9, batch_size=3)
    cfg = Config(data=DataConfig(**data, packed=True, pack_chunk=32), train=TrainConfig(epochs=1))
    train, test = datasets.load(cfg.data)
    mc = dict(SMALL, **datasets.infer_model_dims(train))
    jcfg = make_config(**{f"data.{k}": v for k, v in data.items()},
                       **{"data.packed": True, "data.pack_chunk": 32, "train.epochs": 1,
                          "train.graceful_preempt": False})
    jt = jax_trainer.Trainer(dataclasses.replace(jcfg, model=JaxModelConfig(**mc)),
                             JaxModelConfig(**mc), train, test)
    jt.initialize()
    params = jax.device_get(jt.state.params)
    want = jt.evaluate()
    packed = Trainer(cfg, ModelConfig(**mc), train, test, device="cpu")
    padded = Trainer(dataclasses.replace(cfg, data=DataConfig(**data)), ModelConfig(**mc),
                     train, test, device="cpu")
    for t in (packed, padded):
        t.model.load_state_dict(params_from_jax(params, t.model_cfg), strict=True)
    got = packed.evaluate()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, padded.evaluate(), rtol=0.05)


def test_cli_packed_training(capsys):
    argv = ["--device", "cpu", "--synthetic", "elasticity", "--synth_size", "40", "--n_train",
            "8", "--n_test", "4", "--epochs", "2", "--packed", "--pack_chunk", "32",
            "--n_attn_layers", "1", "--n_attn_hidden_dim", "32", "--n_mlp_num_layers", "1",
            "--n_mlp_hidden_dim", "32", "--n_input_hidden_dim", "32", "--n_head", "4",
            "--ffn_impl", "pallas"]
    trainer = port_main.run_train(port_main.build_parser().parse_args(argv))
    assert isinstance(trainer.train_loader, PackedLoader)
    assert trainer.train_loader.chunk == 32 and np.isfinite(trainer.best_metric)
    out = capsys.readouterr().out
    assert "Epoch 1, Test Metric: " in out and "Best Test Metric: " in out
    defaults = port_main.build_parser().parse_args([])
    assert (defaults.packed, defaults.pack_chunk, defaults.serve_packed,
            defaults.serve_pack_chunk) == (False, 128, False, 64)
    assert (DataConfig().pack_chunk, ServeConfig().pack_chunk) == (128, 64)
    with pytest.raises(ValueError, match="multiple of 8"):
        ServeConfig(pack_chunk=12)
    with pytest.raises(ValueError, match="pack_chunk"):
        DataConfig(packed=True, pack_chunk=0)


# -- serving --------------------------------------------------------------------------


def _traffic(sizes, seed=0, f_dim=3, theta_dim=2):
    """Small ragged meshes in the elasticity schema."""
    rng = np.random.default_rng(seed)
    return [
        MeshSample(
            coords=rng.uniform(0, 1, size=(m, 2)).astype(np.float32),
            y=np.zeros((m, 2), np.float32),
            theta=rng.uniform(0.5, 2.0, size=(theta_dim,)).astype(np.float32),
            funcs=(rng.uniform(0, 1, size=(max(4, m // 4), f_dim)).astype(np.float32),),
        )
        for m in sizes
    ]


def _engines(ffn_impl, dtype="float32"):
    samples = _samples("elasticity", n=3)
    mc, jmodel, params, port = _models(samples, ffn_impl=ffn_impl)
    if dtype == "bfloat16":
        jmodel = jax_precision.serve_model(jmodel, dtype)
    return (JaxEngine(jmodel, params, batch_size=MAX_BATCH, dtype=dtype),
            InferenceEngine(port, batch_size=MAX_BATCH, dtype=dtype))


@pytest.mark.parametrize("ffn_impl", ["xla", "pallas"])
def test_engine_infer_packed_matches_jax_and_solo(ffn_impl):
    """``infer_packed`` against JAX's at the model-level bar, and each
    request's rows against its own solo padded dispatch at 1e-5
    (tests/test_serve.py:623); one dispatch shape however full."""
    jeng, eng = _engines(ffn_impl)
    traffic = _traffic([16, 40, 24, 64, 8, 32])
    plan = PackPlan.from_samples(traffic, chunk=8, batch_size=8)
    assert all(plan.packable(s) for s in traffic)
    assert eng.warmup_packed(traffic, plan) == 1
    shapes = eng.dispatch_shapes
    got = eng.infer_packed(traffic, plan)
    want = jeng.infer_packed(traffic, jax_batch.PackPlan(**dataclasses.asdict(plan)))
    assert eng.dispatch_shapes == shapes
    for s, g, w in zip(traffic, got, want):
        assert g.shape == (s.coords.shape[0], 2)
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)
        key = eng.bucket_key(s)
        solo = eng.infer([s], pad_nodes=key[0], pad_funcs=key[1], rows=MAX_BATCH)[0]
        np.testing.assert_allclose(g, solo, rtol=SOLO_RTOL, atol=SOLO_ATOL)
    eng.infer_packed(traffic[:2], plan)
    assert eng.dispatch_shapes == shapes + 1  # the solo buckets, then nothing new
    with pytest.raises(ValueError, match="take_fn"):
        eng.infer_packed(traffic, plan, placements=[(0, 0)])


def test_bf16_packed_serving_matches_jax_bf16_engine():
    """bf16 packed serving: the engine's dtype reaches ``pack_collate``,
    and each request lands within the bf16 serving bar of JAX's bf16 engine run
    eagerly on the same weights."""
    jeng, eng = _engines("pallas", dtype="bfloat16")
    traffic = _traffic([16, 40, 24, 64, 8])
    plan = PackPlan.from_samples(traffic, chunk=8, batch_size=8)
    got = eng.infer_packed(traffic, plan)
    (sig,) = eng._shapes
    assert sig[0][1] == "torch.bfloat16" and sig[4][1] == "torch.int32"
    with jax.disable_jit():
        want = jeng.infer_packed(traffic, jax_batch.PackPlan(**dataclasses.asdict(plan)))
    for g, w in zip(got, want):
        assert g.dtype == np.float32
        rel = float(np.linalg.norm(g - w) / np.linalg.norm(w))
        assert rel <= BF16_ENGINE_REL, rel


def test_batcher_take_fn_prefix_capacity():
    """A take_fn bucket dispatches exactly the FIFO prefix the packer
    says fits: full when that prefix is shorter than its queue; aged
    flushes take whole dispatches; other buckets keep max_batch
    (tests/test_serve.py:590)."""
    def take(key, reqs):
        return None if key != "packed" else min(2, len(reqs))

    b = Batcher(max_batch=8, max_wait_ms=100, key_fn=lambda r: r[0], take_fn=take)
    b.add(("packed", 1), now=0.0)
    b.add(("packed", 2), now=0.01)
    assert b.pop_ready(0.02) == []
    b.add(("packed", 3), now=0.02)
    [(key, reqs)] = b.pop_ready(0.03)
    assert key == "packed" and [r[1] for r in reqs] == [1, 2]
    [(key, reqs)] = b.pop_ready(0.2)
    assert [r[1] for r in reqs] == [3]
    b.add(("pad", 4), now=0.0)
    assert b.pop_ready(0.01) == []
    [(key, reqs)] = b.pop_ready(0.2)
    assert key == "pad" and len(reqs) == 1
    for i in range(5):
        b.add(("packed", i), now=0.5)
    assert [len(r) for _, r in b.pop_ready(0.5, flush_all=True)] == [2, 2, 1]


def test_packed_server_end_to_end():
    """Plan-fitting requests ride packed dispatches, an oversize request
    takes the padded path, every output is exactly its own rows and
    matches its solo dispatch at 1e-5, and the summary's pad-waste
    rollup shows packing filling more than row-per-request padding
    (tests/test_serve.py:650)."""
    _, eng = _engines("pallas")
    small = _traffic([16, 40, 24, 64, 8, 32, 48, 16])
    plan = PackPlan.from_samples(small, chunk=8, batch_size=4)
    oversize = _traffic([plan.row_len + 8], seed=5)[0]
    assert not plan.packable(oversize)
    server = InferenceServer(eng, max_batch=MAX_BATCH, max_wait_ms=5.0, pack_plan=plan)
    server.start(warmup=small + [oversize])
    futures = [server.submit(s) for s in small + [oversize]]
    results = [f.result(timeout=60) for f in futures]
    summary = server.drain()
    assert all(r.ok for r in results), [r.reason for r in results]
    for s, r in zip(small + [oversize], results):
        key = eng.bucket_key(s)
        solo = eng.infer([s], pad_nodes=key[0], pad_funcs=key[1], rows=MAX_BATCH)[0]
        assert r.output.shape == solo.shape == (s.coords.shape[0], 2)
        np.testing.assert_allclose(r.output, solo, rtol=SOLO_RTOL, atol=SOLO_ATOL)
    pw = summary["pad_waste_by_bucket"]
    packed = pw[f"packed:{plan.n_rows}x{plan.row_len}"]
    ob = eng.bucket_key(oversize)
    assert pw[f"{ob[0]}x{ob[1]}"]["real_tokens"] == oversize.coords.shape[0]
    assert packed["real_tokens"] == sum(s.coords.shape[0] for s in small)
    assert packed["fill_frac"] == pytest.approx(packed["real_tokens"] / packed["capacity_tokens"])
    padded_fill = sum(s.coords.shape[0] for s in small) / (
        len(small) * port_batch.bucket_length(max(s.coords.shape[0] for s in small)))
    assert packed["fill_frac"] > padded_fill
    assert summary["dispatches"] == sum(st["dispatches"] for st in pw.values())
    # Warm-up: one dispatch per bucket of the warm-up set, one packed.
    assert server.warmed == len({eng.bucket_key(s) for s in small + [oversize]}) + 1


def test_cli_serve_packed_end_to_end(capsys):
    """``--serve --serve_packed`` on the CPU: the plan comes from the
    traffic, every request is answered, the summary names the plan."""
    argv = ["--serve", "--serve_packed", "--serve_pack_chunk", "16", "--device", "cpu",
            "--synthetic", "elasticity", "--synth_size", "40", "--n_test", "6",
            "--n_attn_layers", "1", "--n_attn_hidden_dim", "32", "--n_mlp_num_layers", "1",
            "--n_mlp_hidden_dim", "32", "--n_input_hidden_dim", "32", "--n_expert", "2",
            "--n_head", "4", "--ffn_impl", "pallas"]
    run = port_main.run_serve(port_main.build_parser().parse_args(argv))
    assert all(r.ok for r in run.results) and len(run.results) == 6
    want = jax_batch.PackPlan.for_slices(run.samples, chunk=16, batch_size=4, per_devices=1)
    assert run.summary["pack_plan"] == dataclasses.asdict(want)
    plan = run.pack_plan
    assert f"packed:{plan.n_rows}x{plan.row_len}" in run.summary["pad_waste_by_bucket"]
    for r, s in zip(run.results, run.samples):
        assert r.output.shape == s.y.shape
