"""Card-only tests of the port's CUDA kernels (``cuda`` marker).

Each test skips itself when torch finds no card. This file imports
neither JAX nor the JAX package, so it also runs on a machine without
them, past the suite's JAX-configuring conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from gnot_tpu_torch.config import Config, DataConfig, ModelConfig, OptimConfig, TrainConfig
from gnot_tpu_torch.data import datasets
from gnot_tpu_torch.data.batch import PackedLoader, PackPlan, collate, pack_collate, pack_prefix
from gnot_tpu_torch.device import resolve_device
from gnot_tpu_torch.models import layers
from gnot_tpu_torch.models.gnot import GNOT, apply_batch
from gnot_tpu_torch.ops import fused_attention as fa
from gnot_tpu_torch.ops import fused_ffn
from gnot_tpu_torch.train.trainer import Trainer


def _card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return resolve_device("cuda")


def _ffn_inputs(seed, b, l, din=16, hid=32, dout=16, e=3, n_layers=2, device="cuda"):
    rng = np.random.default_rng(seed)
    dims = [din] + [hid] * n_layers + [dout]
    kernels = [
        (rng.standard_normal((e, dims[i], dims[i + 1])) * 0.3).astype(np.float32)
        for i in range(n_layers + 1)
    ]
    biases = [rng.standard_normal((e, dims[i + 1])).astype(np.float32) for i in range(n_layers + 1)]
    x = rng.standard_normal((b, l, din)).astype(np.float32)
    logits = rng.standard_normal((b, l, e)).astype(np.float32)
    scores = (np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)).astype(np.float32)
    t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    return t(x), t(scores), [t(k) for k in kernels], [t(bb) for bb in biases]


def _ffn_inputs_dims(seed, b, l, dims, e, device="cuda"):
    """Inputs at the model's init for an arbitrary width stack."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, l, dims[0])).astype(np.float32)
    logits = rng.standard_normal((b, l, e)).astype(np.float32)
    scores = (np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)).astype(np.float32)
    bounds = [1.0 / np.sqrt(d) for d in dims[:-1]]
    kernels = [rng.uniform(-bd, bd, (e, dims[i], dims[i + 1])).astype(np.float32)
               for i, bd in enumerate(bounds)]
    biases = [rng.uniform(-bd, bd, (e, dims[i + 1])).astype(np.float32)
              for i, bd in enumerate(bounds)]
    t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    return t(x), t(scores), [t(k) for k in kernels], [t(bb) for bb in biases]


@pytest.mark.cuda
@pytest.mark.parametrize("gelu", ["tanh", "erf"])
@pytest.mark.parametrize("b,l", [(2, 12), (3, 1000)])  # 3,000 rows: a ragged last tile
def test_kernel_matches_plain_version_on_card(gelu, b, l):
    _card()
    args = _ffn_inputs(5, b, l)
    before = fused_ffn.fused_gated_ffn_kernel.launches
    got = fused_ffn.fused_gated_ffn(*args, gelu_kind=gelu)
    want = fused_ffn.fused_gated_ffn_reference(*args, gelu_kind=gelu)
    torch.cuda.synchronize()
    assert fused_ffn.fused_gated_ffn_kernel.launches == before + 1
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "dims,e,b,l",
    [([16, 16, 16], 3, 2, 50),            # width 16: 240 zero-padded columns
     ([48, 48, 48, 48], 2, 1, 1000),      # width 48: padding inside a half
     ([32, 64, 64, 32], 3, 2, 300),       # the JAX tool's three-Linear stack
     ([256] * 6, 1, 1, 1),                # E = 1, one row
     ([256] * 6, 4, 1, 1000),             # E = 4, 1,000 rows
     ([256] * 6, 3, 3, 1000),             # 3,000 rows, a ragged last tile
     ([64, 256, 128, 16], 2, 2, 100)],    # mixed widths, 16 out
)
def test_kernel_shapes_on_card(dims, e, b, l):
    """Padding (widths 16 and 48), the tool's shape, E = 1 and 4, and 1,
    1,000 and 3,000 rows, for both GELUs, against the plain version."""
    _card()
    args = _ffn_inputs_dims(7, b, l, dims, e)
    for gelu in ("tanh", "erf"):
        got = fused_ffn.fused_gated_ffn_kernel(*args, gelu_kind=gelu)
        want = fused_ffn.fused_gated_ffn_reference(*args, gelu_kind=gelu)
        torch.cuda.synchronize()
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
def test_kernel_sees_an_in_place_weight_update_on_card():
    """The packed image is cached per weight tensor and version: an
    in-place update between two calls changes the output."""
    _card()
    x, s, ks, bs = _ffn_inputs_dims(8, 2, 64, [32, 64, 32], 2)
    ks = [torch.nn.Parameter(k) for k in ks]
    first = fused_ffn.fused_gated_ffn_kernel(x, s, ks, bs).clone()
    with torch.no_grad():
        ks[1].mul_(-0.5)
    second = fused_ffn.fused_gated_ffn_kernel(x, s, ks, bs)
    want = fused_ffn.fused_gated_ffn_reference(x, s, ks, bs)
    torch.cuda.synchronize()
    assert not torch.allclose(first, second)
    torch.testing.assert_close(second, want, rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
def test_kernel_refuses_unsupported_width_on_card():
    _card()
    args = _ffn_inputs(6, 2, 12, hid=24)
    with pytest.raises(ValueError, match="multiples of 16"):
        fused_ffn.fused_gated_ffn(*args)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["elasticity", "inductor2d"])
def test_model_on_card_matches_cpu(name):
    """The whole GNOT with the kernel on the card against the same
    weights on the CPU (the kernel's plain version there)."""
    device = _card()
    samples = datasets.SYNTHETIC[name](3, seed=4, base_points=40)
    cfg = ModelConfig(
        **datasets.infer_model_dims(samples), n_attn_layers=2, n_attn_hidden_dim=32,
        n_mlp_num_layers=2, n_mlp_hidden_dim=32, n_input_hidden_dim=32,
        n_expert=2, n_head=4, ffn_impl="pallas",
    )
    cpu_model = GNOT(cfg, generator=torch.Generator().manual_seed(1)).eval()
    with torch.inference_mode():
        want = apply_batch(cpu_model, collate(samples)).numpy()
        got = apply_batch(cpu_model.to(device), collate(samples, device=device)).cpu().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


# -- parity mode and the packed layout ----------------------------------------


def _small_cfg(samples, **model) -> ModelConfig:
    return ModelConfig(
        **datasets.infer_model_dims(samples), n_attn_layers=2, n_attn_hidden_dim=32,
        n_mlp_num_layers=2, n_mlp_hidden_dim=32, n_input_hidden_dim=32,
        n_expert=2, n_head=4, ffn_impl="pallas", **model,
    )


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["parity", "packed"])
def test_parity_and_packed_forwards_launch_the_kernel_on_card(mode):
    """A parity forward (erf GELU, masks dropped, the interleaved merge)
    and a packed forward launch the kernel twice per block on the card
    and agree with the same weights on the CPU; cuBLAS TF32 stays off
    (JAX's parity ``precision_scope``), and the packed pad tail is
    finite."""
    device = _card()
    samples = datasets.synth_elasticity(5, seed=4, base_points=40)
    attention_mode = "parity" if mode == "parity" else "masked"
    cfg = _small_cfg(samples, attention_mode=attention_mode)
    cpu_model = GNOT(cfg, generator=torch.Generator().manual_seed(1)).eval()
    if mode == "packed":
        batch = PackedLoader(samples, batch_size=5, chunk=16).probe_batch()
    else:
        batch = collate(samples, bucket=False)
    with torch.inference_mode():
        want = apply_batch(cpu_model, batch).numpy()
        before = fused_ffn.fused_gated_ffn_kernel.launches
        got = apply_batch(cpu_model.to(device), batch.to(device)).cpu().numpy()
    assert fused_ffn.fused_gated_ffn_kernel.launches - before == 2 * cfg.n_attn_layers
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [64, 128])
def test_kernel_at_a_packed_launch_shape_on_card(chunk):
    """The kernel at full width on the rows a packed elasticity dispatch
    gives it, pad tokens as zero rows with their gate scores, against its
    plain version; the pad tail is finite."""
    _card()
    samples = datasets.synth_elasticity(16, seed=0)
    plan = PackPlan.for_slices(samples, chunk=chunk, batch_size=4, per_devices=1)
    x, scores, kernels, biases = _ffn_inputs_dims(3, plan.n_rows, plan.row_len, [256] * 6, 3)
    placements = pack_prefix([s.coords.shape[0] for s in samples], plan)
    mask = pack_collate(samples[: len(placements)], placements, n_rows=plan.n_rows,
                        row_len=plan.row_len, chunk=chunk, n_slots=plan.n_slots,
                        pad_funcs=plan.pad_funcs, device="cuda").node_mask
    x = x * mask[..., None]
    for gelu in ("tanh", "erf"):
        got = fused_ffn.fused_gated_ffn_kernel(x, scores, kernels, biases, gelu_kind=gelu)
        want = fused_ffn.fused_gated_ffn_reference(x, scores, kernels, biases, gelu_kind=gelu)
        torch.cuda.synchronize()
        assert torch.isfinite(got[mask == 0]).all()
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


# -- bf16 serving through the FFN kernel -------------------------------------

#: The bf16 kernel against its plain version on the same bf16 inputs: both
#: compute in f32 and round once to bf16, so they differ by at most one
#: bf16 ulp (2^-7 of the value) where their f32 sums round apart.
BF16_ULP = dict(rtol=2.0**-7, atol=1e-6)


def _bf16(args):
    x, scores, kernels, biases = args
    return (x.bfloat16(), scores, [k.bfloat16() for k in kernels],
            [b.bfloat16() for b in biases])


@pytest.mark.cuda
@pytest.mark.parametrize("gelu", ["tanh", "erf"])
@pytest.mark.parametrize("b,l", [(4, 1024), (3, 1000)])  # the serving shape; a ragged tile
def test_bf16_kernel_matches_plain_version_on_card(gelu, b, l):
    _card()
    args = _bf16(_ffn_inputs_dims(21, b, l, [256] * 6, 3))
    before = dict(fused_ffn.fused_gated_ffn_kernel.launches_by_dtype)
    got = fused_ffn.fused_gated_ffn(*args, gelu_kind=gelu)
    want = fused_ffn.fused_gated_ffn_reference(*args, gelu_kind=gelu)
    torch.cuda.synchronize()
    after = fused_ffn.fused_gated_ffn_kernel.launches_by_dtype
    assert after["bf16"] == before.get("bf16", 0) + 1
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), **BF16_ULP)


@pytest.mark.cuda
@pytest.mark.parametrize("gelu", ["tanh", "erf"])
@pytest.mark.parametrize("b,l", [(4, 1024), (3, 1000)])  # the training shape; a ragged tile
def test_training_mix_kernel_is_the_f32_kernel_rounded_once_on_card(gelu, b, l):
    """bf16 x with the f32 weights and biases (bf16 training): bitwise the
    f32 instance on the widened x with its output rounded to bf16 (the
    same products, the lo weight image included, and one rounding at the
    store), and within one bf16 ulp of the plain version."""
    _card()
    x, scores, ks, bs = _ffn_inputs_dims(23, b, l, [256] * 6, 3)
    x = x.bfloat16()
    before = dict(fused_ffn.fused_gated_ffn_kernel.launches_by_dtype)
    got = fused_ffn.fused_gated_ffn(x, scores, ks, bs, gelu_kind=gelu)
    f32 = fused_ffn.fused_gated_ffn_kernel(x.float(), scores, ks, bs, gelu_kind=gelu)
    want = fused_ffn.fused_gated_ffn_reference(x, scores, ks, bs, gelu_kind=gelu)
    torch.cuda.synchronize()
    after = fused_ffn.fused_gated_ffn_kernel.launches_by_dtype
    assert after["bf16-x/f32-w"] == before.get("bf16-x/f32-w", 0) + 1
    assert after["f32"] == before.get("f32", 0) + 1
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert torch.equal(got, f32.bfloat16())
    torch.testing.assert_close(got.float(), want.float(), **BF16_ULP)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "mix", ["f16", "bf16_scores", "bf16_x_f32_weights_bf16_biases", "f32_x_bf16_weights"])
def test_kernel_refuses_dtypes_outside_the_jax_mix_on_card(mix):
    _card()
    x, scores, ks, bs = _ffn_inputs_dims(22, 2, 64, [32, 64, 32], 2)
    if mix == "f16":
        x, ks, bs = x.half(), [k.half() for k in ks], [b.half() for b in bs]
    elif mix == "bf16_scores":
        x, scores, ks, bs = _bf16((x, scores, ks, bs))
        scores = scores.bfloat16()
    elif mix == "bf16_x_f32_weights_bf16_biases":
        x, bs = x.bfloat16(), [b.bfloat16() for b in bs]
    else:
        ks, bs = [k.bfloat16() for k in ks], [b.bfloat16() for b in bs]
    with pytest.raises(ValueError, match="float32 x, weights and biases, or bfloat16"):
        fused_ffn.fused_gated_ffn_kernel(x, scores, ks, bs)
    # The model's predicate reads shapes only: the mix reaches the
    # wrapper through the model's FFN and raises there too.
    assert fused_ffn.kernel_takes(x, scores, ks, bs)
    with pytest.raises(ValueError, match="float32 x, weights and biases, or bfloat16"):
        fused_ffn.fused_gated_ffn(x, scores, ks, bs)


@pytest.mark.cuda
def test_width_512_serves_through_the_torch_path_on_card():
    """``--ffn_impl pallas`` at width 512 (the FFN's width is
    ``--n_mlp_hidden_dim``, which the residual ties to the other two):
    widths the kernel does not take run the torch FFN path (0 launches),
    as the JAX model's ``fits_vmem`` guard does, instead of raising."""
    from gnot_tpu_torch import main as port_main

    _card()
    argv = ["--serve", "--ffn_impl", "pallas", "--n_mlp_hidden_dim", "512",
            "--n_attn_hidden_dim", "512", "--n_input_hidden_dim", "512",
            "--n_attn_layers", "1", "--synthetic", "elasticity", "--synth_size", "40",
            "--n_test", "4", "--device", "cuda"]
    before = fused_ffn.fused_gated_ffn_kernel.launches
    run = port_main.run_serve(port_main.build_parser().parse_args(argv))
    assert fused_ffn.fused_gated_ffn_kernel.launches == before
    assert run.summary["completed"] == 4 and all(r.ok for r in run.results)
    assert all(np.all(np.isfinite(r.output)) for r in run.results)


@pytest.mark.cuda
def test_bf16_publish_packs_once_not_per_dispatch_on_card():
    """A bf16 engine packs the published copy's expert weights at its first
    dispatch and never again until the next publish."""
    from gnot_tpu_torch.serve.engine import InferenceEngine

    device = _card()
    samples = datasets.synth_elasticity(4, seed=4, base_points=40)
    cfg = ModelConfig(
        **datasets.infer_model_dims(samples), n_attn_layers=2, n_attn_hidden_dim=32,
        n_mlp_num_layers=2, n_mlp_hidden_dim=32, n_input_hidden_dim=32,
        n_expert=2, n_head=4, ffn_impl="pallas",
    )
    model = GNOT(cfg, generator=torch.Generator().manual_seed(2)).to(device)
    eng = InferenceEngine(model, batch_size=4, dtype="bfloat16")
    n_images = 2 * cfg.n_attn_layers * (cfg.n_mlp_num_layers + 1)
    key = eng.bucket_key(samples[0])

    def dispatch():
        return eng.infer(samples[:1], pad_nodes=key[0], pad_funcs=key[1], rows=4)[0]

    packs, launches = fused_ffn.packed_weights.packs, fused_ffn.fused_gated_ffn_kernel.launches
    bf16 = fused_ffn.fused_gated_ffn_kernel.launches_by_dtype.get("bf16", 0)
    first = dispatch()
    for _ in range(3):
        dispatch()
    assert fused_ffn.packed_weights.packs - packs == n_images
    assert fused_ffn.fused_gated_ffn_kernel.launches - launches == 4 * 2 * cfg.n_attn_layers
    assert (fused_ffn.fused_gated_ffn_kernel.launches_by_dtype["bf16"] - bf16
            == 4 * 2 * cfg.n_attn_layers)
    assert first.dtype == np.float32 and np.all(np.isfinite(first))
    with torch.no_grad():
        for p in model.parameters():
            p.mul_(0.5)
    eng.swap_params(model.state_dict())
    assert not np.allclose(dispatch(), first)
    dispatch()
    assert fused_ffn.packed_weights.packs - packs == 2 * n_images


# -- training through the FFN kernel ---------------------------------------


def _trainer_on_card(width: int, n_head: int, **model) -> Trainer:
    samples = datasets.synth_elasticity(4, seed=9, base_points=300)  # ragged, 210-390 points
    mc = ModelConfig(
        **datasets.infer_model_dims(samples), n_attn_layers=2, n_attn_hidden_dim=width,
        n_mlp_num_layers=4, n_mlp_hidden_dim=width, n_input_hidden_dim=width,
        n_expert=3, n_head=n_head, ffn_impl="pallas", **model,
    )
    trainer = Trainer(Config(data=DataConfig(n_train=4), train=TrainConfig(epochs=1)),
                      mc, samples, [], device="cuda")
    trainer.initialize()
    return trainer


@pytest.mark.cuda
@pytest.mark.parametrize("width,n_head", [(32, 4), (256, 8)])
def test_train_step_through_the_kernel_matches_the_plain_ffn_on_card(width, n_head, monkeypatch):
    """One AdamW step with every FFN forward in the kernel, and one from
    the same weights and batch with the plain version: the same loss and
    gradients (the backward is the same plain code; only the forward's
    3xTF32 rounding differs)."""
    _card()
    kernel_run, plain_run = _trainer_on_card(width, n_head), _trainer_on_card(width, n_head)
    batch = next(iter(kernel_run.train_loader))
    before = fused_ffn.fused_gated_ffn_kernel.launches
    loss = kernel_run.train_step(batch, 1e-3)
    assert fused_ffn.fused_gated_ffn_kernel.launches == before + 2 * 2  # 2 FFNs x 2 blocks
    monkeypatch.setattr(layers, "fused_gated_ffn", fused_ffn.fused_gated_ffn_reference)
    want = plain_run.train_step(batch, 1e-3)  # graftlint: disable=GL001 — the port's Trainer.train_step donates nothing; the host batch stays whole
    assert fused_ffn.fused_gated_ffn_kernel.launches == before + 4
    torch.testing.assert_close(loss, want, rtol=1e-4, atol=1e-5)
    plain_grads = dict(plain_run.model.named_parameters())
    for name, p in kernel_run.model.named_parameters():
        assert torch.isfinite(p.grad).all(), name
        torch.testing.assert_close(p.grad, plain_grads[name].grad, rtol=1e-4, atol=1e-5,
                                   msg=lambda m, name=name: f"{name}: {m}")


#: bf16 training through the kernel vs through the plain version, the
#: same weights and batch: the forward differs only where the kernel's and
#: the plain version's f32 sums round to bf16 apart (a one-ulp flip in a
#: few elements in ten thousand at full width), and the backward is the
#: same plain code. Relative norm of the loss and of all gradients.
BF16_STEP_REL = 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("width,n_head", [(32, 4), (256, 8)])
def test_bf16_train_step_through_the_kernel_matches_the_plain_ffn_on_card(
        width, n_head, monkeypatch):
    """One bf16 AdamW step (``dtype="bfloat16"``) with every FFN forward in
    the kernel's training mix, and one from the same weights and batch
    with the plain version: the loss and gradients agree at
    ``BF16_STEP_REL``, every launch is of the bf16-x/f32-w mix, and the
    gradients are f32."""
    _card()
    kernel_run = _trainer_on_card(width, n_head, dtype="bfloat16")
    plain_run = _trainer_on_card(width, n_head, dtype="bfloat16")
    batch = next(iter(kernel_run.train_loader))
    before = dict(fused_ffn.fused_gated_ffn_kernel.launches_by_dtype)
    loss = kernel_run.train_step(batch, 1e-3)
    after = fused_ffn.fused_gated_ffn_kernel.launches_by_dtype
    assert {k: v - before.get(k, 0) for k, v in after.items() if v != before.get(k, 0)} == {
        "bf16-x/f32-w": 2 * 2}
    monkeypatch.setattr(layers, "fused_gated_ffn", fused_ffn.fused_gated_ffn_reference)
    want = plain_run.train_step(batch, 1e-3)  # graftlint: disable=GL001 — the port's Trainer.train_step donates nothing; the host batch stays whole
    assert torch.isfinite(loss) and abs(float(loss) / float(want) - 1) <= BF16_STEP_REL
    plain_grads = dict(plain_run.model.named_parameters())
    got = torch.cat([p.grad.flatten() for _, p in kernel_run.model.named_parameters()])
    ref = torch.cat([plain_grads[n].grad.flatten() for n, _ in kernel_run.model.named_parameters()])
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    assert float((got - ref).norm() / ref.norm()) <= BF16_STEP_REL


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_remat_step_launches_twice_and_packs_once_on_card(dtype):
    """A ``remat`` train step runs each block's forward again in the
    backward: 2 FFNs x 2 blocks x 2 = 8 launches, and the recompute finds
    the weight images the forward packed (their version has not moved):
    one pack per expert weight per step, as without remat."""
    _card()
    trainer = _trainer_on_card(32, 4, dtype=dtype, remat=True)
    n_images = 2 * 2 * (4 + 1)
    batch = next(iter(trainer.train_loader))
    for _ in range(2):
        launches, packs = fused_ffn.fused_gated_ffn_kernel.launches, fused_ffn.packed_weights.packs
        loss = trainer.train_step(batch, 1e-3)  # graftlint: disable=GL001 — the port's Trainer.train_step donates nothing
        assert fused_ffn.fused_gated_ffn_kernel.launches - launches == 2 * 2 * 2
        assert fused_ffn.packed_weights.packs - packs == n_images
        assert torch.isfinite(loss)


def _optim_trainer_on_card(width: int, n_head: int, **optim) -> Trainer:
    samples = datasets.synth_elasticity(4, seed=9, base_points=300)
    mc = ModelConfig(
        **datasets.infer_model_dims(samples), n_attn_layers=2, n_attn_hidden_dim=width,
        n_mlp_num_layers=4, n_mlp_hidden_dim=width, n_input_hidden_dim=width,
        n_expert=3, n_head=n_head, ffn_impl="pallas",
    )
    cfg = Config(optim=OptimConfig(**optim), data=DataConfig(n_train=4),
                 train=TrainConfig(epochs=1))
    trainer = Trainer(cfg, mc, samples, [], device="cuda")
    trainer.initialize()
    return trainer


@pytest.mark.cuda
@pytest.mark.parametrize("width,n_head", [(32, 4), (256, 8)])
def test_flat_layout_step_through_the_kernel_on_card(width, n_head):
    """A train step of the flat layout through the kernel: every weight and
    bias the kernel reads is a view of the flat buffer at a 16-byte
    boundary, so it launches (2 FFNs x 2 blocks) with no alignment error,
    and the step agrees with the tree layout's from the same weights."""
    _card()
    flat = _optim_trainer_on_card(width, n_head, flat_params=True)
    tree = _optim_trainer_on_card(width, n_head)
    for name, p in flat.model.named_parameters():
        assert p.data_ptr() % 16 == 0, name
    batch = next(iter(flat.train_loader))
    before = fused_ffn.fused_gated_ffn_kernel.launches
    losses = [flat.train_step(batch, 1e-3) for _ in range(2)]  # graftlint: disable=GL001 — the port's Trainer.train_step donates nothing
    assert fused_ffn.fused_gated_ffn_kernel.launches == before + 2 * 2 * 2
    want = [tree.train_step(batch, 1e-3) for _ in range(2)]  # graftlint: disable=GL001 — the port's Trainer.train_step donates nothing
    torch.testing.assert_close(torch.stack(losses), torch.stack(want), rtol=1e-4, atol=1e-5)
    tree_params = tree.model.state_dict()
    for name, p in flat.model.state_dict().items():
        torch.testing.assert_close(p, tree_params[name], rtol=1e-4, atol=1e-5,
                                   msg=lambda m, name=name: f"{name}: {m}")


@pytest.mark.cuda
def test_kernel_reads_the_live_flat_weights_after_a_step_on_card():
    """After AdamW writes the flat buffer (torch's default implementation on
    the card) every FFN weight's version has moved: the kernel repacks,
    its output moves, and it agrees with the plain version on the live
    flat weights."""
    _card()
    trainer = _optim_trainer_on_card(64, 4, flat_params=True)
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((2, 300, 64), dtype=np.float32)).cuda()
    scores = torch.softmax(torch.from_numpy(rng.standard_normal((2, 300, 3), dtype=np.float32)), -1).cuda()
    ffns = [m for m in trainer.model.modules() if isinstance(m, layers.GatedExpertFfn)]
    weights = [([l.kernel for l in f.experts.layers()], [l.bias for l in f.experts.layers()]) for f in ffns]
    first = [fused_ffn.fused_gated_ffn_kernel(x, scores, k, b).clone() for k, b in weights]
    trainer.train_step(next(iter(trainer.train_loader)), 1e-2)
    for (k, b), old in zip(weights, first):
        got = fused_ffn.fused_gated_ffn_kernel(x, scores, k, b)
        want = fused_ffn.fused_gated_ffn_reference(x, scores, k, b)
        torch.cuda.synchronize()
        assert not torch.allclose(got, old)
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
def test_grad_accum_packs_once_per_update_on_card():
    """grad_accum=2: each micro-step launches 2 FFNs x 2 blocks; the
    micro-step after an update (and the first) packs every expert weight
    once, the one after it packs none."""
    _card()
    trainer = _optim_trainer_on_card(32, 4, grad_accum=2)
    n_images = 2 * 2 * (4 + 1)
    batch = next(iter(trainer.train_loader))
    for micro in range(4):
        launches, packs = fused_ffn.fused_gated_ffn_kernel.launches, fused_ffn.packed_weights.packs
        trainer.train_step(batch, 1e-3)  # graftlint: disable=GL001 — the port's Trainer.train_step donates nothing
        assert fused_ffn.fused_gated_ffn_kernel.launches - launches == 2 * 2
        assert fused_ffn.packed_weights.packs - packs == (n_images if micro % 2 == 0 else 0)
    assert trainer.gradient_step == 2


@pytest.mark.cuda
def test_kernel_reads_the_weights_the_optimizer_wrote_on_card():
    """The trainer's AdamW step (torch's default implementation on the
    card) moves every expert weight's version, so the kernel's next call
    repacks and agrees with the plain version on the live weights."""
    _card()
    trainer = _trainer_on_card(64, 4)
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((2, 300, 64), dtype=np.float32)).cuda()
    scores = torch.softmax(torch.from_numpy(rng.standard_normal((2, 300, 3), dtype=np.float32)), -1).cuda()
    ffns = [m for m in trainer.model.modules() if isinstance(m, layers.GatedExpertFfn)]
    weights = [([l.kernel for l in f.experts.layers()], [l.bias for l in f.experts.layers()]) for f in ffns]
    first = [fused_ffn.fused_gated_ffn_kernel(x, scores, k, b).clone() for k, b in weights]
    trainer.train_step(next(iter(trainer.train_loader)), 1e-2)
    for (k, b), old in zip(weights, first):
        got = fused_ffn.fused_gated_ffn_kernel(x, scores, k, b)
        want = fused_ffn.fused_gated_ffn_reference(x, scores, k, b)
        torch.cuda.synchronize()
        assert not torch.allclose(got, old)
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("impl", ["foreach", "for-loop", "fused"])
def test_which_adamw_implementations_refresh_the_packed_image_on_card(impl):
    """torch's foreach and for-loop AdamW write a weight through in-place
    ops that move its version, so the kernel's cached image is made
    again. The fused implementation leaves the version where it was: the
    kernel would read the old weights, so the trainer never fuses. Should
    a torch release change that, this test says so."""
    _card()
    rng = np.random.default_rng(12)
    kernel = torch.nn.Parameter(torch.from_numpy(rng.uniform(-0.2, 0.2, (3, 64, 64)).astype(np.float32)).cuda())
    image = fused_ffn.packed_weights(kernel)
    kw = {"foreach": dict(foreach=True), "fused": dict(fused=True), "for-loop": dict(foreach=False)}[impl]
    opt = torch.optim.AdamW([kernel], lr=1e-2, **kw)
    kernel.grad = torch.randn_like(kernel)
    version = kernel._version
    opt.step()
    if impl == "fused":
        assert kernel._version == version
        assert fused_ffn.packed_weights(kernel) is image  # stale
        return
    fresh = fused_ffn.packed_weights(kernel)
    assert fresh is not image
    assert torch.equal(fresh, fused_ffn.pack_weights(kernel.detach()))


@pytest.mark.cuda
def test_a_train_step_never_waits_for_the_card():
    """No stream synchronisation inside a train step (torch's sync debug
    mode raises on one): the pinned batch copy, the repack of every
    expert weight, the kernel launches, the backward and AdamW are all
    enqueued; the loss stays on the card."""
    _card()
    trainer = _trainer_on_card(64, 4)
    batch = next(iter(trainer.train_loader))
    assert batch.coords.is_pinned()
    trainer.train_step(batch, 1e-3)  # first use: library handles, workspaces
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        loss = trainer.train_step(batch, 1e-3)  # graftlint: disable=GL001 — the port's Trainer.train_step donates nothing
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert loss.is_cuda and torch.isfinite(loss)
    assert trainer.optimizer.defaults["fused"] is False


@pytest.mark.cuda
def test_a_telemetry_step_never_waits_for_the_card():
    """The telemetry step (``obs/telemetry.py``) adds no stream
    synchronisation either: its norms, gate stats and pad waste stay on
    the card and the buffer's append copies nothing. Then one drain
    writes the step records from one device-to-host copy; the step's
    loss is bitwise the plain step's from the same weights."""
    from gnot_tpu_torch.obs.telemetry import TelemetryBuffer

    _card()
    plain, observed = _trainer_on_card(64, 4), _trainer_on_card(64, 4)
    observed.model.load_state_dict(plain.model.state_dict())
    batch = next(iter(plain.train_loader))
    for t in (plain, observed):
        t.train_step(batch, 1e-3)  # first use: library handles, workspaces
    torch.cuda.synchronize()
    records = []

    class Sink:
        def log(self, **record):
            records.append(record)

    buf = TelemetryBuffer(Sink(), log_every=2)
    torch.cuda.set_sync_debug_mode("error")
    try:
        want = plain.train_step(batch, 1e-3)  # graftlint: disable=GL001 — the port's Trainer.train_step donates nothing
        telem = {}
        got = observed.train_step(batch, 1e-3, telem)  # graftlint: disable=GL001 — the port's Trainer.train_step donates nothing
        buf.append(steps=[1], epoch=0, lrs=[1e-3], loss=got, telem=telem, batches=[None])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert all(v.is_cuda for v in telem.values()) and records == []
    assert torch.equal(got, want)
    buf.append(steps=[2], epoch=0, lrs=[1e-3], loss=got, telem=telem, batches=[None])
    assert [r["step"] for r in records] == [2] and buf.drains == 1
    assert abs(sum(records[0]["gate_load/block_1"]) - 1.0) < 1e-5


# -- the four attention kernels ------------------------------------------

# Kernel outputs vs the plain version: f32 both ways, only the summation
# order over Lk and E differs; the softmaxed queries and the gradients
# (the backward is the same plain code) are held tighter.
OUT_TOL = dict(rtol=1e-4, atol=1e-5)
TIGHT_TOL = dict(rtol=1e-5, atol=1e-6)


def _attn_inputs(seed, f, b, l, lk, e, device, outlier=0.0, n_head=4):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, l, e)).astype(np.float32)
    k = rng.standard_normal((f, b, lk, e)).astype(np.float32)
    v = rng.standard_normal((f, b, lk, e)).astype(np.float32)
    q[..., : e // n_head] += outlier
    k[..., : e // n_head] += outlier
    mask = (rng.uniform(size=(f, b, lk)) > 0.3).astype(np.float32)
    t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    return t(q), t(k), t(v), t(mask)


def _packed_inputs(seed, device, e=64, chunk=24):
    """Two rows of six chunks: segments 0 and 1 in row 0, 2 and 3 in row 1,
    pad chunks (id 5), slot 4 empty; ragged segment tails."""
    q, k, v, mask = _attn_inputs(seed, 2, 2, 6 * chunk, 6 * chunk, e, device)
    seg = torch.tensor([[0, 0, 1, 1, 1, 5], [2, 3, 3, 5, 5, 5]], dtype=torch.int32, device=device)
    mask[:, 0, 5 * chunk - 7 :] = 0.0
    mask[:, 1, 3 * chunk - 5 :] = 0.0
    return q, k, v, mask, seg, 5


def _assert_stage(got, want, tols):
    for g, w, tol in zip(got, want, tols):
        assert torch.isfinite(g).all()
        torch.testing.assert_close(g, w, **tol)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "f,b,l,lk,e,n_head,outlier",
    [(2, 2, 300, 200, 64, 4, 0.0),     # the JAX tool's shapes; ragged L and Lk
     (1, 3, 1000, 333, 256, 8, 0.0),   # full width, Lk not a multiple of 32
     (1, 2, 64, 64, 256, 8, 200.0),    # one head's logits 200 above the others'
     (2, 1, 40, 17, 48, 3, 0.0),       # D = 16, E not a multiple of 64
     # F = 3; the apply's softmax runs every column group of a warp, those
     # past E on zeros (E = 48: 6 of 8 groups): a ragged last tile, one
     # whole tile, one row
     (3, 2, 235, 77, 48, 3, 0.0),
     (3, 2, 16, 77, 256, 8, 0.0),
     (3, 1, 1, 77, 256, 8, 0.0)],
)
def test_dense_kernels_match_plain_versions_on_card(f, b, l, lk, e, n_head, outlier):
    device = _card()
    q, k, v, mask = _attn_inputs(1, f, b, l, lk, e, device, outlier, n_head)
    mask[-1, 0] = 0.0  # an all-masked slab
    before = fa.nla_reduce_kernel.launches, fa.nla_apply_kernel.launches
    kv, ksum = fa.nla_reduce(k, v, mask, n_head)
    kv_p, ksum_p = fa.reduce_reference(k, v, mask, n_head)
    out, qs = fa.nla_apply(q, kv_p, ksum_p, n_head)
    out_p, qs_p = fa.apply_reference(q, kv_p, ksum_p, n_head)
    torch.cuda.synchronize()
    assert (fa.nla_reduce_kernel.launches, fa.nla_apply_kernel.launches) == (
        before[0] + 1, before[1] + 1)
    _assert_stage((kv, ksum), (kv_p, ksum_p), (OUT_TOL, OUT_TOL))
    _assert_stage((out, qs), (out_p, qs_p), (OUT_TOL, TIGHT_TOL))
    assert (out[-1, 0] == 0).all()
    again = fa.nla_apply(q, kv_p, ksum_p, n_head)  # two launches bitwise equal
    assert torch.equal(again[0], out) and torch.equal(again[1], qs)


@pytest.mark.cuda
@pytest.mark.parametrize("e,n_head", [(64, 4), (48, 3), (256, 8)])
def test_segment_kernels_match_plain_versions_on_card(e, n_head):
    device = _card()
    q, k, v, mask, seg, n_seg = _packed_inputs(2, device, e=e)
    kv, ksum = fa.nla_reduce_seg(k, v, mask, seg, n_seg, n_head)
    kv_p, ksum_p = fa.reduce_seg_reference(k, v, mask, seg, n_seg, n_head)
    out, qs = fa.nla_apply_seg(q, kv_p, ksum_p, seg, n_head)
    out_p, qs_p = fa.apply_seg_reference(q, kv_p, ksum_p, seg, n_head)
    torch.cuda.synchronize()
    _assert_stage((kv, ksum), (kv_p, ksum_p), (OUT_TOL, OUT_TOL))
    _assert_stage((out, qs), (out_p, qs_p), (OUT_TOL, TIGHT_TOL))
    assert (kv[:, 4] == 0).all() and (ksum[:, 4] == 0).all()  # the empty slot
    assert (out[:, 0, 5 * 24 :] == 0).all() and (out[:, 1, 3 * 24 :] == 0).all()  # pad chunks
    again = fa.nla_apply_seg(q, kv_p, ksum_p, seg, n_head)  # two launches bitwise equal
    assert torch.equal(again[0], out) and torch.equal(again[1], qs)
    # The dense form's qs of the same q, bitwise: one softmax in both forms.
    _, qs_dense = fa.nla_apply(q, *fa.reduce_reference(k, v, mask, n_head), n_head)
    assert torch.equal(qs_dense, qs)


@pytest.mark.cuda
@pytest.mark.parametrize("e,n_head,lk", [(48, 3, 77), (256, 8, 1013)])
def test_reduce_kernels_on_the_tensor_cores_match_plain_versions_on_card(e, n_head, lk):
    """The 3xTF32 mma.sync reduce against its plain version at D=16 and
    D=32, F=2: the dense form at a ragged Lk (not a multiple of 8 or 32,
    so the last 8-row mma step is part padding), the segment form with a
    pad chunk whose rows would change every Gram they entered and an empty
    slot, both exactly 0; two launches on the same inputs bitwise equal."""
    device = _card()
    _, k, v, mask = _attn_inputs(6, 2, 2, 8, lk, e, device, n_head=n_head)
    got = fa.nla_reduce_kernel(k, v, mask, n_head)
    again = fa.nla_reduce_kernel(k, v, mask, n_head)
    _assert_stage(got, fa.reduce_reference(k, v, mask, n_head), (OUT_TOL, OUT_TOL))
    assert all(torch.equal(a, b) for a, b in zip(got, again))

    _, k, v, mask, seg, n_seg = _packed_inputs(7, device, e=e, chunk=40)
    mask[:, 0, 5 * 40 :] = 1.0  # the pad chunk's rows unmasked: only seg keeps them out
    got = fa.nla_reduce_seg_kernel(k, v, mask, seg, n_seg, n_head)
    again = fa.nla_reduce_seg_kernel(k, v, mask, seg, n_seg, n_head)
    _assert_stage(got, fa.reduce_seg_reference(k, v, mask, seg, n_seg, n_head), (OUT_TOL, OUT_TOL))
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert (got[0][:, 4] == 0).all() and (got[1][:, 4] == 0).all()  # the empty slot
    k[:, 0, 5 * 40 :] += 100.0  # the pad chunk's rows moved: its share must be exactly 0
    v[:, 0, 5 * 40 :] *= -3.0
    moved = fa.nla_reduce_seg_kernel(k, v, mask, seg, n_seg, n_head)
    assert all(torch.equal(a, b) for a, b in zip(got, moved))


@pytest.mark.cuda
@pytest.mark.parametrize("packed", [False, True])
def test_attention_gradients_on_card(packed):
    """Gradients wrt q, k and v through the four autograd Functions
    against autograd through the plain versions."""
    device = _card()
    if packed:
        q, k, v, mask, seg, n_seg = _packed_inputs(3, device)
        fused = lambda *a: fa.fused_nla_packed(*a, mask, seg, seg, n_seg, 4)  # noqa: E731
        plain = lambda *a: fa.reference_seg_impl(*a, mask, seg, seg, n_seg, 4)  # noqa: E731
    else:
        q, k, v, mask = _attn_inputs(3, 2, 2, 100, 70, 64, device)
        fused = lambda *a: fa.fused_nla(*a, mask, 4)  # noqa: E731
        plain = lambda *a: fa.reference_impl(*a, mask, 4)  # noqa: E731

    def grads(fn):
        xs = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
        out, qs = fn(*xs)
        return torch.autograd.grad((out**2).sum() + (qs * 0.5).sum(), xs)

    for got, want in zip(grads(fused), grads(plain)):
        torch.testing.assert_close(got, want, **TIGHT_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("what", ["bf16", "head width"])
def test_attention_kernels_refuse_on_card(what):
    device = _card()
    q, k, v, mask, seg, n_seg = _packed_inputs(4, device)
    n_head, match = 4, "float32 only"
    if what == "bf16":
        q, k, v = q.bfloat16(), k.bfloat16(), v.bfloat16()
    else:
        n_head, match = 8, "head widths"  # D = 8
    kv = torch.zeros(2, 2, 64, 64, device=device, dtype=q.dtype)
    ksum = torch.zeros(2, 2, 1, 64, device=device, dtype=q.dtype)
    calls = [
        lambda: fa.nla_reduce_kernel(k, v, mask, n_head),
        lambda: fa.nla_apply_kernel(q, kv, ksum, n_head),
        lambda: fa.nla_reduce_seg_kernel(k, v, mask, seg, n_seg, n_head),
        lambda: fa.nla_apply_seg_kernel(q, kv[:, :1].expand(2, n_seg, 64, 64).contiguous(),
                                        ksum[:, :1].expand(2, n_seg, 1, 64).contiguous(), seg,
                                        n_head),
    ]
    for call in calls:
        with pytest.raises(ValueError, match=match):
            call()


def _state_leaves(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _state_leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _state_leaves(v)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["standard", "flat", "stacked"])
def test_the_recovery_snapshot_round_trips_bitwise_on_card(layout):
    """The supervisor's snapshot of the train state is taken on the card
    with no host sync, survives two in-place AdamW steps, and a rollback
    loads it back bitwise (weights, both moments, the CPU step counts, the
    accumulation mean and counts); the step after the rollback is the
    step the snapshot's own run took. Then the async save's host copy:
    page-locked, bitwise the state once its event has passed."""
    from gnot_tpu_torch.resilience.supervisor import RecoverySupervisor, _copy_state
    from gnot_tpu_torch.train.checkpoint import host_copy

    device = _card()
    samples = datasets.synth_darcy2d(12, seed=4)
    cfg = Config(data=DataConfig(synthetic="darcy2d", n_train=12),
                 optim=OptimConfig(grad_accum=2 if layout == "standard" else 1,
                                   flat_params=layout == "flat"),
                 train=TrainConfig(epochs=1))
    mc = ModelConfig(n_attn_layers=2, n_attn_hidden_dim=32, n_mlp_num_layers=2,
                     n_mlp_hidden_dim=32, n_input_hidden_dim=32, n_expert=2, n_head=4,
                     ffn_impl="xla" if layout == "stacked" else "pallas",
                     scan_layers=layout == "stacked", **datasets.infer_model_dims(samples))
    t = Trainer(cfg, mc, samples, [], device=device)
    t.initialize()
    batches = list(t.train_loader)
    t.train_step(batches[0], 1e-3)
    sup = RecoverySupervisor(snapshot_every=1)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        sup.begin_epoch(t.state_dict, host_step=t.host_step)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    # Copies: AdamW's step counts are CPU tensors it updates in place.
    want = [x.to("cpu", copy=True) for x in _state_leaves(t.state_dict())]
    t.train_step(batches[1], 1e-3)  # graftlint: disable=GL001 — the port's Trainer.train_step donates nothing
    t.train_step(batches[2], 1e-3)  # graftlint: disable=GL001 — the port's Trainer.train_step donates nothing
    t.load_state_dict(sup.rollback().state)
    got = list(_state_leaves(t.state_dict()))
    assert len(got) == len(want) and any(x.is_cuda for x in got)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)
    assert t.host_step == 1
    replay = float(t.train_step(batches[1], 1e-3))  # graftlint: disable=GL001 — the port's Trainer.train_step donates nothing
    t2 = Trainer(cfg, mc, samples, [], device=device)
    t2.initialize()
    t2.train_step(batches[0], 1e-3)  # graftlint: disable=GL001 — the port's Trainer.train_step donates nothing
    assert replay == float(t2.train_step(batches[1], 1e-3))  # graftlint: disable=GL001 — the port's Trainer.train_step donates nothing
    for a, b in zip(_state_leaves(sup._snap.state), want):
        assert torch.equal(a.cpu(), b)  # the held snapshot survived
    owned, ready = host_copy(t.state_dict())
    ready.synchronize()
    leaves = list(_state_leaves(owned))
    assert all(x.device.type == "cpu" for x in leaves)
    assert all(x.is_pinned() for x, y in zip(leaves, _state_leaves(t.state_dict())) if y.is_cuda)
    for a, b in zip(leaves, _state_leaves(_copy_state(t.state_dict()))):
        assert torch.equal(a, b.cpu())


# -- hot reload on the card -----------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_a_reload_repacks_once_and_serves_a_fresh_engine_s_outputs_on_card(dtype, tmp_path):
    """At the reference width (4 blocks, 5 Linears a expert: 40 weight
    images) a hot reload publishes the restored weights in the serving
    dtype; the first dispatch after it repacks the 40 images and no later
    one does; each served output is bitwise a fresh engine's on the
    restored weights."""
    from gnot_tpu_torch.serve.engine import InferenceEngine
    from gnot_tpu_torch.serve.server import CheckpointReloader, InferenceServer
    from gnot_tpu_torch.train.checkpoint import Checkpointer

    device = _card()
    samples = datasets.synth_ns2d(4, seed=3, n_points=200)
    cfg = ModelConfig(**datasets.infer_model_dims(samples), ffn_impl="pallas")
    model = GNOT(cfg, generator=torch.Generator().manual_seed(0)).to(device)
    restored = GNOT(cfg, generator=torch.Generator().manual_seed(1))
    ck = Checkpointer(str(tmp_path / "ck"))
    ck.save_latest({"model": restored.state_dict()}, 2, 0.5)
    ck.wait()
    engine = InferenceEngine(model, batch_size=4, dtype=dtype)
    server = InferenceServer(engine, max_batch=4, max_wait_ms=1.0,
                             reload_fn=CheckpointReloader(ck, model)).start(warmup=samples)
    n_images = 2 * cfg.n_attn_layers * (cfg.n_mlp_num_layers + 1)
    assert n_images == 40
    assert server.submit(samples[0]).result(timeout=60).ok
    packs = fused_ffn.packed_weights.packs
    assert server.reload()
    assert fused_ffn.packed_weights.packs == packs  # the repack waits for a dispatch
    want_dtype = torch.float32 if dtype == "float32" else torch.bfloat16
    published = engine.model.state_dict()
    assert {v.dtype for k, v in published.items() if v.is_floating_point()} == {want_dtype}
    assert all(v.is_cuda for v in published.values())
    got = [server.submit(s).result(timeout=60) for s in samples]
    server.drain(timeout_s=60)
    assert fused_ffn.packed_weights.packs - packs == n_images
    fresh = InferenceEngine(restored.to(device), batch_size=4, dtype=dtype)
    key = fresh.bucket_key(samples[0])
    for r, s in zip(got, samples):
        assert r.ok, r.detail
        want = fresh.infer([s], pad_nodes=key[0], pad_funcs=key[1], rows=4)[0]
        assert np.array_equal(r.output, want)


# -- rollout sessions on the card ---------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_a_rollout_on_card_matches_offline_and_launches_the_kernel(dtype):
    """At the reference width (4 blocks: 8 FFN launches a dispatch) two
    4-step sessions in lockstep launch the kernel 8 times a step dispatch,
    none through the plain FFN, and each served step is within 1e-5 of
    ``offline_rollout`` on the same engine with the rows pinned to the
    server's ``max_batch``."""
    from gnot_tpu_torch.serve.engine import InferenceEngine
    from gnot_tpu_torch.serve.rollout import offline_rollout, parity_check
    from gnot_tpu_torch.serve.server import InferenceServer

    device = _card()
    samples = datasets.synth_ns2d(2, seed=5, n_points=200)
    cfg = ModelConfig(**datasets.infer_model_dims(samples), ffn_impl="pallas")
    model = GNOT(cfg, generator=torch.Generator().manual_seed(0)).to(device)
    engine = InferenceEngine(model, batch_size=4, dtype=dtype)
    server = InferenceServer(engine, max_batch=4, max_wait_ms=1.0)
    futures = [server.submit_rollout(s, 4) for s in samples]
    launches = fused_ffn.fused_gated_ffn_kernel.launches
    server.start()
    results = [f.result(timeout=120) for f in futures]
    summary = server.drain(timeout_s=60)
    launched = fused_ffn.fused_gated_ffn_kernel.launches - launches
    assert all(r.ok and len(r.outputs) == 4 for r in results), [r.reason for r in results]
    assert summary["dispatches"] == 4 and summary["sessions"]["steps"] == 8
    assert launched == 2 * cfg.n_attn_layers * summary["dispatches"] == 32
    for r, s in zip(results, samples):
        want = offline_rollout(engine, s, 4, rows=4)
        assert parity_check(r.outputs, want) <= 1e-5
        assert all(np.all(np.isfinite(o)) for o in r.outputs)


# -- replicas sharing the card ------------------------------------------------------


@pytest.mark.cuda
def test_launch_counters_lose_nothing_under_two_threads_on_two_streams():
    """Two threads, each on its own stream, launch the kernel N times each
    with the interpreter switching threads every microsecond: the total
    and the per-mix and per-GELU counts read exactly 2N more, and every
    launch's output is its plain version's."""
    import sys
    import threading

    device = _card()
    n = 2000
    kernel = fused_ffn.fused_gated_ffn_kernel
    args = _ffn_inputs(11, 1, 64)
    want = fused_ffn.fused_gated_ffn_reference(*args, gelu_kind="tanh")
    before = (kernel.launches, kernel.launches_by_dtype.get("f32", 0),
              kernel.launches_by_gelu.get("tanh", 0))
    outs, errors = [None, None], []

    def launch(i, stream):
        try:
            with torch.cuda.stream(stream):
                for _ in range(n):
                    out = kernel(*args, gelu_kind="tanh")
                stream.synchronize()
                outs[i] = out
        except Exception as err:  # noqa: BLE001 — reported by the test thread
            errors.append(err)

    streams = [torch.cuda.Stream(device=device) for _ in range(2)]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream(device))
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=launch, args=(i, s)) for i, s in enumerate(streams)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
    finally:
        sys.setswitchinterval(old)
    assert not errors and not any(t.is_alive() for t in threads)
    after = (kernel.launches, kernel.launches_by_dtype.get("f32", 0),
             kernel.launches_by_gelu.get("tanh", 0))
    assert [a - b for a, b in zip(after, before)] == [2 * n] * 3
    for out in outs:
        torch.testing.assert_close(out, want, rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
def test_two_replicas_share_the_card_each_on_its_own_stream():
    """``build_replicas`` on the card: each replica its own non-default
    stream and weights copy; eight requests through the router split four
    and four, every output the single engine's (1e-5 / 1e-6), the kernel
    launched 2 x blocks per dispatch and warm-up, summed over both."""
    from gnot_tpu_torch.serve.engine import InferenceEngine
    from gnot_tpu_torch.serve.replica import build_replicas
    from gnot_tpu_torch.serve.router import ReplicaRouter

    device = _card()
    samples = datasets.synth_ns2d(8, seed=3, n_points=200)
    cfg = ModelConfig(**datasets.infer_model_dims(samples), ffn_impl="pallas")
    model = GNOT(cfg, generator=torch.Generator().manual_seed(0)).to(device)
    reps = build_replicas(model, 2, batch_size=4)
    streams = [r.engine.stream for r in reps]
    default = torch.cuda.default_stream(device)
    assert all(s is not None and s != default for s in streams) and streams[0] != streams[1]
    assert all(p.data_ptr() != q.data_ptr() for p, q in zip(
        reps[0].engine.model.parameters(), reps[1].engine.model.parameters()))
    launches = fused_ffn.fused_gated_ffn_kernel.launches
    warmed = sum(r.warm(samples[:1], rows=4) for r in reps)
    router = ReplicaRouter(reps, max_batch=4, max_wait_ms=10_000)
    futures = [router.submit(s) for s in samples]
    router.start()
    results = [f.result(timeout=120) for f in futures]
    summary = router.drain(60)
    launched = fused_ffn.fused_gated_ffn_kernel.launches - launches
    assert all(r.ok for r in results), [r.reason for r in results]
    assert [p["routed"] for p in summary["per_replica"].values()] == [4, 4]
    assert launched == 2 * cfg.n_attn_layers * (summary["dispatches"] + warmed)
    engine = InferenceEngine(model, batch_size=4)
    key = engine.bucket_key(samples[0])
    for i in range(2):
        group = samples[i::2]
        want = engine.infer(group, pad_nodes=key[0], pad_funcs=key[1], rows=4)
        for r, w in zip(results[i::2], want):
            np.testing.assert_allclose(r.output, w, rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
def test_a_replica_the_controller_adds_runs_on_its_own_stream_after_its_copy():
    """``AutoscaleController`` scaling a one-replica pool out on the card:
    the factory's replica gets its own non-default stream and weights copy,
    its warm-up (before it joins) and its dispatches run after the copy on
    that stream and match the single engine (1e-5 / 1e-6), and the kernel
    is launched 2 x blocks per dispatch and warm-up, summed over both."""
    from gnot_tpu_torch.serve.autoscaler import AutoscaleController
    from gnot_tpu_torch.serve.engine import InferenceEngine
    from gnot_tpu_torch.serve.replica import build_replica
    from gnot_tpu_torch.serve.router import ReplicaRouter

    device = _card()
    samples = datasets.synth_ns2d(8, seed=5, n_points=200)
    cfg = ModelConfig(**datasets.infer_model_dims(samples), ffn_impl="pallas")
    model = GNOT(cfg, generator=torch.Generator().manual_seed(0)).to(device)

    def factory(rid, slot):
        return build_replica(model, rid, device, batch_size=4)

    launches = fused_ffn.fused_gated_ffn_kernel.launches
    r0 = factory(0, 0)
    warmed = r0.warm(samples[:1], rows=4)
    router = ReplicaRouter([r0], max_batch=4, max_wait_ms=10_000, route_policy="round_robin")
    c = AutoscaleController(router, replica_factory=factory, max_replicas=2, up_load=4.0,
                            warm_samples=samples[:1], clock=lambda: 0.0)
    queued = [router.submit(s) for s in samples]  # the worker not started: depth 8
    decision = c.tick()
    assert decision["action"] == "scale_up" and decision["warm_source"] == "compile"
    r1 = router.pool()[1]
    warmed += r1.warm_stats["programs"]
    default = torch.cuda.default_stream(device)
    assert r1.engine.stream not in (None, default, r0.engine.stream)
    assert all(p.data_ptr() != q.data_ptr() for p, q in zip(
        r0.engine.model.parameters(), r1.engine.model.parameters()))
    r0.server.start()  # the router started the joining replica's server already
    more = [router.submit(s) for s in samples]
    results = [f.result(timeout=120) for f in queued + more]
    summary = router.drain(60)
    c.close()
    launched = fused_ffn.fused_gated_ffn_kernel.launches - launches
    assert all(r.ok for r in results), [r.reason for r in results]
    assert summary["per_replica"]["1"]["completed"] > 0
    assert launched == 2 * cfg.n_attn_layers * (summary["dispatches"] + warmed)
    engine = InferenceEngine(model, batch_size=4)
    key = engine.bucket_key(samples[0])
    want = [o for i in (0, 4) for o in engine.infer(samples[i:i + 4], pad_nodes=key[0],
                                                     pad_funcs=key[1], rows=4)]
    for r, w in zip(results, want + want):
        np.testing.assert_allclose(r.output, w, rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
def test_two_hosts_on_the_card_serve_as_one_router_does():
    """``build_local_federation`` of two hosts of one replica each on the
    card (in-proc links): eight requests, every output within 1e-5 / 1e-6
    of one ``ReplicaRouter`` over two replicas on the card, the kernel
    launched 2 x blocks per dispatch and warm-up, summed over the hosts."""
    from gnot_tpu_torch.serve.federation import build_local_federation
    from gnot_tpu_torch.serve.replica import build_replicas
    from gnot_tpu_torch.serve.router import ReplicaRouter

    device = _card()
    samples = datasets.synth_ns2d(8, seed=7, n_points=200)
    cfg = ModelConfig(**datasets.infer_model_dims(samples), ffn_impl="pallas")
    model = GNOT(cfg, generator=torch.Generator().manual_seed(0)).to(device)
    reps = build_replicas(model, 2, batch_size=4)
    launches = fused_ffn.fused_gated_ffn_kernel.launches
    warmed = sum(r.warm(samples[:1], rows=4) for r in reps)
    cluster, agents = build_local_federation(
        [[r] for r in reps], router_kwargs=dict(max_batch=4, max_wait_ms=5.0))
    try:
        for a in agents.values():
            a.router.start()
        cluster.tick()
        results = [f.result(timeout=120) for f in [cluster.submit(s) for s in samples]]
        summary = cluster.drain(60)
    finally:
        for a in agents.values():
            a.router.drain(60)
    launched = fused_ffn.fused_gated_ffn_kernel.launches - launches
    assert all(r.ok for r in results), [r.reason for r in results]
    assert (summary["hosts_dead"], summary["protocol_errors"], summary["completed"]) == (0, 0, 8)
    dispatches = sum(h["dispatches"] for h in summary["per_host"].values())
    assert launched == 2 * cfg.n_attn_layers * (dispatches + warmed)
    single = build_replicas(model, 2, batch_size=4)
    router = ReplicaRouter(single, max_batch=4, max_wait_ms=5.0).start()
    want = [f.result(timeout=120) for f in [router.submit(s) for s in samples]]
    router.drain(60)
    for r, w in zip(results, want):
        np.testing.assert_allclose(r.output, w.output, rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
def test_a_host_killed_mid_rollout_leaves_every_session_bitwise_offline(tmp_path):
    """Two hosts on the card, four 6-step sessions; host0's first session
    holds its worker at step 2 while ``host_kill@4`` takes host0 at its
    first heartbeat (after the hello and its two placements); on a stepped clock host0 goes SUSPECT then DEAD and its
    sessions re-migrate to host1 from their persisted snapshots: none lost,
    every trajectory bitwise ``offline_rollout`` on the card."""
    import threading

    from gnot_tpu_torch.resilience.faults import FaultInjector
    from gnot_tpu_torch.serve.engine import InferenceEngine
    from gnot_tpu_torch.serve.federation import build_local_federation
    from gnot_tpu_torch.serve.replica import build_replicas
    from gnot_tpu_torch.serve.rollout import SessionStore, offline_rollout

    device = _card()
    samples = datasets.synth_ns2d(4, seed=9, n_points=200)
    cfg = ModelConfig(**datasets.infer_model_dims(samples), ffn_impl="pallas")
    model = GNOT(cfg, generator=torch.Generator().manual_seed(0)).to(device)
    reps = build_replicas(model, 2, batch_size=4)
    for r in reps:
        r.warm(samples[:1], rows=4)
    now = [100.0]
    fi = FaultInjector.from_spec("host_kill@4")
    reached, gate = threading.Event(), threading.Event()

    def on_step(name, step, out):
        if name == "k0" and step == 2:
            reached.set()
            gate.wait(timeout=60)

    cluster, agents = build_local_federation(
        [[r] for r in reps], clock=lambda: now[0], suspect_after_s=0.2, dead_after_s=0.5,
        session_store=SessionStore(str(tmp_path)), host_faults={"host0": fi, "host1": fi},
        router_kwargs=dict(max_batch=4, max_wait_ms=0.0, wedge_after_s=600.0))
    try:
        for a in agents.values():
            a.router.start()
        futs = [cluster.submit_rollout(s, 6, name=f"k{i}", on_step=on_step)
                for i, s in enumerate(samples)]
        try:
            assert reached.wait(timeout=60)
            for _ in range(5):
                cluster.tick()
                if cluster.host_state("host0") == "dead":
                    break
                now[0] += 0.3
        finally:
            gate.set()
        results = [f.result(timeout=120) for f in futs]
        summary = cluster.drain(60)
    finally:
        for a in agents.values():
            a.router.drain(60)
    assert not agents["host0"].alive and summary["hosts_dead"] == 1
    assert summary["remigrated"] >= 1 and summary["lost"] == 0
    engine = InferenceEngine(model, batch_size=4)
    for r, s in zip(results, samples):
        assert r.ok and len(r.outputs) == 6, (r.reason, r.detail)
        offline = offline_rollout(engine, s, 6, rows=4)
        assert all(np.array_equal(a, b) for a, b in zip(r.outputs, offline, strict=True))
