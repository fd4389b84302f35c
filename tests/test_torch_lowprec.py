"""bf16 serving and bf16 training in the port against the JAX package's
low-precision path.

The precision policy (``models/precision.py`` in both packages) lets bf16
into the block matmuls and activations only: the attention Gram, k_sum
and normalizer stay f32, and so does the output head. Each test takes
the same numpy-seeded inputs (and the same weights, through
``params_from_jax``) through the JAX function and the port's, and states
its bar.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

from gnot_tpu.config import ModelConfig as JaxModelConfig
from gnot_tpu.data import datasets
from gnot_tpu.data.batch import collate as jax_collate
from gnot_tpu.models import precision as jax_precision
from gnot_tpu.models.gnot import GNOT as JaxGNOT
from gnot_tpu.ops import attention as jax_attention
from gnot_tpu.ops.pallas_ffn import fused_gated_ffn as jax_fused_gated_ffn
from gnot_tpu.serve.engine import InferenceEngine as JaxEngine
from gnot_tpu.train.trainer import apply_batch as jax_apply_batch
from gnot_tpu_torch.config import Config, DataConfig, ModelConfig, TrainConfig
from gnot_tpu_torch.data.batch import collate
from gnot_tpu_torch.interop import params_from_jax
from gnot_tpu_torch.models import precision
from gnot_tpu_torch.models.gnot import GNOT, apply_batch
from gnot_tpu_torch.ops import attention
from gnot_tpu_torch.ops import fused_ffn
from gnot_tpu_torch.serve.engine import InferenceEngine
from gnot_tpu_torch.serve.server import InferenceServer
from gnot_tpu_torch.train.trainer import Trainer

#: bf16 attention against f32 (tests/test_lowprec.py:34): the bf16 input
#: quantization alone costs ~2^-9; the policy path stays at that floor.
ATTN_REL_BAR = 3.5e-3
#: The port's bf16 op against JAX's where both compute in f32 and round
#: once to bf16: the f32 sums differ only in order, so the two roundings
#: differ by at most one bf16 ulp (2^-7 of the value).
ONE_ULP = dict(rtol=2.0**-7, atol=1e-6)
#: bf16 model outputs against f32 (tests/test_lowprec.py:212).
MODEL_REL_BAR = 2e-2
MAX_BATCH = 4

SMALL = dict(
    n_attn_layers=1,
    n_attn_hidden_dim=16,
    n_mlp_num_layers=2,
    n_mlp_hidden_dim=16,
    n_input_hidden_dim=16,
    n_expert=2,
    n_head=2,
)


def _rel(a, ref) -> float:
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(a - ref) / np.linalg.norm(ref))


def _f32(a) -> np.ndarray:
    """A JAX or torch array of any float dtype as f32 numpy."""
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _bits(a) -> np.ndarray:
    """bf16 bit patterns as uint16 (no ml_dtypes on the port's side)."""
    if isinstance(a, torch.Tensor):
        return a.contiguous().view(torch.int16).numpy().view(np.uint16)
    return np.asarray(a).view(np.uint16)


# -- the policy object ------------------------------------------------------


def test_policy_pins_f32_sites():
    pol = precision.policy_for("bfloat16")
    assert pol.compute_dtype == pol.weights_dtype == "bfloat16"
    assert pol.accum_dtype == pol.normalizer_dtype == pol.head_dtype == "float32"
    assert pol.tag == "bf16" and precision.policy_for("float32").tag == "f32"
    for site in ("accum_dtype", "normalizer_dtype", "head_dtype"):
        with pytest.raises(ValueError, match="must stay float32"):
            dataclasses.replace(pol, **{site: "bfloat16"})
    with pytest.raises(ValueError, match="unknown serve dtype"):
        precision.policy_for("float16")
    assert len(pol.table()) == 5
    assert [row[:2] for row in pol.table()] == [
        row[:2] for row in jax_precision.policy_for("bfloat16").table()
    ]
    assert precision.torch_dtype("bfloat16") is torch.bfloat16
    assert precision.torch_dtype("float32") is torch.float32


def test_cast_params_is_identity_for_f32_and_copy_for_bf16():
    params = {"dense.kernel": torch.ones(4, 4), "steps": torch.tensor(3, dtype=torch.int32)}
    assert precision.cast_params(params, "float32") is params
    cast = precision.cast_params(params, "bfloat16")
    assert cast["dense.kernel"].dtype == torch.bfloat16
    assert cast["steps"].dtype == torch.int32  # non-float passed through
    # The caller's tensors are never mutated (params stay f32 at rest).
    assert params["dense.kernel"].dtype == torch.float32


def test_model_config_takes_bf16_and_refuses_other_dtypes():
    assert ModelConfig(dtype="bfloat16").dtype == "bfloat16"
    with pytest.raises(ValueError, match="unknown dtype"):
        ModelConfig(dtype="float16")


# -- attention: f32 accumulation and normalizer -----------------------------


def _qkv(seed=0, b=2, h=2, l=2048, d=8):
    """tests/test_lowprec.py's inputs, as numpy."""
    rng = np.random.default_rng(seed)
    q = np.asarray(jax_attention.feature_softmax(
        jnp.asarray(rng.standard_normal((b, h, l, d)), jnp.float32)))
    k = np.asarray(jax_attention.feature_softmax(
        jnp.asarray(rng.standard_normal((b, h, l, d)), jnp.float32)))
    v = rng.standard_normal((b, h, l, d)).astype(np.float32)
    mask = (rng.uniform(size=(b, l)) < 0.8).astype(np.float32)
    return q, k, v, mask


def _bf16_pair(*arrays):
    """Each array as a JAX bf16 array and the torch tensor of the same bits."""
    jx = [jnp.asarray(a).astype(jnp.bfloat16) for a in arrays]
    tx = [torch.from_numpy(np.array(_bits(a))).view(torch.bfloat16) for a in jx]
    return jx, tx


def test_bf16_attention_meets_policy_bar():
    q, k, v, mask = _qkv()
    ref = attention.normalized_linear_attention(
        *map(torch.from_numpy, (q, k, v)), kv_mask=torch.from_numpy(mask)
    )
    (jq, jk, jv), (tq, tk, tv) = _bf16_pair(q, k, v)
    out = attention.normalized_linear_attention(tq, tk, tv, kv_mask=torch.from_numpy(mask))
    assert out.dtype == torch.bfloat16  # q's dtype back; the f32 head casts later
    assert _rel(_f32(out), ref.numpy()) <= ATTN_REL_BAR
    want = jax_attention.normalized_linear_attention(jq, jk, jv, kv_mask=jnp.asarray(mask))
    np.testing.assert_allclose(_f32(out), _f32(want), **ONE_ULP)


def test_f32_attention_is_unchanged_by_the_policy_branch():
    """All-f32 operands take the historical branch: the same result as
    the f32 op on upcast bf16 operands, bitwise, and the JAX f32 op's."""
    q, k, v, mask = _qkv(l=256)
    tq, tk, tv, tm = map(torch.from_numpy, (q, k, v, mask))
    got = attention.normalized_linear_attention(tq, tk, tv, kv_mask=tm)
    assert got.dtype == torch.float32
    want = jax_attention.normalized_linear_attention(q, k, v, kv_mask=jnp.asarray(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    _, (bq, bk, bv) = _bf16_pair(q, k, v)
    lowp = attention.normalized_linear_attention(bq, bk, bv, kv_mask=tm)
    f32 = attention.normalized_linear_attention(bq.float(), bk.float(), bv.float(), kv_mask=tm)
    assert torch.equal(lowp, f32.to(torch.bfloat16))


def test_mutation_bf16_normalizer_is_caught_by_the_bar():
    """The same attention with the normalizer the policy forbids (bf16
    k_sum accumulation and a bf16 denominator) must fail the bar that the
    policy path meets: otherwise the bar guards nothing."""
    q, k, v, mask = _qkv()
    tm = torch.from_numpy(mask)
    ref = attention.normalized_linear_attention(*map(torch.from_numpy, (q, k, v)), kv_mask=tm)
    _, (bq, bk, bv) = _bf16_pair(q, k, v)

    def mutant(q, k, v, kv_mask):
        k = k * kv_mask[:, None, :, None].to(k.dtype)
        k_sum = k.sum(dim=2)  # bf16 accumulation: forbidden
        denom = torch.einsum("bhld,bhd->bhl", q, k_sum)  # bf16 normalizer
        denom = torch.where(denom == 0.0, torch.ones_like(denom), denom)
        kv = torch.einsum("bhld,bhle->bhde", k, v)
        out = torch.einsum("bhld,bhde->bhle", q, kv)
        return out / denom[..., None]

    rel_policy = _rel(_f32(attention.normalized_linear_attention(bq, bk, bv, kv_mask=tm)), ref)
    rel_mutant = _rel(_f32(mutant(bq, bk, bv, tm)), ref)
    assert rel_policy <= ATTN_REL_BAR
    assert rel_mutant > ATTN_REL_BAR, (
        f"bf16-normalizer mutant ({rel_mutant}) passes the {ATTN_REL_BAR} bar"
    )
    assert rel_mutant > 1.3 * rel_policy


def test_bf16_packed_attention_meets_policy_bar():
    rng = np.random.default_rng(3)
    b, h, n, c, d, s = 1, 2, 8, 128, 8, 5
    l = n * c
    q = np.asarray(jax_attention.feature_softmax(
        jnp.asarray(rng.standard_normal((b, h, l, d)), jnp.float32)))
    k = np.asarray(jax_attention.feature_softmax(
        jnp.asarray(rng.standard_normal((b, h, l, d)), jnp.float32)))
    v = rng.standard_normal((b, h, l, d)).astype(np.float32)
    seg = rng.integers(0, s, size=(b, n)).astype(np.int32)
    joh = jax_attention.segment_one_hot(jnp.asarray(seg), s)
    toh = attention.segment_one_hot(torch.from_numpy(seg), s)
    ref = attention.packed_normalized_linear_attention(
        *map(torch.from_numpy, (q, k, v)), q_seg_oh=toh, kv_seg_oh=toh
    )
    (jq, jk, jv), (tq, tk, tv) = _bf16_pair(q, k, v)
    out = attention.packed_normalized_linear_attention(tq, tk, tv, q_seg_oh=toh, kv_seg_oh=toh)
    assert out.dtype == torch.bfloat16
    assert _rel(_f32(out), ref.numpy()) <= ATTN_REL_BAR
    want = jax_attention.packed_normalized_linear_attention(
        jq, jk, jv, q_seg_oh=joh, kv_seg_oh=joh
    )
    np.testing.assert_allclose(_f32(out), _f32(want), **ONE_ULP)


# -- the FFN kernel's plain version on the bf16 mix ---------------------------


def _ffn_bf16_inputs(seed, b=2, l=40, dims=(32, 32, 32, 32), e=3):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, l, dims[0])).astype(np.float32)
    logits = rng.standard_normal((b, l, e))
    scores = (np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)).astype(np.float32)
    bounds = [1.0 / np.sqrt(d) for d in dims[:-1]]
    kernels = [rng.uniform(-bd, bd, (e, dims[i], dims[i + 1])).astype(np.float32)
               for i, bd in enumerate(bounds)]
    biases = [rng.uniform(-bd, bd, (e, dims[i + 1])).astype(np.float32)
              for i, bd in enumerate(bounds)]
    (jx, *jw), (tx, *tw) = _bf16_pair(x, *kernels, *biases)
    n = len(kernels)
    return (jx, jnp.asarray(scores), jw[:n], jw[n:]), (tx, torch.from_numpy(scores), tw[:n], tw[n:])


@pytest.mark.parametrize("gelu", ["tanh", "erf"])
def test_ffn_plain_version_on_bf16_matches_the_interpreted_tpu_kernel(gelu, monkeypatch):
    """bf16 x, weights and biases with f32 scores, the mix the bf16 JAX
    model passes its kernel: both compute in f32 and round once."""
    jargs, targs = _ffn_bf16_inputs(11)
    want = jax_fused_gated_ffn(*jargs, interpret=True, gelu=gelu)
    got = fused_ffn.fused_gated_ffn_reference(*targs, gelu_kind=gelu)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    np.testing.assert_allclose(_f32(got), _f32(want), **ONE_ULP)
    # The wrapper on CPU tensors returns what the plain version computes
    # in that call, with no launch. (Two separate CPU calls need not
    # agree bit for bit: MKL's f32 GEMM may sum in another order when
    # the host is loaded.)
    plain = fused_ffn.fused_gated_ffn_reference
    calls = []

    def recording(*args, **kw):
        calls.append(plain(*args, **kw))
        return calls[-1]

    monkeypatch.setattr(fused_ffn, "fused_gated_ffn_reference", recording)
    launches = fused_ffn.fused_gated_ffn_kernel.launches
    out = fused_ffn.fused_gated_ffn(*targs, gelu_kind=gelu)
    assert len(calls) == 1 and out.dtype == torch.bfloat16 and torch.equal(out, calls[0])
    assert fused_ffn.fused_gated_ffn_kernel.launches == launches
    np.testing.assert_allclose(_f32(out), _f32(want), **ONE_ULP)


@pytest.mark.parametrize("gelu", ["tanh", "erf"])
def test_ffn_on_the_training_mix_matches_the_interpreted_tpu_kernel(gelu):
    """bf16 x with f32 weights, biases and scores, the mix the JAX model
    passes its kernel in bf16 training (``GatedExpertFfn`` hands over the
    f32 master weights uncast): the forward within one bf16 ulp of the
    interpreted TPU kernel, and the gradients of the plain-version
    recompute in JAX ``_fused_bwd``'s dtypes (bf16 for x, f32 for the
    scores, weights and biases) and values."""
    rng = np.random.default_rng(14)
    (jx, js, jk, jb), (tx, ts, tk, tb) = _ffn_bf16_inputs(14)
    jk, jb = [jnp.asarray(_f32(k)) for k in jk], [jnp.asarray(_f32(b)) for b in jb]
    tk = [k.float().requires_grad_(True) for k in tk]
    tb = [b.float().requires_grad_(True) for b in tb]
    tx, ts = tx.clone().requires_grad_(True), ts.clone().requires_grad_(True)
    want, vjp = jax.vjp(
        lambda x, s, k, b: jax_fused_gated_ffn(x, s, k, b, interpret=True, gelu=gelu),
        jx, js, jk, jb)
    got = fused_ffn.fused_gated_ffn(tx, ts, tk, tb, gelu_kind=gelu)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    np.testing.assert_allclose(_f32(got.detach()), _f32(want), **ONE_ULP)
    (jg,), (tg,) = _bf16_pair(rng.standard_normal(got.shape).astype(np.float32))
    jgx, jgs, jgk, jgb = vjp(jg)
    got.backward(tg)
    assert tx.grad.dtype == torch.bfloat16 and jgx.dtype == jnp.bfloat16
    np.testing.assert_allclose(_f32(tx.grad), _f32(jgx), **ONE_ULP)
    for t, j in [(ts, jgs), *zip(tk, jgk), *zip(tb, jgb)]:
        assert t.grad.dtype == torch.float32 and j.dtype == jnp.float32
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j), rtol=1e-5, atol=1e-6)


def test_kernel_takes_reads_shapes_and_the_wrapper_refuses_other_dtype_mixes():
    """The model's predicate reads shapes only, so a dtype mix outside the
    f32 mix, the bf16 serving mix and the bf16 training mix reaches the
    wrapper and raises there instead of quietly taking the torch path.
    The three mixes it takes pass the dtype check and raise only because
    the tensors lie on the CPU."""
    _, (x, scores, kernels, biases) = _ffn_bf16_inputs(12)
    f32 = [t.float() for t in kernels], [t.float() for t in biases]
    half = [t.half() for t in kernels], [t.half() for t in biases]
    taken = [(x, scores, kernels, biases), (x.float(), scores, *f32), (x, scores, *f32)]
    off_mix = [
        (x.half(), scores, *half),  # f16
        (x, scores.bfloat16(), kernels, biases),  # bf16 scores
        (x.float(), scores, kernels, biases),  # f32 x, bf16 weights
        (x, scores, f32[0], biases),  # bf16 x, f32 weights, bf16 biases
    ]
    for args in [*taken, *off_mix]:
        assert fused_ffn.kernel_takes(*args)
    for args in off_mix:
        with pytest.raises(ValueError, match="float32 x, weights and biases, or bfloat16"):
            fused_ffn.fused_gated_ffn_kernel(*args)
    for args in taken:
        with pytest.raises(ValueError, match="same CUDA device"):
            fused_ffn.fused_gated_ffn_kernel(*args)


def test_bf16_weight_image_has_an_all_zero_lo_part():
    """A bf16 weight is exact in TF32: its packed image's hi part is the
    weight itself and its lo part is 0, so the kernel's a_hi * w_lo
    product adds exact zeros and the bf16 kernel skips it."""
    _, (_, _, kernels, _) = _ffn_bf16_inputs(13, dims=(48, 256, 16))
    for k in kernels:
        image = fused_ffn.pack_weights(k)
        assert image.dtype == torch.float32
        hi, lo = fused_ffn.unpack_weights(image, k.shape)
        assert torch.equal(hi, k.float()) and not lo.any()


# -- data ---------------------------------------------------------------------


def test_collate_bf16_is_bitwise_jax():
    samples = datasets.synth_ns2d(3, seed=5, n_points=70) + datasets.synth_ns2d(
        2, seed=6, n_points=33)
    want = jax_collate(samples, dtype="bfloat16")
    got = collate(samples, dtype="bfloat16")
    for name in ("coords", "theta", "y", "node_mask", "funcs", "func_mask"):
        w, g = getattr(want, name), getattr(got, name)
        assert g.dtype == torch.bfloat16, name
        assert g.shape == w.shape, name
        np.testing.assert_array_equal(_bits(g), _bits(w), err_msg=name)
    assert got.signature() != collate(samples).signature()  # dtype-keyed
    assert [s[0] for s in got.signature()] == [s[0] for s in collate(samples).signature()]
    with pytest.raises(ValueError, match="float32|bfloat16"):
        collate(samples, dtype="float16")


# -- the model ------------------------------------------------------------------


def _models(samples, ffn_impl, **kw):
    """The JAX GNOT and its f32 params, and the port's GNOT holding them."""
    mc = dict(SMALL, **datasets.infer_model_dims(samples), ffn_impl=ffn_impl, **kw)
    jmodel = JaxGNOT(JaxModelConfig(**mc))
    init = jax.jit(lambda key, b: jmodel.init(
        key, b.coords, b.theta, b.funcs, node_mask=b.node_mask, func_mask=b.func_mask,
    )["params"])
    params = jax.device_get(init(jax.random.key(0), jax_collate(samples)))
    cfg = ModelConfig(**mc)
    port = GNOT(cfg)
    port.load_state_dict(params_from_jax(params, cfg), strict=True)
    return jmodel, params, port.eval()


@pytest.mark.parametrize("ffn_impl", ["xla", "pallas"])
@pytest.mark.parametrize("data", ["ns2d", "darcy2d"])
def test_bf16_model_matches_jax_bf16_model(data, ffn_impl):
    """The port's bf16 forward adds no error beyond what bf16 costs:
    ``rel(port_bf16, jax_bf16) <= rel(jax_bf16, jax_f32) < 2e-2``."""
    if data == "ns2d":
        samples = datasets.synth_ns2d(3, seed=1, n_points=100)
    else:
        samples = datasets.synth_darcy2d(4, seed=0, grid_n=8)
    jmodel, params, port = _models(samples, ffn_impl)
    jmodel16 = jax_precision.serve_model(jmodel, "bfloat16")
    jax32 = np.asarray(jax.jit(lambda p, b: jax_apply_batch(jmodel, p, b))(
        params, jax_collate(samples)))
    jax16 = np.asarray(jax.jit(lambda p, b: jax_apply_batch(jmodel16, p, b))(
        jax_precision.cast_params(params, "bfloat16"), jax_collate(samples, dtype="bfloat16")))
    served = precision.serve_model(port, "bfloat16")
    assert served.config.dtype == "bfloat16" and precision.serve_model(port, "float32") is port
    assert {p.dtype for p in served.parameters()} == {torch.bfloat16}
    assert {p.dtype for p in port.parameters()} == {torch.float32}  # untouched
    with torch.no_grad():
        port16 = apply_batch(served, collate(samples, dtype="bfloat16"))
    assert port16.dtype == torch.float32  # the policy's f32 head
    bf16_cost = _rel(jax16, jax32)
    port_err = _rel(port16.numpy(), jax16)
    assert bf16_cost < MODEL_REL_BAR
    assert port_err <= bf16_cost, (port_err, bf16_cost)


# -- the engine and the server ------------------------------------------------


def _two_bucket_samples():
    small = datasets.synth_ns2d(5, seed=1, n_points=40)
    large = datasets.synth_ns2d(4, seed=2, n_points=100)
    return [s for pair in zip(small, large) for s in pair] + small[4:]


def test_engine_bf16_publishes_cast_copy_and_keeps_rest_f32():
    samples = _two_bucket_samples()
    jmodel, params, port = _models(samples, "pallas")
    eng = InferenceEngine(port, batch_size=MAX_BATCH, dtype="bfloat16")
    assert eng.dtype == "bfloat16" and eng.policy.tag == "bf16"
    assert eng.model is not port
    assert {p.dtype for p in eng.model.parameters()} == {torch.bfloat16}
    assert {p.dtype for p in port.parameters()} == {torch.float32}
    # Hot reload hands over f32 again; publish casts again.
    before = eng.model
    eng.swap_params(port.state_dict())
    assert eng.model is not before
    assert {p.dtype for p in eng.model.parameters()} == {torch.bfloat16}
    assert {p.dtype for p in port.parameters()} == {torch.float32}
    # Responses are f32 and match the JAX bf16 engine's to within what
    # bf16 costs against the f32 engine; bf16 and f32 dispatches at the
    # same shapes are distinct signatures.
    f32 = InferenceEngine(port, batch_size=MAX_BATCH)
    jax16 = JaxEngine(jmodel, params, batch_size=MAX_BATCH, dtype="bfloat16")
    jax32 = JaxEngine(jmodel, params, batch_size=MAX_BATCH)
    group = samples[1:7:2]
    key = eng.bucket_key(group[0])
    kw = dict(pad_nodes=key[0], pad_funcs=key[1], rows=MAX_BATCH)
    got, ref = eng.infer(group, **kw), f32.infer(group, **kw)
    want16, want32 = jax16.infer(group, **kw), jax32.infer(group, **kw)
    for g, r, w16, w32 in zip(got, ref, want16, want32):
        assert g.dtype == np.float32
        assert _rel(g, w16) <= _rel(w16, w32) < MODEL_REL_BAR
        assert _rel(g, r) < MODEL_REL_BAR
    assert eng.dispatch_shapes == f32.dispatch_shapes == 1
    (sig16,), (sig32,) = eng._shapes, f32._shapes
    assert [s[0] for s in sig16] == [s[0] for s in sig32]
    assert {s[1] for s in sig16} == {"torch.bfloat16"}
    assert {s[1] for s in sig32} == {"torch.float32"}


#: The bf16 engine against JAX's bf16 engine run eagerly, on the same
#: weights: both publish them cast to bf16 and compute the same bf16
#: function. Readings per request: 8.3e-7 to 1.0e-6 for both config
#: dtypes; an engine that published the f32 weights of a bf16-config
#: model (the port before this test) read 8.4e-3 to 9.8e-3.
ENGINE_REL_BAR = 1e-5


@pytest.mark.parametrize("config_dtype", ["float32", "bfloat16"])
def test_bf16_engine_publishes_a_cast_copy_whatever_the_config_dtype(config_dtype):
    """``InferenceEngine(dtype="bfloat16")`` publishes ``cast_params`` of
    the weights as JAX's engine does (``gnot_tpu/serve/engine.py``), also
    for a model whose config already computes in bf16 (what bf16
    training produces), and leaves the caller's model untouched."""
    samples = _two_bucket_samples()
    jmodel, params, port = _models(samples, "pallas", dtype=config_dtype)
    eng = InferenceEngine(port, batch_size=MAX_BATCH, dtype="bfloat16")
    # JAX's trainer and main build the engine on serve_model's model.
    jeng = JaxEngine(jax_precision.serve_model(jmodel, "bfloat16"), params,
                     batch_size=MAX_BATCH, dtype="bfloat16")
    group = samples[1:7:2]
    key = eng.bucket_key(group[0])
    kw = dict(pad_nodes=key[0], pad_funcs=key[1], rows=MAX_BATCH)
    got = eng.infer(group, **kw)
    # Eager, so that JAX rounds to bf16 after every op as the port does
    # (jit lets XLA keep fused intermediates in f32: ~5e-3 apart).
    with jax.disable_jit():
        want = jeng.infer(group, **kw)
    assert eng.model is not port
    assert {p.dtype for p in eng.model.parameters()} == {torch.bfloat16}
    assert {p.dtype for p in port.parameters()} == {torch.float32}
    assert port.config.dtype == config_dtype
    for g, w in zip(got, want):
        assert _rel(g, w) <= ENGINE_REL_BAR, _rel(g, w)


def test_bf16_server_storm_end_to_end():
    """A bf16 server serves the traffic the f32 server does: every request
    completes, responses are f32 and within the bar of the f32 engine's,
    the summary names its dtype, and the dispatch shapes stay bounded by
    the buckets (bf16 signatures are dtype-keyed, not extra shapes)."""
    samples = _two_bucket_samples()
    _, _, port = _models(samples, "pallas")
    engine = InferenceEngine(port, batch_size=MAX_BATCH, dtype="bfloat16")
    server = InferenceServer(engine, max_batch=MAX_BATCH, max_wait_ms=5.0).start(warmup=samples)
    futures = [server.submit(s) for s in samples]
    results = [f.result(timeout=60) for f in futures]
    summary = server.drain(timeout_s=60)
    assert all(r.ok for r in results), [r.detail for r in results]
    assert summary["dtype"] == "bfloat16"
    f32 = InferenceEngine(port, batch_size=MAX_BATCH)
    for s, r in zip(samples, results):
        assert r.output.dtype == np.float32
        key = f32.bucket_key(s)
        ref = f32.infer([s], pad_nodes=key[0], pad_funcs=key[1], rows=MAX_BATCH)[0]
        assert _rel(r.output, ref) < MODEL_REL_BAR
    buckets = {f32.bucket_key(s) for s in samples}
    assert summary["compiled_shapes"] <= len(buckets)


# -- bf16 training ---------------------------------------------------------------

TRAIN_SMALL = dict(
    n_attn_layers=2,
    n_attn_hidden_dim=32,
    n_mlp_num_layers=2,
    n_mlp_hidden_dim=32,
    n_input_hidden_dim=32,
    n_expert=2,
    n_head=4,
)
TRAIN_LRS = [1e-3, 8e-4, 5e-4]
#: bf16 training against JAX's: each quantity's relative norm from JAX's
#: bf16 run at most this share of JAX's own bf16-vs-f32 gap of it.
BF16_TRAIN_SHARE = 0.25


def _f32_accumulated_reduce_sum(monkeypatch):
    """JAX's CPU backend sums a bf16 ``reduce_sum`` in bf16, rounding after
    every add: a bias gradient (the transpose of the bias broadcast) then
    lands ~1e-2 from its exact value against ~1e-3 for an f32 sum rounded
    once, which is what torch computes. That alone is ~90% of the JAX bf16
    run's gradient gap to f32 here (9.2e-4 of 1.06e-3). So JAX's bf16 run
    is taken with bf16 sums accumulated in f32 and rounded once; nothing
    else in it changes."""
    from jax._src.lax import lax as jax_lax

    plain = jax_lax.reduce_sum

    def reduce_sum(operand, axes):
        if operand.dtype == jnp.bfloat16:
            return plain(operand.astype(jnp.float32), axes).astype(jnp.bfloat16)
        return plain(operand, axes)

    monkeypatch.setattr(jax_lax, "reduce_sum", reduce_sum)


def _jax_three_steps(mc, jax_samples, params0=None):
    """JAX's three AdamW steps, run eagerly so that every bf16 op rounds as
    it does op by op (under jit XLA keeps fused bf16 intermediates in f32,
    ~5e-3 off the op-by-op result): (params before, step losses, step-1
    gradients, params after). Without ``params0`` the weights are
    ``init_state``'s from seed 0, its ``init_params`` under one ``jax.jit``
    (bitwise flax's eager init, which compiles op by op)."""
    from gnot_tpu.config import OptimConfig as JaxOptimConfig
    from gnot_tpu.data.batch import Loader as JaxLoader
    from gnot_tpu.train import trainer as jax_trainer
    from gnot_tpu_torch.interop import flatten_tree

    model = JaxGNOT(JaxModelConfig(**mc))
    batches = list(JaxLoader(jax_samples, 4, shuffle=True, seed=2))
    if params0 is None:
        params0 = jax.jit(lambda b: jax_trainer.init_params(model, b, 0))(batches[0])
    params = jax.tree.map(np.array, jax.device_get(params0))
    with jax.disable_jit():
        # init_state's state on those weights: AdamW's zero moments, step 0.
        start = jax.tree.map(jnp.asarray, params)
        tx = jax_trainer.make_optimizer(JaxOptimConfig(), JaxOptimConfig().lr)
        state = jax_trainer.TrainState(params=start, opt_state=tx.init(start),
                                       step=jnp.zeros((), jnp.int32))
        grads = jax.grad(lambda p: jax_trainer.batch_loss(model, p, batches[0], "rel_l2"))(
            state.params)
        step = jax_trainer.make_train_step(model, JaxOptimConfig(), "rel_l2")
        losses = []
        for batch, lr in zip(batches, TRAIN_LRS):
            state, loss = step(state, batch, np.float32(lr))
            losses.append(float(loss))
    return (params, np.array(losses), flatten_tree(jax.device_get(grads)),
            flatten_tree(jax.device_get(state.params)))


def _port_three_steps(mc, samples, params0):
    """The port's three steps from ``params0``: (losses, step-1 gradients,
    params after)."""
    from gnot_tpu_torch.data.batch import Loader

    cfg = Config(data=DataConfig(n_train=len(samples)), train=TrainConfig(epochs=1))
    trainer = Trainer(cfg, ModelConfig(**mc), samples, [], device="cpu")
    trainer.initialize()
    trainer.model.load_state_dict(params_from_jax(params0, trainer.model_cfg), strict=True)
    losses, grads = [], None
    for batch, lr in zip(Loader(samples, 4, shuffle=True, seed=2), TRAIN_LRS):
        losses.append(float(trainer.train_step(batch, lr)))
        if grads is None:
            grads = {n: p.grad.numpy().copy() for n, p in trainer.model.named_parameters()}
    return np.array(losses), grads, {n: p.numpy() for n, p in trainer.model.state_dict().items()}


def _rel_tree(a, ref) -> float:
    names = sorted(ref)
    return _rel(np.concatenate([np.ravel(a[n]) for n in names]),
                np.concatenate([np.ravel(ref[n]) for n in names]))


#: Adam moves a coordinate by ~lr whatever the size of its gradient, so a
#: parameter whose gradient sits at the rounding-noise floor ends a step
#: wherever the noise's sign sends it, in JAX's own runs as in the port's.
#: The parameters are held to the bar where the step-1 gradient (JAX f32)
#: is above this share of the largest parameter gradient's norm.
NOISE_FLOOR = 1e-6


@pytest.mark.parametrize("ffn_impl", ["xla", "pallas"])
def test_three_bf16_train_steps_match_jax(ffn_impl, monkeypatch):
    """``ModelConfig(dtype="bfloat16")`` training from JAX's weights: the
    step losses, the step-1 gradients and the parameters after step 3 of
    the port's bf16 run sit within ``BF16_TRAIN_SHARE`` of JAX's bf16-vs-
    f32 gap of the same quantity from JAX's bf16 run, and the port's f32
    run (the control) does not. JAX's Pallas FFN runs in interpret mode;
    the port's runs its kernel's plain version on the training mix.

    Readings, relative norm to JAX's bf16 run as a share of the gap, port
    bf16 run: xla losses 0.059, gradients 0.124, parameters 0.115; pallas
    0.022, 0.075, 0.021 (gaps 1.4e-5 to 1.9e-5, 4.0e-4 to 5.3e-4 and 6.2e-4
    to 6.7e-4); the control reads 0.994 to 1.000 of the gap in each. Over
    every parameter the port's share reads 0.52 (xla) and
    0.59 (pallas): 97% of that is the attention key projections, whose
    step-1 gradients are 2e-9 to 2e-7 of the largest one in norm, against
    2e-5 and up for every other parameter (``NOISE_FLOOR``)."""
    _f32_accumulated_reduce_sum(monkeypatch)
    samples = datasets.synth_elasticity(12, seed=7, base_points=70)
    mc = dict(TRAIN_SMALL, **datasets.infer_model_dims(samples), ffn_impl=ffn_impl)
    params0, losses32, grads32, after32 = _jax_three_steps(mc, samples)
    _, losses16, grads16, after16 = _jax_three_steps(dict(mc, dtype="bfloat16"), samples, params0)
    port16 = _port_three_steps(dict(mc, dtype="bfloat16"), samples, params0)
    port32 = _port_three_steps(mc, samples, params0)
    norms = {n: np.linalg.norm(g) for n, g in grads32.items()}
    floor = NOISE_FLOOR * max(norms.values())
    above = [n for n in norms if norms[n] >= floor]
    noise = sorted(set(norms) - set(above))
    assert all(".key." in n for n in noise), noise
    sub = lambda tree: {n: tree[n] for n in above}  # noqa: E731
    cases = [
        ("losses", _rel, losses16, losses32, port16[0], port32[0]),
        ("gradients", _rel_tree, grads16, grads32, port16[1], port32[1]),
        ("parameters", _rel_tree, sub(after16), sub(after32), sub(port16[2]), sub(port32[2])),
        ("all parameters", _rel_tree, after16, after32, port16[2], port32[2]),
    ]
    readings = {}
    for name, rel, jax16, jax32, got, control in cases:
        gap = rel(jax16, jax32)
        readings[name] = (rel(got, jax16) / gap, rel(control, jax16) / gap, gap)
    for name in ("losses", "gradients", "parameters"):
        share, control_share, _ = readings[name]
        assert share <= BF16_TRAIN_SHARE, (name, readings)
        assert control_share > BF16_TRAIN_SHARE, (name, readings)


def test_bf16_training_reduces_loss(capsys):
    """The bf16 compute path trains: the loss falls over four epochs and
    every number stays finite (``tests/test_trainer.py``'s property)."""
    from gnot_tpu_torch import main as port_main

    argv = ["--device", "cpu", "--dtype", "bfloat16", "--synthetic", "darcy2d", "--epochs", "4",
            "--n_train", "16", "--n_test", "8", "--n_attn_layers", "2", "--n_attn_hidden_dim",
            "32", "--n_mlp_num_layers", "2", "--n_mlp_hidden_dim", "32", "--n_input_hidden_dim",
            "32", "--n_expert", "2", "--n_head", "4", "--ffn_impl", "pallas"]
    trainer = port_main.run_train(port_main.build_parser().parse_args(argv))
    out = capsys.readouterr().out
    assert trainer.model_cfg.dtype == "bfloat16"
    assert {p.dtype for p in trainer.model.parameters()} == {torch.float32}
    first = float(out.split("Epoch 0, Loss: ")[1].splitlines()[0])
    last = float(out.split("Epoch 3, Loss: ")[1].splitlines()[0])
    assert np.isfinite(trainer.best_metric)
    assert last < first, f"bf16 training did not reduce loss: {first} -> {last}"
