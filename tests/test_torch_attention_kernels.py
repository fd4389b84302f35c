"""The port's fused normalized-linear-attention module against the JAX
Pallas kernels.

Inputs come from numpy seeds and go to both packages. On the CPU the JAX
kernels run in Pallas interpret mode (as tests/test_pallas.py runs them)
and the port's stages take their plain versions through the same
``autograd.Function``s the card uses; the CUDA kernels run only on a card
(tests/test_torch_cuda.py). Bar: rtol 1e-5 / atol 1e-6, the JAX
package's own (tests/test_pallas.py:46). On bf16 inputs both packages
compute in f32: the reduce stages' f32 Grams keep that bar, and the apply
stages' bf16 ``out`` / ``qs`` and the bf16 gradients, each rounded once from
an f32 result, sit within one bf16 ulp of JAX's.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

from gnot_tpu.ops import attention as jax_att
from gnot_tpu.ops import pallas_attention as jpa
from gnot_tpu_torch import validate_kernels
from gnot_tpu_torch.ops import attention as att
from gnot_tpu_torch.ops import fused_attention as fa
from gnot_tpu_torch.ops import fused_ffn

RTOL, ATOL = 1e-5, 1e-6


def _close(got, want):
    np.testing.assert_allclose(
        np.asarray(got.detach() if isinstance(got, torch.Tensor) else got),
        np.asarray(want), rtol=RTOL, atol=ATOL,
    )


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _dense_case(seed, n_funcs=1, b=2, l=24, lk=16, e=32, masked=True):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, l, e)).astype(np.float32)
    k = rng.normal(size=(n_funcs, b, lk, e)).astype(np.float32)
    v = rng.normal(size=(n_funcs, b, lk, e)).astype(np.float32)
    if masked:
        mask = (rng.uniform(size=(n_funcs, b, lk)) > 0.3).astype(np.float32)
        mask[:, :, 0] = 1.0  # at least one real row
    else:
        mask = np.ones((n_funcs, b, lk), np.float32)
    return q, k, v, mask


def _packed_case(seed=0, f=2, b=2, e=32, chunk=8):
    """tests/test_pallas.py::_packed_case: row 0 carries segments 0 (2
    chunks) and 1 (3 chunks, ragged tail), row 1 segments 2 and 3 (ragged);
    pad chunks carry id n_seg and slot 4 stays empty."""
    rng = np.random.default_rng(seed)
    n = 6
    l = n * chunk
    n_seg = 5
    q = rng.normal(size=(b, l, e)).astype(np.float32)
    k = rng.normal(size=(f, b, l, e)).astype(np.float32)
    v = rng.normal(size=(f, b, l, e)).astype(np.float32)
    seg = np.array([[0, 0, 1, 1, 1, n_seg], [2, 3, 3, n_seg, n_seg, n_seg]], np.int32)
    mask = np.ones((f, b, l), np.float32)
    mask[:, 0, 5 * chunk :] = 0.0
    mask[:, 0, 5 * chunk - 3 : 5 * chunk] = 0.0
    mask[:, 1, 3 * chunk :] = 0.0
    mask[:, 1, 3 * chunk - 5 : 3 * chunk] = 0.0
    return q, k, v, mask, seg, n_seg


@pytest.mark.parametrize(
    "n_funcs,masked,l,lk",
    [(1, False, 24, 16), (2, True, 24, 16), (3, True, 40, 24), (1, True, 300, 280)],
)
def test_fused_nla_matches_jax(n_funcs, masked, l, lk):
    """test_pallas.py's four cross-attention sets: the port's stages and
    composition against JAX's plain forms and its interpret-mode kernels."""
    h = 4
    q, k, v, mask = _dense_case(0, n_funcs, l=l, lk=lk, masked=masked)
    kv_j, ksum_j = jpa._reduce_ref(k, v, mask, h)
    kv, ksum = fa.reduce_reference(*_t(k, v, mask), h)
    _close(kv, kv_j)
    _close(ksum, ksum_j)
    out, qs = fa.apply_reference(*_t(q, np.asarray(kv_j), np.asarray(ksum_j)), h)
    out_j, qs_j = jpa._apply_ref(q, kv_j, ksum_j, h)
    _close(out, out_j)
    _close(qs, qs_j)
    out, qs = fa.fused_nla(*_t(q, k, v, mask), h)
    out_j, qs_j = jpa.fused_nla(q, k, v, mask, h)
    _close(out, out_j)
    _close(qs, qs_j)
    out_r, qs_r = fa.reference_impl(*_t(q, k, v, mask), h)
    out_jr, qs_jr = jpa._reference_impl(q, k, v, mask, h)
    _close(out_r, out_jr)
    _close(qs_r, qs_jr)


def test_group_softmax_and_block_diag_match_jax():
    x = np.random.default_rng(3).normal(size=(5, 64)).astype(np.float32) * 30
    _close(fa.group_softmax(torch.from_numpy(x), 4), jpa._group_softmax(jnp.asarray(x), 4))
    np.testing.assert_array_equal(fa.block_diag_mask(64, 16).numpy(), jpa._block_diag_mask(64, 16))


def test_outlier_head_finite_and_matches_jax():
    """One head's logits ~200 above another's must not underflow the
    quiet head's group to 0/0 (the max is per head)."""
    h, e = 4, 32
    q, k, v, mask = _dense_case(7, b=1, l=16, lk=16, masked=False)
    q[..., : e // h] += 200.0
    k[..., : e // h] += 200.0
    out, qs = fa.fused_nla(*_t(q, k, v, mask), h)
    assert torch.isfinite(out).all() and torch.isfinite(qs).all()
    out_j, qs_j = jpa.fused_nla(q, k, v, mask, h)
    _close(out, out_j)
    _close(qs, qs_j)


def _loss_torch(out, qs):
    return (out**2).sum() + (qs * 0.5).sum()


def _loss_jax(out, qs):
    return jnp.sum(out**2) + jnp.sum(qs * 0.5)


def test_fused_nla_grads_match_jax():
    """Gradients wrt q, k, v through the port's autograd Functions (their
    backward recomputes the plain version) against jax.grad of the JAX
    custom_vjp kernels."""
    h = 2
    q, k, v, mask = _dense_case(1, b=2, l=12, lk=10, e=16)
    xs = [x.requires_grad_(True) for x in _t(q, k, v)]
    _loss_torch(*fa.fused_nla(*xs, torch.from_numpy(mask), h)).backward()
    g_j = jax.grad(lambda *a: _loss_jax(*jpa.fused_nla(*a, mask, h)), argnums=(0, 1, 2))(q, k, v)
    for x, g in zip(xs, g_j):
        _close(x.grad, g)


@pytest.mark.parametrize("stage", ["reduce", "apply"])
def test_each_stage_grads_match_jax(stage):
    """Each dense stage's backward alone against the JAX custom_vjp."""
    h = 4
    q, k, v, mask = _dense_case(2)
    kv, ksum = (np.asarray(a) for a in jpa._reduce_ref(k, v, mask, h))
    if stage == "reduce":
        args = (k, v)
        fn_t = lambda k_, v_: fa.nla_reduce(k_, v_, torch.from_numpy(mask), h)  # noqa: E731
        fn_j = lambda k_, v_: jpa.nla_reduce(k_, v_, mask, h)  # noqa: E731
    else:
        args = (q, kv, ksum)
        fn_t = lambda *a: fa.nla_apply(*a, h)  # noqa: E731
        fn_j = lambda *a: jpa.nla_apply(*a, h)  # noqa: E731
    xs = [x.requires_grad_(True) for x in _t(*args)]
    a, b = fn_t(*xs)
    ((a**2).sum() + (b * 0.5).sum()).backward()
    g_j = jax.grad(
        lambda *z: (lambda o: jnp.sum(o[0] ** 2) + jnp.sum(o[1] * 0.5))(fn_j(*z)),
        argnums=tuple(range(len(args))),
    )(*args)
    for x, g in zip(xs, g_j):
        _close(x.grad, g)


def test_masks_get_no_gradient():
    h = 4
    q, k, v, mask = _t(*_dense_case(3))
    mask.requires_grad_(True)
    q.requires_grad_(True)
    _loss_torch(*fa.fused_nla(q, k, v, mask, h)).backward()
    assert q.grad is not None and mask.grad is None


def test_fused_nla_matches_split_head_path():
    """The merged-layout op == the port's split-head torch path the model
    runs (test_pallas.py::test_reference_impl_matches_xla_ops)."""
    h = 4
    q, k, v, mask = _t(*_dense_case(2, n_funcs=2, l=12, lk=10))
    out, qs = fa.fused_nla(q, k, v, mask, h)
    qh = att.feature_softmax(att.split_heads(q, h))
    kh = att.feature_softmax(att.split_heads(k, h))
    out_h = att.normalized_linear_attention(qh, kh, att.split_heads(v, h), kv_mask=mask)
    _close(out, att.merge_heads(out_h))
    _close(qs, att.merge_heads(qh))


def test_all_masked_slab_is_finite():
    """An all-masked input-function slab reaches the apply stage with
    k_sum == 0; the denominator select gives 0, not nan, forward and
    backward, as in JAX."""
    h = 4
    q, k, v, mask = _dense_case(5, n_funcs=2, l=16, lk=16, masked=False)
    mask[1, 0, :] = 0.0
    xs = [x.requires_grad_(True) for x in _t(q, k, v)]
    out, qs = fa.fused_nla(*xs, torch.from_numpy(mask), h)
    assert torch.isfinite(out).all() and (out[1, 0] == 0).all()
    ((out**2).mean() + (qs**2).mean()).backward()
    assert all(torch.isfinite(x.grad).all() for x in xs)
    _close(out, jpa.fused_nla(q, k, v, mask, h)[0])


def test_packed_matches_jax():
    """The packed stages against JAX's plain forms and interpret-mode
    kernels, on the multi-segment packing with ragged tails, pad chunks
    and an empty slot."""
    h = 4
    q, k, v, mask, seg, n_seg = _packed_case()
    kv_j, ksum_j = jpa._reduce_seg_ref(k, v, mask, seg, n_seg, h)
    kv, ksum = fa.reduce_seg_reference(*_t(k, v, mask, seg), n_seg, h)
    _close(kv, kv_j)
    _close(ksum, ksum_j)
    out, qs = fa.apply_seg_reference(*_t(q, np.asarray(kv_j), np.asarray(ksum_j), seg), h)
    out_j, qs_j = jpa._apply_seg_ref(q, kv_j, ksum_j, seg, h)
    _close(out, out_j)
    _close(qs, qs_j)
    out, qs = fa.fused_nla_packed(*_t(q, k, v, mask, seg, seg), n_seg, h)
    out_j, qs_j = jpa.fused_nla_packed(q, k, v, mask, seg, seg, n_seg, h)
    _close(out, out_j)
    _close(qs, qs_j)
    _close(fa.reference_seg_impl(*_t(q, k, v, mask, seg, seg), n_seg, h)[0],
           jpa._reference_seg_impl(q, k, v, mask, seg, seg, n_seg, h)[0])


def test_packed_pad_chunks_and_empty_slot_are_zero():
    h = 4
    q, k, v, mask, seg, n_seg = _packed_case(seed=7)
    out, qs = fa.fused_nla_packed(*_t(q, k, v, mask, seg, seg), n_seg, h)
    assert torch.isfinite(out).all() and torch.isfinite(qs).all()
    assert (out[:, 0, 5 * 8 :] == 0).all() and (out[:, 1, 3 * 8 :] == 0).all()
    kv, ksum = fa.nla_reduce_seg(*_t(k, v, mask, seg), n_seg, h)
    assert (kv[:, 4] == 0).all() and (ksum[:, 4] == 0).all()
    kv_j, _ = jpa.nla_reduce_seg(k, v, mask, seg, n_seg, h)
    _close(kv, kv_j)


def _emulate_reduce(k, v, mask, n_head, seg=None, n_seg=0, three=True):
    """Plain torch of ``csrc/nla_reduce.cu``'s arithmetic: ``ks =
    group_softmax(k) * mask`` in f32, the Gram ``ks^T v`` per slot as
    ``lo*hi + hi*lo + hi*hi`` of the TF32 splits of ks and v with f32 sums
    (3xTF32, the kernel's mma.sync form), or one TF32 product (``three=
    False``); k_sum an f32 sum. ``seg`` gives the segment form, whose pad
    chunks and empty slots enter no Gram."""
    f, b, lk, e = k.shape
    ks = fa.group_softmax(k, n_head) * mask[..., None]
    if seg is None:
        rows, vs = ks, v  # [F, B, Lk, E]: slot b owns row b
    else:
        tok = torch.repeat_interleave(seg, lk // seg.shape[1], dim=1)  # [B, Lk]
        oh = fa._one_hot(tok, n_seg).permute(2, 0, 1).reshape(n_seg, b * lk, 1)
        rows = ks.reshape(f, 1, b * lk, e) * oh  # [F, S, B*Lk, E]
        vs = v.reshape(f, 1, b * lk, e)
    if three:
        k_hi, k_lo = fused_ffn.tf32_split(rows)
        v_hi, v_lo = fused_ffn.tf32_split(vs.expand_as(rows))
        kv = k_lo.mT @ v_hi + k_hi.mT @ v_lo + k_hi.mT @ v_hi
    else:
        kv = fused_ffn.tf32_round(rows).mT @ fused_ffn.tf32_round(vs.expand_as(rows))
    return kv, rows.sum(dim=2, keepdim=True)


@pytest.mark.parametrize("form", ["dense", "segment"])
@pytest.mark.parametrize("d", [16, 32])
def test_reduce_3xtf32_arithmetic_matches_jax(form, d):
    """The reduce kernel's 3xTF32 Gram (emulated on the CPU with the FFN
    kernel's split) holds the JAX kernels' bar against ``nla_reduce`` /
    ``nla_reduce_seg`` in interpret mode, with masked rows and, in the
    segment form, a pad chunk and an empty slot (exactly 0); one TF32
    product misses that bar, so the bar tells the two forms apart."""
    h = 2
    e = h * d
    if form == "dense":
        _, k, v, mask = _dense_case(12, n_funcs=2, lk=40, e=e)
        want = jpa.nla_reduce(k, v, mask, h)
        seg, n_seg = None, 0
    else:
        _, k, v, mask, seg, n_seg = _packed_case(seed=12, e=e)
        want = jpa.nla_reduce_seg(k, v, mask, seg, n_seg, h)
        seg = torch.from_numpy(seg)
    kt, vt, mt = _t(k, v, mask)
    got = _emulate_reduce(kt, vt, mt, h, seg, n_seg)
    for g, w in zip(got, want):
        _close(g, w)
    if seg is not None:
        assert (got[0][:, 4] == 0).all() and (got[1][:, 4] == 0).all()  # the empty slot
    one = _emulate_reduce(kt, vt, mt, h, seg, n_seg, three=False)[0].numpy()
    assert not np.allclose(one, np.asarray(want[0]), rtol=RTOL, atol=ATOL)


def test_packed_grads_match_jax():
    h = 4
    q, k, v, mask, seg, n_seg = _packed_case(seed=11)
    xs = [x.requires_grad_(True) for x in _t(q, k, v)]
    _loss_torch(*fa.fused_nla_packed(*xs, *_t(mask, seg, seg), n_seg, h)).backward()
    g_j = jax.grad(
        lambda *a: _loss_jax(*jpa.fused_nla_packed(*a, mask, seg, seg, n_seg, h)),
        argnums=(0, 1, 2),
    )(q, k, v)
    for x, g in zip(xs, g_j):
        _close(x.grad, g)


def test_packed_cross_packing_matches_jax():
    """The key rows use a different packing than the query rows
    (slot-indexed input functions: one row per slot, one chunk each)."""
    rng = np.random.default_rng(9)
    f, e, h, chunk, n_seg = 2, 32, 4, 8, 3
    q_seg = np.array([[0, 0, 1, n_seg], [2, n_seg, n_seg, n_seg]], np.int32)
    kv_seg = np.array([[0], [1], [2]], np.int32)
    q = rng.normal(size=(2, 4 * chunk, e)).astype(np.float32)
    k = rng.normal(size=(f, 3, 16, e)).astype(np.float32)
    v = rng.normal(size=(f, 3, 16, e)).astype(np.float32)
    mask = np.ones((f, 3, 16), np.float32)
    mask[:, 1, 10:] = 0.0
    out, qs = fa.fused_nla_packed(*_t(q, k, v, mask, q_seg, kv_seg), n_seg, h)
    out_j, qs_j = jpa.fused_nla_packed(q, k, v, mask, q_seg, kv_seg, n_seg, h)
    _close(out, out_j)
    _close(qs, qs_j)


def test_packed_segment_matches_unpacked_solo():
    """Each packed segment's output == the unpacked op on that segment
    alone: packing changes the layout, never the result."""
    h = 4
    q, k, v, mask, seg, n_seg = _packed_case()
    out, _ = fa.fused_nla_packed(*_t(q, k, v, mask, seg, seg), n_seg, h)
    for row, sl in [(0, slice(0, 16)), (0, slice(16, 40)), (1, slice(0, 8)), (1, slice(8, 24))]:
        solo, _ = fa.fused_nla(*_t(q[row : row + 1, sl], k[:, row : row + 1, sl],
                                   v[:, row : row + 1, sl], mask[:, row : row + 1, sl]), h)
        _close(out[:, row, sl], solo[:, 0].numpy())


def test_packed_alignment_errors_match_jax():
    """Both packages refuse the same misaligned packings."""
    rng = np.random.default_rng(0)
    q = rng.normal(size=(1, 20, 32)).astype(np.float32)
    k = rng.normal(size=(1, 1, 20, 32)).astype(np.float32)
    mask = np.ones((1, 1, 20), np.float32)
    for seg, match in [(np.zeros((1, 4), np.int32), "multiple of 8"),
                       (np.zeros((1, 3), np.int32), "not divisible")]:
        with pytest.raises(ValueError, match=match):
            jpa.fused_nla_packed(q, k, k, mask, seg, seg, 1, 4)
        with pytest.raises(ValueError, match=match):
            fa.fused_nla_packed(*_t(q, k, k, mask, seg, seg), 1, 4)


def test_segment_one_hot_matches_jax():
    seg = np.array([[0, 2, 3, 3], [1, 3, 3, 3]], np.int32)
    np.testing.assert_array_equal(
        att.segment_one_hot(torch.from_numpy(seg), 3).numpy(),
        np.asarray(jax_att.segment_one_hot(jnp.asarray(seg), 3)),
    )


@pytest.mark.parametrize("masked", [False, True])
def test_packed_normalized_linear_attention_matches_jax(masked):
    rng = np.random.default_rng(4)
    h, d, chunk, n_seg = 2, 8, 4, 3
    q_seg = np.array([[0, 0, 1, n_seg], [2, 2, n_seg, n_seg]], np.int32)
    kv_seg = np.array([[0], [1], [2]], np.int32)
    q = rng.uniform(size=(2, h, 4 * chunk, d)).astype(np.float32)
    k = rng.uniform(size=(3, h, 8, d)).astype(np.float32)
    v = rng.normal(size=(3, h, 8, d)).astype(np.float32)
    mask = (rng.uniform(size=(3, 8)) > 0.3).astype(np.float32) if masked else None
    q_oh, kv_oh = att.segment_one_hot(torch.from_numpy(q_seg), n_seg), att.segment_one_hot(
        torch.from_numpy(kv_seg), n_seg)
    got = att.packed_normalized_linear_attention(
        *_t(q, k, v), q_seg_oh=q_oh, kv_seg_oh=kv_oh,
        kv_mask=None if mask is None else torch.from_numpy(mask))
    want = jax_att.packed_normalized_linear_attention(
        q, k, v, q_seg_oh=jax_att.segment_one_hot(q_seg, n_seg),
        kv_seg_oh=jax_att.segment_one_hot(kv_seg, n_seg), kv_mask=mask)
    _close(got, want)


def test_fused_nla_packed_matches_packed_torch_path():
    """The merged-layout packed op == the einsum path the packed model
    runs, per input function."""
    h = 4
    q, k, v, mask, seg, n_seg = _t(*_packed_case()[:5]) + [5]
    out, _ = fa.fused_nla_packed(q, k, v, mask, seg, seg, n_seg, h)
    qh = att.feature_softmax(att.split_heads(q, h))
    kh = att.feature_softmax(att.split_heads(k, h))
    vh = att.split_heads(v, h)
    oh = att.segment_one_hot(seg, n_seg)
    for f in range(k.shape[0]):
        got = att.packed_normalized_linear_attention(qh, kh[f], vh[f], q_seg_oh=oh,
                                                     kv_seg_oh=oh, kv_mask=mask[f])
        _close(out[f], att.merge_heads(got).numpy())


def test_wrappers_take_the_plain_version_for_cpu_tensors():
    counters = [fa.nla_reduce_kernel, fa.nla_apply_kernel, fa.nla_reduce_seg_kernel,
                fa.nla_apply_seg_kernel]
    before = [c.launches for c in counters]
    q, k, v, mask, seg, n_seg = _packed_case()
    fa.fused_nla(*_t(q, k, v, mask), 4)
    fa.fused_nla_packed(*_t(q, k, v, mask, seg, seg), n_seg, 4)
    assert [c.launches for c in counters] == before


@pytest.mark.parametrize("name", ["nla_reduce", "nla_apply", "nla_reduce_seg", "nla_apply_seg"])
def test_kernel_wrappers_refuse_cpu_tensors(name):
    q, k, v, mask, seg, n_seg = _t(*_packed_case(e=64)[:5]) + [5]
    kv, ksum = fa.reduce_seg_reference(k, v, mask, seg, n_seg, 4)
    args = {
        "nla_reduce": (k, v, mask, 4),
        "nla_apply": (q, kv[:, :2].contiguous(), ksum[:, :2].contiguous(), 4),
        "nla_reduce_seg": (k, v, mask, seg, n_seg, 4),
        "nla_apply_seg": (q, kv, ksum, seg, 4),
    }[name]
    with pytest.raises(ValueError, match="CUDA device"):
        getattr(fa, name + "_kernel")(*args)


@pytest.mark.parametrize(
    "e,n_head,match",
    [(256, 8, None), (64, 4, None), (48, 3, None), (64, 8, "head widths"),
     (512, 16, "E <= 256"), (30, 4, "not divisible")],
)
def test_head_width_checks(e, n_head, match):
    if match is None:
        assert fa._head_width(e, n_head) == e // n_head
    else:
        with pytest.raises(ValueError, match=match):
            fa._head_width(e, n_head)


@pytest.mark.parametrize(
    "f,n_chunks,chunk_len,e",
    [(1, 4, 1024, 256), (1, 4, 512, 256), (2, 2, 200, 64), (1, 1, 0, 256), (3, 1, 1, 32),
     (1, 64, 4096, 256), (1, 24, 128, 256), (1, 24, 192, 256), (2, 12, 8, 32)],
)
def test_reduce_splits_cover_every_row(f, n_chunks, chunk_len, e):
    n, length = fa.reduce_splits(f, n_chunks, chunk_len, e, n_sm=132)
    assert n >= 1 and length % fa.REDUCE_ROWS == 0
    assert n * length >= chunk_len and (n - 1) * length < max(chunk_len, 1)
    tiles = (-(-e // fa.REDUCE_TILE[0])) * (-(-e // fa.REDUCE_TILE[1]))
    # no more pieces than about two blocks per SM need, none needlessly short
    assert n == 1 or tiles * f * n_chunks * (n - 1) < 2 * 132
    assert n == 1 or chunk_len // n >= fa.REDUCE_MIN_SPLIT


def test_launchers_bind_pointer_arguments(monkeypatch):
    """Each C launcher is bound once with 64-bit pointer arguments: a
    pointer passed as a C int would be cut to 32 bits."""
    import ctypes

    calls = []
    fake = types.SimpleNamespace(gnot_fake=types.SimpleNamespace())
    monkeypatch.setattr(fa.build, "load", lambda name: calls.append(name) or fake)
    monkeypatch.setattr(fa, "_launchers", {})
    fn = fa._lib("fake_source", "gnot_fake", 3, 2)
    assert fn.argtypes == [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    assert fn.restype is ctypes.c_int
    assert fa._lib("fake_source", "gnot_fake", 3, 2) is fn and calls == ["fake_source"]


def test_validate_kernels_runs_on_cpu():
    """The validation entry point's checks at the JAX tool's shapes, on the
    CPU (plain versions through the autograd Functions against plain
    autograd): the control flow and the backward wiring."""
    checks = (validate_kernels.validate_attention("cpu")
              + validate_kernels.validate_attention_seg("cpu")
              + validate_kernels.validate_ffn("cpu"))
    assert checks and all(c.ok for c in checks), [c for c in checks if not c.ok]
    assert {c.kernel for c in checks} >= {"nla_reduce", "nla_apply", "nla_reduce_seg",
                                           "nla_apply_seg", "fused_gated_ffn"}


def test_full_width_cases_have_the_model_shapes():
    cases = validate_kernels.full_width_cases("cpu")
    assert tuple(cases["self"]["q"].shape) == (4, 1024, 256)
    assert tuple(cases["self"]["k"].shape) == (1, 4, 1024, 256)
    assert 0 < cases["self"]["mask"].mean() < 1  # ragged meshes: padded rows
    assert tuple(cases["cross"]["k"].shape) == (1, 4, 512, 256)
    sp, cp = cases["self_packed"], cases["cross_packed"]
    assert sp["n_seg"] == 24 and tuple(sp["q"].shape) == (2, 1536, 256)
    assert tuple(sp["q_seg"].shape) == (2, 12)
    assert tuple(cp["k"].shape) == (1, 24, 192, 256) and tuple(cp["kv_seg"].shape) == (24, 1)
    used = set(sp["q_seg"].unique().tolist())
    assert 24 in used and len(used - {24}) < 24  # pad chunks and empty slots
    assert (cases["ragged"]["mask"][1, 0] == 0).all()


def test_reduce_probe_variants_apply_to_the_kernel_source():
    """Every variant of gnot_tpu_torch/reduce_probe.py edits lines that the
    reduce kernel's source still has (the probe builds them only on the
    card)."""
    from gnot_tpu_torch import reduce_probe
    from gnot_tpu_torch.ops import build

    source = (build.CSRC / "nla_reduce.cu").read_text()
    for name, edits in reduce_probe.VARIANTS.items():
        text = build.variant_source("nla_reduce", edits)
        assert (text == source) == (not edits), name


def test_apply_probe_variants_apply_to_the_kernel_source():
    """Every variant of gnot_tpu_torch/apply_probe.py edits lines that the
    apply kernel's source still has (the probe builds them only on the
    card)."""
    from gnot_tpu_torch import apply_probe
    from gnot_tpu_torch.ops import build

    source = (build.CSRC / "nla_apply.cu").read_text()
    for name, edits in apply_probe.VARIANTS.items():
        text = build.variant_source("nla_apply", edits)
        assert (text == source) == (not edits), name


# -- bf16 inputs ----------------------------------------------------------------


def _bf16_exact(*arrays):
    """The f32 arrays rounded to bf16 values (round to nearest even), as f32:
    both packages read the same bf16 numbers from them."""
    return [torch.from_numpy(np.asarray(a)).bfloat16().float().numpy() for a in arrays]


def _jbf(*arrays):
    return [jnp.asarray(a, jnp.bfloat16) for a in arrays]


def _tbf(*arrays):
    return [torch.from_numpy(np.asarray(a)).bfloat16() for a in arrays]


def _within_one_bf16_ulp(got, want):
    """``|got - want|`` at most one bf16 ulp of ``want`` (bf16 keeps 8
    significant bits: 2^(floor(log2 |want|) - 7)), or ATOL where ``want`` is
    0: both sides round an f32 result once, and their f32 results differ by
    the summation order only."""
    got = np.asarray(got.detach().float() if isinstance(got, torch.Tensor) else got, np.float64)
    want = np.asarray(want, np.float32).astype(np.float64)
    mag = np.abs(want)
    ulp = np.where(mag > 0, 2.0 ** (np.floor(np.log2(np.where(mag > 0, mag, 1.0))) - 7), 0.0)
    err = np.abs(got - want)
    assert np.all(err <= np.maximum(ulp, ATOL)), float(np.max(err - np.maximum(ulp, ATOL)))


def _dtype_name(x) -> str:
    return str(x.dtype).removeprefix("torch.")


def test_fault10_plain_apply_returns_q_dtype_like_jax():
    """Fault 10: on a bf16 q the port's plain apply pair returned f32 where
    JAX's (``_apply_ref`` / ``_apply_seg_ref``, and its kernels) return
    ``out`` and ``qs`` in q's dtype. The reduce pair's plain versions keep
    their f32 outputs, as JAX's do."""
    h = 4
    q, k, v, mask = _bf16_exact(*_dense_case(20))
    kv_j, ksum_j = jpa._reduce_ref(*_jbf(k, v, mask), h)
    kv, ksum = fa.reduce_reference(*_tbf(k, v, mask), h)
    assert (_dtype_name(kv), _dtype_name(ksum)) == (str(kv_j.dtype), str(ksum_j.dtype)) == (
        "float32", "float32")
    out_j, qs_j = jpa._apply_ref(*_jbf(q), kv_j, ksum_j, h)
    out, qs = fa.apply_reference(*_tbf(q), *_t(np.asarray(kv_j), np.asarray(ksum_j)), h)
    assert (_dtype_name(out), _dtype_name(qs)) == (str(out_j.dtype), str(qs_j.dtype)) == (
        "bfloat16", "bfloat16")
    _within_one_bf16_ulp(out, out_j)
    _within_one_bf16_ulp(qs, qs_j)

    q, k, v, mask, seg, n_seg = _packed_case(seed=20)
    q, k, v, mask = _bf16_exact(q, k, v, mask)
    kv_j, ksum_j = jpa._reduce_seg_ref(*_jbf(k, v, mask), seg, n_seg, h)
    out_j, qs_j = jpa._apply_seg_ref(*_jbf(q), kv_j, ksum_j, seg, h)
    out, qs = fa.apply_seg_reference(*_tbf(q), *_t(np.asarray(kv_j), np.asarray(ksum_j), seg), h)
    assert (_dtype_name(out), _dtype_name(qs)) == (str(out_j.dtype), str(qs_j.dtype)) == (
        "bfloat16", "bfloat16")
    _within_one_bf16_ulp(out, out_j)
    _within_one_bf16_ulp(qs, qs_j)


@pytest.mark.parametrize("stage", ["nla_reduce", "nla_apply", "nla_reduce_seg", "nla_apply_seg"])
def test_bf16_stages_match_jax_kernels(stage):
    """Each public stage on bf16 inputs (bf16 mask too) against JAX's kernel
    in interpret mode on the same bf16 values: the output dtypes are JAX's
    (f32 Grams; ``out`` and ``qs`` in q's dtype), the Grams at the f32 bar
    (the inputs are exact after widening), ``out`` and ``qs`` within one
    bf16 ulp. The apply stages take JAX's f32 Grams."""
    h = 4
    if stage.endswith("_seg"):
        q, k, v, mask, seg, n_seg = _packed_case(seed=21)
        q, k, v, mask = _bf16_exact(q, k, v, mask)
        kv_j, ksum_j = jpa.nla_reduce_seg(*_jbf(k, v, mask), seg, n_seg, h)
        if stage == "nla_reduce_seg":
            got = fa.nla_reduce_seg(*_tbf(k, v, mask), torch.from_numpy(seg), n_seg, h)
            want = (kv_j, ksum_j)
        else:
            got = fa.nla_apply_seg(*_tbf(q), *_t(np.asarray(kv_j), np.asarray(ksum_j), seg), h)
            want = jpa.nla_apply_seg(*_jbf(q), kv_j, ksum_j, seg, h)
    else:
        q, k, v, mask = _bf16_exact(*_dense_case(21, n_funcs=2, l=40, lk=24))
        kv_j, ksum_j = jpa.nla_reduce(*_jbf(k, v, mask), h)
        if stage == "nla_reduce":
            got, want = fa.nla_reduce(*_tbf(k, v, mask), h), (kv_j, ksum_j)
        else:
            got = fa.nla_apply(*_tbf(q), *_t(np.asarray(kv_j), np.asarray(ksum_j)), h)
            want = jpa.nla_apply(*_jbf(q), kv_j, ksum_j, h)
    assert [_dtype_name(g) for g in got] == [str(w.dtype) for w in want]
    for g, w in zip(got, want):
        if "reduce" in stage:
            assert g.dtype == torch.float32
            _close(g, w)
        else:
            assert g.dtype == torch.bfloat16
            _within_one_bf16_ulp(g, w)


@pytest.mark.parametrize("packed", [False, True])
def test_bf16_gradients_match_jax(packed):
    """Gradients wrt bf16 q, k and v through ``fused_nla`` /
    ``fused_nla_packed`` (the backward recomputes the plain versions) against
    ``jax.grad`` of JAX's kernels: bf16 like JAX's, within one bf16 ulp."""
    h = 4
    if packed:
        q, k, v, mask, seg, n_seg = _packed_case(seed=22)
        q, k, v, mask = _bf16_exact(q, k, v, mask)
        seg_t = torch.from_numpy(seg)
        fn_t = lambda *a: fa.fused_nla_packed(*a, *_tbf(mask), seg_t, seg_t, n_seg, h)  # noqa: E731
        fn_j = lambda *a: jpa.fused_nla_packed(*a, *_jbf(mask), seg, seg, n_seg, h)  # noqa: E731
    else:
        q, k, v, mask = _bf16_exact(*_dense_case(22, n_funcs=2, l=40, lk=24))
        fn_t = lambda *a: fa.fused_nla(*a, *_tbf(mask), h)  # noqa: E731
        fn_j = lambda *a: jpa.fused_nla(*a, *_jbf(mask), h)  # noqa: E731
    xs = [x.requires_grad_(True) for x in _tbf(q, k, v)]
    _loss_torch(*fn_t(*xs)).backward()
    g_j = jax.grad(lambda *a: _loss_jax(*fn_j(*a)), argnums=(0, 1, 2))(*_jbf(q, k, v))
    for x, g in zip(xs, g_j):
        assert _dtype_name(x.grad) == str(g.dtype) == "bfloat16"
        _within_one_bf16_ulp(x.grad, np.asarray(g, np.float32))


@pytest.mark.parametrize(
    "k_dtype,v_dtype,mask_dtype,want",
    [("float32", "float32", "float32", ("float32", "float32", "float32")),
     ("bfloat16", "bfloat16", "bfloat16", ("bfloat16", "bfloat16", "bfloat16")),
     ("bfloat16", "bfloat16", "float32", ("bfloat16", "bfloat16", "float32")),
     ("float32", "float32", "bfloat16", ("float32", "float32", "float32")),
     ("float32", "bfloat16", "bfloat16", ("float32", "float32", "float32")),
     ("bfloat16", "float32", "float32", ("float32", "float32", "float32"))],
)
def test_reduce_widens_the_mixes_no_kernel_instance_takes(k_dtype, v_dtype, mask_dtype, want):
    """The reduce kernels read k and v of one type and a mask of f32 or k's
    type; ``_reduce_inputs`` widens any other mix to f32, an exact cast."""
    rng = np.random.default_rng(23)
    k, v = (torch.from_numpy(rng.normal(size=(1, 2, 8, 32)).astype(np.float32)) for _ in "kv")
    mask = torch.ones(1, 2, 8)
    args = [t.to(getattr(torch, d)) for t, d in zip((k, v, mask), (k_dtype, v_dtype, mask_dtype))]
    got = fa._reduce_inputs(*args)
    assert tuple(_dtype_name(t) for t in got) == want
    for g, a in zip(got, args):
        assert torch.equal(g.float(), a.float())


def test_validate_kernels_bf16_checks_run_on_cpu():
    """``validate_kernels.check_bf16`` at the four full-width cases, on the
    CPU (the plain versions on both sides): the control flow, the dtypes
    and the gradients' wiring that phase 23 of chip_smoke.py runs on the
    card."""
    cases = validate_kernels.full_width_cases("cpu")
    for name in ("self", "cross", "self_packed", "cross_packed"):
        checks = validate_kernels.check_bf16(name, cases[name], validate_kernels.N_HEAD)
        assert len(checks) == 11 and all(c.ok for c in checks), [c for c in checks if not c.ok]
        assert {c.kernel for c in checks} - {None} == (
            {"nla_reduce_seg", "nla_apply_seg"} if "packed" in name else {"nla_reduce", "nla_apply"})
