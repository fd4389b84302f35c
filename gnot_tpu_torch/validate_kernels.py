"""Validate the port's CUDA kernels against their plain versions on the card.

    python -m gnot_tpu_torch.validate_kernels

The counterpart of ``tools/validate_tpu_kernels.py``. It runs that tool's
three checks at its shapes and seeds (fused attention, packed fused
attention, the fused FFN; forward and gradients), then the four attention
kernels again at the model's full width (E=256, H=8, D=32, f32):

* ``self``: q ``[4,1024,256]``, k/v ``[1,4,1024,256]``, the key mask from
  collating 4 synthetic elasticity meshes (ragged, so rows are padded);
* ``cross``: q ``[4,1024,256]``, k/v ``[1,4,512,256]``, as NS2d-1k gives
  them;
* ``self_packed`` / ``cross_packed``: a ``PackPlan`` over 16 synthetic
  elasticity samples (chunk 128, batch_size 4), ``pack_prefix`` and
  ``pack_collate``: node rows against themselves, and node rows against
  the slot-indexed input functions (two packings; empty slots);
* ``ragged``: L=1000, Lk=300, a random mask and one all-masked slab;
* ``outlier``: one head's q and k logits 200 above the others'.

Each stage is held against its plain version on the same inputs, the
composed ops against the plain composition and against the split-head
torch einsum path (``ops/attention.py``), and the gradients wrt q, k and
v against autograd through the plain version. One line per check with
its max abs error and tolerance. It runs on ``cuda`` and raises without
a card; it exits 0 only when every check passed.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

import numpy as np
import torch

from gnot_tpu_torch.data import datasets
from gnot_tpu_torch.data.batch import PackPlan, collate, pack_collate, pack_prefix
from gnot_tpu_torch.device import resolve_device
from gnot_tpu_torch.ops import attention, fused_attention as fa, fused_ffn

# (rtol, atol) on the card. Kernel outputs against the plain version: f32
# both ways, only the summation order over Lk and E differs.
OUT_TOL = (1e-4, 1e-5)
# The softmaxed queries: a softmax only.
QS_TOL = (1e-5, 1e-6)
# Gradients: the backward is the same plain code.
GRAD_TOL = (1e-5, 1e-6)
# The composed kernels against the torch einsum path: the JAX package's
# model-level bar.
MODEL_TOL = (1e-4, 1e-5)
# bf16 outputs against the plain version on the same bf16 inputs: both
# compute in f32 and round once, so an element differs by at most one bf16
# ulp (2^-7 of its value at most) where the two f32 results round apart.
BF16_TOL = (2.0**-7, 1e-6)

WIDTH, N_HEAD = 256, 8


@dataclasses.dataclass
class Check:
    group: str
    name: str
    max_abs_err: float
    rtol: float
    atol: float
    ok: bool
    kernel: str | None = None  # the kernel whose output is held against its plain version


def compare(group: str, name: str, got, want, tol, kernel: str | None = None) -> Check:
    """Hold ``got`` against ``want``: same shape, all finite, and
    ``|got - want| <= atol + rtol * |want|`` everywhere. Prints the line."""
    rtol, atol = tol
    got, want = got.detach().float(), want.detach().float()
    if got.shape != want.shape:
        err, ok = float("inf"), False
    else:
        err = (got - want).abs().max().item() if got.numel() else 0.0
        finite = bool(torch.isfinite(got).all()) and bool(torch.isfinite(want).all())
        ok = finite and torch.allclose(got, want, rtol=rtol, atol=atol)
    check = Check(group, name, err, rtol, atol, ok, kernel)
    print(f"[{group}] {name}: max_abs_err {err:.3e} (rtol {rtol} atol {atol}) "
          f"{'ok' if ok else 'FAILED'}", flush=True)
    return check


def _t(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _loss(out, qs):
    return (out**2).sum() + (qs * 0.5).sum()


def _grads(fn, q, k, v):
    """Gradients of ``_loss(fn(q, k, v))`` wrt q, k and v."""
    xs = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
    return torch.autograd.grad(_loss(*fn(*xs)), xs)


def einsum_path(q, k, v, mask, n_head: int):
    """``fused_nla``'s output by the split-head torch einsum path the model
    runs (``ops/attention.py``): ``(out [F,B,L,E], qs [B,L,E])``."""
    qh = attention.feature_softmax(attention.split_heads(q, n_head))
    kh = attention.feature_softmax(attention.split_heads(k, n_head))
    vh = attention.split_heads(v, n_head)
    out = attention.normalized_linear_attention(qh, kh, vh, kv_mask=mask)
    return attention.merge_heads(out), attention.merge_heads(qh)


def packed_einsum_path(q, k, v, mask, q_seg, kv_seg, n_seg: int, n_head: int):
    """``fused_nla_packed``'s output by the einsum path of the JAX packed
    model (``packed_normalized_linear_attention``), one input function at
    a time: ``out [F,B,L,E]``."""
    qh = attention.feature_softmax(attention.split_heads(q, n_head))
    kh = attention.feature_softmax(attention.split_heads(k, n_head))
    vh = attention.split_heads(v, n_head)
    q_oh = attention.segment_one_hot(q_seg, n_seg)
    kv_oh = attention.segment_one_hot(kv_seg, n_seg)
    return torch.stack([
        attention.merge_heads(attention.packed_normalized_linear_attention(
            qh, kh[f], vh[f], q_seg_oh=q_oh, kv_seg_oh=kv_oh, kv_mask=mask[f]))
        for f in range(k.shape[0])
    ])


def check_dense(name: str, q, k, v, mask, n_head: int) -> list[Check]:
    """``nla_reduce``, ``nla_apply`` and ``fused_nla`` (forward and
    gradients) against their plain versions."""
    g = "attn"
    kv, ksum = fa.nla_reduce(k, v, mask, n_head)
    kv_p, ksum_p = fa.reduce_reference(k, v, mask, n_head)
    out, qs = fa.nla_apply(q, kv_p, ksum_p, n_head)
    out_p, qs_p = fa.apply_reference(q, kv_p, ksum_p, n_head)
    checks = [
        compare(g, f"{name} nla_reduce kv", kv, kv_p, OUT_TOL, "nla_reduce"),
        compare(g, f"{name} nla_reduce ksum", ksum, ksum_p, OUT_TOL, "nla_reduce"),
        compare(g, f"{name} nla_apply out", out, out_p, OUT_TOL, "nla_apply"),
        compare(g, f"{name} nla_apply qs", qs, qs_p, QS_TOL, "nla_apply"),
    ]
    out, qs = fa.fused_nla(q, k, v, mask, n_head)
    out_p, qs_p = fa.reference_impl(q, k, v, mask, n_head)
    checks += [
        compare(g, f"{name} fused_nla out", out, out_p, OUT_TOL),
        compare(g, f"{name} fused_nla qs", qs, qs_p, QS_TOL),
    ]
    out_t, qs_t = einsum_path(q, k, v, mask, n_head)
    checks += [
        compare(g, f"{name} fused_nla out vs split-head torch", out, out_t, MODEL_TOL),
        compare(g, f"{name} fused_nla qs vs split-head torch", qs, qs_t, MODEL_TOL),
    ]
    got = _grads(lambda *a: fa.fused_nla(*a, mask, n_head), q, k, v)
    want = _grads(lambda *a: fa.reference_impl(*a, mask, n_head), q, k, v)
    checks += [compare(g, f"{name} fused_nla grad {w}", a, b, GRAD_TOL)
               for w, a, b in zip("qkv", got, want)]
    return checks


def check_packed(name: str, q, k, v, mask, q_seg, kv_seg, n_seg: int, n_head: int) -> list[Check]:
    """``nla_reduce_seg``, ``nla_apply_seg`` and ``fused_nla_packed``
    (forward and gradients) against their plain versions."""
    g = "attn"
    kv, ksum = fa.nla_reduce_seg(k, v, mask, kv_seg, n_seg, n_head)
    kv_p, ksum_p = fa.reduce_seg_reference(k, v, mask, kv_seg, n_seg, n_head)
    out, qs = fa.nla_apply_seg(q, kv_p, ksum_p, q_seg, n_head)
    out_p, qs_p = fa.apply_seg_reference(q, kv_p, ksum_p, q_seg, n_head)
    checks = [
        compare(g, f"{name} nla_reduce_seg kv", kv, kv_p, OUT_TOL, "nla_reduce_seg"),
        compare(g, f"{name} nla_reduce_seg ksum", ksum, ksum_p, OUT_TOL, "nla_reduce_seg"),
        compare(g, f"{name} nla_apply_seg out", out, out_p, OUT_TOL, "nla_apply_seg"),
        compare(g, f"{name} nla_apply_seg qs", qs, qs_p, QS_TOL, "nla_apply_seg"),
    ]
    out, qs = fa.fused_nla_packed(q, k, v, mask, q_seg, kv_seg, n_seg, n_head)
    out_p, qs_p = fa.reference_seg_impl(q, k, v, mask, q_seg, kv_seg, n_seg, n_head)
    checks += [
        compare(g, f"{name} fused_nla_packed out", out, out_p, OUT_TOL),
        compare(g, f"{name} fused_nla_packed qs", qs, qs_p, QS_TOL),
    ]
    out_t = packed_einsum_path(q, k, v, mask, q_seg, kv_seg, n_seg, n_head)
    checks.append(compare(g, f"{name} fused_nla_packed out vs packed torch", out, out_t,
                          MODEL_TOL))
    got = _grads(lambda *a: fa.fused_nla_packed(*a, mask, q_seg, kv_seg, n_seg, n_head), q, k, v)
    want = _grads(lambda *a: fa.reference_seg_impl(*a, mask, q_seg, kv_seg, n_seg, n_head),
                  q, k, v)
    checks += [compare(g, f"{name} fused_nla_packed grad {w}", a, b, GRAD_TOL)
               for w, a, b in zip("qkv", got, want)]
    return checks


def check_bf16(name: str, case: dict, n_head: int, seed: int = 0) -> list[Check]:
    """The stages of one case (dense, or packed where it has ``q_seg``) on
    bf16 q, k, v and mask against their plain versions on the same bf16
    inputs: the reduce's f32 Grams at OUT_TOL (its inputs are exact after
    widening) and bitwise the reduce of the widened inputs; the apply's
    ``out`` and ``qs`` in bf16 within one bf16 ulp (the apply takes the
    plain Grams); gradients wrt q, k and v through the autograd Functions
    against autograd through the plain versions, bf16, along one fixed
    cotangent from ``seed``."""
    g = "attn-bf16"
    q, k, v, mask = (case[x].bfloat16() for x in ("q", "k", "v", "mask"))
    if "q_seg" in case:
        seg = (case["kv_seg"], case["n_seg"], n_head)
        reduce, reduce_p = fa.nla_reduce_seg, fa.reduce_seg_reference
        apply, apply_p = fa.nla_apply_seg, fa.apply_seg_reference
        apply_args = (case["q_seg"], n_head)
        fused = lambda *a: fa.fused_nla_packed(  # noqa: E731
            *a, mask, case["q_seg"], case["kv_seg"], case["n_seg"], n_head)
        plain = lambda *a: fa.reference_seg_impl(  # noqa: E731
            *a, mask, case["q_seg"], case["kv_seg"], case["n_seg"], n_head)
        stages = ("nla_reduce_seg", "nla_apply_seg")
    else:
        seg = (n_head,)
        reduce, reduce_p = fa.nla_reduce, fa.reduce_reference
        apply, apply_p = fa.nla_apply, fa.apply_reference
        apply_args = (n_head,)
        fused = lambda *a: fa.fused_nla(*a, mask, n_head)  # noqa: E731
        plain = lambda *a: fa.reference_impl(*a, mask, n_head)  # noqa: E731
        stages = ("nla_reduce", "nla_apply")
    kv, ksum = reduce(k, v, mask, *seg)
    kv_p, ksum_p = reduce_p(k, v, mask, *seg)
    kv_w, ksum_w = reduce(k.float(), v.float(), mask.float(), *seg)
    out, qs = apply(q, kv_p, ksum_p, *apply_args)
    out_p, qs_p = apply_p(q, kv_p, ksum_p, *apply_args)
    dtypes = [t.dtype for t in (kv, ksum, out, qs, out_p, qs_p)]
    want_dtypes = [torch.float32] * 2 + [torch.bfloat16] * 4
    checks = [
        compare(g, f"{name} {stages[0]} kv", kv, kv_p, OUT_TOL, stages[0]),
        compare(g, f"{name} {stages[0]} ksum", ksum, ksum_p, OUT_TOL, stages[0]),
        compare(g, f"{name} {stages[0]} kv vs the widened inputs' (bitwise)", kv, kv_w, (0, 0)),
        compare(g, f"{name} {stages[0]} ksum vs the widened inputs' (bitwise)", ksum, ksum_w,
                (0, 0)),
        compare(g, f"{name} {stages[1]} out", out, out_p, BF16_TOL, stages[1]),
        compare(g, f"{name} {stages[1]} qs", qs, qs_p, BF16_TOL, stages[1]),
        Check(g, f"{name} dtypes {[str(d) for d in dtypes]}", 0.0, 0.0, 0.0,
              dtypes == want_dtypes),
    ]
    print(f"[{g}] {checks[-1].name}: {'ok' if checks[-1].ok else 'FAILED'}", flush=True)
    gen = torch.Generator().manual_seed(seed)
    cots = [torch.randn(t.shape, generator=gen).to(device=t.device, dtype=t.dtype)
            for t in (out_p, qs_p)]

    def grads(fn):
        xs = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
        return torch.autograd.grad(fn(*xs), xs, cots)

    got, want = grads(fused), grads(plain)
    checks += [compare(g, f"{name} grad {w} ({a.dtype})", a, b, BF16_TOL)
               for w, a, b in zip("qkv", got, want)]
    ok = all(a.dtype == torch.bfloat16 for a in got)
    checks.append(Check(g, f"{name} grad dtypes bf16", 0.0, 0.0, 0.0, ok))
    return checks


def validate_attention(device) -> list[Check]:
    """``tools/validate_tpu_kernels.py::validate_attention``'s case."""
    rng = np.random.default_rng(1)
    f, b, l, lk, e, h = 2, 2, 300, 200, 64, 4
    q = _t(rng.normal(size=(b, l, e)).astype(np.float32), device)
    k = _t(rng.normal(size=(f, b, lk, e)).astype(np.float32), device)
    v = _t(rng.normal(size=(f, b, lk, e)).astype(np.float32), device)
    mask = _t((rng.uniform(size=(f, b, lk)) > 0.3).astype(np.float32), device)
    return check_dense("tool", q, k, v, mask, h)


def validate_attention_seg(device) -> list[Check]:
    """``tools/validate_tpu_kernels.py::validate_attention_seg``'s case: a
    two-row multi-segment packing with ragged tails, pad chunks and an
    empty slot."""
    rng = np.random.default_rng(2)
    f, b, e, h, chunk = 2, 2, 64, 4, 128
    n, n_seg = 6, 5  # slot 4 left empty
    l = n * chunk
    q = _t(rng.normal(size=(b, l, e)).astype(np.float32), device)
    k = _t(rng.normal(size=(f, b, l, e)).astype(np.float32), device)
    v = _t(rng.normal(size=(f, b, l, e)).astype(np.float32), device)
    seg = _t(np.array([[0, 0, 1, 1, 1, n_seg], [2, 3, 3, n_seg, n_seg, n_seg]], np.int32), device)
    mask = np.ones((f, b, l), np.float32)
    mask[:, 0, 5 * chunk - 17 :] = 0.0  # seg 1 ragged tail + pad chunk
    mask[:, 1, 3 * chunk - 40 :] = 0.0  # seg 3 ragged tail + pad chunks
    return check_packed("tool packed", q, k, v, _t(mask, device), seg, seg, n_seg, h)


def validate_ffn(device) -> list[Check]:
    """``tools/validate_tpu_kernels.py::validate_ffn``'s case: forward and
    gradients wrt every input."""
    rng = np.random.default_rng(0)
    e_, b, l, d, hid = 3, 2, 300, 32, 64
    x = _t(rng.normal(size=(b, l, d)).astype(np.float32), device)
    s = torch.softmax(_t(rng.normal(size=(b, l, e_)).astype(np.float32), device), -1)
    ks = [
        _t(rng.normal(size=(e_, d, hid)).astype(np.float32) * 0.1, device),
        _t(rng.normal(size=(e_, hid, hid)).astype(np.float32) * 0.1, device),
        _t(rng.normal(size=(e_, hid, d)).astype(np.float32) * 0.1, device),
    ]
    bs = [_t(rng.normal(size=(e_, k.shape[-1])).astype(np.float32) * 0.1, device) for k in ks]
    checks = [compare("ffn", "tool out", fused_ffn.fused_gated_ffn(x, s, ks, bs),
                      fused_ffn.fused_gated_ffn_reference(x, s, ks, bs), OUT_TOL,
                      "fused_gated_ffn")]

    # The loss is linear in the output with a fixed cotangent from the seed,
    # so both sides run their backward (the same plain code) on the same
    # cotangent: the check is of the backward and the wrapper's routing of
    # gradients alone. A loss of the output's square would feed each side
    # its own forward's rounding, which OUT_TOL already bounds.
    cot = _t(rng.normal(size=(b, l, d)).astype(np.float32), device)

    def grads(fn):
        xs = [t.detach().clone().requires_grad_(True) for t in (x, s, *ks, *bs)]
        out = fn(xs[0], xs[1], xs[2:5], xs[5:])
        return torch.autograd.grad((out * cot).sum(), xs)

    got = grads(fused_ffn.fused_gated_ffn)
    want = grads(fused_ffn.fused_gated_ffn_reference)
    names = ["x", "scores"] + [f"kernel {i}" for i in range(3)] + [f"bias {i}" for i in range(3)]
    checks += [compare("ffn", f"tool grad {n}", a, b_, GRAD_TOL)
               for n, a, b_ in zip(names, got, want)]
    return checks


def packed_batch(seed: int = 0):
    """The full-width packed dispatch: a ``PackPlan`` over 16 synthetic
    elasticity samples (chunk 128, batch_size 4), then ``pack_prefix`` and
    ``pack_collate``."""
    samples = datasets.synth_elasticity(16, seed=seed)
    plan = PackPlan.from_samples(samples, chunk=128, batch_size=4)
    placements = pack_prefix([s.coords.shape[0] for s in samples], plan)
    return pack_collate(
        samples[: len(placements)], placements, n_rows=plan.n_rows, row_len=plan.row_len,
        chunk=plan.chunk, n_slots=plan.n_slots, pad_funcs=plan.pad_funcs,
    )


def full_width_cases(device) -> dict[str, dict]:
    """The full-width attention inputs, by case name: ``q, k, v, mask``
    and, for the packed cases, ``q_seg, kv_seg, n_seg``. Inputs come from
    numpy seeds; the masks and segment tables from collating and packing
    synthetic meshes."""
    rng = np.random.default_rng(10)
    e = WIDTH

    def normal(*shape):
        return _t(rng.standard_normal(shape, dtype=np.float32), device)

    cases = {}
    node_mask = collate(datasets.synth_elasticity(4, seed=0), pad_nodes=1024).node_mask
    cases["self"] = dict(q=normal(4, 1024, e), k=normal(1, 4, 1024, e), v=normal(1, 4, 1024, e),
                         mask=node_mask[None].to(device))
    func_mask = collate(datasets.synth_ns2d(4, seed=0)).func_mask  # [1, 4, 512]
    cases["cross"] = dict(q=normal(4, 1024, e), k=normal(1, 4, 512, e), v=normal(1, 4, 512, e),
                          mask=func_mask.to(device))
    pb = packed_batch().to(device)
    r, l = pb.node_mask.shape
    cases["self_packed"] = dict(
        q=normal(r, l, e), k=normal(1, r, l, e), v=normal(1, r, l, e),
        mask=pb.node_mask[None], q_seg=pb.node_seg, kv_seg=pb.node_seg, n_seg=pb.n_seg)
    _, s, lf = pb.func_mask.shape
    cases["cross_packed"] = dict(
        q=normal(r, l, e), k=normal(1, s, lf, e), v=normal(1, s, lf, e),
        mask=pb.func_mask, q_seg=pb.node_seg, kv_seg=pb.func_seg, n_seg=pb.n_seg)
    mask = (rng.uniform(size=(2, 2, 300)) > 0.3).astype(np.float32)
    mask[1, 0] = 0.0  # an all-masked slab
    cases["ragged"] = dict(q=normal(2, 1000, e), k=normal(2, 2, 300, e), v=normal(2, 2, 300, e),
                           mask=_t(mask, device))
    q, k = normal(2, 256, e), normal(1, 2, 256, e)
    d = e // N_HEAD
    q[..., :d] += 200.0  # head 0's logits far above the others'
    k[..., :d] += 200.0
    cases["outlier"] = dict(q=q, k=k, v=normal(1, 2, 256, e), mask=torch.ones(1, 2, 256, device=device))
    return cases


def validate_full_width(device) -> list[Check]:
    checks = []
    for name, c in full_width_cases(device).items():
        if "q_seg" in c:
            checks += check_packed(name, c["q"], c["k"], c["v"], c["mask"], c["q_seg"],
                                   c["kv_seg"], c["n_seg"], N_HEAD)
        else:
            checks += check_dense(name, c["q"], c["k"], c["v"], c["mask"], N_HEAD)
    return checks


def run(device) -> list[Check]:
    """Every check, at the tool's shapes and then at full width."""
    checks = []
    for fn in (validate_attention, validate_attention_seg, validate_ffn, validate_full_width):
        checks += fn(device)
    return checks


def main(argv: list[str] | None = None) -> int:
    argparse.ArgumentParser(
        description="Validate the port's CUDA kernels against their plain versions on the card."
    ).parse_args(argv)
    device = resolve_device("cuda")
    print(f"device: {torch.cuda.get_device_name(device)}", flush=True)
    checks = run(device)
    failed = [c for c in checks if not c.ok]
    if failed:
        print(f"{len(failed)} of {len(checks)} checks FAILED: "
              f"{[f'{c.group} {c.name}' for c in failed]}")
        return 1
    print(f"all {len(checks)} kernel checks passed")
    return 0


if __name__ == "__main__":
    sys.exit(main())
