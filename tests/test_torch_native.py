"""The port's native host packer (``gnot_tpu_torch/native``) against the
JAX package's (``gnot_tpu.native``) and its collate, bitwise, on the CPU.

Each case runs on both of the port's paths: ``native`` drops the payload
bars to 0 so every call takes the C sweep, ``numpy`` raises them past
any payload so every call takes the numpy version. The JAX package runs
as its own tests run it. bf16 results are compared as uint16 bits (the
port's are ``np.uint16`` arrays or ``torch.bfloat16`` tensors, JAX's
``ml_dtypes.bfloat16`` arrays).
"""

import ml_dtypes
import numpy as np
import pytest
import torch

from gnot_tpu import native as jax_native
from gnot_tpu.data.batch import collate as jax_collate
from gnot_tpu.data.batch import pack_collate as jax_pack_collate
from gnot_tpu_torch import native
from gnot_tpu_torch.data import batch as port_batch
from gnot_tpu_torch.data import datasets

PATHS = ["native", "numpy"]

# JAX's adversarial block (tests/test_native.py): specials, RNE ties and
# their neighbours, denormals, the largest finite values.
EDGES = np.array(
    [
        [np.nan, -np.nan, np.inf, -np.inf],
        [0.0, -0.0, 1e-40, -1e-40],
        [1.001953125, 1.0019531, 1.0019532, -1.001953125],
        [3.3895314e38, -3.3895314e38, 65504.0, 1.5],
    ],
    np.float32,
)


@pytest.fixture(params=PATHS)
def path(request, monkeypatch):
    """Force one of the port's two paths for every call in the test."""
    bar = 0 if request.param == "native" else 1 << 62
    monkeypatch.setattr(native, "PACK_NATIVE_MIN_BYTES", {"float32": bar, "bfloat16": bar})
    monkeypatch.setattr(native, "NATIVE_UNPAD_MIN_BYTES", bar)
    if request.param == "native":
        assert native.native_available(), native.status()["error"]
    return request.param


def _tn_bits(a) -> np.ndarray:
    """The bits of a packed array or tensor: uint16 for bf16, uint32 for f32."""
    if isinstance(a, torch.Tensor):
        a = a.view(torch.int16).numpy() if a.dtype == torch.bfloat16 else a.numpy()
    if a.dtype == np.dtype(ml_dtypes.bfloat16):
        return a.view(np.uint16)
    return a.view(np.uint16) if a.dtype in (np.uint16, np.int16) else a.view(np.uint32)


def _tn_ragged(rng, n, dim, lo=3, hi=40):
    return [rng.standard_normal((int(rng.integers(lo, hi)), dim)).astype(np.float32)
            for _ in range(n)]


def _tn_same_pack(arrs, max_len, dtype):
    out, mask = native.pack_rows(arrs, max_len, dtype)
    want_out, want_mask = jax_native.pack_rows(arrs, max_len, dtype)
    assert out.shape == want_out.shape and mask.shape == want_mask.shape
    np.testing.assert_array_equal(_tn_bits(out), _tn_bits(want_out))
    np.testing.assert_array_equal(_tn_bits(mask), _tn_bits(want_mask))
    return out, mask


def test_native_builds_and_loads():
    """g++ builds the port's copy into build/gnot_tpu_torch/ and both
    handles bind; the JAX package's loads beside it."""
    assert native.native_available(), native.status()["error"]
    assert native.status()["so"].endswith("build/gnot_tpu_torch/_ragged_pack.so")
    assert native._lib_gil is not None and jax_native.native_available()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pack_rows_is_jax_s(path, dtype):
    """Several widths, JAX's edge block in one sample, and a fuzz of
    lengths (zero-length blocks included) and widths."""
    rng = np.random.default_rng(0)
    for n, dim in [(1, 2), (4, 3), (16, 7)]:
        arrs = _tn_ragged(rng, n, dim)
        _tn_same_pack(arrs, max(a.shape[0] for a in arrs) + 5, dtype)
    arrs = _tn_ragged(rng, 6, 4)
    arrs[0] = EDGES
    _tn_same_pack(arrs, max(a.shape[0] for a in arrs) + 3, dtype)
    for _ in range(20):
        n, dim = int(rng.integers(1, 9)), int(rng.integers(1, 17))
        lens = rng.integers(0, 33, size=n)
        arrs = [rng.normal(size=(int(m), dim)).astype(np.float32) for m in lens]
        _tn_same_pack(arrs, int(max(lens.max(), 1) + rng.integers(0, 8)), dtype)


def test_pack_rows_threaded_path_is_jax_s(path):
    """Above 32 MB of input the C sweep splits the samples over threads."""
    rng = np.random.default_rng(1)
    arrs = [rng.standard_normal((4096, 64), dtype=np.float32) for _ in range(33)]
    assert sum(a.nbytes for a in arrs) > 32 << 20
    _tn_same_pack(arrs, 4096, "float32")


def test_pack_rows_f64_input_rounds_through_f32(path):
    """f64 input rounds f64 -> f32 -> bf16 on both paths, as JAX's does."""
    rng = np.random.default_rng(11)
    a = np.concatenate([
        rng.standard_normal(64) * np.float64(1.0000000596046448),
        np.nextafter(np.float64(1.001953125), 2.0) * np.ones(8),
        rng.standard_normal(64),
    ]).reshape(-1, 4)
    out, _ = _tn_same_pack([a, rng.standard_normal((5, 4))], 40, "bfloat16")
    want = a.astype(np.float32).astype(ml_dtypes.bfloat16).view(np.uint16)
    np.testing.assert_array_equal(out[0, : a.shape[0]], want)


def test_pack_rows_empty_oversize_and_dtype_edges(path):
    """A zero-length block packs to an all-pad row; an oversize block and
    an unknown dtype raise JAX's errors before either path is chosen."""
    arrs = [np.zeros((0, 3), np.float32), np.ones((2, 3), np.float32)]
    for dtype in ("float32", "bfloat16"):
        _, mask = _tn_same_pack(arrs, 4, dtype)
        assert not mask[0].any() and mask[1, :2].all() and not mask[1, 2:].any()
    big = [np.ones((9, 3), np.float32)]
    for pack in (native.pack_rows, native.pack_rows_numpy, jax_native.pack_rows):
        with pytest.raises(ValueError, match="exceeds max_len"):
            pack(big, 8, "bfloat16")
    with pytest.raises(ValueError, match="dtype must be"):
        native.pack_rows(arrs, 4, "float16")


def test_bf16_bits_is_ml_dtypes_cast():
    """The port's host cast against ml_dtypes' RNE cast: JAX's edge block,
    NaNs of both signs and payloads, and random finite values."""
    rng = np.random.default_rng(3)
    nans = np.array([0x7FC00000, 0xFFC00000, 0x7F800001, 0xFF800001, 0x7FFFFFFF,
                     0xFFFFFFFF], np.uint32).view(np.float32)
    x = np.concatenate([EDGES.ravel(), nans, rng.standard_normal(4096).astype(np.float32),
                        (rng.standard_normal(256) * 1e-39).astype(np.float32)])
    got = native.bf16_bits(x)
    assert got.dtype == np.uint16
    np.testing.assert_array_equal(got, x.astype(ml_dtypes.bfloat16).view(np.uint16))


@pytest.mark.parametrize("itemsize", ["float32", "bfloat16"])
def test_unpad_rows_is_jax_s(path, itemsize):
    """Padded spans (row, 0, n), packed spans (row, offset, n) and an empty
    span: the same bytes as JAX's, each an owned array."""
    rng = np.random.default_rng(5)
    out = rng.standard_normal((3, 40, 2)).astype(np.float32)
    spans = [(0, 0, 17), (1, 8, 20), (2, 0, 0), (1, 28, 12)]
    want_src = out if itemsize == "float32" else out.astype(ml_dtypes.bfloat16)
    src = want_src if itemsize == "float32" else want_src.view(np.uint16)
    got = native.unpad_rows(src, spans)
    want = jax_native.unpad_rows(want_src, spans)
    assert [g.shape for g in got] == [(17, 2), (20, 2), (0, 2), (12, 2)]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_tn_bits(g), _tn_bits(w))
        assert g.base is None  # owned, never a view into the dispatch output


def test_unpad_rows_bounds_checked(path):
    out = np.zeros((2, 8, 1), np.float32)
    for unpad in (native.unpad_rows, native.unpad_rows_numpy, jax_native.unpad_rows):
        with pytest.raises(ValueError, match="out of bounds"):
            unpad(out, [(0, 4, 5)])
        with pytest.raises(ValueError, match="out of bounds"):
            unpad(out, [(2, 0, 1)])
        with pytest.raises(ValueError, match=r"\[R, L, dim\]"):
            unpad(np.zeros((4, 4), np.float32), [(0, 0, 1)])


def test_status_keys_are_jax_s():
    st = native.status()
    assert set(st) == set(jax_native.status())
    assert st["impl"] == "native" and st["available"] and st["error"] is None
    assert st["pack_native_min_bytes"] == jax_native.PACK_NATIVE_MIN_BYTES
    assert st["unpad_native_min_bytes"] == jax_native.NATIVE_UNPAD_MIN_BYTES
    assert native.GIL_HOLD_MAX_BYTES == jax_native.GIL_HOLD_MAX_BYTES


def test_failed_build_falls_back_and_says_why(monkeypatch):
    """Without the library the numpy version answers (the same bits) and
    ``status()`` reports the python path with the load error."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_load_failed", True)
    monkeypatch.setattr(native, "_load_error", "OSError: no g++")
    monkeypatch.setattr(native, "PACK_NATIVE_MIN_BYTES", {"float32": 0, "bfloat16": 0})
    st = native.status()
    assert (st["available"], st["impl"], st["so"], st["error"]) == (
        False, "python", None, "OSError: no g++")
    _tn_same_pack([EDGES, np.ones((2, 4), np.float32)], 6, "bfloat16")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_collate_is_jax_s(path, dtype):
    """collate over ragged samples with input functions, bucketed and at
    fixed pad lengths: every field bitwise JAX's collate."""
    samples = datasets.synth_elasticity(5, base_points=64, seed=2)
    for kw in ({}, {"pad_nodes": 128, "pad_funcs": 128}):
        got = port_batch.collate(samples, dtype=dtype, **kw)
        want = jax_collate(samples, dtype=dtype, **kw)
        for name in ("coords", "theta", "y", "node_mask", "funcs", "func_mask"):
            g, w = getattr(got, name), getattr(want, name)
            if w is None:
                assert g is None, name
                continue
            assert g.dtype == (torch.bfloat16 if dtype == "bfloat16" else torch.float32)
            np.testing.assert_array_equal(_tn_bits(g), _tn_bits(w), err_msg=name)


def _tn_nan_samples():
    """Samples whose every float field holds JAX's edge values, NaNs of
    both signs first, beside random finite values."""
    rng = np.random.default_rng(9)
    edges = EDGES.ravel()
    out = []
    for n in (7, 12, 5):
        coords = rng.standard_normal((n, 2)).astype(np.float32)
        y = rng.standard_normal((n, 1)).astype(np.float32)
        funcs = (rng.standard_normal((n + 1, 3)).astype(np.float32),)
        coords.ravel()[:4] = edges[:4]
        y.ravel()[:4] = edges[4:8]
        funcs[0].ravel()[:16] = edges
        theta = np.array([np.nan, -np.nan, 0.5], np.float32)
        out.append(port_batch.MeshSample(coords=coords, y=y, theta=theta, funcs=funcs))
    return out


def test_bf16_collate_keeps_the_nan_sign_bits(path):
    """Fault 9: the bf16 host cast went through torch's CPU cast, which
    gives every NaN one bit pattern, where JAX keeps 0x7FC0 / 0xFFC0 by
    sign. collate and pack_collate at bf16 are now bitwise JAX's, NaNs,
    infinities and denormals included."""
    samples = _tn_nan_samples()
    got = port_batch.collate(samples, dtype="bfloat16")
    want = jax_collate(samples, dtype="bfloat16")
    for name in ("coords", "theta", "y", "node_mask", "funcs", "func_mask"):
        np.testing.assert_array_equal(_tn_bits(getattr(got, name)),
                                      _tn_bits(getattr(want, name)), err_msg=name)
    assert {0x7FC0, 0xFFC0} <= set(_tn_bits(got.coords).ravel().tolist())
    placements = [(0, 0), (0, 8), (1, 0)]
    kw = dict(n_rows=2, row_len=24, chunk=4, n_slots=4, pad_funcs=16)
    got = port_batch.pack_collate(samples, placements, dtype="bfloat16", **kw)
    want = jax_pack_collate(samples, placements, dtype="bfloat16", **kw)
    for name in ("coords", "theta", "y", "node_mask", "funcs", "func_mask"):
        g = getattr(got, name)
        assert g.dtype == torch.bfloat16, name
        np.testing.assert_array_equal(_tn_bits(g), _tn_bits(getattr(want, name)),
                                      err_msg=name)
    for name in ("node_seg", "func_seg"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), getattr(want, name))
