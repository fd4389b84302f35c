"""The port's native (C++) host packer, loaded through ctypes.

The serving dispatch and ``collate`` pad ragged row-blocks into a dense
batch on the host and cut each response's rows out of the dispatch
output. ``ragged_pack.cpp`` (the port's copy of the JAX package's
``gnot_tpu/native/ragged_pack.cpp``, same symbols and ABI) does both
in one call each: the pad, the fused pad-and-cast to bfloat16, and the
batched unpad. It builds with ``g++`` into ``build/gnot_tpu_torch/`` at
the root of the checkout the first time a call needs it (never at
import; no ``nvcc`` and no card needed), and is rebuilt when the source
is newer than the library.

Every entry point has a numpy version, and the two are BITWISE equal
(``tests/test_torch_native.py`` holds both against ``gnot_tpu.native``),
so which one ran never changes an answer, only its cost. Which one this
process runs is one probe, :func:`status`; serving emits it as the
one-time ``native_packer`` event and stamps it into ``run.json``.

bfloat16 has no numpy dtype here (the port does not use ``ml_dtypes``):
bf16 results are ``np.uint16`` arrays of bf16 bits, which the caller
views as ``torch.bfloat16`` (``torch.from_numpy(u16).view(torch.bfloat16)``).
:func:`bf16_bits` is the port's one f32 -> bf16 host cast, the C sweep's
formula on the uint32 bits: round to nearest even, a NaN kept as
``0x7FC0`` / ``0xFFC0`` by its sign.

The ctypes signatures in ``_bind`` are cross-checked against the C
declarations by the port's lint rule GL007 (``analysis/native_abi.py``).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

from gnot_tpu_torch.ops.build import BUILD_DIR

_SRC = os.path.join(os.path.dirname(__file__), "ragged_pack.cpp")
_SO = os.path.join(str(BUILD_DIR), "_ragged_pack.so")

_lock = threading.Lock()
_lib = None
_lib_gil = None
_load_failed = False
_load_error: str | None = None

#: Payloads under this run through the GIL-HOLDING handle (PyDLL): a
#: sub-millisecond memory sweep must not pay a GIL release and
#: reacquire, which under a serve storm contends with the submitting
#: client thread (the port's serving is GIL-bound: several replicas on
#: one card share one interpreter). Above it (the threaded multi-MB
#: collate regime) the CDLL handle releases the GIL so a long pack
#: never stalls the interpreter. The JAX package's value.
GIL_HOLD_MAX_BYTES = 2 << 20

#: Minimum total payload (bytes of ragged f32 input) at which ``pack_rows``
#: takes the C sweep, per output dtype. These are the JAX package's
#: crossovers, measured on the JAX package's own host, NOT on the card's
#: machine: ``chip_smoke.py`` phase 20 measures this host's crossovers
#: and reports them. Below a bar numpy runs; bitwise the same either way.
PACK_NATIVE_MIN_BYTES = {"bfloat16": 96 << 10, "float32": 32 << 20}

#: Minimum total payload (bytes copied out) at which ``unpad_rows`` makes
#: one native call instead of a numpy copy per span. The JAX package's
#: crossover, measured on its own host, not on the card's machine (phase
#: 20 of ``chip_smoke.py`` measures this host's).
NATIVE_UNPAD_MIN_BYTES = 4 << 20

_BF16_ONE = 0x3F80  # 1.0 in bfloat16 bits (the mask's value)


def _bind(lib):
    """Attach the ctypes signatures to one dlopen handle. GL007
    cross-checks these against ragged_pack.cpp's extern "C"
    declarations (arity + dtype tags) on every lint run."""
    lib.gnot_pack_rows.argtypes = [
        ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.c_void_p,
        ctypes.c_void_p,
    ]
    lib.gnot_pack_rows.restype = None
    lib.gnot_pack_rows_bf16.argtypes = [
        ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.c_void_p,
        ctypes.c_void_p,
    ]
    lib.gnot_pack_rows_bf16.restype = None
    lib.gnot_unpad_rows.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_void_p),
    ]
    lib.gnot_unpad_rows.restype = None
    return lib


def _load():
    """Build (if stale) and dlopen the packer; None when that failed."""
    global _lib, _lib_gil, _load_failed, _load_error
    if _lib is not None or _load_failed:
        return _lib
    with _lock:
        if _lib is not None or _load_failed:
            return _lib
        try:
            if not os.path.exists(_SO) or os.path.getmtime(_SO) < os.path.getmtime(_SRC):
                os.makedirs(os.path.dirname(_SO), exist_ok=True)
                # Per-process tmp name: concurrent first builds (test
                # workers) never interleave writes; os.replace is atomic.
                tmp = f"{_SO}.{os.getpid()}.tmp"
                # -march=native is safe: the library is built on the
                # machine that runs it, never shipped, and it lets -O3
                # vectorize the bf16 sweep. -fno-strict-aliasing: the
                # sweep reads float bits through a uint32 pointer.
                cmd = ["g++", "-O3", "-march=native", "-fno-strict-aliasing",
                       "-shared", "-fPIC", "-std=c++17", _SRC, "-o", tmp]
                # The build runs under _lock on purpose: every caller
                # needs the library it makes, once per process.
                try:
                    #: allowed_blocking — the one-time build every caller waits for
                    subprocess.run(cmd, check=True, capture_output=True)
                except subprocess.CalledProcessError:
                    # A toolchain without -march=native still builds a
                    # correct, slower library.
                    cmd.remove("-march=native")
                    #: allowed_blocking — the one-time build every caller waits for
                    subprocess.run(cmd, check=True, capture_output=True)
                os.replace(tmp, _SO)
            # Two handles on one library: PyDLL holds the GIL through a
            # call (serve-sized sweeps), CDLL releases it (long packs).
            _lib_gil = _bind(ctypes.PyDLL(_SO))
            _lib = _bind(ctypes.CDLL(_SO))
        except (OSError, subprocess.CalledProcessError, AttributeError) as err:
            _load_failed = True
            _load_error = f"{type(err).__name__}: {err}"
    return _lib


def _handle(payload_bytes: int):
    """The handle for one call: GIL-holding under ``GIL_HOLD_MAX_BYTES``,
    GIL-releasing above it. ``_load()`` must have succeeded."""
    return _lib_gil if payload_bytes < GIL_HOLD_MAX_BYTES else _lib


def native_available() -> bool:
    return _load() is not None


def status() -> dict:
    """Which packer this process runs, and why when it fell back: the
    ``native_packer`` event's and ``run.json``'s record. ``impl:
    "native"`` means the library loaded AND dispatch is the payload-gated
    policy, whose bars are part of the record: below them numpy runs by
    choice. Builds the library when it is not loaded yet."""
    lib = _load()
    return {
        "available": lib is not None,
        "impl": "native" if lib is not None else "python",
        "so": _SO if lib is not None else None,
        "error": _load_error,
        "pack_native_min_bytes": dict(PACK_NATIVE_MIN_BYTES),
        "unpad_native_min_bytes": NATIVE_UNPAD_MIN_BYTES,
    }


def bf16_bits(a: np.ndarray) -> np.ndarray:
    """bfloat16 bits (``np.uint16``) of ``a`` rounded to f32 first, then
    to bf16 by round-to-nearest-even; a NaN becomes ``0x7FC0`` or
    ``0xFFC0`` by its sign. Bitwise ``ragged_pack.cpp``'s sweep and
    ``ml_dtypes``' cast (``torch``'s CPU cast turns every NaN into one
    pattern, so it is not used for host data)."""
    x = np.ascontiguousarray(a, np.float32).view(np.uint32)
    rne = ((x + np.uint32(0x7FFF) + ((x >> 16) & 1)) >> 16).astype(np.uint16)
    nan = (x & 0x7FFFFFFF) > 0x7F800000
    if not nan.any():
        return rne
    return np.where(nan, np.where(x >> 31, 0xFFC0, 0x7FC0).astype(np.uint16), rne)


def _check_blocks(arrs: list[np.ndarray], max_len: int) -> None:
    dim = arrs[0].shape[1] if arrs[0].ndim == 2 else -1
    for a in arrs:
        if a.ndim != 2 or a.shape[1] != dim:
            raise ValueError(
                f"pack_rows needs uniform [len_i, {dim}] blocks, got {a.shape}"
            )
    too_long = max(a.shape[0] for a in arrs)
    if too_long > max_len:
        raise ValueError(f"row block of {too_long} rows exceeds max_len={max_len}")


def _pack_numpy(arrs, max_len, dtype):
    n, dim = len(arrs), arrs[0].shape[1]
    bf16 = dtype == "bfloat16"
    out = np.zeros((n, max_len, dim), np.uint16 if bf16 else np.float32)
    mask = np.zeros((n, max_len), out.dtype)
    for i, a in enumerate(arrs):
        # Non-f32 input is rounded to f32 first on both paths: the C
        # sweep reads f32 bits, so f64 -> bf16 must be f64 -> f32 -> bf16.
        a32 = np.ascontiguousarray(a, np.float32)
        out[i, : a.shape[0]] = bf16_bits(a32) if bf16 else a32
        mask[i, : a.shape[0]] = _BF16_ONE if bf16 else 1.0
    return out, mask


def pack_rows_numpy(
    arrs: list[np.ndarray], max_len: int, dtype: str = "float32"
) -> tuple[np.ndarray, np.ndarray]:
    """The numpy version: pad ``[len_i, dim]`` blocks to ``[n, max_len,
    dim]`` plus an ``[n, max_len]`` 0/1 mask (zero pad at the row tail,
    reference utils.py:3-4). ``dtype="bfloat16"`` gives both as bf16 bits
    (``np.uint16``), bitwise the fused native sweep."""
    _check_blocks(arrs, max_len)
    return _pack_numpy(arrs, max_len, dtype)


def pack_rows(
    arrs: list[np.ndarray], max_len: int, dtype: str = "float32"
) -> tuple[np.ndarray, np.ndarray]:
    """Pack ragged row-blocks into a padded batch and its mask, through
    the C sweep from ``PACK_NATIVE_MIN_BYTES[dtype]`` of input up, numpy
    below. ``dtype="bfloat16"`` is the fused pad-and-cast: one sweep
    emits the half-width batch as bf16 bits (``np.uint16``), with no f32
    batch built first."""
    if dtype not in ("float32", "bfloat16"):
        raise ValueError(f"pack_rows dtype must be float32|bfloat16, got {dtype!r}")
    _check_blocks(arrs, max_len)
    dim = arrs[0].shape[1]
    payload = sum(a.shape[0] for a in arrs) * dim * 4
    lib = _load() if payload >= PACK_NATIVE_MIN_BYTES[dtype] else None
    if lib is None:
        return _pack_numpy(arrs, max_len, dtype)
    n = len(arrs)
    contig = [np.ascontiguousarray(a, np.float32) for a in arrs]
    # np.zeros, not np.empty: the C side writes the payload and the mask
    # prefix only, and calloc's lazy zero pages make the pad tail free.
    out = np.zeros((n, max_len, dim), np.uint16 if dtype == "bfloat16" else np.float32)
    mask = np.zeros((n, max_len), out.dtype)
    srcs = np.fromiter(
        (a.__array_interface__["data"][0] for a in contig), dtype=np.uintp, count=n
    )
    lens = np.fromiter((a.shape[0] for a in contig), dtype=np.int64, count=n)
    lib = _handle(payload)
    fn = lib.gnot_pack_rows_bf16 if dtype == "bfloat16" else lib.gnot_pack_rows
    fn(
        srcs.ctypes.data_as(ctypes.POINTER(ctypes.c_void_p)),
        lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        n,
        dim,
        max_len,
        out.ctypes.data_as(ctypes.c_void_p),
        mask.ctypes.data_as(ctypes.c_void_p),
    )
    return out, mask


def _check_spans(out: np.ndarray, spans) -> None:
    if out.ndim != 3:
        raise ValueError(f"unpad_rows needs a [R, L, dim] output, got {out.shape}")
    for r, off, length in spans:
        if not (0 <= r < out.shape[0] and 0 <= off and off + length <= out.shape[1]):
            raise ValueError(
                f"span {(r, off, length)} out of bounds for {out.shape}"
            )


def unpad_rows_numpy(
    out: np.ndarray, spans: list[tuple[int, int, int]]
) -> list[np.ndarray]:
    """The numpy version: per-span OWNED copies ``out[row, off:off+length]``,
    so no response pins the whole dispatch buffer."""
    _check_spans(out, spans)
    return [out[r, off : off + length].copy() for r, off, length in spans]


def unpad_rows(
    out: np.ndarray, spans: list[tuple[int, int, int]]
) -> list[np.ndarray]:
    """Batched unpad: each request's ``[length, dim]`` block of a dense
    ``[R, L, dim]`` dispatch output as an OWNED array (``spans`` are
    ``(row, offset, length)``: ``(i, 0, n_i)`` padded, the segment
    placements packed). One native call from ``NATIVE_UNPAD_MIN_BYTES``
    copied up, a numpy copy per span below; the same bytes either way."""
    _check_spans(out, spans)
    n = len(spans)
    row_len, dim = out.shape[1], out.shape[2]
    total = sum(length for _, _, length in spans) * dim * out.itemsize
    lib = _load() if n and total >= NATIVE_UNPAD_MIN_BYTES else None
    if lib is None:
        return [out[r, off : off + length].copy() for r, off, length in spans]
    src = np.ascontiguousarray(out)
    tok_bytes = dim * src.itemsize
    dsts = [np.empty((length, dim), src.dtype) for _, _, length in spans]
    meta = np.array(spans, np.int64).reshape(n, 3).T.copy()
    ptrs = np.fromiter(
        (d.__array_interface__["data"][0] for d in dsts), dtype=np.uintp, count=n
    )
    as_i64 = ctypes.POINTER(ctypes.c_int64)
    lib = _handle(total)
    lib.gnot_unpad_rows(
        src.ctypes.data_as(ctypes.c_void_p),
        meta[0].ctypes.data_as(as_i64),
        meta[1].ctypes.data_as(as_i64),
        meta[2].ctypes.data_as(as_i64),
        n,
        row_len * tok_bytes,
        tok_bytes,
        ptrs.ctypes.data_as(ctypes.POINTER(ctypes.c_void_p)),
    )
    return dsts
