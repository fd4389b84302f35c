"""Dense batch container + ragged->dense batching.

Port of ``gnot_tpu/data/batch.py`` for the unpacked serving path. The
reference's padding semantics stay as they are:

  * input functions are padded to the **single max length across ALL
    functions of ALL samples in the batch** (reference main.py:63 — one
    shared max, not per-function);
  * coords/targets are padded to the per-batch max node count;
  * zero padding at the tail of the length axis (reference utils.py:3-4).

Bucketing rounds pad lengths up to the next bucket boundary so the
number of distinct dispatch shapes is O(log L). Packing runs in numpy
(``pack_rows_numpy``, the same bytes as ``gnot_tpu``'s native packer);
the finished batch is a ``MeshBatch`` of tensors on one device.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch


@dataclasses.dataclass
class MeshSample:
    """One ragged sample: ``[X, Y, theta, (f1, f2, ...)]`` — the pickle
    record schema of the reference (dataset.py:7)."""

    coords: np.ndarray  # [n, dx]
    y: np.ndarray  # [n, dy]
    theta: np.ndarray  # [T]
    funcs: tuple[np.ndarray, ...] = ()  # each [m_i, df]


@dataclasses.dataclass
class MeshBatch:
    """One padded batch of ragged PDE meshes, every field a tensor on
    the same device.

    Shapes: B batch, L max nodes, Lf max input-function points, F number
    of input functions, dx/df/dy coordinate/function/output dims, T theta.
    """

    coords: torch.Tensor  # [B, L, dx]
    theta: torch.Tensor  # [B, T]
    y: torch.Tensor  # [B, L, dy]
    node_mask: torch.Tensor  # [B, L] 1 for real nodes, 0 for padding
    funcs: torch.Tensor | None = None  # [F, B, Lf, df]
    func_mask: torch.Tensor | None = None  # [F, B, Lf]

    def signature(self) -> tuple:
        """``(shape, dtype)`` of every field: one entry per distinct
        dispatch shape."""
        return tuple(
            (tuple(t.shape), str(t.dtype)) if t is not None else None
            for t in (
                self.coords, self.theta, self.y, self.node_mask,
                self.funcs, self.func_mask,
            )
        )


def bucket_length(n: int, *, min_size: int = 64) -> int:
    """Round up to the next power-of-two-ish bucket (1, 1.5 mantissa)."""
    size = min_size
    while size < n:
        if int(size * 1.5) >= n and (size & (size - 1)) == 0:
            return int(size * 1.5)
        size *= 2
    return size


def validate_samples(
    samples: Sequence[MeshSample],
    *,
    pad_nodes: int = 0,
    pad_funcs: int = 0,
) -> None:
    """Reject malformed inference inputs with the offending sample index.

    Oversize meshes/functions against FIXED pad lengths, and non-finite
    coords / input functions / theta / targets (one NaN query would
    poison every batchmate through the shared attention Grams), raise a
    ValueError naming ``sample i``.
    """
    for i, s in enumerate(samples):
        if pad_nodes and s.coords.shape[0] > pad_nodes:
            raise ValueError(
                f"sample {i} has {s.coords.shape[0]} mesh points but the "
                f"fixed pad length is {pad_nodes} (set from the training "
                "data); rebuild with larger pad_nodes"
            )
        if pad_funcs:
            for j, f in enumerate(s.funcs):
                if f.shape[0] > pad_funcs:
                    raise ValueError(
                        f"sample {i} input function {j} has {f.shape[0]} "
                        f"points but the fixed pad length is {pad_funcs}; "
                        "rebuild with larger pad_funcs"
                    )
        if not np.all(np.isfinite(s.coords)):
            raise ValueError(f"sample {i} has non-finite mesh coordinates")
        if not np.all(np.isfinite(np.asarray(s.theta, dtype=np.float64))):
            raise ValueError(f"sample {i} has non-finite theta parameters")
        if s.y is not None and not np.all(np.isfinite(s.y)):
            raise ValueError(f"sample {i} has non-finite target values")
        for j, f in enumerate(s.funcs):
            if not np.all(np.isfinite(f)):
                raise ValueError(
                    f"sample {i} input function {j} has non-finite values"
                )


def pad_rows(arr: np.ndarray, length: int) -> np.ndarray:
    """Zero-pad axis 0 to ``length`` (reference utils.py:3-4)."""
    if arr.shape[0] == length:
        return arr
    pad = [(0, length - arr.shape[0])] + [(0, 0)] * (arr.ndim - 1)
    return np.pad(arr, pad)


def pack_rows_numpy(
    arrs: list[np.ndarray], max_len: int
) -> tuple[np.ndarray, np.ndarray]:
    """Pad ``[len_i, dim]`` blocks to ``[n, max_len, dim]`` float32 plus
    an ``[n, max_len]`` 0/1 mask (zero pad at the row tail)."""
    dim = arrs[0].shape[1] if arrs[0].ndim == 2 else -1
    for a in arrs:
        if a.ndim != 2 or a.shape[1] != dim:
            raise ValueError(
                f"pack_rows needs uniform [len_i, {dim}] blocks, got {a.shape}"
            )
    too_long = max(a.shape[0] for a in arrs)
    if too_long > max_len:
        raise ValueError(f"row block of {too_long} rows exceeds max_len={max_len}")
    out = np.zeros((len(arrs), max_len, dim), np.float32)
    mask = np.zeros((len(arrs), max_len), np.float32)
    for i, a in enumerate(arrs):
        out[i, : a.shape[0]] = np.ascontiguousarray(a, np.float32)
        mask[i, : a.shape[0]] = 1.0
    return out, mask


def unpad_rows_numpy(
    out: np.ndarray, spans: list[tuple[int, int, int]]
) -> list[np.ndarray]:
    """Per-span OWNED copies ``out[row, off:off+length]`` — no response
    pins the whole dispatch buffer."""
    if out.ndim != 3:
        raise ValueError(f"unpad_rows needs a [R, L, dim] output, got {out.shape}")
    for r, off, length in spans:
        if not (0 <= r < out.shape[0] and 0 <= off and off + length <= out.shape[1]):
            raise ValueError(
                f"span {(r, off, length)} out of bounds for {out.shape}"
            )
    return [out[r, off : off + length].copy() for r, off, length in spans]


def collate(
    samples: Sequence[MeshSample],
    *,
    bucket: bool = True,
    pad_nodes: int = 0,
    pad_funcs: int = 0,
    device: torch.device | str = "cpu",
) -> MeshBatch:
    """Pad and stack ragged samples on the host, then move them onto
    ``device`` as one ``MeshBatch``. ``pad_nodes``/``pad_funcs`` force
    fixed pad lengths (0 = per-batch max, optionally bucketed)."""
    if pad_nodes:
        max_nodes = pad_nodes
    else:
        max_nodes = max(s.coords.shape[0] for s in samples)
        if bucket:
            max_nodes = bucket_length(max_nodes)

    coords, node_mask = pack_rows_numpy([s.coords for s in samples], max_nodes)
    y, _ = pack_rows_numpy([s.y for s in samples], max_nodes)
    theta = np.stack(
        [np.atleast_1d(np.asarray(s.theta, np.float32)) for s in samples]
    )

    n_funcs = len(samples[0].funcs)
    funcs = func_mask = None
    if n_funcs:
        if pad_funcs:
            max_f = pad_funcs
        else:
            # Single shared max across every function of every sample
            # (reference main.py:63).
            max_f = max(f.shape[0] for s in samples for f in s.funcs)
            if bucket:
                max_f = bucket_length(max_f)
        packed = [
            pack_rows_numpy([s.funcs[j] for s in samples], max_f)
            for j in range(n_funcs)
        ]
        funcs = np.stack([p[0] for p in packed])
        func_mask = np.stack([p[1] for p in packed])
    arrays = dict(
        coords=coords, theta=theta, y=y, node_mask=node_mask,
        funcs=funcs, func_mask=func_mask,
    )
    return MeshBatch(
        **{
            k: None if v is None else torch.from_numpy(v).to(device)
            for k, v in arrays.items()
        }
    )
