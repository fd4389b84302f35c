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

``PackedBatch``, ``pack_collate``, ``PackPlan``, ``pack_prefix`` and
``PackedLoader`` port the packed ("pack, don't pad") layout: several
samples share a row as chunk-aligned segments, and ``node_seg`` /
``func_seg`` are the chunk -> segment tables the packed model and the
segment attention kernels take.

``Loader`` and ``PackedLoader`` are the training epoch iterators:
shuffle, batch (or pack), collate on the host in a prefetch thread; the
trainer moves each batch to the device.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator, Sequence

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

    @property
    def n_real_points(self) -> int:
        return int(self.node_mask.float().sum())

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

    def _map(self, fn) -> "MeshBatch":
        return MeshBatch(
            **{
                f.name: None if (t := getattr(self, f.name)) is None else fn(t)
                for f in dataclasses.fields(self)
            }
        )

    def to(self, device: torch.device | str, non_blocking: bool = False) -> "MeshBatch":
        """The same batch with every field on ``device``."""
        return self._map(lambda t: t.to(device, non_blocking=non_blocking))

    def pin_memory(self) -> "MeshBatch":
        """The same batch in page-locked host memory, which a copy to the
        card with ``non_blocking=True`` reads without stalling the host
        or the stream."""
        return self._map(torch.Tensor.pin_memory)


@dataclasses.dataclass
class PackedBatch:
    """A packed batch, every field a tensor on the same device: samples
    share each row as chunk-aligned contiguous segments.

    Shapes: R rows, L row length (a multiple of the chunk C), N = L / C
    chunks per row, S sample slots, F input functions, Lf function pad
    length. Input functions are not packed: they stay slot-indexed
    ``[F, S, Lf, df]``, each slot one one-chunk segment.
    """

    coords: torch.Tensor  # [R, L, dx]
    theta: torch.Tensor  # [S, T] per-sample params (slot-indexed)
    y: torch.Tensor  # [R, L, dy]
    node_mask: torch.Tensor  # [R, L]
    node_seg: torch.Tensor  # [R, N] int32 chunk -> slot ids; pad chunks = S
    funcs: torch.Tensor | None = None  # [F, S, Lf, df]
    func_mask: torch.Tensor | None = None  # [F, S, Lf]
    func_seg: torch.Tensor | None = None  # [S, 1] slot ids (S for empty slots)
    n_seg: int = 0

    @property
    def n_real_points(self) -> int:
        return int(self.node_mask.float().sum())

    def signature(self) -> tuple:
        """``(shape, dtype)`` of every tensor field and ``n_seg``: one
        entry per distinct dispatch shape."""
        return tuple(
            (tuple(t.shape), str(t.dtype)) if t is not None else None
            for t in (
                self.coords, self.theta, self.y, self.node_mask, self.node_seg,
                self.funcs, self.func_mask, self.func_seg,
            )
        ) + (self.n_seg,)

    def _map(self, fn) -> "PackedBatch":
        return PackedBatch(
            **{
                f.name: v if (v := getattr(self, f.name)) is None or f.name == "n_seg" else fn(v)
                for f in dataclasses.fields(self)
            }
        )

    def to(self, device: torch.device | str, non_blocking: bool = False) -> "PackedBatch":
        """The same batch with every tensor on ``device``."""
        return self._map(lambda t: t.to(device, non_blocking=non_blocking))

    def pin_memory(self) -> "PackedBatch":
        """The same batch in page-locked host memory."""
        return self._map(torch.Tensor.pin_memory)


def bucket_length(n: int, *, min_size: int = 64) -> int:
    """Round up to the next power-of-two-ish bucket (1, 1.5 mantissa)."""
    size = min_size
    while size < n:
        if int(size * 1.5) >= n and (size & (size - 1)) == 0:
            return int(size * 1.5)
        size *= 2
    return size


def fixed_pad_lengths(
    samples: Sequence[MeshSample], *, bucket: bool = True
) -> tuple[int, int]:
    """Dataset-wide ``(pad_nodes, pad_funcs)`` targets: the maxima over
    ALL samples (bucketed), so every batch has one shape, as the ranks of
    a mesh need (``gnot_tpu/data/batch.py::fixed_pad_lengths``)."""
    pn = max(s.coords.shape[0] for s in samples)
    pf = max((f.shape[0] for s in samples for f in s.funcs), default=0)
    if bucket:
        pn = bucket_length(pn)
        pf = bucket_length(pf) if pf else 0
    return pn, pf


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
    dtype: str = "float32",
) -> MeshBatch:
    """Pad and stack ragged samples on the host, then move them onto
    ``device`` as one ``MeshBatch``. ``pad_nodes``/``pad_funcs`` force
    fixed pad lengths (0 = per-batch max, optionally bucketed).
    ``dtype="bfloat16"`` is the bf16 serving batch: every float field,
    masks included, is rounded to bf16 (nearest even) on the host, so the
    copy to the card moves half the bytes; bitwise what the JAX
    package's ``collate(dtype="bfloat16")`` gives."""
    if dtype not in ("float32", "bfloat16"):
        raise ValueError(f"collate dtype must be float32|bfloat16, got {dtype!r}")
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
    target = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    return MeshBatch(
        **{
            k: None if v is None else torch.from_numpy(v).to(target).to(device)
            for k, v in arrays.items()
        }
    )


def pack_collate(
    samples: Sequence[MeshSample],
    placements: Sequence[tuple[int, int]],
    *,
    n_rows: int,
    row_len: int,
    chunk: int,
    n_slots: int,
    pad_funcs: int,
    device: torch.device | str = "cpu",
    dtype: str = "float32",
) -> PackedBatch:
    """Assemble one ``PackedBatch`` on ``device`` from samples and their
    chunk-aligned ``(row, offset)`` placements. Slot ids are assignment
    order; unused rows and slots stay zero / pad. ``dtype="bfloat16"`` is
    the bf16 packed serving dispatch: every float field is rounded to bf16
    (nearest even) on the host, the segment tables stay int32; bitwise
    what the JAX package's ``pack_collate(dtype="bfloat16")`` gives."""
    if dtype not in ("float32", "bfloat16"):
        raise ValueError(f"pack_collate dtype must be float32|bfloat16, got {dtype!r}")
    dx = samples[0].coords.shape[-1]
    dy = samples[0].y.shape[-1]
    n_funcs = len(samples[0].funcs)
    coords = np.zeros((n_rows, row_len, dx), np.float32)
    y = np.zeros((n_rows, row_len, dy), np.float32)
    node_mask = np.zeros((n_rows, row_len), np.float32)
    node_seg = np.full((n_rows, row_len // chunk), n_slots, np.int32)
    theta = np.zeros((n_slots, np.atleast_1d(samples[0].theta).shape[-1]), np.float32)
    funcs = func_mask = func_seg = None
    if n_funcs:
        df = samples[0].funcs[0].shape[-1]
        funcs = np.zeros((n_funcs, n_slots, pad_funcs, df), np.float32)
        func_mask = np.zeros((n_funcs, n_slots, pad_funcs), np.float32)
        func_seg = np.full((n_slots, 1), n_slots, np.int32)
    for slot, (s, (r, off)) in enumerate(zip(samples, placements)):
        n = s.coords.shape[0]
        coords[r, off : off + n] = s.coords
        y[r, off : off + n] = s.y
        node_mask[r, off : off + n] = 1.0
        node_seg[r, off // chunk : (off + n + chunk - 1) // chunk] = slot
        theta[slot] = np.atleast_1d(np.asarray(s.theta, np.float32))
        for j, f in enumerate(s.funcs):
            funcs[j, slot, : f.shape[0]] = f
            func_mask[j, slot, : f.shape[0]] = 1.0
        if n_funcs:
            func_seg[slot, 0] = slot
    target = torch.bfloat16 if dtype == "bfloat16" else torch.float32

    def put(a: np.ndarray | None) -> torch.Tensor | None:
        if a is None:
            return None
        t = torch.from_numpy(a)
        return (t if a.dtype == np.int32 else t.to(target)).to(device)

    return PackedBatch(
        coords=put(coords), theta=put(theta), y=put(y), node_mask=put(node_mask),
        node_seg=put(node_seg), funcs=put(funcs), func_mask=put(func_mask),
        func_seg=put(func_seg), n_seg=n_slots,
    )


@dataclasses.dataclass(frozen=True)
class PackPlan:
    """The static shape of one packed dispatch: ``n_rows`` rows of
    ``row_len`` tokens (chunk-aligned segments), ``n_slots`` sample
    slots, input functions padded to ``pad_funcs``."""

    row_len: int
    chunk: int
    n_rows: int
    n_slots: int
    pad_funcs: int

    def __post_init__(self) -> None:
        if self.chunk < 1:
            raise ValueError(f"chunk must be >= 1, got {self.chunk}")
        if self.row_len % self.chunk:
            raise ValueError(
                f"row_len {self.row_len} must be a multiple of chunk "
                f"{self.chunk}"
            )
        if self.n_rows < 1 or self.n_slots < 1:
            raise ValueError("n_rows and n_slots must be >= 1")

    @classmethod
    def from_samples(
        cls,
        samples: Sequence[MeshSample],
        *,
        chunk: int = 128,
        n_rows: int = 0,
        batch_size: int = 4,
        row_len: int = 0,
    ) -> "PackPlan":
        """A plan from representative traffic: ``row_len`` fits about two
        samples of the largest size (bucketed), ``n_rows`` carries about
        ``batch_size`` samples per dispatch, and the slots are sized so
        that no packing of the row grid can overflow them."""
        if not samples:
            raise ValueError("PackPlan.from_samples needs at least one sample")
        aligned = [-(-s.coords.shape[0] // chunk) * chunk for s in samples]
        if not row_len:
            row_len = -(-bucket_length(2 * max(aligned)) // chunk) * chunk
        mean_a = float(np.mean(aligned))
        if not n_rows:
            n_rows = max(1, -(-int(batch_size * mean_a) // row_len))
        # Traffic may include samples down to one chunk.
        n_slots = n_rows * (row_len // chunk)
        pad_funcs = max((f.shape[0] for s in samples for f in s.funcs), default=0)
        if pad_funcs:
            pad_funcs = bucket_length(pad_funcs)
        return cls(
            row_len=row_len, chunk=chunk, n_rows=n_rows,
            n_slots=n_slots, pad_funcs=pad_funcs,
        )

    def aligned(self, n: int) -> int:
        """Chunk-aligned token footprint of an n-point mesh."""
        return -(-n // self.chunk) * self.chunk

    def packable(self, sample: MeshSample) -> bool:
        """Whether this sample fits a packed dispatch: its aligned span
        fits one row and every input function fits the slot pad."""
        if self.aligned(sample.coords.shape[0]) > self.row_len:
            return False
        return all(f.shape[0] <= self.pad_funcs for f in sample.funcs)

    @property
    def capacity_tokens(self) -> int:
        """Token capacity of one dispatch (the pad-waste denominator)."""
        return self.n_rows * self.row_len

    @classmethod
    def for_slices(
        cls,
        samples: Sequence[MeshSample],
        *,
        chunk: int,
        batch_size: int,
        per_devices: int,
    ) -> "PackPlan":
        """``from_samples`` whose row count divides over a
        ``per_devices``-wide replica slice, so that every slice gets whole
        rows; the one place the alignment rule lives (the serve entry
        point calls it with one device)."""
        plan = cls.from_samples(samples, chunk=chunk, batch_size=batch_size)
        per = max(1, per_devices)
        if plan.n_rows % per:
            plan = cls.from_samples(
                samples, chunk=chunk, batch_size=batch_size,
                n_rows=-(-plan.n_rows // per) * per,
            )
        return plan


def pack_prefix(sizes: Sequence[int], plan: PackPlan) -> list[tuple[int, int]]:
    """First-fit packing of an arrival-order prefix into one ``plan``-shaped
    dispatch: each sample goes into the first row with space, and packing
    stops at the first sample that fits nowhere (or when the slots run
    out), so a request never overtakes an older one. Returns the
    ``(row, offset)`` placements of the packed prefix."""
    used = [0] * plan.n_rows
    placements: list[tuple[int, int]] = []
    for n in sizes:
        if len(placements) >= plan.n_slots:
            break
        a = plan.aligned(n)
        for r in range(plan.n_rows):
            if used[r] + a <= plan.row_len:
                placements.append((r, used[r]))
                used[r] += a
                break
        else:
            break
    return placements


# Collated batches the prefetch thread may hold ahead of the consumer.
PREFETCH_DEPTH = 2


def _prefetched(items, collate_fn):
    """Collate ``items`` on a background thread with a bounded queue, so
    the host collates batch N+1 while the device runs batch N.
    An error in the thread is raised to the consumer; a consumer that
    stops early stops the thread."""
    q: queue.Queue = queue.Queue(maxsize=PREFETCH_DEPTH)
    stop = threading.Event()
    end = object()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            for it in items:
                if not put(collate_fn(it)):
                    return  # the consumer abandoned the epoch
            put(end)
        except BaseException as e:  # handed to the consumer, raised there
            put(e)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is end:
                break
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        t.join()


class Loader:
    """Epoch iterator: shuffle, batch, collate on the host, prefetch.

    Port of ``gnot_tpu/data/batch.py::Loader`` (the reference's
    ``DataLoader(batch_size=4, shuffle=True, collate_fn=unzip)``,
    main.py:37-42). Each epoch's order is a pure function of
    ``(seed, epoch)``, ``np.random.default_rng((seed, epoch)).shuffle``,
    the JAX package's own draw, so a resumed run sees the batches the
    continuous run would have. Batches are ``MeshBatch``es of CPU tensors,
    page-locked with ``pin_memory`` (on the prefetch thread); the caller
    moves them to its device.
    """

    def __init__(
        self,
        samples: Sequence[MeshSample],
        batch_size: int,
        *,
        shuffle: bool = False,
        seed: int = 0,
        bucket: bool = True,
        drop_remainder: bool = False,
        pad_nodes: int = 0,
        pad_funcs: int = 0,
        pin_memory: bool = False,
    ):
        self.samples = list(samples)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.bucket = bucket
        self.drop_remainder = drop_remainder
        self.pad_nodes = pad_nodes
        self.pad_funcs = pad_funcs
        self.pin_memory = pin_memory
        # Advanced by __iter__; set_epoch() pins it (trainer resume).
        self._epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch

    def __len__(self) -> int:
        n = len(self.samples)
        if self.drop_remainder:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def epoch_indices(self) -> list[np.ndarray]:
        """This epoch's batches as sample indices; advances the epoch."""
        order = np.arange(len(self.samples))
        if self.shuffle:
            np.random.default_rng((self.seed, self._epoch)).shuffle(order)
        self._epoch += 1
        chunks = []
        for start in range(0, len(order), self.batch_size):
            idx = order[start : start + self.batch_size]
            if self.drop_remainder and len(idx) < self.batch_size:
                break
            chunks.append(idx)
        return chunks

    def collate_at(self, idx: np.ndarray) -> MeshBatch:
        batch = collate(
            [self.samples[i] for i in idx],
            bucket=self.bucket,
            pad_nodes=self.pad_nodes,
            pad_funcs=self.pad_funcs,
        )
        return batch.pin_memory() if self.pin_memory else batch

    def __iter__(self) -> Iterator[MeshBatch]:
        yield from _prefetched(self.epoch_indices(), self.collate_at)


class PackedLoader:
    """Epoch iterator over packed batches (``gnot_tpu/data/batch.py::PackedLoader``).

    The epoch's (shuffled) sample stream is first-fit packed into rows of
    one fixed length, then ``n_rows`` consecutive rows form each
    dispatch: every dispatch has one shape, and rows fill to ~90% where
    bucket padding fills ~70% on ragged meshes. ``batch_size`` is the
    nominal samples per step (the row count is sized so a dispatch carries
    about that many on average); the count per dispatch varies with the
    packing. The order is ``np.random.default_rng((seed, epoch))``'s
    shuffle, the JAX package's draw, so both packages pack the same
    dispatches. ``row_multiple`` rounds the row count up so rows split
    evenly over a data axis.
    """

    def __init__(
        self,
        samples: Sequence[MeshSample],
        batch_size: int,
        *,
        chunk: int = 128,
        shuffle: bool = False,
        seed: int = 0,
        row_multiple: int = 1,
        pin_memory: bool = False,
    ):
        if not samples:
            raise ValueError("PackedLoader needs at least one sample")
        self.samples = list(samples)
        self.batch_size = batch_size
        self.chunk = chunk
        self.shuffle = shuffle
        self.seed = seed
        self.pin_memory = pin_memory
        self._epoch = 0
        self._aligned = [-(-s.coords.shape[0] // chunk) * chunk for s in self.samples]
        max_a, min_a = max(self._aligned), min(self._aligned)
        # ~2 max-size samples per row, bucketed, on the chunk grid.
        self.row_len = -(-bucket_length(2 * max_a) // chunk) * chunk
        mean_a = float(np.mean(self._aligned))
        n_rows = max(1, -(-int(batch_size * mean_a) // self.row_len))
        self.n_rows = -(-n_rows // row_multiple) * row_multiple
        # No n_rows-row window can carry more samples than this.
        self.n_slots = self.n_rows * (self.row_len // min_a)
        self.pad_funcs = max((f.shape[0] for s in self.samples for f in s.funcs), default=0)
        if self.pad_funcs:
            self.pad_funcs = bucket_length(self.pad_funcs)
        self._canonical_len: int | None = None

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch

    def _unshuffled(self, fn):
        """``fn()`` on the canonical (unshuffled) stream, leaving the
        epoch counter and the shuffle flag as they were."""
        epoch, shuffle = self._epoch, self.shuffle
        self.shuffle = False
        try:
            return fn()
        finally:
            self._epoch, self.shuffle = epoch, shuffle

    def probe_batch(self) -> PackedBatch:
        """The canonical stream's first dispatch, for shape probing; the
        epoch counter does not move."""
        return self.collate_at(self._unshuffled(self.epoch_dispatches)[0])

    def epoch_dispatches(self) -> list[tuple[list[int], list[tuple[int, int]]]]:
        """This epoch's dispatches as ``(sample indices, (row, offset)
        placements)``; advances the epoch. First-fit with open rows: each
        sample goes into the first row it fits, and a row whose space
        left fits no sample closes."""
        order = np.arange(len(self.samples))
        if self.shuffle:
            np.random.default_rng((self.seed, self._epoch)).shuffle(order)
        self._epoch += 1
        min_a = min(self._aligned)
        open_rows: list[list] = []  # [used, [(sample index, offset)]]
        closed: list[list] = []
        for i in order:
            a = self._aligned[i]
            for rb in open_rows:
                if rb[0] + a <= self.row_len:
                    rb[1].append((int(i), rb[0]))
                    rb[0] += a
                    break
            else:
                open_rows.append([a, [(int(i), 0)]])
            closed.extend(rb for rb in open_rows if self.row_len - rb[0] < min_a)
            open_rows = [rb for rb in open_rows if self.row_len - rb[0] >= min_a]
        rows = [rb[1] for rb in closed + open_rows]
        dispatches = []
        for start in range(0, len(rows), self.n_rows):
            group = rows[start : start + self.n_rows]
            idx = [i for row in group for i, _ in row]
            placements = [(r, off) for r, row in enumerate(group) for _, off in row]
            dispatches.append((idx, placements))
        return dispatches

    def __len__(self) -> int:
        """The canonical stream's exact dispatch count; a shuffled epoch
        may pack one row group more or fewer, so callers that must not
        drop a dispatch iterate to the end (``Trainer.evaluate``)."""
        if self._canonical_len is None:
            self._canonical_len = len(self._unshuffled(self.epoch_dispatches))
        return self._canonical_len

    def collate_at(self, dispatch) -> PackedBatch:
        idx, placements = dispatch
        batch = pack_collate(
            [self.samples[i] for i in idx],
            placements,
            n_rows=self.n_rows,
            row_len=self.row_len,
            chunk=self.chunk,
            n_slots=self.n_slots,
            pad_funcs=self.pad_funcs,
        )
        return batch.pin_memory() if self.pin_memory else batch

    def __iter__(self) -> Iterator[PackedBatch]:
        yield from _prefetched(self.epoch_dispatches(), self.collate_at)
