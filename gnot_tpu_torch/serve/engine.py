"""InferenceEngine: the forward path for inference, offline and serving.

Port of ``gnot_tpu/serve/engine.py::InferenceEngine`` without the AOT
table, program catalog, sanitizer or precision policy. Two entry points:

* ``predict(samples)`` — the offline, all-at-once path: bucketed
  batches of ``batch_size``, per-sample unpadded outputs.
* ``infer(samples, pad_nodes=, pad_funcs=, rows=)`` — ONE dispatch at
  one fully static shape, the serving hot path. Short batches are
  padded to ``rows`` with repeats of the last sample, so a bucket always
  dispatches at one shape; ``dispatch_shapes`` counts the distinct
  shapes seen (the JAX engine's ``compiled_shapes``).

The weights are swapped atomically under a lock (``swap_params``); a
dispatch reads the published model once, so in-flight requests always
see one consistent weight set.
"""

from __future__ import annotations

import copy
import threading
from typing import Mapping, Sequence

import numpy as np
import torch

from gnot_tpu_torch.data.batch import (
    MeshSample,
    bucket_length,
    collate,
    unpad_rows_numpy,
    validate_samples,
)
from gnot_tpu_torch.models.gnot import GNOT, apply_batch


class InferenceEngine:
    """Validated, bucketed, statically-shaped batched forward of one
    ``GNOT`` on one device."""

    def __init__(self, model: GNOT, *, batch_size: int):
        self.batch_size = batch_size
        self.device = next(model.parameters()).device
        self._lock = threading.Lock()
        # The published model; swap_params replaces the reference.
        self._model = model.eval()  #: guarded_by _lock
        # Distinct dispatch signatures seen so far.
        self._shapes: set[tuple] = set()  #: guarded_by _lock

    # -- params ------------------------------------------------------------

    def swap_params(self, state_dict: Mapping[str, torch.Tensor]) -> None:
        """Publish a new weight set (hot reload). A copy of the model
        takes the new weights; in-flight dispatches keep the model they
        already read, the next dispatch sees the new one."""
        with self._lock:
            current = self._model
        fresh = copy.deepcopy(current)
        fresh.load_state_dict(state_dict, strict=True)
        fresh.eval()
        with self._lock:
            self._model = fresh

    @property
    def model(self) -> GNOT:
        with self._lock:
            return self._model

    # -- validation / bucketing --------------------------------------------

    def validate(self, samples: Sequence[MeshSample]) -> None:
        """Reject non-finite inputs with the offending sample index."""
        validate_samples(samples)

    @staticmethod
    def bucket_key(sample: MeshSample) -> tuple[int, int]:
        """The static pad shape ``(pad_nodes, pad_funcs)`` this sample's
        dispatch uses: its bucketed lengths. The batcher keys its queues
        on it, so no batch ever mixes two buckets."""
        f = max((fn.shape[0] for fn in sample.funcs), default=0)
        return bucket_length(sample.coords.shape[0]), bucket_length(f) if f else 0

    @property
    def dispatch_shapes(self) -> int:
        """Distinct dispatch shapes seen so far."""
        with self._lock:
            return len(self._shapes)

    def _note_shape(self, batch) -> None:
        key = batch.signature()
        with self._lock:
            self._shapes.add(key)

    def _forward(self, model: GNOT, batch) -> np.ndarray:
        with torch.inference_mode():
            return apply_batch(model, batch).cpu().numpy()

    # -- the serving hot path ----------------------------------------------

    def infer(
        self,
        samples: Sequence[MeshSample],
        *,
        pad_nodes: int,
        pad_funcs: int,
        rows: int | None = None,
    ) -> list[np.ndarray]:
        """ONE dispatch at the static shape ``(rows, pad_nodes,
        pad_funcs)``; returns per-sample UNPADDED outputs ``[n_i, out]``.
        Callers (the server) validate and bucket upstream."""
        reqs = list(samples)
        if not reqs:
            return []
        rows = rows or self.batch_size
        if len(reqs) > rows:
            raise ValueError(
                f"infer() got {len(reqs)} samples for a {rows}-row dispatch"
            )
        batch = collate(
            reqs + [reqs[-1]] * (rows - len(reqs)),
            bucket=False,
            pad_nodes=pad_nodes,
            pad_funcs=pad_funcs,
            device=self.device,
        )
        self._note_shape(batch)
        out = self._forward(self.model, batch)
        return unpad_rows_numpy(
            out, [(i, 0, s.coords.shape[0]) for i, s in enumerate(reqs)]
        )

    def warmup(
        self, samples: Sequence[MeshSample], *, rows: int | None = None
    ) -> int:
        """One real dispatch per bucket present in ``samples`` (outputs
        discarded), so the first live request of a bucket finds the
        kernels built and the allocator warm. Returns the buckets warmed."""
        seen: set[tuple[int, int]] = set()
        for s in samples:
            key = self.bucket_key(s)
            if key in seen:
                continue
            seen.add(key)
            self.infer([s], pad_nodes=key[0], pad_funcs=key[1], rows=rows)
        return len(seen)

    # -- the offline path --------------------------------------------------

    def predict(self, samples: Sequence[MeshSample]) -> list[np.ndarray]:
        """Per-sample unpadded model outputs ``[n_i, out_dim]`` for an
        arbitrary sample list, in batches of ``batch_size``."""
        samples = list(samples)
        self.validate(samples)
        model = self.model
        outs: list[np.ndarray] = []
        for start in range(0, len(samples), self.batch_size):
            chunk = samples[start : start + self.batch_size]
            batch = collate(chunk, device=self.device)
            self._note_shape(batch)
            out = self._forward(model, batch)
            outs.extend(
                unpad_rows_numpy(
                    out, [(j, 0, s.coords.shape[0]) for j, s in enumerate(chunk)]
                )
            )
        return outs
