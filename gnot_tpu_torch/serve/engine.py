"""InferenceEngine: the forward path for inference, offline and serving.

Port of ``gnot_tpu/serve/engine.py::InferenceEngine`` without the AOT
table or the sanitizer. Three entry points:

* ``predict(samples)`` — the offline, all-at-once path: bucketed
  batches of ``batch_size``, per-sample unpadded outputs.
* ``infer(samples, pad_nodes=, pad_funcs=, rows=)`` — ONE dispatch at
  one fully static shape, the serving hot path. Short batches are
  padded to ``rows`` with repeats of the last sample, so a bucket always
  dispatches at one shape; ``dispatch_shapes`` counts the distinct
  shapes seen (the JAX engine's ``compiled_shapes``).
* ``infer_packed(samples, plan)`` — ONE dispatch of many small requests
  packed into the plan's fixed shape as chunk-aligned segments sharing
  rows ("pack, don't pad"); segment Grams keep attention per sample, so
  each output matches its solo padded dispatch to summation order, and
  request i gets exactly its own ``[n_i, out]`` rows.

With a program catalog attached (``attach_catalog``, ``serve/catalog.py``)
each dispatch stamps its program key into ``timings["program"]`` and a
program's first dispatch records its costs (``obs/costs.py::program_costs``).

The weights are swapped atomically under a lock (``swap_params``); a
dispatch reads the published model once, so in-flight requests always
see one consistent weight set.

``stream`` (a ``torch.cuda.Stream``, a router replica's own) runs every
call of the engine on that stream, entered on the calling thread: the
worker's dispatches, a warm-up on the caller's thread and a reload's
weight copy. Its output's copy to the host waits for that stream alone,
so replicas sharing a card never wait for each other. None (the default,
and on the CPU) runs on the thread's current stream.

``dtype`` is the serving compute dtype (``models/precision.py``).
"bfloat16" serves the caller's f32 weights through the precision
policy: the engine publishes a bf16 copy (``serve_model``, which holds
``cast_params`` of the weights) and casts again on every
``swap_params``, so the caller's model stays f32 at rest; batches
collate in bf16; responses are f32 (the policy's head). Dispatch
signatures carry each field's dtype, so bf16 and f32 dispatches at the
same shapes are distinct. The FFN kernel packs the published copy's
weights once, at the first dispatch after a publish.
"""

from __future__ import annotations

import contextlib
import copy
import threading
from typing import Mapping, Sequence

import numpy as np
import torch

from gnot_tpu_torch.data.batch import (
    MeshSample,
    PackPlan,
    bucket_length,
    collate,
    pack_collate,
    pack_prefix,
    validate_samples,
)
from gnot_tpu_torch.native import unpad_rows
from gnot_tpu_torch.models import precision
from gnot_tpu_torch.models.gnot import GNOT, apply_batch
from gnot_tpu_torch.obs.costs import program_costs, unavailable_costs
from gnot_tpu_torch.serve.catalog import bucket_program_key, packed_program_key


class InferenceEngine:
    """Validated, bucketed, statically-shaped batched forward of one
    ``GNOT`` on one device."""

    def __init__(self, model: GNOT, *, batch_size: int, dtype: str = "float32",
                 stream: torch.cuda.Stream | None = None):
        self.policy = precision.policy_for(dtype)
        self.dtype = dtype
        self.batch_size = batch_size
        self.device = next(model.parameters()).device
        self.stream = stream
        self._lock = threading.Lock()
        # The published model (a cast copy below f32); swap_params
        # replaces the reference.
        self._model = precision.serve_model(model, dtype).eval()  #: guarded_by _lock
        # Distinct dispatch signatures seen so far.
        self._shapes: set[tuple] = set()  #: guarded_by _lock
        # The shared program catalog (serve/catalog.py), or None.
        self._catalog = None

    def _on_stream(self):
        """The engine's stream as the calling thread's current one."""
        return torch.cuda.stream(self.stream) if self.stream is not None else contextlib.nullcontext()

    # -- params ------------------------------------------------------------

    def swap_params(self, state_dict: Mapping[str, torch.Tensor]) -> None:
        """Publish a new weight set (hot reload). A copy of the model
        takes the new weights, cast to the serving dtype; in-flight
        dispatches keep the model they already read, the next dispatch
        sees the new one. On a replica's stream the copy is ordered after
        the caller's pending work and before the next dispatch."""
        with self._lock:
            current = self._model
        if self.stream is not None:
            self.stream.wait_stream(torch.cuda.current_stream(self.device))
        with self._on_stream():
            fresh = copy.deepcopy(current)
            fresh.load_state_dict(precision.cast_params(state_dict, self.dtype), strict=True)
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

    def _timed(self, timings: dict | None, clock, batch, cut) -> list[np.ndarray]:
        """Forward ``batch`` and ``cut`` its output per request; with a
        ``timings`` dict, stamp the ``device`` (forward and copy to the
        host) and ``unpad`` phases on ``clock`` (the JAX engine's phase
        stamps, which the server's request spans read)."""
        if timings is None:
            return cut(self._forward(self.model, batch))
        t1 = clock()
        out = self._forward(self.model, batch)
        t2 = clock()
        outs = cut(out)
        timings["device"] = (t1, t2)
        timings["unpad"] = (t2, clock())
        return outs

    # -- program catalog (serve/catalog.py) --------------------------------

    def attach_catalog(self, catalog) -> None:
        """Wire (or detach, with None) the shared program catalog:
        dispatches then record first-seen program costs and stamp their
        program key into ``timings`` for the server's attribution."""
        self._catalog = catalog

    @property
    def catalog(self):
        return self._catalog

    def _capture_costs(self, program: str, **shape) -> None:
        """Record one program's costs into the attached catalog, once per
        program key, counted at its dispatch ``shape`` (``program_costs``'
        arguments). ``source`` is JAX's "compile": here it means the
        program's first dispatch. A failed count records the
        ``unavailable`` marker and never raises into a dispatch."""
        cat = self._catalog
        if cat is None or cat.has(program):
            return
        try:
            model = self.model
            costs = program_costs(model.config, dtype=self.dtype, params=model.parameters(),
                                  **shape)
        except Exception as e:  # a cost count must never fail serving
            costs = unavailable_costs(f"capture failed: {type(e).__name__}")
        cat.record(program, costs, source="compile")

    # -- the serving hot path ----------------------------------------------

    def infer(
        self,
        samples: Sequence[MeshSample],
        *,
        pad_nodes: int,
        pad_funcs: int,
        rows: int | None = None,
        timings: dict | None = None,
        clock=None,
    ) -> list[np.ndarray]:
        """ONE dispatch at the static shape ``(rows, pad_nodes,
        pad_funcs)``; returns per-sample UNPADDED outputs ``[n_i, out]``.
        Callers (the server) validate and bucket upstream. A ``timings``
        dict gets the ``batch_assembly``, ``device`` and ``unpad`` phases
        as ``(start, end)`` on ``clock``."""
        with self._on_stream():
            return self._infer(list(samples), pad_nodes, pad_funcs, rows, timings, clock)

    def _infer(self, reqs, pad_nodes, pad_funcs, rows, timings, clock) -> list[np.ndarray]:
        if not reqs:
            return []
        t0 = clock() if timings is not None else None
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
            dtype=self.dtype,
        )
        self._note_shape(batch)
        program = bucket_program_key(pad_nodes, pad_funcs, rows, self.dtype)
        if timings is not None:
            timings["batch_assembly"] = (t0, clock())
            timings["program"] = program
        outs = self._timed(timings, clock, batch, lambda out: unpad_rows(
            out, [(i, 0, s.coords.shape[0]) for i, s in enumerate(reqs)]))
        self._capture_costs(program, rows=rows, pad_nodes=pad_nodes, pad_funcs=pad_funcs)
        return outs

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

    def infer_packed(
        self,
        samples: Sequence[MeshSample],
        plan: PackPlan,
        *,
        placements: Sequence[tuple[int, int]] | None = None,
        timings: dict | None = None,
        clock=None,
    ) -> list[np.ndarray]:
        """ONE dispatch of ``samples`` packed into ``plan``'s fixed shape
        (first-fit prefix placements unless given), in the serving dtype;
        returns per-request outputs ``[n_i, out]``, each cut from its own
        segment. Every sample must fit: the server's batcher cuts
        dispatches to the packable prefix. ``timings`` / ``clock`` as in
        ``infer``."""
        with self._on_stream():
            return self._infer_packed(list(samples), plan, placements, timings, clock)

    def _infer_packed(self, reqs, plan, placements, timings, clock) -> list[np.ndarray]:
        if not reqs:
            return []
        t0 = clock() if timings is not None else None
        if placements is None:
            placements = pack_prefix([s.coords.shape[0] for s in reqs], plan)
        if len(placements) != len(reqs):
            raise ValueError(
                f"infer_packed() got {len(reqs)} samples but only "
                f"{len(placements)} fit the plan {plan}; the batcher's "
                "take_fn must cut dispatches to the packable prefix"
            )
        batch = pack_collate(
            reqs, placements, n_rows=plan.n_rows, row_len=plan.row_len,
            chunk=plan.chunk, n_slots=plan.n_slots, pad_funcs=plan.pad_funcs,
            device=self.device, dtype=self.dtype,
        )
        self._note_shape(batch)
        program = packed_program_key(plan, self.dtype)
        if timings is not None:
            timings["batch_assembly"] = (t0, clock())
            timings["program"] = program
        outs = self._timed(timings, clock, batch, lambda out: unpad_rows(
            out, [(r, off, s.coords.shape[0]) for s, (r, off) in zip(reqs, placements)]))
        self._capture_costs(program, plan=plan)
        return outs

    def warmup_packed(self, samples: Sequence[MeshSample], plan: PackPlan) -> int:
        """One packed dispatch of the first sample that fits ``plan``
        (outputs discarded), as ``warmup`` does per bucket. Returns 1 when
        one fit, else 0."""
        fits = [s for s in samples if plan.packable(s)]
        if not fits:
            return 0
        self.infer_packed(fits[:1], plan)
        return 1

    # -- the offline path --------------------------------------------------

    def predict(self, samples: Sequence[MeshSample]) -> list[np.ndarray]:
        """Per-sample unpadded model outputs ``[n_i, out_dim]`` for an
        arbitrary sample list, in batches of ``batch_size``."""
        samples = list(samples)
        self.validate(samples)
        model = self.model
        outs: list[np.ndarray] = []
        with self._on_stream():
            for start in range(0, len(samples), self.batch_size):
                chunk = samples[start : start + self.batch_size]
                batch = collate(chunk, device=self.device, dtype=self.dtype)
                self._note_shape(batch)
                out = self._forward(model, batch)
                outs.extend(
                    unpad_rows(
                        out, [(j, 0, s.coords.shape[0]) for j, s in enumerate(chunk)]
                    )
                )
        return outs
