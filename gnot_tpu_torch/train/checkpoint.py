"""Checkpoints of a training run: ``best`` and ``latest``.

The part of ``gnot_tpu/train/checkpoint.py::Checkpointer`` the trainer
calls, in the port's own format: one ``torch.save`` file per name,
``<dir>/best.pt`` (written when the eval metric improves) and
``<dir>/latest.pt`` (every ``checkpoint_every`` epochs, for ``--resume``).
Each holds ``{"state", "epoch", "best_metric"}``, where ``state`` is
``Trainer.state_dict()`` in the trainer's own parameter layout (flat,
stacked or standard): weights, AdamW state, the micro-step count and any
gradient-accumulation state. ``extra_meta`` (``main.py`` records
``flat_params``) is saved beside them as ``"meta"``; a restore whose
checkpoint recorded another ``flat_params`` prints the JAX package's
layout warning (``gnot_tpu/train/checkpoint.py::_warn_numerics``), after
which loading the state into the trainer fails.

A save writes a temporary file beside the target and renames it over the
target (``os.replace``), so a crash leaves the previous checkpoint
whole. Files are read with ``torch.load(weights_only=True)`` onto the
CPU; ``load_state_dict`` moves each tensor to its parameter's device and
keeps AdamW's step counts on the CPU, where torch's non-fused AdamW
reads them without a device sync.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Any

import torch


class Checkpointer:
    def __init__(self, directory: str, extra_meta: dict | None = None):
        self.directory = Path(directory)
        self.directory.mkdir(parents=True, exist_ok=True)
        self.extra_meta = dict(extra_meta or {})

    def path(self, name: str) -> Path:
        return self.directory / f"{name}.pt"

    def _save(self, name: str, state: dict, epoch: int, best_metric: float) -> None:
        payload = {
            "state": state,
            "epoch": int(epoch),
            "best_metric": float(best_metric),
        }
        if self.extra_meta:
            payload["meta"] = self.extra_meta
        target = self.path(name)
        tmp = target.with_name(f".{target.name}.tmp{os.getpid()}")
        try:
            torch.save(payload, tmp)
            os.replace(tmp, target)
        finally:
            tmp.unlink(missing_ok=True)

    def save_best(self, state: dict, epoch: int, best_metric: float) -> None:
        self._save("best", state, epoch, best_metric)

    def save_latest(self, state: dict, epoch: int, best_metric: float) -> None:
        """``epoch`` is the first epoch a resumed run trains."""
        self._save("latest", state, epoch, best_metric)

    def _restore(self, name: str) -> tuple[dict, int, float] | None:
        path = self.path(name)
        if not path.is_file():
            return None
        payload: dict[str, Any] = torch.load(path, map_location="cpu", weights_only=True)
        self._warn_layout(name, payload.get("meta", {}))
        return payload["state"], payload["epoch"], payload["best_metric"]

    def _warn_layout(self, name: str, meta: dict) -> bool:
        """The JAX checkpointer's state-layout warning: printed when the
        checkpoint's recorded ``flat_params`` differs from this run's (a
        checkpoint that recorded none is a tree-layout one). Returns
        whether it was printed."""
        if "flat_params" not in self.extra_meta:
            return False
        cur = bool(self.extra_meta["flat_params"])
        ck = bool(meta.get("flat_params", False))
        if ck == cur:
            return False
        print(
            f"warning: '{name}' checkpoint was saved in the "
            f"{'flat [P]-vector' if ck else 'standard tree'} state "
            f"layout but this run uses the "
            f"{'flat' if cur else 'tree'} layout — restore will "
            "fail with a tree-structure mismatch; "
            f"{'pass' if ck else 'drop'} --flat_params to match"
        )
        return True

    def restore_latest(self) -> tuple[dict, int, float] | None:
        """``(state, epoch, best_metric)`` of ``latest``, or None when there
        is none."""
        return self._restore("latest")

    def restore_best(self) -> tuple[dict, int, float] | None:
        """``(state, epoch, best_metric)`` of ``best``, or None when there
        is none."""
        return self._restore("best")
