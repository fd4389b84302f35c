"""Structured metrics sink: one JSON record per line.

A copy of ``gnot_tpu/utils/metrics.py``. The trainer keeps the
reference's console lines; this adds JSONL records (step, epoch,
telemetry and event records) beside them.
"""

from __future__ import annotations

import json
import math
import os
import time
from typing import Any, TextIO

import numpy as np
import torch


def _coerce(v: Any) -> Any:
    """JSON-safe recursive coercion: numpy and torch scalars to Python,
    arrays and tensors to (nested) lists, non-finite floats to null
    (``json.dumps`` would write bare NaN / Infinity, which is not JSON).
    A tensor on the card is copied to the host here, a sync: the
    telemetry buffer hands the sink host values only."""
    if isinstance(v, dict):
        return {k: _coerce(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_coerce(x) for x in v]
    if isinstance(v, torch.Tensor):
        return _coerce(v.detach().cpu().tolist())
    if isinstance(v, np.floating):
        v = float(v)
    elif isinstance(v, np.integer):
        return int(v)
    elif isinstance(v, np.bool_):
        return bool(v)
    elif isinstance(v, np.ndarray):
        # 0-d arrays tolist() to a bare scalar.
        return _coerce(v.tolist())
    if isinstance(v, float) and not math.isfinite(v):
        return None
    return v


class MetricsSink:
    """Append-only JSONL metrics writer.

    A context manager: ``with MetricsSink(path) as sink: ...`` closes the
    file on every exit path, so a run that dies mid-way keeps its
    records."""

    def __init__(self, path: str):
        self.path = path
        if d := os.path.dirname(path):
            os.makedirs(d, exist_ok=True)
        self._fh: TextIO = open(path, "a", buffering=1)

    def log(self, **record: Any) -> None:
        record.setdefault("ts", time.time())
        record = {k: _coerce(v) for k, v in record.items()}
        self._fh.write(json.dumps(record) + "\n")

    def flush(self) -> None:
        if not self._fh.closed:
            self._fh.flush()

    def close(self) -> None:
        if not self._fh.closed:
            self._fh.close()

    def __enter__(self) -> "MetricsSink":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()
