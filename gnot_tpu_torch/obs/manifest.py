"""Run manifest: one ``run.json`` of provenance per run.

Port of ``gnot_tpu/obs/manifest.py``, with the same top-level keys
(``ts``, ``argv``, ``config``, ``model_config``, ``git``, ``versions``,
``devices``, ``mesh``, ``compile_cache``, plus ``extra``), the same
atomic tmp + rename write and the same ``manifest_path_for`` rule. The
values are torch's: ``versions`` names torch, its CUDA and numpy;
``devices`` the card; ``mesh`` is null (the port has no device mesh);
``compile_cache`` describes the kernel build directory of
``ops/build.py``, the nearest thing to an XLA compile cache the port has.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import time
from typing import Any

import numpy as np
import torch

from gnot_tpu_torch.ops import build


def _git_rev() -> dict:
    """Git revision and dirtiness of the checkout; nulls outside a
    repository, never raises."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    out = {"rev": None, "dirty": None}
    try:
        rev = subprocess.run(
            ["git", "rev-parse", "HEAD"], cwd=root, capture_output=True,
            text=True, timeout=10,
        )
        if rev.returncode == 0:
            out["rev"] = rev.stdout.strip()
            status = subprocess.run(
                ["git", "status", "--porcelain"], cwd=root,
                capture_output=True, text=True, timeout=10,
            )
            if status.returncode == 0:
                out["dirty"] = bool(status.stdout.strip())
    except (OSError, subprocess.SubprocessError):
        pass
    return out


def _versions() -> dict:
    return {"torch": torch.__version__, "cuda": torch.version.cuda, "numpy": np.__version__}


def _devices(device: torch.device | str | None) -> dict:
    """The run's device: platform "gpu" or "cpu", the card's name, how
    many cards torch sees, and the ranks of the run and this one's
    (``process_count`` / ``process_index``, JAX's keys: 1 and 0 outside a
    ``torch.distributed`` launch)."""
    from gnot_tpu_torch.parallel import multihost

    procs = {"process_count": multihost.process_count(),
             "process_index": multihost.process_index()}
    dev = torch.device(device if device is not None else "cpu")
    if dev.type == "cuda":
        index = dev.index if dev.index is not None else torch.cuda.current_device()
        return {
            "platform": "gpu",
            "device_kind": torch.cuda.get_device_name(index),
            "device_index": index,
            "n_devices": torch.cuda.device_count(),
            **procs,
        }
    return {"platform": "cpu", "device_kind": "cpu", "device_index": None, "n_devices": 1,
            **procs}


def _compile_cache_stats() -> dict:
    """Directory, file count and bytes of the kernel build directory."""
    path = str(build.BUILD_DIR)
    stats = {"dir": path, "entries": None, "bytes": None}
    if os.path.isdir(path):
        entries = n_bytes = 0
        try:
            for de in os.scandir(path):
                if de.is_file():
                    entries += 1
                    n_bytes += de.stat().st_size
            stats["entries"], stats["bytes"] = entries, n_bytes
        except OSError:
            pass
    return stats


def _snapshot(obj: Any) -> Any:
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.asdict(obj)
    return obj


def build_manifest(
    *,
    config: Any = None,
    model_config: Any = None,
    device: torch.device | str | None = None,
    mesh=None,
    argv=None,
    extra: dict | None = None,
) -> dict:
    manifest = {
        "ts": time.time(),
        "argv": list(argv) if argv is not None else None,
        "config": _snapshot(config),
        "model_config": _snapshot(model_config),
        "git": _git_rev(),
        "versions": _versions(),
        "devices": _devices(device),
        "mesh": dict(mesh.shape) if mesh is not None else None,
        "compile_cache": _compile_cache_stats(),
    }
    if extra:
        manifest.update(extra)
    return manifest


def write_manifest(path: str, **kwargs) -> dict:
    """Build and atomically write the manifest (tmp + rename, so a reader
    never sees a torn file). Returns the dict."""
    manifest = build_manifest(**kwargs)
    if d := os.path.dirname(path):
        os.makedirs(d, exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(manifest, f, indent=2, default=str)
        f.write("\n")
    os.replace(tmp, path)
    return manifest


def manifest_path_for(metrics_path: str) -> str:
    """``run.json`` next to the metrics JSONL, unless another run's
    ``run.json`` is already there (two runs sharing a directory): then
    ``<metrics-stem>.run.json``, so the first run's provenance stays."""
    metrics_path = os.path.abspath(metrics_path)
    default = os.path.join(os.path.dirname(metrics_path), "run.json")
    try:
        with open(default) as f:
            existing = json.load(f)
    except (OSError, json.JSONDecodeError):
        return default  # absent or torn: ours to (re)write
    if os.path.abspath(existing.get("metrics_path") or "") == metrics_path:
        return default  # a re-run of the same metrics file
    stem = os.path.splitext(os.path.basename(metrics_path))[0]
    return os.path.join(os.path.dirname(metrics_path), f"{stem}.run.json")
