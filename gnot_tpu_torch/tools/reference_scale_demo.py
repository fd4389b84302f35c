"""Training at the reference's own data scale, through ``--train_data``.

Port of ``tools/reference_scale_demo.py``. The reference's design point is
real pickles of ~1,100 samples with ~10k-point meshes and ~800-point input
functions (its inline shape comment checks ``q [4,10044,256]`` and an
input function ``[4,805,256]``). This tool writes synthetic pickles at that
scale in the reference record schema ``[X, Y, theta, (f,)]`` and trains on
them through the port's ``main`` with the JAX tool's argv, recording each
epoch's record and a summary line of end-to-end throughput.

    python -m gnot_tpu_torch.tools.reference_scale_demo --generate   # ~220 MB under build/
    python -m gnot_tpu_torch.tools.reference_scale_demo --train --epochs 5
    python -m gnot_tpu_torch.tools.reference_scale_demo --generate --train --device cpu \\
        --n_train 2 --n_test 1 --epochs 1 --out build/ref_scale.jsonl

``generate(n_train, n_test, seed)`` gives the JAX tool's samples bitwise
(the same numpy draws, ``data/datasets.py::_smooth_target``,
``save_pickle``) and the same ``.count`` sidecar beside each pickle.
``TRAIN_PKL``, ``TEST_PKL`` and the metrics file lie under the checkout's
``build/`` (the JAX tool's sit in ``/tmp``), and ``--out`` defaults there
too: the JAX tool's default, ``docs/artifacts/reference_scale_demo.jsonl``,
is its committed TPU artifact. ``--device`` is the port's own: ``cuda``
unless ``--device cpu`` is passed, handed to ``main``; without a card,
``cuda`` raises. The module imports only the standard library, numpy,
torch and the port.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from pathlib import Path

import numpy as np

BUILD = Path(__file__).resolve().parents[2] / "build" / "reference_scale_demo"
TRAIN_PKL = str(BUILD / "ref_scale_train.pkl")
TEST_PKL = str(BUILD / "ref_scale_test.pkl")
METRICS = str(BUILD / "ref_scale_metrics.jsonl")
OUT = str(BUILD / "reference_scale_demo.jsonl")


def generate(n_train: int, n_test: int, seed: int = 0) -> None:
    """Write ``n_train`` and ``n_test`` reference-scale samples to
    ``TRAIN_PKL`` and ``TEST_PKL``, each with its ``.count`` sidecar."""
    from gnot_tpu_torch.data.batch import MeshSample
    from gnot_tpu_torch.data.datasets import _smooth_target, save_pickle

    rng = np.random.default_rng(seed)

    def make(n_samples):
        out = []
        for _ in range(n_samples):
            # The reference's shape of record: ~10,044-point meshes and
            # ~805-point input functions.
            n = int(rng.integers(9500, 10500))
            m = int(rng.integers(760, 850))
            coords = rng.uniform(0, 1, size=(n, 2)).astype(np.float32)
            theta = rng.uniform(0, 1, size=(1,)).astype(np.float32)
            fc = rng.uniform(0, 1, size=(m, 2)).astype(np.float32)
            w0 = np.sin(2 * np.pi * fc @ rng.uniform(1, 2, size=(2, 1))).astype(np.float32)
            f = np.concatenate([fc, w0], axis=1)
            y = _smooth_target(coords, theta, (f,))
            out.append(MeshSample(coords=coords, y=y, theta=theta, funcs=(f,)))
        return out

    for path, n in ((TRAIN_PKL, n_train), (TEST_PKL, n_test)):
        t0 = time.time()
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        save_pickle(make(n), path)
        # The sample count beside the pickle: train() stamps the true scale
        # into its summary without unpickling ~150 MB again.
        with open(path + ".count", "w") as f:
            f.write(str(n))
        print(f"{path}: {n} samples, {os.path.getsize(path) / 1e6:.0f} MB "
              f"({time.time() - t0:.0f}s)")


def train(args) -> None:
    """Train on ``TRAIN_PKL`` / ``TEST_PKL`` through the port's ``main``
    with the JAX tool's argv (bf16, ``--steps_per_dispatch``, a metrics
    file) on ``args.device``, then write the metrics records and a summary
    line to ``args.out``. On the card the closing line also names the
    process's peak device memory."""
    from gnot_tpu_torch.main import main as cli_main

    # The scale actually trained on: the sidecar, else the pickle's length.
    try:
        with open(TRAIN_PKL + ".count") as f:
            n_train_actual = int(f.read())
    except (OSError, ValueError):
        from gnot_tpu_torch.data.datasets import load_pickle

        n_train_actual = len(load_pickle(TRAIN_PKL))
    out = args.out
    metrics = METRICS
    os.makedirs(os.path.dirname(metrics) or ".", exist_ok=True)
    if os.path.exists(metrics):
        os.remove(metrics)
    t0 = time.time()
    best = cli_main([
        "--train_data", TRAIN_PKL, "--test_data", TEST_PKL,
        "--epochs", str(args.epochs),
        "--dtype", "bfloat16",
        "--steps_per_dispatch", str(args.steps_per_dispatch),
        "--metrics_path", metrics,
        "--device", args.device,
    ])
    wall = time.time() - t0
    with open(metrics) as f:
        records = [json.loads(line) for line in f]
    epochs = [r for r in records if "train_loss" in r and "epoch" in r]
    # Whole-run throughput of real (unpadded) points: each epoch's meter
    # times its whole host and device loop, so this is the end-to-end rate.
    total_points = sum(
        r["points_per_sec"] * r["epoch_seconds"]
        for r in epochs
        if r.get("points_per_sec") and r.get("epoch_seconds")
    )
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    with open(out, "w") as f:
        for r in records:
            f.write(json.dumps(r) + "\n")
        f.write(json.dumps({
            "kind": "summary",
            "n_train": n_train_actual,
            "epochs": args.epochs,
            "best_metric": best,
            "wall_seconds": round(wall, 1),
            "train_points_per_sec_end_to_end": (
                round(total_points / wall, 1) if total_points else None
            ),
        }) + "\n")
    peak = ""
    if args.device == "cuda":
        import torch

        peak = f" peak device memory {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB"
    print(f"best={best} wall={wall:.0f}s{peak} -> {out}")


def main(argv: list[str] | None = None) -> None:
    p = argparse.ArgumentParser(
        description="Generate reference-scale pickles and train on them through --train_data.")
    p.add_argument("--generate", action="store_true")
    p.add_argument("--train", action="store_true")
    p.add_argument("--n_train", type=int, default=1100)
    p.add_argument("--n_test", type=int, default=110)
    p.add_argument("--epochs", type=int, default=5)
    p.add_argument("--steps_per_dispatch", type=int, default=5)
    p.add_argument("--out", default=OUT)
    p.add_argument(
        "--device", type=str, default="cuda", choices=["cuda", "cpu"],
        help="where main trains: cuda (the default; raises without a card) or cpu")
    args = p.parse_args(argv)
    if args.generate:
        generate(args.n_train, args.n_test)
    if args.train:
        train(args)


if __name__ == "__main__":
    main()
