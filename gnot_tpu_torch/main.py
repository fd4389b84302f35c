"""CLI entry point of the port: ``python -m gnot_tpu_torch.main --serve [flags]``.

A subset of ``gnot_tpu/main.py``'s parser with the same flag names, so
the same command line works in both packages. Serving is the one mode
ported so far: weights are initialised from ``--seed``, one dispatch per
bucket warms the engine, the test set is submitted as requests through
the ``InferenceServer``, the server drains, and the summary is printed
as one JSON line. Runs on ``cuda`` unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import torch

from gnot_tpu_torch.config import DataConfig, ModelConfig, ServeConfig
from gnot_tpu_torch.data import datasets
from gnot_tpu_torch.data.batch import MeshSample
from gnot_tpu_torch.device import resolve_device
from gnot_tpu_torch.models.gnot import GNOT
from gnot_tpu_torch.serve.engine import InferenceEngine
from gnot_tpu_torch.serve.server import InferenceServer, ServeResult

# How long the storm waits for each request, and drain() for stragglers.
DRAIN_TIMEOUT_S = 30.0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="GNOT in PyTorch/CUDA (serving)")
    # Reference flags (main.py:15-23), same names and defaults.
    p.add_argument("--n_attn_layers", type=int, default=4)
    p.add_argument("--n_attn_hidden_dim", type=int, default=256)
    p.add_argument("--n_mlp_num_layers", type=int, default=4)
    p.add_argument("--n_mlp_hidden_dim", type=int, default=256)
    p.add_argument("--n_input_hidden_dim", type=int, default=256)
    p.add_argument("--n_expert", type=int, default=3)
    p.add_argument("--n_head", type=int, default=8)
    p.add_argument(
        "--synthetic", type=str, default="ns2d", choices=sorted(datasets.SYNTHETIC),
        help="synthetic benchmark config when no pickle paths are given",
    )
    p.add_argument(
        "--synth_size", type=int, default=0,
        help="synthetic generator size (0 = its default): grid side for "
             "darcy2d (points = size^2), mesh points for the others",
    )
    p.add_argument("--n_test", type=int, default=16)
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument(
        "--ffn_impl", type=str, default="xla", choices=["xla", "pallas"],
        help="xla: batched-matmul expert FFN in torch; pallas: the fused "
             "gated-FFN kernel (hand-written CUDA on the card)",
    )
    p.add_argument(
        "--device", type=str, default="cuda", choices=["cuda", "cpu"],
        help="cuda (default; raises without a card) or cpu",
    )
    p.add_argument(
        "--serve", action="store_true",
        help="serving mode: fresh weights from --seed, drive the test set "
             "through the InferenceServer as requests, drain, report",
    )
    p.add_argument("--serve_max_batch", type=int, default=4,
                   help="serving: requests per dispatch (dispatches are padded to it)")
    p.add_argument("--serve_max_wait_ms", type=float, default=10.0,
                   help="serving: max ms a request waits for batchmates")
    p.add_argument("--serve_queue_limit", type=int, default=64,
                   help="serving: bounded-queue admission limit")
    return p


def configs_from_args(args) -> tuple[DataConfig, ServeConfig]:
    data = DataConfig(
        synthetic=args.synthetic,
        synth_size=args.synth_size,
        n_test=args.n_test,
        batch_size=args.batch_size,
        seed=args.seed,
    )
    serve = ServeConfig(
        max_batch=args.serve_max_batch,
        max_wait_ms=args.serve_max_wait_ms,
        queue_limit=args.serve_queue_limit,
    )
    return data, serve


def served_samples(data: DataConfig) -> list[MeshSample]:
    """The served requests: the synthetic test split (seed + 1, the same
    samples ``gnot_tpu``'s ``load`` gives)."""
    return datasets.synth(data.synthetic, data.n_test, data.seed + 1, data.synth_size)


def model_config(args, samples: list[MeshSample]) -> ModelConfig:
    return ModelConfig(
        **datasets.infer_model_dims(samples),
        n_attn_layers=args.n_attn_layers,
        n_attn_hidden_dim=args.n_attn_hidden_dim,
        n_mlp_num_layers=args.n_mlp_num_layers,
        n_mlp_hidden_dim=args.n_mlp_hidden_dim,
        n_input_hidden_dim=args.n_input_hidden_dim,
        n_expert=args.n_expert,
        n_head=args.n_head,
        ffn_impl=args.ffn_impl,
    )


@dataclasses.dataclass
class ServeRun:
    """Everything one ``--serve`` run produced."""

    summary: dict
    results: list[ServeResult]
    samples: list[MeshSample]
    model: GNOT


def run_serve(args) -> ServeRun:
    """``--serve``: build the model from ``--seed`` on the chosen device,
    start the server with one warm-up dispatch per bucket, submit the
    test set as requests, wait for every future, drain, and report."""
    device = resolve_device(args.device)
    data, sc = configs_from_args(args)
    samples = served_samples(data)
    gen = torch.Generator().manual_seed(args.seed)
    model = GNOT(model_config(args, samples), generator=gen).to(device)
    engine = InferenceEngine(model, batch_size=data.batch_size)
    server = InferenceServer(
        engine,
        max_batch=sc.max_batch,
        max_wait_ms=sc.max_wait_ms,
        queue_limit=sc.queue_limit,
    )
    t0 = time.monotonic()
    server.start(warmup=samples)
    warm_s = time.monotonic() - t0
    try:
        futures = [server.submit(s) for s in samples]
        results = [f.result(timeout=DRAIN_TIMEOUT_S) for f in futures]
    finally:
        summary = server.drain(DRAIN_TIMEOUT_S)
    summary.update(warmed_buckets=server.warmed, warmup_s=warm_s, device=str(device))
    return ServeRun(summary, results, samples, model)


def main(argv: list[str] | None = None) -> float:
    parser = build_parser()
    args = parser.parse_args(argv)
    if not args.serve:
        parser.error("only --serve is ported so far; training comes in a later slice")
    run = run_serve(args)
    print(json.dumps({"serve_summary": run.summary}))
    return run.summary["completed"] / max(1, run.summary["requests"])


if __name__ == "__main__":
    main()
