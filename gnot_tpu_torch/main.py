"""CLI entry point of the port: ``python -m gnot_tpu_torch.main [--serve] [flags]``.

A subset of ``gnot_tpu/main.py``'s parser with the same flag names and
defaults, so the same command line works in both packages. Two modes:

* training (no ``--serve``, the default, as in ``gnot_tpu``): the
  single-device ``Trainer`` on the synthetic or pickled train split,
  weights from ``--seed``, eval on the test split every epoch, the
  reference's console lines, in f32 or (``--dtype bfloat16``) bf16
  compute, masked or (``--attention_mode parity``, bucketing off)
  reference-parity numerics, padded or (``--packed``) packed batches,
  with ``--grad_accum`` micro-batches per update, ``--steps_per_dispatch``
  steps per host-to-device copy, and the weights in the standard, the
  flat (``--flat_params``) or the stacked (``--scan_layers``) layout;
  ``main`` returns the best test metric. ``--eval_only``
  evaluates ``--checkpoint_dir``'s best checkpoint instead of training.
  Then ``--export_torch`` saves the weights as a state_dict the
  reference's torch GNOT loads, and ``--predict_out`` writes the test
  split's predictions as a reference-schema pickle; both use the best
  checkpoint when ``--checkpoint_dir`` is set, else the final weights.
* ``--serve``: the weights of ``--checkpoint_dir``'s ``best``, else its
  ``latest``, checkpoint (in the layout ``--flat_params`` /
  ``--scan_layers`` name, served in the standard one), else fresh from
  ``--seed``; one dispatch per
  bucket warms the engine, the test split (synthetic or pickled) is
  submitted as requests through the ``InferenceServer`` at
  ``--serve_dtype``, the server drains, and the summary is printed as
  one JSON line. With ``--serve_packed`` the requests that fit a
  ``PackPlan`` derived from that traffic are served packed, the plan
  warmed with one packed dispatch.

Observability (``gnot_tpu/main.py``'s flags, defaults and refusals):
``--metrics_path`` opens a JSONL ``MetricsSink`` (per-epoch records and
events; serving's ``shed``, ``queue_depth`` and ``serve_summary``) with a
``run.json`` manifest beside it, written before the run and again at its
end; ``--log_every N`` adds a step record every N steps (it needs
``--metrics_path``); ``--telemetry`` makes those records the device-side
telemetry (norms, gate load and entropy, padding waste) and turns on the
slow-step gauge and the NaN watchdog; ``--trace_path`` writes the span
tracer's Chrome trace at exit (``--trace_sample_rate`` heads-samples
it); ``--profile_dir`` writes a ``torch.profiler`` trace of one epoch.
The sink, the trace flush and the manifest sit on one ``ExitStack``, so a
run that dies (the NaN watchdog raises) still writes its records and
its trace.

Resilience (``gnot_tpu/main.py``'s flags, defaults and refusals):
``--inject_fault`` arms deterministic faults (``--stop_after_epoch N`` is
``stop_epoch@N``); ``--recovery`` turns on the rollback ladder
(``--snapshot_every``, ``--max_rollbacks``); SIGTERM / SIGINT stop a run
at the next step boundary and save ``latest`` unless ``--no_preempt``;
``--debug_checks`` reads every step's loss. Checkpoints record the
resolved numerics and the layout (``checkpoint_meta``), and ``run.json``'s
``restore`` field is the checkpointer's ``last_restore``: which file a
resume, an eval or a serve restored, fallbacks included.

Runs on ``cuda`` unless ``--device cpu`` is given; ``--device_id i``
pins ``cuda:i``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import sys
import time

import torch

from gnot_tpu_torch import interop
from gnot_tpu_torch.config import (
    Config,
    DataConfig,
    ModelConfig,
    OptimConfig,
    ServeConfig,
    TrainConfig,
)
from gnot_tpu_torch.data import datasets
from gnot_tpu_torch.data.batch import MeshSample, PackPlan
from gnot_tpu_torch.device import resolve_device
from gnot_tpu_torch.models.gnot import GNOT
from gnot_tpu_torch.models.precision import SERVE_DTYPES
from gnot_tpu_torch.obs import manifest as manifest_lib
from gnot_tpu_torch.obs.tracing import Tracer
from gnot_tpu_torch.serve.engine import InferenceEngine
from gnot_tpu_torch.serve.server import InferenceServer, ServeResult
from gnot_tpu_torch.train.checkpoint import Checkpointer
from gnot_tpu_torch.train.trainer import Trainer, standard_weights, state_layout
from gnot_tpu_torch.utils.metrics import MetricsSink

# How long the storm waits for each request, and drain() for stragglers.
DRAIN_TIMEOUT_S = 30.0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="GNOT in PyTorch/CUDA (training, serving)")
    # Reference flags (main.py:15-23), same names and defaults.
    p.add_argument("--n_attn_layers", type=int, default=4)
    p.add_argument("--n_attn_hidden_dim", type=int, default=256)
    p.add_argument("--n_mlp_num_layers", type=int, default=4)
    p.add_argument("--n_mlp_hidden_dim", type=int, default=256)
    p.add_argument("--n_input_hidden_dim", type=int, default=256)
    p.add_argument("--n_expert", type=int, default=3)
    p.add_argument("--n_head", type=int, default=8)
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--train_data", type=str, default="", help="train pickle path")
    p.add_argument("--test_data", type=str, default="", help="test pickle path")
    p.add_argument(
        "--synthetic", type=str, default="ns2d", choices=sorted(datasets.SYNTHETIC),
        help="synthetic benchmark config when no pickle paths are given",
    )
    p.add_argument(
        "--synth_size", type=int, default=0,
        help="synthetic generator size (0 = its default): grid side for "
             "darcy2d (points = size^2), mesh points for the others",
    )
    p.add_argument("--n_train", type=int, default=64)
    p.add_argument("--n_test", type=int, default=16)
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument(
        "--grad_accum", type=int, default=1,
        help="accumulate gradients over k micro-batches per optimizer update "
             "(effective batch = k x batch_size): the running mean of k "
             "gradients makes one AdamW update, at the memory of one batch",
    )
    p.add_argument("--seed", type=int, default=0)
    p.add_argument(
        "--gelu", type=str, default="", choices=["", "erf", "tanh"],
        help="GELU flavor: erf (torch nn.GELU, the reference op) or tanh "
             "(the standard approximation). Default: tanh (masked mode)",
    )
    p.add_argument(
        "--attention_impl", type=str, default="xla", choices=["xla", "pallas"],
        help="xla is the only supported impl; the pallas kernel lost the "
             "honest A/B at every scale and its model dispatch was retired "
             "(both packages): passing pallas raises",
    )
    p.add_argument(
        "--attention_mode", type=str, default="masked", choices=["masked", "parity"],
        help="masked: padding masked out of attention (pad-length invariant); "
             "parity: the reference's numerics (unmasked padding, interleaved "
             "head merge, erf GELU; turns bucketing off)",
    )
    p.add_argument(
        "--ffn_impl", type=str, default="xla", choices=["xla", "pallas"],
        help="xla: batched-matmul expert FFN in torch; pallas: the fused "
             "gated-FFN kernel (hand-written CUDA on the card)",
    )
    p.add_argument(
        "--dtype", type=str, default="float32", choices=list(SERVE_DTYPES),
        help="compute dtype of the block stack: bfloat16 computes the blocks "
             "in bf16 on the f32 weights (f32 gradients, AdamW state and "
             "checkpoints; f32 attention accumulation and output head)",
    )
    p.add_argument(
        "--remat", action="store_true",
        help="recompute each block's activations in the backward (less "
             "activation memory, one more forward of each block)",
    )
    p.add_argument(
        "--flat_params", action="store_true",
        help="flat parameter layout: every weight and gradient a view into one "
             "f32 buffer (each leaf 16-byte aligned), so AdamW updates one tensor "
             "instead of one per weight; same math; checkpoints keep the layout",
    )
    p.add_argument(
        "--scan_layers", action="store_true",
        help="the stacked-layer layout: the block weights stacked on a leading "
             "layer axis, one block module applied per layer. Compiles nothing "
             "in PyTorch (the same kernels run in the same order); it is the "
             "JAX package's stacked layout and checkpoint format. Needs "
             "--ffn_impl xla",
    )
    p.add_argument(
        "--predict_out", type=str, default="",
        help="after the run, write test-set predictions to this pickle as "
             "[X, Y_pred, theta, (f...)] records (reference schema); uses the "
             "best checkpoint when --checkpoint_dir is set, else the "
             "final-epoch weights",
    )
    p.add_argument(
        "--export_torch", type=str, default="",
        help="after the run, save the weights as a reference-compatible torch "
             "state_dict .pth (best checkpoint when --checkpoint_dir is set, "
             "else the final weights)",
    )
    p.add_argument(
        "--device", type=str, default="cuda", choices=["cuda", "cpu"],
        help="cuda (default; raises without a card) or cpu",
    )
    p.add_argument(
        "--device_id", type=int, default=-1,
        help="pin the run to cuda:i (the reference's --gpu_id, main.py:15); "
             "-1 = the current CUDA device",
    )
    p.add_argument("--metrics_path", type=str, default="")
    p.add_argument(
        "--log_every", type=int, default=0,
        help="per-step JSONL metric cadence (0 = per-epoch only; needs --metrics_path)",
    )
    p.add_argument(
        "--telemetry", action="store_true",
        help="device-side telemetry + health monitors (obs/): grad/param/"
             "update norms, per-layer gate load/entropy, padding waste "
             "computed in each step, fetched every --log_every steps "
             "without per-step host syncs; plus slow-step outliers and the "
             "NaN watchdog",
    )
    p.add_argument("--profile_dir", type=str, default="",
                   help="write a torch.profiler Chrome trace of one epoch here")
    p.add_argument(
        "--trace_path", type=str, default="",
        help="host-side structured span tracing (obs/tracing.py): write a "
             "Chrome trace-event JSON here at exit: request-lifecycle spans "
             "(admission..resolve) when serving, per-step phase spans "
             "(data_iter/host_to_device/step_dispatch/...) when training; "
             "open in chrome://tracing or https://ui.perfetto.dev",
    )
    p.add_argument(
        "--trace_sample_rate", type=float, default=1.0,
        help="head-based trace sampling rate in [0,1] (decided once per "
             "request/epoch, deterministically)",
    )
    p.add_argument(
        "--debug_checks", action="store_true",
        help="deterministic per-step guard: every step's loss is read on the "
             "host and the first NaN/inf raises at its step (one sync a step; "
             "with --recovery the ladder takes it). JAX's jax_debug_nans and "
             "its donation alias guard have no counterpart in eager PyTorch, "
             "which donates no buffers",
    )
    p.add_argument("--loss", type=str, default="rel_l2", choices=["rel_l2", "mse"])
    p.add_argument("--schedule", type=str, default="parity", choices=["parity", "per_step"],
                   help="parity: per-epoch OneCycle stepping (the reference bug); per_step: correct")
    p.add_argument("--checkpoint_dir", type=str, default="")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--checkpoint_every", type=int, default=0)
    p.add_argument(
        "--stop_after_epoch", type=int, default=0,
        help="fault injection: stop cleanly after N epochs as if "
             "preempted (schedule stays sized by --epochs; resume with "
             "--resume to continue the same regime); alias for "
             "--inject_fault stop_epoch@N",
    )
    p.add_argument(
        "--inject_fault", type=str, default="",
        help="deterministic fault injection: comma-separated kind@N "
             "entries — nan_grad@step, bad_sample@step, sigterm@step, "
             "ckpt_io@count, corrupt_ckpt@epoch, stop_epoch@epochs",
    )
    p.add_argument(
        "--recovery", action="store_true",
        help="automatic NaN recovery: rolling last-good snapshot of the "
             "train state on the device every --snapshot_every steps; a "
             "non-finite loss rolls back, quarantines the offending batch, "
             "and continues — escalating to checkpoint restore after "
             "--max_rollbacks, then to the hard abort (off by default: "
             "recovery changes the training trajectory)",
    )
    p.add_argument("--snapshot_every", type=int, default=50)
    p.add_argument("--max_rollbacks", type=int, default=3)
    p.add_argument(
        "--no_preempt", action="store_true",
        help="disable graceful SIGTERM/SIGINT handling (stop at the next "
             "step boundary + 'latest' save + resume-ready exit; on by "
             "default)",
    )
    p.add_argument(
        "--preempt_sync_every", type=int, default=1,
        help="multi-host graceful preemption: agree on the stop flag every "
             "N dispatches (validated; a single-process run reads its own "
             "flag at every step boundary)",
    )
    p.add_argument(
        "--eval_only", action="store_true",
        help="restore the best checkpoint and evaluate (no training)",
    )
    p.add_argument(
        "--steps_per_dispatch", type=int, default=1,
        help="K train (and eval) steps per dispatch: K same-shape batches "
             "stacked in pinned memory, one host-to-device copy, no host read "
             "between the steps (every kernel still launches per step); "
             "identical to K single steps",
    )
    p.add_argument("--no_bucket", action="store_true", help="pad to per-batch max (parity)")
    p.add_argument(
        "--packed", action="store_true",
        help="pack several samples per sequence row (chunk-aligned segments, "
             "exact per-sample attention and losses) instead of padding each "
             "to its bucket length; masked mode",
    )
    p.add_argument(
        "--pack_chunk", type=int, default=128,
        help="segment alignment granularity for --packed (tokens)",
    )
    p.add_argument(
        "--serve", action="store_true",
        help="serving mode: restore --checkpoint_dir's best (else latest) "
             "weights, else fresh ones from --seed, drive the test set "
             "through the InferenceServer as requests, drain, report",
    )
    p.add_argument("--serve_max_batch", type=int, default=4,
                   help="serving: requests per dispatch (dispatches are padded to it)")
    p.add_argument("--serve_max_wait_ms", type=float, default=10.0,
                   help="serving: max ms a request waits for batchmates")
    p.add_argument("--serve_queue_limit", type=int, default=64,
                   help="serving: bounded-queue admission limit")
    p.add_argument(
        "--serve_dtype", type=str, default="float32", choices=list(SERVE_DTYPES),
        help="serving compute dtype (models/precision.py): bfloat16 runs the "
             "block stack in bf16 with f32 attention accumulation, an f32 "
             "attention normalizer and an f32 output head; params stay f32 "
             "at rest (the engine publishes a cast copy per reload) and "
             "batches assemble in bf16",
    )
    p.add_argument(
        "--serve_packed", action="store_true",
        help="serving: first-fit pack the requests as chunk-aligned segments "
             "into one fixed dispatch shape (a PackPlan derived from the "
             "traffic) instead of one padded row each; each response is "
             "exactly its own nodes, and requests the plan does not fit take "
             "the padded per-bucket path",
    )
    p.add_argument(
        "--serve_pack_chunk", type=int, default=64,
        help="serving: packed-mode segment alignment in tokens (multiple of 8)",
    )
    return p


def data_config(args) -> DataConfig:
    return DataConfig(
        train_path=args.train_data,
        test_path=args.test_data,
        synthetic=args.synthetic,
        synth_size=args.synth_size,
        n_train=args.n_train,
        n_test=args.n_test,
        batch_size=args.batch_size,
        seed=args.seed,
        bucket=not args.no_bucket and args.attention_mode != "parity",
        packed=args.packed,
        pack_chunk=args.pack_chunk,
    )


def train_config(args) -> Config:
    """The training run's config (``gnot_tpu/main.py::config_from_args``)."""
    return Config(
        optim=OptimConfig(
            lr=args.lr,
            grad_accum=args.grad_accum,
            flat_params=args.flat_params,
            parity_schedule_bug=args.schedule == "parity",
        ),
        data=data_config(args),
        train=TrainConfig(
            epochs=args.epochs,
            loss=args.loss,
            checkpoint_dir=args.checkpoint_dir,
            resume=args.resume,
            checkpoint_every=args.checkpoint_every,
            steps_per_dispatch=args.steps_per_dispatch,
            log_every=args.log_every,
            metrics_path=args.metrics_path,
            telemetry=args.telemetry,
            profile_dir=args.profile_dir,
            trace_path=args.trace_path,
            trace_sample_rate=args.trace_sample_rate,
            debug_checks=args.debug_checks,
            stop_after_epoch=args.stop_after_epoch,
            inject_fault=args.inject_fault,
            recovery=args.recovery,
            snapshot_every=args.snapshot_every,
            max_rollbacks=args.max_rollbacks,
            graceful_preempt=not args.no_preempt,
            preempt_sync_every=args.preempt_sync_every,
            seed=args.seed,
        ),
    )


def configs_from_args(args) -> tuple[DataConfig, ServeConfig]:
    data = data_config(args)
    serve = ServeConfig(
        max_batch=args.serve_max_batch,
        max_wait_ms=args.serve_max_wait_ms,
        queue_limit=args.serve_queue_limit,
        dtype=args.serve_dtype,
        packed=args.serve_packed,
        pack_chunk=args.serve_pack_chunk,
    )
    return data, serve


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
        attention_mode=args.attention_mode,
        attention_impl=args.attention_impl,
        ffn_impl=args.ffn_impl,
        gelu=args.gelu,
        dtype=args.dtype,
        remat=args.remat,
        scan_layers=args.scan_layers,
    )


def run_device(args) -> torch.device:
    """The run's device: ``--device``, or ``cuda:i`` with ``--device_id i``
    (then also torch's current CUDA device, which the kernels launch on)."""
    if args.device_id < 0:
        return resolve_device(args.device)
    if args.device == "cpu":
        raise ValueError("--device_id pins a CUDA device; drop --device cpu")
    device = resolve_device(f"cuda:{args.device_id}")
    if args.device_id >= torch.cuda.device_count():
        raise ValueError(
            f"--device_id {args.device_id} out of range: "
            f"{torch.cuda.device_count()} device(s) visible"
        )
    torch.cuda.set_device(device)
    return device


@dataclasses.dataclass
class RunManifest:
    """The run's ``run.json`` beside ``--metrics_path``
    (``obs/manifest.py``), rewritten whole with what each ``write`` adds:
    the first write, before the run, fixes its path."""

    args: argparse.Namespace
    argv: list[str]
    path: str = ""
    fields: dict = dataclasses.field(default_factory=dict)

    def write(self, **fields) -> None:
        self.fields.update(fields)
        if not self.path:
            self.path = manifest_lib.manifest_path_for(self.args.metrics_path)
        extra = {"metrics_path": self.args.metrics_path,
                 "kind": self.fields.get("kind"), "restore": self.fields.get("restore")}
        manifest_lib.write_manifest(
            self.path, argv=self.argv, extra=extra,
            **{k: self.fields.get(k) for k in ("config", "model_config", "device")},
        )


def param_layout(args) -> str:
    """The parameter layout the flags select: "flat", "stacked" or
    "standard"."""
    return "flat" if args.flat_params else "stacked" if args.scan_layers else "standard"


@dataclasses.dataclass
class ServeRun:
    """Everything one ``--serve`` run produced."""

    summary: dict
    results: list[ServeResult]
    samples: list[MeshSample]
    model: GNOT
    pack_plan: PackPlan | None = None


def checkpoint_meta(args, mc: ModelConfig) -> dict:
    """The provenance every sidecar records (``gnot_tpu/main.py``): the
    resolved numerics, which a restore under other flags warns about, and
    the state layout."""
    return {"gelu": mc.gelu, "attention_mode": mc.attention_mode, "dtype": mc.dtype,
            "flat_params": args.flat_params}


def restore_for_serving(model: GNOT, checkpointer: Checkpointer | None,
                        layout: str = "standard") -> str:
    """Load the ``best`` checkpoint's weights into ``model``, else the
    ``latest`` one's (``gnot_tpu/main.py``'s serve restore: each walks its
    fallback chain, and ``restore_latest`` walks on to ``best``),
    converted from the checkpoint's parameter layout, which must be
    ``layout``, to the standard one. Returns the name of the checkpoint
    that was loaded (``checkpointer.last_restore`` says which file), or ""
    when none was: with a checkpointer that restores nothing, after
    printing the JAX package's note."""
    if checkpointer is None:
        return ""
    restored = checkpointer.restore_best() or checkpointer.restore_latest()
    if restored is None:
        print("note: no restorable checkpoint — serving fresh weights")
        return ""
    state, name = restored[0], checkpointer.last_restore["name"]
    if state_layout(state) != layout:
        raise ValueError(
            f"the '{name}' checkpoint holds the {state_layout(state)} parameter "
            f"layout but this run uses the {layout} layout; pass the layout "
            "flag it was trained with (--flat_params, --scan_layers)"
        )
    model.load_state_dict(standard_weights(
        state["model"], model.state_dict(), model.config.n_attn_layers))
    return name


def run_serve(args, *, sink=None, tracer=None, manifest: RunManifest | None = None) -> ServeRun:
    """``--serve``: build the model on the chosen device with the weights
    of ``--checkpoint_dir`` (else from ``--seed``), start the server with
    one warm-up dispatch per bucket (and, with ``--serve_packed``, one
    packed dispatch of the plan derived from the traffic), submit the test split of
    ``datasets.load`` as requests, wait for every future, drain, and
    report. The server writes its events to ``sink`` and its request
    spans to ``tracer`` when given."""
    device = run_device(args)
    data, sc = configs_from_args(args)
    train_samples, samples = datasets.load(data)
    gen = torch.Generator().manual_seed(args.seed)
    mc = model_config(args, train_samples)
    if manifest is not None:
        manifest.write(config=train_config(args), model_config=mc, device=device, kind="serve")
    model = GNOT(mc, generator=gen).to(device)
    checkpointer = (
        Checkpointer(args.checkpoint_dir, extra_meta=checkpoint_meta(args, mc),
                     on_event=sink.log if sink is not None else None)
        if args.checkpoint_dir else None
    )
    restored = restore_for_serving(model, checkpointer, param_layout(args))
    if manifest is not None and checkpointer is not None:
        # Which checkpoint serving restored, any fallback walk included.
        manifest.write(restore=checkpointer.last_restore)
    engine = InferenceEngine(model, batch_size=data.batch_size, dtype=sc.dtype)
    # Packed dispatch: the one fixed dispatch shape comes from the traffic
    # itself, the samples about to be served.
    pack_plan = (
        PackPlan.for_slices(samples, chunk=sc.pack_chunk, batch_size=sc.max_batch,
                            per_devices=1)
        if sc.packed else None
    )
    server = InferenceServer(
        engine,
        max_batch=sc.max_batch,
        max_wait_ms=sc.max_wait_ms,
        queue_limit=sc.queue_limit,
        pack_plan=pack_plan,
        sink=sink,
        tracer=tracer,
    )
    t0 = time.monotonic()
    server.start(warmup=samples)
    warm_s = time.monotonic() - t0
    try:
        futures = [server.submit(s) for s in samples]
        results = [f.result(timeout=DRAIN_TIMEOUT_S) for f in futures]
    finally:
        summary = server.drain(DRAIN_TIMEOUT_S)
    summary.update(warmed_buckets=server.warmed, warmup_s=warm_s, device=str(device),
                   restored=restored)
    if pack_plan is not None:
        summary["pack_plan"] = dataclasses.asdict(pack_plan)
    return ServeRun(summary, results, samples, model, pack_plan)


def run_train(args, *, sink=None, tracer=None, manifest: RunManifest | None = None) -> Trainer:
    """Training (no ``--serve``): load the splits, build the trainer on
    the chosen device with weights from ``--seed``, fit (or with
    ``--eval_only`` evaluate the best checkpoint), then export and
    predict as asked (``gnot_tpu/main.py``). Returns the trainer: its
    ``best_metric`` (with ``--eval_only``, the metric just evaluated),
    ``history`` and model. The trainer writes its records to ``sink``
    and its spans to ``tracer`` when given."""
    device = run_device(args)
    cfg = train_config(args)
    train_samples, test_samples = datasets.load(cfg.data)
    mc = model_config(args, train_samples)
    # The trainer gives the checkpointer its fault injector and the sink.
    checkpointer = (
        Checkpointer(cfg.train.checkpoint_dir, extra_meta=checkpoint_meta(args, mc))
        if cfg.train.checkpoint_dir else None
    )
    trainer = Trainer(cfg, mc, train_samples, test_samples, checkpointer=checkpointer,
                      device=device, metrics_sink=sink, tracer=tracer)
    if manifest is not None:
        # Before any step: a run that dies keeps its provenance.
        manifest.write(config=cfg, model_config=mc, device=device,
                       kind="eval" if args.eval_only else "train")
    if args.eval_only:
        trainer.best_metric = trainer.evaluate_from_checkpoint()
        if manifest is not None and checkpointer is not None:
            # Which 'best' the eval restored, any fallback walk included.
            manifest.write(restore=checkpointer.last_restore)
    else:
        trainer.initialize()
        if manifest is not None and checkpointer is not None:
            # A resume that fell back from 'latest' to 'best' shows here.
            manifest.write(restore=checkpointer.last_restore)
        trainer.fit()
    if (args.export_torch or args.predict_out) and not args.eval_only:
        # The artifacts of the reported best metric, not of the last epoch.
        if checkpointer is not None:
            trainer.restore_best()
        else:
            print("note: no --checkpoint_dir, so export/predict artifacts "
                  "use the FINAL-epoch weights, not the reported best")
    if args.export_torch:
        torch.save(interop.reference_state_dict(trainer.standard_params(), mc),
                   args.export_torch)
        print(f"Exported torch state_dict to {args.export_torch}")
    if args.predict_out:
        preds = trainer.predict(test_samples)
        datasets.save_pickle(
            [dataclasses.replace(s, y=p) for s, p in zip(test_samples, preds)],
            args.predict_out,
        )
        print(f"Wrote {len(preds)} predictions to {args.predict_out}")
    return trainer


def run(argv: list[str] | None = None) -> Trainer | ServeRun:
    """The command line's run: the trainer of a training (or eval) run,
    or the ``ServeRun`` of ``--serve`` after printing its summary line.
    The metrics sink, the tracer's flush and the manifest's last write sit
    on one ``ExitStack``: a run that raises still leaves its records,
    trace and provenance (``gnot_tpu/main.py``)."""
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.log_every and not args.metrics_path:
        parser.error("--log_every needs --metrics_path (step records are JSONL-only)")
    argv = list(argv) if argv is not None else sys.argv[1:]
    with contextlib.ExitStack() as stack:
        sink = stack.enter_context(MetricsSink(args.metrics_path)) if args.metrics_path else None
        tracer = None
        if args.trace_path:
            # annotate under --profile_dir: each span is also a profiler
            # range, so host phases line up with the kernels.
            tracer = Tracer(path=args.trace_path, sample_rate=args.trace_sample_rate,
                            annotate=bool(args.profile_dir))

            # After the sink's enter_context: unwinding flushes the trace
            # (and writes its trace_flush event) before the sink closes.
            def flush_trace(t=tracer):
                path = t.flush(sink=sink)
                print(f"Wrote {len(t.snapshot())} spans to {path} (open in "
                      "chrome://tracing / https://ui.perfetto.dev; summarize with "
                      "tools/trace_report.py)")

            stack.callback(flush_trace)
        manifest = None
        if args.metrics_path:
            manifest = RunManifest(args, argv)
            stack.callback(lambda: manifest.path and manifest.write())
        if not args.serve:
            return run_train(args, sink=sink, tracer=tracer, manifest=manifest)
        result = run_serve(args, sink=sink, tracer=tracer, manifest=manifest)
    print(json.dumps({"serve_summary": result.summary}))
    return result


def main(argv: list[str] | None = None) -> float:
    """Trains (or evaluates) and returns the best (or evaluated) test
    metric, or with ``--serve`` serves and returns the share of requests
    answered."""
    result = run(argv)
    if isinstance(result, Trainer):
        return result.best_metric
    return result.summary["completed"] / max(1, result.summary["requests"])


if __name__ == "__main__":
    main()
