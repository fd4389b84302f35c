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

Serving's failure handling and live metrics (``gnot_tpu/main.py``'s
flags, defaults and refusals): ``--serve_deadline_ms`` sheds requests
past their deadline before dispatch; ``--serve_breaker_threshold`` and
``--serve_breaker_cooldown_s`` set the circuit breaker; ``--drain_timeout_s``
bounds each wait of the storm and the drain; ``--serve_inject_fault``
arms ``slow_request@N``, ``nan_output@N`` and ``reload_corrupt@N``;
``--serve_reload_every N`` hot-reloads ``--checkpoint_dir`` every N
requests; SIGTERM stops the storm and drains the server;
``--metrics_interval_s`` streams the live registry (``metrics_snapshot``
events, ``<metrics-stem>.series.jsonl``, ``<metrics-stem>.prom``) with
``slo_alert`` edges on the ``--slo_*`` objectives when serving, and the
telemetry drain's step times when training.

Tenants and rollout sessions (``gnot_tpu/main.py``'s flags, defaults and
refusals): ``--tenant_weights``, ``--tenant_quotas`` and
``--tenant_priorities`` build one ``TenantPolicy`` (per-tenant WFQ
weights, quotas, priority classes; with the metrics plane on, a latency
and a shed objective per tenant beside the pool's);
``--serve_rollout_steps K`` drives each test sample as one K-step rollout
session (``submit_rollout``), waiting ``drain_timeout_s * K`` for each,
snapshotted every ``--session_snapshot_every`` steps; ``--session_dir``
keeps drained named sessions' snapshots for ``resume_rollout``. The
``Serve:`` line gains the sessions clause, and ``main`` then returns the
fraction of sessions completed.

Replicas and the router (``gnot_tpu/main.py``'s flags, defaults and
refusals): ``--serve_replicas N`` (N > 1) serves through a
``ReplicaRouter`` over N replicas of the served weights on the run's one
card, each warmed by dispatching every bucket and running on its own CUDA
stream; ``--route_policy`` picks the placement policy and
``--wedge_after_s`` the router's wedge bound; ``--serve_reload_every``
rolls each reload across the pool; the ``Serve:`` line gains the routing
clause. ``--serve_prewarm`` is refused (no executable to serialize), and
so are ``--scan_layers`` and ``--flat_params`` with replicas, as in JAX.

The elastic pool (``gnot_tpu/main.py``'s nine ``--autoscale*`` flags,
defaults and checks): ``--autoscale`` routes through a ``ReplicaRouter``
even from ``--serve_replicas 1`` and runs an ``AutoscaleController``
(``serve/autoscaler.py``) over it while the storm runs, building each
founding, scale-out and replacement replica through ``build_replica`` on
the run's card (every slot is that card, so ``--autoscale_max`` is not
held to a device count); the controller is closed before the drain, JAX's
``Autoscale: pool [...]`` line is printed and run.json gains
``autoscale`` with ``replica_seconds``.

The federation (``gnot_tpu/main.py``'s six flags, defaults and checks):
``--hosts N`` (N > 1) splits the ``--serve_replicas`` replicas on the
run's card evenly into N loopback hosts, each a ``ReplicaRouter`` behind a
``HostAgent``, and a ``ClusterRouter`` (``serve/federation.py``) serves
the storm through the versioned wire protocol over in-proc links or, from
``--federation_port``, loopback TCP; ``--heartbeat_interval_s``,
``--suspect_after_s`` and ``--dead_after_s`` set the control loop and the
failure detector's leases; ``--session_dir`` is the store a dead host's
sessions re-migrate from; ``--trace_path`` becomes the merged cluster
trace and ``--flight_recorder_s`` turns on the flight recorders. JAX's
``Federated serve:`` line is printed and run.json gains ``federation``.

Parallel training (``gnot_tpu/main.py``'s seven mesh flags, defaults and
checks): ``--distributed`` trains over the rank mesh of ``--mesh_data``,
``--mesh_seq``, ``--mesh_model``, ``--mesh_expert`` and ``--mesh_pipe``
with ``--microbatches`` (``parallel/mesh.py``, the pipeline schedule in
``parallel/pipeline.py``), ``--packed`` and ``--scan_layers`` included,
one process a rank, launched by ``torchrun``
(``python -m torch.distributed.run --nproc_per_node N -m
gnot_tpu_torch.main --distributed ...``) or alone as a mesh of one. Each
rank joins the group ``torchrun``'s environment describes
(``parallel/multihost.py::initialize``: gloo on the CPU, NCCL with a card
a rank, gloo with CUDA tensors when ranks share a card, named on the
``Distributed:`` line); with several nodes each keeps its node's strided
shard of the samples (``shard_samples``), padded to the whole dataset's
lengths. Rank 0 alone writes the metrics, the trace, ``run.json`` (with the
mesh and ``process_count`` / ``process_index``), the checkpoints, the
export and the predictions. ``--serve`` with ``--distributed`` is
refused (``NotPortedError``: JAX serves on a one-process mesh, the port's
mesh is one process a rank), and ``--device_id`` with it.

Runs on ``cuda`` unless ``--device cpu`` is given; ``--device_id i``
pins ``cuda:i``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import tempfile
import time

import torch

from gnot_tpu_torch import interop, native
from gnot_tpu_torch.config import (
    Config,
    DataConfig,
    MeshConfig,
    ModelConfig,
    NotPortedError,
    OptimConfig,
    ServeConfig,
    TrainConfig,
)
from gnot_tpu_torch.data import datasets
from gnot_tpu_torch.data.batch import MeshSample, PackPlan
from gnot_tpu_torch.device import resolve_device
from gnot_tpu_torch.models.gnot import GNOT
from gnot_tpu_torch.models.precision import SERVE_DTYPES
from gnot_tpu_torch.obs import events
from gnot_tpu_torch.obs import manifest as manifest_lib
from gnot_tpu_torch.obs import metrics as metrics_lib
from gnot_tpu_torch.obs.tracing import Tracer
from gnot_tpu_torch.parallel import multihost
from gnot_tpu_torch.resilience.faults import FaultInjector
from gnot_tpu_torch.resilience.preemption import PreemptionHandler
from gnot_tpu_torch.serve.engine import InferenceEngine
from gnot_tpu_torch.serve.policies import TenantPolicy
from gnot_tpu_torch.serve.autoscaler import AutoscaleController
from gnot_tpu_torch.serve.replica import build_replica, build_replicas
from gnot_tpu_torch.serve.rollout import RolloutResult, SessionStore
from gnot_tpu_torch.serve.router import ReplicaRouter
from gnot_tpu_torch.serve.server import CheckpointReloader, InferenceServer, ServeResult
from gnot_tpu_torch.train.checkpoint import Checkpointer
from gnot_tpu_torch.train.trainer import Trainer, serving_weights
from gnot_tpu_torch.utils.metrics import MetricsSink


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
        "--serve_deadline_ms", type=float, default=0.0,
        help="serving: default per-request deadline (0 = none); expired "
             "requests are shed before dispatch",
    )
    p.add_argument(
        "--serve_breaker_threshold", type=int, default=3,
        help="serving: consecutive dispatch failures (NaN outputs / "
             "device errors) that trip the circuit breaker open",
    )
    p.add_argument(
        "--serve_breaker_cooldown_s", type=float, default=1.0,
        help="serving: seconds the tripped breaker rejects before one "
             "half-open trial dispatch decides recovery",
    )
    p.add_argument(
        "--drain_timeout_s", type=float, default=30.0,
        help="serving: graceful-drain budget — how long drain() waits "
             "for in-flight requests before force-resolving the "
             "stragglers",
    )
    p.add_argument(
        "--wedge_after_s", type=float, default=2.0,
        help="serving: seconds of worker-loop silence (with requests "
             "in-system) before the router treats a replica as wedged "
             "and drains its traffic to siblings",
    )
    p.add_argument(
        "--serve_inject_fault", type=str, default="",
        help="serving-side deterministic fault injection: comma-separated "
             "kind@N — slow_request@admission, nan_output@dispatch, "
             "reload_corrupt@reload",
    )
    p.add_argument(
        "--serve_reload_every", type=int, default=0,
        help="serving demo traffic: hot-reload the checkpoint after "
             "every N requests (0 = never) — exercises the atomic "
             "weight swap under load",
    )
    p.add_argument(
        "--metrics_interval_s", type=float, default=0.0,
        help="live metrics plane (obs/metrics.py): publish a registry "
             "snapshot every N seconds: metrics_snapshot events, a JSONL "
             "time series (<metrics-stem>.series.jsonl), a Prometheus "
             "exposition file (<metrics-stem>.prom), and slo_alert "
             "burn-rate fire/clear edges when serving; 0 = off",
    )
    p.add_argument(
        "--slo_p99_ms", type=float, default=0.0,
        help="serving SLO: windowed p99 latency objective (ms) the live "
             "metrics plane alerts on; 0 = no latency objective",
    )
    p.add_argument(
        "--slo_shed_frac", type=float, default=0.05,
        help="serving SLO: tolerated windowed shed fraction before the "
             "live metrics plane fires an slo_alert; 0 = off",
    )
    p.add_argument(
        "--slo_fast_window_s", type=float, default=5.0,
        help="serving SLO: fast burn-rate window (seconds) — both "
             "windows must burn > 1.0 to FIRE; the fast window "
             "clearing CLEARS (edge-triggered alerts)",
    )
    p.add_argument(
        "--slo_slow_window_s", type=float, default=30.0,
        help="serving SLO: slow burn-rate window (seconds) — the "
             "sustained-violation half of the two-window burn gate",
    )
    p.add_argument(
        "--serve_rollout_steps", type=int, default=0,
        help="serving: autoregressive rollout mode (docs/serving.md "
             "'Rollout serving') — drive each test sample as ONE "
             "K-step stateful session (K chained dispatches, carry "
             "resident on the owning replica, per-step deadlines, "
             "streamed partial results, migration on replica failure); "
             "0 = one-shot serving",
    )
    p.add_argument(
        "--session_snapshot_every", type=int, default=1,
        help="serving: rollout-session snapshot cadence (steps between "
             "host-side carry snapshots — the state a migration "
             "replays from; 1 = every step)",
    )
    p.add_argument(
        "--session_dir", type=str, default="",
        help="serving: persist drained rollout sessions' final carry "
             "snapshots in this directory (serve/rollout.py::"
             "SessionStore) — a restarted server resumes a named "
             "session from its last snapshotted step (resume_rollout)",
    )
    p.add_argument(
        "--hosts", type=int, default=1,
        help="serving: federate the replica pool across N loopback "
             "hosts (serve/federation.py, docs/distributed.md) — each "
             "host wraps an even share of --serve_replicas behind a "
             "HostAgent; a ClusterRouter places requests/sessions over "
             "the versioned wire protocol, detects dead hosts by lease, "
             "and re-migrates their sessions to survivors; 1 = the "
             "single-host tier, byte-identical to before"
    )
    p.add_argument(
        "--federation_port", type=int, default=0,
        help="federation: base loopback-TCP port — host i listens on "
             "port+i and the controller connects real sockets instead "
             "of in-proc links (0 = in-proc transport; chaos hooks are "
             "in-proc-only)"
    )
    p.add_argument(
        "--heartbeat_interval_s", type=float, default=0.5,
        help="federation: cluster control-loop cadence — each tick "
             "probes every host's lease, sweeps the failure detector, "
             "and publishes the merged per-host series"
    )
    p.add_argument(
        "--suspect_after_s", type=float, default=2.0,
        help="federation failure detector: a host silent this long is "
             "SUSPECT — new placements avoid it and its pending "
             "one-shots are hedged onto siblings, but nothing is "
             "declared dead yet"
    )
    p.add_argument(
        "--dead_after_s", type=float, default=6.0,
        help="federation failure detector: a host silent this long is "
             "DEAD — its sessions re-migrate to survivors from "
             "persisted snapshots; must exceed --suspect_after_s (the "
             "suspicion dwell absorbs GC pauses and slow heartbeats)"
    )
    p.add_argument(
        "--flight_recorder_s", type=float, default=0.0,
        help="anomaly flight recorder (obs/dtrace.py, "
             "docs/observability.md 'Distributed tracing'): keep the "
             "last N seconds of ALL spans/events — sampled or not — in "
             "a bounded per-host ring, dumped atomically beside the "
             "trace/metrics path on trigger edges (slo_alert fire, "
             "breaker_open, host_dead, non_finite_loss, lockguard "
             "inversion); 0 = off"
    )
    p.add_argument(
        "--tenant_weights", type=str, default="",
        help="serving multi-tenant isolation (docs/serving.md): "
             "per-tenant WFQ weights as tenant:weight pairs, e.g. "
             "'interactive:3,batch:1' — the batcher drains each "
             "bucket's per-tenant sub-queues deficit-round-robin by "
             "these shares, so a flooding tenant cannot starve "
             "siblings; empty (with the other tenant specs empty) = "
             "tenant mode off, byte-identical single-tenant behavior",
    )
    p.add_argument(
        "--tenant_quotas", type=str, default="",
        help="serving multi-tenant isolation: per-tenant admission "
             "quotas as tenant:limit pairs — a tenant at its pool-wide "
             "in-system limit fast-fails new work in O(1) with reason "
             "shed_tenant_quota (tenant_quota_shed event); unlisted "
             "tenants are never quota-limited",
    )
    p.add_argument(
        "--tenant_priorities", type=str, default="",
        help="serving multi-tenant isolation: per-tenant priority "
             "classes as tenant:class pairs (class 'interactive' or "
             "'batch'); under contention batch-class work is deferred "
             "first — brownout before blackout; unlisted tenants are "
             "interactive (except one literally named 'batch')",
    )
    p.add_argument(
        "--serve_dtype", type=str, default="float32", choices=list(SERVE_DTYPES),
        help="serving compute dtype (models/precision.py): bfloat16 runs the "
             "block stack in bf16 with f32 attention accumulation, an f32 "
             "attention normalizer and an f32 output head; params stay f32 "
             "at rest (the engine publishes a cast copy per reload) and "
             "batches assemble in bf16",
    )
    p.add_argument(
        "--serve_replicas", type=int, default=1,
        help="serving: engine replicas behind the compile-affinity "
             "router (serve/router.py) — each replica owns a disjoint "
             "device slice (GSPMD NamedSharding placement), its own "
             "queue/batcher/breaker, and reloads roll across the pool "
             "one replica at a time; 1 = the single-server tier "
             "(docs/serving.md 'Replicated serving')",
    )
    p.add_argument(
        "--route_policy", type=str, default="affinity",
        choices=["affinity", "least_loaded", "round_robin"],
        help="serving: replica placement policy — affinity (prefer the "
             "replica that already compiled the request's bucket; cold "
             "compiles never stall the pool), least_loaded, round_robin",
    )
    p.add_argument(
        "--autoscale", action="store_true",
        help="serving: self-healing elastic pool (serve/autoscaler.py) — "
             "an AutoscaleController scales the replica pool against "
             "live SLO/load pressure: warm-before-join scale-out (a new "
             "replica runs its warm-up dispatches before it takes "
             "traffic), drain-then-remove scale-in (resident sessions "
             "migrate to siblings), self-healing replacement of "
             "dead/wedged replicas; guards: min/max bounds, "
             "per-direction cooldowns, hysteresis, flap suppression"
    )
    p.add_argument(
        "--autoscale_min", type=int, default=1,
        help="autoscale: pool floor (the controller never shrinks "
             "below it)"
    )
    p.add_argument(
        "--autoscale_max", type=int, default=4,
        help="autoscale: pool ceiling; every slot is the run's one "
             "card, each replica on its own CUDA stream"
    )
    p.add_argument(
        "--autoscale_cooldown_s", type=float, default=2.0,
        help="autoscale: per-direction cooldown between actions; the "
             "flap suppressor additionally vetoes any scale-in within "
             "3 cooldowns of a scale-out"
    )
    p.add_argument(
        "--autoscale_interval_s", type=float, default=0.5,
        help="autoscale: controller tick cadence (seconds)"
    )
    p.add_argument(
        "--autoscale_up_load", type=float, default=8.0,
        help="autoscale: per-replica in-system load (requests + "
             "sessions) above which the controller scales out; must "
             "exceed --autoscale_down_load (hysteresis)"
    )
    p.add_argument(
        "--autoscale_down_load", type=float, default=1.0,
        help="autoscale: per-replica load below which a tick counts as "
             "calm; the hysteresis floor of the up/down load band"
    )
    p.add_argument(
        "--autoscale_down_ticks", type=int, default=3,
        help="autoscale: consecutive calm ticks required before any "
             "scale-in (sustained-calm guard)"
    )
    p.add_argument(
        "--autoscale_heal_after_s", type=float, default=5.0,
        help="autoscale: seconds a replica stays dead/wedged/breaker-"
             "stuck before the controller replaces it (self-healing)"
    )
    p.add_argument(
        "--serve_prewarm", type=str, default="",
        help="serving: JAX's deploy-time AOT prewarm manifest; refused: "
             "eager PyTorch has no compiled executable to serialize (each "
             "replica warms by dispatching every bucket instead)",
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
    # Parallel training (gnot_tpu/main.py:539-560).
    p.add_argument(
        "--distributed", action="store_true",
        help="train over the rank mesh (one torch.distributed process a "
             "rank; spans hosts when launched by torchrun on several nodes)"
    )
    p.add_argument("--mesh_data", type=int, default=-1)
    p.add_argument("--mesh_seq", type=int, default=1)
    p.add_argument("--mesh_model", type=int, default=1)
    p.add_argument(
        "--mesh_expert", type=int, default=1,
        help="expert parallelism over the stacked soft-MoE experts "
             "(n_expert must be divisible by it)"
    )
    p.add_argument(
        "--mesh_pipe", type=int, default=1,
        help="pipeline parallelism over the attention-block stack "
             "(n_attn_layers must be divisible by it; composes with the "
             "data axis only)"
    )
    p.add_argument(
        "--microbatches", type=int, default=0,
        help="microbatches per pipeline round (0 = one per stage); the "
             "pipeline bubble is (pipe-1)/(microbatches+pipe-1)"
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
            distributed=args.distributed,
        ),
        mesh=MeshConfig(
            data=args.mesh_data,
            seq=args.mesh_seq,
            model=args.mesh_model,
            expert=args.mesh_expert,
            pipe=args.mesh_pipe,
            microbatches=args.microbatches,
        ),
    )


def configs_from_args(args) -> tuple[DataConfig, ServeConfig]:
    data = data_config(args)
    serve = ServeConfig(
        max_batch=args.serve_max_batch,
        max_wait_ms=args.serve_max_wait_ms,
        queue_limit=args.serve_queue_limit,
        deadline_ms=args.serve_deadline_ms,
        breaker_threshold=args.serve_breaker_threshold,
        breaker_cooldown_s=args.serve_breaker_cooldown_s,
        drain_timeout_s=args.drain_timeout_s,
        inject_fault=args.serve_inject_fault,
        dtype=args.serve_dtype,
        packed=args.serve_packed,
        pack_chunk=args.serve_pack_chunk,
        metrics_interval_s=args.metrics_interval_s,
        slo_p99_ms=args.slo_p99_ms,
        slo_shed_frac=args.slo_shed_frac,
        slo_fast_window_s=args.slo_fast_window_s,
        slo_slow_window_s=args.slo_slow_window_s,
        rollout_steps=args.serve_rollout_steps,
        session_snapshot_every=args.session_snapshot_every,
        session_dir=args.session_dir,
        tenant_weights=args.tenant_weights,
        tenant_quotas=args.tenant_quotas,
        tenant_priorities=args.tenant_priorities,
        replicas=args.serve_replicas,
        route_policy=args.route_policy,
        wedge_after_s=args.wedge_after_s,
        autoscale=args.autoscale,
        autoscale_min=args.autoscale_min,
        autoscale_max=args.autoscale_max,
        autoscale_interval_s=args.autoscale_interval_s,
        autoscale_cooldown_s=args.autoscale_cooldown_s,
        autoscale_up_load=args.autoscale_up_load,
        autoscale_down_load=args.autoscale_down_load,
        autoscale_down_ticks=args.autoscale_down_ticks,
        autoscale_heal_after_s=args.autoscale_heal_after_s,
        hosts=args.hosts,
        federation_port=args.federation_port,
        heartbeat_interval_s=args.heartbeat_interval_s,
        suspect_after_s=args.suspect_after_s,
        dead_after_s=args.dead_after_s,
        flight_recorder_s=args.flight_recorder_s,
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
    (then also torch's current CUDA device, which the kernels launch on);
    with ``--distributed``, this rank's card (``multihost.rank_device``)."""
    if args.distributed:
        return resolve_device(str(multihost.rank_device(resolve_device(args.device))))
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
        # The live metrics plane's stats (MetricsPublisher.stats()), the
        # controller's stats and replica-seconds (--autoscale), the cluster
        # summary without per_host (--hosts N > 1), and a serve run's host
        # packer status and dtype: each only when the run has it.
        for key in ("metrics", "autoscale", "federation", "native_packer", "serve_dtype"):
            if self.fields.get(key) is not None:
                extra[key] = self.fields[key]
        manifest_lib.write_manifest(
            self.path, argv=self.argv, extra=extra,
            **{k: self.fields.get(k) for k in ("config", "model_config", "device", "mesh")},
        )


def param_layout(args) -> str:
    """The parameter layout the flags select: "flat", "stacked" or
    "standard"."""
    return "flat" if args.flat_params else "stacked" if args.scan_layers else "standard"


@dataclasses.dataclass
class ServeRun:
    """Everything one ``--serve`` run produced."""

    summary: dict
    # One ServeResult per request, or with --serve_rollout_steps one
    # RolloutResult per session.
    results: list[ServeResult | RolloutResult]
    samples: list[MeshSample]
    model: GNOT
    pack_plan: PackPlan | None = None
    # The live metrics plane's stats with ``summary_agrees`` (run.json's
    # ``metrics``), when --metrics_interval_s is on.
    metrics: dict | None = None


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
    name = checkpointer.last_restore["name"]
    model.load_state_dict(serving_weights(
        restored[0], model.state_dict(), model.config.n_attn_layers, layout, name))
    return name


def run_serve(args, *, sink=None, tracer=None, manifest: RunManifest | None = None,
              registry=None) -> ServeRun:
    """``--serve``: build the model on the chosen device with the weights
    of ``--checkpoint_dir`` (else from ``--seed``), start the server with
    one warm-up dispatch per bucket (and, with ``--serve_packed``, one
    packed dispatch of the plan derived from the traffic) inside a
    ``PreemptionHandler`` (SIGTERM drains it), submit the test split of
    ``datasets.load`` as requests (``_serve_storm``), drain, and report.
    With a ``--checkpoint_dir`` the server can hot-reload it
    (``CheckpointReloader``; ``--serve_reload_every``); with
    ``--metrics_interval_s`` it records into ``registry`` (a fresh one
    when None), which a ``MetricsPublisher`` with the config's SLO
    objectives streams until after the drain, and the final snapshot is
    held to the summary (``summary_agrees``). The tenant flags give the
    server one ``TenantPolicy`` (and the evaluator per-tenant objectives),
    ``--session_dir`` a ``SessionStore``, and ``--serve_rollout_steps``
    makes each sample a rollout session. With ``--serve_replicas N > 1`` a
    ``ReplicaRouter`` over N replicas on the same card takes the server's
    place, and with ``--autoscale`` one over the founding replicas, which an
    ``AutoscaleController`` scales. The server writes its events to ``sink``
    and its request spans to ``tracer`` when given."""
    if args.serve_prewarm:
        raise NotPortedError(
            "--serve_prewarm (AOT executable snapshots, JAX's serve/aot.py) has no "
            "counterpart: eager PyTorch has no compiled executable to serialize; each "
            "replica warms by dispatching every bucket")
    device = run_device(args)
    data, sc = configs_from_args(args)
    # An elastic pool routes through the router even from one replica.
    replicated = sc.replicas > 1 or sc.autoscale
    if replicated and (args.scan_layers or args.flat_params):
        # The replicas serve the standard layout only, as JAX's do.
        raise ValueError(
            "--serve_replicas serves the standard param layout only; "
            "drop --scan_layers/--flat_params for replicated serving "
            "(single-server --serve supports them)"
        )
    faults = FaultInjector.from_spec(sc.inject_fault)
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
    # Whether batch assembly and unpad run the C++ packer or numpy, once,
    # as an event and in run.json (gnot_tpu/main.py's record), for every
    # serving layout: one server, replicas, the autoscaler, --hosts.
    packer = native.status()
    if sink is not None:
        sink.log(
            event=events.NATIVE_PACKER,
            available=packer["available"],
            impl=packer["impl"],
            pack_native_min_bytes=packer["pack_native_min_bytes"],
            unpad_native_min_bytes=packer["unpad_native_min_bytes"],
            **({"so": packer["so"]} if packer["so"] else {}),
            **({"error": packer["error"]} if packer["error"] else {}),
        )
    if manifest is not None:
        manifest.write(native_packer=packer, serve_dtype=sc.dtype)
    if sc.hosts > 1:
        # The federation: its own function, so the path with --hosts 1
        # stays exactly as it is.
        return _run_serve_federated(args, sc, model, samples, device, restored, sink=sink,
                                    manifest=manifest)
    # Packed dispatch: the one fixed dispatch shape comes from the traffic
    # itself, the samples about to be served (per_devices 1: each replica
    # has the whole card).
    pack_plan = (
        PackPlan.for_slices(samples, chunk=sc.pack_chunk, batch_size=sc.max_batch,
                            per_devices=1)
        if sc.packed else None
    )
    reload_fn = (CheckpointReloader(checkpointer, model, layout=param_layout(args))
                 if checkpointer is not None else None)
    # One policy, or None (all three specs empty): tenant mode off.
    tenants = TenantPolicy.from_specs(
        weights=sc.tenant_weights, quotas=sc.tenant_quotas, priorities=sc.tenant_priorities)
    publisher = None
    if sc.metrics_interval_s > 0:
        if registry is None:
            registry = metrics_lib.MetricsRegistry()
        stem = (os.path.splitext(args.metrics_path)[0] if args.metrics_path
                else os.path.join(tempfile.mkdtemp(prefix="gnot_metrics_"), "serve"))
        publisher = metrics_lib.MetricsPublisher(
            registry, interval_s=sc.metrics_interval_s, sink=sink,
            series_path=f"{stem}.series.jsonl", exposition_path=f"{stem}.prom",
            # Per-tenant latency and shed objectives beside the pool's: their
            # slo_alert edges carry the tenant.
            evaluator=metrics_lib.SLOEvaluator(
                metrics_lib.default_objectives(sc)
                + (metrics_lib.tenant_objectives(sc, tenants.tenants)
                   if tenants is not None else [])),
        )
    session_store = SessionStore(sc.session_dir) if sc.session_dir else None
    with PreemptionHandler() as preempt:
        common = dict(
            max_batch=sc.max_batch,
            max_wait_ms=sc.max_wait_ms,
            queue_limit=sc.queue_limit,
            default_deadline_ms=sc.deadline_ms,
            breaker_threshold=sc.breaker_threshold,
            breaker_cooldown_s=sc.breaker_cooldown_s,
            pack_plan=pack_plan,
            sink=sink,
            tracer=tracer,
            reload_fn=reload_fn,
            faults=faults,
            preempt=preempt,
            metrics=registry,
            session_snapshot_every=sc.session_snapshot_every,
            session_store=session_store,
            tenants=tenants,
        )
        if replicated:
            # Replicas of the served weights, all on the run's card, each
            # on its own stream; --serve_reload_every rolls across them.
            replicas = build_replicas(model, sc.replicas, batch_size=sc.max_batch,
                                      dtype=sc.dtype)
            server = ReplicaRouter(replicas, route_policy=sc.route_policy,
                                   wedge_after_s=sc.wedge_after_s, **common)
        else:
            replicas = None
            server = InferenceServer(
                InferenceEngine(model, batch_size=data.batch_size, dtype=sc.dtype), **common)
        controller = None
        try:
            t0 = time.monotonic()
            if replicas is not None:
                warmed = sum(r.warm(samples, rows=sc.max_batch, pack_plan=pack_plan)
                             for r in replicas)
                server.start()
            else:
                warmed = server.start(warmup=samples).warmed
            warm_s = time.monotonic() - t0
            if publisher is not None:
                publisher.start()
            if sc.autoscale:
                # Scale-out replicas come from the factory build_replicas
                # uses for the founding pool. JAX gives each slot its own
                # devices and refuses --autoscale_max beyond the device
                # count; here every replica shares the run's card on its
                # own stream, so every slot is that card and no count is
                # refused.
                def autoscale_factory(rid, slot):
                    return build_replica(model, rid, device, batch_size=sc.max_batch,
                                         dtype=sc.dtype)

                # The controller reads the registry and the evaluator the
                # publisher polls, and scales the founding pool between the
                # bounds while the storm runs.
                controller = AutoscaleController(
                    server,
                    replica_factory=autoscale_factory,
                    min_replicas=sc.autoscale_min,
                    max_replicas=sc.autoscale_max,
                    interval_s=sc.autoscale_interval_s,
                    cooldown_s=sc.autoscale_cooldown_s,
                    up_load=sc.autoscale_up_load,
                    down_load=sc.autoscale_down_load,
                    down_ticks=sc.autoscale_down_ticks,
                    heal_after_s=sc.autoscale_heal_after_s,
                    drain_timeout_s=sc.drain_timeout_s,
                    registry=registry,
                    evaluator=publisher.evaluator if publisher is not None else None,
                    warm_samples=samples,
                    pack_plan=pack_plan,
                    prewarm_manifest=None,
                    sink=sink,
                    tenants=tenants,
                ).start()
            summary, results = _serve_storm(args, sc, server, samples, checkpointer, preempt,
                                            controller=controller)
        finally:
            # The controller's and the publisher's threads stop before the
            # sink can close, on every exit path; the publisher's final
            # snapshot follows the drain. close() is idempotent.
            if controller is not None:
                controller.close()
            if publisher is not None:
                publisher.close()
    if controller is not None:
        ast_stats = controller.stats()  # closed before the drain
        if manifest is not None:
            manifest.write(autoscale={
                **ast_stats, "replica_seconds": round(controller.replica_seconds(), 3)})
        print(f"Autoscale: pool [{sc.autoscale_min}, {sc.autoscale_max}], "
              f"{ast_stats['scale_ups']} up / {ast_stats['scale_downs']} down / "
              f"{ast_stats['replaces']} replaced over {ast_stats['ticks']} ticks; "
              f"{controller.replica_seconds():.1f} replica-seconds")
    metrics = None
    if publisher is not None:
        final = publisher.close()  # already closed: the final row
        disagreements = metrics_lib.summary_agrees(summary, final)
        if disagreements:
            print(f"WARNING: serve_summary and the final metrics_snapshot disagree: "
                  f"{disagreements}")
        metrics = {**publisher.stats(), "summary_agrees": not disagreements}
        if manifest is not None:
            manifest.write(metrics=metrics)
        print(f"Metrics plane: {publisher.seq} snapshots every {sc.metrics_interval_s}s, "
              f"{publisher.alerts} SLO alert edges -> {publisher.series_path} + "
              f"{publisher.exposition_path}")
    routing = summary.get("routing")
    sessions = summary.get("sessions")
    print(f"Serve: {summary['completed']}/{summary['requests']} ok, shed={summary['shed']}, "
          f"breaker_trips={summary['breaker_trips']}, reloads={summary['reloads']}, "
          f"p50={summary['latency_p50_ms']}ms p99={summary['latency_p99_ms']}ms, "
          f"compiled_shapes={summary['compiled_shapes']}"
          + (f", replicas={routing['replicas']} policy={routing['policy']} "
             f"spills={routing['spills']}" if routing else "")
          + (f", sessions={sessions['completed']}/{sessions['started']} complete "
             f"(migrated={sessions.get('migrated', 0)}, "
             f"lost={sessions.get('lost', sessions.get('failed', 0))}), "
             f"step_p50={sessions['step_latency_p50_ms']}ms" if sessions else ""))
    summary.update(warmed_buckets=warmed, warmup_s=warm_s, device=str(device),
                   restored=restored)
    if pack_plan is not None:
        summary["pack_plan"] = dataclasses.asdict(pack_plan)
    return ServeRun(summary, results, samples, model, pack_plan, metrics)


def _run_serve_federated(args, sc: ServeConfig, model: GNOT, samples: list[MeshSample],
                         device: torch.device, restored: str, *, sink=None,
                         manifest: RunManifest | None = None) -> ServeRun:
    """``--serve --hosts N``: the federation (``serve/federation.py``,
    ``gnot_tpu/main.py::_run_serve_federated``). The ``--serve_replicas``
    replicas, all on the run's card, each on its own stream, split evenly
    into N loopback hosts, each a ``ReplicaRouter`` behind a ``HostAgent``;
    a ``ClusterRouter`` drives the storm through the wire protocol
    (in-proc links, or loopback TCP from ``--federation_port``) while a
    control-loop thread ticks the failure detector every
    ``--heartbeat_interval_s``. One fault injector serves every hook
    level (link, agent, local router), so a single-fire fault fires once.
    ``--session_dir`` is the shared ``SessionStore`` every host persists
    each due snapshot to (the re-migration substrate); with
    ``--metrics_path`` each host gets a ``MetricsRegistry`` and the cluster
    writes the merged per-host series to ``<stem>.series.jsonl``;
    ``--trace_path`` gets the merged cluster trace (the controller's and
    every host's spans, rebased by the heartbeat clock offsets) at drain,
    and ``--flight_recorder_s`` a ring per host and one for the controller
    (which watches the lock guard), dumped on trigger edges. Every replica
    is warmed before traffic; the drain, the agents' stop and the links'
    close run on every exit path. Returns the ``ServeRun`` with the
    cluster summary."""
    import threading

    from gnot_tpu_torch.obs import dtrace
    from gnot_tpu_torch.serve.federation import build_local_federation

    per = sc.replicas // sc.hosts  # divisibility is config-checked
    replicas = build_replicas(model, sc.replicas, batch_size=sc.max_batch, dtype=sc.dtype)
    groups = [replicas[i * per:(i + 1) * per] for i in range(sc.hosts)]
    # The migration substrate: a survivor resumes a dead host's sessions
    # from snapshots persisted here; without it, restart from zero.
    session_store = SessionStore(sc.session_dir) if sc.session_dir else None
    series_path = None
    if args.metrics_path:
        series_path = f"{os.path.splitext(args.metrics_path)[0]}.series.jsonl"
    metrics_factory = (metrics_lib.MetricsRegistry
                       if sc.metrics_interval_s > 0 or series_path else None)
    fi = FaultInjector.from_spec(sc.inject_fault)
    host_ids = [f"host{i}" for i in range(sc.hosts)]
    chaos = {h: fi for h in host_ids} if fi is not None else None
    # The sampling decision lives in the cluster's tracer; the hosts' only
    # adopt it from the wire.
    cluster_tracer = None
    tracer_factory = None
    recorders = None
    if sc.flight_recorder_s > 0:
        flight_dir = (os.path.dirname(args.trace_path)
                      or os.path.dirname(args.metrics_path) or ".")
        recorders = {h: dtrace.FlightRecorder(flight_dir, window_s=sc.flight_recorder_s, host=h)
                     for h in ["controller", *host_ids]}
        # The controller's ring is the cluster's black box: host_dead fires
        # there, and the lock-guard hook is process-wide.
        recorders["controller"].watch_lockguard()
    if args.trace_path or recorders is not None:
        # Without --trace_path nothing is exported: rate 0, and the rings
        # still fill with shadow spans.
        rate = args.trace_sample_rate if args.trace_path else 0.0

        def tracer_factory(host_id):
            return Tracer(sample_rate=rate, recorder=(recorders or {}).get(host_id))

        cluster_tracer = tracer_factory("controller")
    cluster, agents = build_local_federation(
        groups,
        sink=sink,
        suspect_after_s=sc.suspect_after_s,
        dead_after_s=sc.dead_after_s,
        session_store=session_store,
        link_faults=None if sc.federation_port else chaos,
        host_faults=chaos,
        series_path=series_path,
        metrics_factory=metrics_factory,
        tcp_base_port=sc.federation_port,
        tracer_factory=tracer_factory,
        cluster_tracer=cluster_tracer,
        trace_path=args.trace_path or None,
        recorders=recorders,
        router_kwargs=dict(
            max_batch=sc.max_batch,
            max_wait_ms=sc.max_wait_ms,
            queue_limit=sc.queue_limit,
            default_deadline_ms=sc.deadline_ms,
            breaker_threshold=sc.breaker_threshold,
            breaker_cooldown_s=sc.breaker_cooldown_s,
            session_snapshot_every=sc.session_snapshot_every,
            route_policy=sc.route_policy,
            faults=fi,
        ),
    )
    rollout_k = sc.rollout_steps
    futures = []
    with PreemptionHandler() as preempt:
        t0 = time.monotonic()
        # Every bucket dispatched on every replica before traffic.
        warmed = sum(r.warm(samples, rows=sc.max_batch) for r in replicas)
        warm_s = time.monotonic() - t0
        for a in agents.values():
            a.router.start()
        stop = threading.Event()

        def _control_loop():
            while not stop.is_set():
                cluster.tick()
                stop.wait(sc.heartbeat_interval_s)

        ticker = threading.Thread(target=_control_loop, name="fed-control", daemon=True)
        ticker.start()
        try:
            for s in samples:
                if preempt.triggered:
                    break
                futures.append(cluster.submit_rollout(s, rollout_k) if rollout_k
                               else cluster.submit(s))
            session_timeout = sc.drain_timeout_s * max(1, rollout_k)
            results = [f.result(timeout=session_timeout) for f in futures]
        finally:
            stop.set()
            ticker.join(timeout=5)
            summary = cluster.drain(sc.drain_timeout_s)
            local: dict[str, dict] = {}
            for host_id, a in agents.items():
                a.stop()
                if host_id not in summary["per_host"]:
                    # A host the cluster could not drain (killed, or dead
                    # behind a partition) still runs its pool: drained here,
                    # so none of its workers outlives the run.
                    local[host_id] = a.drain_local(sc.drain_timeout_s)
            cluster.close()
    print(
        f"Federated serve: {sc.hosts} hosts x {per} replicas "
        f"({'tcp' if sc.federation_port else 'in-proc'}), "
        f"{summary['completed']}/{summary['requests']} ok, "
        f"shed={summary['shed']}, sessions={summary['sessions']} "
        f"(remigrated={summary['remigrated']}, lost={summary['lost']}), "
        f"hosts_dead={summary['hosts_dead']}, "
        f"protocol_errors={summary['protocol_errors']}"
    )
    if args.trace_path and cluster.merged_trace is not None:
        print(
            f"Wrote merged cluster trace "
            f"({len(cluster.merged_trace['traceEvents'])} spans, "
            f"{len(cluster.merged_trace['otherData']['hosts'])} sources) "
            f"to {args.trace_path} (open in https://ui.perfetto.dev; "
            "summarize with tools/trace_report.py)"
        )
    if recorders is not None:
        dumps = [p for r in recorders.values() for p in r.dumps]
        if dumps:
            print(f"Flight recorder dumped {len(dumps)} ring(s): " + ", ".join(dumps))
    if manifest is not None:
        manifest.write(federation={k: v for k, v in summary.items() if k != "per_host"})
    # Beside the cluster's keys: the warm-up, and the pool summaries of the
    # hosts drained here rather than over the wire.
    summary.update(warmed_buckets=warmed, warmup_s=warm_s, device=str(device),
                   restored=restored, drained_locally=local)
    return ServeRun(summary, results, samples, model)


def _serve_storm(args, sc: ServeConfig, server: InferenceServer | ReplicaRouter, samples,
                 checkpointer, preempt, controller=None
                 ) -> tuple[dict, list[ServeResult | RolloutResult]]:
    """Drive the in-process request storm through a started server (or
    router: its reload rolls across the replicas) and
    drain it (``gnot_tpu/main.py::_serve_storm``): submitting stops once a
    SIGTERM has arrived; each sample is one request, or with
    ``--serve_rollout_steps K`` one K-step session; every
    ``--serve_reload_every`` submissions the checkpoint is hot-reloaded
    under the deadline; each future is waited for up to
    ``drain_timeout_s`` (times K for a session), and the drain gets
    ``drain_timeout_s``. The autoscale ``controller`` (when elastic) is
    closed between the last result and the drain, so no scale action races
    the final rollup. Returns ``(summary, results)``; the drain runs on
    every exit path."""
    futures = []
    rollout_k = sc.rollout_steps
    try:
        for i, s in enumerate(samples):
            if preempt.triggered:
                break
            futures.append(server.submit_rollout(s, rollout_k) if rollout_k
                           else server.submit(s))
            if (args.serve_reload_every and checkpointer is not None
                    and (i + 1) % args.serve_reload_every == 0):
                server.reload(deadline_ms=sc.deadline_ms)
        timeout = sc.drain_timeout_s * max(1, rollout_k)
        results = [f.result(timeout=timeout) for f in futures]
        if controller is not None:
            controller.close()
    finally:
        summary = server.drain(sc.drain_timeout_s)
    return summary, results


def run_train(args, *, sink=None, tracer=None, manifest: RunManifest | None = None,
              registry=None) -> Trainer:
    """Training (no ``--serve``): load the splits, build the trainer on
    the chosen device with weights from ``--seed``, fit (or with
    ``--eval_only`` evaluate the best checkpoint), then export and
    predict as asked (``gnot_tpu/main.py``). Returns the trainer: its
    ``best_metric`` (with ``--eval_only``, the metric just evaluated),
    ``history`` and model. The trainer writes its records to ``sink``
    and its spans to ``tracer`` when given, and its telemetry drain's
    step times into ``registry``, which with ``--metrics_path`` a
    ``MetricsPublisher`` streams every ``--metrics_interval_s`` while it
    fits (no SLO evaluator: the objectives are serving ones)."""
    device = run_device(args)
    cfg = train_config(args)
    train_samples, test_samples = datasets.load(cfg.data)
    mc = model_config(args, train_samples)
    # Predict and export want the whole test split (the same on every rank).
    full_test_samples = test_samples
    if args.distributed and multihost.node_count() > 1:
        cfg, train_samples, test_samples = _node_shard(cfg, train_samples, test_samples)
    # The trainer gives the checkpointer its fault injector and the sink.
    checkpointer = (
        Checkpointer(cfg.train.checkpoint_dir, extra_meta=checkpoint_meta(args, mc))
        if cfg.train.checkpoint_dir else None
    )
    trainer = Trainer(cfg, mc, train_samples, test_samples, checkpointer=checkpointer,
                      device=device, metrics_sink=sink, tracer=tracer, metrics_registry=registry)
    if manifest is not None:
        # Before any step: a run that dies keeps its provenance.
        manifest.write(config=cfg, model_config=mc, device=device, mesh=trainer.mesh,
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
        if registry is not None and args.metrics_path:
            stem = os.path.splitext(args.metrics_path)[0]
            publisher = metrics_lib.MetricsPublisher(
                registry, interval_s=args.metrics_interval_s, sink=sink,
                series_path=f"{stem}.series.jsonl", exposition_path=f"{stem}.prom",
            ).start()
            try:
                trainer.fit()
            finally:
                publisher.close()
            if manifest is not None:
                manifest.write(metrics=publisher.stats())
        else:
            trainer.fit()
    if (args.export_torch or args.predict_out) and not args.eval_only:
        # The artifacts of the reported best metric, not of the last epoch.
        if checkpointer is not None:
            trainer.restore_best()
        else:
            print("note: no --checkpoint_dir, so export/predict artifacts "
                  "use the FINAL-epoch weights, not the reported best")
    # On a mesh the gather and the forward are every rank's; rank 0 writes.
    writer = multihost.process_index() == 0
    if args.export_torch:
        params = trainer.standard_params()
        if writer:
            torch.save(interop.reference_state_dict(params, mc), args.export_torch)
            print(f"Exported torch state_dict to {args.export_torch}")
    if args.predict_out:
        preds = trainer.predict(full_test_samples)
        if writer:
            datasets.save_pickle(
                [dataclasses.replace(s, y=p) for s, p in zip(full_test_samples, preds)],
                args.predict_out,
            )
            print(f"Wrote {len(preds)} predictions to {args.predict_out}")
    return trainer


def _node_shard(cfg: Config, train_samples, test_samples):
    """A multi-node launch: every node keeps its strided shard of each
    split (``multihost.shard_samples``), padded to the lengths of the whole
    dataset so every rank's batches have one shape
    (``gnot_tpu/main.py:828-856``)."""
    from gnot_tpu_torch.data.batch import fixed_pad_lengths

    p = multihost.node_count()
    for name, n in (("n_train", len(train_samples)), ("n_test", len(test_samples))):
        if n % p:
            raise ValueError(
                f"{name}={n} must be divisible by the {p} processes "
                "(every host must run the same number of steps)"
            )
    pn, pf = fixed_pad_lengths(list(train_samples) + list(test_samples), bucket=cfg.data.bucket)
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, pad_nodes=pn, pad_funcs=pf))
    return cfg, multihost.shard_samples(train_samples), multihost.shard_samples(test_samples)


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
    # The serve section is validated in both modes, as JAX's config is.
    _, sc = configs_from_args(args)
    with contextlib.ExitStack() as stack:
        if args.distributed:
            if args.device_id >= 0:
                parser.error("--device_id pins a single device; drop --distributed")
            if args.serve:
                raise NotPortedError(
                    "--serve with --distributed: serving over a trainer's mesh "
                    "(gnot_tpu/main.py:1093-1115) is not ported; serve without it"
                )
            # Without a card this raises before any rank waits on another.
            resolve_device(args.device)
            if not torch.distributed.is_initialized():
                # A group the caller made is the caller's to end.
                multihost.initialize(run_device(args))
                stack.callback(multihost.shutdown)
        # Rank 0 alone writes the records, the trace and run.json.
        writer = multihost.process_index() == 0
        # One registry for the run (the live metrics plane): the server's
        # series when serving, the telemetry drain's when training.
        registry = (metrics_lib.MetricsRegistry()
                    if sc.metrics_interval_s > 0 and writer else None)
        sink = (stack.enter_context(MetricsSink(args.metrics_path))
                if args.metrics_path and writer else None)
        tracer = None
        # A federated serve writes the merged cluster trace itself.
        if args.trace_path and writer and not (args.serve and args.hosts > 1):
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
        if args.metrics_path and writer:
            manifest = RunManifest(args, argv)
            stack.callback(lambda: manifest.path and manifest.write())
        if not args.serve:
            return run_train(args, sink=sink, tracer=tracer, manifest=manifest,
                             registry=registry)
        result = run_serve(args, sink=sink, tracer=tracer, manifest=manifest,
                           registry=registry)
    print(json.dumps({"serve_summary": result.summary}))
    return result


def main(argv: list[str] | None = None) -> float:
    """Trains (or evaluates) and returns the best (or evaluated) test
    metric, or with ``--serve`` serves and returns the share of requests
    answered (of sessions completed, with ``--serve_rollout_steps``)."""
    result = run(argv)
    if isinstance(result, Trainer):
        return result.best_metric
    if result.summary.get("sessions") is not None:
        return sum(r.ok for r in result.results) / max(1, len(result.results))
    return result.summary["completed"] / max(1, result.summary["requests"])


if __name__ == "__main__":
    main()
