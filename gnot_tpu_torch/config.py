"""Configuration dataclasses of the port.

``ModelConfig`` mirrors ``gnot_tpu/config.py::ModelConfig`` field for
field, with the same defaults and the same refusals. ``OptimConfig``
mirrors its namesake; ``DataConfig``, ``TrainConfig`` and ``ServeConfig``
keep only the fields ``datasets.load``, the loaders, the single-device
trainer, its observability plane and the serving path read.
``NotPortedError`` is the refusal for a value that selects a part of the
JAX package the port does not have yet. ``parse_tenant_spec`` is JAX's
grammar of the three tenant flags, kept here (as JAX keeps it in its
config) so ``ServeConfig`` validates them without the serving package.
"""

from __future__ import annotations

import dataclasses

from gnot_tpu_torch.models.precision import SERVE_DTYPES


class NotPortedError(ValueError):
    """A configuration value that selects a part of ``gnot_tpu`` the port
    does not have yet. ``PreemptionHandler.should_stop(multiprocess=True)``
    raises it (the multi-host stop agreement waits for multi-process
    training); ``EngineReplica.prewarm_from``, ``--serve_prewarm`` and the
    federation's ``ClusterRouter(manifests=...)`` /
    ``build_local_federation(manifests=...)`` raise it for snapshot
    hydration (eager PyTorch has no compiled executable to serialize; a
    ``HostAgent`` answers a ``prewarm`` frame with an ``error`` frame)."""


def parse_tenant_spec(spec: str, *, what: str = "value") -> dict[str, str]:
    """Parse a ``tenant:value,tenant:value`` spec (the grammar of
    ``--tenant_weights`` / ``--tenant_quotas`` / ``--tenant_priorities``)
    into an ordered ``{tenant: raw value}`` dict. The empty string parses
    to an empty dict; a malformed entry or a duplicate tenant raises, with
    ``gnot_tpu/config.py::parse_tenant_spec``'s messages."""
    out: dict[str, str] = {}
    for entry in filter(None, (e.strip() for e in spec.split(","))):
        name, sep, value = entry.partition(":")
        name, value = name.strip(), value.strip()
        if not sep or not name or not value:
            raise ValueError(
                f"malformed tenant {what} entry {entry!r}; expected "
                "'tenant:value,tenant:value'"
            )
        if name in out:
            raise ValueError(f"duplicate tenant {name!r} in {what} spec")
        out[name] = value
    return out


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """GNOT architecture hyperparameters (reference main.py:16-22)."""

    input_dim: int = 2
    theta_dim: int = 1
    input_func_dim: int = 1
    out_dim: int = 1
    n_input_functions: int = 1
    n_attn_layers: int = 4
    n_attn_hidden_dim: int = 256
    n_mlp_num_layers: int = 4
    n_mlp_hidden_dim: int = 256
    n_input_hidden_dim: int = 256
    n_expert: int = 3
    n_head: int = 8
    # "parity": unmasked padding, pollution-faithful to the reference
    # (masks dropped, the interleaved head merge, erf GELU).
    # "masked": correct masking; results independent of pad lengths.
    attention_mode: str = "masked"
    # "xla" is the only attention impl: the fused attention kernel lost
    # the A/B against the einsum path and its model dispatch was
    # retired. The name is kept so configs read the same in both
    # packages; here "xla" means the plain torch einsum path.
    attention_impl: str = "xla"
    # "xla": batched-matmul expert FFN in plain torch. "pallas": the
    # fused gated-FFN kernel (ops/fused_ffn.py, csrc/fused_gated_ffn.cu).
    ffn_impl: str = "xla"
    # GELU flavor for every MLP: "erf" (torch nn.GELU default, the
    # reference's op) or "tanh". "" resolves to "erf" in parity mode
    # and "tanh" otherwise.
    gelu: str = ""
    # Compute dtype of the block stack: "float32", or "bfloat16" (bf16
    # training on f32 master weights, or bf16 serving of a cast copy:
    # models/precision.py). Weights stay float32 at rest.
    dtype: str = "float32"
    # Recompute each block's activations in the backward (nn.remat).
    remat: bool = False
    # The stacked-layer layout: the block weights stacked on a leading
    # layer axis and one block module applied per layer
    # (parallel/pipeline.py). Read by the trainer; the model class
    # builds the standard layout either way, as in the JAX package.
    scan_layers: bool = False

    def __post_init__(self) -> None:
        if self.n_attn_hidden_dim % self.n_head:
            raise ValueError("n_attn_hidden_dim must be divisible by n_head")
        if self.attention_mode not in ("parity", "masked"):
            raise ValueError(f"unknown attention_mode {self.attention_mode!r}")
        if not self.gelu:
            object.__setattr__(
                self,
                "gelu",
                "erf" if self.attention_mode == "parity" else "tanh",
            )
        if self.gelu not in ("erf", "tanh"):
            raise ValueError(f"unknown gelu {self.gelu!r}")
        if self.dtype not in SERVE_DTYPES:
            raise ValueError(f"unknown dtype {self.dtype!r}; one of {SERVE_DTYPES}")
        if self.attention_mode == "parity" and self.gelu != "erf":
            raise ValueError(
                "parity mode reproduces the reference bit-for-bit and "
                "requires gelu='erf' (torch nn.GELU); tanh-GELU is the "
                "masked-mode TPU default"
            )
        if self.attention_impl == "pallas":
            raise ValueError(
                "attention_impl='pallas' was retired in round 4: the "
                "fused kernel measured slower than the XLA einsum path "
                "at every scale under honest timing (docs/performance.md"
                " 'Why the fused attention kernel lost'). The kernels "
                "remain in ops/pallas_attention.py for research use."
            )
        if self.attention_impl != "xla":
            raise ValueError(f"unknown attention_impl {self.attention_impl!r}")
        if self.ffn_impl not in ("xla", "pallas"):
            raise ValueError(f"unknown ffn_impl {self.ffn_impl!r}")
        if self.scan_layers and (
            self.attention_impl != "xla" or self.ffn_impl != "xla"
        ):
            raise ValueError("scan_layers requires the xla attention/ffn impls")


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    """AdamW + OneCycle regime (reference main.py:50-52)."""

    lr: float = 1e-3
    # torch.optim.AdamW defaults, set explicitly as the JAX package does.
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.01
    # OneCycleLR defaults (torch): cos anneal, 3-phase off.
    pct_start: float = 0.3
    div_factor: float = 25.0
    final_div_factor: float = 1e4
    # The reference sizes OneCycleLR in steps but steps it once per
    # EPOCH (main.py:52,106), so the LR never leaves the warm-up ramp.
    # True reproduces that; False steps the schedule per update.
    parity_schedule_bug: bool = True
    grad_clip_norm: float = 0.0  # 0 = off (reference has no clipping)
    # Gradient accumulation (optax.MultiSteps): the running mean of k
    # micro-batch gradients makes one AdamW update (clipped first when
    # grad_clip_norm > 0), so the effective batch is k x batch_size at
    # the memory of one. Windows straddle epoch boundaries and a
    # trailing partial window is never applied.
    grad_accum: int = 1
    # Flat parameter layout: every weight, and every gradient, is a view
    # into one f32 buffer (each leaf at a multiple of 4 elements, zero
    # padding between), so AdamW updates one tensor instead of one per
    # weight. Same math. Composes with neither scan_layers nor packed.
    flat_params: bool = False

    def __post_init__(self) -> None:
        if self.grad_accum < 1:
            raise ValueError(f"grad_accum must be >= 1, got {self.grad_accum}")


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """The data fields ``datasets.load``, the ``Loader``, the
    ``PackedLoader`` and the serving path read (``gnot_tpu`` DataConfig)."""

    train_path: str = ""
    test_path: str = ""
    synthetic: str = "ns2d"  # darcy2d | ns2d | elasticity | inductor2d | heatsink3d
    # Size knob of the synthetic generator (0 = its default): grid side
    # for darcy2d (points = size^2), mesh points for the others.
    synth_size: int = 0
    n_train: int = 64
    n_test: int = 16
    batch_size: int = 4
    shuffle_train: bool = True
    seed: int = 0
    # Pad ragged lengths up to the next bucket boundary; False pads to
    # the per-batch max, as the reference does.
    bucket: bool = True
    drop_remainder: bool = False
    # Fixed pad lengths (0 = per-batch).
    pad_nodes: int = 0
    pad_funcs: int = 0
    # "Pack, don't pad": several samples share each sequence row as
    # chunk-aligned contiguous segments, with attention and losses kept
    # exactly per sample through segment Grams
    # (ops.attention.packed_normalized_linear_attention). Recovers the
    # tokens bucket padding wastes on ragged meshes. Masked mode only.
    # pack_chunk is the segment alignment in tokens.
    packed: bool = False
    pack_chunk: int = 128

    def __post_init__(self) -> None:
        if self.packed and self.pack_chunk < 1:
            raise ValueError(f"pack_chunk must be >= 1, got {self.pack_chunk}")


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """The single-device training loop's fields (``gnot_tpu`` TrainConfig),
    with its resilience fields and their checks."""

    epochs: int = 100  # reference main.py:23
    loss: str = "rel_l2"  # the reference trains AND evals on rel-L2
    checkpoint_dir: str = ""
    resume: bool = False
    checkpoint_every: int = 0  # epochs; 0 = best-only (reference behavior)
    # K train (and eval) steps per dispatch: K same-shape host batches
    # stacked in pinned memory, one host-to-device copy, the K steps run
    # with no host read between them. Identical to K single steps.
    steps_per_dispatch: int = 1
    log_every: int = 0  # steps; 0 = per-epoch only
    metrics_path: str = ""  # JSONL sink; "" = console only
    # Telemetry and health monitors (obs/): grad / param / update norms,
    # per-layer gate load and entropy, and padding waste, computed on the
    # device in each step and fetched once per log_every steps; plus the
    # slow-step gauge and the NaN watchdog. Off by default: the extra
    # reductions are extra kernels in every step.
    telemetry: bool = False
    profile_dir: str = ""  # torch.profiler trace of one epoch
    # Host-side span tracing (obs/tracing.py): per-step phase spans when
    # training, request-lifecycle spans when serving, written as Chrome
    # trace-event JSON to trace_path. "" = no tracer is built.
    trace_path: str = ""
    # Head-sampling rate in [0, 1], decided once per trace (an epoch when
    # training, a request when serving) by a counter, not an RNG.
    trace_sample_rate: float = 1.0
    # Debug guard: every step's loss is read on the host, and the first
    # non-finite one raises NonFiniteLossError (a FloatingPointError) at
    # that step; with recovery on, the ladder takes it. One sync a step.
    debug_checks: bool = False
    # Fault injection: stop cleanly after this many epochs (0 = off), as
    # if preempted; the schedule stays sized by `epochs`, so a resumed run
    # continues the same regime. An alias of ``stop_epoch@N``.
    stop_after_epoch: int = 0
    # Deterministic fault injection (resilience/faults.py): comma-separated
    # ``kind@N`` entries (nan_grad@step, bad_sample@step, sigterm@step,
    # ckpt_io@count, corrupt_ckpt@epoch, stop_epoch@epochs). "" = none.
    inject_fault: str = ""
    # Automatic NaN recovery (resilience/supervisor.py): a rolling
    # last-good snapshot of the train state on the device every
    # `snapshot_every` steps; a non-finite loss rolls back to it,
    # quarantines the dispatch and goes on, escalating to a checkpoint
    # restore after `max_rollbacks`, then to the hard abort. Off by
    # default: recovery changes the trajectory (skipped batches).
    recovery: bool = False
    snapshot_every: int = 50  # steps between last-good snapshots
    max_rollbacks: int = 3  # rollback budget before escalating
    # Graceful preemption (resilience/preemption.py): SIGTERM / SIGINT stop
    # the run at the next step boundary, save `latest` (with a
    # checkpointer), flush the sink and exit resume-ready.
    # `preempt_sync_every` is the multi-host agreement's cadence; one
    # process reads its own flag at every boundary.
    graceful_preempt: bool = True
    preempt_sync_every: int = 1
    seed: int = 0

    def __post_init__(self) -> None:
        if self.loss not in ("rel_l2", "mse"):
            raise ValueError(f"unknown loss {self.loss!r}")
        if self.steps_per_dispatch < 1:
            raise ValueError(
                f"steps_per_dispatch must be >= 1, got {self.steps_per_dispatch}"
            )
        if self.snapshot_every < 1:
            raise ValueError(
                f"snapshot_every must be >= 1, got {self.snapshot_every}"
            )
        if self.max_rollbacks < 0:
            raise ValueError(
                f"max_rollbacks must be >= 0, got {self.max_rollbacks}"
            )
        if self.preempt_sync_every < 1:
            raise ValueError(
                f"preempt_sync_every must be >= 1, got {self.preempt_sync_every}"
            )
        if not 0.0 <= self.trace_sample_rate <= 1.0:
            raise ValueError(
                f"trace_sample_rate must be in [0, 1], got "
                f"{self.trace_sample_rate}"
            )


@dataclasses.dataclass(frozen=True)
class Config:
    """What one training run reads (``gnot_tpu`` Config without the mesh
    and serving sections)."""

    optim: OptimConfig = dataclasses.field(default_factory=OptimConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)


def refuse_compositions(config: Config, model_cfg: ModelConfig) -> None:
    """The training options that do not compose, refused with the JAX
    trainer's messages in its order (``gnot_tpu/train/trainer.py``)."""
    if config.data.packed:
        if model_cfg.attention_mode == "parity":
            raise ValueError(
                "packed mode requires attention_mode='masked' (parity "
                "reproduces the reference's per-batch padding pollution, "
                "which has no packed equivalent)"
            )
        if model_cfg.scan_layers:
            raise ValueError("packed + scan_layers not composed yet; pick one")
        if config.optim.flat_params:
            raise ValueError("packed + flat_params not composed yet; pick one")
    if config.optim.flat_params and model_cfg.scan_layers:
        raise ValueError(
            "flat_params and scan_layers both re-lay-out the params (flat "
            "buffer vs stacked blocks) and do not compose; pick one"
        )


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """The serving policies the port implements (``gnot_tpu`` ServeConfig)."""

    # A bucket's queue flushes at max_batch requests or when its oldest
    # request has waited max_wait_ms; every dispatch is padded to
    # max_batch rows, so each bucket has one dispatch shape.
    max_batch: int = 4
    max_wait_ms: float = 10.0
    # At most queue_limit requests in the system; beyond it submissions
    # fast-fail ("shed_queue_full").
    queue_limit: int = 64
    # Default per-request deadline (ms; 0 = none): an expired request is
    # shed before dispatch, and the budget clamps a reload's retries.
    deadline_ms: float = 0.0
    # Circuit breaker: open after breaker_threshold consecutive failed
    # dispatches (non-finite outputs, device errors); while open, requests
    # are rejected at once; after breaker_cooldown_s one half-open trial.
    breaker_threshold: int = 3
    breaker_cooldown_s: float = 1.0
    # How long drain() (and the storm, per request) waits for in-flight
    # requests.
    drain_timeout_s: float = 30.0
    # Serve-side fault injection (resilience/faults.py): slow_request@N,
    # nan_output@N, reload_corrupt@N. "" = none.
    inject_fault: str = ""
    # Serving compute dtype (models/precision.py): "float32", or
    # "bfloat16" (the block stack in bf16 with f32 accumulation, an f32
    # attention normalizer and an f32 output head; the engine publishes
    # a bf16 copy of the f32 weights).
    dtype: str = "float32"
    # Packed dispatch ("pack, don't pad"): requests that fit the plan
    # (data/batch.py::PackPlan, derived from the traffic) are first-fit
    # packed as chunk-aligned segments into one fixed dispatch shape
    # instead of one padded row each; the rest take the per-bucket
    # padded path. pack_chunk is the segment alignment, a multiple of 8.
    packed: bool = False
    pack_chunk: int = 64
    # The live metrics plane (obs/metrics.py): with metrics_interval_s > 0
    # a MetricsPublisher snapshots the registry every interval
    # (metrics_snapshot events, <stem>.series.jsonl, <stem>.prom) and an
    # SLOEvaluator turns the history into slo_alert fire / clear edges.
    # 0 = off.
    metrics_interval_s: float = 0.0
    # The SLO objectives, over a fast and a slow burn-rate window (both
    # must burn to fire; the fast window clearing clears). slo_p99_ms 0
    # turns the latency objective off, slo_shed_frac 0 the shed one.
    slo_p99_ms: float = 0.0
    slo_shed_frac: float = 0.05
    slo_fast_window_s: float = 5.0
    slo_slow_window_s: float = 30.0
    # Rollout serving (serve/rollout.py): with rollout_steps K > 0 the
    # --serve entry point drives each test sample as one K-step session,
    # K chained dispatches whose carry stays on the server between steps
    # (deadline_ms applies per step); 0 = one-shot serving.
    rollout_steps: int = 0
    # Steps between a session's host-side carry snapshots (1 = every step).
    session_snapshot_every: int = 1
    # With a directory, every named session drained mid-rollout persists
    # its final snapshot there (rollout.SessionStore), and a restarted
    # server resumes it from that step (resume_rollout). "" = off.
    session_dir: str = ""
    # Tenants (serve/policies.py::TenantPolicy), each a "tenant:value,..."
    # spec; any non-empty spec turns tenant mode on (per-tenant WFQ
    # sub-queues, quotas, priority tiers, tenant_* series and SLOs), all
    # empty is the single-tenant path. Weights are integer deficit-round-
    # robin shares >= 1 within a tier (unlisted: 1); quotas bound a
    # tenant's in-system requests (beyond: "shed_tenant_quota"; unlisted:
    # none); priorities are "interactive" or "batch" (unlisted:
    # interactive, but for a tenant named "batch").
    tenant_weights: str = ""
    tenant_quotas: str = ""
    tenant_priorities: str = ""
    # Replicated serving (serve/router.py, serve/replica.py): N engine
    # replicas behind the router, each with its own engine, weights copy,
    # worker, admission, batcher and breaker (and on the card its own CUDA
    # stream: the replicas share the one card). 1 = the single server.
    replicas: int = 1
    # The router's placement policy: "affinity" (prefer the replica that
    # has served the request's bucket), "least_loaded" or "round_robin".
    route_policy: str = "affinity"
    # Seconds of worker-loop silence, with requests in its system, before
    # the router reads a replica as wedged and routes around it.
    wedge_after_s: float = 2.0
    # Self-healing elastic serving (serve/autoscaler.py): with autoscale
    # on, an AutoscaleController reads the metrics plane (the registry's
    # load gauges; the SLO evaluator's alerts when metrics_interval_s > 0)
    # and scales the router's pool between autoscale_min and
    # autoscale_max: warm-before-join scale-out on high per-replica load
    # (in-system requests + resident sessions) or a pressure alert,
    # drain-then-remove scale-in after autoscale_down_ticks calm ticks,
    # and replacement of dead, wedged or breaker-stuck replicas. Guards:
    # per-direction cooldowns, up/down hysteresis (up_load > down_load)
    # and no scale-in within three cooldowns of a scale-out. Every slot is
    # the one card.
    autoscale: bool = False
    autoscale_min: int = 1
    autoscale_max: int = 4
    autoscale_interval_s: float = 0.5
    autoscale_cooldown_s: float = 2.0
    autoscale_up_load: float = 8.0
    autoscale_down_load: float = 1.0
    autoscale_down_ticks: int = 3
    autoscale_heal_after_s: float = 5.0
    # The federation (serve/federation.py): hosts > 1 splits the replica
    # pool evenly into `hosts` ReplicaRouter pools, each behind a HostAgent,
    # and serves through a ClusterRouter over the versioned wire protocol
    # (lease heartbeats, suspicion-then-dead detection, session
    # re-migration); 1 is the single-host path. federation_port 0 uses
    # in-proc links, a port >= 1024 real loopback TCP (host i on port + i).
    # heartbeat_interval_s is the control loop's tick; suspect_after_s and
    # dead_after_s are the detector's lease ages (the gap is the dwell).
    hosts: int = 1
    federation_port: int = 0
    heartbeat_interval_s: float = 0.5
    suspect_after_s: float = 2.0
    dead_after_s: float = 6.0
    # The flight recorder (obs/dtrace.py): the last N seconds of every span
    # and event, sampled or not, in a bounded ring per host, dumped on
    # trigger edges (slo_alert fire, breaker_open, host_dead,
    # non_finite_loss, a lockguard inversion). 0 = off.
    flight_recorder_s: float = 0.0

    def __post_init__(self) -> None:
        if self.max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {self.max_batch}")
        if self.replicas < 1:
            raise ValueError(f"replicas must be >= 1, got {self.replicas}")
        if self.route_policy not in ("affinity", "least_loaded", "round_robin"):
            raise ValueError(
                f"unknown route_policy {self.route_policy!r}; one of "
                "('affinity', 'least_loaded', 'round_robin')"
            )
        if self.wedge_after_s <= 0:
            raise ValueError(
                f"wedge_after_s must be > 0, got {self.wedge_after_s}"
            )
        if self.max_wait_ms < 0:
            raise ValueError(
                f"max_wait_ms must be >= 0, got {self.max_wait_ms}"
            )
        if self.queue_limit < 1:
            raise ValueError(
                f"queue_limit must be >= 1, got {self.queue_limit}"
            )
        if self.dtype not in SERVE_DTYPES:
            raise ValueError(f"unknown serve dtype {self.dtype!r}; one of {SERVE_DTYPES}")
        if self.pack_chunk < 8 or self.pack_chunk % 8:
            raise ValueError(
                f"pack_chunk must be a positive multiple of 8, got {self.pack_chunk}"
            )
        if self.breaker_threshold < 1:
            raise ValueError(
                f"breaker_threshold must be >= 1, got {self.breaker_threshold}"
            )
        if self.rollout_steps < 0:
            raise ValueError(
                f"rollout_steps must be >= 0, got {self.rollout_steps}"
            )
        if self.session_snapshot_every < 1:
            raise ValueError(
                "session_snapshot_every must be >= 1, got "
                f"{self.session_snapshot_every}"
            )
        if self.metrics_interval_s < 0:
            raise ValueError(
                f"metrics_interval_s must be >= 0, got "
                f"{self.metrics_interval_s}"
            )
        if self.slo_p99_ms < 0:
            raise ValueError(
                f"slo_p99_ms must be >= 0, got {self.slo_p99_ms}"
            )
        if not 0.0 <= self.slo_shed_frac <= 1.0:
            raise ValueError(
                f"slo_shed_frac must be in [0, 1], got {self.slo_shed_frac}"
            )
        if not 0 < self.slo_fast_window_s <= self.slo_slow_window_s:
            raise ValueError(
                "need 0 < slo_fast_window_s <= slo_slow_window_s, got "
                f"{self.slo_fast_window_s}/{self.slo_slow_window_s}"
            )
        if not 1 <= self.autoscale_min <= self.autoscale_max:
            raise ValueError(
                "need 1 <= autoscale_min <= autoscale_max, got "
                f"{self.autoscale_min}/{self.autoscale_max}"
            )
        if self.autoscale and not (
            self.autoscale_min <= self.replicas <= self.autoscale_max
        ):
            raise ValueError(
                f"--autoscale needs the founding pool size (replicas="
                f"{self.replicas}) within [autoscale_min, autoscale_max]"
                f" = [{self.autoscale_min}, {self.autoscale_max}]"
            )
        if self.autoscale_interval_s <= 0:
            raise ValueError(
                "autoscale_interval_s must be > 0, got "
                f"{self.autoscale_interval_s}"
            )
        if self.autoscale_cooldown_s < 0:
            raise ValueError(
                "autoscale_cooldown_s must be >= 0, got "
                f"{self.autoscale_cooldown_s}"
            )
        if not 0 <= self.autoscale_down_load < self.autoscale_up_load:
            raise ValueError(
                "autoscale hysteresis needs 0 <= down_load < up_load, "
                f"got {self.autoscale_down_load}/{self.autoscale_up_load}"
            )
        if self.autoscale_down_ticks < 1:
            raise ValueError(
                "autoscale_down_ticks must be >= 1, got "
                f"{self.autoscale_down_ticks}"
            )
        if self.autoscale_heal_after_s <= 0:
            raise ValueError(
                "autoscale_heal_after_s must be > 0, got "
                f"{self.autoscale_heal_after_s}"
            )
        if self.hosts < 1:
            raise ValueError(f"hosts must be >= 1, got {self.hosts}")
        if self.hosts > 1 and self.replicas % self.hosts:
            raise ValueError(
                f"replicas ({self.replicas}) must divide evenly across "
                f"hosts ({self.hosts}) — every host pool is identically "
                "sized so the topology key is well-defined"
            )
        if self.federation_port and not 1024 <= self.federation_port <= 65535:
            raise ValueError(
                "federation_port must be 0 (in-proc) or in [1024, 65535], "
                f"got {self.federation_port}"
            )
        if self.heartbeat_interval_s <= 0:
            raise ValueError(
                "heartbeat_interval_s must be > 0, got "
                f"{self.heartbeat_interval_s}"
            )
        if not 0 < self.suspect_after_s < self.dead_after_s:
            raise ValueError(
                "failure detector needs 0 < suspect_after_s < "
                "dead_after_s (the suspicion dwell), got "
                f"{self.suspect_after_s}/{self.dead_after_s}"
            )
        if self.flight_recorder_s < 0:
            raise ValueError(
                "flight_recorder_s must be >= 0 (0 = off), got "
                f"{self.flight_recorder_s}"
            )
        if self.hosts > 1 and self.autoscale:
            raise ValueError(
                "--autoscale is single-host (the pool-level controller); "
                "with hosts > 1 use the cluster's scale plane "
                "(ClusterRouter.scale / autoscale_target)"
            )
        for t, w in parse_tenant_spec(self.tenant_weights, what="weight").items():
            if not w.isdigit() or int(w) < 1:
                raise ValueError(
                    f"tenant weight for {t!r} must be an integer >= 1, got {w!r}"
                )
        for t, q in parse_tenant_spec(self.tenant_quotas, what="quota").items():
            if not q.isdigit() or int(q) < 1:
                raise ValueError(
                    f"tenant quota for {t!r} must be an integer >= 1, got {q!r}"
                )
        for t, p in parse_tenant_spec(self.tenant_priorities, what="priority").items():
            if p not in ("interactive", "batch"):
                raise ValueError(
                    f"tenant priority for {t!r} must be 'interactive' or "
                    f"'batch', got {p!r}"
                )
