"""The registry of the port's ``MetricsSink`` event kinds and tracer spans.

A copy of the part of ``gnot_tpu/obs/events.py`` the port emits, with the
same kind names, the same required ``fields`` and declared ``optional``
tuples, and the same span names, so a record or a trace file written by
the port reads as one the JAX package wrote (its ``validate_record``
accepts it). ``module=`` names the port's file that emits each kind.

The registries differ by two kinds: ``aot_prewarm`` has no emitter
(eager PyTorch has no executable to serialize), and ``recompile`` has no
meaning without a jit trace cache and is never emitted
(``obs/health.py``); nor is the serve span ``compile``. ``host_skew`` is
emitted by the multi-process trainer (``train/trainer.py``) and
``native_packer`` by every serve run (``main.py``), as in the JAX package.

Emit sites use the module constants (``events.SHED``), never fresh
string literals. Stdlib only.
"""

from __future__ import annotations

import dataclasses

SLOW_STEP = "slow_step"
NON_FINITE_LOSS = "non_finite_loss"
ROLLBACK = "rollback"
BATCH_QUARANTINED = "batch_quarantined"
RECOVERY_RESTORE = "recovery_restore"
PREEMPT_SAVE = "preempt_save"
RESTORE = "restore"
RESTORE_FALLBACK = "restore_fallback"
IO_RETRY = "io_retry"
QUEUE_DEPTH = "queue_depth"
SHED = "shed"
BREAKER_OPEN = "breaker_open"
BREAKER_CLOSE = "breaker_close"
DRAIN_TIMEOUT = "drain_timeout"
RELOAD = "reload"
SERVE_SUMMARY = "serve_summary"
TRACE_FLUSH = "trace_flush"
METRICS_SNAPSHOT = "metrics_snapshot"
SLO_ALERT = "slo_alert"
ROLLOUT_STEP = "rollout_step"
SESSION_SNAPSHOT = "session_snapshot"
TENANT_QUOTA_SHED = "tenant_quota_shed"
ROUTE = "route"
REPLICA_HEALTH = "replica_health"
ROLLING_RELOAD = "rolling_reload"
REPLICA_WARM = "replica_warm"
NATIVE_PACKER = "native_packer"
SESSION_MIGRATE = "session_migrate"
REPLICA_REMOVE = "replica_remove"
PROGRAM_CATALOG = "program_catalog"
CAPACITY_SNAPSHOT = "capacity_snapshot"
AUTOSCALE_DECISION = "autoscale_decision"
SCALE_UP = "scale_up"
SCALE_DOWN = "scale_down"
REPLICA_REPLACE = "replica_replace"
HOST_SKEW = "host_skew"
HOST_HEARTBEAT = "host_heartbeat"
HOST_DEAD = "host_dead"
SESSION_REMIGRATE = "session_remigrate"
CLUSTER_SUMMARY = "cluster_summary"


@dataclasses.dataclass(frozen=True)
class EventSpec:
    """One event kind: the payload keys every record must carry (extra
    keys are always allowed), the keys present only when the emitting
    feature is on, the port module that emits it, and a one-line
    description."""

    fields: tuple[str, ...]
    module: str
    doc: str
    optional: tuple[str, ...] = ()


#: kind -> spec; ``fields`` and ``optional`` are the JAX registry's.
EVENTS: dict[str, EventSpec] = {
    "slow_step": EventSpec(
        fields=("step", "epoch", "step_time_s", "median_s", "slowdown"),
        module="gnot_tpu_torch/obs/telemetry.py",
        doc="dispatch interval exceeded 3x the rolling median",
        optional=("span_id",),
    ),
    "non_finite_loss": EventSpec(
        fields=("step", "epoch", "loss", "detail"),
        module="gnot_tpu_torch/train/trainer.py",
        doc="NaN watchdog abort; `detail` names the first module whose "
        "output was non-finite in a re-run of the batch",
    ),
    "host_skew": EventSpec(
        fields=("epoch", "step_time_per_host", "skew_s"),
        module="gnot_tpu_torch/train/trainer.py",
        doc="per-host epoch step-time gauge of multi-process training "
        "(registered ahead of the port's multi-process trainer)",
    ),
    "rollback": EventSpec(
        fields=("epoch", "step", "to_step", "rollbacks_used"),
        module="gnot_tpu_torch/train/trainer.py",
        doc="recovery rolled back to the last-good snapshot",
    ),
    "batch_quarantined": EventSpec(
        fields=("epoch", "step", "ordinal"),
        module="gnot_tpu_torch/train/trainer.py",
        doc="the offending dispatch is skipped on replay",
    ),
    "recovery_restore": EventSpec(
        fields=("epoch", "step", "restored_epoch", "restored_from"),
        module="gnot_tpu_torch/train/trainer.py",
        doc="rollback budget exhausted; restored from checkpoint",
    ),
    "preempt_save": EventSpec(
        fields=("epoch", "step", "resumable"),
        module="gnot_tpu_torch/train/trainer.py",
        doc="graceful SIGTERM/SIGINT stop saved `latest`",
    ),
    "restore": EventSpec(
        fields=(
            "requested", "name", "dir", "epoch", "best_metric", "fallback",
            "skipped",
        ),
        module="gnot_tpu_torch/train/checkpoint.py",
        doc="clean (sidecar-named) checkpoint restore",
    ),
    "restore_fallback": EventSpec(
        fields=(
            "requested", "name", "dir", "epoch", "best_metric", "fallback",
            "skipped",
        ),
        module="gnot_tpu_torch/train/checkpoint.py",
        doc="restore walked past corrupt/missing candidates",
    ),
    "io_retry": EventSpec(
        fields=("op", "attempt", "error"),
        module="gnot_tpu_torch/train/checkpoint.py",
        doc="transient checkpoint-I/O failure retried with backoff",
    ),
    "queue_depth": EventSpec(
        fields=("depth", "batched", "dispatch", "bucket_nodes",
                "bucket_funcs", "n", "packed", "real_tokens",
                "capacity_tokens"),
        module="gnot_tpu_torch/serve/server.py",
        doc="one serving dispatch (depth at flush, its bucket, and the "
        "dispatch's real-vs-capacity node tokens; `packed` marks a "
        "pack_plan dispatch)",
        optional=("trace_ids", "replica"),
    ),
    "shed": EventSpec(
        fields=("reason",),
        module="gnot_tpu_torch/serve/server.py",
        doc="a request was shed or rejected (reason + per-reason detail; "
        "a rollout session's carries its `session`, a tagged request's "
        "its `tenant`)",
        optional=(
            "trace_id", "trace_ids", "replica", "session", "step",
            "tenant",
        ),
    ),
    "tenant_quota_shed": EventSpec(
        fields=("tenant", "quota", "in_system"),
        module="gnot_tpu_torch/serve/server.py",
        doc="a request or rollout step fast-failed at its tenant's "
        "admission quota (reason `shed_tenant_quota`); a rollout step's "
        "record carries its `session`, and the session ends",
        optional=("trace_id", "replica", "session"),
    ),
    "breaker_open": EventSpec(
        fields=("state", "reason", "detail", "trips"),
        module="gnot_tpu_torch/serve/server.py",
        doc="circuit breaker tripped open (backend unhealthy)",
        optional=("trace_id", "replica"),
    ),
    "breaker_close": EventSpec(
        fields=("state",),
        module="gnot_tpu_torch/serve/server.py",
        doc="half-open trial succeeded; breaker closed",
        optional=("replica",),
    ),
    "drain_timeout": EventSpec(
        fields=("timeout_s",),
        module="gnot_tpu_torch/serve/server.py",
        doc="graceful drain exceeded its budget (wedged dispatch)",
        optional=("replica",),
    ),
    "reload": EventSpec(
        fields=("ok", "reload", "duration_ms"),
        module="gnot_tpu_torch/serve/server.py",
        doc="hot weight reload (+ restore provenance when ok)",
        optional=("trace_id", "replica"),
    ),
    "serve_summary": EventSpec(
        fields=(
            "requests", "admitted", "completed", "shed", "dispatches",
            "reloads", "breaker_trips", "compiled_shapes",
            "latency_p50_ms", "latency_p99_ms",
        ),
        module="gnot_tpu_torch/serve/server.py",
        doc="end-of-serve rollup emitted on drain; `dtype` names the "
        "serving compute dtype",
        optional=(
            "queue_device_by_bucket", "pad_waste_by_bucket", "replica",
            "per_replica", "routing", "dtype", "sessions", "tenants",
            "trace",
        ),
    ),
    "rollout_step": EventSpec(
        fields=("session", "step", "steps", "latency_ms"),
        module="gnot_tpu_torch/serve/server.py",
        doc="one committed step of a rollout session (1-indexed `step` of "
        "`steps`; the carry advanced and the step streamed)",
        optional=("replica", "dispatch"),
    ),
    "session_snapshot": EventSpec(
        fields=("session", "step"),
        module="gnot_tpu_torch/serve/server.py",
        doc="a rollout session's carry was snapshotted host-side (every "
        "`session_snapshot_every` steps, and once more when it ends "
        "early); `persisted` marks one written to the session store",
        optional=("replica", "persisted"),
    ),
    "route": EventSpec(
        fields=("replica", "bucket", "policy", "reason", "depth"),
        module="gnot_tpu_torch/serve/router.py",
        doc="one placement decision: which replica got the request and "
        "why (affinity | cold_assign | spill | least_loaded | "
        "round_robin | pool_full | no_healthy); `dtype` is the pool's "
        "serving compute dtype; a rollout session's first-step placement "
        "carries its `session` id (later steps never re-route)",
        optional=("dtype", "session"),
    ),
    "replica_health": EventSpec(
        fields=("replica", "healthy", "reason"),
        module="gnot_tpu_torch/serve/router.py",
        doc="a replica's routability changed (ok | trial | warming | "
        "breaker_open | wedged | dead | retiring); unhealthy replicas "
        "drain to siblings instead of shedding",
    ),
    "rolling_reload": EventSpec(
        fields=("replica", "ok", "step", "n_replicas", "rollout"),
        module="gnot_tpu_torch/serve/router.py",
        doc="one step of a rolling hot reload (one replica warming at a "
        "time; a failed step keeps its old weights serving)",
    ),
    "replica_warm": EventSpec(
        fields=("replica", "source", "programs", "seconds"),
        module="gnot_tpu_torch/serve/router.py",
        doc="a replica joined the pool serve-ready: `source` 'compile' "
        "(its warm-up dispatches, JAX's name for the cold path) or 'none' "
        "(never warmed); emitted at every add_replica",
        optional=("hits", "misses", "reason"),
    ),
    "native_packer": EventSpec(
        fields=("available", "impl"),
        module="gnot_tpu_torch/main.py",
        doc="one-time serve-start record of the host packer path: `impl` "
        "'native' (the C++ packer loaded; the fused pad/cast and the "
        "batched unpad run from the recorded `*_min_bytes` bars up, the "
        "bitwise numpy version below them) or 'python' (numpy only; "
        "`error` says why), so a run's numbers name the path that made them",
        optional=("so", "error", "pack_native_min_bytes",
                  "unpad_native_min_bytes"),
    ),
    "session_migrate": EventSpec(
        fields=(
            "session", "from_replica", "to_replica", "at_step",
            "replay_from", "reason",
        ),
        module="gnot_tpu_torch/serve/router.py",
        doc="a rollout session was re-placed on a sibling replica: after "
        "its owner failed mid-rollout (`reason` names the failure; the "
        "replay starts at the `replay_from` snapshot cursor) or at a "
        "scale-in's step boundary (`scale_in`, no replay)",
    ),
    "replica_remove": EventSpec(
        fields=("replica", "reason", "requests", "completed"),
        module="gnot_tpu_torch/serve/router.py",
        doc="one replica left the pool after drain-then-remove: no new "
        "placement ('retiring'), its sessions handed to siblings at a step "
        "boundary, its queue flushed, its latency histograms kept in the "
        "pool rollup",
        optional=("pool", "sessions_migrated", "drain_timeout_s"),
    ),
    "program_catalog": EventSpec(
        fields=("key", "source"),
        module="gnot_tpu_torch/serve/catalog.py",
        doc="a program entered the catalog: `key` is the dtype-keyed "
        "program signature (JAX's), `source` its provenance ('compile', "
        "JAX's name: recorded at the program's first dispatch), `costs` "
        "the analytic count of obs/costs.py (the fields it does not count "
        "listed under `unavailable`, never 0)",
        optional=("costs", "replica"),
    ),
    "capacity_snapshot": EventSpec(
        fields=("programs", "pool"),
        module="gnot_tpu_torch/serve/catalog.py",
        doc="drain-time capacity model: per-program cost x traffic rates "
        "(device time per token, achieved FLOPs/s, useful-token fraction) "
        "and the pool rollup of sustainable tokens/s and requests/s per "
        "replica (x / device_s); retired replicas' traffic merged in",
        optional=("replica",),
    ),
    "autoscale_decision": EventSpec(
        fields=("action", "reason", "pool", "min", "max"),
        module="gnot_tpu_torch/serve/autoscaler.py",
        doc="the autoscaling controller acted or a stability guard vetoed "
        "it: `action` 'scale_up' | 'scale_down' | 'replace' | 'hold'; a "
        "'hold' names the guard (cooldown_up | cooldown_down | "
        "cooldown_heal | at_max | flap_suppressed | last_replica | "
        "batch_deferral) and is emitted on edges only; `load` is the "
        "per-replica in-system load read, `alerts` the active objectives",
        optional=("replica", "load", "alerts", "detail"),
    ),
    "scale_up": EventSpec(
        fields=("replica", "pool", "reason", "warm_source", "seconds"),
        module="gnot_tpu_torch/serve/autoscaler.py",
        doc="the controller grew the pool: a replica built on the card, "
        "warmed before it joined (`warm_source` 'compile': its warm-up "
        "dispatches) and admitted to routing; `seconds` is build + warm "
        "+ join, `reason` the signal (load | surge | below_min | "
        "slo:<objective>)",
        optional=("load",),
    ),
    "scale_down": EventSpec(
        fields=("replica", "pool", "reason"),
        module="gnot_tpu_torch/serve/autoscaler.py",
        doc="the controller shrank the pool: the named replica retired by "
        "drain-then-remove after the calm held for the configured ticks",
        optional=("load", "sessions_migrated"),
    ),
    "replica_replace": EventSpec(
        fields=("from_replica", "to_replica", "reason"),
        module="gnot_tpu_torch/serve/autoscaler.py",
        doc="self-healing: a dead, wedged or breaker-stuck replica was "
        "removed and a fresh one built and warmed on its slot under a new "
        "id (`reason` is the verdict that condemned it)",
        optional=("pool", "seconds"),
    ),
    "host_heartbeat": EventSpec(
        fields=("host", "seq", "state"),
        module="gnot_tpu_torch/serve/federation.py",
        doc="one failure-detector verdict per heartbeat round per host: "
        "`state` is 'alive' | 'suspect' | 'dead' after this round's ack or "
        "silence; `load` and `pool` the host's in-system load and replica "
        "count from its last ack, `edge` the transition this round made; "
        "`clock_offset_s` +/- `clock_err_s` the midpoint clock-alignment "
        "estimate of obs/dtrace.py (the merged trace's rebase)",
        optional=(
            "load", "pool", "rtt_ms", "edge", "clock_offset_s",
            "clock_err_s",
        ),
    ),
    "host_dead": EventSpec(
        fields=("host", "silent_s", "sessions"),
        module="gnot_tpu_torch/serve/federation.py",
        doc="the failure detector declared a host dead after the full "
        "suspicion dwell (`silent_s` of lease silence): its pending "
        "requests are re-placed on survivors and its `sessions` rollout "
        "sessions re-migrate from their persisted snapshots",
        optional=("pending", "reason"),
    ),
    "session_remigrate": EventSpec(
        fields=(
            "session", "from_host", "to_host", "at_step", "replay_from",
            "reason",
        ),
        module="gnot_tpu_torch/serve/federation.py",
        doc="a rollout session was re-placed on a surviving host after its "
        "owner died: it resumes from the `replay_from` cursor of its "
        "persisted snapshot (0: none survived, a full replay); steps the "
        "cluster already streamed are suppressed",
    ),
    "cluster_summary": EventSpec(
        fields=(
            "hosts", "requests", "completed", "shed", "sessions",
            "remigrated", "hosts_dead",
        ),
        module="gnot_tpu_torch/serve/federation.py",
        doc="the federation's rollup, once at cluster drain (beside each "
        "host's own `serve_summary`): request and session accounting, the "
        "per-host summaries (`per_host`) and the failure-detector ledger; "
        "with cluster tracing, `trace_coverage` holds each source's "
        "sampled/total counters and the clock offset its spans were "
        "rebased by",
        optional=("per_host", "lost", "protocol_errors",
                  "trace_coverage"),
    ),
    "trace_flush": EventSpec(
        fields=("path", "spans", "dropped"),
        module="gnot_tpu_torch/obs/tracing.py",
        doc="the span tracer wrote its Chrome trace-event JSON file",
    ),
    "metrics_snapshot": EventSpec(
        fields=("seq", "interval_s", "series", "pool"),
        module="gnot_tpu_torch/obs/metrics.py",
        doc="one live metrics-plane publish cycle (cadence "
        "`--metrics_interval_s`): `pool` is the serving rollup "
        "(requests/completed/shed, histogram p50/p99, queue depth); the "
        "full per-series state goes to the JSONL time series and the "
        "Prometheus exposition file",
        optional=("series_path",),
    ),
    "slo_alert": EventSpec(
        fields=(
            "objective", "kind", "state", "threshold", "burn_fast",
            "burn_slow",
        ),
        module="gnot_tpu_torch/obs/metrics.py",
        doc="an SLO objective crossed a burn-rate edge: `state` is 'fire' "
        "(burn >= 1 in both the fast and slow windows) or 'clear' (the "
        "fast window recovered); `value` carries the observed quantity",
        optional=("value", "fast_window_s", "slow_window_s", "tenant"),
    ),
}

_CONSTANT_KINDS = {
    v for k, v in vars().items() if k.isupper() and isinstance(v, str)
}
assert _CONSTANT_KINDS == set(EVENTS), (
    "obs/events.py constants and EVENTS keys drifted: "
    f"{sorted(_CONSTANT_KINDS ^ set(EVENTS))}"
)


@dataclasses.dataclass(frozen=True)
class SpanSpec:
    """One tracer span kind: the port module that records it and a
    one-line description."""

    module: str
    doc: str


#: span kind -> spec: the JAX registry's names for the spans the port
#: records. ``obs/tracing.py``'s SERVE_SPANS / TRAIN_SPANS give their order.
SPANS: dict[str, SpanSpec] = {
    "admission": SpanSpec(
        module="gnot_tpu_torch/serve/server.py",
        doc="admission decision at submit (`reason` = admitted or the "
        "reject verdict); the root of every serve request chain",
    ),
    "queue_wait": SpanSpec(
        module="gnot_tpu_torch/serve/server.py",
        doc="admission close to dispatch pop: time spent queued",
    ),
    "batch_assembly": SpanSpec(
        module="gnot_tpu_torch/serve/server.py",
        doc="pad/pack of the dispatch's batch and its copy to the device, "
        "once per traced member",
    ),
    "dispatch": SpanSpec(
        module="gnot_tpu_torch/serve/server.py",
        doc="the whole engine dispatch window (queue pop to result "
        "publishable); `member_trace_ids` links co-dispatched riders",
    ),
    "device": SpanSpec(
        module="gnot_tpu_torch/serve/server.py",
        doc="the forward and its device-to-host copy inside the dispatch",
    ),
    "unpad": SpanSpec(
        module="gnot_tpu_torch/serve/server.py",
        doc="host-side unpad of the batch outputs",
    ),
    "resolve": SpanSpec(
        module="gnot_tpu_torch/serve/server.py",
        doc="result resolution (`reason`, `latency_ms`): the chain's "
        "terminal span",
    ),
    "reload": SpanSpec(
        module="gnot_tpu_torch/serve/server.py",
        doc="hot weight reload lifecycle (aux stream `r`: never consumes "
        "a request sampling slot)",
    ),
    "replica_warm": SpanSpec(
        module="gnot_tpu_torch/serve/router.py",
        doc="one replica's warm-to-serve-ready window (its warm-up "
        "dispatches; aux stream `r`), recorded when it joins the pool",
    ),
    "placement": SpanSpec(
        module="gnot_tpu_torch/serve/federation.py",
        doc="one controller-to-host placement frame of a cluster request "
        "or session (`host`, `kind` = place | hedge | redeliver | "
        "remigrate | reconcile | restart; all but the first carry "
        "`link_to`, the first placement's span id: linked spans of one "
        "trace, never a second chain)",
    ),
    "cluster_request": SpanSpec(
        module="gnot_tpu_torch/serve/federation.py",
        doc="one one-shot's whole cluster lifecycle, submit to resolution "
        "(`reason`; recorded at resolve on the controller)",
    ),
    "cluster_rollout": SpanSpec(
        module="gnot_tpu_torch/serve/federation.py",
        doc="one rollout session's whole cluster lifecycle, first placement "
        "to resolution (`reason`, `migrations`)",
    ),
    "epoch": SpanSpec(
        module="gnot_tpu_torch/train/trainer.py",
        doc="one training epoch: the root of each train trace",
    ),
    "data_iter": SpanSpec(
        module="gnot_tpu_torch/train/trainer.py",
        doc="one batch pull from the loader",
    ),
    "step": SpanSpec(
        module="gnot_tpu_torch/train/trainer.py",
        doc="one optimizer step, or one K-step group (host view)",
    ),
    "host_to_device": SpanSpec(
        module="gnot_tpu_torch/train/trainer.py",
        doc="the step's batch copy to the device",
    ),
    "step_dispatch": SpanSpec(
        module="gnot_tpu_torch/train/trainer.py",
        doc="the step's forward, backward and update, enqueued",
    ),
    "telemetry_drain": SpanSpec(
        module="gnot_tpu_torch/train/trainer.py",
        doc="end-of-epoch telemetry queue drain",
    ),
    "eval": SpanSpec(
        module="gnot_tpu_torch/train/trainer.py",
        doc="held-out evaluation pass",
    ),
    "checkpoint_save": SpanSpec(
        module="gnot_tpu_torch/train/trainer.py",
        doc="checkpoint write (`which` = best | latest)",
    ),
}


def validate_record(record: dict) -> list[str]:
    """Missing-field / unknown-kind problems for one sink record (empty
    list = valid). Records without an ``event`` key (step and epoch
    metrics) always validate."""
    kind = record.get("event")
    if kind is None:
        return []
    spec = EVENTS.get(kind)
    if spec is None:
        return [f"unknown event kind {kind!r}"]
    return [
        f"event {kind!r} missing required field {f!r}"
        for f in spec.fields
        if f not in record
    ]
