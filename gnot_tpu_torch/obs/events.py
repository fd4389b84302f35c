"""The registry of the port's ``MetricsSink`` event kinds and tracer spans.

A copy of the part of ``gnot_tpu/obs/events.py`` the port emits, with the
same kind names, the same required ``fields`` and declared ``optional``
tuples, and the same span names, so a record or a trace file written by
the port reads as one the JAX package wrote (its ``validate_record``
accepts it). ``module=`` names the port's file that emits each kind.

Kinds not here wait for the port modules that emit them (``ROADMAP.md``).
``recompile`` in particular has no meaning without a jit trace cache and
is never emitted (``obs/health.py``); nor is the serve span ``compile``.

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
SERVE_SUMMARY = "serve_summary"
TRACE_FLUSH = "trace_flush"


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
        doc="a request was rejected at admission (reason + per-reason "
        "detail)",
        optional=(
            "trace_id", "trace_ids", "replica", "session", "step",
            "tenant",
        ),
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
    "trace_flush": EventSpec(
        fields=("path", "spans", "dropped"),
        module="gnot_tpu_torch/obs/tracing.py",
        doc="the span tracer wrote its Chrome trace-event JSON file",
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
