"""What the per-layer readers (``metrics/<name>.py``) share.

Each function takes the run's context (the cell's driver fills it) and
returns the metric, or None when the run holds nothing to read it from:
then the metric is left out of the result line, never given as 0.
"""

from __future__ import annotations

import re
import statistics

from benchmark import costs

FFN_SYMBOL = "fused_gated_ffn"
_STEP = re.compile(r"^bench\.step\.(\d+)$")


def _dtype(ctx) -> str:
    return ctx["config"]["model"]["dtype"]


def idle_pct(ctx, kind: str):
    data = ctx.get("trace")
    if ctx["kind"] != kind or data is None or data.wall_s <= 0:
        return None
    return 100.0 * (1.0 - data.busy_s / data.wall_s)


def mfu_pct(ctx, kind: str):
    """The model's products over the real points, over their time in the
    window (before a traced run's profiled slice), over the peak; a
    training step counts three forwards."""
    if ctx["kind"] != kind or not ctx.get("forward_flops_real"):
        return None
    flops = ctx["forward_flops_real"] * (3 if kind == "train" else 1)
    return 100.0 * flops / ctx["rate_s"] / costs.PEAKS[_dtype(ctx)]["flops"]


def pad_waste_pct(ctx, kind: str):
    if ctx["kind"] != kind:
        return None
    if kind == "train":
        real, padded = ctx["real_points"], ctx["padded_points"]
    else:
        buckets = ctx["summary"].get("pad_waste_by_bucket") or {}
        real = sum(b["real_tokens"] for b in buckets.values())
        padded = sum(b["capacity_tokens"] for b in buckets.values())
    return 100.0 * (1.0 - real / padded) if padded else None


def _step_rows(ctx) -> list[tuple[float, float, int]]:
    """``(start, end, FFN rows)`` on the trace's clock of each host
    interval whose FFN launches share one row count: a training step, or
    the forward of a serving dispatch."""
    data = ctx["trace"]
    if ctx["kind"] == "train":
        out = []
        for name, a, b in data.annotations:
            m = _STEP.match(name)
            if m:
                out.append((a, b, ctx["step_rows"][int(m.group(1))]))
        return out
    rows = ctx["traffic"]["max_batch"]
    out = []
    for s in ctx["spans"]:
        if s.name == "device" and s.args and "bucket" in s.args:
            nodes = int(str(s.args["bucket"]).split("x")[0])
            out.append((data.at(s.start), data.at(s.end), rows * nodes))
    return out


def ffn_roofline_pct(ctx, kind: str):
    """The FFN kernel's least time for the rows of each of its records in
    the slice, over the records' device time."""
    data = ctx.get("trace")
    if ctx["kind"] != kind or data is None:
        return None
    records = data.kernels(FFN_SYMBOL)
    intervals = _step_rows(ctx)
    same = {r for *_, r in intervals}
    least = spent = 0.0
    for start, end, _name, _cat, corr in records:
        launched = data.launches.get(corr)
        rows = None
        if launched is not None:
            rows = next((r for a, b, r in intervals if a <= launched <= b), None)
        if rows is None and len(same) == 1:
            rows = next(iter(same))
        if rows is None:
            continue
        flops, nbytes = costs.ffn_kernel_cost(ctx["config"]["model"], rows, _dtype(ctx))
        least += costs.least_seconds(flops, nbytes, _dtype(ctx))
        spent += (end - start) / 1e6
    return 100.0 * least / spent if spent else None


def launches_per(ctx, kind: str):
    """Kernel-launch calls on the host in the slice, per step or per
    dispatch."""
    data = ctx.get("trace")
    if ctx["kind"] != kind or data is None:
        return None
    units = len(ctx["slice_steps"]) if kind == "train" else ctx["slice_dispatches"]
    return data.launch_calls / units if units else None


def queue_ms_p50(ctx):
    """The median of the server's ``queue_wait`` spans that ended in the
    window."""
    end = ctx.get("window_end")
    waits = [s.duration_ms for s in ctx.get("spans", ())
             if s.name == "queue_wait" and s.end <= end]
    return statistics.median(waits) if waits else None
