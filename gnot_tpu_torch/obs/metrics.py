"""The live metrics plane: windowed histograms, streaming snapshots and
burn-rate SLO alerts for the serving tier and the training loop.

A copy of ``gnot_tpu/obs/metrics.py`` with the port's ``obs/events``: the
same bucket bounds, the same percentile rule, the same snapshot rows,
exposition text and SLO edges, so the same observations give the same
numbers in both packages. Three pieces:

* ``MetricsRegistry``: a thread-safe registry of named series, monotonic
  ``Counter``s, ``Gauge``s (set, or a callable polled at snapshot time)
  and log-bucketed ``LogHistogram``s with fixed bounds: O(1) memory per
  series, and a lossless merge (bucket counts add exactly).
* ``MetricsPublisher``: polls the registry on an injectable clock every
  ``interval_s``; each snapshot is one appended JSONL row, an atomic
  rewrite of a Prometheus-text file (tmp + rename) and a
  ``metrics_snapshot`` event through the ``MetricsSink``. ``tick()`` is
  the synchronous core; ``start()`` runs it on a daemon thread and
  ``close()`` always takes a final tick.
* ``SLOEvaluator``: declared objectives (p99 latency, shed fraction,
  breaker and wedge state, queue depth, session loss) over a fast and a
  slow burn-rate window of the snapshot history. An alert fires when the
  burn reaches 1.0 in both windows and clears when the fast window
  recovers: ``slo_alert`` events are edges, never levels.

Percentile estimates: bounds are log-spaced at ``BUCKETS_PER_DECADE`` per
decade (growth factor ``g = 10^(1/20)``); an estimate is the geometric
midpoint of the bucket holding the nearest-rank observation, clamped to
the observed ``[min, max]``, so its relative error is at most
``sqrt(g) - 1`` (``REL_ERROR``, ~5.9%). Stdlib only.
"""

from __future__ import annotations

import bisect
import json
import math
import os
import random
import threading
import time
from typing import Callable, Iterable, Sequence

from gnot_tpu_torch.obs import events

#: Log-bucket resolution: buckets per decade of the value axis. 20 per
#: decade over [1e-2, 1e6] ms spans 10 us .. ~17 min of latency in 160
#: buckets (+ underflow/overflow) — O(1) memory per series.
BUCKETS_PER_DECADE = 20

#: Worst-case relative error of a percentile estimate (geometric
#: midpoint of a bucket whose edges are a factor g = 10^(1/20) apart):
#: sqrt(g) - 1 ~= 5.9%. The documented agreement tolerance between the
#: live snapshots and the drain-time serve_summary.
REL_ERROR = 10.0 ** (1.0 / (2 * BUCKETS_PER_DECADE)) - 1.0

#: Bounded raw-sample retention per latency series (uniform reservoir
#: sampling): the exact-values escape hatch (``latencies_ms()``) the
#: unbounded lists used to be, at fixed memory.
RESERVOIR_SIZE = 2048


def _log_bounds(
    lo: float = 1e-2, hi: float = 1e6, per_decade: int = BUCKETS_PER_DECADE
) -> tuple[float, ...]:
    """Fixed log-spaced bucket upper bounds. Shared by every histogram
    (same bounds => lossless merge); computed once at import."""
    n = int(round(math.log10(hi / lo) * per_decade))
    return tuple(lo * 10.0 ** (i / per_decade) for i in range(n + 1))


#: THE default bucket bounds (milliseconds). Every latency series in
#: the package uses these, so any two histograms merge losslessly.
DEFAULT_BOUNDS = _log_bounds()


class LogHistogram:
    """Fixed-bound log-bucketed histogram: O(len(bounds)) memory
    forever, lossless ``merge``, and percentile estimates within
    ``REL_ERROR`` of the exact nearest-rank value.

    Thread-safe (internal lock): the serve worker records while the
    publisher thread snapshots. Values <= bounds[0] land in the
    underflow bucket 0; values > bounds[-1] in the overflow bucket
    (estimated at the observed max, which is tracked exactly).
    """

    __slots__ = ("bounds", "_counts", "_n", "_sum", "_min", "_max", "_lock")

    def __init__(self, bounds: Sequence[float] = DEFAULT_BOUNDS):
        self.bounds = tuple(bounds)
        if len(self.bounds) < 2 or any(
            b <= a for a, b in zip(self.bounds, self.bounds[1:])
        ):
            raise ValueError("histogram bounds must be increasing, len >= 2")
        # counts[i] observes bounds[i-1] < v <= bounds[i]; counts[0] is
        # the underflow bucket, counts[len(bounds)] the overflow.
        self._counts = [0] * (len(self.bounds) + 1)
        self._n = 0
        self._sum = 0.0
        self._min = math.inf
        self._max = -math.inf
        self._lock = threading.Lock()

    def record(self, value: float) -> None:
        v = float(value)
        idx = bisect.bisect_left(self.bounds, v)
        with self._lock:
            self._counts[idx] += 1
            self._n += 1
            self._sum += v
            if v < self._min:
                self._min = v
            if v > self._max:
                self._max = v

    # -- read side ---------------------------------------------------------

    @property
    def count(self) -> int:
        with self._lock:
            return self._n

    @property
    def total(self) -> float:
        with self._lock:
            return self._sum

    def copy(self) -> "LogHistogram":
        """Point-in-time copy (the merge/aggregation input)."""
        out = LogHistogram(self.bounds)
        with self._lock:
            out._counts = list(self._counts)
            out._n = self._n
            out._sum = self._sum
            out._min = self._min
            out._max = self._max
        return out

    def merge(self, other: "LogHistogram") -> "LogHistogram":
        """Add ``other``'s observations into this histogram — LOSSLESS
        (bucket counts add exactly; only estimation error is bucket
        width, identical before and after the merge). Bounds must be
        identical by construction (every series uses DEFAULT_BOUNDS)."""
        if other.bounds != self.bounds:
            raise ValueError("cannot merge histograms with different bounds")
        o = other.copy()
        with self._lock:
            for i, c in enumerate(o._counts):
                self._counts[i] += c
            self._n += o._n
            self._sum += o._sum
            self._min = min(self._min, o._min)
            self._max = max(self._max, o._max)
        return self

    def percentile(self, q: float) -> float | None:
        """Nearest-rank percentile ESTIMATE: the geometric midpoint of
        the bucket holding rank ``ceil(q * n)``, clamped to the
        observed [min, max] — relative error <= REL_ERROR. None when
        empty."""
        if not 0.0 < q <= 1.0:
            raise ValueError(f"q must be in (0, 1], got {q}")
        with self._lock:
            if self._n == 0:
                return None
            rank = max(1, math.ceil(q * self._n))
            acc = 0
            idx = len(self._counts) - 1
            for i, c in enumerate(self._counts):
                acc += c
                if acc >= rank:
                    idx = i
                    break
            est = self._bucket_mid(idx)
            return min(max(est, self._min), self._max)

    def _bucket_mid(self, idx: int) -> float:
        b = self.bounds
        if idx == 0:  # underflow: at most the lowest bound
            return b[0]
        if idx >= len(b):  # overflow: clamped to observed max by caller
            return self._max
        return math.sqrt(b[idx - 1] * b[idx])

    def state(self) -> dict:
        """JSON-ready snapshot: count/sum/min/max plus the SPARSE
        nonzero bucket counts (index -> count; bounds are implied by
        DEFAULT_BOUNDS — the time-series file stays compact)."""
        with self._lock:
            return {
                "count": self._n,
                "sum": round(self._sum, 6),
                "min": self._min if self._n else None,
                "max": self._max if self._n else None,
                "buckets": {
                    str(i): c for i, c in enumerate(self._counts) if c
                },
            }

    @classmethod
    def from_state(
        cls, state: dict, bounds: Sequence[float] = DEFAULT_BOUNDS
    ) -> "LogHistogram":
        """Rebuild a histogram from a ``state()`` dict (the time-series
        reader's path back to percentiles: windowed p50/p99 come from
        JSONL row deltas this way)."""
        out = cls(bounds)
        for i, c in (state.get("buckets") or {}).items():
            out._counts[int(i)] = int(c)
        out._n = int(state.get("count", 0))
        out._sum = float(state.get("sum", 0.0))
        out._min = state["min"] if state.get("min") is not None else math.inf
        out._max = state["max"] if state.get("max") is not None else -math.inf
        return out

    @classmethod
    def delta(cls, now: dict, then: dict | None) -> "LogHistogram":
        """The WINDOWED histogram between two cumulative ``state()``
        snapshots: bucket-wise subtraction (exact — cumulative counts
        are monotone). ``then=None`` means "since the start". min/max
        degrade to the cumulative ones (they are not windowable), so
        windowed percentile clamps stay conservative."""
        out = cls.from_state(now)
        if then is None:
            return out
        for i, c in (then.get("buckets") or {}).items():
            out._counts[int(i)] -= int(c)
        out._n -= int(then.get("count", 0))
        out._sum -= float(then.get("sum", 0.0))
        return out


class Reservoir:
    """Bounded uniform sample of a stream (Vitter's algorithm R) — the
    raw-values retention that replaces the unbounded per-request lists:
    exact for populations <= ``size``, a uniform sample beyond. The RNG
    is seeded, so runs are replayable. Thread-safe."""

    __slots__ = ("size", "_values", "_seen", "_rng", "_lock")

    def __init__(self, size: int = RESERVOIR_SIZE, seed: int = 0):
        if size < 1:
            raise ValueError(f"reservoir size must be >= 1, got {size}")
        self.size = size
        self._values: list[float] = []
        self._seen = 0
        self._rng = random.Random(seed)
        self._lock = threading.Lock()

    def add(self, value: float) -> None:
        with self._lock:
            self._seen += 1
            if len(self._values) < self.size:
                self._values.append(float(value))
                return
            j = self._rng.randrange(self._seen)
            if j < self.size:
                self._values[j] = float(value)

    @property
    def seen(self) -> int:
        with self._lock:
            return self._seen

    def values(self) -> list[float]:
        with self._lock:
            return list(self._values)


class Counter:
    """Monotonic counter. Thread-safe."""

    __slots__ = ("_n", "_lock")

    def __init__(self) -> None:
        self._n = 0
        self._lock = threading.Lock()

    def inc(self, n: int = 1) -> None:
        if n < 0:
            raise ValueError("counters are monotonic; inc() needs n >= 0")
        with self._lock:
            self._n += n

    @property
    def value(self) -> int:
        with self._lock:
            return self._n


class Gauge:
    """Point-in-time value: ``set()`` stores, or ``fn`` is called at
    snapshot time (queue depth, breaker state — no push site needed)."""

    __slots__ = ("_value", "_fn", "_lock")

    def __init__(self, fn: Callable[[], float] | None = None):
        self._value = 0.0
        self._fn = fn
        self._lock = threading.Lock()

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def read(self) -> float:
        if self._fn is not None:
            return float(self._fn())
        with self._lock:
            return self._value


def series_key(name: str, labels: dict | None) -> str:
    """Canonical series identity: ``name{k=v,...}`` with sorted label
    keys (the Prometheus spelling, minus quoting)."""
    if not labels:
        return name
    inner = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
    return f"{name}{{{inner}}}"


class MetricsRegistry:
    """Thread-safe get-or-create registry of metric series.

    Series are identified by ``(name, labels)``; the first caller
    creates the series, later callers get the SAME object — the serve
    worker, the router and the publisher all see one set of counters.
    ``snapshot()`` is the publisher's poll: a JSON-ready dict of every
    series' state (gauges are read at poll time).
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._series: dict[str, tuple[str, str, dict, object]] = {}

    def _get(self, kind: str, name: str, labels: dict, make):
        key = series_key(name, labels)
        with self._lock:
            ent = self._series.get(key)
            if ent is None:
                ent = (kind, name, dict(labels), make())
                self._series[key] = ent
            elif ent[0] != kind:
                raise ValueError(
                    f"series {key!r} already registered as {ent[0]}"
                )
            return ent[3]

    def counter(self, name: str, **labels) -> Counter:
        return self._get("counter", name, labels, Counter)

    def gauge(
        self, name: str, fn: Callable[[], float] | None = None, **labels
    ) -> Gauge:
        return self._get("gauge", name, labels, lambda: Gauge(fn))

    def histogram(self, name: str, **labels) -> LogHistogram:
        return self._get("histogram", name, labels, LogHistogram)

    def snapshot(self) -> dict:
        """``{series_key: {"type", "name", "labels", ...state}}`` for
        every registered series, gauges polled NOW. Counters/histograms
        report cumulative state; windowing happens downstream by
        differencing rows (``LogHistogram.delta``)."""
        with self._lock:
            items = list(self._series.items())
        out: dict[str, dict] = {}
        for key, (kind, name, labels, obj) in items:
            row: dict = {"type": kind, "name": name, "labels": labels}
            if kind == "counter":
                row["value"] = obj.value
            elif kind == "gauge":
                row["value"] = obj.read()
            else:
                row.update(obj.state())
            out[key] = row
        return out

    def unregister_gauges(self, **labels) -> int:
        """Drop every GAUGE series whose labels include ``labels`` —
        the membership-change hook: a removed replica's callback gauges
        (depth/breaker/sessions/wedge) otherwise pin its server and
        engine (device weights included) alive forever. Counters and
        histograms are deliberately kept: they are plain accumulated
        data, and the pool's cumulative rollups must keep the retired
        replica's history. Returns the number of series dropped."""
        with self._lock:
            doomed = [
                key
                for key, (kind, _, lbls, _) in self._series.items()
                if kind == "gauge"
                and all(
                    str(lbls.get(k)) == str(v) for k, v in labels.items()
                )
            ]
            for key in doomed:
                del self._series[key]
        return len(doomed)

    def aggregate_histogram(self, name: str) -> LogHistogram:
        """Lossless merge of EVERY series named ``name`` across all
        label sets — the pool view (per-replica, per-bucket series sum
        to exactly the pool histogram)."""
        out = LogHistogram()
        with self._lock:
            objs = [
                obj
                for (kind, n, _, obj) in self._series.values()
                if kind == "histogram" and n == name
            ]
        for h in objs:
            out.merge(h)
        return out

    def aggregate_counter(self, name: str) -> int:
        with self._lock:
            objs = [
                obj
                for (kind, n, _, obj) in self._series.values()
                if kind == "counter" and n == name
            ]
        return sum(o.value for o in objs)

    def aggregate_gauge(self, name: str) -> float:
        with self._lock:
            objs = [
                obj
                for (kind, n, _, obj) in self._series.values()
                if kind == "gauge" and n == name
            ]
        return float(sum(o.read() for o in objs))


# -- snapshot-level helpers (shared by the evaluator and the report) --------


def snap_counter(snap: dict, name: str, label: str | None = None,
                 value: str | None = None) -> int:
    """Sum of every counter series named ``name`` in a snapshot row,
    optionally filtered to ``labels[label] == value``."""
    total = 0
    for row in snap.values():
        if row.get("type") != "counter" or row.get("name") != name:
            continue
        if label is not None and str(row["labels"].get(label)) != str(value):
            continue
        total += int(row["value"])
    return total


def snap_gauge(snap: dict, name: str) -> float:
    return float(
        sum(
            row["value"]
            for row in snap.values()
            if row.get("type") == "gauge" and row.get("name") == name
        )
    )


def snap_histogram(snap: dict, name: str, label: str | None = None,
                   value: str | None = None) -> LogHistogram:
    """Merged histogram of every series named ``name`` in one row,
    optionally filtered to ``labels[label] == value`` (the per-tenant
    latency read: replica-labeled sub-series of one tenant merge
    losslessly into that tenant's pool view)."""
    out = LogHistogram()
    for row in snap.values():
        if row.get("type") != "histogram" or row.get("name") != name:
            continue
        if label is not None and str(row["labels"].get(label)) != str(value):
            continue
        out.merge(LogHistogram.from_state(row))
    return out


def pool_block(snap: dict) -> dict:
    """The pool-level rollup a ``metrics_snapshot`` event carries: the
    cross-replica totals and merged-histogram percentiles — the same
    numbers ``serve_summary`` reports at drain, live."""
    hist = snap_histogram(snap, "serve_request_latency_ms")
    shed = snap_counter(snap, "serve_shed_total")
    requests = snap_counter(snap, "serve_requests_total")
    return {
        "requests": requests,
        "completed": snap_counter(snap, "serve_completed_total"),
        "shed": shed,
        "shed_frac": (shed / requests) if requests else 0.0,
        "p50_ms": hist.percentile(0.50),
        "p99_ms": hist.percentile(0.99),
        "depth": snap_gauge(snap, "serve_queue_depth"),
    }


# -- Prometheus-text exposition ---------------------------------------------


def _prom_name(name: str) -> str:
    return "".join(c if c.isalnum() or c == "_" else "_" for c in name)


def _prom_labels(labels: dict, extra: dict | None = None) -> str:
    merged = {**labels, **(extra or {})}
    if not merged:
        return ""
    inner = ",".join(
        f'{_prom_name(str(k))}="{merged[k]}"' for k in sorted(merged)
    )
    return f"{{{inner}}}"


def exposition_text(snap: dict) -> str:
    """Render one registry snapshot in the Prometheus text exposition
    format (counters/gauges as samples, histograms as cumulative
    ``_bucket{le=...}`` + ``_sum`` + ``_count`` families)."""
    by_name: dict[str, list[tuple[dict, dict]]] = {}
    types: dict[str, str] = {}
    for row in snap.values():
        by_name.setdefault(row["name"], []).append((row["labels"], row))
        types[row["name"]] = row["type"]
    lines: list[str] = []
    for name in sorted(by_name):
        kind = types[name]
        pname = _prom_name(name)
        lines.append(
            f"# TYPE {pname} "
            f"{'histogram' if kind == 'histogram' else kind}"
        )
        for labels, row in by_name[name]:
            if kind in ("counter", "gauge"):
                lines.append(f"{pname}{_prom_labels(labels)} {row['value']}")
                continue
            counts = [0] * (len(DEFAULT_BOUNDS) + 1)
            for i, c in (row.get("buckets") or {}).items():
                counts[int(i)] = int(c)
            acc = 0
            for i, bound in enumerate(DEFAULT_BOUNDS):
                acc += counts[i]
                le = _prom_labels(labels, {"le": f"{bound:.6g}"})
                lines.append(f"{pname}_bucket{le} {acc}")
            acc += counts[-1]
            le = _prom_labels(labels, {"le": "+Inf"})
            lines.append(f"{pname}_bucket{le} {acc}")
            lines.append(
                f"{pname}_sum{_prom_labels(labels)} {row.get('sum', 0.0)}"
            )
            lines.append(
                f"{pname}_count{_prom_labels(labels)} {row.get('count', 0)}"
            )
    return "\n".join(lines) + "\n"


# -- SLO evaluation ---------------------------------------------------------


#: Objective kinds the evaluator understands (the config-declared
#: vocabulary).
SLO_KINDS = (
    "p99_latency_ms",  # windowed pool p99 vs threshold (ms)
    "shed_frac",       # windowed shed/submitted fraction vs threshold
    "breaker_open",    # replicas with an open breaker vs threshold
    "wedged",          # wedged replicas vs threshold (gauge)
    "queue_depth",     # pool in-system depth vs threshold
    "session_loss",    # lost rollout sessions per window vs threshold
)


class SLOObjective:
    """One declared objective: a ``kind`` (how to read the snapshot
    history), a ``threshold`` (burn = observed / threshold), and the
    fast/slow burn windows. ``clear_frac`` is the hysteresis: an active
    alert clears when the FAST burn drops below it.

    ``tenant`` scopes the objective to ONE tenant's series
    (``tenant_latency_ms`` / ``tenant_shed_total`` filtered by the
    tenant label) instead of the pool aggregates — the attribution the
    autoscaler needs to tell "interactive is burning budget" from
    "batch is flooding" (only the latency/shed kinds are per-tenant;
    breaker/wedge/depth are pool properties)."""

    __slots__ = (
        "name", "kind", "threshold", "fast_window_s", "slow_window_s",
        "clear_frac", "tenant",
    )

    def __init__(
        self,
        name: str,
        kind: str,
        threshold: float,
        *,
        fast_window_s: float = 5.0,
        slow_window_s: float = 30.0,
        clear_frac: float = 1.0,
        tenant: str | None = None,
    ):
        if kind not in SLO_KINDS:
            raise ValueError(f"unknown SLO kind {kind!r}; one of {SLO_KINDS}")
        if threshold <= 0:
            raise ValueError(f"threshold must be > 0, got {threshold}")
        if not 0 < fast_window_s <= slow_window_s:
            raise ValueError(
                "need 0 < fast_window_s <= slow_window_s, got "
                f"{fast_window_s}/{slow_window_s}"
            )
        if tenant is not None and kind not in (
            "p99_latency_ms", "shed_frac"
        ):
            raise ValueError(
                f"SLO kind {kind!r} cannot be tenant-scoped (pool "
                "property); only p99_latency_ms/shed_frac can"
            )
        self.name = name
        self.kind = kind
        self.threshold = float(threshold)
        self.fast_window_s = float(fast_window_s)
        self.slow_window_s = float(slow_window_s)
        self.clear_frac = float(clear_frac)
        self.tenant = tenant


def default_objectives(sc) -> list[SLOObjective]:
    """The serving tier's config-declared objectives (ServeConfig):
    p99 vs ``slo_p99_ms`` (when set), shed fraction vs
    ``slo_shed_frac``, plus the always-on health objectives — open
    breakers, wedge state (via progress-age gauges is the router's
    job; here the breaker gauge), pool queue depth vs the admission
    limit, and any rollout-session loss."""
    fast, slow = sc.slo_fast_window_s, sc.slo_slow_window_s
    w = dict(fast_window_s=fast, slow_window_s=slow)
    out = []
    if sc.slo_p99_ms > 0:
        out.append(
            SLOObjective("latency_p99", "p99_latency_ms", sc.slo_p99_ms, **w)
        )
    if sc.slo_shed_frac > 0:
        out.append(
            SLOObjective("shed_fraction", "shed_frac", sc.slo_shed_frac, **w)
        )
    out.append(SLOObjective("breaker_open", "breaker_open", 1.0, **w))
    out.append(SLOObjective("replica_wedged", "wedged", 1.0, **w))
    out.append(
        SLOObjective(
            "queue_saturation", "queue_depth",
            max(1.0, 0.9 * sc.queue_limit), **w,
        )
    )
    out.append(SLOObjective("session_loss", "session_loss", 1.0, **w))
    return out


def tenant_objectives(sc, tenants: Iterable[str]) -> list[SLOObjective]:
    """Per-tenant latency/shed objectives beside the pool ones: for
    each tenant the policy names, ``latency_p99:<tenant>`` (when
    ``slo_p99_ms`` is set) and ``shed_fraction:<tenant>`` (when
    ``slo_shed_frac`` is set), each reading ONLY that tenant's series.
    Their ``slo_alert`` edges carry the tenant — the attributed
    pressure signal the autoscaler's batch-deferral veto reads."""
    fast, slow = sc.slo_fast_window_s, sc.slo_slow_window_s
    w = dict(fast_window_s=fast, slow_window_s=slow)
    out = []
    for t in tenants:
        if sc.slo_p99_ms > 0:
            out.append(
                SLOObjective(
                    f"latency_p99:{t}", "p99_latency_ms", sc.slo_p99_ms,
                    tenant=t, **w,
                )
            )
        if sc.slo_shed_frac > 0:
            out.append(
                SLOObjective(
                    f"shed_fraction:{t}", "shed_frac", sc.slo_shed_frac,
                    tenant=t, **w,
                )
            )
    return out


class SLOEvaluator:
    """Streaming burn-rate evaluation over the snapshot history.

    ``observe(t, snap)`` appends one snapshot row and returns the edge
    records to emit (possibly empty): ``state="fire"`` when an
    objective's burn first reaches 1.0 in BOTH windows, ``state=
    "clear"`` when an active alert's fast burn recovers below
    ``clear_frac``. Steady violation and steady health both return
    nothing — the event stream carries edges only.

    The history is bounded: rows older than the longest slow window
    (plus one interval of slack) are dropped.
    """

    def __init__(self, objectives: Iterable[SLOObjective]):
        self.objectives = list(objectives)
        self._history: list[tuple[float, dict]] = []
        self._active: dict[str, bool] = {}
        self._lock = threading.Lock()

    def _window_base(self, now: float, window_s: float) -> dict | None:
        """The snapshot row at (or latest before) ``now - window_s`` —
        the cumulative baseline the window delta subtracts. None when
        the history starts inside the window ("since the start")."""
        cutoff = now - window_s
        base = None
        for t, snap in self._history:
            if t <= cutoff:
                base = snap
            else:
                break
        return base

    def _burn(
        self, obj: SLOObjective, now: float, snap: dict, window_s: float
    ) -> tuple[float, float | None]:
        """(burn, observed value) for one objective over one window."""
        base = self._window_base(now, window_s)
        kind = obj.kind
        if kind == "p99_latency_ms":
            # Tenant-scoped objectives read the tenant-labeled series;
            # pool objectives read the pool aggregate, exactly as
            # before.
            if obj.tenant is not None:
                name, flt = "tenant_latency_ms", {
                    "label": "tenant", "value": obj.tenant,
                }
            else:
                name, flt = "serve_request_latency_ms", {}
            now_h = snap_histogram(snap, name, **flt).state()
            base_h = (
                snap_histogram(base, name, **flt).state()
                if base is not None
                else None
            )
            p99 = LogHistogram.delta(now_h, base_h).percentile(0.99)
            if p99 is None:
                return 0.0, None
            return p99 / obj.threshold, p99
        if kind == "shed_frac":
            if obj.tenant is not None:
                shed_name, req_name = (
                    "tenant_shed_total", "tenant_requests_total",
                )
                flt = {"label": "tenant", "value": obj.tenant}
            else:
                shed_name, req_name = (
                    "serve_shed_total", "serve_requests_total",
                )
                flt = {}
            shed = snap_counter(snap, shed_name, **flt)
            reqs = snap_counter(snap, req_name, **flt)
            if base is not None:
                shed -= snap_counter(base, shed_name, **flt)
                reqs -= snap_counter(base, req_name, **flt)
            # Sheds resolve LATER than their submissions, so a window
            # can hold sheds with few (or zero) new requests — the
            # denominator is everything that MOVED in the window, never
            # smaller than the sheds themselves (a tail-of-storm shed
            # burst must read as a breach, not divide-by-zero calm).
            moved = max(reqs, shed)
            frac = shed / moved if moved > 0 else 0.0
            return frac / obj.threshold, frac
        if kind == "session_loss":
            lost = snap_counter(snap, "rollout_sessions_lost_total")
            if base is not None:
                lost -= snap_counter(base, "rollout_sessions_lost_total")
            return lost / obj.threshold, float(lost)
        # Gauge kinds: worst (max) value observed across the window's
        # rows — a gauge is a level, not a rate.
        gauge_name = {
            "breaker_open": "serve_breaker_open",
            "wedged": "serve_wedged",
            "queue_depth": "serve_queue_depth",
        }[kind]
        cutoff = now - window_s
        vals = [
            snap_gauge(s, gauge_name)
            for t, s in self._history
            if t >= cutoff
        ]
        vals.append(snap_gauge(snap, gauge_name))
        worst = max(vals)
        return worst / obj.threshold, worst

    def observe(self, t: float, snap: dict) -> list[dict]:
        edges: list[dict] = []
        with self._lock:
            for obj in self.objectives:
                burn_fast, value = self._burn(obj, t, snap, obj.fast_window_s)
                burn_slow, _ = self._burn(obj, t, snap, obj.slow_window_s)
                active = self._active.get(obj.name, False)
                # Fire at burn >= 1.0 (REACHING the threshold is the
                # breach): the always-on unit-threshold objectives —
                # one open breaker, one wedged replica, ONE lost
                # session — burn exactly 1.0 on the single-unit events
                # they exist to catch, and a strict > would make them
                # structurally unfireable.
                if not active and burn_fast >= 1.0 and burn_slow >= 1.0:
                    self._active[obj.name] = True
                    edges.append(
                        self._edge(obj, "fire", burn_fast, burn_slow, value)
                    )
                elif active and burn_fast < obj.clear_frac:
                    self._active[obj.name] = False
                    edges.append(
                        self._edge(obj, "clear", burn_fast, burn_slow, value)
                    )
            self._history.append((t, snap))
            horizon = max(
                (o.slow_window_s for o in self.objectives), default=0.0
            )
            cutoff = t - 2 * horizon
            while len(self._history) > 2 and self._history[1][0] <= cutoff:
                # Keep one row at/behind the horizon so slow-window
                # deltas always have a baseline.
                self._history.pop(0)
        return edges

    @staticmethod
    def _edge(obj, state, burn_fast, burn_slow, value) -> dict:
        return {
            "objective": obj.name,
            "kind": obj.kind,
            "state": state,
            "threshold": obj.threshold,
            "burn_fast": round(burn_fast, 4),
            "burn_slow": round(burn_slow, 4),
            "value": value,
            "fast_window_s": obj.fast_window_s,
            "slow_window_s": obj.slow_window_s,
            # Tenant-scoped objectives attribute their edges: the
            # autoscaler's deferral-vs-scale decision reads this.
            **({"tenant": obj.tenant} if obj.tenant is not None else {}),
        }

    def active(self) -> dict[str, bool]:
        with self._lock:
            return dict(self._active)


# -- the publisher ----------------------------------------------------------


class MetricsPublisher:
    """Polls a ``MetricsRegistry`` every ``interval_s`` and publishes
    each snapshot three ways: one appended JSONL row in the time-series
    file, an atomic rewrite of the Prometheus-text exposition file, and
    a ``metrics_snapshot`` event (with the ``pool_block`` rollup)
    through the sink. An attached ``SLOEvaluator`` turns each snapshot
    into zero or more ``slo_alert`` fire/clear edges.

    ``tick()`` is the synchronous unit of work (tests call it under a
    fake clock); ``start()``/``close()`` run it on a daemon thread at
    the configured cadence. ``close()`` always takes one FINAL tick, so
    the last snapshot reflects the drained end state ``serve_summary``
    reports — ``summary_agrees`` pins the two views together.
    """

    def __init__(
        self,
        registry: MetricsRegistry,
        *,
        interval_s: float,
        sink=None,
        series_path: str = "",
        exposition_path: str = "",
        evaluator: SLOEvaluator | None = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        if interval_s <= 0:
            raise ValueError(f"interval_s must be > 0, got {interval_s}")
        self.registry = registry
        self.interval_s = float(interval_s)
        self.sink = sink
        self.series_path = series_path
        self.exposition_path = exposition_path
        self.evaluator = evaluator
        self._clock = clock
        self._seq = 0
        self._alerts = 0
        self._last: dict | None = None
        self._lock = threading.Lock()
        # Serializes WHOLE publish cycles: callers may tick() manually
        # (the smoke's guaranteed mid-storm snapshot) while the cadence
        # thread runs — concurrent cycles would interleave writes into
        # the one exposition tmp path / series handle and feed the
        # evaluator history out of time order.
        self._tick_lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._closed = False
        self._fh = None
        if series_path:
            if d := os.path.dirname(series_path):
                os.makedirs(d, exist_ok=True)
            # Line-buffered append: each snapshot is ONE write() of one
            # terminated line, so a concurrent reader never sees a torn
            # row (the same contract MetricsSink keeps).
            self._fh = open(series_path, "a", buffering=1)

    # -- synchronous core --------------------------------------------------

    def tick(self) -> dict:
        """One publish cycle: snapshot -> series row -> exposition ->
        snapshot event -> SLO edges. Returns the published row.
        Thread-safe: cycles are serialized (manual ticks interleave
        with, never tear, the cadence thread's)."""
        with self._tick_lock:
            return self._tick_locked()

    def _tick_locked(self) -> dict:
        t = self._clock()
        snap = self.registry.snapshot()
        pool = pool_block(snap)
        with self._lock:
            self._seq += 1
            seq = self._seq
        row = {
            "seq": seq,
            "t": round(t, 6),
            "ts": time.time(),
            "interval_s": self.interval_s,
            "pool": pool,
            "series": snap,
        }
        if self._fh is not None and not self._fh.closed:
            self._fh.write(json.dumps(row) + "\n")
        if self.exposition_path:
            tmp = f"{self.exposition_path}.tmp"
            with open(tmp, "w") as f:
                f.write(exposition_text(snap))
            os.replace(tmp, self.exposition_path)
        if self.sink is not None:
            self.sink.log(
                event=events.METRICS_SNAPSHOT,
                seq=seq,
                interval_s=self.interval_s,
                series=len(snap),
                pool=pool,
                **(
                    {"series_path": self.series_path}
                    if self.series_path
                    else {}
                ),
            )
        if self.evaluator is not None:
            for edge in self.evaluator.observe(t, snap):
                with self._lock:
                    self._alerts += 1
                if self.sink is not None:
                    self.sink.log(event=events.SLO_ALERT, **edge)
        with self._lock:
            self._last = row
        return row

    # -- thread lifecycle --------------------------------------------------

    def start(self) -> "MetricsPublisher":
        if self._thread is not None:
            raise RuntimeError("publisher already started")
        self._thread = threading.Thread(
            target=self._run, name="gnot-metrics-publisher", daemon=True
        )
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            self.tick()

    def close(self) -> dict:
        """Stop the thread (if any), take the FINAL snapshot, close the
        series file. Idempotent (a second close returns the final row
        without publishing again)."""
        with self._lock:
            if self._closed:
                return self._last
            self._closed = True
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=max(5.0, 2 * self.interval_s))
            self._thread = None
        row = self.tick()
        if self._fh is not None and not self._fh.closed:
            self._fh.close()
        return row

    @property
    def seq(self) -> int:
        with self._lock:
            return self._seq

    @property
    def alerts(self) -> int:
        with self._lock:
            return self._alerts

    @property
    def last(self) -> dict | None:
        with self._lock:
            return self._last

    def stats(self) -> dict:
        """The run.json ``metrics`` block."""
        with self._lock:
            return {
                "interval_s": self.interval_s,
                "snapshots": self._seq,
                "alerts": self._alerts,
                "series": len(self._last["series"]) if self._last else 0,
                "series_path": self.series_path or None,
                "exposition_path": self.exposition_path or None,
            }


def summary_agrees(
    summary: dict, snapshot_row: dict, *, rel: float = 2 * REL_ERROR
) -> list[str]:
    """Cross-check the drain-time ``serve_summary`` against the FINAL
    ``metrics_snapshot`` row: counters must match exactly (same
    increments, same sites), percentile estimates within ``rel`` (both
    views read the same histograms, so in practice they are equal; the
    tolerance covers the documented estimate error when one side is
    computed from raw values). Returns a list of mismatch descriptions
    — empty means the two views agree."""
    problems: list[str] = []
    pool = snapshot_row["pool"]

    def _check_exact(key: str, want, got) -> None:
        if want != got:
            problems.append(f"{key}: serve_summary={want} snapshot={got}")

    _check_exact("requests", summary["requests"], pool["requests"])
    _check_exact("completed", summary["completed"], pool["completed"])
    _check_exact(
        "shed", sum(summary.get("shed", {}).values()), pool["shed"]
    )
    for key, snap_key in (
        ("latency_p50_ms", "p50_ms"),
        ("latency_p99_ms", "p99_ms"),
    ):
        want, got = summary.get(key), pool.get(snap_key)
        if want is None and got is None:
            continue
        if want is None or got is None:
            problems.append(f"{key}: serve_summary={want} snapshot={got}")
            continue
        lo = min(want, got)
        if lo > 0 and abs(want - got) / lo > rel:
            problems.append(
                f"{key}: serve_summary={want} vs snapshot={got} "
                f"beyond rel {rel}"
            )
    return problems
