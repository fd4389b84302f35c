"""Program catalog: per-program costs joined with live traffic.

Port of ``gnot_tpu/serve/catalog.py``, pure Python: the same inputs give
the same dicts and events as JAX's. The serving tier dispatches a closed
set of programs, one per dtype-keyed bucket shape plus one per
``PackPlan``, and GNOT's linear attention makes each program's cost a
closed-form function of its shape. So "what can a replica sustain?"
decomposes into per-program device cost (``obs/costs.py::program_costs``,
recorded once per program at its first dispatch) times per-program
traffic (dispatch time). This module is the join.

Two ledgers, one key namespace:

* **entries**, one per program signature: the cost dict, its provenance
  (``source``; the port's engine records ``"compile"``, JAX's name, at a
  program's first dispatch) and a ``program_catalog`` event on first
  sight. Keys are JAX's program keys
  (``bucket:{nodes}x{funcs}@{rows}@{dtype}`` /
  ``packed:{rows}x{len}@{dtype}``);
* **traffic**, per (program, replica): dispatches, requests, real and
  capacity tokens, device seconds (the host time around the forward and
  the copy of its output to the host, the engine's ``device`` stamp). Fed
  by every server dispatch (padded, packed, rollout step); rows are never
  deleted, so a replica retired by scale-in keeps its history in the pool
  capacity model.

With a ``MetricsRegistry`` the join is live: per-program counters, device
time histograms (per dispatch and per token) and callback gauges of the
achieved FLOPs/s and the useful-token fraction (``program_*``).

:meth:`capacity_model` folds both ledgers into the ``serve_summary`` /
``capacity_snapshot`` export: per-program rates and the pool's
sustainable tokens/s and requests/s per replica (device seconds as the
denominator: what a replica would sustain at 100% device duty).

Thread-safety: one lock guards both ledgers; servers on worker threads
feed ``note_dispatch`` while engines record entries and the publisher's
gauge callbacks read.
"""

from __future__ import annotations

import threading

from gnot_tpu_torch.models.precision import DTYPE_TAGS
from gnot_tpu_torch.obs import events
from gnot_tpu_torch.obs.costs import unavailable_costs


def bucket_program_key(
    pad_nodes: int, pad_funcs: int, rows: int, dtype: str
) -> str:
    """The padded-bucket program key: JAX's string for the same program,
    so the two packages' catalogs key alike."""
    return f"bucket:{pad_nodes}x{pad_funcs}@{rows}@{DTYPE_TAGS[dtype]}"


def packed_program_key(plan, dtype: str) -> str:
    """The pack-plan program key (one fixed shape per plan)."""
    return f"packed:{plan.n_rows}x{plan.row_len}@{DTYPE_TAGS[dtype]}"


class ProgramCatalog:
    """Cost entries + live traffic attribution for every program the
    tier dispatches. Share ONE catalog across a deployment (engine(s),
    server(s) or router): program identity is pool-wide by
    construction — replicas dispatch the same programs."""

    def __init__(self, metrics=None, sink=None):
        self._metrics = metrics
        self._sink = sink
        self._lock = threading.Lock()
        # Program key -> {"costs": dict, "source": str}.
        self._entries: dict[str, dict] = {}  #: guarded_by _lock
        # (program key, replica) -> accumulated dispatch traffic.
        self._traffic: dict[tuple, dict] = {}  #: guarded_by _lock
        self._snapshot_emitted = False  #: guarded_by _lock
        # Registry series cache, off the note_dispatch hot path
        # (get-or-create only on first sight of a (program, replica);
        # benign races resolve to the same registry objects).
        self._series: dict[tuple, dict] = {}

    def attach_outputs(self, *, metrics=None, sink=None) -> None:
        """Late-bind the registry and/or event sink: a deployment
        harness builds and warms engines (which records entries) before
        its sink or registry exists. Entries recorded
        before a sink attached are REPLAYED into it, so the event
        stream still carries one ``program_catalog`` record per
        program regardless of wiring order."""
        backlog: list = []
        with self._lock:
            if metrics is not None:
                self._metrics = metrics
            if sink is not None and self._sink is None:
                self._sink = sink
                backlog = [
                    (k, e["source"], dict(e["costs"]))
                    for k, e in self._entries.items()
                ]
        for key, source, costs in backlog:
            sink.log(
                event=events.PROGRAM_CATALOG,
                key=key,
                source=source,
                costs=costs,
            )

    # -- entries (a program's first dispatch) -------------------------------

    def record(self, key: str, costs: dict | None, *, source: str) -> bool:
        """Record one program's cost entry. First sight wins and emits
        a ``program_catalog`` event; a later recording replaces the
        entry only when it knows strictly MORE (fewer ``unavailable``
        fields), as a full count upgrading an entry recorded with the
        ``unavailable_costs`` marker. Returns True iff the entry changed."""
        if costs is None:
            costs = unavailable_costs(f"no costs from {source}")
        with self._lock:
            prev = self._entries.get(key)
            if prev is not None:
                if len(costs.get("unavailable", ())) >= len(
                    prev["costs"].get("unavailable", ())
                ):
                    return False
            self._entries[key] = {"costs": dict(costs), "source": source}
            fresh = prev is None
        if fresh and self._sink is not None:
            self._sink.log(
                event=events.PROGRAM_CATALOG,
                key=key,
                source=source,
                costs=dict(costs),
            )
        return True

    def has(self, key: str) -> bool:
        with self._lock:
            return key in self._entries

    def get(self, key: str) -> dict | None:
        with self._lock:
            e = self._entries.get(key)
            return None if e is None else {**e, "costs": dict(e["costs"])}

    def entries(self) -> dict:
        """Snapshot of every recorded entry (key -> {costs, source})."""
        with self._lock:
            return {
                k: {**e, "costs": dict(e["costs"])}
                for k, e in self._entries.items()
            }

    # -- traffic (dispatch time) -------------------------------------------

    def note_dispatch(
        self,
        key: str,
        *,
        requests: int,
        real_tokens: int,
        capacity_tokens: int,
        device_s: float | None,
        replica=None,
    ) -> None:
        """Attribute one executed dispatch to its program: the join's
        write side, called by the server right where the pad-waste
        rollup is fed (the program RAN; its tokens and device time are
        real). ``device_s`` may be None when the dispatch carried no
        timing probe — the dispatch still counts, its device time is
        simply unknown (never invented)."""
        dev = float(device_s) if device_s else 0.0
        tkey = (key, replica)
        with self._lock:
            t = self._traffic.get(tkey)
            if t is None:
                t = self._traffic[tkey] = {
                    "dispatches": 0,
                    "requests": 0,
                    "real_tokens": 0,
                    "capacity_tokens": 0,
                    "device_s": 0.0,
                }
            t["dispatches"] += 1
            t["requests"] += int(requests)
            t["real_tokens"] += int(real_tokens)
            t["capacity_tokens"] += int(capacity_tokens)
            t["device_s"] += dev
        if self._metrics is not None:
            s = self._series.get(tkey)
            if s is None:
                s = self._make_series(key, replica)
            s["dispatches"].inc()
            s["requests"].inc(requests)
            s["real_tokens"].inc(real_tokens)
            s["capacity_tokens"].inc(capacity_tokens)
            if device_s:
                s["device_ms"].record(dev * 1e3)
                if real_tokens:
                    s["device_us_per_token"].record(
                        dev * 1e6 / real_tokens
                    )

    def _make_series(self, key: str, replica) -> dict:
        """Get-or-create the per-(program, replica) registry series.
        Gauges are CALLBACK gauges over the catalog's own ledgers, so
        achieved FLOPs/s and useful-token fraction are whatever is
        true at snapshot time — no second accounting to drift."""
        lbl = {"program": key}
        if replica is not None:
            lbl["replica"] = replica
        m = self._metrics
        s = {
            "dispatches": m.counter("program_dispatches_total", **lbl),
            "requests": m.counter("program_requests_total", **lbl),
            "real_tokens": m.counter("program_real_tokens_total", **lbl),
            "capacity_tokens": m.counter(
                "program_capacity_tokens_total", **lbl
            ),
            "device_ms": m.histogram("program_device_ms", **lbl),
            "device_us_per_token": m.histogram(
                "program_device_us_per_token", **lbl
            ),
        }
        m.gauge(
            "program_flops_per_s",
            fn=lambda k=key, r=replica: self._flops_per_s(k, r),
            **lbl,
        )
        m.gauge(
            "program_useful_token_frac",
            fn=lambda k=key, r=replica: self._useful_frac(k, r),
            **lbl,
        )
        self._series[(key, replica)] = s
        return s

    def _flops_per_s(self, key: str, replica) -> float:
        with self._lock:
            e = self._entries.get(key)
            t = self._traffic.get((key, replica))
        flops = (e or {}).get("costs", {}).get("flops")
        if not flops or t is None or not t["device_s"]:
            return 0.0
        return flops * t["dispatches"] / t["device_s"]

    def _useful_frac(self, key: str, replica) -> float:
        with self._lock:
            t = self._traffic.get((key, replica))
        if t is None or not t["capacity_tokens"]:
            return 0.0
        return t["real_tokens"] / t["capacity_tokens"]

    # -- the capacity model ------------------------------------------------

    def capacity_model(self) -> dict:
        """Costs x traffic, folded into the serve_summary export:
        per-program rates (device-time per token, achieved FLOPs/s,
        useful-token fraction) and the pool rollup of sustainable
        tokens/s and requests/s per replica — ``x / device_s``, i.e.
        what the replica would sustain at 100% device duty, the
        headroom baseline. Retired replicas merge in automatically
        (traffic rows are never deleted)."""
        with self._lock:
            entries = {
                k: {**e, "costs": dict(e["costs"])}
                for k, e in self._entries.items()
            }
            traffic = {k: dict(t) for k, t in self._traffic.items()}
        programs: dict[str, dict] = {}
        for key, entry in entries.items():
            programs[key] = {
                "source": entry["source"],
                "costs": entry["costs"],
                "dispatches": 0,
                "requests": 0,
                "real_tokens": 0,
                "capacity_tokens": 0,
                "device_s": 0.0,
                "per_replica": {},
            }
        replicas: dict[str, dict] = {}
        for (key, replica), t in sorted(
            traffic.items(), key=lambda kv: str(kv[0])
        ):
            prog = programs.get(key)
            if prog is None:
                # Dispatched but never recorded (a capture failed
                # loudly elsewhere): surface it with the explicit
                # marker rather than dropping its traffic.
                prog = programs[key] = {
                    "source": None,
                    "costs": unavailable_costs("never recorded"),
                    "dispatches": 0,
                    "requests": 0,
                    "real_tokens": 0,
                    "capacity_tokens": 0,
                    "device_s": 0.0,
                    "per_replica": {},
                }
            rid = str(replica if replica is not None else 0)
            for k in (
                "dispatches", "requests", "real_tokens",
                "capacity_tokens", "device_s",
            ):
                prog[k] += t[k]
            prog["per_replica"][rid] = dict(t)
            agg = replicas.setdefault(
                rid,
                {
                    "dispatches": 0,
                    "requests": 0,
                    "real_tokens": 0,
                    "capacity_tokens": 0,
                    "device_s": 0.0,
                },
            )
            for k in agg:
                agg[k] += t[k]
        for prog in programs.values():
            prog.update(_rates(prog, prog["costs"]))
            for t in prog["per_replica"].values():
                t.update(_rates(t, prog["costs"]))
        for agg in replicas.values():
            agg.update(_rates(agg, None))
        pool = {
            "replicas": len(replicas),
            "programs": len(programs),
            "dispatches": sum(a["dispatches"] for a in replicas.values()),
            "requests": sum(a["requests"] for a in replicas.values()),
            "real_tokens": sum(
                a["real_tokens"] for a in replicas.values()
            ),
            "capacity_tokens": sum(
                a["capacity_tokens"] for a in replicas.values()
            ),
            "device_s": sum(a["device_s"] for a in replicas.values()),
            # Pool capacity is ADDITIVE over replicas: each replica's
            # sustainable rate is its own device-duty bound.
            "sustainable_requests_per_s": sum(
                a["requests_per_device_s"] or 0.0
                for a in replicas.values()
            ),
            "sustainable_tokens_per_s": sum(
                a["tokens_per_device_s"] or 0.0
                for a in replicas.values()
            ),
            "per_replica": {
                rid: replicas[rid] for rid in sorted(replicas)
            },
        }
        cap = pool["capacity_tokens"]
        pool["useful_token_frac"] = (
            pool["real_tokens"] / cap if cap else None
        )
        return {
            "programs": {k: programs[k] for k in sorted(programs)},
            "pool": pool,
        }

    def emit_snapshot(self, summary: dict | None = None) -> dict | None:
        """One ``capacity_snapshot`` event with the current capacity
        model (idempotent — the drain that gets there first wins, like
        the serve_summary event). Returns the model, or None when the
        event already fired."""
        with self._lock:
            if self._snapshot_emitted:
                return None
            self._snapshot_emitted = True
        model = self.capacity_model()
        if self._sink is not None:
            self._sink.log(
                event=events.CAPACITY_SNAPSHOT,
                programs=model["programs"],
                pool=model["pool"],
            )
        if summary is not None:
            summary["capacity_model"] = model
        return model


def _rates(t: dict, costs: dict | None) -> dict:
    """Derived throughput rates for one traffic aggregate. None (never
    zero) when the denominator is unknown — a program with no device
    timing has an unknown rate, not an infinite one."""
    dev = t.get("device_s") or 0.0
    real = t.get("real_tokens") or 0
    cap = t.get("capacity_tokens") or 0
    out = {
        "useful_token_frac": (real / cap) if cap else None,
        "tokens_per_device_s": (real / dev) if dev else None,
        "requests_per_device_s": (
            (t.get("requests", 0) / dev) if dev else None
        ),
        "device_us_per_token": (dev * 1e6 / real) if dev and real else None,
    }
    flops = (costs or {}).get("flops")
    out["flops_per_s"] = (
        flops * t.get("dispatches", 0) / dev if flops and dev else None
    )
    return out
