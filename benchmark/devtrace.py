"""A ``torch.profiler`` slice of the measured window, read from its Chrome trace.

``Slice`` profiles the host (CPU ops, CUDA runtime calls, record_function
ranges) and the card (kernels, copies, fills) between ``start`` and
``stop``, writes the Chrome trace into the run's temporary directory,
reads it back and deletes it. Two ``bench.anchor`` ranges, one at each
end, tie ``time.perf_counter`` to the trace's clock, so spans recorded
on that clock elsewhere (the server's tracer) can be laid over the
device's timeline.

The arithmetic (device records by category, launch calls by name, record
families, the union of busy intervals) is the repo's
``gnot_tpu_torch/tools/profile_step.py``'s, copied so that it stays as
it is here.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import tempfile
import time

#: Chrome-trace categories of the records that run on the device.
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
#: Host calls that launch one kernel each (cudaLaunchKernel*, cuLaunchKernel*).
LAUNCH_CALL = re.compile(r"^cu(da)?Launch(Cooperative)?Kernel")
ANCHOR = "bench.anchor"


def family(event_name: str) -> str:
    """A kernel's family: its symbol without template arguments, parameter
    list, a leading ``void`` and a numeric suffix."""
    out, depth = [], 0
    for ch in event_name:
        if ch == "<":
            depth += 1
        elif ch == ">" and depth:
            depth -= 1
        elif not depth:
            out.append(ch)
    base = "".join(out).strip()
    if base.endswith(")"):
        depth = 0
        for i in range(len(base) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(base[i], 0)
            if depth == 0:
                base = base[:i].strip()
                break
    base = base.removeprefix("void ").strip()
    return re.sub(r"[.\d]+$", "", base)


def merged(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    """Overlapping ``(start, end)`` intervals merged, in order."""
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


@dataclasses.dataclass
class TraceData:
    """What one slice recorded, times in the trace's microseconds."""

    begin: float  # the slice's ends
    end: float
    offset_us: float  # trace time of perf_counter() == 0
    device: list  # (start, end, name, cat, correlation), started inside the slice
    launches: dict  # correlation -> host time of the launch call
    launch_calls: int  # inside the slice
    annotations: list  # (name, start, end) of record_function ranges

    @property
    def wall_s(self) -> float:
        return (self.end - self.begin) / 1e6

    def at(self, t_perf: float) -> float:
        """A ``time.perf_counter()`` reading on the trace's clock."""
        return t_perf * 1e6 + self.offset_us

    def busy_intervals(self) -> list[tuple[float, float]]:
        clipped = [(max(a, self.begin), min(b, self.end)) for a, b, *_ in self.device]
        return merged([(a, b) for a, b in clipped if b > a])

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e6

    def kernels(self, symbol: str) -> list:
        return [d for d in self.device if d[3] == "kernel" and symbol in d[2]]

    def gaps(self) -> list[tuple[float, float]]:
        """The idle stretches of the device inside the slice."""
        out, t = [], self.begin
        for a, b in self.busy_intervals():
            if a > t:
                out.append((t, a))
            t = max(t, b)
        if self.end > t:
            out.append((t, self.end))
        return out


def parse(events: list[dict], anchors: tuple[float, float]) -> TraceData:
    """The slice's records from a Chrome trace's ``traceEvents``; ``anchors``
    are the perf_counter readings taken inside the two anchor ranges."""
    device, launches, notes, marks = [], {}, [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = str(e.get("cat", "")).lower()
        ts, dur = float(e["ts"]), float(e["dur"])
        name = str(e.get("name", ""))
        corr = (e.get("args") or {}).get("correlation")
        if cat in DEVICE_CATS:
            device.append((ts, ts + dur, name, cat, corr))
        elif cat in ("cuda_runtime", "cuda_driver") and LAUNCH_CALL.match(name):
            launches[corr] = ts
        elif cat == "user_annotation":
            if name == ANCHOR:
                marks.append(ts + dur / 2)
            else:
                notes.append((name, ts, ts + dur))
    if len(marks) != 2:
        raise RuntimeError(f"the profiler trace holds {len(marks)} anchor ranges, not 2")
    marks.sort()
    offset = ((marks[0] - anchors[0] * 1e6) + (marks[1] - anchors[1] * 1e6)) / 2
    calls = sum(1 for ts in launches.values() if marks[0] <= ts <= marks[1])
    inside = [d for d in device if marks[0] <= d[0] <= marks[1]]
    return TraceData(begin=marks[0], end=marks[1], offset_us=offset, device=inside,
                     launches=launches, launch_calls=calls, annotations=notes)


class Slice:
    """Profile from ``start()`` to ``stop()``; ``read()`` gives the
    ``TraceData``."""

    def __init__(self) -> None:
        self._prof = None
        self._anchors: list[float] = []

    @staticmethod
    def _anchor() -> float:
        import torch

        with torch.profiler.record_function(ANCHOR):
            return time.perf_counter()

    def start(self, settle: float = 0.0) -> None:
        """Start profiling; the slice begins ``settle`` seconds after the
        profiler is up (its start holds the interpreter's lock for seconds,
        which stalls other threads)."""
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self._prof.__enter__()
        time.sleep(settle)
        self._anchors = [self._anchor()]

    def stop(self) -> None:
        """Stop profiling; ``read`` the records later, out of the window."""
        self._anchors.append(self._anchor())
        self._prof.__exit__(None, None, None)

    def read(self) -> TraceData:
        """The slice's records, through a Chrome trace in the run's
        temporary directory, deleted once read."""
        fd, path = tempfile.mkstemp(prefix="bench_trace_", suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.remove(path)
        self._prof = None
        return parse(events, (self._anchors[0], self._anchors[1]))


def device_ops(data: TraceData, top: int = 10) -> list[list]:
    """The device's records by family, the most time first, in seconds."""
    fams: dict[str, float] = {}
    for a, b, name, _cat, _corr in data.device:
        fams[family(name)] = fams.get(family(name), 0.0) + (b - a) / 1e6
    return [[k, v] for k, v in sorted(fams.items(), key=lambda kv: -kv[1])[:top]]


def idle_gaps(data: TraceData, spans: list[tuple[str, float, float]], top: int = 10) -> list[list]:
    """The device's idle time inside the slice by what the host was doing:
    each gap is named by the shortest span (trace time) that covers its
    middle, "no span" where none does; seconds per name, most first."""
    named: dict[str, float] = {}
    for a, b in data.gaps():
        mid = (a + b) / 2
        covering = [(e - s, n) for n, s, e in spans if s <= mid <= e]
        name = min(covering)[1] if covering else "no span"
        named[name] = named.get(name, 0.0) + (b - a) / 1e6
    return [[k, v] for k, v in sorted(named.items(), key=lambda kv: -kv[1])[:top]]
