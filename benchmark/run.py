"""Run one cell of the port's benchmark once.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Reads ``BENCHMARK.json`` at the root of the checkout, finds the cell's
configuration, traffic mix, limits and per-layer readers by name
(``benchmark/spec.py``), and runs the driver of the mix's ``kind`` on the
card. The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, each number that ``correct`` compares
beside its limit; the same numbers are the last lines of standard error.

Exits non-zero, printing no result, without a CUDA device (or with fewer
than the cell asks for), when a module of JAX or of the JAX package is
loaded once the window has closed, and in a checkout without the port.
Build and kernel caches stay inside the checkout, under ``build/``.
"""

from __future__ import annotations

import time

_PERF0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import re  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parents[1]
#: Top-level module names that must not be loaded in the measured process.
FORBIDDEN = ("jax", "jaxlib", "flax", "gnot_tpu")


def process_start() -> float:
    """The process's start on the ``time.perf_counter`` clock (its age read
    from /proc; this module's first line where /proc cannot say)."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - ticks / os.sysconf("SC_CLK_TCK")
        now = time.perf_counter()
        return min(_PERF0, now - max(age, 0.0))
    except (OSError, ValueError, IndexError):
        return _PERF0


def _environment() -> None:
    """Caches inside the checkout, at fixed paths (the port's own nvcc
    libraries already build under ``build/gnot_tpu_torch``)."""
    build = CHECKOUT / "build" / "benchmark"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    if str(CHECKOUT) not in sys.path:
        sys.path.insert(0, str(CHECKOUT))
    # This file's folder first on the path would let its modules shadow
    # the standard library's.
    here = str(Path(__file__).resolve().parent)
    sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != here]


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def result_line(cell, out: dict, trace: bool, device) -> dict:
    """The result object, ``checks`` last."""
    from benchmark import devtrace
    from benchmark.common import device_info, judge

    correct, checks = judge(out["numbers"], cell.limits)
    if trace:
        metrics = {}
        for m in cell.per_layer:
            value = cell.readers[m["name"]](out["ctx"])
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": float(out["values"][m["name"]]), "unit": m["unit"]}
                   for m in cell.end_to_end}
    dev = device_info(device, cell.chips)
    dev["memory_peak_bytes"] = int(out["memory_peak_bytes"])
    line = {"correct": correct, "attempted": int(out["attempted"]), "failed": int(out["failed"]),
            "metrics": metrics, "device": dev}
    data = out["ctx"].get("trace")
    if trace and data is not None:
        dev["busy_s"] = data.busy_s
        dev["window_s"] = data.wall_s
        line["breakdown"] = {"device_ops": devtrace.device_ops(data),
                             "idle_gaps": devtrace.idle_gaps(data, host_spans(out["ctx"]))}
    line["checks"] = checks
    return line


def host_spans(ctx) -> list[tuple[str, float, float]]:
    """What the host was doing, on the trace's clock: the harness's own
    ranges and, serving, the server's dispatch phases."""
    data = ctx["trace"]
    spans = [(re.sub(r"\.\d+$", "", n), a, b) for n, a, b in data.annotations]
    for s in ctx.get("spans", ()):
        if s.name in ("batch_assembly", "device", "unpad", "dispatch"):
            spans.append((f"server.{s.name}", data.at(s.start), data.at(s.end)))
    return spans


def main(argv=None) -> int:
    started = process_start()
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    _environment()

    from benchmark import spec

    cell = spec.cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"benchmark: the cell {cell.name} needs {cell.chips} CUDA device(s); torch finds "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.cuda.reset_peak_memory_stats(device)
    return measure(cell, args.seed, args.seconds, bool(args.trace), device, started)


def measure(cell, seed: int, seconds: float, trace: bool, device, started: float) -> int:
    """One run of ``cell`` on ``device``, its result printed; the exit code."""
    from benchmark import serve_cell, train_cell

    drivers = {"train": train_cell.run, "serve_closed": serve_cell.run}
    out = drivers[cell.traffic["kind"]](cell, seed, seconds, trace, device,
                                        lambda: time.perf_counter() - started)
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: the process loaded {bad}", file=sys.stderr)
        return 4
    line = result_line(cell, out, trace, device)
    print(json.dumps({"detail": out["detail"]}, default=str), file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name} = {c['value']} (limit {c['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
