"""Finding a cell's files by name.

``BENCHMARK.json`` at the root of the checkout names the cells. A cell's
configuration is the file its ``configs`` entry names; its traffic mix is
``traffic/<traffic>.json``; its limits (what ``correct`` compares and the
limit of each number) are ``limits/<workload>.json``; a per-layer metric
is read by ``metrics/<metric>.py``'s ``read(ctx)``; all of these under the
benchmark's own folder. A new cell, mix or metric is a new file and a new
entry, never an edit.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
CHECKOUT = HERE.parent


@dataclasses.dataclass
class Cell:
    name: str
    config: dict  # the configuration file's content
    traffic: dict  # the traffic mix's file
    limits: dict  # the limits file's
    chips: int
    end_to_end: list  # this cell's end-to-end metric entries
    per_layer: list  # this cell's per-layer metric entries
    readers: dict  # per-layer metric name -> read(ctx)


def _load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_reader(path: Path):
    """The ``read`` function of a metric's reader file."""
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + path.stem.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def cell(name: str, *, bench: Path | None = None, root: Path = HERE) -> Cell:
    """The cell ``name`` of the ``BENCHMARK.json`` at ``bench`` (default:
    the checkout's): its configuration file where that names it, relative
    to ``bench``; its traffic, limits and readers under ``root``."""
    bench = bench or CHECKOUT / "BENCHMARK.json"
    spec = _load_json(bench)
    work = {w["name"]: w for w in spec["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r}; known: {sorted(work)}")
    w = work[name]
    conf = {c["name"]: c for c in spec["configs"]}[w["config"]]
    config = _load_json(bench.parent / conf["file"])
    traffic = _load_json(root / "traffic" / f"{w['traffic']}.json")
    limits = _load_json(root / "limits" / f"{name}.json")

    def mine(m):
        return name in m.get("workloads", [name])

    e2e = [m for m in spec["end_to_end"] if mine(m)]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"]
                 if (name in m["workloads"] if "workloads" in m else m["moves"] in reported)]
    readers = {m["name"]: load_reader(root / "metrics" / f"{m['name']}.py") for m in per_layer}
    return Cell(name=name, config=config, traffic=traffic, limits=limits, chips=w["chips"],
                end_to_end=e2e, per_layer=per_layer, readers=readers)
