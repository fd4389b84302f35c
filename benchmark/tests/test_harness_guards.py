"""Guards of the benchmark's shape: imports, names, files found by name,
the result line, and no run without a card. CPU only."""

from __future__ import annotations

import ast
import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
BENCH = HERE.parent
CHECKOUT = BENCH.parent
sys.path.insert(0, str(CHECKOUT))

from benchmark import run as run_mod  # noqa: E402
from benchmark import spec  # noqa: E402

FORBIDDEN = {"jax", "jaxlib", "flax", "gnot_tpu"}
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _imports(path: Path) -> set[str]:
    """Top-level names of every module ``path`` imports, whole."""
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module.split(".")[0])
    return out


def _spec() -> dict:
    return json.loads((CHECKOUT / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")), ids=lambda p: str(p.relative_to(BENCH)))
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not _imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    assert _imports(path) <= {"__future__", "contextlib", "math", "torch"}


def test_names_units_and_keys_are_as_the_contract_allows():
    b = _spec()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    names = []
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and len(c["reduced"]) <= 16
        # Never a width: no hidden, head or projection size is cut.
        assert not [k for k in c["reduced"] if not NAME.match(k) or k.endswith(("_dim", "_rank"))
                    or k in ("n_head", "n_expert")]
        assert c["file"].startswith(tuple(p + "/" for p in b["paths"]))
        names.append(c["name"])
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert all(NAME.match(w[k]) for k in ("name", "config", "traffic"))
        assert w["chips"] == 1 and len(w["why"]) <= 200
        names.append(w["name"])
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher") and m["source"] in SOURCES
        names.append(m["name"])
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in b["end_to_end"]}
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e
    assert len(names) == len(set(names))
    assert 1 <= b["run_seconds"] <= 51


@pytest.mark.parametrize("workload", [w["name"] for w in _spec()["workloads"]])
def test_every_cell_finds_its_files_by_name(workload):
    cell = spec.cell(workload)
    assert cell.config["model"] and cell.traffic["kind"] in ("train", "serve_closed")
    assert cell.limits["numbers"]
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s", "peak_mem_gib"}
    assert len(cell.end_to_end) >= 3 and cell.per_layer
    assert set(cell.readers) == {m["name"] for m in cell.per_layer}


def test_a_fixture_config_traffic_and_metric_load_without_editing_a_file():
    fx = HERE / "fixtures"
    cell = spec.cell("tiny.train", bench=fx / "BENCHMARK.json", root=fx)
    assert cell.config["name"] == "tiny" and cell.traffic["pool"] == 8
    assert cell.readers["fixture.steps"]({"steps": 5}) == 5
    serve = spec.cell("tiny.serve", bench=fx / "BENCHMARK.json", root=fx)
    assert serve.readers == {}  # the metric moves a metric this cell does not report


def test_the_result_line_has_the_keys_of_the_contract(monkeypatch):
    fx = HERE / "fixtures"
    cell = spec.cell("tiny.train", bench=fx / "BENCHMARK.json", root=fx)
    monkeypatch.setattr("benchmark.common.device_info",
                        lambda device, chips: {"platform": "gpu", "kind": "x", "count": chips})
    out = {"numbers": {"loss_gap": 0.0, "grad_gap": 0.0, "change_gap_median": 0.0},
           "values": {"train_points_per_s": 1.0, "setup_s": 2.0}, "attempted": 3, "failed": 0,
           "memory_peak_bytes": 10, "ctx": {"steps": 3}}
    line = run_mod.result_line(cell, out, False, "cpu")
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert line["correct"] is True
    assert set(line["metrics"]) == {"train_points_per_s", "setup_s"}
    traced = run_mod.result_line(cell, out, True, "cpu")
    assert traced["metrics"] == {"fixture.steps": {"value": 3.0, "unit": "steps"}}
    out["numbers"]["grad_gap"] = 1.0
    assert run_mod.result_line(cell, out, False, "cpu")["correct"] is False


def test_run_exits_non_zero_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is here: the run would measure")
    proc = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload", "ns2d_ref.train",
                           "--seed", "2147483659", "--seconds", "1", "--trace", "0"],
                          capture_output=True, text=True, timeout=120, cwd=CHECKOUT)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
