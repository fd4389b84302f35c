"""The frozen yardstick against the program's own count of today."""

from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
BENCH = HERE.parent
sys.path.insert(0, str(BENCH.parent))

from benchmark import costs  # noqa: E402
from gnot_tpu_torch.config import ModelConfig  # noqa: E402
from gnot_tpu_torch.obs.costs import program_costs  # noqa: E402

CONFIGS = {name: json.loads((BENCH / "configs" / f"{name}.json").read_text())["model"]
           for name in ("gnot_ns2d_ref",)}
#: Each configuration's dispatch shapes: (rows, nodes, input-function
#: points): the cells' buckets, and long single meshes.
SHAPES = {
    "gnot_ns2d_ref": [(4, 12288, 768), (4, 12288, 1024), (1, 12288, 1024),
                      (1, 65536, 8192), (1, 98304, 12288), (1, 98304, 8192)],
}


@pytest.mark.parametrize("name,shape", [(n, s) for n, ss in SHAPES.items() for s in ss])
def test_forward_products_equal_the_programs_count(name, shape):
    rows, nodes, funcs = shape
    cfg = CONFIGS[name]
    want = program_costs(ModelConfig(**cfg), rows=rows, pad_nodes=nodes, pad_funcs=funcs)
    assert costs.forward_flops(cfg, rows, nodes, funcs) == want["flops"]


def test_the_ffn_launch_at_the_reference_scale():
    cfg = CONFIGS["gnot_ns2d_ref"]
    flops, nbytes = costs.ffn_kernel_cost(cfg, 4 * 12288, "float32")
    assert flops == 2 * 49152 * 3 * 5 * 256 * 256  # 96.6 GFLOP
    weights = 3 * 5 * (256 * 256 + 256) * 4
    assert nbytes == weights + 49152 * (256 + 256) * 4 + 49152 * 3 * 4
    least = costs.least_seconds(flops, nbytes, "float32")
    assert least == pytest.approx(flops / 495e12)  # bound by operations: 0.195 ms
    assert least == pytest.approx(1.952e-4, rel=1e-3)


def test_a_mesh_costs_its_own_points():
    cfg = CONFIGS["gnot_ns2d_ref"]
    assert costs.mesh_flops(cfg, 10000, 800) == costs.forward_flops(cfg, 1, 10000, 800)
    assert costs.mesh_flops(cfg, 10000, 800) < costs.forward_flops(cfg, 1, 12288, 1024)
