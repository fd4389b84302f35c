"""Hygiene of the port: no JAX anywhere in it, ``cuda`` by default and a
refusal without a card, kernels built only on first use."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "gnot_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
# Files that must run where JAX is not installed: the port, the on-card
# smoke test, the card-only tests and the rank processes they launch.
JAX_FREE_FILES = PORT_FILES + [ROOT / "tests" / "test_torch_cuda.py",
                                ROOT / "tests" / "torch_ranks.py"]
# ml_dtypes is not installed beside the card: the port's bf16 is torch.bfloat16.
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "gnot_tpu", "ml_dtypes"}


def _imported_roots(path: Path) -> set[str]:
    """Top-level module names a file imports: import statements plus
    ``importlib.import_module("...")`` / ``__import__("...")`` with a
    literal name."""
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and node.args:
            fn = node.func
            name = fn.attr if isinstance(fn, ast.Attribute) else getattr(fn, "id", "")
            arg = node.args[0]
            if name in ("import_module", "__import__") and isinstance(arg, ast.Constant):
                roots.add(str(arg.value).split(".")[0])
    return roots


def test_port_files_found():
    names = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    assert "chip_smoke.py" in names
    assert "gnot_tpu_torch/ops/fused_ffn.py" in names
    # Parallel training: the scanner sees its three modules.
    assert {"gnot_tpu_torch/parallel/multihost.py", "gnot_tpu_torch/parallel/mesh.py",
            "gnot_tpu_torch/ops/collectives.py"} <= names
    assert len(names) >= 15


@pytest.mark.parametrize(
    "path", JAX_FREE_FILES, ids=lambda p: p.relative_to(ROOT).as_posix()
)
def test_port_imports_no_jax(path):
    bad = _imported_roots(path) & FORBIDDEN
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_scanner_sees_jax_imports(tmp_path):
    f = tmp_path / "m.py"
    f.write_text(
        "import os\nfrom gnot_tpu.ops import attention\n"
        "import importlib\nimportlib.import_module('jax.numpy')\n"
    )
    assert _imported_roots(f) & FORBIDDEN == {"gnot_tpu", "jax"}


def test_cuda_is_the_default_and_refused_without_a_card(monkeypatch):
    from gnot_tpu_torch import main as port_main
    from gnot_tpu_torch.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = port_main.build_parser().parse_args(["--serve"])
    assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_main.run_serve(args)
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("meta")


def test_bf16_serving_runs_on_cuda_by_default_and_is_refused_without_a_card(monkeypatch):
    """``--serve_dtype bfloat16`` changes the dtype, not the device: the
    bf16 engine serves on ``cuda`` unless told ``--device cpu``, and
    without a card the entry point raises before building anything."""
    from gnot_tpu_torch import main as port_main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = port_main.build_parser().parse_args(["--serve", "--serve_dtype", "bfloat16"])
    assert args.device == "cuda" and args.serve_dtype == "bfloat16"
    monkeypatch.setattr(port_main.datasets, "load", lambda *_: pytest.fail("loaded data"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_main.run_serve(args)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_main.main(["--serve", "--serve_dtype", "bfloat16", "--ffn_impl", "pallas"])


def test_scanner_sees_ml_dtypes_imports(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import ml_dtypes\nfrom ml_dtypes import bfloat16\n")
    assert _imported_roots(f) & FORBIDDEN == {"ml_dtypes"}


def test_training_runs_on_cuda_by_default_and_is_refused_without_a_card(monkeypatch):
    """Without ``--serve`` the CLI trains, on ``cuda`` unless told
    ``--device cpu``; without a card it raises before loading any data."""
    from gnot_tpu_torch import main as port_main
    from gnot_tpu_torch.config import Config, ModelConfig
    from gnot_tpu_torch.train.trainer import Trainer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--synthetic", "darcy2d", "--n_train", "12", "--n_test", "4", "--epochs", "2"]
    args = port_main.build_parser().parse_args(argv)
    assert not args.serve and args.device == "cuda"
    monkeypatch.setattr(port_main.datasets, "load", lambda *_: pytest.fail("loaded data"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_main.main(argv)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(Config(), ModelConfig(), [], [])


def test_distributed_training_runs_on_cuda_by_default_and_is_refused_without_a_card(
        monkeypatch):
    """``--distributed`` changes the layout of the run, not the device: a
    rank trains on ``cuda`` unless told ``--device cpu``, and without a card
    the entry point raises before joining a group or loading any data."""
    from gnot_tpu_torch import main as port_main
    from gnot_tpu_torch.parallel import multihost

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--distributed", "--mesh_seq", "2", "--synthetic", "darcy2d", "--epochs", "1"]
    assert port_main.build_parser().parse_args(argv).device == "cuda"
    monkeypatch.setattr(port_main.datasets, "load", lambda *_: pytest.fail("loaded data"))
    monkeypatch.setattr(multihost, "initialize", lambda *a, **k: pytest.fail("joined a group"))
    for env in ({}, dict(RANK="0", WORLD_SIZE="2", MASTER_ADDR="127.0.0.1", MASTER_PORT="1")):
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port_main.main(argv)


def test_validate_kernels_refuses_without_a_card(monkeypatch):
    """The kernel-validation entry point runs on cuda only: without a card
    it raises before any check, and it takes no device option."""
    from gnot_tpu_torch import validate_kernels

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        validate_kernels.main([])
    with pytest.raises(SystemExit):
        validate_kernels.main(["--device", "cpu"])


def test_importing_the_port_builds_nothing():
    """Every module imports in a fresh interpreter without building or
    loading a kernel (kernels build on first launch only)."""
    mods = [
        p.relative_to(ROOT).with_suffix("").as_posix().replace("/", ".").removesuffix(".__init__")
        for p in PORT_FILES[:-1]
    ]
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "from gnot_tpu_torch.ops import build, fused_attention, fused_ffn\n"
        "assert build._libs == {}, build._libs\n"
        "assert fused_ffn.fused_gated_ffn_kernel.launches == 0\n"
        "for n in ('nla_reduce', 'nla_apply', 'nla_reduce_seg', 'nla_apply_seg'):\n"
        "    assert getattr(fused_attention, n + '_kernel').launches == 0, n\n"
        "assert fused_attention._launchers == {}\n"
        "print('imported', len(sys.modules) > 0)\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    assert "imported True" in out.stdout


def test_build_paths():
    from gnot_tpu_torch.ops import build

    assert build.sources() == ["fused_gated_ffn", "nla_apply", "nla_reduce"]
    assert build.library_path("fused_gated_ffn").parent == ROOT / "build" / "gnot_tpu_torch"
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS


@pytest.mark.parametrize(
    "argv",
    [["--attention_mode", "parity", "--synthetic", "darcy2d"],
     ["--packed", "--synthetic", "elasticity"],
     ["--serve", "--serve_packed", "--synthetic", "elasticity"],
     ["--serve", "--serve_packed", "--serve_dtype", "bfloat16", "--synthetic", "elasticity"]],
    ids=["parity", "packed", "serve_packed", "serve_packed_bf16"],
)
def test_parity_and_packed_run_on_cuda_by_default_and_are_refused_without_a_card(
        argv, monkeypatch):
    """Parity mode, packed training and packed serving change the layout
    or the numerics, not the device: each runs on ``cuda`` unless told
    ``--device cpu``, and without a card raises before loading any data."""
    from gnot_tpu_torch import main as port_main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = port_main.build_parser().parse_args(argv)
    assert args.device == "cuda"
    monkeypatch.setattr(port_main.datasets, "load", lambda *_: pytest.fail("loaded data"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_main.main(argv + ["--ffn_impl", "pallas"])


@pytest.mark.parametrize(
    "argv",
    [["--grad_accum", "2"], ["--steps_per_dispatch", "4"], ["--flat_params"],
     ["--scan_layers", "--ffn_impl", "xla"],
     ["--serve", "--flat_params"], ["--serve", "--scan_layers", "--ffn_impl", "xla"]],
    ids=["grad_accum", "steps_per_dispatch", "flat_params", "scan_layers", "serve_flat",
         "serve_scan"],
)
def test_training_loop_options_run_on_cuda_by_default_and_are_refused_without_a_card(
        argv, monkeypatch):
    """Gradient accumulation, K steps per dispatch and the flat and stacked
    layouts change the loop or the layout, not the device: each runs on
    ``cuda`` unless told ``--device cpu``, and without a card raises
    before loading any data."""
    from gnot_tpu_torch import main as port_main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = port_main.build_parser().parse_args(argv)
    assert args.device == "cuda"
    monkeypatch.setattr(port_main.datasets, "load", lambda *_: pytest.fail("loaded data"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_main.main(argv)


def test_the_stacked_layout_module_is_scanned():
    names = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    assert {"gnot_tpu_torch/parallel/pipeline.py", "gnot_tpu_torch/parallel/__init__.py"} <= names
