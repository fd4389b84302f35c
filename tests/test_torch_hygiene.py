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
# smoke test, and the card-only tests.
JAX_FREE_FILES = PORT_FILES + [ROOT / "tests" / "test_torch_cuda.py"]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "gnot_tpu"}


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
        "from gnot_tpu_torch.ops import build, fused_ffn\n"
        "assert build._libs == {}, build._libs\n"
        "assert fused_ffn.fused_gated_ffn_kernel.launches == 0\n"
        "print('imported', len(sys.modules) > 0)\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    assert "imported True" in out.stdout


def test_build_paths():
    from gnot_tpu_torch.ops import build

    assert build.sources() == ["fused_gated_ffn"]
    assert build.library_path("fused_gated_ffn").parent == ROOT / "build" / "gnot_tpu_torch"
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
