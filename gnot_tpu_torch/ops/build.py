"""Build the port's CUDA sources and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain ``extern "C"`` launcher and builds
alone with ``nvcc`` into ``build/gnot_tpu_torch/lib<name>.so`` at the
root of the checkout (no PyTorch headers, so a build takes seconds).
A library is rebuilt when its source is newer than it; nothing is
compiled or loaded when a module is imported, only on first use.
"""

from __future__ import annotations

import ctypes
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "gnot_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    # Per-kernel registers, shared memory and spills, kept beside the
    # library in <name>.ptxas.txt.
    "-Xptxas", "-v",
)

_lock = threading.Lock()
# Loaded libraries by name: a dlopen'ed library lives as long as the
# process, so one handle per process is the natural lifetime.
_libs: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``PATH``, then
    ``/usr/local/cuda/bin``. Raises when there is none."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        candidates.append(found)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (CUDA_HOME, PATH, /usr/local/cuda/bin); the CUDA "
        "kernels build only on a machine with the CUDA toolkit"
    )


def sources() -> list[str]:
    """Names of every kernel source under ``csrc/``."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _up_to_date(name: str) -> bool:
    lib = library_path(name)
    if not lib.exists():
        return False
    newest = max(p.stat().st_mtime for p in CSRC.glob(f"{name}.cu*"))
    headers = [p.stat().st_mtime for p in CSRC.glob("*.cuh")]
    return lib.stat().st_mtime >= max([newest, *headers])


def start_build(name: str) -> subprocess.Popen | None:
    """Start ``nvcc`` for ``csrc/<name>.cu`` in the background (None when
    the library is up to date). Several builds may run at once."""
    if _up_to_date(name):
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = library_path(name).with_suffix(f".so.tmp{os.getpid()}")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    return subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )


def finish_build(name: str, proc: subprocess.Popen | None) -> str:
    """Wait for ``start_build``'s process, install the library, and
    return the compiler's register/shared-memory report."""
    report_path = BUILD_DIR / f"{name}.ptxas.txt"
    if proc is None:
        return report_path.read_text() if report_path.exists() else ""
    out, _ = proc.communicate()
    tmp = library_path(name).with_suffix(f".so.tmp{os.getpid()}")
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{out}")
    os.replace(tmp, library_path(name))
    report_path.write_text(out)
    return out


def build(name: str) -> str:
    """Build one library (if stale) and return its compiler report."""
    return finish_build(name, start_build(name))


def ptxas_summary(report: str) -> tuple[list[int], int]:
    """From a ``-Xptxas -v`` report: the registers a thread of each kernel
    instance uses, in the report's order, and the bytes of spill stores
    and loads over all of them."""
    regs = [int(m) for m in re.findall(r"Used (\d+) registers", report)]
    spills = sum(int(m) for m in re.findall(r"(\d+) bytes spill (?:stores|loads)", report))
    return regs, spills


def variant_source(name: str, edits: list[tuple[str, str]]) -> str:
    """``csrc/<name>.cu`` with every ``(old, new)`` edit applied, for a
    probe's variant; raises when an ``old`` text is not in the source."""
    source = CSRC / f"{name}.cu"
    text = source.read_text()
    for old, new in edits:
        if old not in text:
            raise RuntimeError(f"variant edit not found in {source.name}: {old!r}")
        text = text.replace(old, new)
    return text


def build_variants(name: str, variants: dict[str, list[tuple[str, str]]],
                   out_dir: Path) -> dict[str, tuple[ctypes.CDLL, str]]:
    """Build each variant of ``csrc/<name>.cu`` (``variant_source`` of its
    edits) into ``out_dir/lib<variant>.so``, every ``nvcc`` started
    together; by variant, the loaded library and the compiler's report.
    Only the probes load variants."""
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for variant, edits in variants.items():
        src = out_dir / f"{variant}.cu"
        src.write_text(variant_source(name, edits))
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(out_dir / f"lib{variant}.so"), str(src)]
        procs[variant] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True)
    built = {}
    for variant, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {variant} of csrc/{name}.cu:\n{out}")
        built[variant] = (ctypes.CDLL(str(out_dir / f"lib{variant}.so")), out)
    return built


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build(name)
            lib = _libs[name] = ctypes.CDLL(str(library_path(name)))
        return lib
