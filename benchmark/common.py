"""What both kinds of cell share: seeds, weights, the verdict, the card.

``make_weights`` draws every parameter of the reference's layout on the
device from the seed in one call (torch.nn.Linear's U(+-1/sqrt(fan_in))),
and the same tensors go to the program and, after the window, to the
plain reference. ``judge`` holds each number that ``correct`` compares to
its limit from the cell's limits file.
"""

from __future__ import annotations

import contextlib
import gc
import math
import statistics
import subprocess

import torch

from benchmark.reference import gnot as ref


def seed_of(seed: int) -> int:
    """A seed as the generators take it (non-negative, under 2**63)."""
    return seed % (2**63)


def make_weights(model_cfg: dict, seed: int, device) -> dict:
    """Every parameter, by its flax-tree name, drawn on ``device`` from
    ``seed`` in one call and scaled per leaf."""
    specs = ref.param_specs(model_cfg)
    total = sum(math.prod(shape) for _, shape, _ in specs)
    gen = torch.Generator(device=device).manual_seed(seed_of(seed))
    flat = torch.rand(total, generator=gen, device=device).mul_(2).sub_(1)
    out, off = {}, 0
    for name, shape, fan_in in specs:
        n = math.prod(shape)
        out[name] = flat[off:off + n].view(shape).mul_(1.0 / math.sqrt(fan_in))
        off += n
    return out


def load_weights(model, weights: dict) -> None:
    """Copy ``weights`` into the program's model, name by name; every
    parameter must be there."""
    params = dict(model.named_parameters())
    if set(params) != set(weights):
        missing, extra = set(params) - set(weights), set(weights) - set(params)
        raise KeyError(f"weights do not match the model: missing {sorted(missing)[:5]}, "
                       f"extra {sorted(extra)[:5]}")
    with torch.no_grad():
        for name, p in params.items():
            p.copy_(weights[name])


def norm_gaps(prog: dict, refn: dict, keys=None) -> dict:
    """Each leaf's gap between the program's norm and the reference's, over
    the reference's norm of that leaf or of the median leaf, whichever is
    larger."""
    keys = list(keys if keys is not None else refn)
    med = statistics.median(refn[k] for k in keys)
    return {k: abs(prog[k] - refn[k]) / max(refn[k], med) for k in keys}


def judge(values: dict, limits: dict) -> tuple[bool, dict]:
    """Each number of the limits file beside its limit; ``correct`` when
    every one is there, finite and at most its limit."""
    checks, ok = {}, True
    for name, entry in limits["numbers"].items():
        v = values.get(name)
        good = v is not None and math.isfinite(v) and v <= entry["limit"]
        ok = ok and good
        checks[name] = {"value": v if v is None or math.isfinite(v) else str(v),
                        "limit": entry["limit"]}
    return ok, checks


def span(on: bool, name: str):
    """A record_function range on the profiler's timeline when tracing."""
    if not on:
        return contextlib.nullcontext()
    return torch.profiler.record_function(name)


def device_info(device, chips: int) -> dict:
    """The card this run used: name, count and the power limit."""
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": chips}
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader",
                              "-i", str(torch.device(device).index or 0)],
                             capture_output=True, text=True, timeout=20)
        info["power_limit"] = out.stdout.strip() or None
    except (OSError, subprocess.SubprocessError):
        info["power_limit"] = None
    return info


def sync(device) -> None:
    """Wait for the card (nothing to wait for on the CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def peak_bytes(device) -> int:
    """The card's peak of allocated memory (0 on the CPU)."""
    if torch.device(device).type == "cuda":
        return torch.cuda.max_memory_allocated(device)
    return 0


def release(device) -> None:
    """Give freed blocks back to the card."""
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
