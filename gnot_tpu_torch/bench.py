"""Benchmark of the port: mesh points a second on NS2d-1k.

Port of the repo-root ``bench.py``, with its flags, defaults, functions
and one JSON line, plus ``--device`` (``cuda`` unless ``--device cpu`` is
passed; without a card ``cuda`` raises). It times the full training step
of the port's trainer (``train/trainer.py::Trainer``: forward, backward,
AdamW) at the reference-default architecture on the NS2d ~1k-point
config, counting REAL (unpadded) mesh points a second on the one card.
``vs_baseline`` divides by the same step on the host CPU in float32
(``--baseline jax``, the JAX bench's name for "this framework's step on
the host CPU"). ``--baseline torch`` (the reference implementation's own
eager step, which the JAX bench imports from the reference checkout that
``GNOT_REFERENCE_PATH`` names) is not ported and raises
``NotPortedError``.

Timing (``--timing``):

* ``scan_marginal`` (``auto`` on the card): windows of K1 and K2 steps on
  one device-resident batch, each ending in a hard fetch (``.item()`` of
  the last loss and of one parameter element sliced on the device), and
  the marginal time a step from their difference; best of ``--repeats``
  windows, each from the same saved state. Eager PyTorch has no
  ``lax.scan``: a window is K eager steps with no host read between
  them, so the host's kernel launches fall inside the marginal, where
  JAX's window is one dispatch. Read ``ms_per_step`` with that in mind.
* ``persstep`` (``auto`` on the CPU): the per-step loop after a warm-up.

``flops_per_step`` is ``torch.utils.flop_counter.FlopCounterMode``'s count
of one ``ffn_impl="xla"`` step at the same shapes and dtype: the counter
cannot see the FFN kernel's ctypes launch, so ``--ffn_impl pallas``
reports the ``xla`` step's count. The counter counts products (matmuls,
``2·M·N·K``) only, not AdamW's or any other elementwise work, so
``achieved_tflops`` and ``mfu`` are matmul rates (XLA's count that JAX's
bench reads includes the elementwise work).

Usage::

    python -m gnot_tpu_torch.bench                       # on the card
    python -m gnot_tpu_torch.bench --ffn_impl pallas --dtype float32
    python -m gnot_tpu_torch.bench --device cpu --n_points 64 --batch_size 2
"""

from __future__ import annotations

import argparse
import copy
import json
import sys
import time

import torch

# Peak dense throughput by (torch.cuda.get_device_name prefix, compute
# dtype), FLOP/s. Source: NVIDIA's H100 data sheet, SXM part, dense
# (without sparsity): 989 TFLOP/s bf16 on the tensor cores and 67 TFLOP/s
# float32 outside them. The port runs float32 matmuls with TF32 off
# (device.py), so 67 is its float32 rate. Any other device reports
# mfu = None (a notice goes to stderr: peak_flops()).
PEAK_FLOPS = {
    ("NVIDIA H100 80GB HBM3", "bfloat16"): 989e12,
    ("NVIDIA H100 80GB HBM3", "float32"): 67e12,
}

#: What ``--mem_stats`` prints, the JAX bench's keys.
MEM_KEYS = ("peak_bytes_in_use", "bytes_in_use", "largest_alloc_size")

SCAN_MARGINAL_NOTE = (
    "bench: timing=scan_marginal runs each window as K eager train steps on "
    "one device-resident batch with no host read between them; the host's "
    "kernel launches fall inside the marginal ms/step (JAX's window is one "
    "lax.scan dispatch)"
)


def _gen_samples(config: str, n_points: int, batch_size: int):
    """Synthetic samples for a bench config: the one size mapping (darcy2d
    is a square grid, so n_points maps to the nearest grid edge). The
    padded and the packed batches are both drawn from here, so A/Bs
    compare the same samples."""
    from gnot_tpu_torch.data import datasets

    gen_kwargs = {
        "ns2d": {"n_points": n_points},
        "darcy2d": {"grid_n": max(2, int(n_points**0.5))},
        "elasticity": {"base_points": n_points},
        "inductor2d": {"base_points": n_points},
        "heatsink3d": {"base_points": n_points},
    }[config]
    return datasets.SYNTHETIC[config](batch_size, seed=0, **gen_kwargs)


def _model_config(samples, step_dtype: str, attention_impl: str, ffn_impl: str, remat: bool,
                  model_overrides: dict | None):
    """The one bench ``ModelConfig`` (``build`` calls it for the padded and
    the packed layouts alike, so A/Bs benchmark the same model)."""
    from gnot_tpu_torch.config import ModelConfig
    from gnot_tpu_torch.data import datasets

    return ModelConfig(
        dtype=step_dtype,
        attention_impl=attention_impl,
        ffn_impl=ffn_impl,
        remat=remat,
        **datasets.infer_model_dims(samples),
        **(model_overrides or {}),
    )


def build_data(step_dtype: str, n_points: int, batch_size: int, config: str,
               attention_impl: str = "xla", ffn_impl: str = "xla", remat: bool = False,
               model_overrides: dict | None = None):
    """One padded host batch (the ``Loader``'s first, unshuffled) and the
    reference-default ``ModelConfig`` for the workload; no model state.
    ``model_overrides`` replaces ``ModelConfig`` fields."""
    from gnot_tpu_torch.data.batch import Loader

    samples = _gen_samples(config, n_points, batch_size)
    mc = _model_config(samples, step_dtype, attention_impl, ffn_impl, remat, model_overrides)
    loader = Loader(samples, batch_size)
    return loader.collate_at(loader.epoch_indices()[0]), mc


def train_step(state, batch, lr: float):
    """One training step of the trainer ``state`` on ``batch`` at learning
    rate ``lr``: ``Trainer.train_step``, the step ``main`` trains with.
    Returns ``(state, loss)`` as the JAX step does; ``state`` is updated
    in place and the loss is a device scalar nothing has waited for."""
    return state, state.train_step(batch, lr)


def build(step_dtype: str, attention_impl: str = "xla", n_points: int = 1024,
          batch_size: int = 4, ffn_impl: str = "xla", config: str = "ns2d",
          remat: bool = False, flat_params: bool = False, model_overrides: dict | None = None,
          packed: bool = False, pack_chunk: int = 128, device: str = "cuda"):
    """``(step, state, batch, model_config)`` for the workload: ``step`` is
    ``train_step``, ``state`` a ``Trainer`` on ``device`` with its
    optimizer (weights from seed 0), ``batch`` the host batch. With
    ``packed`` the batch is the ``PackedLoader``'s first dispatch of the
    same samples and the trainer runs the packed loss; with
    ``flat_params`` the flat layout."""
    from gnot_tpu_torch.config import Config, DataConfig, OptimConfig, TrainConfig
    from gnot_tpu_torch.train.trainer import Trainer

    if packed and flat_params:
        raise ValueError(
            "packed + flat_params not composed (the Trainer rejects the "
            "combination too); pick one"
        )
    samples = _gen_samples(config, n_points, batch_size)
    if packed:
        # "Pack, don't pad": ONE packed dispatch (several segments a row)
        # from the samples the padded path uses; points a second stay
        # comparable because the metric counts REAL points either way.
        from gnot_tpu_torch.data.batch import PackedLoader

        batch = PackedLoader(samples, batch_size, chunk=pack_chunk).probe_batch()
        mc = _model_config(samples, step_dtype, attention_impl, ffn_impl, remat, model_overrides)
    else:
        batch, mc = build_data(step_dtype, n_points, batch_size, config, attention_impl,
                               ffn_impl, remat, model_overrides)
    cfg = Config(
        optim=OptimConfig(flat_params=flat_params),
        data=DataConfig(synthetic=config, batch_size=batch_size, packed=packed,
                        pack_chunk=pack_chunk),
        train=TrainConfig(epochs=1),
    )
    state = Trainer(cfg, mc, samples, samples, device=device)
    state.initialize()
    return train_step, state, batch, mc


def _params(state) -> list[torch.Tensor]:
    return state.optimizer.param_groups[0]["params"]


def _hard_sync(state, loss) -> None:
    """Wait for the device with real device-to-host reads: the loss, and
    ONE parameter element sliced on the device (with ``--flat_params`` the
    first parameter is the whole flat buffer, which is never fetched)."""
    loss.item()
    _params(state)[0].detach().reshape(-1)[:1].item()


def _snapshot(state) -> dict:
    """A device-side copy of the trainer's weights, AdamW state and step
    count (``Trainer.state_dict``, every tensor cloned)."""
    return copy.deepcopy(state.state_dict())


def _restore(state, snapshot: dict) -> None:
    """Load ``_snapshot``'s state back and wait for the copies, so no
    restore is left queued in front of a timed window. The weights are
    written in place, which moves their versions: the FFN kernel's packed
    weight images are made again on the next forward."""
    state.load_state_dict(snapshot)
    _params(state)[0].detach().reshape(-1)[:1].item()


def _window(step, state, batch, lr: float, k: int):
    """``k`` steps with no host read between them; the last step's loss."""
    for _ in range(k):
        state, loss = step(state, batch, lr)
    return loss


def time_scan_marginal(
    step, state, batch, lr, device, k1: int, k2: int, repeats: int,
    max_retries: int = 3,
) -> float:
    """Marginal seconds a step from windows of two lengths:
    ``(T(k2) - T(k1)) / (k2 - k1)``. A constant cost per window (the last
    host read, the first launches) cancels in the difference; each window
    is best-of-``repeats`` (stalls only ever add time) and starts from the
    state ``state`` held on entry, which it holds again on return. An
    error in a window retries it up to ``max_retries`` times before the
    last one propagates. The host's launches of every step fall inside
    the marginal (``SCAN_MARGINAL_NOTE``)."""
    if k2 <= k1:
        raise ValueError(f"need k2 > k1, got k1={k1} k2={k2}")
    dbatch = batch.to(device)
    start = _snapshot(state)
    t = {}
    try:
        for k in (k1, k2):
            best = float("inf")
            for w in range(max(1, repeats)):
                for attempt in range(max_retries):
                    try:
                        _restore(state, start)
                        if w == 0:
                            # Warm this K outside the timed region: the
                            # kernels' first launches, the allocator.
                            _hard_sync(state, _window(step, state, dbatch, lr, k))
                            _restore(state, start)
                        t0 = time.perf_counter()
                        loss = _window(step, state, dbatch, lr, k)
                        _hard_sync(state, loss)
                        best = min(best, time.perf_counter() - t0)
                        break
                    except Exception:
                        if attempt == max_retries - 1:
                            raise
            t[k] = best
    finally:
        _restore(state, start)
    if t[k2] <= t[k1]:
        # Timing noise swallowed the marginal (workload too small for
        # the window sizes): a non-positive estimate would make
        # points/sec, achieved TFLOP/s and MFU negative or infinite.
        raise RuntimeError(
            f"scan-marginal degenerate: T(k2={k2})={t[k2]:.4f}s <= "
            f"T(k1={k1})={t[k1]:.4f}s — increase --k2/--repeats or use "
            "--timing persstep for this workload"
        )
    return (t[k2] - t[k1]) / (k2 - k1)


def time_steps(
    step, state, batch, lr, n_warmup: int, n_steps: int, device,
    repeats: int = 1,
) -> float:
    """Per-step loop: seconds a step, best of ``repeats`` timed windows of
    ``n_steps``, each from the state ``state`` held on entry (held again on
    return) after ``n_warmup`` warm-up steps in the first window and one in
    the others."""
    dbatch = batch.to(device)
    start = _snapshot(state)
    best = float("inf")
    try:
        for i in range(max(1, repeats)):
            _restore(state, start)
            for _ in range(max(1, n_warmup) if i == 0 else 1):
                state, loss = step(state, dbatch, lr)
            _hard_sync(state, loss)
            t0 = time.perf_counter()
            for _ in range(n_steps):
                state, loss = step(state, dbatch, lr)
            _hard_sync(state, loss)
            best = min(best, (time.perf_counter() - t0) / n_steps)
    finally:
        _restore(state, start)
    return best


def step_flops(step, state, batch, lr) -> float | None:
    """Products of one training step, as ``FlopCounterMode`` counts them,
    with every gated FFN on the ``xla`` path (the counter cannot see the
    FFN kernel's launch, so both paths report this count). The step runs
    on ``state``, which is put back afterwards, weights, AdamW state and
    FFN paths alike. ``None`` if the count fails, as in the JAX bench."""
    from torch.utils.flop_counter import FlopCounterMode

    from gnot_tpu_torch.models.layers import GatedExpertFfn

    try:
        start = _snapshot(state)
        ffns = [m for m in state.model.modules() if isinstance(m, GatedExpertFfn)]
        impls = [m.ffn_impl for m in ffns]
        try:
            for m in ffns:
                m.ffn_impl = "xla"
            with FlopCounterMode(display=False) as counter:
                state, loss = step(state, batch.to(state.device), lr)
            _hard_sync(state, loss)
            return float(counter.get_total_flops())
        finally:
            for m, impl in zip(ffns, impls):
                m.ffn_impl = impl
            _restore(state, start)
    except Exception:
        return None


def device_kind(device) -> str:
    """``torch.cuda.get_device_name`` of a card, ``"cpu"`` for the CPU."""
    device = torch.device(device)
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def peak_flops(kind: str, dtype: str) -> float | None:
    """``PEAK_FLOPS``' entry for the device named ``kind``
    (``device_kind``) at ``dtype``; ``None``, with a notice on stderr, for
    any device the table does not name. No peak is guessed."""
    for (prefix, dt), peak in PEAK_FLOPS.items():
        if kind.startswith(prefix) and dt == dtype:
            return peak
    print(
        f"bench: no peak-FLOPs entry for device_kind={kind!r} dtype={dtype!r}"
        " — mfu will be null (extend PEAK_FLOPS to enable it)",
        file=sys.stderr,
    )
    return None


def mem_stats(device) -> dict:
    """The JAX bench's ``--mem_stats`` keys from torch's allocator:
    ``max_memory_allocated`` since the reset before the timed windows, and
    ``memory_allocated``, on a card. A key the
    port cannot fill (``largest_alloc_size`` always; all three on the
    CPU) is ``None``, and stderr names it."""
    device = torch.device(device)
    mem = dict.fromkeys(MEM_KEYS)
    if device.type == "cuda":
        mem["peak_bytes_in_use"] = torch.cuda.max_memory_allocated(device)
        mem["bytes_in_use"] = torch.cuda.memory_allocated(device)
    missing = [k for k, v in mem.items() if v is None]
    if missing:
        print(f"bench: torch's allocator on {device} does not give {missing}: null",
              file=sys.stderr)
    return mem


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Mesh points a second of the port's train step.")
    p.add_argument(
        "--timing", type=str, default="auto",
        choices=["auto", "scan_marginal", "persstep"],
        help="auto: scan_marginal on the card, persstep on the CPU"
    )
    p.add_argument("--k1", type=int, default=25, help="short window (steps)")
    p.add_argument("--k2", type=int, default=100, help="long window (steps)")
    p.add_argument("--steps", type=int, default=20, help="persstep window size")
    p.add_argument(
        "--repeats", type=int, default=3,
        help="timed repetitions per window; the reported value uses the "
             "best (stalls only ever subtract from measured throughput)"
    )
    p.add_argument("--warmup", type=int, default=3)
    p.add_argument(
        "--cpu_steps", type=int, default=10,
        help="baseline-divisor sample size (0 skips the baseline run)"
    )
    p.add_argument(
        "--baseline", type=str, default="jax", choices=["jax", "torch"],
        help="divisor for vs_baseline: this framework's step on the host "
             "CPU (jax); torch (the reference's eager step) is not ported"
    )
    p.add_argument("--dtype", type=str, default="bfloat16", choices=["float32", "bfloat16"])
    p.add_argument("--attention_impl", type=str, default="xla", choices=["xla"])
    p.add_argument("--ffn_impl", type=str, default="xla", choices=["xla", "pallas"])
    p.add_argument("--n_points", type=int, default=1024)
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument(
        "--config", type=str, default="ns2d",
        choices=["ns2d", "darcy2d", "elasticity", "inductor2d", "heatsink3d"],
        help="benchmark config; the headline metric is ns2d"
    )
    p.add_argument("--remat", action="store_true", help="rematerialized backward")
    p.add_argument(
        "--flat_params", action="store_true",
        help="flat parameter/optimizer layout (one buffer, one AdamW update)"
    )
    p.add_argument(
        "--packed", action="store_true",
        help="packed ragged batching ('pack, don't pad' — multiple "
             "samples per row as chunk-aligned segments)"
    )
    p.add_argument("--pack_chunk", type=int, default=128,
                   help="packed segment alignment (tokens)")
    p.add_argument(
        "--mem_stats", action="store_true",
        help="also print the device's peak-memory stats as JSON on stderr "
             "(keeps the stdout one-line contract)"
    )
    p.add_argument(
        "--metrics_path", type=str, default="",
        help="also append the result record to this JSONL file in the "
             "trainer's MetricsSink schema (plus a run.json manifest "
             "next to it)"
    )
    p.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                   help="where the step runs; cuda raises without a card")
    return p


def main(argv=None) -> dict:
    """Run the bench, print its one JSON line and return it as a dict."""
    from gnot_tpu_torch.config import NotPortedError
    from gnot_tpu_torch.device import resolve_device

    p = build_parser()
    args = p.parse_args(argv)
    if args.baseline == "torch":
        raise NotPortedError(
            "--baseline torch times the reference implementation's own eager "
            "step, imported from the reference checkout that GNOT_REFERENCE_PATH "
            "names (gnot_tpu/interop/torch_oracle.py); that checkout is not part "
            "of this repository and the port has no copy of it: use --baseline jax"
        )
    lr = 1e-3
    accel = resolve_device(args.device)
    timing = args.timing
    if timing == "auto":
        timing = "persstep" if accel.type == "cpu" else "scan_marginal"

    step, state, batch, _ = build(
        args.dtype, args.attention_impl, args.n_points, args.batch_size,
        args.ffn_impl, args.config, args.remat, args.flat_params,
        packed=args.packed, pack_chunk=args.pack_chunk, device=args.device,
    )
    if accel.type == "cuda":
        torch.cuda.reset_peak_memory_stats(accel)
    if timing == "scan_marginal":
        print(SCAN_MARGINAL_NOTE, file=sys.stderr)
        sec_per_step = time_scan_marginal(
            step, state, batch, lr, accel, args.k1, args.k2, args.repeats
        )
    else:
        sec_per_step = time_steps(
            step, state, batch, lr, args.warmup, args.steps, accel,
            repeats=args.repeats,
        )
    value = batch.n_real_points / sec_per_step
    # Read before the flop count's step, which runs the xla FFN path.
    mem = mem_stats(accel) if args.mem_stats else None

    flops = step_flops(step, state, batch, lr)
    achieved = flops / sec_per_step if flops else None
    peak = peak_flops(device_kind(accel), args.dtype)
    mfu = achieved / peak if (achieved and peak) else None

    if mem is not None:
        print(json.dumps(mem), file=sys.stderr)
    del state

    if accel.type == "cpu" or args.cpu_steps == 0:
        vs_baseline = 1.0
    else:
        # The f32 step on the host CPU at the SAME workload, best-of-N as
        # the card's, so vs_baseline is a hardware ratio.
        step_c, state_c, batch_c, _ = build(
            "float32", "xla", args.n_points, args.batch_size, config=args.config,
            device="cpu",
        )
        cpu_sec = time_steps(
            step_c, state_c, batch_c, lr, 1, args.cpu_steps, "cpu",
            repeats=args.repeats,
        )
        vs_baseline = value / (batch_c.n_real_points / cpu_sec)

    result = {
        "metric": f"{args.config}_mesh_points_per_sec_per_chip",
        "value": round(value, 1),
        "unit": "points/sec/chip",
        "vs_baseline": round(vs_baseline, 3),
        "ms_per_step": round(sec_per_step * 1e3, 4),
        "flops_per_step": flops,
        "achieved_tflops": round(achieved / 1e12, 2) if achieved else None,
        "mfu": round(mfu, 4) if mfu is not None else None,
        "timing": timing,
        "dtype": args.dtype,
    }
    print(json.dumps(result), flush=True)
    if args.metrics_path:
        # The trainer's JSONL schema and writer plus a run.json manifest,
        # so one report tool reads bench and training runs.
        from gnot_tpu_torch.obs import manifest as manifest_lib
        from gnot_tpu_torch.utils.metrics import MetricsSink

        with MetricsSink(args.metrics_path) as sink:
            sink.log(kind="bench", **result)
        manifest_lib.write_manifest(
            manifest_lib.manifest_path_for(args.metrics_path),
            config=vars(args),
            device=accel,
            argv=sys.argv[1:] if argv is None else list(argv),
            extra={"metrics_path": args.metrics_path, "kind": "bench"},
        )
    return result


if __name__ == "__main__":
    main()
