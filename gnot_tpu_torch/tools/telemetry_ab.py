"""Telemetry-overhead A/B: train step time with telemetry OFF vs ON.

Port of ``tools/telemetry_ab.py``, with its flags, functions, records and
summary (plus ``--device``: ``cuda`` unless ``--device cpu`` is passed;
without a card ``cuda`` raises). The JAX package's bar for the telemetry
subsystem (docs/observability.md) is <2% step-time regression at
``log_every=10`` on the ns2d micro-bench; the tool reports it and asserts
nothing. Both arms run the trainer's real step,
``Trainer.train_step``: the ON arm asks it for the step's telemetry (the
gate stats, the grad / update / param norms and the padding waste, device
scalars) and feeds a live ``TelemetryBuffer`` draining into a real
``MetricsSink`` every ``log_every`` steps, so the measured cost includes
the extra reductions, the buffered device-tensor bookkeeping, the one
device-to-host copy a drain and the JSONL writes.

Each timed window starts from the trainer's state on entry (a device copy
of the weights and AdamW state written back in place, outside the window,
as ``gnot_tpu_torch/bench.py`` restores), runs one warm-up step outside
the window and ends in a hard fetch (a host read of the last loss and of
one parameter element, which waits for the card). Windows are best-of-N
and interleaved off/on, so ambient load drift hits both arms alike.

Usage::

    python -m gnot_tpu_torch.tools.telemetry_ab --steps 60 --repeats 3 \
        --out build/telemetry_overhead_ab.jsonl
    python -m gnot_tpu_torch.tools.telemetry_ab --device cpu --n_points 64 --steps 2

Emits one JSONL record per arm plus a summary record with
``overhead_frac``, to stdout and to ``--out`` when it is given.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

#: The micro-bench architecture: the reference shape at half width and
#: depth, so a CPU arm finishes in seconds while the norms and gate stats
#: keep a realistic relative cost.
MICRO_ARCH = dict(
    n_attn_layers=2, n_attn_hidden_dim=128, n_mlp_num_layers=2,
    n_mlp_hidden_dim=128, n_input_hidden_dim=128, n_expert=3, n_head=4,
)


def platform_name(device: str) -> str:
    """JAX's platform names: ``"gpu"`` for a CUDA card, ``"cpu"``."""
    return "gpu" if device == "cuda" else "cpu"


def plain_step(state, batch, lr):
    """The trainer's step on a host batch: ``(state, loss)``."""
    return state, state.train_step(batch, lr)


def instrumented_step(state, batch, lr):
    """The trainer's step asked for its telemetry: ``(state, (loss,
    telem))``, ``telem`` the step's dict of device scalars."""
    telem: dict = {}
    loss = state.train_step(batch, lr, telem)
    return state, (loss, telem)


def build(telemetry: bool, n_points: int, batch_size: int, *, device: str = "cuda",
          model_kwargs: dict | None = None):
    """``(step, state, batch)``: ``state`` a ``Trainer`` on ``device`` with
    its optimizer (weights from seed 0) on NS2d samples of ``n_points``
    points, ``batch`` the first host batch, ``step`` ``instrumented_step``
    with ``telemetry`` and ``plain_step`` without (the trainer updates in
    place, so either step runs on either build). ``model_kwargs`` are
    ``ModelConfig`` fields in place of ``MICRO_ARCH`` (``{}``: the
    reference-default architecture)."""
    from gnot_tpu_torch.config import Config, DataConfig, ModelConfig, OptimConfig, TrainConfig
    from gnot_tpu_torch.data import datasets
    from gnot_tpu_torch.data.batch import Loader
    from gnot_tpu_torch.train.trainer import Trainer

    samples = datasets.synth_ns2d(batch_size, n_points=n_points, seed=0)
    loader = Loader(samples, batch_size)
    batch = loader.collate_at(loader.epoch_indices()[0])  # its first batch, no prefetch thread
    arch = MICRO_ARCH if model_kwargs is None else model_kwargs
    mc = ModelConfig(**arch, **datasets.infer_model_dims(samples))
    cfg = Config(
        optim=OptimConfig(),
        data=DataConfig(synthetic="ns2d", batch_size=batch_size),
        train=TrainConfig(epochs=1),
    )
    state = Trainer(cfg, mc, samples, samples, device=device)
    state.initialize()
    return (instrumented_step if telemetry else plain_step), state, batch


def restorer(state):
    """JAX's ``copy_tree`` for a trainer that updates in place: a device
    copy of ``state``'s weights, AdamW state and step count now, and a
    function that writes it back and returns ``state`` (waiting for the
    copies, so no restore is left queued in front of a timed window)."""
    from gnot_tpu_torch import bench

    snapshot = bench._snapshot(state)

    def restore(state0):
        bench._restore(state0, snapshot)
        return state0

    return restore


def hard_fetch(state, loss) -> None:
    """``np.asarray(loss)`` of JAX's window: host reads that wait for the
    card to finish the last step, its optimizer update included."""
    from gnot_tpu_torch import bench

    bench._hard_sync(state, loss)


def _window(step, state0, batch, telemetry: bool, steps: int, log_every: int,
            copy_tree, lr) -> float:
    """One timed window of ``steps`` steps; the ON arm runs the full
    buffer+sink hot path. ``copy_tree(state0)`` (``restorer``) puts the
    trainer back to its start state; it and the warm-up step run outside
    the window. Returns seconds a step."""
    from gnot_tpu_torch.obs.telemetry import TelemetryBuffer
    from gnot_tpu_torch.utils.metrics import MetricsSink

    state = copy_tree(state0)
    sink = buf = None
    if telemetry:
        sink = MetricsSink(os.path.join(tempfile.mkdtemp(), "telemetry_ab.jsonl"))
        buf = TelemetryBuffer(sink, log_every)

    def one(state, i):
        if telemetry:
            state, (loss, telem) = step(state, batch, lr)
            buf.append(steps=[i], epoch=0, lrs=[1e-3], loss=loss,
                       telem=telem, batches=[batch])
        else:
            state, loss = step(state, batch, lr)
        return state, loss

    state, loss = one(state, 0)
    hard_fetch(state, loss)
    t0 = time.perf_counter()
    for i in range(1, steps + 1):
        state, loss = one(state, i)
    if buf is not None:
        buf.drain()
    hard_fetch(state, loss)  # the window ends when the card does
    sec = (time.perf_counter() - t0) / steps
    if sink is not None:
        sink.close()
    return sec


def time_ab(n_points: int, batch_size: int, steps: int, log_every: int,
            repeats: int, device: str = "cuda") -> tuple[float, float]:
    """Best-of-``repeats`` seconds/step for (off, on), with the arms'
    timed windows INTERLEAVED off/on/off/on: ambient machine-load drift
    over the minutes the A/B takes hits both arms alike instead of
    whichever ran second. Both arms run one trainer (JAX builds a state
    for each), put back to its start state before every window."""
    _, state, batch = build(False, n_points, batch_size, device=device)
    copy_tree = restorer(state)
    lr = 1e-3
    best_off = best_on = float("inf")
    for _ in range(max(1, repeats)):
        best_off = min(
            best_off,
            _window(plain_step, state, batch, False, steps, log_every, copy_tree, lr),
        )
        best_on = min(
            best_on,
            _window(instrumented_step, state, batch, True, steps, log_every, copy_tree, lr),
        )
    return best_off, best_on


def main(argv=None) -> list[dict]:
    p = argparse.ArgumentParser(description="Train step ms, telemetry off against on.")
    p.add_argument("--n_points", type=int, default=512)
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--steps", type=int, default=60)
    p.add_argument("--log_every", type=int, default=10)
    p.add_argument("--repeats", type=int, default=3)
    p.add_argument("--out", type=str, default="")
    p.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                   help="where both arms run; cuda raises without a card")
    args = p.parse_args(argv)

    platform = platform_name(args.device)
    sec_off, sec_on = time_ab(
        args.n_points, args.batch_size, args.steps, args.log_every,
        args.repeats, args.device,
    )
    records = []
    for arm, sec in (("telemetry_off", sec_off), ("telemetry_on", sec_on)):
        records.append({
            "arm": arm, "ms_per_step": round(sec * 1e3, 4),
            "platform": platform, "n_points": args.n_points,
            "batch_size": args.batch_size, "steps": args.steps,
            "log_every": args.log_every, "repeats": args.repeats,
        })
    off, on = records[0]["ms_per_step"], records[1]["ms_per_step"]
    records.append({
        "summary": "telemetry_overhead", "config": "ns2d_micro",
        "ms_per_step_off": off, "ms_per_step_on": on,
        "overhead_frac": round(on / off - 1.0, 4),
        "bar": "overhead_frac < 0.02 at log_every=10",
    })
    write_records(records, args.out)
    return records


def write_records(records: list[dict], out: str) -> None:
    """The records as JSONL on stdout, and in ``out`` when it is given."""
    text = "\n".join(json.dumps(r) for r in records) + "\n"
    sys.stdout.write(text)
    sys.stdout.flush()
    if out:
        if d := os.path.dirname(out):
            os.makedirs(d, exist_ok=True)
        with open(out, "w") as f:
            f.write(text)


if __name__ == "__main__":
    main()
