"""A training cell: ``Trainer.train_step`` on a fresh batch each step.

Set-up builds one ``Trainer`` as ``main`` does (AdamW, rel-L2, the cell's
model configuration, the training set shuffled every epoch), gives its
model the harness's weights, and drives it through its first steps with
the window's own call and feed (the trainer's ``Loader`` over the seeded
pool, in the order the loader draws from the seed): the first three are
the steps the reference follows afterwards, on the meshes the loader's
own draw names, and the steps go on until every batch shape of the first
epoch has run once. The window then runs steps for ``seconds`` and ends
in ``torch.cuda.synchronize()``.

Compared once the window has closed, the peak read and the program's
state freed, against the plain reference (``benchmark/reference``) in
float32 with TF32 off, from the same weights on the same three batches:

* ``loss_gap``: each of the three steps' loss, the worst relative gap;
* ``grad_gap``: each leaf's first gradient as AdamW got it (its first
  moment after one step over ``1 - b1``), the worst leaf's gap of norms;
* ``change_gap_median``: each leaf's change over the three steps, the
  median leaf's gap of norms, leaving out leaves whose reference gradient
  is under a thousandth of the median leaf's (``common.norm_gaps``). The
  worst leaf's gap is kept in the detail: AdamW moves every entry by
  about its rate whatever the gradient's size, so a leaf with entries
  whose gradient is rounding alone reads a gap of float32 itself.
"""

from __future__ import annotations

import math
import statistics
import time

from benchmark import common, costs, devtrace, meshes
from benchmark.reference import gnot as ref

CHECKED_STEPS = 3
#: A traced run profiles the window's last this many seconds.
SLICE_S = 3.0


def _trainer(cell, samples, seed: int, device):
    from gnot_tpu_torch.config import Config, DataConfig, ModelConfig, OptimConfig, TrainConfig
    from gnot_tpu_torch.train.trainer import Trainer

    optim = cell.config["optim"]
    config = Config(
        optim=OptimConfig(lr=optim["lr"], b1=optim["b1"], b2=optim["b2"], eps=optim["eps"],
                          weight_decay=optim["weight_decay"]),
        data=DataConfig(batch_size=cell.traffic["batch"], shuffle_train=True,
                        n_train=len(samples), n_test=0, seed=common.seed_of(seed)),
        train=TrainConfig(epochs=1, loss="rel_l2", seed=common.seed_of(seed)),
    )
    return Trainer(config, ModelConfig(**cell.config["model"]), samples, [], device=device)


def _feed(loader):
    """The loader's batches, epoch after epoch."""
    while True:
        yield from loader


def drawn(loader, steps: int) -> list:
    """The sample indices of the loader's first ``steps`` batches, epoch
    after epoch, as its own draw gives them; leaves it at epoch 0."""
    out, epoch = [], 0
    while len(out) < steps:
        loader.set_epoch(epoch)
        out += loader.epoch_indices()
        epoch += 1
    loader.set_epoch(0)
    return out[:steps]


def _sizes(b) -> list[tuple[int, int]]:
    """Each row's real points and its first input function's real points."""
    nodes = b.node_mask.sum(1).tolist()
    funcs = b.func_mask[0].sum(1).tolist() if b.func_mask is not None else [0] * len(nodes)
    return [(int(n), int(f)) for n, f in zip(nodes, funcs)]


def prepare(cell, seed: int, device) -> dict:
    """Set-up: the trainer with the harness's weights, driven through the
    checked steps and until every batch shape of the first epoch has run. Returns
    the state the window goes on with and the program's readings."""
    import torch

    from gnot_tpu_torch.data.batch import MeshSample

    model_cfg, optim = cell.config["model"], cell.config["optim"]
    pool = meshes.pool(cell.config["data"], cell.traffic["pool"], seed)
    samples = [MeshSample(coords=m.coords, y=m.y, theta=m.theta, funcs=m.funcs) for m in pool]
    trainer = _trainer(cell, samples, seed, device)
    weights = common.make_weights(model_cfg, seed, device)
    common.load_weights(trainer.model, weights)
    trainer.initialize()
    named = dict(trainer.model.named_parameters())

    # The shapes of the first epoch's batches, and the meshes of the
    # checked steps.
    loader = trainer.train_loader
    shapes = {loader.collate_at(idx).signature() for idx in drawn(loader, len(loader))}
    checked_idx = drawn(loader, CHECKED_STEPS)
    checked_meshes = [[pool[i] for i in idx] for idx in checked_idx]

    it = _feed(loader)
    seen, step, checked = set(), 0, []
    while step < CHECKED_STEPS or not shapes <= seen:
        b = next(it)
        seen.add(b.signature())
        loss = trainer.train_step(b, optim["lr"])
        if step < CHECKED_STEPS:
            want = [(m.coords.shape[0], m.funcs[0].shape[0] if m.funcs else 0)
                    for m in checked_meshes[step]]
            if _sizes(b) != want:
                raise RuntimeError(f"step {step}: the loader fed {_sizes(b)}, its draw names {want}")
            checked.append(loss)
        if step == 0:
            # What AdamW got: its first moment over (1 - b1); none if it
            # took no step.
            state = trainer.optimizer.state
            first = {k: (state[p]["exp_avg"] / (1.0 - optim["b1"])).norm()
                     if "exp_avg" in state.get(p, {}) else torch.zeros(())
                     for k, p in named.items()}
        if step == CHECKED_STEPS - 1:
            change = {k: (p.detach() - weights[k]).norm() for k, p in named.items()}
        step += 1
    prog = {
        "losses": [float(x) for x in checked],
        "first": {k: float(v) for k, v in first.items()},
        "change": {k: float(v) for k, v in change.items()},
    }
    return {"trainer": trainer, "feed": it, "weights": weights, "prog": prog,
            "checked": checked_meshes}


def run(cell, seed: int, seconds: float, trace: bool, device, setup_clock) -> dict:
    import torch

    optim = cell.config["optim"]
    st = prepare(cell, seed, device)
    trainer, it, lr = st["trainer"], st["feed"], optim["lr"]
    common.sync(device)
    setup_s = setup_clock()

    # The window. A traced run profiles its last SLICE_S seconds, from a
    # sync on: the profiler's start and stop hold the host for seconds, so
    # the window's rates per layer are read over the steps before it.
    steps = []  # (loss, each row's real sizes, padded points)
    step_rows = []  # FFN rows of each step
    tracer = devtrace.Slice() if trace else None
    slice_at = seconds - min(SLICE_S, seconds / 4)
    slice_steps, t_slice = [], None
    t0 = time.perf_counter()
    while True:
        now = time.perf_counter()
        if now - t0 >= seconds:
            break
        if tracer is not None and t_slice is None and now - t0 >= slice_at:
            common.sync(device)
            t_slice = time.perf_counter()
            tracer.start()
        i = len(steps)
        with common.span(trace, "bench.next_batch"):
            b = next(it)
        with common.span(trace, f"bench.step.{i}"):
            loss = trainer.train_step(b, lr)
        if t_slice is not None:
            slice_steps.append(i)
        step_rows.append(b.coords.shape[0] * b.coords.shape[1])
        steps.append((loss, _sizes(b), b.node_mask.numel()))
    common.sync(device)
    window_s = time.perf_counter() - t0
    data = None
    if t_slice is not None:
        tracer.stop()
        data = tracer.read()
    it.close()
    losses = torch.stack([s[0] for s in steps]).float().cpu()
    peak = common.peak_bytes(device)
    real = sum(n for s in steps for n, _ in s[1])
    padded = sum(s[2] for s in steps)
    n_rate = slice_steps[0] if slice_steps else len(steps)
    # Forward products of the real points of the steps before the slice.
    flops_real = float(sum(costs.mesh_flops(cell.config["model"], n, f)
                           for s in steps[:n_rate] for n, f in s[1]))
    del trainer, it, st["trainer"], st["feed"], steps, b, loss
    common.release(device)

    # The reference, on the same weights and the three checked batches.
    reference = ref_readings(cell, st["weights"], st["checked"], device)
    numbers, worst = compare(st["prog"], reference)

    ctx = {
        "kind": "train", "config": cell.config, "traffic": cell.traffic, "window_s": window_s,
        "steps": len(losses), "real_points": real, "padded_points": padded,
        # The steps before the slice, and their seconds.
        "forward_flops_real": flops_real,
        "rate_s": t_slice - t0 if t_slice is not None else window_s,
        "trace": data, "slice_steps": slice_steps, "step_rows": step_rows,
    }
    return {
        "values": {
            "train_points_per_s": real / window_s,
            "peak_mem_gib": peak / 2**30,
            "setup_s": setup_s,
        },
        "attempted": len(losses),
        "failed": int((~torch.isfinite(losses)).sum()),
        "numbers": numbers,
        "detail": worst,
        "memory_peak_bytes": peak,
        "ctx": ctx,
    }


def ref_readings(cell, weights: dict, batches, device, *, tf32: bool = False) -> dict:
    """The reference's three steps from ``weights`` on ``batches``: each
    step's loss, each leaf's first-gradient norm and change norm (``tf32``
    puts the reference's products in TF32)."""
    model_cfg = cell.config["model"]
    with ref.precision(tf32):
        losses, first, change = ref.train_steps(weights, model_cfg, cell.config["optim"],
                                                batches, device)
    out = {"losses": losses, "first": {k: float(v.norm()) for k, v in first.items()},
           "change": {k: float(v.norm()) for k, v in change.items()}}
    del first, change
    common.release(device)
    return out


def compare(prog: dict, reference: dict) -> tuple[dict, dict]:
    """``loss_gap``, ``grad_gap`` and ``change_gap_median`` of the readings
    ``prog`` against the reference's (a non-finite gap reads infinite)."""
    ref_first = reference["first"]
    med = statistics.median(ref_first.values())
    moved = [k for k, v in ref_first.items() if v >= 1e-3 * med]
    loss_gap = max(abs(p - r) / abs(r) if r else math.inf
                   for p, r in zip(prog["losses"], reference["losses"]))
    grads = common.norm_gaps(prog["first"], ref_first)
    changes = common.norm_gaps(prog["change"], reference["change"], moved)
    grad_at, change_at = max(grads, key=grads.get), max(changes, key=changes.get)
    finite = all(math.isfinite(v) for v in [*grads.values(), *changes.values()])
    numbers = {"loss_gap": loss_gap,
               "grad_gap": grads[grad_at] if finite else math.inf,
               "change_gap_median": statistics.median(changes.values()) if finite else math.inf}
    detail = {"grad_gap_leaf": grad_at, "change_gap_worst": changes[change_at],
              "change_gap_worst_leaf": change_at,
              "left_out": sorted(set(ref_first) - set(moved)),
              "ref_losses": reference["losses"], "prog_losses": prog["losses"]}
    return numbers, detail
