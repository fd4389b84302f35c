"""Training loop: AdamW steps, per-epoch eval, best-metric checkpoints.

Port of the single-device branch of ``gnot_tpu/train/trainer.py``,
which reproduces the reference regime
(``main.py:50-153``): AdamW at torch's defaults, the OneCycle schedule
(with the per-epoch stepping bug by default, see schedule.py), rel-L2 as
train objective and eval metric, the reference's console lines, and
best-eval checkpoint selection.

As in the JAX loop, a step's loss stays a device tensor until the epoch
ends: the host syncs once per epoch for the train losses and once per
eval. The learning rate is written into the optimizer's param groups
before each step from ``lr_fn(host_step, epoch)``.

With ``ffn_impl="pallas"`` every forward of a train step and of eval runs
the fused gated-FFN kernel on the card; its backward recomputes the plain
version (``ops/fused_ffn.py``). The kernel reads each expert weight as a
packed image cached per tensor version, and ``torch.optim.AdamW`` updates
the weights in place, which moves their version: each update's first
forward repacks them.

With ``DataConfig(packed=True)`` (``--packed``) both loaders are
``PackedLoader``s and every train and eval step takes the packed forward
and the per-segment pooled loss (``PACKED_LOSSES``): the eval metric of a
dispatch is the mean over the samples it carries. In parity mode the loss
stays masked, as in the reference, which unpads before pooling.

With ``ModelConfig(dtype="bfloat16")`` (``--dtype bfloat16``) the model
computes its blocks in bf16 on its f32 weights, as the JAX trainer does:
the FFN kernel gets bf16 tokens with the f32 master weights and biases,
the rel-L2 loss reads the f32 output head, and the gradients, AdamW
state and checkpoints stay f32.

The rest of the JAX loop's single-device options:

* ``OptimConfig(grad_accum=k)``: ``optax.MultiSteps``. Each micro-step
  folds its gradient into a running mean, ``acc + (g - acc) / (n + 1)``;
  the k-th micro-step of a window clips the mean (when
  ``grad_clip_norm > 0``) and takes one AdamW update on it at its own
  learning rate; the others move neither the weights nor AdamW's moments
  and count, so the kernel's weight images are packed once per update.
  ``host_step`` counts micro-steps, as the JAX state's ``step``.
* ``TrainConfig(steps_per_dispatch=K)``: ``group_batches`` groups K
  same-shape batches, ``stack_batches`` stacks them in pinned memory, and
  ``multi_train_step`` / ``multi_eval_step`` run the K steps after one
  host-to-device copy with no host read between them. Eager PyTorch
  still launches every kernel of every step: what a group saves is K-1
  copies and the K-1 loss tensors' separate reads.
* ``OptimConfig(flat_params=True)``: ``FlatParams``. Every weight, and
  every gradient, is a view into one f32 buffer, so AdamW (and clipping,
  and the accumulation) runs over one tensor.
* ``ModelConfig(scan_layers=True)``: the stacked-layer layout
  (``parallel/pipeline.py::StackedGNOT``).

The observability plane (``gnot_tpu/train/trainer.py``'s hooks), each
piece off unless asked for:

* ``TrainConfig(telemetry=True)``: every micro-step also fills a dict of
  device scalars (``obs/telemetry.py``) that a ``TelemetryBuffer`` fetches
  once per ``log_every`` steps and at epoch end, and writes as step
  records; the slow-step gauge and the NaN watchdog read each drained
  window. Off, the step runs exactly the ops it ran before.
* ``log_every`` without telemetry: a ``{step, epoch, loss, lr}`` record
  every ``log_every`` steps, one host read of the loss each.
* a ``metrics_sink``: the per-epoch record, the events.
* a ``metrics_registry`` (``obs/metrics.py``) with telemetry on: the
  drain records each dispatch interval in ``train_step_time_ms`` and
  counts slow-step outliers in ``train_slow_steps_total``.
* a ``tracer`` (``obs/tracing.py``): one trace per epoch, an ``epoch``
  root with ``data_iter``, ``step`` (``host_to_device``,
  ``step_dispatch``), ``telemetry_drain``, ``eval`` and
  ``checkpoint_save`` spans.
* ``profile_dir``: a ``torch.profiler`` trace of epoch ``trace_at``.

Resilience (``gnot_tpu/train/trainer.py``'s harness, ``resilience/``):

* ``TrainConfig(inject_fault=...)``: the fault injector's hooks before
  each step (``sigterm``, ``nan_grad``, ``bad_sample``), in the
  checkpointer (``ckpt_io``, ``corrupt_ckpt``) and at epoch end
  (``stop_epoch``).
* ``TrainConfig(recovery=True)``: the ``RecoverySupervisor`` snapshots the
  whole train state on the device at each epoch's start and every
  ``snapshot_every`` steps, after checking the window's losses with one
  host read; a non-finite loss (found there, at epoch end, by the
  telemetry watchdog or by ``debug_checks``) rolls the state back,
  quarantines the dispatch and replays the epoch's order from the
  snapshot, within ``max_rollbacks``; then restores ``latest`` (else
  ``best``) and re-enters the epoch loop there; then aborts.
* ``TrainConfig(graceful_preempt=True)`` (the default): SIGTERM / SIGINT
  stop the run at the next step boundary, save ``latest`` at the current
  epoch (a resumed run replays the partial epoch), flush the sink.
* ``TrainConfig(debug_checks=True)``: every step's loss is read, and the
  first non-finite one raises at its step.

``standard_params()`` gives the weights in the standard layout whatever
the trainer holds; checkpoints keep the trainer's own layout, and
``convert_flat_state`` / ``pipeline.convert_state_layout`` move a whole
training state between layouts.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import logging
import math
import time
from typing import Callable, Iterable, Iterator, Mapping

import numpy as np
import torch

from gnot_tpu_torch.config import (
    Config,
    DataConfig,
    ModelConfig,
    OptimConfig,
    refuse_compositions,
)
from gnot_tpu_torch.data.batch import Loader, MeshBatch, PackedBatch, PackedLoader
from gnot_tpu_torch.device import resolve_device
from gnot_tpu_torch.models.gnot import GNOT, apply_batch
from gnot_tpu_torch.obs import events, health
from gnot_tpu_torch.obs import telemetry as obs_telemetry
from gnot_tpu_torch.ops.segment import LOSSES, PACKED_LOSSES
from gnot_tpu_torch.parallel.pipeline import (
    StackedGNOT,
    is_stacked,
    stack_params,
    unstack_params,
)
from gnot_tpu_torch.resilience.faults import FaultInjector
from gnot_tpu_torch.resilience.preemption import PreemptionHandler
from gnot_tpu_torch.resilience.supervisor import (
    NonFiniteLossError,
    PreemptionRequested,
    RecoverySupervisor,
    RestoreEscalation,
)
from gnot_tpu_torch.serve.engine import InferenceEngine
from gnot_tpu_torch.train.schedule import make_lr_fn
from gnot_tpu_torch.utils import profiling


def make_optimizer(cfg: OptimConfig, params: Iterable[torch.nn.Parameter]) -> torch.optim.AdamW:
    """``torch.optim.AdamW`` over every parameter with the JAX package's
    b1/b2/eps/weight_decay (``optax.adamw``: the same update, decay
    applied to all parameters). The learning rate is set per step.

    The foreach implementation, asked for by name: a few multi-tensor
    kernels per op over all the weights. ``fused=False`` alone would
    leave torch on its for-loop implementation, one kernel per op per
    weight (1,472 CUDA kernels an update at full width, 184 weights, on
    an H100; ``chip_smoke.py`` phase 10). Never the fused one: on the
    card it writes the weights without moving their version, so the FFN
    kernel's cached weight images would go stale
    (``tests/test_torch_cuda.py``); foreach moves it."""
    return torch.optim.AdamW(
        params, lr=cfg.lr, betas=(cfg.b1, cfg.b2), eps=cfg.eps,
        weight_decay=cfg.weight_decay, foreach=True, fused=False,
    )


@torch.no_grad()
def clip_by_global_norm_(grads: list[torch.Tensor], max_norm: float) -> None:
    """``optax.clip_by_global_norm`` in place: when the global norm ``n``
    of ``grads`` is at least ``max_norm``, each becomes ``(g / n) *
    max_norm``. (``torch.nn.utils.clip_grad_norm_`` scales by ``max_norm
    / (n + 1e-6)``, which gives other numbers.) No host sync."""
    g_norm = torch.sqrt(sum(torch.sum(torch.square(g)) for g in grads))
    keep = g_norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, (g / g_norm) * max_norm))


def batch_loss(model: GNOT, batch: MeshBatch | PackedBatch, loss_name: str,
               gates: dict | None = None) -> torch.Tensor:
    """Forward + per-graph pooled loss, always masked, parity mode
    included: the reference unpads before pooling (main.py:89). A
    ``PackedBatch`` pools per segment, the mean over the samples present
    in the dispatch (``packed_loss_fn``). ``gates`` collects the standard
    forward's gate stats (``GNOT.forward``)."""
    preds = apply_batch(model, batch, gates)
    if isinstance(batch, PackedBatch):
        return PACKED_LOSSES[loss_name](preds, batch.y, batch.node_mask, batch.node_seg,
                                        batch.n_seg)
    return LOSSES[loss_name](preds, batch.y, batch.node_mask)


def make_loaders(data: DataConfig, train_samples, test_samples, *, pin_memory: bool):
    """The train (shuffled) and test loaders of ``data``: ``PackedLoader``s
    with ``data.packed``, else ``Loader``s (an empty test split gets an
    empty ``Loader`` either way)."""
    if data.packed:
        train = PackedLoader(train_samples, data.batch_size, chunk=data.pack_chunk,
                             shuffle=data.shuffle_train, seed=data.seed,
                             pin_memory=pin_memory)
        test = (PackedLoader(test_samples, data.batch_size, chunk=data.pack_chunk,
                             pin_memory=pin_memory)
                if len(test_samples) else Loader([], data.batch_size))
        return train, test
    pads = dict(bucket=data.bucket, pad_nodes=data.pad_nodes, pad_funcs=data.pad_funcs,
                pin_memory=pin_memory)
    train = Loader(train_samples, data.batch_size, shuffle=data.shuffle_train,
                   seed=data.seed, drop_remainder=data.drop_remainder, **pads)
    return train, Loader(test_samples, data.batch_size, **pads)


def group_batches(batches, k: int) -> Iterator[tuple[str, object]]:
    """Same-shape batches in runs of ``k`` for one dispatch each: yields
    ``("group", [b1..bk])`` for full groups and ``("single", b)`` for the
    batches of a group a shape change cut short and for the remainder.
    The train and eval loops both iterate it; ``k < 2`` yields singles
    only. A copy of ``gnot_tpu/train/trainer.py::group_batches``."""
    if k < 2:
        for b in batches:
            yield "single", b
        return
    pending, key = [], None
    for b in batches:
        bk = b.signature()
        if pending and bk != key:
            # Shape change: the open group can stack no further.
            for p in pending:
                yield "single", p
            pending = []
        pending.append(b)
        key = bk
        if len(pending) == k:
            yield "group", pending
            pending = []
    for p in pending:  # remainder
        yield "single", p


def stack_batches(batches: list, *, pin_memory: bool = False):
    """Same-shape host batches stacked on a new leading step axis, into
    page-locked memory with ``pin_memory``: one host-to-device copy moves
    them all. ``n_seg`` (equal within a group) is kept."""
    first = batches[0]
    fields = {}
    for f in dataclasses.fields(first):
        value = getattr(first, f.name)
        if isinstance(value, torch.Tensor):
            out = torch.empty((len(batches), *value.shape), dtype=value.dtype,
                              pin_memory=pin_memory)
            fields[f.name] = torch.stack([getattr(b, f.name) for b in batches], out=out)
        else:
            fields[f.name] = value
    return type(first)(**fields)


def batch_at(stacked, i: int):
    """Batch ``i`` of a ``stack_batches`` result, as views."""
    return type(stacked)(**{
        f.name: v[i] if isinstance(v := getattr(stacked, f.name), torch.Tensor) else v
        for f in dataclasses.fields(stacked)
    })


# The flat layout's leaf alignment in f32 elements: 16 bytes, what the FFN
# kernel asks of every tensor it reads, biases included.
FLAT_ALIGN = 4


@dataclasses.dataclass(frozen=True)
class FlatLayout:
    """Where each weight lies in a flat buffer: leaf ``names[i]`` of shape
    ``shapes[i]`` at ``offsets[i]``, a multiple of ``FLAT_ALIGN``
    elements, with zeros between leaves. Unlike JAX's ``ravel_pytree``
    (leaves back to back, in sorted-name order) the leaves keep the
    template's order and every view is 16-byte aligned."""

    names: tuple[str, ...]
    shapes: tuple[tuple[int, ...], ...]
    offsets: tuple[int, ...]
    size: int

    @classmethod
    def of(cls, template: Mapping[str, torch.Tensor]) -> "FlatLayout":
        offsets, off = [], 0
        for t in template.values():
            offsets.append(off)
            off += -(-t.numel() // FLAT_ALIGN) * FLAT_ALIGN
        shapes = tuple(tuple(t.shape) for t in template.values())
        return cls(tuple(template), shapes, tuple(offsets), off)

    def views(self, flat: torch.Tensor) -> dict[str, torch.Tensor]:
        """Each leaf of ``flat`` as a view in its shape."""
        return {n: flat[o:o + math.prod(s)].view(s)
                for n, s, o in zip(self.names, self.shapes, self.offsets)}

    def flatten(self, tree: Mapping[str, torch.Tensor]) -> torch.Tensor:
        """The flat f32 buffer of a ``{name: tensor}`` map of these leaves."""
        if set(tree) != set(self.names):
            raise ValueError(
                f"the weights do not match the flat layout: extra "
                f"{sorted(set(tree) - set(self.names))}, missing "
                f"{sorted(set(self.names) - set(tree))}"
            )
        first = tree[self.names[0]]
        flat = torch.zeros(self.size, dtype=torch.float32, device=first.device)
        for name, view in self.views(flat).items():
            view.copy_(tree[name])
        return flat


class FlatParams:
    """A model's weights and gradients as views into one flat f32 buffer
    each (``FlatLayout``), in place of its own parameters.

    ``param`` is the buffer as one ``nn.Parameter`` with ``grad`` the
    gradient buffer: the optimizer takes ``[param]``. Every weight of the
    model becomes an ``nn.Parameter`` over its slice of the buffer, which
    shares the buffer's storage and version counter, so an optimizer's
    in-place write moves every weight's version and the FFN kernel
    repacks its images; its ``.grad`` is its slice of the gradient
    buffer, which autograd accumulates into in place. The gradient
    buffer is zeroed in place (``zero_grad``), never dropped: a weight
    whose ``.grad`` were set to None would no longer write the buffer.
    The padding between leaves gets a zero gradient and so stays zero
    through AdamW, weight decay and clipping."""

    def __init__(self, model: torch.nn.Module):
        named = dict(model.named_parameters())
        self.layout = FlatLayout.of(named)
        with torch.no_grad():
            buf = self.layout.flatten({n: p.detach() for n, p in named.items()})
        self.param = torch.nn.Parameter(buf)
        self.param.grad = torch.zeros_like(buf)
        grads = self.layout.views(self.param.grad)
        for name, view in self.layout.views(buf).items():
            owner, _, leaf = name.rpartition(".")
            weight = torch.nn.Parameter(view)
            weight.grad = grads[name]
            setattr(model.get_submodule(owner), leaf, weight)

    def zero_grad(self) -> None:
        self.param.grad.zero_()

    @torch.no_grad()
    def load(self, flat: torch.Tensor) -> None:
        if flat.shape != self.param.shape:
            raise ValueError(
                f"flat weights of {tuple(flat.shape)} do not fit the layout's "
                f"{tuple(self.param.shape)}"
            )
        self.param.copy_(flat)


def state_layout(state: dict) -> str:
    """The parameter layout of a trainer state: "flat", "stacked" or
    "standard"."""
    if "flat" in state["model"]:
        return "flat"
    return "stacked" if is_stacked(state["model"]) else "standard"


def map_param_state(state: dict, convert: Callable[[dict], dict]) -> dict:
    """A trainer state (``Trainer.state_dict()``) with ``convert``, a map of
    ``{name: tensor}`` dicts from one layout to another, applied to every
    part shaped like the weights: the weights, both AdamW moments and the
    gradient-accumulation mean. The optimizer's state is indexed by
    parameter order, which is the order of ``state["model"]``; AdamW's
    step count, equal across parameters, is carried over. The one
    traversal both layout converters share (``convert_flat_state``,
    ``pipeline.convert_state_layout``)."""
    names = list(state["model"])
    model = convert(state["model"])
    new_names = list(model)
    opt = state["optimizer"]
    if len(opt["param_groups"]) != 1:
        raise ValueError("a layout change takes an optimizer of one param group")
    per = opt["state"]
    new_per = {}
    if per:
        moments = {
            key: convert({n: per[i][key] for i, n in enumerate(names)})
            for key in ("exp_avg", "exp_avg_sq")
        }
        new_per = {
            j: {"step": per[0]["step"].clone(), **{k: m[n] for k, m in moments.items()}}
            for j, n in enumerate(new_names)
        }
    groups = [dict(opt["param_groups"][0], params=list(range(len(new_names))))]
    out = dict(state, model=model, optimizer={"state": new_per, "param_groups": groups})
    if "accum" in state:
        out["accum"] = dict(state["accum"], acc=convert(state["accum"]["acc"]))
    return out


def convert_flat_state(state: dict, template: Mapping[str, torch.Tensor], to: str) -> dict:
    """A trainer state moved between the flat layout and the standard one
    (``gnot_tpu/train/trainer.py::convert_flat_state``): the weights, both
    AdamW moments and the accumulation mean, so a ``--flat_params``
    checkpoint resumes in a standard run and back. ``template`` is a
    standard-layout ``{name: tensor}`` map (a ``GNOT`` state_dict) whose
    order fixes the flat layout. No-op when the state is already in the
    target layout."""
    if to not in ("flat", "tree"):
        raise ValueError(f"unknown layout {to!r} (want 'flat' or 'tree')")
    if (state_layout(state) == "flat") == (to == "flat"):
        return state
    layout = FlatLayout.of(template)
    if to == "flat":
        return map_param_state(state, lambda p: {"flat": layout.flatten(p)})
    return map_param_state(
        state, lambda p: {n: v.clone() for n, v in layout.views(p["flat"]).items()})


def standard_weights(
    weights: Mapping[str, torch.Tensor], template: Mapping[str, torch.Tensor], n_layers: int
) -> dict[str, torch.Tensor]:
    """A checkpoint's weights (``state["model"]``) of any layout in the
    standard one; ``template`` is a standard-layout map (a ``GNOT``
    state_dict) whose order fixes the flat layout."""
    if "flat" in weights:
        return FlatLayout.of(template).views(weights["flat"])
    return unstack_params(weights, n_layers) if is_stacked(weights) else dict(weights)


def serving_weights(
    state: dict, template: Mapping[str, torch.Tensor], n_layers: int, layout: str, name: str
) -> dict[str, torch.Tensor]:
    """A restored trainer state's weights in the standard layout, for a
    served model: the checkpoint's layout must be ``layout`` (the run's
    flags), else ValueError naming the flag to pass. ``name`` is the
    checkpoint the state came from; ``template`` and ``n_layers`` as in
    ``standard_weights``."""
    if state_layout(state) != layout:
        raise ValueError(
            f"the '{name}' checkpoint holds the {state_layout(state)} parameter "
            f"layout but this run uses the {layout} layout; pass the layout "
            "flag it was trained with (--flat_params, --scan_layers)"
        )
    return standard_weights(state["model"], template, n_layers)


@dataclasses.dataclass
class EpochRecord:
    """What one epoch produced, on the host."""

    epoch: int
    step_losses: np.ndarray  # [steps] float32
    train_loss: float
    test_metric: float


class Trainer:
    """One train/eval run (reference main.py:55-153) on one device."""

    def __init__(
        self,
        config: Config,
        model_cfg: ModelConfig,
        train_samples,
        test_samples,
        *,
        checkpointer=None,
        device: torch.device | str = "cuda",
        metrics_sink=None,
        tracer=None,
        metrics_registry=None,
    ):
        # First, so TF32 stays off before any weight reaches the card.
        self.device = resolve_device(str(device))
        self.config = config
        self.model_cfg = model_cfg
        self.checkpointer = checkpointer
        # utils.metrics.MetricsSink or None; obs.tracing.Tracer or None.
        # Every span is host-side, around the step, never inside it.
        self.metrics_sink = metrics_sink
        self._tracer = tracer
        # obs.metrics.MetricsRegistry or None: the telemetry drain's
        # train_step_time_ms and train_slow_steps_total series.
        self._metrics_registry = metrics_registry
        # The TelemetryBuffer of a telemetry run, made by fit().
        self._telemetry: obs_telemetry.TelemetryBuffer | None = None
        # The fault plan, parsed here so a bad spec fails at construction;
        # the recovery supervisor is made by fit() with recovery on.
        self._faults = FaultInjector.from_config(config.train)
        self._supervisor: RecoverySupervisor | None = None
        if checkpointer is not None:
            # One injector end to end (the ckpt_io budget is shared), and
            # the restore / retry events in the run's sink.
            if self._faults is not None and checkpointer.fault_injector is None:
                checkpointer.fault_injector = self._faults
            if checkpointer.on_event is None and metrics_sink is not None:
                checkpointer.on_event = metrics_sink.log
        # JAX's flat, packed and stacked layouts run an overridden forward
        # whose telemetry has no gate stats; the port gives the same keys.
        self._gate_telemetry = not (config.optim.flat_params or config.data.packed
                                    or model_cfg.scan_layers)
        refuse_compositions(config, model_cfg)
        # Batches for the card are page-locked on the prefetch thread, so
        # each step's copy neither blocks the host nor drains the stream.
        self.train_loader, self.test_loader = make_loaders(
            config.data, train_samples, test_samples, pin_memory=self.device.type == "cuda"
        )
        accum = config.optim.grad_accum
        if accum > 1 and len(self.train_loader) % accum:
            logging.getLogger(__name__).warning(
                "steps_per_epoch=%d is not divisible by grad_accum=%d: "
                "accumulation windows straddle epoch boundaries and the "
                "final partial window is discarded",
                len(self.train_loader),
                accum,
            )
        self.lr_fn = make_lr_fn(
            config.optim,
            steps_per_epoch=len(self.train_loader),
            epochs=config.train.epochs,
        )
        # Weights from train.seed through an explicit generator, as
        # serving draws them; the stacked layout draws the same weights
        # and stacks them.
        gen = torch.Generator().manual_seed(config.train.seed)
        model_cls = StackedGNOT if model_cfg.scan_layers else GNOT
        self.model = model_cls(model_cfg, generator=gen).to(self.device)
        self.flat = FlatParams(self.model) if config.optim.flat_params else None
        self.optimizer: torch.optim.AdamW | None = None
        # Gradient accumulation (grad_accum > 1): the window's running
        # mean gradient, one per optimizer tensor, and MultiSteps' counts.
        self.acc: list[torch.Tensor] | None = None
        self.mini_step = 0
        self.gradient_step = 0
        self.best_metric = float("inf")
        self.start_epoch = 0
        # Micro-steps taken so far (the JAX state's step counter).
        self.host_step = 0
        self.history: list[EpochRecord] = []

    def _opt_params(self) -> list[torch.nn.Parameter]:
        return [self.flat.param] if self.flat is not None else list(self.model.parameters())

    def initialize(self) -> None:
        """The optimizer over the model's weights (the flat buffer with
        ``flat_params``), the accumulation state, and on ``resume`` the
        latest checkpoint's state (else the best one's, walking each
        chain), ``host_step`` from its step count."""
        params = self._opt_params()
        self.optimizer = make_optimizer(self.config.optim, params)
        if self.config.optim.grad_accum > 1:
            self.acc = [torch.zeros_like(p) for p in params]
        if self.checkpointer is not None and self.config.train.resume:
            restored = self.checkpointer.restore_latest()
            if restored is not None:
                state, self.start_epoch, self.best_metric = restored
                self.load_state_dict(state)

    def _param_names(self) -> list[str]:
        return ["flat"] if self.flat is not None else [n for n, _ in self.model.named_parameters()]

    def state_dict(self) -> dict:
        """The training state a checkpoint holds, in the trainer's own
        layout: weights (``{"flat": buffer}`` with ``flat_params``), AdamW
        moments and step counts, the micro-step count, and with
        ``grad_accum > 1`` the accumulation mean and counts."""
        model = ({"flat": self.flat.param.detach()} if self.flat is not None
                 else self.model.state_dict())
        state = {"model": model, "optimizer": self.optimizer.state_dict(), "step": self.host_step}
        if self.acc is not None:
            state["accum"] = {
                "acc": dict(zip(self._param_names(), self.acc)),
                "mini_step": self.mini_step,
                "gradient_step": self.gradient_step,
            }
        return state

    def load_state_dict(self, state: dict) -> None:
        """Load a ``state_dict()`` of the same layout and accumulation; a
        state of another layout raises (``convert_flat_state`` /
        ``pipeline.convert_state_layout`` convert it first)."""
        layout = "flat" if self.flat is not None else (
            "stacked" if self.model_cfg.scan_layers else "standard")
        if state_layout(state) != layout:
            raise ValueError(
                f"the state is in the {state_layout(state)} parameter layout but this "
                f"trainer holds the {layout} layout"
            )
        if ("accum" in state) != (self.acc is not None):
            raise ValueError(
                f"the state {'holds' if 'accum' in state else 'lacks'} a gradient-"
                f"accumulation state but this run has grad_accum="
                f"{self.config.optim.grad_accum}"
            )
        if self.flat is not None:
            self.flat.load(state["model"]["flat"])
        else:
            self.model.load_state_dict(state["model"])
        # A copy: torch's optimizer would otherwise keep the given moment
        # tensors as its own and update them in place.
        self.optimizer.load_state_dict(copy.deepcopy(state["optimizer"]))
        self.host_step = int(state["step"])
        if self.acc is not None:
            accum = state["accum"]
            with torch.no_grad():
                for acc, name in zip(self.acc, self._param_names()):
                    acc.copy_(accum["acc"][name])
            self.mini_step = int(accum["mini_step"])
            self.gradient_step = int(accum["gradient_step"])

    def standard_params(self) -> dict[str, torch.Tensor]:
        """The weights in the standard ``block_{i}`` layout, whatever the
        trainer holds: what predict, export and serving read."""
        params = self.model.state_dict()
        if self.model_cfg.scan_layers:
            return unstack_params(params, self.model_cfg.n_attn_layers)
        return params

    def load_standard_params(self, params: Mapping[str, torch.Tensor]) -> None:
        """Load standard-layout weights (a ``GNOT`` state_dict) into the
        trainer's own layout."""
        if self.model_cfg.scan_layers:
            params = stack_params(params, self.model_cfg.n_attn_layers)
        self.model.load_state_dict(params)

    def standard_model(self) -> GNOT:
        """A ``GNOT`` holding the current weights: the trainer's own model
        in the standard and flat layouts, an unstacked copy in the stacked
        one."""
        if not self.model_cfg.scan_layers:
            return self.model
        with torch.device("meta"):
            model = GNOT(self.model_cfg)
        params = {k: v.clone() for k, v in self.standard_params().items()}
        model.load_state_dict(params, assign=True)
        return model

    def train_step(self, batch: MeshBatch, lr: float, telem: dict | None = None) -> torch.Tensor:
        """One micro-step on a host batch at learning rate ``lr``: with
        ``grad_accum`` 1 an AdamW update, else the gradient folded into the
        window's mean and, on the window's last micro-step, one update on
        the mean. Returns the loss as a device scalar; nothing waits for
        the card. A ``telem`` dict gets the step's telemetry."""
        return self._step(batch.to(self.device, non_blocking=True), lr, telem)

    def multi_train_step(self, batches, lrs: list[float], telem: dict | None = None) -> torch.Tensor:
        """``len(lrs)`` micro-steps over a ``stack_batches`` result, the
        i-th on batch i at ``lrs[i]``, after one host-to-device copy and
        with no host read between them. Returns their ``[K]`` losses as one
        device tensor. The same steps, in the same order, as K
        ``train_step`` calls (``make_multi_train_step``). A ``telem`` dict
        gets each telemetry key stacked over the K steps."""
        return self._multi_step(batches.to(self.device, non_blocking=True), lrs, telem)

    def _multi_step(self, device_batches, lrs: list[float], telem: dict | None) -> torch.Tensor:
        steps = [{} if telem is not None else None for _ in lrs]
        losses = torch.stack([self._step(batch_at(device_batches, i), lr, steps[i])
                              for i, lr in enumerate(lrs)])
        if telem is not None:
            telem.update({k: torch.stack([t[k] for t in steps]) for k in steps[0]})
        return losses

    def _step(self, batch, lr: float, telem: dict | None = None) -> torch.Tensor:
        """One micro-step on a device batch. A ``telem`` dict is filled
        with the step's telemetry (``obs/telemetry.py``), device scalars
        that read what the step holds and change none of it."""
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        if self.flat is not None:
            self.flat.zero_grad()
        else:
            self.optimizer.zero_grad(set_to_none=True)
        gates = {} if telem is not None and self._gate_telemetry else None
        loss = batch_loss(self.model, batch, self.config.train.loss, gates)
        loss.backward()
        if telem is None:
            self._update()
        else:
            params = self._opt_params()
            grad_norm = obs_telemetry.global_norm([p.grad for p in params])
            update_norm = self._update(measure=True)
            telem.update(obs_telemetry.instrument(gates, grad_norm, update_norm, params, batch))
        self.host_step += 1
        return loss.detach()

    @torch.no_grad()
    def _update(self, measure: bool = False) -> torch.Tensor | None:
        """The optimizer transform on this micro-step's gradients:
        ``optax.MultiSteps`` around clipping and AdamW, as the JAX
        ``make_optimizer`` chains them. With ``measure``, returns the
        global norm of the update it applied (0 on a micro-step that only
        accumulates)."""
        optim = self.config.optim
        params = self.optimizer.param_groups[0]["params"]
        grads = [p.grad for p in params]
        if self.acc is not None:
            delta = torch._foreach_sub(grads, self.acc)
            torch._foreach_div_(delta, self.mini_step + 1)
            torch._foreach_add_(self.acc, delta)
            if self.mini_step < optim.grad_accum - 1:
                self.mini_step += 1
                return torch.zeros((), device=self.device) if measure else None
            for g, acc in zip(grads, self.acc):
                g.copy_(acc)
        if optim.grad_clip_norm > 0:
            clip_by_global_norm_(grads, optim.grad_clip_norm)
        self.optimizer.step()
        if self.acc is not None:
            torch._foreach_zero_(self.acc)
            self.mini_step = 0
            self.gradient_step += 1
        return obs_telemetry.adamw_update_norm(self.optimizer) if measure else None

    @torch.no_grad()
    def eval_step(self, batch: MeshBatch) -> torch.Tensor:
        """The batch's eval metric as a device scalar."""
        return batch_loss(
            self.model, batch.to(self.device, non_blocking=True), self.config.train.loss
        )

    @torch.no_grad()
    def multi_eval_step(self, batches) -> torch.Tensor:
        """The ``[K]`` eval metrics of a ``stack_batches`` result, after
        one host-to-device copy (``make_multi_eval_step``)."""
        device_batches = batches.to(self.device, non_blocking=True)
        return torch.stack([
            batch_loss(self.model, batch_at(device_batches, i), self.config.train.loss)
            for i in range(device_batches.coords.shape[0])
        ])

    def _groups(self, loader):
        return group_batches(loader, self.config.train.steps_per_dispatch)

    def _stacked(self, group: list):
        return stack_batches(group, pin_memory=self.device.type == "cuda")

    def evaluate(self) -> float:
        """The mean of the per-batch metrics over the test set: a short
        last batch weighs like a full one, as in the JAX package. The test
        batches are grouped as the train loop groups its own."""
        if len(self.test_loader) == 0:
            return float("inf")
        metrics = [
            self.multi_eval_step(self._stacked(item)) if kind == "group"
            else self.eval_step(item).reshape(1)
            for kind, item in self._groups(self.test_loader)
        ]
        return float(np.mean(torch.cat(metrics).cpu().numpy()))  # the one host sync

    def _tspan(self, trace, name: str, **args):
        """One train-phase span under the epoch's trace; a null context
        when tracing is off or the epoch was sampled out."""
        if self._tracer is None or trace is None:
            return contextlib.nullcontext()
        return self._tracer.span(name, trace=trace, args=args or None)

    def run_epoch(self, epoch: int, trace_at: int = -1, preempt=None) -> EpochRecord:
        """One epoch: the train steps (``steps_per_dispatch`` at a time)
        under the recovery harness, the reference's console lines, eval,
        best-metric selection and the checkpoint saves; profiled when
        ``epoch == trace_at`` and ``profile_dir`` is set. With a tracer the
        epoch is one trace, head sampled here, under an ``epoch`` root
        span. ``preempt`` (a ``PreemptionHandler``) is read after every
        dispatch."""
        trace = self._tracer.start_trace() if self._tracer is not None else None
        with self._tspan(trace, "epoch", epoch=epoch):
            return self._run_epoch(epoch, trace_at, preempt, trace)

    def _run_epoch(self, epoch: int, trace_at: int, preempt, trace) -> EpochRecord:
        cfg = self.config
        t0 = time.perf_counter()
        losses, points = [], 0
        sup = self._supervisor
        quarantine: set[int] = set()
        resume_at = 0
        with profiling.trace_epoch(cfg.train.profile_dir, epoch, trace_at=trace_at):
            with profiling.annotate("train_epoch"):
                if sup is not None:
                    sup.begin_epoch(self.state_dict, host_step=self.host_step)
                while True:  # recovery attempts; one pass normally
                    # The shuffle order is a function of (seed, epoch), and
                    # iterating advances the loader's epoch: pin it on every
                    # attempt, so a rollback replays this epoch's order and
                    # the ordinal skips below hit the right dispatches (and a
                    # resumed run replays the continuous run's batches).
                    self.train_loader.set_epoch(epoch)
                    ordinal = -1
                    try:
                        batches = self._groups(self.train_loader)
                        if trace is not None:
                            # data_iter: the time spent waiting on the loader.
                            batches = self._tracer.timed_iter(batches, "data_iter", trace=trace)
                        for ordinal, (kind, item) in enumerate(batches):
                            if ordinal < resume_at or ordinal in quarantine:
                                continue
                            start_step = self.host_step
                            if kind == "group":
                                points += sum(b.n_real_points for b in item)
                                losses.append(self._run_group(item, epoch, trace))
                            else:
                                points += item.n_real_points
                                losses.append(self._run_single(item, epoch, trace))
                            if sup is not None:
                                sup.after_dispatch(
                                    self.state_dict, ordinal=ordinal, start_step=start_step,
                                    end_step=self.host_step, losses=losses, points=points,
                                    epoch=epoch,
                                )
                            if preempt is not None and preempt.should_stop():
                                raise PreemptionRequested(epoch, self.host_step)
                        if self._telemetry is not None:
                            # The partial window, before eval: the NaN watchdog
                            # must fire before eval spends a pass on a dead run.
                            with self._tspan(trace, "telemetry_drain"):
                                self._telemetry.drain()
                        if sup is not None:
                            # A NaN in the last partial snapshot window must
                            # not reach eval or a checkpoint.
                            sup.check_losses(losses, epoch=epoch)
                        break
                    except NonFiniteLossError as err:
                        if sup is None:
                            raise
                        bad = err.ordinal if err.ordinal is not None else sup.ordinal_for_step(err.step)
                        if bad is None:
                            bad = ordinal  # the dispatch in flight
                        action = sup.plan(err)
                        if action == "restore":
                            raise RestoreEscalation(err) from err
                        if action == "abort":
                            self._abort_nonfinite(err.step, err.epoch, None, err.batch)
                        if self._telemetry is not None:
                            # The rolled-back steps' records are bogus, and
                            # their NaN must not fire the watchdog again.
                            self._telemetry.discard()
                        snap = sup.rollback()
                        self.load_state_dict(snap.state)
                        self.host_step = snap.host_step
                        del losses[snap.n_losses:]
                        points = snap.points
                        quarantine.add(bad)
                        resume_at = snap.ordinal
                        print(
                            f"Recovery: non-finite loss at step {err.step} — rolled back to "
                            f"step {snap.host_step}, quarantined dispatch {bad} "
                            f"({sup.rollbacks_used}/{sup.max_rollbacks} rollbacks used)"
                        )
                        if self.metrics_sink is not None:
                            self.metrics_sink.log(
                                event=events.ROLLBACK, epoch=epoch, step=err.step,
                                to_step=snap.host_step, rollbacks_used=sup.rollbacks_used,
                            )
                            self.metrics_sink.log(
                                event=events.BATCH_QUARANTINED, epoch=epoch, step=err.step,
                                ordinal=bad,
                            )
            step_losses = (
                torch.cat(losses).cpu().numpy() if losses else np.zeros(0, np.float32)
            )  # the epoch's one host sync for the train losses
            train_loss = float(np.mean(step_losses)) if losses else float("nan")
            dt = time.perf_counter() - t0
            # The reference's console lines (main.py:105,147-148).
            print(f"Epoch {epoch}, Loss: {train_loss}")
            with profiling.annotate("eval_epoch"), self._tspan(trace, "eval"):
                res = self.evaluate()
        print(f"Epoch {epoch}, Test Metric: {res}")
        print("-----------------------------------")
        record = EpochRecord(epoch, step_losses, train_loss, res)
        self.history.append(record)
        if self.metrics_sink is not None:
            self.metrics_sink.log(
                epoch=epoch,
                train_loss=train_loss,
                test_metric=res,  # the sink writes a non-finite value as null
                lr=self.lr_fn(self.host_step, epoch),
                points_per_sec=points / dt,
                epoch_seconds=dt,
            )
        if res < self.best_metric:
            self.best_metric = res
            if self.checkpointer is not None:
                with self._tspan(trace, "checkpoint_save", which="best"):
                    self.checkpointer.save_best(self.state_dict(), epoch, self.best_metric)
        if (
            self.checkpointer is not None
            and cfg.train.checkpoint_every
            and (epoch + 1) % cfg.train.checkpoint_every == 0
        ):
            with self._tspan(trace, "checkpoint_save", which="latest"):
                self.checkpointer.save_latest(self.state_dict(), epoch + 1, self.best_metric)
        return record

    def _run_single(self, batch, epoch: int, trace) -> torch.Tensor:
        """One step on a host batch with its spans, its telemetry or its
        ``log_every`` record; returns its loss as a ``[1]`` device tensor.
        The fault hooks act first; with ``debug_checks`` a non-finite loss
        raises ``NonFiniteLossError`` at its step."""
        cfg = self.config
        if self._faults is not None:
            self._faults.maybe_sigterm(self.host_step + 1)
            batch = self._faults.poison_batch(batch, self.host_step + 1)
        lr = self.lr_fn(self.host_step, epoch)
        telem = {} if self._telemetry is not None else None
        with self._tspan(trace, "step", step=self.host_step + 1) as sp:
            with self._tspan(trace, "host_to_device"):
                device_batch = batch.to(self.device, non_blocking=True)
            with self._tspan(trace, "step_dispatch"):
                loss = self._step(device_batch, lr, telem)
        if self._telemetry is not None:
            # Device tensors only: the buffer reads them at its drains.
            self._telemetry.append(
                steps=[self.host_step], epoch=epoch, lrs=[lr], loss=loss,
                telem=telem, batches=[batch],
                span_ids=[sp.span_id if sp is not None else None],
            )
        if cfg.train.debug_checks and not math.isfinite(float(loss)):
            # The deterministic guard: one host read a step.
            raise NonFiniteLossError(
                f"non-finite train loss at epoch {epoch}, step {self.host_step}",
                step=self.host_step, epoch=epoch, batch=batch,
            )
        if (
            self._telemetry is None
            and self.metrics_sink is not None
            and cfg.train.log_every
            and self.host_step % cfg.train.log_every == 0
        ):
            # float(loss) waits for the step: step records without
            # telemetry are meant for coarse cadences.
            self.metrics_sink.log(step=self.host_step, epoch=epoch, loss=float(loss), lr=lr)
        return loss.reshape(1)

    def _run_group(self, group: list, epoch: int, trace) -> torch.Tensor:
        """One dispatch of ``len(group)`` steps (``multi_train_step``) with
        its spans, telemetry or records; returns the ``[K]`` losses. The
        fault hooks act on each step of the group first."""
        cfg = self.config
        if self._faults is not None:
            for i in range(len(group)):
                self._faults.maybe_sigterm(self.host_step + 1 + i)
            group = [self._faults.poison_batch(b, self.host_step + 1 + i)
                     for i, b in enumerate(group)]
        start = self.host_step
        lrs = [self.lr_fn(start + i, epoch) for i in range(len(group))]
        telem = {} if self._telemetry is not None else None
        with self._tspan(trace, "step", step=start + 1, k=len(group)) as sp:
            with self._tspan(trace, "host_to_device"):
                device_batches = self._stacked(group).to(self.device, non_blocking=True)
            with self._tspan(trace, "step_dispatch"):
                loss_k = self._multi_step(device_batches, lrs, telem)
        if self._telemetry is not None:
            # One stacked entry for the K steps; the drain unstacks it.
            self._telemetry.append(
                steps=list(range(start + 1, self.host_step + 1)), epoch=epoch,
                lrs=lrs, loss=loss_k, telem=telem, batches=group,
                span_ids=[sp.span_id if sp is not None else None] * len(group),
            )
        host_lk = loss_k.cpu().numpy() if cfg.train.debug_checks else None  # one sync
        if host_lk is not None and not np.all(np.isfinite(host_lk)):
            bad = int(np.argmax(~np.isfinite(host_lk)))
            raise NonFiniteLossError(
                f"non-finite train loss at epoch {epoch}, steps {start + 1}..{self.host_step}",
                step=start + bad + 1, epoch=epoch, batch=group[bad],
            )
        if self._telemetry is None and self.metrics_sink is not None and cfg.train.log_every:
            for i in range(len(group)):
                if (start + i + 1) % cfg.train.log_every == 0:
                    if host_lk is None:
                        host_lk = loss_k.cpu().numpy()  # one sync for the group
                    self.metrics_sink.log(step=start + i + 1, epoch=epoch,
                                          loss=float(host_lk[i]), lr=lrs[i])
        return loss_k

    def _handle_nonfinite_loss(self, step: int, epoch: int, loss: float, batch) -> None:
        """The NaN watchdog (``TelemetryBuffer``'s ``on_nonfinite``): with the
        recovery supervisor, a ``NonFiniteLossError`` the epoch harness
        takes to roll back; otherwise the hard abort."""
        if self._supervisor is not None:
            raise NonFiniteLossError(
                f"non-finite train loss at epoch {epoch}, step {step}",
                step=step, epoch=epoch, batch=batch,
            )
        self._abort_nonfinite(step, epoch, loss, batch)

    def _abort_nonfinite(self, step: int, epoch: int, loss: float | None, batch) -> None:
        """The hard abort, the recovery ladder's last rung (and its only one
        with recovery off): name the first module whose output is
        non-finite in a re-run of the offending host batch on the current
        weights, record the event, flush, and stop the run
        (``gnot_tpu/train/trainer.py::_abort_nonfinite``)."""
        detail = None
        if batch is not None:
            loss_name = self.config.train.loss
            detail = health.localize_nan(
                self.model,
                lambda b: batch_loss(self.model, b.to(self.device), loss_name),
                batch,
            )
        if self.metrics_sink is not None:
            self.metrics_sink.log(event=events.NON_FINITE_LOSS, step=step, epoch=epoch,
                                  loss=loss, detail=detail)
            self.metrics_sink.flush()
        raise FloatingPointError(
            f"non-finite train loss at epoch {epoch}, step {step}"
            + (
                f" (first non-finite module output: {detail})"
                if detail
                else " (the re-run did not reproduce it: the bad value predates "
                     "this step's forward)"
                if batch is not None
                else ""
            )
        )

    def restore_best(self) -> int | None:
        """Load the best checkpoint's state (weights, AdamW state, step
        and accumulation counts), making the optimizer first if need be;
        returns its epoch, or None when there is no best checkpoint."""
        if self.optimizer is None:
            self.initialize()
        restored = self.checkpointer.restore_best()
        if restored is None:
            return None
        state, epoch, _ = restored
        self.load_state_dict(state)
        return epoch

    def evaluate_from_checkpoint(self) -> float:
        """Restore the best checkpoint and evaluate it, no training
        (``gnot_tpu/train/trainer.py::evaluate_from_checkpoint``)."""
        if self.checkpointer is None:
            raise ValueError("eval-only mode needs --checkpoint_dir")
        epoch = self.restore_best()
        if epoch is None:
            raise FileNotFoundError(f"no best checkpoint under {self.checkpointer.directory}")
        res = self.evaluate()
        print(f"Eval (best checkpoint from epoch {epoch}): {res}")
        return res

    def predict(self, samples) -> list[np.ndarray]:
        """Per-sample unpadded outputs ``[n_i, out_dim]`` of the current
        weights, through the serving engine's offline path at the train
        batch size and the model's own compute dtype, as
        ``gnot_tpu/train/trainer.py::predict``; the stacked layout serves
        its unstacked copy."""
        engine = InferenceEngine(self.standard_model(), batch_size=self.config.data.batch_size)
        return engine.predict(samples)

    def fit(self) -> float:
        """Train from ``start_epoch`` to ``train.epochs`` under the
        preemption handler and the recovery ladder; returns the best test
        metric. A stop request saves ``latest`` and ends the run
        resume-ready; ``stop_epoch`` ends it after that epoch."""
        if self.optimizer is None:
            self.initialize()
        cfg = self.config
        if cfg.train.telemetry:
            self._telemetry = obs_telemetry.TelemetryBuffer(
                self.metrics_sink,
                cfg.train.log_every,
                slow_step=health.SlowStepMonitor(),
                on_nonfinite=self._handle_nonfinite_loss,
                metrics=self._metrics_registry,
            )
        self._supervisor = (
            RecoverySupervisor(snapshot_every=cfg.train.snapshot_every,
                               max_rollbacks=cfg.train.max_rollbacks)
            if cfg.train.recovery else None
        )
        preempt_cm = (
            PreemptionHandler(sync_every=cfg.train.preempt_sync_every)
            if cfg.train.graceful_preempt else contextlib.nullcontext()
        )
        # Profile the second epoch this run executes (first-use builds and
        # allocations stay out), or the only one.
        trace_at = min(self.start_epoch + 1, cfg.train.epochs - 1)
        with preempt_cm as preempt:
            epoch = self.start_epoch
            while epoch < cfg.train.epochs:
                try:
                    self.run_epoch(epoch, trace_at, preempt)
                except PreemptionRequested as stop:
                    self._preempt_save(stop)
                    break
                except RestoreEscalation as esc:
                    epoch = self._escalate_restore(esc)
                    continue
                if self._faults is not None and self._faults.stop_after_epoch(epoch):
                    # An injected clean stop; the wait below commits the
                    # saves in flight.
                    print(f"Stopping after epoch {epoch} (--stop_after_epoch)")
                    break
                epoch += 1
        if self.checkpointer is not None:
            self.checkpointer.wait()
        print(f"\nBest Test Metric: {self.best_metric}")
        return self.best_metric

    def _preempt_save(self, stop: PreemptionRequested) -> None:
        """The graceful-preemption exit: save ``latest`` at the current epoch
        (a resumed run replays the partial epoch on the saved state), flush
        the sink, leave the run resume-ready. When the last telemetry drain
        finds a NaN in the live state, the last-good snapshot is saved
        instead (recovery on), or nothing."""
        print(
            f"Preemption: stopping at epoch {stop.epoch}, step {stop.step}"
            + (
                " — saving 'latest' and exiting resume-ready"
                if self.checkpointer is not None
                else " (no --checkpoint_dir: exiting without a save)"
            )
        )
        state = self.state_dict()
        if self._telemetry is not None:
            try:
                self._telemetry.drain()
            except FloatingPointError:
                state = (self._supervisor.last_good_state()
                         if self._supervisor is not None else None)
                print(
                    "Preemption: non-finite loss in the final telemetry window — "
                    + (
                        "saving the last-good recovery snapshot instead of the "
                        "poisoned live state"
                        if state is not None
                        else "NOT saving 'latest' (live state is poisoned and no "
                             "recovery snapshot exists)"
                    )
                )
        if self.checkpointer is not None and state is not None:
            self.checkpointer.save_latest(state, stop.epoch, self.best_metric)
            self.checkpointer.wait()
        if self.metrics_sink is not None:
            self.metrics_sink.log(
                event=events.PREEMPT_SAVE, epoch=stop.epoch, step=stop.step,
                resumable=self.checkpointer is not None and state is not None,
            )
            self.metrics_sink.flush()

    def _escalate_restore(self, esc: RestoreEscalation) -> int:
        """The ladder's second rung: restore the newest restorable
        checkpoint (``latest``, else ``best``) and return its epoch to
        re-enter the loop at; ``host_step`` comes from its step count.
        Without a checkpointer or anything restorable, the hard abort."""
        err = esc.cause
        if self._telemetry is not None:
            self._telemetry.discard()
        restored = self.checkpointer.restore_latest() if self.checkpointer is not None else None
        if restored is None:
            self._abort_nonfinite(err.step, err.epoch, None, err.batch)
        state, epoch, self.best_metric = restored
        self.load_state_dict(state)
        print(f"Recovery: rollback budget exhausted — restored checkpoint (epoch {epoch}); "
              "continuing")
        if self.metrics_sink is not None:
            self.metrics_sink.log(
                event=events.RECOVERY_RESTORE, epoch=err.epoch, step=err.step,
                restored_epoch=epoch,
                restored_from=(self.checkpointer.last_restore or {}).get("dir"),
            )
        return epoch
