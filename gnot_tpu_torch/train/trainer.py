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
the weights in place, which moves their version: each step's first
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
"""

from __future__ import annotations

import dataclasses
from typing import Iterable

import numpy as np
import torch

from gnot_tpu_torch.config import Config, DataConfig, ModelConfig, OptimConfig
from gnot_tpu_torch.data.batch import Loader, MeshBatch, PackedBatch, PackedLoader
from gnot_tpu_torch.device import resolve_device
from gnot_tpu_torch.models.gnot import GNOT, apply_batch
from gnot_tpu_torch.ops.segment import LOSSES, PACKED_LOSSES
from gnot_tpu_torch.serve.engine import InferenceEngine
from gnot_tpu_torch.train.schedule import make_lr_fn


def make_optimizer(cfg: OptimConfig, params: Iterable[torch.nn.Parameter]) -> torch.optim.AdamW:
    """``torch.optim.AdamW`` over every parameter with the JAX package's
    b1/b2/eps/weight_decay (``optax.adamw``: the same update, decay
    applied to all parameters). The learning rate is set per step.

    Never the fused implementation: on the card it writes the weights
    without moving their version, so the FFN kernel's cached weight
    images would go stale (``tests/test_torch_cuda.py``). torch's default
    there, foreach, moves it."""
    return torch.optim.AdamW(
        params, lr=cfg.lr, betas=(cfg.b1, cfg.b2), eps=cfg.eps,
        weight_decay=cfg.weight_decay, fused=False,
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


def batch_loss(model: GNOT, batch: MeshBatch | PackedBatch, loss_name: str) -> torch.Tensor:
    """Forward + per-graph pooled loss, always masked, parity mode
    included: the reference unpads before pooling (main.py:89). A
    ``PackedBatch`` pools per segment, the mean over the samples present
    in the dispatch (``packed_loss_fn``)."""
    preds = apply_batch(model, batch)
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
    ):
        # First, so TF32 stays off before any weight reaches the card.
        self.device = resolve_device(str(device))
        self.config = config
        self.model_cfg = model_cfg
        self.checkpointer = checkpointer
        data = config.data
        if data.packed and model_cfg.attention_mode == "parity":
            raise ValueError(
                "packed mode requires attention_mode='masked' (parity "
                "reproduces the reference's per-batch padding pollution, "
                "which has no packed equivalent)"
            )
        # Batches for the card are page-locked on the prefetch thread, so
        # each step's copy neither blocks the host nor drains the stream.
        self.train_loader, self.test_loader = make_loaders(
            data, train_samples, test_samples, pin_memory=self.device.type == "cuda"
        )
        self.lr_fn = make_lr_fn(
            config.optim,
            steps_per_epoch=len(self.train_loader),
            epochs=config.train.epochs,
        )
        # Weights from train.seed through an explicit generator, as
        # serving draws them; a mode the port lacks is refused here.
        gen = torch.Generator().manual_seed(config.train.seed)
        self.model = GNOT(model_cfg, generator=gen).to(self.device)
        self.optimizer: torch.optim.AdamW | None = None
        self.best_metric = float("inf")
        self.start_epoch = 0
        # Updates taken so far (the JAX state's step counter).
        self.host_step = 0
        self.history: list[EpochRecord] = []

    def initialize(self) -> None:
        """The optimizer over the model's weights, and on ``resume`` the
        latest checkpoint's state."""
        self.optimizer = make_optimizer(self.config.optim, self.model.parameters())
        if self.checkpointer is not None and self.config.train.resume:
            restored = self.checkpointer.restore_latest()
            if restored is not None:
                state, self.start_epoch, self.best_metric = restored
                self.load_state_dict(state)

    def state_dict(self) -> dict:
        """The training state a checkpoint holds: weights, AdamW moments
        and step counts, and the update count."""
        return {
            "model": self.model.state_dict(),
            "optimizer": self.optimizer.state_dict(),
            "step": self.host_step,
        }

    def load_state_dict(self, state: dict) -> None:
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.host_step = int(state["step"])

    def train_step(self, batch: MeshBatch, lr: float) -> torch.Tensor:
        """One AdamW update on a host batch at learning rate ``lr``.
        Returns the loss as a device scalar; nothing waits for the card."""
        batch = batch.to(self.device, non_blocking=True)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.zero_grad(set_to_none=True)
        loss = batch_loss(self.model, batch, self.config.train.loss)
        loss.backward()
        if self.config.optim.grad_clip_norm > 0:
            grads = [p.grad for p in self.model.parameters() if p.grad is not None]
            clip_by_global_norm_(grads, self.config.optim.grad_clip_norm)
        self.optimizer.step()
        self.host_step += 1
        return loss.detach()

    @torch.no_grad()
    def eval_step(self, batch: MeshBatch) -> torch.Tensor:
        """The batch's eval metric as a device scalar."""
        return batch_loss(
            self.model, batch.to(self.device, non_blocking=True), self.config.train.loss
        )

    def evaluate(self) -> float:
        """The mean of the per-batch metrics over the test set: a short
        last batch weighs like a full one, as in the JAX package."""
        if len(self.test_loader) == 0:
            return float("inf")
        metrics = torch.stack([self.eval_step(b) for b in self.test_loader])
        return float(np.mean(metrics.cpu().numpy()))  # the one host sync

    def run_epoch(self, epoch: int) -> EpochRecord:
        """One epoch: the train steps, the reference's console lines,
        eval, best-metric selection and the checkpoint saves."""
        cfg = self.config
        # The shuffle order is a function of (seed, epoch): a resumed run
        # replays the continuous run's batches.
        self.train_loader.set_epoch(epoch)
        losses = [
            self.train_step(batch, self.lr_fn(self.host_step, epoch))
            for batch in self.train_loader
        ]
        step_losses = (
            torch.stack(losses).cpu().numpy() if losses else np.zeros(0, np.float32)
        )  # the epoch's one host sync for the train losses
        train_loss = float(np.mean(step_losses)) if losses else float("nan")
        # The reference's console lines (main.py:105,147-148).
        print(f"Epoch {epoch}, Loss: {train_loss}")
        res = self.evaluate()
        print(f"Epoch {epoch}, Test Metric: {res}")
        print("-----------------------------------")
        record = EpochRecord(epoch, step_losses, train_loss, res)
        self.history.append(record)
        if res < self.best_metric:
            self.best_metric = res
            if self.checkpointer is not None:
                self.checkpointer.save_best(self.state_dict(), epoch, self.best_metric)
        if (
            self.checkpointer is not None
            and cfg.train.checkpoint_every
            and (epoch + 1) % cfg.train.checkpoint_every == 0
        ):
            self.checkpointer.save_latest(self.state_dict(), epoch + 1, self.best_metric)
        return record

    def restore_best(self) -> int | None:
        """Load the best checkpoint's state (weights, AdamW state, update
        count), making the optimizer first if need be; returns its epoch,
        or None when there is no best checkpoint."""
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
        ``gnot_tpu/train/trainer.py::predict``."""
        engine = InferenceEngine(self.model, batch_size=self.config.data.batch_size)
        return engine.predict(samples)

    def fit(self) -> float:
        """Train from ``start_epoch`` to ``train.epochs``; returns the best
        test metric."""
        if self.optimizer is None:
            self.initialize()
        for epoch in range(self.start_epoch, self.config.train.epochs):
            self.run_epoch(epoch)
        print(f"\nBest Test Metric: {self.best_metric}")
        return self.best_metric
