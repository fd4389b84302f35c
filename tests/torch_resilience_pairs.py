"""Shared by ``test_torch_resilience.py`` and ``test_torch_checkpoint.py``:
the same small training run through the JAX package's ``Trainer`` and the
port's, from the same initial weights, at ``tests/test_resilience.py::
tiny_setup``'s size (1 layer, width 16, 2 experts, 2 heads; darcy2d, 16
train and 8 test samples, batch 4), f32 on the CPU, with every record
both write kept in a list."""

from __future__ import annotations

import dataclasses

import jax
import numpy as np

from gnot_tpu import make_config
from gnot_tpu.config import ModelConfig as JaxModelConfig
from gnot_tpu.data import datasets as jax_datasets
from gnot_tpu.train.checkpoint import Checkpointer as JaxCheckpointer
from gnot_tpu.train.trainer import Trainer as JaxTrainer
from gnot_tpu_torch.config import Config, DataConfig, ModelConfig, TrainConfig
from gnot_tpu_torch.data import datasets
from gnot_tpu_torch.interop import params_from_jax
from gnot_tpu_torch.resilience.retry import RetryPolicy
from gnot_tpu_torch.train.checkpoint import Checkpointer
from gnot_tpu_torch.train.trainer import Trainer

RTOL, ATOL = 1e-4, 1e-5  # the model-level bar of tests/test_pallas_ffn.py

TINY = dict(n_attn_layers=1, n_attn_hidden_dim=16, n_mlp_num_layers=1, n_mlp_hidden_dim=16,
            n_input_hidden_dim=16, n_expert=2, n_head=2)
DATA = dict(synthetic="darcy2d", n_train=16, n_test=8)

# No backoff sleeps in the tests; the same policy on both sides.
NO_WAIT = dict(attempts=4, base_delay_s=0.0)


class ListSink:
    def __init__(self):
        self.records = []

    def log(self, **record):
        self.records.append(record)

    def flush(self):
        pass

    def events(self) -> list[dict]:
        return [r for r in self.records if "event" in r]

    def steps(self) -> list[tuple[int, float]]:
        return [(r["step"], r["loss"]) for r in self.records
                if "event" not in r and "step" in r]


@dataclasses.dataclass
class Run:
    sink: ListSink
    best: float | None
    error: BaseException | None
    trainer: object


def jax_trainer(train: dict, ck_dir: str | None = None, sink: ListSink | None = None,
                epochs: int = 2):
    cfg = make_config(**{f"data.{k}": v for k, v in DATA.items()},
                      **{"train.epochs": epochs, "train.log_every": 1},
                      **{f"train.{k}": v for k, v in train.items()})
    tr, te = jax_datasets.load(cfg.data)
    mc = JaxModelConfig(**TINY, **jax_datasets.infer_model_dims(tr))
    ck = (JaxCheckpointer(ck_dir, retry_policy=_jax_policy()) if ck_dir else None)
    return JaxTrainer(cfg, mc, tr, te, metrics_sink=sink, checkpointer=ck)


def port_trainer(train: dict, ck_dir: str | None = None, sink: ListSink | None = None,
                 epochs: int = 2) -> Trainer:
    cfg = Config(data=DataConfig(**DATA), train=TrainConfig(epochs=epochs, log_every=1, **train))
    tr, te = datasets.load(cfg.data)
    mc = ModelConfig(**TINY, **datasets.infer_model_dims(tr))
    ck = Checkpointer(ck_dir, retry_policy=RetryPolicy(**NO_WAIT)) if ck_dir else None
    return Trainer(cfg, mc, tr, te, device="cpu", metrics_sink=sink, checkpointer=ck)


def _jax_policy():
    from gnot_tpu.resilience.retry import RetryPolicy as JaxRetryPolicy

    return JaxRetryPolicy(**NO_WAIT)


def initial_params(jt) -> dict:
    """The JAX trainer's initial weights, by value (a step donates them)."""
    jt.initialize()
    return jax.tree.map(np.array, jax.device_get(jt.state.params))


def carry(port: Trainer, params) -> None:
    port.initialize()
    port.load_standard_params(params_from_jax(params, port.model_cfg))


def outcome(trainer) -> tuple[float | None, BaseException | None]:
    try:
        return trainer.fit(), None
    except FloatingPointError as err:
        return None, err


def run_pair(train: dict, tmp_path=None, epochs: int = 2) -> tuple[Run, Run]:
    """The same run through both trainers from the same weights; each with
    its own checkpoint directory under ``tmp_path`` when one is given."""
    runs = []
    params = None
    for side in ("jax", "port"):
        sink = ListSink()
        ck = str(tmp_path / side) if tmp_path is not None else None
        if side == "jax":
            t = jax_trainer(train, ck, sink, epochs)
            params = initial_params(t)
        else:
            t = port_trainer(train, ck, sink, epochs)
            carry(t, params)
        best, err = outcome(t)
        runs.append(Run(sink, best, err, t))  # graftlint: disable=GL001 — a trainer object, not a donated buffer
    return runs[0], runs[1]


EVENT_FIELDS = ("event", "epoch", "step", "to_step", "ordinal", "rollbacks_used",
                "restored_epoch", "restored_from", "resumable", "requested", "name", "dir",
                "fallback", "op", "attempt")


def event_view(events: list[dict]) -> list[tuple]:
    """The events in order, each by the fields both packages fill alike; a
    checkpoint is named by its file (``latest.1.pt``) in the port and by
    its directory (``latest.1``) in JAX."""
    def value(k, v):
        return v[:-3] if k in ("dir", "restored_from") and str(v).endswith(".pt") else v

    return [tuple((k, value(k, e[k])) for k in EVENT_FIELDS if k in e) for e in events]


def assert_same_run(want: Run, got: Run) -> None:
    """The same events in order (kinds and fields), the same step records
    (numbers and losses at the model-level bar), the same outcome."""
    import numpy.testing as npt

    assert event_view(got.sink.events()) == event_view(want.sink.events())
    want_steps, got_steps = want.sink.steps(), got.sink.steps()
    assert [s for s, _ in got_steps] == [s for s, _ in want_steps]
    npt.assert_allclose([l for _, l in got_steps], [l for _, l in want_steps],
                        rtol=RTOL, atol=ATOL)
    assert (got.error is None) == (want.error is None), (want.error, got.error)
    if want.error is not None:
        assert type(got.error).__name__ == type(want.error).__name__
        assert str(want.error).split(" (")[0] == str(got.error).split(" (")[0]
    else:
        npt.assert_allclose(got.best, want.best, rtol=RTOL, atol=ATOL)
