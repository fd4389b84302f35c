"""The port's fault injection, recovery ladder and graceful preemption
(``gnot_tpu_torch/resilience/``, ``Trainer.fit``'s harness) against the
JAX package's: the spec grammar, the retry loop, the preemption handler,
each rung of the ladder through both trainers from the same weights (the
same events in order and the same step losses at 1e-4 / 1e-5), the
rollback replay's shuffle order, SIGTERM mid-epoch and ``stop_epoch``
then ``--resume``. At ``tests/test_resilience.py::tiny_setup``'s size.
The checkpointer's side is ``test_torch_checkpoint.py``."""

import dataclasses
import signal

import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

from gnot_tpu import make_config
from gnot_tpu import main as jax_main
from gnot_tpu.resilience import faults as jax_faults
from gnot_tpu.resilience import retry as jax_retry
from gnot_tpu_torch import main as port_main
from gnot_tpu_torch.config import Config, DataConfig, ModelConfig, TrainConfig
from gnot_tpu_torch.data import datasets
from gnot_tpu_torch.data.batch import PackedLoader, collate
from gnot_tpu_torch.resilience import faults, retry
from gnot_tpu_torch.resilience.preemption import PreemptionHandler
from gnot_tpu_torch.resilience.retry import RetryPolicy, retry_io
from gnot_tpu_torch.resilience.supervisor import RecoverySupervisor, _copy_state
from gnot_tpu_torch.train.trainer import Trainer
from torch_resilience_pairs import TINY, ListSink, assert_same_run, port_trainer, run_pair

# -- the spec grammar, the flags and the config checks ------------------------

SPECS = ["", "nan_grad@3, ckpt_io@2", "stop_epoch@1", "sigterm@3,corrupt_ckpt@1",
         "bad_sample@5", "msg_delay@250", "reload_corrupt@2,host_kill@1", " nan_grad@1 ,",
         "nan_grad", "nan_grad@x", "typo@3", "nan_grad@0", "nan_grad@-2", "@3", "nan_grad@3@4"]


@pytest.mark.parametrize("spec", SPECS)
def test_fault_specs_parse_as_in_jax(spec):
    """Every spec JAX accepts parses to the same (kind, at) list; every
    spec it refuses is refused with the same message."""
    try:
        want = [(s.kind, s.at) for s in jax_faults.parse_fault_spec(spec)]
    except ValueError as err:
        with pytest.raises(ValueError) as got:
            faults.parse_fault_spec(spec)
        assert str(got.value) == str(err)
        return
    assert [(s.kind, s.at) for s in faults.parse_fault_spec(spec)] == want
    assert faults.FAULT_KINDS == jax_faults.FAULT_KINDS


def test_stop_after_epoch_is_the_stop_epoch_alias():
    for train in (TrainConfig(stop_after_epoch=2), TrainConfig(inject_fault="stop_epoch@2")):
        inj = faults.FaultInjector.from_config(train)
        assert inj.stop_after_epoch(1) and not inj.stop_after_epoch(0)
    assert faults.FaultInjector.from_config(TrainConfig()) is None
    with pytest.raises(ValueError, match="fault spec"):
        port_trainer({"inject_fault": "nope@1"})


FLAGS = ["inject_fault", "stop_after_epoch", "recovery", "snapshot_every", "max_rollbacks",
         "no_preempt", "preempt_sync_every", "debug_checks"]


def test_the_eight_flags_take_jax_s_defaults_and_refusals():
    want = vars(jax_main.build_parser().parse_args([]))
    got = vars(port_main.build_parser().parse_args([]))
    assert {f: got[f] for f in FLAGS} == {f: want[f] for f in FLAGS}
    argv = ["--recovery", "--snapshot_every", "2", "--max_rollbacks", "1", "--no_preempt",
            "--preempt_sync_every", "3", "--debug_checks", "--inject_fault", "nan_grad@3",
            "--stop_after_epoch", "2"]
    port = port_main.train_config(port_main.build_parser().parse_args(argv)).train
    jax_cfg = jax_main.config_from_args(jax_main.build_parser().parse_args(argv)).train
    for field in ("recovery", "snapshot_every", "max_rollbacks", "graceful_preempt",
                  "preempt_sync_every", "debug_checks", "inject_fault", "stop_after_epoch"):
        assert getattr(port, field) == getattr(jax_cfg, field), field
    for bad in (["--snapshot_every", "0"], ["--max_rollbacks", "-1"],
                ["--preempt_sync_every", "0"]):
        with pytest.raises(ValueError) as want_err:
            jax_main.config_from_args(jax_main.build_parser().parse_args(bad))
        with pytest.raises(ValueError) as got_err:
            port_main.train_config(port_main.build_parser().parse_args(bad))
        assert str(got_err.value) == str(want_err.value)


# -- retries and the preemption handler ---------------------------------------


def test_retry_io_retries_transients_and_passes_the_rest_like_jax():
    for retry_fn in (jax_retry.retry_io, retry_io):
        calls = []

        def flaky():
            calls.append(1)
            if len(calls) < 3:
                raise OSError("transient")
            return "ok"

        assert retry_fn(flaky, policy=RetryPolicy(attempts=4, base_delay_s=0.0),
                     sleep=lambda s: None) == "ok"
        assert len(calls) == 3
        for exc in (ValueError("bad bytes"), FileNotFoundError("gone"), PermissionError("no")):
            calls.clear()

            def once(exc=exc):
                calls.append(1)
                raise exc

            with pytest.raises(type(exc)):
                retry_fn(once, policy=RetryPolicy(attempts=4, base_delay_s=0.0), sleep=lambda s: None)
            assert calls == [1]
    assert (retry.PERMANENT_ERRORS, retry.TRANSIENT_ERRORS) == (
        jax_retry.PERMANENT_ERRORS, jax_retry.TRANSIENT_ERRORS)


def test_retry_io_deadline_clamps_sleeps_and_stops():
    clk, slept = [0.0], []

    def sleep(s):
        slept.append(s)
        clk[0] += s

    def always():
        clk[0] += 0.05
        raise OSError("down")

    with pytest.raises(OSError, match="down"):
        retry_io(always, policy=RetryPolicy(attempts=6, base_delay_s=10.0, max_delay_s=10.0),
                 sleep=sleep, deadline=0.4, clock=lambda: clk[0])
    assert slept and all(s <= 0.4 for s in slept)
    assert clk[0] <= 0.4 + 0.05 + 1e-9
    slept.clear()
    with pytest.raises(OSError):
        retry_io(always, policy=RetryPolicy(attempts=6, base_delay_s=10.0), sleep=sleep,
                 deadline=0.0, clock=lambda: clk[0])
    assert slept == []


def test_preemption_handler_installs_restores_and_bails_on_a_second_sigint():
    before = {sig: signal.getsignal(sig) for sig in PreemptionHandler.SIGNALS}
    with PreemptionHandler(sync_every=4) as h:
        assert not h.should_stop()
        signal.raise_signal(signal.SIGTERM)
        assert h.should_stop() and h.triggered
        # The multi-rank agreement: every 4th check syncs the flag (in a
        # world of one, the local flag); the others wait for it.
        assert [h.should_stop(multiprocess=True) for _ in range(4)] == [False] * 3 + [True]
    assert {sig: signal.getsignal(sig) for sig in PreemptionHandler.SIGNALS} == before
    with PreemptionHandler() as h:
        h._handle(signal.SIGINT, None)
        assert h.triggered
        with pytest.raises(KeyboardInterrupt):
            h._handle(signal.SIGINT, None)
    assert signal.getsignal(signal.SIGINT) is before[signal.SIGINT]


# -- the trainer's hooks --------------------------------------------------------


def test_poison_batch_returns_a_copy_for_padded_and_packed_batches():
    samples = datasets.synth_elasticity(6, seed=3, base_points=40)
    batch = collate(samples[:4])
    packed = next(iter(PackedLoader(samples, 4, chunk=16)))
    for b in (batch, packed):
        before = {f.name: getattr(b, f.name) for f in dataclasses.fields(b)}
        copies = {k: v.clone() for k, v in before.items() if isinstance(v, torch.Tensor)}
        inj = faults.FaultInjector.from_spec("nan_grad@2,bad_sample@3")
        assert inj.poison_batch(b, 1) is b
        poisoned = inj.poison_batch(b, 2)
        assert torch.isnan(poisoned.y).all() and torch.equal(poisoned.coords, b.coords)
        bad = inj.poison_batch(b, 3)
        assert torch.isnan(bad.coords).all() and torch.equal(bad.y, b.y)
        assert inj.poison_batch(b, 2) is b  # fires once
        assert type(poisoned) is type(b) and getattr(poisoned, "n_seg", 0) == getattr(b, "n_seg", 0)
        for k, v in copies.items():
            assert torch.equal(getattr(b, k), v), f"{type(b).__name__}.{k} written in place"


def test_the_snapshot_owns_every_tensor_of_the_state():
    """The supervisor's copy shares no storage with the live state, the
    AdamW step counts included, and survives the in-place updates of
    later steps; a rollback loads it back bitwise."""
    t = port_trainer({})
    t.initialize()
    batches = list(t.train_loader)
    t.train_step(batches[0], 1e-3)
    sup = RecoverySupervisor(snapshot_every=1)
    sup.begin_epoch(t.state_dict, host_step=t.host_step)
    want = _copy_state(t.state_dict())
    live = [v for v in _leaves(t.state_dict())]
    held = [v for v in _leaves(sup._snap.state)]
    assert len(live) == len(held) and not {a.data_ptr() for a in live} & {b.data_ptr() for b in held}
    for b in batches[1:3]:  # graftlint: disable=GL001 — the port's Trainer.train_step donates nothing
        t.train_step(b, 1e-3)
    assert t.host_step == 3
    snap = sup.rollback()
    t.load_state_dict(snap.state)
    assert t.host_step == 1
    for a, b in zip(_leaves(t.state_dict()), _leaves(want), strict=True):
        assert torch.equal(a, b)
    t.train_step(batches[1], 1e-3)  # the held snapshot survives a replayed step
    for a, b in zip(_leaves(sup._snap.state), _leaves(want), strict=True):
        assert torch.equal(a, b)


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)


# -- the ladder, through both trainers ----------------------------------------

LADDER = {
    "nan_grad rolls back": dict(inject_fault="nan_grad@5", recovery=True, snapshot_every=2),
    "bad_sample rolls back": dict(inject_fault="bad_sample@5", recovery=True, snapshot_every=2),
    "escalates to a restore": dict(inject_fault="nan_grad@6", recovery=True, max_rollbacks=0,
                                   snapshot_every=2, checkpoint_every=1),
    "exhausted, aborts": dict(inject_fault="nan_grad@2", recovery=True, max_rollbacks=0,
                              snapshot_every=1),
    "recovery off, hard abort": dict(inject_fault="nan_grad@2", debug_checks=True),
}


@pytest.mark.parametrize("rung", list(LADDER))
def test_the_recovery_ladder_matches_jax(rung, tmp_path):
    over = LADDER[rung]
    # Each side checkpoints into its own directory under tmp_path.
    want, got = run_pair(over, tmp_path if over.get("checkpoint_every") else None)
    assert_same_run(want, got)
    kinds = [e["event"] for e in got.sink.events()]
    if "rolls back" in rung:
        assert kinds == ["rollback", "batch_quarantined"] and got.best is not None
        assert len(got.trainer.history[1].step_losses) == 3  # the quarantined step is gone
    elif "restore" in rung:
        assert kinds == ["restore", "recovery_restore"]
        assert got.sink.events()[1]["restored_from"] == "latest.1.pt"
        assert np.isfinite(got.best)
    else:
        assert isinstance(got.error, FloatingPointError) and got.best is None
        assert kinds == (["non_finite_loss"] if "exhausted" in rung else [])


def test_rollback_replay_pins_shuffle_order():
    """A content-poisoned sample with shuffle on: each epoch's replay
    repeats that epoch's order, so quarantining the bad dispatch skips the
    bad sample and each epoch costs one rollback (a replay in another
    order would meet it again and spend the budget)."""
    train = datasets.synth_darcy2d(16, seed=0)
    train[5].y[:] = np.nan
    test = datasets.synth_darcy2d(4, seed=1)
    cfg = Config(data=DataConfig(n_train=16, n_test=4),
                 train=TrainConfig(epochs=2, recovery=True, snapshot_every=1, max_rollbacks=2))
    assert cfg.data.shuffle_train
    sink = ListSink()
    t = Trainer(cfg, ModelConfig(**TINY, **datasets.infer_model_dims(train)), train, test,
                device="cpu", metrics_sink=sink)
    best = t.fit()
    assert np.isfinite(best)
    assert [e["event"] for e in sink.events()] == ["rollback", "batch_quarantined"] * 2
    assert t._supervisor.rollbacks_used == 2
    assert [len(r.step_losses) for r in t.history] == [3, 3]


def test_a_group_dispatch_is_quarantined_whole():
    """With two steps per dispatch, a NaN in the second step of a group
    rolls back to the epoch's entry and skips the whole group."""
    sink = ListSink()
    t = port_trainer(dict(inject_fault="nan_grad@4", recovery=True, snapshot_every=4,
                          steps_per_dispatch=2), sink=sink, epochs=1)
    assert np.isfinite(t.fit())
    events = sink.events()
    assert [(e["event"], e["step"]) for e in events] == [("rollback", 4), ("batch_quarantined", 4)]
    assert events[0]["to_step"] == 0 and events[1]["ordinal"] == 1
    assert t.host_step == 2 and len(t.history[0].step_losses) == 2


# -- preemption and stop_epoch, then --resume ---------------------------------


def test_sigterm_mid_epoch_saves_latest_like_jax_and_resumes(tmp_path):
    """A real SIGTERM before step 3: the step runs, the run stops at its
    boundary, saves ``latest`` at the current epoch and writes
    ``preempt_save``, as JAX's does; the resumed run replays the epoch on
    the saved state and finishes finite."""
    want, got = run_pair(dict(inject_fault="sigterm@3"), tmp_path)
    assert_same_run(want, got)
    assert [(e["event"], e["epoch"], e["step"], e["resumable"]) for e in got.sink.events()] == [
        ("preempt_save", 0, 3, True)]
    assert got.trainer.host_step == 3 and got.trainer.history == []
    resumed = port_trainer(dict(resume=True), str(tmp_path / "port"))
    resumed.initialize()
    assert (resumed.start_epoch, resumed.host_step) == (0, 3)
    assert np.isfinite(resumed.fit()) and resumed.host_step == 11


def test_stop_epoch_then_resume_equals_the_continuous_run(tmp_path, capsys):
    """``stop_epoch@1`` stops after epoch 0 with ``latest`` published; the
    resumed run's epoch 1 is the continuous run's bit for bit (the seeded
    shuffle and the checkpointed state)."""
    continuous = port_trainer(dict(checkpoint_every=1), str(tmp_path / "a"))
    continuous.fit()
    stopped = port_trainer(dict(checkpoint_every=1, inject_fault="stop_epoch@1"),
                           str(tmp_path / "b"))
    stopped.fit()
    assert "Stopping after epoch 0 (--stop_after_epoch)" in capsys.readouterr().out
    assert [r.epoch for r in stopped.history] == [0]
    resumed = port_trainer(dict(checkpoint_every=1, resume=True), str(tmp_path / "b"))
    resumed.fit()
    assert [r.epoch for r in resumed.history] == [1]
    np.testing.assert_array_equal(resumed.history[0].step_losses,
                                  continuous.history[1].step_losses)
    assert resumed.best_metric == continuous.best_metric
    for a, b in zip(_leaves(resumed.state_dict()), _leaves(continuous.state_dict()), strict=True):
        assert torch.equal(a, b)


def test_debug_checks_stop_at_the_poisoned_step_of_a_group():
    t = port_trainer(dict(inject_fault="nan_grad@3", debug_checks=True, steps_per_dispatch=2))
    with pytest.raises(FloatingPointError, match="epoch 0, steps 3..4"):
        t.fit()


def test_graceful_preemption_off_leaves_the_handlers_alone(monkeypatch):
    seen = []
    monkeypatch.setattr(PreemptionHandler, "__enter__", lambda self: seen.append(self) or self)
    port_trainer(dict(graceful_preempt=False), epochs=1).fit()
    assert seen == []
    port_trainer({}, epochs=1).fit()
    assert len(seen) == 1 and seen[0].sync_every == 1


def test_jax_config_defaults_match():
    want = make_config().train
    got = TrainConfig()
    for field in ("recovery", "snapshot_every", "max_rollbacks", "graceful_preempt",
                  "preempt_sync_every", "debug_checks", "inject_fault", "stop_after_epoch"):
        assert getattr(got, field) == getattr(want, field), field
