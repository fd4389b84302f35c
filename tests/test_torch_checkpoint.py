"""The port's checkpointer (``gnot_tpu_torch/train/checkpoint.py``) against
the JAX package's: ``restore_latest`` falling back to ``best`` on
``--resume`` (the trainer side: the same start epoch and step losses as
JAX's), the fallback walk over the same save sequence and the same
corruption (which file or directory restores, from which epoch, whether
as a fallback, after how many skips), the ``ckpt_io`` retries, the
``corrupt_ckpt`` fault, the restore deadline, the asynchronous save, and
the run manifest's ``restore`` field. The recovery ladder is
``test_torch_resilience.py``."""

import json
import os
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

from gnot_tpu.resilience import faults as jax_faults
from gnot_tpu.resilience.retry import RetryPolicy as JaxRetryPolicy
from gnot_tpu.train.checkpoint import Checkpointer as JaxCheckpointer
from gnot_tpu_torch import main as port_main
from gnot_tpu_torch.resilience import faults
from gnot_tpu_torch.resilience.retry import RetryPolicy
from gnot_tpu_torch.train.checkpoint import Checkpointer, host_copy
from torch_resilience_pairs import (
    ATOL,
    NO_WAIT,
    RTOL,
    ListSink,
    carry,
    initial_params,
    jax_trainer,
    port_trainer,
)

# -- fault 6: --resume with only a best checkpoint ----------------------------


def test_resume_without_latest_resumes_from_best_like_jax(tmp_path):
    """A run that kept only ``best`` (a checkpoint directory, no
    ``checkpoint_every``), resumed to 3 epochs: JAX restores ``best`` and
    goes on from its epoch with its AdamW state; so does the port (which
    read only ``latest`` and trained again from epoch 0 with fresh AdamW
    state). The same start epoch, the same restore event and the same step
    losses at 1e-4 / 1e-5."""
    jd, pd = str(tmp_path / "jax"), str(tmp_path / "port")
    jt = jax_trainer({}, jd)
    params = initial_params(jt)
    jt.fit()
    pt = port_trainer({}, pd)
    carry(pt, params)
    pt.fit()
    assert not os.path.exists(os.path.join(pd, "latest.json"))
    runs = {}
    for side, make, d in (("jax", jax_trainer, jd), ("port", port_trainer, pd)):
        sink = ListSink()
        t = make({"resume": True}, d, sink, epochs=3)
        t.initialize()
        start = t.start_epoch
        t.fit()
        runs[side] = (start, t.host_step, sink)
    (j_start, j_step, j_sink), (p_start, p_step, p_sink) = runs["jax"], runs["port"]
    assert p_start == j_start >= 1 and p_step == j_step
    want = [(r["step"], r["loss"]) for r in j_sink.records if "loss" in r and "event" not in r]
    got = [(r["step"], r["loss"]) for r in p_sink.records if "loss" in r and "event" not in r]
    # best holds the state after its epoch's steps, and that epoch trains again.
    assert [s for s, _ in got] == [s for s, _ in want] and got[0][0] == 4 * (j_start + 1) + 1
    np.testing.assert_allclose([l for _, l in got], [l for _, l in want], rtol=RTOL, atol=ATOL)
    (j_ev,), (p_ev,) = j_sink.events(), p_sink.events()
    assert (p_ev["event"], p_ev["requested"], p_ev["name"], p_ev["epoch"], p_ev["fallback"]) == (
        j_ev["event"], j_ev["requested"], j_ev["name"], j_ev["epoch"], j_ev["fallback"]) == (
        "restore_fallback", "latest", "best", j_start, True)


# -- the fallback walk: the same saves, the same corruption --------------------


def _saves(ck, value):
    """A two-epoch run's saves (``checkpoint_every`` 1): best and latest
    after each epoch, then the final wait."""
    for epoch, metric in ((0, 0.9), (1, 0.8)):
        ck.save_best(value(epoch), epoch, metric)
        ck.save_latest(value(epoch), epoch + 1, metric)
    ck.wait()


def _jax_side(d, spec=""):
    events = []
    ck = JaxCheckpointer(d, fault_injector=jax_faults.FaultInjector.from_spec(spec),
                         retry_policy=JaxRetryPolicy(**NO_WAIT),
                         on_event=lambda **e: events.append(e))
    _saves(ck, lambda e: {"w": jnp.full((3,), float(e))})
    return events


def _port_side(d, spec=""):
    events = []
    ck = Checkpointer(d, fault_injector=faults.FaultInjector.from_spec(spec),
                      retry_policy=RetryPolicy(**NO_WAIT), on_event=lambda **e: events.append(e))
    _saves(ck, lambda e: {"w": torch.full((3,), float(e))})
    return events


def _corrupt(d, how, port: bool):
    """One corruption shape, in each package's own format."""
    mod = faults if port else jax_faults
    kind = os.path.isfile if port else os.path.isdir
    named = lambda name: os.path.join(d, json.load(open(os.path.join(d, f"{name}.json")))["dir"])  # noqa: E731
    if how == "truncated latest":
        mod.corrupt_checkpoint(named("latest"), mode="truncate")
    elif how == "removed latest":
        mod.corrupt_checkpoint(named("latest"), mode="remove")
    elif how == "dangling sidecar":
        mod.dangle_sidecar(d, "latest")
    elif how == "missing sidecars":
        os.remove(os.path.join(d, "latest.json"))
        os.remove(os.path.join(d, "best.json"))
    elif how == "torn sidecar":
        with open(os.path.join(d, "latest.json"), "w") as f:
            f.write('{"epoch": 2, "di')
    elif how == "everything corrupt":
        for f in os.listdir(d):
            if kind(os.path.join(d, f)):
                mod.corrupt_checkpoint(os.path.join(d, f), mode="remove")
    elif how == "truncated latest and best":
        mod.corrupt_checkpoint(named("latest"), mode="truncate")
        mod.corrupt_checkpoint(named("best"), mode="truncate")


def _restored(ck, restore, as_number):
    out = restore()
    if out is None:
        return None, None
    r = ck.last_restore
    return ((r["requested"], r["name"], r["dir"].removesuffix(".pt"), r["epoch"],
             r["best_metric"], r["fallback"], len(r["skipped"])), as_number(out[0]["w"]))


SHAPES = ["intact", "truncated latest", "removed latest", "dangling sidecar", "missing sidecars",
          "torn sidecar", "everything corrupt", "truncated latest and best"]


@pytest.mark.parametrize("how", SHAPES)
def test_the_fallback_walk_picks_what_jax_picks(how, tmp_path):
    """The same save sequence and corruption: ``restore_latest`` and
    ``restore_best`` restore the same checkpoint (requested, name, file or
    directory, epoch, best metric, fallback, number of skips) holding the
    same values, or nothing."""
    got = {}
    for side in ("jax", "port"):
        d = str(tmp_path / side)
        (_port_side if side == "port" else _jax_side)(d)
        _corrupt(d, how, port=side == "port")
        if side == "port":
            ck = Checkpointer(d, retry_policy=RetryPolicy(**NO_WAIT))
            restores = (ck.restore_latest, ck.restore_best)
            num = lambda w: float(w[0])  # noqa: E731
        else:
            ck = JaxCheckpointer(d, retry_policy=JaxRetryPolicy(**NO_WAIT))
            target = {"w": jnp.zeros(3)}
            restores = (lambda: ck.restore_latest(target), lambda: ck.restore_best(target))
            num = lambda w: float(np.asarray(w)[0])  # noqa: E731
        got[side] = [_restored(ck, r, num) for r in restores]
    assert got["port"] == got["jax"]
    if how == "intact":
        assert got["port"][0][0][:3] == ("latest", "latest", "latest.2")
    if how == "everything corrupt":
        assert got["port"] == [(None, None)] * 2


def test_a_fallback_from_latest_names_the_file_it_skipped(tmp_path):
    """``restore_latest`` walking on to ``best`` emits one
    ``restore_fallback``; it also names the ``latest`` files that failed
    (``requested_skipped``, a key JAX's event lacks)."""
    events = _port_side(str(tmp_path))
    _corrupt(str(tmp_path), "truncated latest", port=True)
    events.clear()
    ck = Checkpointer(str(tmp_path), on_event=lambda **e: events.append(e))
    assert ck.restore_latest()[1] == 1
    (ev,) = events
    assert (ev["event"], ev["name"], ev["skipped"]) == ("restore_fallback", "best", [])
    assert [s.split(" ")[0] for s in ev["requested_skipped"]] == ["latest.2.pt"]


def test_transient_io_errors_are_retried_as_jax_retries_them(tmp_path):
    """``ckpt_io@3`` over the same save sequence: the same ``io_retry``
    events (operation and attempt) in the same order, and every save
    commits."""
    want = _jax_side(str(tmp_path / "jax"), "ckpt_io@3")
    got = _port_side(str(tmp_path / "port"), "ckpt_io@3")
    view = lambda evs: [(e["event"], e["op"], e["attempt"]) for e in evs]  # noqa: E731
    assert view(got) == view(want) == [("io_retry", "save:best", 1), ("io_retry", "save:best", 2),
                                       ("io_retry", "save:best", 3)]
    ck = Checkpointer(str(tmp_path / "port"))
    assert ck.restore_latest()[1:] == (2, 0.8) and ck.restore_best()[1:] == (1, 0.8)
    assert sorted(os.listdir(tmp_path / "port")) == ["best.1.pt", "best.json", "latest.2.pt",
                                                     "latest.json"]


def test_a_training_run_retries_ckpt_io_and_every_save_commits(tmp_path):
    sink = ListSink()
    t = port_trainer(dict(inject_fault="ckpt_io@2", checkpoint_every=1), str(tmp_path), sink)
    assert np.isfinite(t.fit())
    assert [(e["event"], e["op"]) for e in sink.events()] == [("io_retry", "save:best")] * 2
    ck = Checkpointer(str(tmp_path))
    assert ck.restore_latest()[1] == 2 and ck.restore_best() is not None


def test_corrupt_ckpt_then_resume_falls_back_like_jax(tmp_path):
    """``corrupt_ckpt@2`` truncates the published epoch-2 ``latest`` after
    the run; the same saves under JAX's injector and the port's, then a
    restore: the same fallback."""
    got = {}
    for side, saves in (("jax", _jax_side), ("port", _port_side)):
        d = str(tmp_path / side)
        saves(d, "corrupt_ckpt@2")
        if side == "port":
            ck = Checkpointer(d)
            ck.restore_latest()
        else:
            ck = JaxCheckpointer(d, retry_policy=JaxRetryPolicy(**NO_WAIT))
            ck.restore_latest({"w": jnp.zeros(3)})
        r = ck.last_restore
        got[side] = (r["requested"], r["name"], r["epoch"], r["fallback"], len(r["skipped"]))
    assert got["port"] == got["jax"] == ("latest", "best", 1, True, 0)
    sink = ListSink()
    t = port_trainer(dict(inject_fault="corrupt_ckpt@2", checkpoint_every=1),
                     str(tmp_path / "run"))
    t.fit()
    resumed = port_trainer(dict(resume=True), str(tmp_path / "run"), sink, epochs=3)
    resumed.initialize()
    (ev,) = sink.events()
    assert ev["event"] == "restore_fallback" and resumed.start_epoch == ev["epoch"]


def test_a_restore_honours_its_deadline(tmp_path):
    """Flaky I/O with a 30 s backoff: the restore finishes within its
    sub-second budget instead of sitting through the schedule."""
    _port_side(str(tmp_path))
    flaky = Checkpointer(str(tmp_path), fault_injector=faults.FaultInjector.from_spec("ckpt_io@1"),
                         retry_policy=RetryPolicy(attempts=4, base_delay_s=30.0))
    t0 = time.monotonic()
    assert flaky.restore_latest(deadline=time.monotonic() + 0.3) is not None
    assert time.monotonic() - t0 < 10.0


def test_an_async_save_is_not_corrupted_by_the_next_steps(tmp_path):
    """A ``latest`` saved mid-run and overlapped at once by in-place AdamW
    steps restores the state as of the save, bitwise (weights, moments,
    step counts): the save copied the state before returning."""
    t = port_trainer({})
    t.initialize()
    batches = list(t.train_loader)
    t.train_step(batches[0], 1e-3)
    want, _ = host_copy(t.state_dict())
    ck = Checkpointer(str(tmp_path))
    ck.save_latest(t.state_dict(), 1, 0.5)
    for b in batches[1:4]:  # graftlint: disable=GL001 — the port's Trainer.train_step donates nothing
        t.train_step(b, 1e-3)
    ck.wait()
    got = Checkpointer(str(tmp_path)).restore_latest()[0]
    assert got["step"] == 1 and t.host_step == 4
    for name, p in want["model"].items():
        assert torch.equal(got["model"][name], p), name
        assert not torch.equal(t.model.state_dict()[name], p), name
    for pid, s in want["optimizer"]["state"].items():
        for k, v in s.items():
            assert torch.equal(got["optimizer"]["state"][pid][k], v), (pid, k)
    assert float(want["optimizer"]["state"][0]["step"]) == 1.0


def test_saves_publish_after_commit_and_prune_what_they_supersede(tmp_path):
    """Each save is its own file; the sidecar names it only once it is
    committed (at the next save or ``wait``), older files of the name
    go then, and a save of an epoch whose file is published is
    uniquified instead of written over it."""
    ck = Checkpointer(str(tmp_path), extra_meta={"gelu": "tanh"})
    ck.save_latest({"w": torch.ones(2)}, 1, 0.5)
    assert not (tmp_path / "latest.json").exists()
    ck.save_latest({"w": torch.full((2,), 2.0)}, 2, 0.4)
    assert json.load(open(tmp_path / "latest.json")) == {
        "epoch": 1, "best_metric": 0.5, "dir": "latest.1.pt", "gelu": "tanh"}
    ck.wait()
    assert sorted(os.listdir(tmp_path)) == ["latest.2.pt", "latest.json"]
    again = Checkpointer(str(tmp_path))
    again.save_latest({"w": torch.full((2,), 3.0)}, 2, 0.3)
    again.wait()
    assert again.path("latest").name == "latest.2r1.pt"
    assert sorted(os.listdir(tmp_path)) == ["latest.2r1.pt", "latest.json"]
    payload = torch.load(again.path("latest"), weights_only=True)
    assert payload["epoch"] == 2 and torch.equal(payload["state"]["w"], torch.full((2,), 3.0))
    with pytest.raises(FileNotFoundError):
        again.path("best")


def test_a_numerics_mismatch_warns_with_jax_s_words(tmp_path, capsys):
    meta = {"gelu": "erf", "attention_mode": "masked", "dtype": "float32", "flat_params": False}
    old = dict(meta, gelu="tanh")
    port = Checkpointer(str(tmp_path / "p"), extra_meta=meta)._warn_numerics("best", old)
    port_out = capsys.readouterr().out
    jax_ret = JaxCheckpointer(str(tmp_path / "j"), extra_meta=meta)._warn_numerics("best", old)
    assert port is jax_ret is False and port_out == capsys.readouterr().out
    assert "gelu: checkpoint='tanh' current='erf'" in port_out
    missing = {"epoch": 1}
    Checkpointer(str(tmp_path / "p"), extra_meta=meta)._warn_numerics("best", missing)
    port_out = capsys.readouterr().out
    JaxCheckpointer(str(tmp_path / "j"), extra_meta=meta)._warn_numerics("best", missing)
    assert port_out == capsys.readouterr().out and "gelu/attention_mode/dtype" in port_out


def test_run_json_records_which_checkpoint_a_resume_restored(tmp_path):
    """``run.json``'s ``restore`` field is the checkpointer's
    ``last_restore``: null for a fresh run, the fallback to ``best`` for a
    resume of a best-only run."""
    ck, m = str(tmp_path / "ck"), str(tmp_path / "m.jsonl")
    base = ["--device", "cpu", "--synthetic", "darcy2d", "--n_train", "8", "--n_test", "4",
            "--n_attn_layers", "1", "--n_attn_hidden_dim", "16", "--n_mlp_num_layers", "1",
            "--n_mlp_hidden_dim", "16", "--n_input_hidden_dim", "16", "--n_expert", "2",
            "--n_head", "2", "--checkpoint_dir", ck, "--metrics_path", m]
    port_main.run(base + ["--epochs", "1"])
    run_json = tmp_path / "run.json"
    assert json.load(open(run_json))["restore"] is None
    port_main.run(base + ["--epochs", "2", "--resume"])
    restore = json.load(open(run_json))["restore"]
    assert (restore["requested"], restore["name"], restore["dir"], restore["fallback"]) == (
        "latest", "best", "best.0.pt", True)
    recs = [json.loads(line) for line in open(m)]
    assert [r["event"] for r in recs if "event" in r] == ["restore_fallback"]
