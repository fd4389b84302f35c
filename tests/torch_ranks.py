"""Rank processes for the port's multi-rank CPU tests
(``test_torch_collectives.py``, ``test_torch_parallel.py``).

``launch`` starts N processes of this file, one a rank, with the
environment ``torchrun`` would give them (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``), so
each joins its gloo group through the port's own
``multihost.initialize``. A rank runs one scenario on the payload the test
wrote, saves what it found to ``<out>/rank<r>.pt`` and exits. Every wait
is bounded: the group's timeout, and the launcher's deadline, after which
it kills every rank. The ranks import torch and the port only.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
GROUP_TIMEOUT_S = 60.0


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_env(rank: int, world: int, port: int) -> dict:
    env = dict(os.environ)
    env.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
               LOCAL_WORLD_SIZE=str(world), GROUP_RANK="0", MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(port), OMP_NUM_THREADS="1",
               GNOT_DIST_TIMEOUT_S=str(GROUP_TIMEOUT_S))
    env.pop("XLA_FLAGS", None)
    return env


def write_payload(payload: dict, path: Path) -> None:
    """``torch.save`` of a payload, renamed into place whole: ranks started
    before it exists wait for it."""
    import torch

    tmp = path.with_suffix(".tmp")
    torch.save(payload, tmp)
    os.replace(tmp, path)


class Launch:
    """N rank processes of ``scenario`` on ``payload`` (a ``torch.save``
    file, which may be written after the start: ``write_payload``),
    started at once; ``wait`` collects their results."""

    def __init__(self, scenario: str, world: int, payload: Path, out: Path):
        self.out = out
        out.mkdir(parents=True, exist_ok=True)
        port = free_port()
        self.procs = [
            subprocess.Popen(
                [sys.executable, __file__, scenario, str(payload), str(out)],
                env=rank_env(r, world, port), cwd=ROOT,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            for r in range(world)
        ]

    def wait(self, timeout_s: float) -> list[dict]:
        import torch

        deadline = time.monotonic() + timeout_s
        logs = []
        try:
            for p in self.procs:
                out, _ = p.communicate(timeout=max(0.1, deadline - time.monotonic()))
                logs.append(out)
        except subprocess.TimeoutExpired:
            self.kill()
            raise AssertionError(f"ranks still running after {timeout_s} s; killed") from None
        bad = [(r, p.returncode) for r, p in enumerate(self.procs) if p.returncode]
        if bad:
            raise AssertionError(
                f"ranks failed {bad}:\n" + "\n".join(f"--- rank {r}:\n{logs[r][-3000:]}"
                                                      for r, _ in bad))
        return [torch.load(self.out / f"rank{r}.pt", weights_only=False)
                for r in range(len(self.procs))]

    def kill(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
        for p in self.procs:
            p.wait()


def place(full: np.ndarray, block: np.ndarray, spec: tuple, shape: dict, coords: dict) -> None:
    """Write a rank's ``block`` of an array split by ``spec`` into
    ``full``."""
    idx = []
    for dim, axis in enumerate(spec):
        n = full.shape[dim]
        if axis is None or shape[axis] == 1:
            idx.append(slice(None))
        else:
            step = n // shape[axis]
            idx.append(slice(coords[axis] * step, (coords[axis] + 1) * step))
    full[tuple(idx)] = block


# --------------------------------------------------------------------------
# Scenarios (run inside a rank).
# --------------------------------------------------------------------------


def _collectives(payload: dict, rank: int) -> dict:
    """``fused_nla_sp`` on each case's mesh (its blocks and its part of
    the gradients), the ring against the all-reduce, and the agreements."""
    import torch

    from gnot_tpu_torch.config import MeshConfig
    from gnot_tpu_torch.ops.collectives import all_reduce_sum, ring_allreduce
    from gnot_tpu_torch.ops.fused_attention import fused_nla_sp
    from gnot_tpu_torch.parallel import multihost
    from gnot_tpu_torch.parallel.mesh import make_mesh

    q, k, v, mask, h = (payload[n] for n in ("q", "k", "v", "mask", "n_head"))
    out = {"cases": {}}
    for name, case in payload["cases"].items():
        mesh = make_mesh(MeshConfig(**case["mesh"]))
        qs_, ks_, vs_ = (t.clone().requires_grad_(True) for t in (q, k, v))
        o, qs = fused_nla_sp(qs_, ks_, vs_, mask, h, mesh, **case["kwargs"])
        (torch.sum(o ** 2) + torch.sum(qs * 0.5)).backward()
        out["cases"][name] = {
            "shape": mesh.shape, "coords": mesh.coords, "out": o.detach(), "qs": qs.detach(),
            "grads": [t.grad for t in (qs_, ks_, vs_)],
        }
    # The ring against the all-reduce on a generic tensor, and its backward.
    mesh = make_mesh(MeshConfig(seq=8))
    x = torch.arange(12, dtype=torch.float32).reshape(3, 4) * (rank + 1)
    xr, xp = x.clone().requires_grad_(True), x.clone().requires_grad_(True)
    yr = ring_allreduce(xr, mesh.group("seq"))
    yp = all_reduce_sum(xp, mesh.group("seq"))
    w = torch.full_like(x, float(rank))
    (yr * w).sum().backward()
    (yp * w).sum().backward()
    out["ring"] = {"ring": yr.detach(), "psum": yp.detach(), "g_ring": xr.grad,
                   "g_psum": xp.grad}
    out["agree"] = {
        "flag_one": multihost.sync_flag(rank == 5),
        "flag_none": multihost.sync_flag(False),
        "same": multihost.all_agree("latest:latest.3.pt"),
        "diverged": multihost.all_agree("latest:latest.3.pt" if rank != 2 else "x"),
        "gauge": multihost.per_host_gauge(float(rank)),
    }
    return out


def _small_config(payload: dict, *, mesh: dict | None, batch_size: int, **over):
    """The config of a case: ``over`` may set the optimizer's ``grad_accum``
    and ``flat_params``, the model's ``n_attn_layers``, ``scan_layers``,
    ``attention_mode`` and ``gelu``, the data's ``packed``; the rest are
    train fields."""
    from gnot_tpu_torch.config import (
        Config, DataConfig, MeshConfig, ModelConfig, OptimConfig, TrainConfig)

    model = {k: over.pop(k) for k in ("n_attn_layers", "scan_layers", "attention_mode", "gelu")
             if k in over}
    mc = ModelConfig(**dict(payload["model"], **model))
    optim = OptimConfig(grad_accum=over.pop("grad_accum", 1),
                        flat_params=over.pop("flat_params", False))
    data = DataConfig(batch_size=batch_size, packed=over.pop("packed", False),
                      pack_chunk=PACK_CHUNK)
    train = dict(epochs=1, graceful_preempt=False, distributed=bool(mesh), seed=0)
    train.update(over)
    cfg = Config(optim=optim, data=data, train=TrainConfig(**train),
                 mesh=MeshConfig(**(mesh or {})))
    return cfg, mc


#: The packed cases' chunk, and their samples: NS2d graphs of 64 and of 32
#: points, so rows (and so data ranks) hold different numbers of samples.
PACK_CHUNK = 16


def packed_samples(datasets):
    """``datasets`` is the port's or the JAX package's module."""
    big = datasets.synth_ns2d(6, n_points=64)
    small = datasets.synth_ns2d(6, seed=9, n_points=32)
    return [s for pair in zip(big, small) for s in pair]


def _train(payload: dict, rank: int) -> dict:
    """The sharded train steps of each case from the carried JAX weights,
    the ragged-tail eval, telemetry on a mesh, the stop agreement and the
    restore-walk agreement."""
    import torch

    from gnot_tpu_torch.data import datasets
    from gnot_tpu_torch.data.batch import Loader, PackedLoader
    from gnot_tpu_torch.parallel import multihost
    from gnot_tpu_torch.train.checkpoint import Checkpointer
    from gnot_tpu_torch.train.trainer import Trainer, stack_batches

    samples = datasets.synth_ns2d(16, n_points=64)
    # Each call takes a fresh copy: the port's eager steps donate nothing,
    # but JAX's linter (tests/test_analysis.py) reads a batch passed to a
    # ``train_step`` as donated.
    def batches():
        return list(Loader(samples, 8))
    lrs = payload["lrs"]
    out = {"cases": {}}
    for name, case in payload["cases"].items():
        over = dict(case.get("over", {}))
        cfg, mc = _small_config(payload, mesh=case["mesh"], batch_size=8, **over)
        data = packed_samples(datasets) if cfg.data.packed else samples
        trainer = Trainer(cfg, mc, data, [], device="cpu")
        trainer.initialize()
        trainer.load_standard_params(payload["params"][mc.n_attn_layers])
        res = {}
        if cfg.data.packed:
            # The unshuffled first dispatch, rows a multiple of the data axis.
            batch = PackedLoader(data, 8, chunk=PACK_CHUNK, row_multiple=4).probe_batch()
            block = trainer._device_batch(batch).node_seg
            res["segments"] = int(torch.unique(block[block < batch.n_seg]).numel())
            res["losses"] = [float(trainer.train_step(batch, lrs[0]))]
        elif case["steps"] == "single":
            telem = {} if case.get("telemetry") else None
            res["losses"] = [float(trainer.train_step(batches()[0], lrs[0], telem))]
            if telem is not None:
                res["telemetry"] = {k: v.detach().clone() for k, v in telem.items()}
                if rank == 0:
                    out["single_telemetry"] = _single_telemetry(payload, samples,
                                                                batches()[0])
        elif case["steps"] == "two":
            res["losses"] = [float(trainer.train_step(b, lr)) for b, lr in zip(batches(), lrs)]
        else:  # one dispatch of two steps
            res["losses"] = trainer.multi_train_step(stack_batches(batches()), lrs).tolist()
            res["multi_eval"] = trainer.multi_eval_step(stack_batches(batches())).tolist()
        params = trainer.standard_params()
        if rank == 0:
            res["params"] = {n: t.detach().clone() for n, t in params.items()}
        if case.get("roundtrip"):
            res["roundtrip"] = _checkpoint_roundtrip(trainer, cfg, mc, samples)
        out["cases"][name] = res
    out["eval"] = _ragged_eval(payload, dict(data=2, seq=2, model=2))
    out["pipe_eval"] = _ragged_eval(payload, dict(data=2, model=2, pipe=2))
    out["stop"] = _stop_agreement(payload, rank, dict(data=4, seq=2), stop_dir=payload["stop_dir"])
    out["pipe_stop"] = _stop_agreement(payload, rank, dict(data=2, model=2, pipe=2),
                                       stop_dir=payload["pipe_stop_dir"])
    out["serve"] = _serve_mesh(payload, rank)
    out["serve_sigterm"] = _serve_sigterm(payload, rank)
    out["diverge"] = {}
    for which, dirs in payload["diverge"].items():
        try:
            Checkpointer(dirs[rank]).restore_latest()
            out["diverge"][which] = "restored"
        except RuntimeError as exc:
            out["diverge"][which] = str(exc)
    out["process"] = (multihost.process_index(), multihost.process_count())
    return out


def _checkpoint_roundtrip(trainer, cfg, mc, samples) -> bool:
    """A checkpoint's whole state (gathered from the shards) loaded into a
    fresh trainer on the same mesh (each rank keeping its shards) gathers
    back bitwise: weights, both AdamW moments and the step counts."""
    import torch

    from gnot_tpu_torch.train.trainer import Trainer

    state = trainer.checkpoint_state()
    fresh = Trainer(cfg, mc, samples, [], device="cpu")
    fresh.initialize()
    fresh.load_checkpoint_state(state)
    again = fresh.checkpoint_state()

    def same(a, b):
        if isinstance(a, torch.Tensor):
            return torch.equal(a, b)
        if isinstance(a, dict):
            return a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
        if isinstance(a, list):
            return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
        return a == b

    return same(state, again)


def _single_telemetry(payload: dict, samples, batch) -> dict:
    """The telemetry of the same step on one device (no mesh)."""
    from gnot_tpu_torch.train.trainer import Trainer

    cfg, mc = _small_config(payload, mesh=None, batch_size=8)
    single = Trainer(cfg, mc, samples, [], device="cpu")
    single.initialize()
    single.load_standard_params(payload["params"][mc.n_attn_layers])
    telem = {}
    single.train_step(batch, payload["lrs"][0], telem)
    return {k: v.detach().clone() for k, v in telem.items()}


def _ragged_eval(payload: dict, mesh: dict) -> float:
    """``evaluate`` on ``mesh`` over 6 test samples in batches of 4: the
    tail batch is filled with repeats and scored per sample."""
    from gnot_tpu_torch.data import datasets
    from gnot_tpu_torch.train.trainer import Trainer

    samples = datasets.synth_ns2d(16, n_points=64)
    tests = datasets.synth_ns2d(6, seed=5, n_points=64)
    cfg, mc = _small_config(payload, mesh=mesh, batch_size=4)
    trainer = Trainer(cfg, mc, samples[:8], tests, device="cpu")
    trainer.initialize()
    trainer.load_standard_params(payload["params"][mc.n_attn_layers])
    return trainer.evaluate()


def _stop_agreement(payload: dict, rank: int, mesh: dict, stop_dir: str) -> dict:
    """Two epochs of two steps on ``mesh`` where only rank 5 gets SIGTERM,
    at step 3: every rank stops at step 3 and rank 0 saves ``latest``
    (epoch 1, replayed on resume). A fresh trainer resumed from it, and the
    stopped trainer carried on in memory from the same epoch (no checkpoint
    in between), end on the same weights and losses."""
    from gnot_tpu_torch.data import datasets
    from gnot_tpu_torch.train.checkpoint import Checkpointer
    from gnot_tpu_torch.train.trainer import Trainer

    samples = datasets.synth_ns2d(16, n_points=64)

    def trainer_for(**over):
        cfg, mc = _small_config(payload, mesh=mesh, batch_size=4,
                                epochs=2, graceful_preempt=True, checkpoint_dir=stop_dir,
                                **over)
        return Trainer(cfg, mc, samples[:8], samples[8:12], device="cpu",
                       checkpointer=Checkpointer(stop_dir))

    def final(t):
        return {"host_step": t.host_step, "loss": t.history[-1].train_loss,
                "params": {n: v.detach().clone() for n, v in t.standard_params().items()}}

    stopped = trainer_for(**({"inject_fault": "sigterm@3"} if rank == 5 else {}))
    stopped.fit()
    res = {"stop_step": stopped.host_step, "stop_epochs": len(stopped.history),
           "latest": Checkpointer(stop_dir)._read_sidecar("latest")}
    state = Checkpointer(stop_dir).restore_latest()[0]  # every rank's walk agrees
    res["saved_shapes"] = {n: tuple(t.shape) for n, t in state["model"].items()}
    resumed = trainer_for(resume=True)
    resumed.fit()
    res["resumed"] = final(resumed)
    stopped.checkpointer = None
    stopped.start_epoch = len(stopped.history)
    stopped.fit()
    res["carried_on"] = final(stopped)
    return res


#: The serving scenarios' mesh and requests: NS2d graphs of 64 points.
SERVE_MESH = dict(data=2, seq=2, model=2)


def serve_samples(datasets):
    """The serving scenarios' train split (which fixes the pad lengths) and
    requests; ``datasets`` is the port's or the JAX package's module."""
    return datasets.synth_ns2d(8, n_points=64), datasets.synth_ns2d(8, seed=7, n_points=64)


def _serve_mesh(payload: dict, rank: int) -> dict:
    """Serving on data2 x seq2 x model2 (``serve/mesh_serve.py``): rank 0's
    ``InferenceServer`` over a ``MeshEngine`` publishing the carried
    weights, the 8 requests, a hot reload to the second weight set, the 8
    requests again, then a bf16 engine and a packed one on the same
    trainer; every other rank follows. Rank 3 sends itself a SIGTERM after its second op, which
    must not end it."""
    import signal

    import torch

    from gnot_tpu_torch.data import datasets
    from gnot_tpu_torch.data.batch import PackPlan, pack_prefix
    from gnot_tpu_torch.models.gnot import GNOT
    from gnot_tpu_torch.serve import mesh_serve
    from gnot_tpu_torch.serve.engine import InferenceEngine
    from gnot_tpu_torch.serve.server import InferenceServer
    from gnot_tpu_torch.train.trainer import Trainer

    cfg, mc = _small_config(payload, mesh=SERVE_MESH, batch_size=4)
    train, reqs = serve_samples(datasets)
    trainer = Trainer(cfg, mc, train, reqs, device="cpu")
    weights, reload = payload["params"][2], payload["serve_reload"]
    if rank != 0:
        if rank == 3:
            recv, seen = mesh_serve.Wire.recv, []

            def recv_then_signal(wire):
                got = recv(wire)
                seen.append(got[0]["op"])
                if len(seen) == 2:
                    os.kill(os.getpid(), signal.SIGTERM)
                return got

            mesh_serve.Wire.recv = recv_then_signal
        out = {"f32": mesh_serve.follow(trainer, dtype="float32"),
               "bf16": mesh_serve.follow(trainer, dtype="bfloat16"),
               "packed": mesh_serve.follow(trainer, dtype="float32")}
        return out
    out = {}
    engine = mesh_serve.MeshEngine(trainer, batch_size=4)
    try:
        engine.swap_params(weights)
        server = InferenceServer(engine, max_batch=4, max_wait_ms=1.0,
                                 reload_fn=lambda **kw: (reload, {"name": "reload"}))
        server.start(warmup=reqs)
        first = [f.result(timeout=60) for f in [server.submit(s) for s in reqs]]
        reloaded = server.reload()
        second = [f.result(timeout=60) for f in [server.submit(s) for s in reqs]]
        out["summary"] = server.drain(timeout_s=60)
    finally:
        engine.close()
    out.update(reloaded=reloaded, stats=mesh_serve.stats_summary(engine.stats),
               ok=[r.ok for r in first + second],
               outputs=[r.output for r in first], reload_outputs=[r.output for r in second])
    # bf16 on the same mesh, against the port's single-device bf16 engine.
    engine = mesh_serve.MeshEngine(trainer, batch_size=4, dtype="bfloat16")
    try:
        engine.swap_params(weights)
        pn, pf = engine.bucket_key(reqs[0])
        out["bf16"] = [o for i in range(0, 8, 4)
                       for o in engine.infer(reqs[i:i + 4], pad_nodes=pn, pad_funcs=pf)]
    finally:
        engine.close()
    # Packed dispatches (rows over data, every point on each seq rank).
    plan = PackPlan.for_slices(reqs, chunk=PACK_CHUNK, batch_size=4,
                               per_devices=trainer.mesh.local_data)
    groups, rest = [], list(reqs)
    while rest:
        n = len(pack_prefix([r.coords.shape[0] for r in rest], plan))
        groups.append(rest[:n])
        rest = rest[n:]
    engine = mesh_serve.MeshEngine(trainer, batch_size=4)
    try:
        engine.swap_params(weights)
        out["packed"] = [o for g in groups for o in engine.infer_packed(g, plan)]
    finally:
        engine.close()
    out["packed_rows"] = plan.n_rows
    single = GNOT(mc)
    single.load_state_dict(weights)
    one = InferenceEngine(single, batch_size=4, dtype="bfloat16")
    out["bf16_single"] = [o for i in range(0, 8, 4)
                          for o in one.infer(reqs[i:i + 4], pad_nodes=pn, pad_funcs=pf)]
    one32 = InferenceEngine(single, batch_size=4)
    out["f32_single"] = [o for i in range(0, 8, 4)
                         for o in one32.infer(reqs[i:i + 4], pad_nodes=pn, pad_funcs=pf)]
    out["packed_single"] = [o for g in groups for o in one32.infer_packed(g, plan)]
    return out


def _serve_sigterm(payload: dict, rank: int) -> dict:
    """``main --serve --distributed`` on data2 x seq2 x model2 on every rank
    (the CLI's path, in the group this rank already joined), rank 0 sending
    itself a SIGTERM as it submits the third request: rank 0 stops
    submitting and drains, every rank returns."""
    import signal

    from gnot_tpu_torch import main as port_main
    from gnot_tpu_torch.serve.server import InferenceServer

    argv = ["--serve", "--distributed", "--device", "cpu", "--mesh_data", "2", "--mesh_seq", "2",
            "--mesh_model", "2", "--synthetic", "ns2d", "--synth_size", "64", "--n_train", "8",
            "--n_test", "8", "--n_attn_layers", "1", "--n_attn_hidden_dim", "16",
            "--n_mlp_num_layers", "1", "--n_mlp_hidden_dim", "16", "--n_input_hidden_dim", "16",
            "--n_expert", "2", "--n_head", "2"]
    if rank == 0:
        submit, calls = InferenceServer.submit, []

        def submit_then_signal(server, sample, **kw):
            calls.append(1)
            if len(calls) == 3:
                os.kill(os.getpid(), signal.SIGTERM)
            return submit(server, sample, **kw)

        InferenceServer.submit = submit_then_signal
    try:
        run = port_main.run(argv)
    finally:
        if rank == 0:
            InferenceServer.submit = submit
    if run.follower is not None:
        return {"follower": run.follower}
    return {"summary": {k: run.summary[k] for k in ("requests", "completed", "mesh")}}


def _dead_follower(payload: dict, rank: int) -> dict:
    """The last act of the serving mesh (data2 x seq2 x model2), after the
    results are saved: rank 7 dies after its first op (the weights); rank
    0's next dispatch must raise, not wait, and every later op raise at
    once; the other followers' waits end when rank 0 leaves."""
    from gnot_tpu_torch.data import datasets
    from gnot_tpu_torch.serve import mesh_serve
    from gnot_tpu_torch.train.trainer import Trainer

    cfg, mc = _small_config(payload, mesh=SERVE_MESH, batch_size=4)
    train, reqs = serve_samples(datasets)
    trainer = Trainer(cfg, mc, train, reqs, device="cpu")
    t0 = time.monotonic()
    if rank == 0:
        engine = mesh_serve.MeshEngine(trainer, batch_size=4)
        engine.swap_params(payload["params"][2])
        pn, pf = engine.bucket_key(reqs[0])
        out = {"raised": None, "dispatched": 0}
        try:
            for _ in range(4):
                engine.infer(reqs[:4], pad_nodes=pn, pad_funcs=pf)
                out["dispatched"] += 1
        except Exception as exc:  # noqa: BLE001 — what the test reads
            out["raised"] = f"{type(exc).__name__}: {exc}"
        out["raised_after_s"] = time.monotonic() - t0
        try:
            engine.infer(reqs[:4], pad_nodes=pn, pad_funcs=pf)
        except RuntimeError as exc:
            out["then"] = str(exc)
        engine.close()  # sends nothing after a failure
        return out
    if rank == 7:
        recv = mesh_serve.Wire.recv

        def recv_then_die(wire):
            got = recv(wire)
            os._exit(0)

        mesh_serve.Wire.recv = recv_then_die
    try:
        mesh_serve.follow(trainer, dtype="float32")
        return {"raised": None}
    except Exception as exc:  # noqa: BLE001 — what the test reads
        return {"raised": f"{type(exc).__name__}: {exc}", "after_s": time.monotonic() - t0}


def _sp_cuda(payload: dict, rank: int) -> dict:
    """``fused_nla_sp`` over 2 ranks sharing the card (gloo with CUDA
    tensors), psum and ring: its blocks, its gradient parts and its kernel
    launches."""
    import torch

    from gnot_tpu_torch.config import MeshConfig
    from gnot_tpu_torch.ops import fused_attention as fa
    from gnot_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(MeshConfig(seq=2))
    q, k, v, mask = (payload[n].cuda() for n in ("q", "k", "v", "mask"))
    out = {"coords": mesh.coords, "cases": {}}
    for coll in ("psum", "ring"):
        fa.nla_reduce_kernel.launches = fa.nla_apply_kernel.launches = 0
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        o, qs = fa.fused_nla_sp(*leaves, mask, payload["n_head"], mesh, sp_collective=coll)
        (torch.sum(o**2) + torch.sum(qs * 0.5)).backward()
        out["cases"][coll] = {
            "out": o.detach().cpu(), "qs": qs.detach().cpu(),
            "grads": [t.grad.cpu() for t in leaves],
            "launches": [fa.nla_reduce_kernel.launches, fa.nla_apply_kernel.launches]}
    return out


SCENARIOS = {"collectives": _collectives, "train": _train, "sp_cuda": _sp_cuda}
#: What a scenario's ranks do after saving their results, each saving its
#: own to ``<out>/<name><rank>.pt`` and leaving without the group's
#: teardown (the finale breaks the group on purpose).
FINALES = {"train": ("dead", _dead_follower)}


def main() -> None:
    scenario, payload_path, out = sys.argv[1:4]
    sys.path.insert(0, str(ROOT))
    import torch

    torch.set_num_threads(1)
    from gnot_tpu_torch.parallel import multihost

    multihost.initialize("cuda" if scenario.endswith("_cuda") else "cpu",
                         timeout_s=GROUP_TIMEOUT_S)
    try:
        # The launcher may start the ranks before it has written the payload.
        deadline = time.monotonic() + GROUP_TIMEOUT_S
        while not os.path.exists(payload_path):
            if time.monotonic() > deadline:
                raise TimeoutError(f"no payload at {payload_path}")
            time.sleep(0.05)
        payload = torch.load(payload_path, weights_only=False)
        rank = multihost.process_index()
        result = SCENARIOS[scenario](payload, rank)
        torch.save(result, Path(out) / f"rank{rank}.pt")
        if scenario in FINALES:
            name, finale = FINALES[scenario]
            torch.save(finale(payload, rank), Path(out) / f"{name}{rank}.pt")
            sys.stdout.flush()
            os._exit(0)
    finally:
        multihost.shutdown()


if __name__ == "__main__":
    main()
