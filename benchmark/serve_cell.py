"""A serving cell (``serve_closed``): closed-loop clients that each wait
for their answer.

Set-up builds a ``GNOT`` on the card with the harness's weights, an
``InferenceEngine`` and an ``InferenceServer`` over it, and starts the
server with one warm-up dispatch per bucket of the pool.

The window starts every client at once; each client is a chain of
futures: a done-callback on ``submit``'s ``Future`` reads the clock,
keeps the answer and submits that client's next mesh, so no thread is
made per client. Client ``c`` walks the pool's order from
``c * pool / clients`` on, so together the clients send the whole pool
in every round. Latency is the client's clock from ``submit`` to the
answer in hand, over the requests answered in the window.

At the window's end nothing more is sent; the answers still in flight
are waited for (a minute at most) and count as attempted.
Compared once the window has closed and the server is drained: a sample
of the requests completed in the window, drawn from the seed with the
longest mesh among them, each answer against the plain reference's
forward of its mesh in float32 with TF32 off (``output_gap``: the worst
request's L2 gap over the L2 norm of its mesh's target field).
"""

from __future__ import annotations

import math
import threading
import time

import numpy as np

from benchmark import common, costs, devtrace, meshes
from benchmark.reference import gnot as ref

#: A traced run profiles this many seconds after its window, from this
#: many seconds after the profiler is up.
SLICE_S, SETTLE_S = 3.0, 1.0
#: A minute past the window's close for the answers in flight.
DRAIN_S = 60.0
#: A client whose requests fail this many times in a row stops sending
#: (a refused request resolves at once, inside ``submit``).
MAX_FAILS = 100


class ClosedLoop:
    """``clients`` chains of requests over ``samples`` in ``order``."""

    def __init__(self, server, samples, order: list[int], clients: int):
        self.server, self.samples, self.order = server, samples, order
        self.start = [c * len(order) // clients for c in range(clients)]
        self.sent = [0] * clients
        self.fails = [0] * clients
        self.closed = False
        self.lock = threading.Lock()
        self.in_flight = 0
        self.idle = threading.Event()
        # (mesh index, submitted, answered, ok, output)
        self.records: list[tuple] = []

    def submit(self, c: int) -> None:
        with self.lock:
            if self.closed:
                return
            k = self.sent[c]
            self.sent[c] += 1
            self.in_flight += 1
            self.idle.clear()
        idx = self.order[(self.start[c] + k) % len(self.order)]
        t = time.perf_counter()
        fut = self.server.submit(self.samples[idx])
        fut.add_done_callback(lambda f: self._done(c, idx, t, f))

    def _done(self, c: int, idx: int, t_sub: float, fut) -> None:
        t = time.perf_counter()
        res = fut.result()
        with self.lock:
            self.records.append((idx, t_sub, t, res.ok, res.output if res.ok else None))
            self.in_flight -= 1
            if self.in_flight == 0:
                self.idle.set()
            self.fails[c] = 0 if res.ok else self.fails[c] + 1
            stop = self.fails[c] >= MAX_FAILS
        if not stop:
            self.submit(c)

    def begin(self) -> None:
        for c in range(len(self.start)):
            self.submit(c)

    def close(self) -> None:
        with self.lock:
            self.closed = True
            if self.in_flight == 0:
                self.idle.set()


def run(cell, seed: int, seconds: float, trace: bool, device, setup_clock) -> dict:
    import torch

    from gnot_tpu_torch.config import ModelConfig
    from gnot_tpu_torch.data.batch import MeshSample
    from gnot_tpu_torch.device import resolve_device
    from gnot_tpu_torch.models.gnot import GNOT
    from gnot_tpu_torch.obs.tracing import Tracer
    from gnot_tpu_torch.serve.engine import InferenceEngine
    from gnot_tpu_torch.serve.server import InferenceServer

    model_cfg, tr = cell.config["model"], cell.traffic
    # As ``main --serve`` does: TF32 off for every product on the card.
    device = resolve_device(str(device))
    pool = meshes.pool(cell.config["data"], tr["pool"], seed)
    samples = [MeshSample(coords=m.coords, y=m.y, theta=m.theta, funcs=m.funcs) for m in pool]
    with torch.device(device):
        model = GNOT(ModelConfig(**model_cfg))
    weights = common.make_weights(model_cfg, seed, device)
    common.load_weights(model, weights)
    model.eval()
    engine = InferenceEngine(model, batch_size=tr["max_batch"], dtype=model_cfg["dtype"])
    tracer = (Tracer(clock=time.perf_counter, sample_rate=1.0, max_spans=10_000_000)
              if trace else None)
    server = InferenceServer(engine, max_batch=tr["max_batch"], max_wait_ms=tr["max_wait_ms"],
                             queue_limit=tr["queue_limit"], tracer=tracer,
                             clock=time.perf_counter)
    server.start(warmup=samples)
    common.sync(device)
    setup_s = setup_clock()

    loop = ClosedLoop(server, samples, list(range(len(samples))), tr["clients"])
    t0 = time.perf_counter()
    loop.begin()
    time.sleep(seconds)
    t_close = time.perf_counter()
    window_s = t_close - t0
    summary = server.summary()
    counts = {}
    if trace:
        # The profiled slice follows the window under the same load: the
        # profiler's start holds the interpreter's lock for seconds, which
        # would starve the worker inside the window.
        prof = devtrace.Slice()
        prof.start(settle=SETTLE_S)
        counts["before"] = server.summary()["dispatches"]
        time.sleep(SLICE_S)
        counts["after"] = server.summary()["dispatches"]
        prof.stop()
    loop.close()
    loop.idle.wait(DRAIN_S)
    data = prof.read() if trace else None
    server.drain(timeout_s=DRAIN_S)
    peak = common.peak_bytes(device)
    spans = tracer.snapshot() if tracer is not None else []
    with loop.lock:
        records = list(loop.records)
        unanswered = loop.in_flight
    del server, engine, model
    common.release(device)

    done = [r for r in records if r[3] and r[2] <= t_close]
    latencies = [(r[2] - r[1]) * 1e3 for r in done]
    numbers, detail = check(done, pool, weights, model_cfg, tr["checked_requests"], seed, device)
    real_flops = sum(costs.mesh_flops(model_cfg, pool[r[0]].coords.shape[0],
                                      pool[r[0]].funcs[0].shape[0] if pool[r[0]].funcs else 0)
                     for r in done)
    ctx = {
        "kind": "serve", "config": cell.config, "traffic": tr, "window_s": window_s,
        "completed": len(done), "summary": summary,
        "forward_flops_real": float(real_flops), "rate_s": window_s,
        "trace": data, "slice_dispatches": counts.get("after", 0) - counts.get("before", 0),
        "spans": spans, "window_end": t_close,
    }
    return {
        "values": {
            "serve_meshes_per_s": len(done) / window_s,
            "serve_latency_p95_ms": float(np.percentile(latencies, 95)) if latencies else math.inf,
            "peak_mem_gib": peak / 2**30,
            "setup_s": setup_s,
        },
        "attempted": len(records) + unanswered,
        "failed": sum(1 for r in records if not r[3]) + unanswered,
        "numbers": numbers,
        "detail": detail,
        "memory_peak_bytes": peak,
        "ctx": ctx,
        "state": {"done": done, "pool": pool, "weights": weights},
    }


def sample(done: list, count: int, seed: int, pool) -> list:
    """``count`` of the completed requests drawn from the seed, the one
    with the longest mesh among them."""
    if not done:
        return []
    rng = np.random.default_rng([common.seed_of(seed), 7])
    longest = max(range(len(done)), key=lambda i: pool[done[i][0]].coords.shape[0])
    rest = [i for i in rng.permutation(len(done)) if i != longest]
    return [done[i] for i in [longest, *rest[:count - 1]]]


def check(done: list, pool, weights: dict, model_cfg: dict, count: int, seed: int, device):
    """``output_gap`` over the sample, against the float32 reference: each
    answer's L2 distance from the reference's over the L2 norm of its
    mesh's target field, the units of the rel-L2 metric the model is
    trained and scored on. (Over
    the reference's own output's norm it would swing with the seed: a
    seed's weights can give outputs near 0, on which float32 itself, the
    reference's included, reads 1e-5.)"""
    picked = sample(done, count, seed, pool)
    if not picked:
        return {"output_gap": math.inf}, {"compared": 0}
    expect = {}
    with ref.precision(False):
        for idx in sorted({r[0] for r in picked}):
            expect[idx] = ref.predict(weights, model_cfg, pool[idx], device).cpu().numpy()
    common.release(device)
    worst, at = 0.0, None
    for idx, *_, out in picked:
        want = expect[idx].astype(np.float64)
        scale = np.linalg.norm(pool[idx].y.astype(np.float64))
        gap = float(np.linalg.norm(out.astype(np.float64) - want) / scale)
        if not math.isfinite(gap):
            return {"output_gap": math.inf}, {"compared": len(picked), "worst_mesh": idx}
        if gap > worst:
            worst, at = gap, idx
    return {"output_gap": worst}, {"compared": len(picked), "meshes": len(expect),
                                   "worst_mesh": at}


def control(res: dict, cell, seed: int, device) -> tuple[dict, dict]:
    """``output_gap`` of the reference in TF32 put in the program's place,
    on the requests a run ``res`` compared."""
    st, model_cfg = res["state"], cell.config["model"]
    count = cell.traffic["checked_requests"]
    picked = sample(st["done"], count, seed, st["pool"])
    with ref.precision(True):
        outs = {idx: ref.predict(st["weights"], model_cfg, st["pool"][idx], device).cpu().numpy()
                for idx in {r[0] for r in picked}}
    fake = [(r[0], r[1], r[2], True, outs[r[0]]) for r in picked]
    return check(fake, st["pool"], st["weights"], model_cfg, count, seed, device)
