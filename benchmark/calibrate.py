"""The readings each limit of ``limits/<workload>.json`` is set from.

    python3 benchmark/calibrate.py --workload <name> --seeds 1 2 3 ...

For each seed, in one process on the card, at the cell's own sizes:

* ``program``: the numbers ``correct`` compares, of the program as the
  configuration states (training: set-up's three checked steps; serving:
  a short window at the cell's load). Their largest over a dozen seeds is
  a limit's lower reading.
* ``control`` (the first three seeds): the reference put in the
  program's place with its products in TF32, the nearest precision below
  the configuration's float32 with TF32 off, held to the float32
  reference. The smallest is a limit's upper reading.
* ``half_batch`` (training, with the control): the reference put in the
  program's place with half of each batch left out and the mean taken
  over the rest.
* ``bf16`` (the first three seeds): the program with its own bfloat16
  path switched on.

A state left unchanged reads 1 on ``change_gap_median`` by its
definition and needs no run. Prints one JSON line a seed and reading.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

#: Seeds that also read the control, the faults and the bf16 path.
CONTROL_SEEDS = 3
#: A serving seed's window, long enough for the pool's longest requests.
SERVE_SECONDS = 3.0


def _bf16(cell):
    config = dict(cell.config, model=dict(cell.config["model"], dtype="bfloat16"))
    return dataclasses.replace(cell, config=config)


def _half(batch: list) -> list:
    """The first half of a batch."""
    return batch[: len(batch) // 2]


def train_readings(cell, seed: int, device, *, control: bool, bf16: bool) -> list[tuple]:
    from benchmark import common, train_cell

    out = []
    st = train_cell.prepare(cell, seed, device)
    st["feed"].close()
    prog, weights, batches = st["prog"], st["weights"], st["checked"]
    del st
    common.release(device)
    r32 = train_cell.ref_readings(cell, weights, batches, device)
    out.append(("program", train_cell.compare(prog, r32)))
    if control:
        tf32 = train_cell.ref_readings(cell, weights, batches, device, tf32=True)
        out.append(("control", train_cell.compare(tf32, r32)))
        half = train_cell.ref_readings(cell, weights, [_half(b) for b in batches], device)
        out.append(("half_batch", train_cell.compare(half, r32)))
    if bf16:
        st = train_cell.prepare(_bf16(cell), seed, device)
        st["feed"].close()
        prog16 = st["prog"]
        del st
        common.release(device)
        out.append(("bf16", train_cell.compare(prog16, r32)))
    return out


def serve_readings(cell, seed: int, device, seconds: float, *, control: bool, bf16: bool):
    from benchmark import serve_cell

    out = []
    res = serve_cell.run(cell, seed, seconds, False, device, lambda: 0.0)
    out.append(("program", (res["numbers"], res["detail"])))
    if control:
        out.append(("control", serve_cell.control(res, cell, seed, device)))
    if bf16:
        res16 = serve_cell.run(_bf16(cell), seed, seconds, False, device, lambda: 0.0)
        out.append(("bf16", (res16["numbers"], res16["detail"])))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)

    import torch

    from benchmark import spec

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 3
    cell = spec.cell(args.workload)
    device = torch.device("cuda", 0)
    for i, seed in enumerate(args.seeds):
        t = time.perf_counter()
        first = i < CONTROL_SEEDS
        if cell.traffic["kind"] == "train":
            rows = train_readings(cell, seed, device, control=first, bf16=first)
        else:
            rows = serve_readings(cell, seed, device, SERVE_SECONDS, control=first, bf16=first)
        for what, (numbers, detail) in rows:
            print(json.dumps({"workload": cell.name, "seed": seed, "reading": what,
                              "numbers": numbers, "detail": detail,
                              "seconds": time.perf_counter() - t}, default=str), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
