"""Per-step timing probe of the port's train step.

Port of ``tools/honest_probe.py``: a thin command line over
``gnot_tpu_torch.bench.time_scan_marginal``, the one copy of the
estimator (windows of two lengths on one device-resident batch, the
marginal ms a step from their difference, each window ending in a hard
fetch, errors retried). The host's kernel launches of every step fall
inside the marginal (``bench.SCAN_MARGINAL_NOTE``). JAX's flags, plus
``--device`` (``cuda`` unless ``--device cpu`` is passed; without a card
``cuda`` raises), and its one printed line.

Usage::

    python -m gnot_tpu_torch.tools.honest_probe [--dtype bfloat16] [--ffn_impl xla]
        [--config ns2d] [--n_points 1024] [--batch_size 4] [--k1 25] [--k2 100]
        [--windows 3] [--remat] [--flat_params] [--n_attn_layers N] [--device cpu]
"""

from __future__ import annotations

import argparse


def main(argv=None) -> str:
    """Time the step and print (and return) the one line."""
    p = argparse.ArgumentParser(description="Marginal ms a step of the port's train step.")
    p.add_argument("--dtype", default="bfloat16")
    p.add_argument("--attention_impl", default="xla")
    p.add_argument("--ffn_impl", default="xla")
    p.add_argument("--config", default="ns2d")
    p.add_argument("--n_points", type=int, default=1024)
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--k1", type=int, default=25)
    p.add_argument("--k2", type=int, default=100)
    p.add_argument("--windows", type=int, default=3)
    p.add_argument("--remat", action="store_true")
    p.add_argument("--flat_params", action="store_true",
                   help="flat parameter/optimizer layout")
    p.add_argument("--n_attn_layers", type=int, default=0,
                   help="override depth (0 = reference default)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the step runs; cuda raises without a card")
    args = p.parse_args(argv)

    from gnot_tpu_torch import bench

    overrides = (
        {"n_attn_layers": args.n_attn_layers} if args.n_attn_layers else None
    )
    step, state, batch, mc = bench.build(
        args.dtype, args.attention_impl, args.n_points, args.batch_size,
        args.ffn_impl, args.config, args.remat, args.flat_params, overrides,
        device=args.device,
    )
    per = bench.time_scan_marginal(
        step, state, batch, 1e-3, state.device, args.k1, args.k2, args.windows,
    )
    label = f"{args.dtype} attn={args.attention_impl} ffn={args.ffn_impl} {args.config}"
    if args.n_attn_layers:
        label += f" layers={args.n_attn_layers}"
    if args.flat_params:
        label += " flat"
    line = (
        f"{label}: {per * 1e3:.2f} ms/step  "
        f"{batch.n_real_points / per / 1e6:.3f}M pts/s"
    )
    print(line, flush=True)
    return line


if __name__ == "__main__":
    main()
