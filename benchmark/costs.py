"""The benchmark's yardstick: operations, bytes and the card's peaks.

Frozen here so that a change to the program cannot change what its work
is counted as; ``tests/test_harness_costs.py`` holds the forward count to
the program's own count of today (``obs/costs.py::program_costs``).

* ``forward_flops``: every matrix product of one GNOT forward at
  ``2·M·K·N``, at a padded shape ``[rows, pad_nodes]`` with input
  functions padded to ``pad_funcs``: the gate, the query and
  input-function MLPs, each block's projections, its attention's
  normalizer, Gram and apply, its expert Linears and their gate-weighted
  sum, and the output head. A mesh's real work is the count at its own
  sizes (``rows=1``).
* ``ffn_kernel_cost``: one launch of the gated expert FFN on ``rows``
  tokens: every expert's Linears (operations), and each input and output
  byte once (bytes), whatever the kernel re-reads.
* ``PEAKS``: one H100 SXM's dense tensor-core rate for the precision a
  configuration states (float32 results are bounded by the TF32 rate,
  which every float32-accurate implementation on the tensor cores sits
  under) and its HBM bandwidth, from NVIDIA's data sheet.
"""

from __future__ import annotations

PEAKS = {
    "float32": {"flops": 495e12, "bytes": 3.35e12},
    "bfloat16": {"flops": 989e12, "bytes": 3.35e12},
}

_ITEMSIZE = {"float32": 4, "bfloat16": 2}


def _mlp_dims(in_dim: int, num_layers: int, hidden: int, out_dim: int) -> list[tuple[int, int]]:
    dims = [in_dim] + [hidden] * num_layers + [out_dim]
    return list(zip(dims[:-1], dims[1:]))


def _linears(m: int, dims) -> int:
    return sum(2 * m * k * n for k, n in dims)


def _nla_flops(lead: int, h: int, lq: int, lk: int, d: int) -> int:
    return 2 * lead * h * (lq * d + d * lk * d + lq * d * d)


def expert_dims(cfg: dict) -> list[tuple[int, int]]:
    """``(in, out)`` of each Linear of one expert."""
    return _mlp_dims(cfg["n_attn_hidden_dim"], cfg["n_mlp_num_layers"], cfg["n_mlp_hidden_dim"],
                     cfg["n_mlp_hidden_dim"])


def forward_flops(cfg: dict, rows: int, pad_nodes: int, pad_funcs: int) -> int:
    """Products of one forward at ``[rows, pad_nodes]`` (input functions at
    ``pad_funcs``)."""
    h, d_attn = cfg["n_head"], cfg["n_attn_hidden_dim"]
    d = d_attn // h
    nl, dm, din, e = (cfg["n_mlp_num_layers"], cfg["n_mlp_hidden_dim"],
                      cfg["n_input_hidden_dim"], cfg["n_expert"])
    n_func = cfg["n_input_functions"]
    m, mf = rows * pad_nodes, n_func * rows * pad_funcs
    flops = (_linears(m, _mlp_dims(cfg["input_dim"], nl, dm, e))
             + _linears(m, _mlp_dims(cfg["input_dim"] + cfg["theta_dim"], nl, din, din))
             + _linears(m, _mlp_dims(din, nl, dm, cfg["out_dim"])))
    if n_func:
        flops += _linears(mf, _mlp_dims(cfg["input_func_dim"], nl, dm, din))
    ffn = _linears(m * e, expert_dims(cfg)) + 2 * m * e * expert_dims(cfg)[-1][1]
    block = 0
    for cross in ((True, False) if n_func else (False,)):
        kv_m = mf if cross else m
        block += 2 * m * din * d_attn + 2 * m * d_attn * d_attn  # query, fc_out
        block += 2 * 2 * kv_m * din * d_attn  # key, value
        block += _nla_flops((n_func if cross else 1) * rows, h, pad_nodes,
                            pad_funcs if cross else pad_nodes, d)
        block += ffn
    return flops + cfg["n_attn_layers"] * block


def mesh_flops(cfg: dict, n_nodes: int, n_func_points: int) -> int:
    """Products of one forward over one mesh's real points only."""
    return forward_flops(cfg, 1, n_nodes, n_func_points)


def ffn_kernel_cost(cfg: dict, rows: int, dtype: str) -> tuple[int, int]:
    """``(operations, bytes)`` of one gated-FFN launch on ``rows`` tokens:
    the experts' Linears; x, the gate scores (float32), the weights and
    biases, and the output, each once."""
    e, dims = cfg["n_expert"], expert_dims(cfg)
    size = _ITEMSIZE[dtype]
    flops = _linears(rows * e, dims)
    weights = sum(e * (k * n + n) for k, n in dims) * size
    data = rows * (dims[0][0] + dims[-1][1]) * size + rows * e * 4
    return flops, weights + data


def least_seconds(flops: float, nbytes: float, dtype: str) -> float:
    """The least time the card could take: operations over the peak rate
    or bytes over the bandwidth, whichever is longer."""
    peak = PEAKS[dtype]
    return max(flops / peak["flops"], nbytes / peak["bytes"])
