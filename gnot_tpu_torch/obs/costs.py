"""Program costs: the device-side sensor of the program catalog.

Port of ``gnot_tpu/obs/costs.py``. JAX reads what a compiled XLA
executable reports about itself (``cost_analysis()`` /
``memory_analysis()``). Eager PyTorch compiles no program, so the port
counts the serving forward instead, analytically, at one program's shape
(``program_costs``):

* ``flops``: every product of the forward at ``2·M·K·N`` (the input MLPs,
  each block's Q/K/V and output projections, the attention's Gram and
  apply contractions and, packed, its segment scatters and gathers, every
  expert's Linears, the gate and the output MLP): exactly what
  ``torch.utils.flop_counter.FlopCounterMode`` counts of the plain
  forward. XLA's count of the same program adds the elementwise work
  (0.86 of XLA's at ``tests/test_torch_catalog.py``'s tiny model, 0.99 at
  width 256);
* ``transcendentals``: the elements that go through ``exp`` (the gate's and
  the attention's softmaxes) or the GELU's ``tanh`` / ``erf``, XLA's count
  of the same forward;
* ``argument_bytes``: the weights at the serving dtype plus the batch
  tensors the forward reads (``y`` is not one: XLA drops it from the
  program too);
* ``output_bytes``: the f32 output.

``bytes_accessed``, ``temp_bytes`` and ``generated_code_bytes`` stay
``None`` and are listed in ``unavailable``: XLA's ``bytes_accessed`` is a
sum over its fused HLO ops, which neither the compulsory minimum nor a
sum over eager ops equals, and eager PyTorch has no temp buffer plan and
no generated code. A missing field is ``None`` and named, never 0.

``ffn_flops`` is the gated-FFN part on its own and ``block_ffn_flops`` one
FFN of a forward; ``chip_smoke.py``'s FFN bound and its peak rate for a
program read them too, so the counts cannot drift. Imports nothing but
the standard library.
"""

from __future__ import annotations

#: Every cost field a catalog entry carries, in JAX's schema order.
COST_FIELDS = (
    "flops",
    "bytes_accessed",
    "transcendentals",
    "argument_bytes",
    "output_bytes",
    "temp_bytes",
    "generated_code_bytes",
)

#: The fields the analytic count leaves to the ``unavailable`` marker.
UNCOUNTED_FIELDS = ("bytes_accessed", "temp_bytes", "generated_code_bytes")

_ITEMSIZE = {"float32": 4, "bfloat16": 2}
_INT32 = 4


def unavailable_costs(reason: str) -> dict:
    """The all-``None`` cost dict of a program that could not be costed at
    all; ``unavailable`` names every field and ``unavailable_reason`` says
    why (JAX's marker, the same keys)."""
    out: dict = {f: None for f in COST_FIELDS}
    out["unavailable"] = sorted(COST_FIELDS)
    out["unavailable_reason"] = reason
    return out


def _mlp_dims(in_dim: int, num_layers: int, hidden: int, out_dim: int) -> list[tuple[int, int]]:
    dims = [in_dim] + [hidden] * num_layers + [out_dim]
    return list(zip(dims[:-1], dims[1:]))


def _linears(m: int, dims: list[tuple[int, int]]) -> int:
    return sum(2 * m * k * n for k, n in dims)


def ffn_flops(rows: int, n_expert: int, dims) -> tuple[list[int], int]:
    """The gated expert FFN's products over ``rows`` tokens: each expert
    Linear's ``(in, out)`` in ``dims`` as ``2·rows·E·in·out`` (one entry a
    Linear), and the gate's weighted sum over experts, ``2·rows·E·out``."""
    dims = list(dims)
    return [2 * rows * n_expert * k * n for k, n in dims], 2 * rows * n_expert * dims[-1][1]


def block_ffn_flops(cfg, tokens: int) -> tuple[list[int], int]:
    """``ffn_flops`` of one gated FFN of a ``GNOT`` with config ``cfg`` over
    ``tokens`` query tokens; a forward runs one after each attention."""
    c = cfg
    return ffn_flops(tokens, c.n_expert,
                     _mlp_dims(c.n_attn_hidden_dim, c.n_mlp_num_layers, c.n_mlp_hidden_dim,
                               c.n_mlp_hidden_dim))


def _nla_flops(*, lead: int, h: int, lq: int, lk: int, d: int) -> int:
    """``normalized_linear_attention`` over ``lead`` (functions x batch)
    slices: the normalizer ``q·k_sum``, the Gram ``kᵀv`` and its apply."""
    return 2 * lead * h * (lq * d + d * lk * d + lq * d * d)


def _packed_nla_flops(*, bq: int, nq: int, cq: int, bk: int, nk: int, ck: int, s: int,
                      h: int, d: int) -> int:
    """``packed_normalized_linear_attention``: the per-chunk Grams, their
    scatter into ``s`` segment Grams and key sums, the gather back per
    query chunk, the normalizer and the apply."""
    return 2 * (
        bk * h * nk * ck * d * d  # per-chunk Grams
        + bk * nk * s * h * d * d + bk * nk * s * h * d  # scatter per segment
        + bq * nq * s * h * d * d + bq * nq * s * h * d  # gather per query chunk
        + bq * h * nq * cq * d  # normalizer
        + bq * h * nq * cq * d * d  # apply
    )


def program_costs(cfg, *, rows: int = 0, pad_nodes: int = 0, pad_funcs: int = 0, plan=None,
                  dtype: str = "float32", params=()) -> dict:
    """The cost dict of one serving program of a ``GNOT`` with config
    ``cfg``: the padded program of ``rows`` samples at ``(pad_nodes,
    pad_funcs)``, or with ``plan`` (a ``PackPlan``) the packed one, in the
    serving ``dtype``. ``params`` are the model's parameters (only their
    element counts are read: the served copy holds them at ``dtype``).
    Every field of :data:`COST_FIELDS` is present; the uncounted ones are
    ``None`` and listed under ``unavailable``."""
    c = cfg
    h, d_attn = c.n_head, c.n_attn_hidden_dim
    d = d_attn // h
    nl, dm, din, e = c.n_mlp_num_layers, c.n_mlp_hidden_dim, c.n_input_hidden_dim, c.n_expert
    n_func = c.n_input_functions
    if plan is not None:
        bq, lq, lf, bk = plan.n_rows, plan.row_len, plan.pad_funcs, plan.n_slots
        nq, cq = plan.row_len // plan.chunk, plan.chunk
    else:
        bq, lq, lf, bk = rows, pad_nodes, pad_funcs, rows
    m, mf = bq * lq, n_func * bk * lf  # query tokens, input-function tokens
    # Once a forward: the gate, the query and input-function embeddings,
    # the output head.
    flops = (_linears(m, _mlp_dims(c.input_dim, nl, dm, e))
             + _linears(m, _mlp_dims(c.input_dim + c.theta_dim, nl, din, din))
             + _linears(m, _mlp_dims(din, nl, dm, c.out_dim)))
    gelu = m * dm * nl + m * din * nl + m * dm * nl
    exps = m * e  # the gate's softmax
    if n_func:
        flops += _linears(mf, _mlp_dims(c.input_func_dim, nl, dm, din))
        gelu += mf * dm * nl
    # Each block: cross attention (with input functions) and self
    # attention, each followed by the gated FFN.
    ffn_linears, ffn_gate = block_ffn_flops(c, m)
    block_flops = block_t = 0
    for cross in ((True, False) if n_func else (False,)):
        kv_m = mf if cross else m
        block_flops += 2 * m * din * d_attn + 2 * m * d_attn * d_attn  # query, fc_out
        block_flops += 2 * 2 * kv_m * din * d_attn  # key, value
        if plan is None:
            block_flops += _nla_flops(lead=(n_func if cross else 1) * bq, h=h, lq=lq,
                                      lk=lf if cross else lq, d=d)
        elif cross:
            block_flops += n_func * _packed_nla_flops(bq=bq, nq=nq, cq=cq, bk=bk, nk=1, ck=lf,
                                                      s=plan.n_slots, h=h, d=d)
        else:
            block_flops += _packed_nla_flops(bq=bq, nq=nq, cq=cq, bk=bq, nk=nq, ck=cq,
                                             s=plan.n_slots, h=h, d=d)
        block_t += m * d_attn + kv_m * d_attn  # q's and k's feature softmax
        block_flops += sum(ffn_linears) + ffn_gate
        block_t += e * m * dm * nl  # the experts' GELU
    flops += c.n_attn_layers * block_flops
    transcendentals = gelu + exps + c.n_attn_layers * block_t
    size = _ITEMSIZE[dtype]
    n_params = sum(p.numel() for p in params)
    batch = bq * lq * c.input_dim + bq * lq  # coords, node_mask
    batch += (bk if plan is not None else bq) * c.theta_dim
    if n_func:
        batch += mf * c.input_func_dim + mf  # funcs, func_mask
    seg = 0
    if plan is not None:
        seg = bq * nq + (bk if n_func else 0)  # node_seg, func_seg (int32)
    out: dict = {f: None for f in COST_FIELDS}
    out.update(
        flops=flops,
        transcendentals=transcendentals,
        argument_bytes=n_params * size + batch * size + seg * _INT32,
        output_bytes=bq * lq * c.out_dim * 4,
    )
    out["unavailable"] = sorted(UNCOUNTED_FIELDS)
    return out
