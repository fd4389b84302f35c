"""The stacked-layer parameter layout (``scan_layers``) and the pipeline
schedule over a ``pipe`` mesh axis.

Port of ``gnot_tpu/parallel/pipeline.py``. The layout: the block weights
stacked on a leading layer axis, the forward that applies one block
module per layer to slice *i* of each stacked tensor, and the conversions
to and from the standard ``block_{i}`` layout (of the weights, and of a
whole training state with its AdamW moments). In PyTorch the layout
compiles nothing: the forward runs the same block kernels as the
standard one, in the same order. What it is for is the layout itself: a
``--scan_layers`` run trains, checkpoints and resumes in the JAX
package's stacked format, on one device or sharded over a mesh.

The schedule (``PipelinedGNOT``, ``pipe_blocks``): the stacked blocks'
leading layer dim is split over ``pipe`` (``mesh.param_spec``), so stage
*s* of a pipe line holds ``n_attn_layers / S`` consecutive blocks. Every
rank embeds its data shard; the embedded batch is split into M
microbatches and the ``M + S - 1``-tick schedule runs: at tick t stage s
runs microbatch ``t - s`` and hands its output to stage ``s + 1`` in one
hop (stage 0 ingests a fresh microbatch and discards the wraparound).
The last stage's outputs are broadcast over ``pipe``, so the head and the
loss run alike on every stage. A stage's blocks are the port's block
modules with the model axis's ``enter`` / ``close``, as on a GSPMD mesh.

JAX gets the backward from ``ppermute``'s transpose inside ``lax.scan``.
Autograd would run a hop's backward only where its output reached the
loss, which differs from stage to stage (the wraparound, the idle
warm-up and drain ticks), and a process group whose ranks run different
collectives hangs. So the schedule is one autograd node (``_PipeBlocks``)
whose backward walks the ticks in reverse: at every tick every stage
sends its input's gradient back and receives its output's, zeros where no
gradient exists, then runs its blocks' backward on the microbatch it ran.

State-dict names follow the JAX tree: ``block_{i}.X`` of the standard
layout is slice *i* of ``blocks.X``; every other weight keeps its name.
"""

from __future__ import annotations

from typing import Mapping

import torch
from torch.func import functional_call

from gnot_tpu_torch.config import ModelConfig
from gnot_tpu_torch.models.gnot import GNOT
from gnot_tpu_torch.ops.collectives import broadcast_from, hop

BLOCKS = "blocks."


def stack_params(params: Mapping[str, torch.Tensor], n_layers: int) -> dict[str, torch.Tensor]:
    """Standard layout -> stacked: the ``block_{i}.X`` entries become one
    ``blocks.X`` entry ``[n_layers, ...]``, after every other entry (the
    order of ``StackedGNOT``'s parameters)."""
    out = {k: v for k, v in params.items() if not k.startswith("block_")}
    prefix = "block_0."
    for key in params:
        if key.startswith(prefix):
            leaf = key[len(prefix):]
            out[BLOCKS + leaf] = torch.stack(
                [params[f"block_{i}.{leaf}"] for i in range(n_layers)]
            )
    return out


def unstack_params(params: Mapping[str, torch.Tensor], n_layers: int) -> dict[str, torch.Tensor]:
    """Stacked layout -> standard, in ``GNOT``'s parameter order
    (``block_{i}`` before ``out_mlp``)."""
    rest = {k: v for k, v in params.items() if not k.startswith(BLOCKS)}
    blocks = {k[len(BLOCKS):]: v for k, v in params.items() if k.startswith(BLOCKS)}
    out = {k: v for k, v in rest.items() if not k.startswith("out_mlp.")}
    for i in range(n_layers):
        out.update({f"block_{i}.{leaf}": v[i] for leaf, v in blocks.items()})
    out.update({k: v for k, v in rest.items() if k.startswith("out_mlp.")})
    return out


def is_stacked(params: Mapping[str, torch.Tensor]) -> bool:
    return any(k.startswith(BLOCKS) for k in params)


def convert_state_layout(state: dict, n_layers: int, to: str) -> dict:
    """A trainer state (``Trainer.state_dict()``) moved between the
    standard and the stacked layout: the weights, both AdamW moments and
    the gradient-accumulation mean, so a ``--scan_layers`` checkpoint
    resumes in a standard run and back. No-op when the state is already
    in the target layout."""
    from gnot_tpu_torch.train.trainer import map_param_state

    if to not in ("stacked", "standard"):
        raise ValueError(f"unknown layout {to!r}")
    if is_stacked(state["model"]) == (to == "stacked"):
        return state
    convert = stack_params if to == "stacked" else unstack_params
    return map_param_state(state, lambda p: convert(p, n_layers))


def scan_blocks(model: GNOT, block: torch.nn.Module, scores, query, funcs, kw: dict) -> torch.Tensor:
    """``block`` (a module whose parameters carry the leading layer axis)
    applied once per layer it holds (all of them, or a pipeline stage's),
    each time to slice *i* of every stacked parameter
    (``torch.func.functional_call``): the port of ``_scan_blocks``. With
    ``remat`` each layer is checkpointed, as ``jax.checkpoint`` wraps the
    scan body."""
    stacked = dict(block.named_parameters())
    for i in range(next(iter(stacked.values())).shape[0]):
        layer = {name: p[i] for name, p in stacked.items()}

        def apply(scores, q, funcs, layer=layer, **kw):
            return functional_call(block, layer, (scores, q, funcs), kw)

        query = model.run_block(apply, scores, query, funcs, kw)
    return query


class StackedGNOT(GNOT):
    """GNOT in the stacked layout: ``gating``, ``x_embed``,
    ``input_func_mlps`` and ``out_mlp`` as in ``GNOT``, and ``blocks``, one
    ``HNABlock`` whose every parameter is ``[n_attn_layers, ...]``.

    Built as the standard model and then stacked, so the same generator
    draws the same weights as ``GNOT`` (``init_stacked_state``: the
    standard init, stacked). Its forward is the port of
    ``stacked_forward``: the standard embedding, ``scan_blocks``, the
    standard head; parity mode drops the masks in ``embed`` as the
    standard forward does. ``apply_batch`` runs it as it runs ``GNOT``."""

    def __init__(self, config: ModelConfig, *, generator: torch.Generator | None = None):
        super().__init__(config, generator=generator)
        n = config.n_attn_layers
        layers = [getattr(self, f"block_{i}") for i in range(n)]
        for i in range(n):
            delattr(self, f"block_{i}")
        blocks = layers[0]
        with torch.no_grad():
            for name, _ in list(blocks.named_parameters()):
                owner, _, leaf = name.rpartition(".")
                stacked = torch.stack([l.get_parameter(name) for l in layers])
                setattr(blocks.get_submodule(owner), leaf, torch.nn.Parameter(stacked))
        self.blocks = blocks

    def forward(
        self,
        coords: torch.Tensor,
        theta: torch.Tensor,
        input_functions: torch.Tensor | None = None,
        *,
        node_mask: torch.Tensor | None = None,
        func_mask: torch.Tensor | None = None,
        node_seg: torch.Tensor | None = None,
        func_seg: torch.Tensor | None = None,
        n_seg: int = 0,
    ) -> torch.Tensor:
        scores, query, funcs, kw = self.embed(
            coords, theta, input_functions, node_mask=node_mask, func_mask=func_mask,
            node_seg=node_seg, func_seg=func_seg, n_seg=n_seg,
        )
        return self.head(scan_blocks(self, self.blocks, scores, query, funcs, kw))


# --------------------------------------------------------------------------
# The pipeline schedule.
# --------------------------------------------------------------------------


def _validate(cfg: ModelConfig, mesh) -> None:
    """``gnot_tpu/parallel/pipeline.py::_validate``, its messages."""
    s = mesh.shape["pipe"]
    if cfg.attention_impl != "xla" or cfg.ffn_impl != "xla":
        raise ValueError(
            "pipeline parallelism supports the xla attention/ffn impls only"
        )
    if cfg.n_attn_layers % s:
        raise ValueError(
            f"n_attn_layers={cfg.n_attn_layers} must be divisible by the "
            f"mesh pipe axis ({s})"
        )
    if any(mesh.shape[a] > 1 for a in ("seq", "expert")):
        raise ValueError(
            "pipe > 1 composes with data and model only; seq == expert == 1"
        )


def resolve_microbatches(mesh, microbatches: int) -> int:
    """0 (the documented auto value) -> one microbatch per stage (bubble
    ``(S-1)/(2S-1)``); negatives are rejected rather than coerced."""
    if microbatches < 0:
        raise ValueError(f"microbatches must be >= 0, got {microbatches}")
    return microbatches if microbatches > 0 else mesh.shape["pipe"]


def validate_local_batch(mesh, per_host_batch_size: int, microbatches: int,
                         n_process: int = 1) -> None:
    """Fail at startup, not mid-epoch, if a node's batch cannot split into
    its data shards x microbatches (``n_process``: the nodes; the data axis
    is global)."""
    micro = resolve_microbatches(mesh, microbatches)
    local_data = max(1, mesh.shape["data"] // max(1, n_process))
    per_shard = per_host_batch_size // local_data
    if per_host_batch_size % local_data or per_shard % micro:
        raise ValueError(
            f"batch_size={per_host_batch_size} (per host) must split into "
            f"the per-host data axis ({local_data}) x microbatches ({micro})"
        )


def split_micro(x: torch.Tensor | None, m: int, batch_axis: int):
    """``[..., B, ...] -> [M, ..., B/M, ...]``: the batch axis carved into
    M microbatches of consecutive rows, the microbatch index in front."""
    if x is None:
        return None
    b = x.shape[batch_axis]
    if b % m:
        raise ValueError(f"local batch {b} must be divisible by microbatches={m}")
    return x.unflatten(batch_axis, (m, b // m)).movedim(batch_axis, 0)


class _Schedule:
    """One pipelined forward's fixed parts: the model, its pipe line, the
    microbatch count, the masks, and whether the backward will run."""

    def __init__(self, model: "PipelinedGNOT", kw: dict, grad: bool):
        mesh = model.mesh
        self.model, self.grad = model, grad
        self.group = mesh.group("pipe")
        self.s, self.n_stage = mesh.coords["pipe"], mesh.shape["pipe"]
        self.m = model.n_micro
        self.ticks = self.m + self.n_stage - 1
        self.node_mask = split_micro(kw["node_mask"], self.m, 0)
        self.func_mask = split_micro(kw["func_mask"], self.m, 1)

    def active(self, t: int) -> bool:
        """Whether this stage runs a microbatch at tick ``t``."""
        return 0 <= t - self.s < self.m

    def stage(self, scores_m, query, funcs_m, i: int) -> torch.Tensor:
        """This stage's blocks on microbatch ``i``."""
        kw = dict(node_mask=None if self.node_mask is None else self.node_mask[i],
                  func_mask=None if self.func_mask is None else self.func_mask[i],
                  node_seg_oh=None, func_seg_oh=None)
        funcs = None if funcs_m is None else funcs_m[i]
        return scan_blocks(self.model, self.model.blocks, scores_m[i], query, funcs, kw)

    def forward_hop(self, q: torch.Tensor) -> torch.Tensor:
        return hop(q, self.group, (self.s + 1) % self.n_stage, (self.s - 1) % self.n_stage)

    def backward_hop(self, g: torch.Tensor) -> torch.Tensor:
        return hop(g, self.group, (self.s - 1) % self.n_stage, (self.s + 1) % self.n_stage)


def _leaf(x: torch.Tensor | None, grad: bool) -> torch.Tensor | None:
    if x is None:
        return None
    x = x.detach()
    return x.requires_grad_(True) if grad else x


class _PipeBlocks(torch.autograd.Function):
    """The schedule as one autograd node: inputs the embedded scores,
    query and input functions, output the last stage's block outputs on
    every stage. The blocks' weight gradients accumulate in the backward's
    inner passes, as a reentrant checkpoint's do."""

    @staticmethod
    def forward(ctx, run: _Schedule, scores, query, funcs):
        sc, q0, fn = (_leaf(x, run.grad) for x in (scores, query, funcs))
        ticks = []  # (tick, stage input, stage output) of the ticks this stage ran
        outputs = []
        with torch.set_grad_enabled(run.grad):
            scores_m, query_m = split_micro(sc, run.m, 0), split_micro(q0, run.m, 0)
            funcs_m = split_micro(fn, run.m, 1)
            received = None
            for t in range(run.ticks):
                if run.active(t):
                    i = t - run.s
                    # Stage 0 ingests a fresh microbatch; later stages take
                    # the previous stage's handoff.
                    q_in = query_m[i] if run.s == 0 else _leaf(received, run.grad)
                    q_out = run.stage(scores_m, q_in, funcs_m, i)
                    ticks.append((t, q_in, q_out))
                    if run.s == run.n_stage - 1:
                        outputs.append(q_out.detach())
                    send = q_out.detach()
                else:
                    # Idle (warm-up, drain): no block compute, but the hop.
                    send = torch.zeros_like(query_m[0]).detach()
                received = run.forward_hop(send)
        last = run.n_stage - 1
        out = torch.cat(outputs) if run.s == last else torch.zeros_like(query)
        ctx.run, ctx.leaves, ctx.ticks = run, (sc, q0, fn), ticks
        return broadcast_from(out, run.group, last)

    @staticmethod
    def backward(ctx, g_out):
        run, (sc, q0, fn) = ctx.run, ctx.leaves
        ticks = {t: (q_in, q_out) for t, q_in, q_out in ctx.ticks}
        last = run.s == run.n_stage - 1
        # One copy of the output gradient, the last stage's: every stage
        # computed the same head and loss on the broadcast outputs.
        g_m = split_micro(g_out, run.m, 0)
        zeros = torch.zeros_like(g_m[0])
        g_next = None  # the gradient of the input this stage took at tick t + 1
        with torch.enable_grad():
            for t in reversed(range(run.ticks)):
                # Stage 0's input came from no stage: it sends zeros.
                send = g_next if (run.s != 0 and g_next is not None) else zeros
                received = run.backward_hop(send)
                g_next = None
                if t not in ticks:
                    continue
                q_in, q_out = ticks[t]
                g = g_m[t - run.s] if last else received
                torch.autograd.backward(q_out, g)
                if run.s != 0:
                    g_next = q_in.grad
        return (None, sc.grad, q0.grad if run.s == 0 else None,
                None if fn is None else fn.grad)


def pipe_blocks(model: "PipelinedGNOT", scores, query, funcs, kw: dict) -> torch.Tensor:
    """The block stack as an S-stage, M-microbatch pipeline over the
    model's pipe line (``_pipe_blocks``): the last stage's outputs, on
    every stage."""
    run = _Schedule(model, kw, torch.is_grad_enabled())
    return _PipeBlocks.apply(run, scores, query, funcs)


class PipelinedGNOT(StackedGNOT):
    """``StackedGNOT`` whose block stack runs as the pipeline schedule
    (``gnot_tpu``'s ``pipelined_forward``) once ``parallel/mesh.py::shard_model`` has
    kept this rank's stage of the blocks and set the mesh. ``n_micro``:
    the microbatches a forward (``resolve_microbatches``)."""

    def __init__(self, config: ModelConfig, n_micro: int, *,
                 generator: torch.Generator | None = None):
        super().__init__(config, generator=generator)
        self.n_micro = n_micro

    def forward(
        self,
        coords: torch.Tensor,
        theta: torch.Tensor,
        input_functions: torch.Tensor | None = None,
        *,
        node_mask: torch.Tensor | None = None,
        func_mask: torch.Tensor | None = None,
    ) -> torch.Tensor:
        scores, query, funcs, kw = self.embed(
            coords, theta, input_functions, node_mask=node_mask, func_mask=func_mask)
        return self.head(pipe_blocks(self, scores, query, funcs, kw))
