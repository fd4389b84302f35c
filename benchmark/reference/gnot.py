"""Plain PyTorch reference of GNOT: forward, per-graph rel-L2 loss, AdamW.

The architecture of the GNOT replication (aloe101/GNOT-Replication,
``model.py``, ``main.py:16-22``; arXiv 2302.14376), one mesh at a time
with no padding, so no mask is needed: every row is a real point.

* Gate: an MLP on the raw coordinates, softmaxed over the experts, and
  reused by every block.
* Query: an MLP on the coordinates with theta appended to every point.
  Input functions: one MLP each (its own weights), on that function's
  points.
* Block: cross attention over the input functions, then the gated expert
  FFN and a residual; self attention, then the gated expert FFN and a
  residual. No LayerNorm anywhere.
* Attention: normalized linear attention. q and k are softmaxed over
  each head's features; ``out = (q (k^T v)) / <q, sum_l k>``; several
  input functions average their outputs; the residual inside attention
  adds the softmaxed q; one output projection closes both branches.
* Expert FFN: every expert MLP runs on every point, and the gate's
  scores weigh their outputs.
* Head: an MLP on the last block's output.

An MLP of ``num_layers`` is ``num_layers + 1`` Linears with GELU between
them. Parameters carry the flax tree's names and layout (a Linear holds
``kernel [in, out]`` and ``bias [out]``; a stack of S holds ``[S, in,
out]`` and ``[S, out]``), which is how the harness hands one set of
weights to both sides. Float32 throughout; the caller decides whether
cuBLAS may use TF32 (``precision``).

Imports torch and the standard library only.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F


def _mlp_dims(in_dim: int, num_layers: int, hidden: int, out_dim: int) -> list[tuple[int, int]]:
    dims = [in_dim] + [hidden] * num_layers + [out_dim]
    return list(zip(dims[:-1], dims[1:]))


def param_specs(cfg: dict) -> list[tuple[str, tuple[int, ...], int]]:
    """Every parameter as ``(name, shape, fan_in)``, in a fixed order. The
    initialization is torch.nn.Linear's, U(+-1/sqrt(fan_in)) for weight
    and bias alike."""
    nl, hid = cfg["n_mlp_num_layers"], cfg["n_mlp_hidden_dim"]
    din, dattn, e = cfg["n_input_hidden_dim"], cfg["n_attn_hidden_dim"], cfg["n_expert"]
    nf = cfg["n_input_functions"]
    specs: list[tuple[str, tuple[int, ...], int]] = []

    def linear(name, k, n, stack=0):
        lead = (stack,) if stack else ()
        specs.append((f"{name}.kernel", lead + (k, n), k))
        specs.append((f"{name}.bias", lead + (n,), k))

    def mlp(name, dims, stack=0):
        for i, (k, n) in enumerate(dims):
            linear(f"{name}.dense_{i}", k, n, stack)

    mlp("gating", _mlp_dims(cfg["input_dim"], nl, hid, e))
    mlp("x_embed", _mlp_dims(cfg["input_dim"] + cfg["theta_dim"], nl, din, din))
    if nf:
        mlp("input_func_mlps", _mlp_dims(cfg["input_func_dim"], nl, hid, din), stack=nf)
    for b in range(cfg["n_attn_layers"]):
        for attn, funcs in (("cross_attention", nf), ("self_attention", 0)):
            p = f"block_{b}.{attn}"
            linear(f"{p}.query", din, dattn)
            linear(f"{p}.key", din, dattn, stack=funcs)
            linear(f"{p}.value", din, dattn, stack=funcs)
            linear(f"{p}.fc_out", dattn, dattn)
        for ffn in ("ffn1", "ffn2"):
            mlp(f"block_{b}.{ffn}.experts", _mlp_dims(dattn, nl, hid, hid), stack=e)
    mlp("out_mlp", _mlp_dims(din, nl, hid, cfg["out_dim"]))
    return specs


def _gelu(cfg: dict):
    approximate = "tanh" if cfg["gelu"] == "tanh" else "none"
    return lambda x: F.gelu(x, approximate=approximate)


def _mlp(p: dict, name: str, x: torch.Tensor, n: int, act, s: int | None = None) -> torch.Tensor:
    for i in range(n + 1):
        k, b = p[f"{name}.dense_{i}.kernel"], p[f"{name}.dense_{i}.bias"]
        if s is not None:
            k, b = k[s], b[s]
        x = x @ k + b
        if i < n:
            x = act(x)
    return x


def _heads(x: torch.Tensor, h: int) -> torch.Tensor:
    """``[L, E] -> [H, L, E/H]``."""
    l, e = x.shape
    return x.reshape(l, h, e // h).transpose(0, 1)


def _merge(x: torch.Tensor) -> torch.Tensor:
    """``[H, L, D] -> [L, H*D]``."""
    h, l, d = x.shape
    return x.transpose(0, 1).reshape(l, h * d)


def _nla(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Normalized linear attention of one head stack ``[H, L, D]``."""
    k_sum = k.sum(dim=1)  # [H, D]
    denom = (q * k_sum[:, None, :]).sum(dim=-1)  # [H, Lq]
    return (q @ (k.transpose(1, 2) @ v)) / denom[..., None]


def _attention(p: dict, name: str, x: torch.Tensor, funcs: list[torch.Tensor] | None,
               h: int) -> torch.Tensor:
    q = torch.softmax(_heads(x @ p[f"{name}.query.kernel"] + p[f"{name}.query.bias"], h), -1)
    wk, bk = p[f"{name}.key.kernel"], p[f"{name}.key.bias"]
    wv, bv = p[f"{name}.value.kernel"], p[f"{name}.value.bias"]
    if funcs:
        outs = []
        for f, g in enumerate(funcs):
            k = torch.softmax(_heads(g @ wk[f] + bk[f], h), -1)
            outs.append(_nla(q, k, _heads(g @ wv[f] + bv[f], h)))
        out = torch.stack(outs).mean(dim=0)
    else:
        k = torch.softmax(_heads(x @ wk + bk, h), -1)
        out = _nla(q, k, _heads(x @ wv + bv, h))
    res = _merge(q) + _merge(out)
    return res @ p[f"{name}.fc_out.kernel"] + p[f"{name}.fc_out.bias"]


def _experts(p: dict, name: str, x: torch.Tensor, scores: torch.Tensor, n: int, act) -> torch.Tensor:
    out = 0
    for e in range(scores.shape[-1]):
        out = out + scores[:, e:e + 1] * _mlp(p, name, x, n, act, s=e)
    return out


def _block(p: dict, b: int, cfg: dict, scores, query, funcs) -> torch.Tensor:
    n, h, act = cfg["n_mlp_num_layers"], cfg["n_head"], _gelu(cfg)
    cross = _attention(p, f"block_{b}.cross_attention", query, funcs or None, h)
    query = query + _experts(p, f"block_{b}.ffn1.experts", cross, scores, n, act)
    self_out = _attention(p, f"block_{b}.self_attention", query, None, h)
    return query + _experts(p, f"block_{b}.ffn2.experts", self_out, scores, n, act)


def forward(p: dict, cfg: dict, coords: torch.Tensor, theta: torch.Tensor,
            funcs: list[torch.Tensor]) -> torch.Tensor:
    """The model's output ``[n, out_dim]`` for one mesh: ``coords [n, dx]``,
    ``theta [T]``, ``funcs`` one ``[m_f, df]`` tensor per input function."""
    n, act = cfg["n_mlp_num_layers"], _gelu(cfg)
    scores = torch.softmax(_mlp(p, "gating", coords, n, act), dim=-1)
    feats = torch.cat([coords, theta[None, :].expand(coords.shape[0], -1)], dim=-1)
    query = _mlp(p, "x_embed", feats, n, act)
    emb = [_mlp(p, "input_func_mlps", f, n, act, s=i) for i, f in enumerate(funcs)]
    for b in range(cfg["n_attn_layers"]):
        query = _block(p, b, cfg, scores, query, emb)
    return _mlp(p, "out_mlp", query, n, act)


def rel_l2(pred: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """One graph's relative L2 error, averaged over output channels."""
    return torch.sqrt(((pred - y) ** 2).sum(dim=0) / (y ** 2).sum(dim=0)).mean()


@contextlib.contextmanager
def precision(tf32: bool):
    """cuBLAS and cuDNN with TF32 on (``tf32``) or off, restored after."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


class AdamW:
    """torch.optim.AdamW's update written out: decoupled weight decay,
    then the bias-corrected moments."""

    def __init__(self, params: dict, *, lr: float, b1: float, b2: float, eps: float,
                 weight_decay: float):
        self.params, self.lr, self.b1, self.b2 = params, lr, b1, b2
        self.eps, self.wd, self.t = eps, weight_decay, 0
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}

    @torch.no_grad()
    def step(self, grads: dict) -> None:
        self.t += 1
        bc1 = 1.0 - self.b1 ** self.t
        bc2 = 1.0 - self.b2 ** self.t
        for k, p in self.params.items():
            g = grads[k]
            p.mul_(1.0 - self.lr * self.wd)
            self.m[k].mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            denom = (self.v[k].sqrt() / math.sqrt(bc2)).add_(self.eps)
            p.addcdiv_(self.m[k], denom, value=-self.lr / bc1)


def mesh_tensors(sample, device) -> tuple:
    """One mesh's ``coords, theta, funcs, y`` as float32 tensors."""
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)  # noqa: E731
    return t(sample.coords), t(sample.theta).reshape(-1), [t(f) for f in sample.funcs], t(sample.y)


def batch_loss_and_grads(p: dict, cfg: dict, samples, device):
    """The batch's loss, the mean over its graphs of each graph's rel-L2,
    and its gradient, one graph at a time (a graph's part of the mean is
    its own loss over the batch size)."""
    grads = {k: torch.zeros_like(v) for k, v in p.items()}
    leaves = {k: v.detach().requires_grad_(True) for k, v in p.items()}
    total = 0.0
    for s in samples:
        coords, theta, funcs, y = mesh_tensors(s, device)
        loss = rel_l2(forward(leaves, cfg, coords, theta, funcs), y) / len(samples)
        got = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
        for k, g in zip(leaves, got):
            if g is not None:
                grads[k] += g
        total += float(loss.detach())
    return total, grads


def train_steps(p0: dict, cfg: dict, optim: dict, batches, device):
    """Follow ``len(batches)`` AdamW steps from the weights ``p0`` (left as
    they are). Returns each step's loss, each leaf's first gradient and each
    leaf's change over all the steps."""
    p = {k: v.detach().clone() for k, v in p0.items()}
    opt = AdamW(p, lr=optim["lr"], b1=optim["b1"], b2=optim["b2"], eps=optim["eps"],
                weight_decay=optim["weight_decay"])
    losses, first = [], None
    for samples in batches:
        loss, grads = batch_loss_and_grads(p, cfg, samples, device)
        losses.append(loss)
        if first is None:
            first = grads
        opt.step(grads)
    change = {k: p[k] - p0[k] for k in p}
    return losses, first, change


@torch.no_grad()
def predict(p: dict, cfg: dict, sample, device) -> torch.Tensor:
    """One mesh's output ``[n, out_dim]``."""
    coords, theta, funcs, _ = mesh_tensors(sample, device)
    return forward(p, cfg, coords, theta, funcs)
