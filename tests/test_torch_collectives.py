"""The port's collectives and ``fused_nla_sp`` against the JAX package's.

One launch of 8 gloo ranks (``torch_ranks.py``) runs ``fused_nla_sp`` on
four meshes, each rank on its block with the plain versions of the
reduce and apply kernels: the Gram summed over 8 sequence ranks by one
all-reduce, by the ring, with the heads split over a model axis and with
the batch split over a data axis. The test assembles the ranks' blocks and
sums their gradient parts, and holds them against JAX's ``fused_nla_sp`` on
the conftest's 8-device mesh as ``tests/test_pallas.py:147-215`` runs it,
at its 1e-5 / 1e-6. The same launch checks the ring against the all-reduce
on a plain tensor, both backwards, and the stop and restore agreements'
primitives."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import torch_ranks
from gnot_tpu.ops.pallas_attention import fused_nla_sp as jax_fused_nla_sp
from gnot_tpu_torch.config import MeshConfig
from gnot_tpu_torch.ops.collectives import all_reduce_sum, copy_to, reduce_from, ring_allreduce
from gnot_tpu_torch.ops.fused_attention import fused_nla_sp, reference_impl
from gnot_tpu_torch.parallel.mesh import Mesh as Mesh_
from gnot_tpu_torch.parallel.mesh import make_mesh

RTOL, ATOL = 1e-5, 1e-6  # tests/test_pallas.py's bar for fused_nla_sp
B, H, L, LK, E, F = 2, 4, 64, 32, 32, 2  # tests/test_pallas.py's shapes
CASES = {
    "psum": dict(mesh=dict(seq=8), axes=("seq",), kwargs={}),
    "ring": dict(mesh=dict(seq=8), axes=("seq",), kwargs=dict(sp_collective="ring")),
    "model": dict(mesh=dict(data=1, seq=4, model=2), axes=("seq", "model"),
                  kwargs=dict(model_axis="model")),
    "data": dict(mesh=dict(data=2, seq=4), axes=("data", "seq"),
                 kwargs=dict(data_axis="data")),
}


def _inputs():
    rng = np.random.default_rng(3)
    q = rng.normal(size=(B, L, E)).astype(np.float32)
    k = rng.normal(size=(F, B, LK, E)).astype(np.float32)
    v = rng.normal(size=(F, B, LK, E)).astype(np.float32)
    mask = (rng.uniform(size=(F, B, LK)) > 0.3).astype(np.float32)
    mask[:, :, 0] = 1.0
    return q, k, v, mask


def _jax_case(case, q, k, v, mask):
    """JAX's ``fused_nla_sp`` forward and gradients wrt q, k, v of
    ``sum(out^2) + sum(qs / 2)`` (``tests/test_pallas.py``'s loss), jitted
    once per mesh."""
    mesh = Mesh(np.asarray(jax.devices()[:8]).reshape(
        [case["mesh"][a] for a in case["axes"]]), case["axes"])

    def run(q, k, v):
        def loss(q, k, v):
            out, qs = jax_fused_nla_sp(q, k, v, mask, H, mesh, **case["kwargs"])
            return jnp.sum(out**2) + jnp.sum(qs * 0.5), (out, qs)

        (_, (out, qs)), grads = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(
            q, k, v)
        return out, qs, grads

    out, qs, grads = jax.jit(run)(q, k, v)
    return np.asarray(out), np.asarray(qs), [np.asarray(g) for g in grads]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 (virtual) devices")
    tmp = tmp_path_factory.mktemp("collectives")
    q, k, v, mask = _inputs()
    payload = dict(q=torch.from_numpy(q), k=torch.from_numpy(k), v=torch.from_numpy(v),
                   mask=torch.from_numpy(mask), n_head=H,
                   cases={n: dict(mesh=c["mesh"], kwargs=c["kwargs"]) for n, c in CASES.items()})
    torch_ranks.write_payload(payload, tmp / "payload.pt")
    launch = torch_ranks.Launch("collectives", 8, tmp / "payload.pt", tmp / "out")
    try:
        want = {n: _jax_case(c, q, k, v, mask) for n, c in CASES.items()}
        results = launch.wait(timeout_s=180)
    finally:
        launch.kill()
    return dict(results=results, want=want, inputs=(q, k, v, mask))


def _assembled(results, name, inputs):
    """Every rank's blocks of (out, qs) placed whole, and the sum of their
    gradient parts."""
    q = inputs[0]
    out = np.zeros((F, B, L, E), np.float32)
    qs = np.zeros((B, L, E), np.float32)
    grads = [np.zeros_like(t) for t in inputs[:3]]
    kw = CASES[name]["kwargs"]
    d, s, m = kw.get("data_axis"), "seq", kw.get("model_axis")
    for r in results:
        case = r["cases"][name]
        torch_ranks.place(out, case["out"].numpy(), (None, d, s, m), case["shape"], case["coords"])
        torch_ranks.place(qs, case["qs"].numpy(), (d, s, m), case["shape"], case["coords"])
        for acc, g in zip(grads, case["grads"]):
            acc += g.numpy()
    assert out.shape[1:] == (B, L, E) and qs.shape == q.shape
    return out, qs, grads


@pytest.mark.parametrize("name", list(CASES))
def test_fused_nla_sp_matches_jax(ranks, name):
    """Forward (out, qs) and the gradients wrt q, k, v of the port's
    ``fused_nla_sp`` over 8 ranks == JAX's over 8 devices, at 1e-5 / 1e-6."""
    out, qs, grads = _assembled(ranks["results"], name, ranks["inputs"])
    want_out, want_qs, want_grads = ranks["want"][name]
    np.testing.assert_allclose(out, want_out, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(qs, want_qs, rtol=RTOL, atol=ATOL)
    for g, w, what in zip(grads, want_grads, "qkv"):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL, err_msg=f"grad wrt {what}")


def test_ring_matches_the_all_reduce_forward_and_backward(ranks):
    """S-1 neighbour hops sum what one all-reduce sums, and the ring's
    backward (the ring in reverse) gives each rank the sum of every rank's
    cotangent, as the all-reduce's backward does."""
    x = np.arange(12, dtype=np.float32).reshape(3, 4)
    for r in ranks["results"]:
        ring = r["ring"]
        np.testing.assert_array_equal(ring["psum"].numpy(), x * sum(range(1, 9)))
        np.testing.assert_allclose(ring["ring"].numpy(), ring["psum"].numpy(), rtol=1e-6)
        np.testing.assert_array_equal(ring["g_psum"].numpy(), np.full_like(x, sum(range(8))))
        np.testing.assert_allclose(ring["g_ring"].numpy(), ring["g_psum"].numpy(), rtol=1e-6)


def test_agreement_primitives(ranks):
    """``sync_flag``: a flag raised on rank 5 alone is seen on every rank;
    ``all_agree``: True when every rank holds the token, False on EVERY rank
    when one differs; ``per_host_gauge``: every rank's value in rank order."""
    for r in ranks["results"]:
        a = r["agree"]
        assert a["flag_one"] is True and a["flag_none"] is False
        assert a["same"] is True and a["diverged"] is False
        np.testing.assert_array_equal(a["gauge"], np.arange(8, dtype=np.float32))


def test_a_world_of_one_is_the_single_device_op():
    """Alone (no process group) every collective is the identity and
    ``fused_nla_sp`` is ``fused_nla``'s plain version."""
    q, k, v, mask = (torch.from_numpy(t) for t in _inputs())
    mesh = make_mesh(MeshConfig())
    for kwargs in ({}, dict(sp_collective="ring")):
        out, qs = fused_nla_sp(q, k, v, mask, H, mesh, **kwargs)
        want_out, want_qs = reference_impl(q, k, v, mask, H)
        assert torch.equal(out, want_out) and torch.equal(qs, want_qs)
    x = torch.ones(3)
    for fn in (all_reduce_sum, reduce_from, copy_to, ring_allreduce):
        assert fn(x, None) is x
    with pytest.raises(ValueError, match="unknown sp_collective 'tree'"):
        fused_nla_sp(q, k, v, mask, H, mesh, sp_collective="tree")
    three = Mesh_(dict(mesh.shape, model=3), mesh.coords, {})
    with pytest.raises(ValueError, match="n_head=4 must be divisible by the model axis size 3"):
        fused_nla_sp(q, k, v, mask, H, three, model_axis="model")
