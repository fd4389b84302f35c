"""The port's ``tools/reference_scale_demo`` and the data path at the
reference's own scale against the JAX package.

The reference's design point is a ~10k-point mesh with an ~800-point input
function. At that scale: JAX's ``generate`` and the port's write bitwise
the same samples, each package's ``load_pickle`` reads the other's file
bitwise, a batch collates bitwise into the same buckets (12,288 points,
1,024 function points), and one f32 forward at full width (2 blocks)
agrees with JAX's at the model-level bar (1e-4 / 1e-5), the JAX weights
carried over by ``interop.params_from_jax``. The tool itself runs ``--generate
--train --device cpu`` on 2 / 1 samples in a process where importing JAX
raises, and writes a summary with the keys of the committed JAX artifact's.
"""

import hashlib
import importlib.util
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

from chip_smoke import NO_JAX

from gnot_tpu.config import ModelConfig as JaxModelConfig
from gnot_tpu.data import datasets as jax_datasets
from gnot_tpu.data.batch import collate as jax_collate
from gnot_tpu.models.gnot import GNOT as JaxGNOT
from gnot_tpu_torch.config import ModelConfig
from gnot_tpu_torch.data import datasets
from gnot_tpu_torch.data.batch import collate
from gnot_tpu_torch.interop import params_from_jax
from gnot_tpu_torch.models.gnot import GNOT, apply_batch
from gnot_tpu_torch.tools import reference_scale_demo as demo

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DOCS = os.path.join(REPO, "docs")
RTOL, ATOL = 1e-4, 1e-5  # the JAX package's model-level bar


def _jax_demo():
    spec = importlib.util.spec_from_file_location(
        "gnot_tool_reference_scale_demo", os.path.join(REPO, "tools", "reference_scale_demo.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _docs_digest() -> dict:
    out = {}
    for root, _, files in os.walk(DOCS):
        for name in files:
            path = os.path.join(root, name)
            with open(path, "rb") as f:
                out[path] = hashlib.sha256(f.read()).hexdigest()
    return out


@pytest.fixture(scope="module")
def pickles(tmp_path_factory):
    """``generate(2, 1)`` of each package into a directory of its own."""
    out = {}
    for name, module in (("jax", _jax_demo()), ("port", demo)):
        d = tmp_path_factory.mktemp(name)
        saved = module.TRAIN_PKL, module.TEST_PKL
        module.TRAIN_PKL, module.TEST_PKL = str(d / "train.pkl"), str(d / "test.pkl")
        try:
            module.generate(2, 1)
        finally:
            module.TRAIN_PKL, module.TEST_PKL = saved
        out[name] = d
    return out


@pytest.fixture(scope="module", autouse=True)
def no_jax_run(tmp_path_factory):
    """The tool's ``main`` with ``--generate --train --device cpu`` on 2 / 1
    samples for one epoch, in a process where importing JAX raises, its
    pickles and metrics under a temporary directory. Started before the
    module's first test, so that it runs beside them; read it through
    ``no_jax_result``."""
    d = tmp_path_factory.mktemp("no_jax")
    code = (
        "import sys\n"
        "from gnot_tpu_torch.tools import reference_scale_demo as demo\n"
        "d = sys.argv[1]\n"
        "demo.TRAIN_PKL, demo.TEST_PKL = d + '/train.pkl', d + '/test.pkl'\n"
        "demo.METRICS = d + '/metrics.jsonl'\n"
        "demo.main(sys.argv[2:])\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    before = _docs_digest()
    proc = subprocess.Popen(
        [sys.executable, "-c", NO_JAX, "-c", code, str(d), "--generate", "--train", "--device",
         "cpu", "--n_train", "2", "--n_test", "1", "--epochs", "1", "--out", str(d / "out.jsonl")],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    run = {"proc": proc, "dir": d, "before": before}
    yield run
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture
def no_jax_result(no_jax_run):
    """(exit code, stdout, stderr, the directory, the docs tree's digest
    before and after) of ``no_jax_run``'s process, waited for."""
    if "out" not in no_jax_run:
        stdout, stderr = no_jax_run["proc"].communicate(timeout=240)
        no_jax_run["out"] = (no_jax_run["proc"].returncode, stdout, stderr)
        no_jax_run["after"] = _docs_digest()
    return (*no_jax_run["out"], no_jax_run["dir"], no_jax_run["before"], no_jax_run["after"])


def _samples_equal(a, b) -> None:
    assert len(a) == len(b)
    for x, y in zip(a, b):
        for u, v in ((x.coords, y.coords), (x.y, y.y), (x.theta, y.theta)):
            assert u.dtype == v.dtype and np.array_equal(u, v)
        assert len(x.funcs) == len(y.funcs) == 1
        assert x.funcs[0].dtype == y.funcs[0].dtype and np.array_equal(x.funcs[0], y.funcs[0])


def test_generate_writes_jax_s_samples_and_sidecars(pickles):
    """The same seed gives bitwise JAX's reference-scale samples (9,500-
    10,500-point meshes, 760-850-point functions) and the same sidecars."""
    for split, n in (("train", 2), ("test", 1)):
        jax_s = jax_datasets.load_pickle(str(pickles["jax"] / f"{split}.pkl"))
        port_s = datasets.load_pickle(str(pickles["port"] / f"{split}.pkl"))
        _samples_equal(port_s, jax_s)
        assert all(9500 <= s.coords.shape[0] < 10500 and 760 <= s.funcs[0].shape[0] < 850
                   for s in port_s)
        for name in ("jax", "port"):
            assert (pickles[name] / f"{split}.pkl.count").read_text() == str(n)


def test_each_load_pickle_reads_the_other_s_file(pickles):
    for reader, other in ((datasets.load_pickle, "jax"), (jax_datasets.load_pickle, "port")):
        got = reader(str(pickles[other] / "train.pkl"))
        want = (jax_datasets if other == "jax" else datasets).load_pickle(
            str(pickles[other] / "train.pkl"))
        _samples_equal(got, want)


def test_a_reference_scale_batch_collates_bitwise_like_jax(pickles):
    port_s = datasets.load_pickle(str(pickles["port"] / "train.pkl"))
    jax_s = jax_datasets.load_pickle(str(pickles["port"] / "train.pkl"))
    got, want = collate(port_s), jax_collate(jax_s)
    assert tuple(got.coords.shape) == (2, 12288, 2) and tuple(got.funcs[0].shape) == (2, 1024, 3)
    for name in ("coords", "y", "theta", "node_mask", "func_mask"):
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert g.shape == w.shape and np.array_equal(g, w), name
    assert np.array_equal(got.funcs[0].numpy(), np.asarray(want.funcs[0]))


def test_a_full_width_forward_at_reference_scale_matches_jax(pickles):
    """One sample (12,288 rows) through the reference-default model at full
    width (256, 3 experts, 8 heads), f32, in both packages, cut to 2 blocks:
    at 4 the two forwards cost 21 s on one torch thread. JAX's params are
    made by ``jax.jit`` of ``init`` on the sample's first 64 points (the
    weights do not depend on the sequence length)."""
    samples = jax_datasets.load_pickle(str(pickles["port"] / "train.pkl"))[:1]
    mc = dict(jax_datasets.infer_model_dims(samples), n_attn_layers=2)
    model = JaxGNOT(JaxModelConfig(**mc))
    small = jax_collate([samples[0].__class__(
        coords=samples[0].coords[:64], y=samples[0].y[:64], theta=samples[0].theta,
        funcs=(samples[0].funcs[0][:64],))])
    init = jax.jit(lambda b: model.init(jax.random.key(0), b.coords, b.theta, b.funcs,
                                        node_mask=b.node_mask, func_mask=b.func_mask)["params"])
    params = jax.device_get(init(small))
    jb = jax_collate(samples)
    forward = jax.jit(lambda p, b: model.apply({"params": p}, b.coords, b.theta, b.funcs,
                                               node_mask=b.node_mask, func_mask=b.func_mask))
    want = np.asarray(forward(params, jb))
    cfg = ModelConfig(**mc)
    assert (cfg.n_attn_layers, cfg.n_attn_hidden_dim, cfg.n_expert, cfg.n_head) == (
        2, 256, 3, 8)
    port = GNOT(cfg)
    port.load_state_dict(params_from_jax(params, cfg), strict=True)
    port.eval()
    with torch.inference_mode():
        got = apply_batch(port, collate(datasets.load_pickle(
            str(pickles["port"] / "train.pkl"))[:1])).numpy()
    assert got.shape == want.shape == (1, 12288, 1)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_the_tool_runs_without_jax(no_jax_result):
    code, stdout, stderr, _, _, _ = no_jax_result
    assert code == 0, stdout[-2000:] + stderr[-4000:]
    assert "no-jax: refused [] loaded [] in " in stderr, stderr[-2000:]
    assert "Epoch 0, Loss: " in stdout and "best=" in stdout


def test_train_writes_the_jax_artifact_s_summary(no_jax_result):
    """``train`` on 2 / 1 samples: the epoch records, then a summary whose
    keys are those of the committed JAX artifact's, ``n_train`` from the
    sidecar."""
    code, _, stderr, d, _, _ = no_jax_result
    assert code == 0, stderr[-4000:]
    with open(d / "out.jsonl") as f:
        records = [json.loads(line) for line in f]
    with open(os.path.join(DOCS, "artifacts", "reference_scale_demo.jsonl")) as f:
        committed = [json.loads(line) for line in f]
    [summary] = [r for r in records if r.get("kind") == "summary"]
    [want] = [r for r in committed if r.get("kind") == "summary"]
    assert sorted(summary) == sorted(want)
    assert (d / "train.pkl.count").read_text() == "2"
    assert summary["n_train"] == 2 and summary["epochs"] == 1
    [epoch] = [r for r in records if "train_loss" in r]
    assert sorted(k for k in epoch if k != "ts") == sorted(
        k for k in committed[0] if k != "ts")
    assert np.isfinite(epoch["train_loss"]) and summary["best_metric"] == epoch["test_metric"]
    assert summary["train_points_per_sec_end_to_end"] > 0


def test_nothing_is_written_under_docs(no_jax_result):
    """The run leaves the docs tree as it was, and ``--out`` defaults under
    the checkout's gitignored ``build/``, not to JAX's committed artifact."""
    *_, before, after = no_jax_result
    assert after == before
    build = os.path.join(REPO, "build") + os.sep
    for path in (demo.OUT, demo.TRAIN_PKL, demo.TEST_PKL, demo.METRICS):
        assert path.startswith(build) and not path.startswith(DOCS)
