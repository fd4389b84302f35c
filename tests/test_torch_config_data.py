"""Port config and data against the JAX package: same defaults, same
refusals, bitwise-equal samples and batches."""

import dataclasses
import pickle

import numpy as np
import pytest

from gnot_tpu import config as jax_config
from gnot_tpu.data import batch as jax_batch
from gnot_tpu.data import datasets as jax_datasets
from gnot_tpu_torch import config as port_config
from gnot_tpu_torch.data import batch as port_batch
from gnot_tpu_torch.data import datasets as port_datasets


def test_model_config_defaults_match():
    jax_cfg = jax_config.ModelConfig()
    port_cfg = port_config.ModelConfig()
    assert dataclasses.asdict(port_cfg) == dataclasses.asdict(jax_cfg)
    assert port_cfg.gelu == "tanh"
    assert port_config.ModelConfig(attention_mode="parity").gelu == "erf"


@pytest.mark.parametrize(
    "kwargs",
    [
        dict(n_attn_hidden_dim=30, n_head=8),
        dict(attention_mode="sparse"),
        dict(gelu="relu"),
        dict(attention_mode="parity", gelu="tanh"),
        dict(attention_impl="pallas"),
        dict(attention_impl="triton"),
        dict(ffn_impl="cuda"),
        dict(scan_layers=True, ffn_impl="pallas"),
    ],
)
def test_model_config_refusals_match(kwargs):
    with pytest.raises(ValueError) as jax_err:
        jax_config.ModelConfig(**kwargs)
    with pytest.raises(ValueError) as port_err:
        port_config.ModelConfig(**kwargs)
    assert str(port_err.value) == str(jax_err.value)


def test_data_and_serve_config_fields_match():
    jax_data = dataclasses.asdict(jax_config.DataConfig())
    for k, v in dataclasses.asdict(port_config.DataConfig()).items():
        assert jax_data[k] == v, k
    jax_serve = dataclasses.asdict(jax_config.ServeConfig())
    for k, v in dataclasses.asdict(port_config.ServeConfig()).items():
        assert jax_serve[k] == v, k
    for bad in (dict(max_batch=0), dict(max_wait_ms=-1), dict(queue_limit=0)):
        with pytest.raises(ValueError):
            port_config.ServeConfig(**bad)
        with pytest.raises(ValueError):
            jax_config.ServeConfig(**bad)


def _assert_samples_equal(a, b):
    assert len(a) == len(b)
    for sa, sb in zip(a, b):
        for fa, fb in ((sa.coords, sb.coords), (sa.y, sb.y), (sa.theta, sb.theta)):
            assert fa.dtype == fb.dtype and fa.shape == fb.shape
            assert fa.tobytes() == fb.tobytes()
        assert len(sa.funcs) == len(sb.funcs)
        for fa, fb in zip(sa.funcs, sb.funcs):
            assert fa.dtype == fb.dtype and fa.tobytes() == fb.tobytes()


GEN_SIZES = {
    "darcy2d": 6,
    "ns2d": 48,
    "elasticity": 40,
    "inductor2d": 40,
    "heatsink3d": 64,
}


@pytest.mark.parametrize("name", sorted(GEN_SIZES))
@pytest.mark.parametrize("seed", [0, 3])
def test_generators_bitwise_equal(name, seed):
    size = GEN_SIZES[name]
    kw = {port_datasets._SIZE_KWARG[name]: size}
    _assert_samples_equal(
        port_datasets.SYNTHETIC[name](5, seed=seed, **kw),
        jax_datasets.SYNTHETIC[name](5, seed=seed, **kw),
    )


def test_load_matches_jax_load():
    cfg = dict(synthetic="elasticity", synth_size=40, n_train=3, n_test=2, seed=4)
    p_train, p_test = port_datasets.load(port_config.DataConfig(**cfg))
    j_train, j_test = jax_datasets.load(jax_config.DataConfig(**cfg))
    _assert_samples_equal(p_train, j_train)
    _assert_samples_equal(p_test, j_test)
    assert port_datasets.infer_model_dims(p_train) == jax_datasets.infer_model_dims(j_train)


def test_load_pickle_reads_reference_schema(tmp_path):
    samples = jax_datasets.synth_inductor2d(3, seed=2, base_points=30)
    path = tmp_path / "d.pkl"
    jax_datasets.save_pickle(samples, str(path))
    _assert_samples_equal(port_datasets.load_pickle(str(path)), jax_datasets.load_pickle(str(path)))
    bad = tmp_path / "bad.pkl"
    with open(bad, "wb") as f:
        pickle.dump([[np.zeros((3, 2)), np.zeros((4, 1)), 0.5]], f)
    with pytest.raises(ValueError, match="record 0"):
        port_datasets.load_pickle(str(bad))


@pytest.mark.parametrize("n", [1, 63, 64, 65, 96, 97, 128, 1000, 1024, 1025])
def test_bucket_length_matches(n):
    assert port_batch.bucket_length(n) == jax_batch.bucket_length(n)


COLLATE_CASES = [
    ("ns2d", 48, {}),
    ("elasticity", 40, {}),
    ("elasticity", 40, dict(bucket=False)),
    ("elasticity", 40, dict(pad_nodes=96, pad_funcs=32)),
    ("inductor2d", 40, {}),
    ("inductor2d", 40, dict(bucket=False)),
]


@pytest.mark.parametrize("name,size,kw", COLLATE_CASES)
def test_collate_bitwise_equal(name, size, kw):
    gen_kw = {port_datasets._SIZE_KWARG[name]: size}
    samples = jax_datasets.SYNTHETIC[name](4, seed=1, **gen_kw)
    want = jax_batch.collate(samples, **kw)
    got = port_batch.collate(samples, **kw)
    for field in ("coords", "theta", "y", "node_mask", "funcs", "func_mask"):
        w = getattr(want, field)
        g = getattr(got, field)
        if w is None:
            assert g is None
            continue
        g = g.numpy()
        assert g.dtype == np.asarray(w).dtype and g.shape == np.asarray(w).shape, field
        assert g.tobytes() == np.asarray(w).tobytes(), field


def test_collate_keeps_one_shared_function_pad():
    samples = jax_datasets.synth_inductor2d(3, seed=5, base_points=60)
    batch = port_batch.collate(samples, bucket=False)
    longest = max(f.shape[0] for s in samples for f in s.funcs)
    assert batch.funcs.shape[:3] == (3, 3, longest)


def test_validate_samples_names_the_bad_sample():
    samples = port_datasets.synth_ns2d(3, n_points=20)
    samples[1].coords[0, 0] = np.nan
    with pytest.raises(ValueError, match="sample 1 has non-finite mesh"):
        port_batch.validate_samples(samples)
    with pytest.raises(ValueError, match="sample 0 has 20 mesh points"):
        port_batch.validate_samples(samples[:1], pad_nodes=10)


def test_pad_and_unpad_rows():
    a = np.arange(6, dtype=np.float32).reshape(3, 2)
    assert port_batch.pad_rows(a, 5).tobytes() == jax_batch.pad_rows(a, 5).tobytes()
    out = np.arange(24, dtype=np.float32).reshape(2, 4, 3)
    parts = port_batch.unpad_rows_numpy(out, [(0, 0, 2), (1, 1, 3)])
    assert parts[0].tobytes() == out[0, :2].tobytes()
    assert parts[1].tobytes() == out[1, 1:4].tobytes()
    assert not np.shares_memory(parts[0], out)
    with pytest.raises(ValueError, match="out of bounds"):
        port_batch.unpad_rows_numpy(out, [(2, 0, 1)])
