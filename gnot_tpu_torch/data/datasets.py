"""Dataset loading: the reference pickle schema + synthetic generators.

A copy of ``gnot_tpu/data/datasets.py``'s generators, which are numpy
only: the same seed gives bitwise-equal samples in both packages.
"""

from __future__ import annotations

import pickle
from typing import Callable, Sequence

import numpy as np

from gnot_tpu_torch.data.batch import MeshSample


def load_pickle(path: str) -> list[MeshSample]:
    """Read a reference-schema pickle: list of ``[X, Y, theta, (f...)]``.

    X/Y may be any float arrays (or tensors), theta a scalar, 0-d or
    1-d value, the input functions a tuple or list (possibly empty).
    Malformed records raise a ValueError naming the record. Unpickling
    runs code, so only read files this program or a trusted writer made.
    """
    with open(path, "rb") as f:
        records = pickle.load(f)
    if not isinstance(records, (list, tuple)):
        raise ValueError(
            f"{path}: expected a pickled list of [X, Y, theta, (f...)] "
            f"records, got {type(records).__name__}"
        )
    samples = []
    for i, rec in enumerate(records):
        if not isinstance(rec, (list, tuple)) or len(rec) < 3:
            raise ValueError(
                f"{path}: record {i} must be [X, Y, theta, (f...)] with "
                f"at least 3 entries, got "
                + (f"{len(rec)} entries" if isinstance(rec, (list, tuple))
                   else type(rec).__name__)
            )
        x, y, theta = rec[0], rec[1], rec[2]
        try:
            x = np.asarray(x, np.float32)
            y = np.asarray(y, np.float32)
            theta = np.atleast_1d(np.asarray(theta, np.float32))
        except (TypeError, ValueError) as e:
            raise ValueError(
                f"{path}: record {i} has non-numeric X/Y/theta: {e}"
            ) from e
        if x.ndim != 2 or y.ndim != 2 or x.shape[0] != y.shape[0]:
            raise ValueError(
                f"{path}: record {i} needs X [n, d] and Y [n, c] with "
                f"matching n, got X {x.shape} and Y {y.shape}"
            )
        if theta.ndim != 1:
            raise ValueError(
                f"{path}: record {i} theta must be a scalar or 1-d "
                f"vector, got shape {theta.shape}"
            )
        raw_funcs = rec[3] if len(rec) > 3 else ()
        if raw_funcs is None:
            raw_funcs = ()
        if not isinstance(raw_funcs, (list, tuple)):
            raise ValueError(
                f"{path}: record {i} input functions must be a tuple or "
                f"list of [m, d] arrays, got {type(raw_funcs).__name__}"
            )
        try:
            funcs = tuple(np.asarray(fi, np.float32) for fi in raw_funcs)
        except (TypeError, ValueError) as e:
            raise ValueError(
                f"{path}: record {i} has a non-numeric input function: {e}"
            ) from e
        for j, fi in enumerate(funcs):
            if fi.ndim != 2:
                raise ValueError(
                    f"{path}: record {i} input function {j} must be "
                    f"[m, d], got shape {fi.shape}"
                )
        samples.append(MeshSample(coords=x, y=y, theta=theta, funcs=funcs))
    return samples


def save_pickle(samples: Sequence[MeshSample], path: str) -> None:
    """Write samples in the reference pickle schema (round-trippable), as
    ``gnot_tpu/data/datasets.py::save_pickle``."""
    records = [
        [s.coords, s.y, np.asarray(s.theta), tuple(s.funcs)] for s in samples
    ]
    with open(path, "wb") as f:
        pickle.dump(records, f)


def _smooth_target(coords: np.ndarray, theta: np.ndarray, funcs) -> np.ndarray:
    """Deterministic smooth operator output: learnable but nontrivial."""
    t = float(np.sum(theta))
    base = np.sin(np.pi * coords).prod(axis=1, keepdims=True)
    mod = 1.0 + 0.5 * np.cos(2 * np.pi * coords[:, :1] + t)
    fmean = 0.0
    for f in funcs:
        fmean = fmean + float(f[:, -1].mean())
    return (base * mod + 0.1 * fmean + 0.2).astype(np.float32)


def _grid(n: int, dim: int = 2) -> np.ndarray:
    axes = [np.linspace(0.0, 1.0, n, dtype=np.float32)] * dim
    mesh = np.meshgrid(*axes, indexing="ij")
    return np.stack([m.ravel() for m in mesh], axis=1)


def synth_darcy2d(n_samples: int, seed: int = 0, grid_n: int = 16) -> list[MeshSample]:
    """Darcy2d: regular grid, one input function (permeability field)."""
    rng = np.random.default_rng(seed)
    coords = _grid(grid_n)
    out = []
    for _ in range(n_samples):
        theta = rng.uniform(0.5, 1.5, size=(1,)).astype(np.float32)
        a = (
            1.0
            + rng.uniform(0, 1)
            * np.cos(np.pi * coords @ rng.integers(1, 4, size=(2, 1)))
        ).astype(np.float32)
        f = np.concatenate([coords, a], axis=1)
        y = _smooth_target(coords, theta, (f,))
        out.append(MeshSample(coords=coords, y=y, theta=theta, funcs=(f,)))
    return out


def synth_ns2d(n_samples: int, seed: int = 0, n_points: int = 1024) -> list[MeshSample]:
    """NS2d-1k: ~1k-point mesh, time-dependent (theta = time), one input
    function (initial vorticity on its own mesh). The throughput config."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_samples):
        coords = rng.uniform(0, 1, size=(n_points, 2)).astype(np.float32)
        theta = rng.uniform(0, 1, size=(1,)).astype(np.float32)
        m = n_points // 2
        fc = rng.uniform(0, 1, size=(m, 2)).astype(np.float32)
        w0 = np.sin(2 * np.pi * fc @ rng.uniform(1, 2, size=(2, 1))).astype(np.float32)
        f = np.concatenate([fc, w0], axis=1)
        y = _smooth_target(coords, theta, (f,))
        out.append(MeshSample(coords=coords, y=y, theta=theta, funcs=(f,)))
    return out


def synth_elasticity(n_samples: int, seed: int = 0, base_points: int = 512) -> list[MeshSample]:
    """Elasticity: variable-length irregular point cloud (ragged L), one
    geometry input function."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_samples):
        n = int(base_points * rng.uniform(0.7, 1.3))
        coords = rng.uniform(-1, 1, size=(n, 2)).astype(np.float32)
        theta = rng.uniform(0.5, 2.0, size=(2,)).astype(np.float32)
        m = max(16, n // 4)
        boundary = rng.uniform(-1, 1, size=(m, 2)).astype(np.float32)
        load = np.cos(np.pi * boundary[:, :1]).astype(np.float32)
        f = np.concatenate([boundary, load], axis=1)
        y = np.concatenate(
            [_smooth_target(coords, theta, (f,)), 0.5 * _smooth_target(coords, theta[::-1], (f,))],
            axis=1,
        )
        out.append(MeshSample(coords=coords, y=y, theta=theta, funcs=(f,)))
    return out


def synth_inductor2d(n_samples: int, seed: int = 0, base_points: int = 512) -> list[MeshSample]:
    """Inductor2d: three input functions of different lengths."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_samples):
        n = int(base_points * rng.uniform(0.8, 1.2))
        coords = rng.uniform(0, 1, size=(n, 2)).astype(np.float32)
        theta = rng.uniform(0.5, 1.5, size=(3,)).astype(np.float32)
        funcs = []
        for j in range(3):
            m = max(8, int(n * rng.uniform(0.1, 0.4)))
            fc = rng.uniform(0, 1, size=(m, 2)).astype(np.float32)
            val = np.sin((j + 1) * np.pi * fc[:, :1]).astype(np.float32)
            funcs.append(np.concatenate([fc, val], axis=1))
        y = _smooth_target(coords, theta, tuple(funcs))
        out.append(MeshSample(coords=coords, y=y, theta=theta, funcs=tuple(funcs)))
    return out


def synth_heatsink3d(n_samples: int, seed: int = 0, base_points: int = 2048) -> list[MeshSample]:
    """Heatsink3d: large 3D point cloud."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_samples):
        n = int(base_points * rng.uniform(0.9, 1.1))
        coords = rng.uniform(0, 1, size=(n, 3)).astype(np.float32)
        theta = rng.uniform(0.5, 1.5, size=(2,)).astype(np.float32)
        m = max(32, n // 8)
        inlet = rng.uniform(0, 1, size=(m, 3)).astype(np.float32)
        vel = np.cos(np.pi * inlet[:, :1]).astype(np.float32)
        f = np.concatenate([inlet, vel], axis=1)
        y = _smooth_target(coords, theta, (f,))
        out.append(MeshSample(coords=coords, y=y, theta=theta, funcs=(f,)))
    return out


SYNTHETIC: dict[str, Callable[..., list[MeshSample]]] = {
    "darcy2d": synth_darcy2d,
    "ns2d": synth_ns2d,
    "elasticity": synth_elasticity,
    "inductor2d": synth_inductor2d,
    "heatsink3d": synth_heatsink3d,
}

# Name of each generator's size kwarg, for DataConfig.synth_size.
_SIZE_KWARG = {
    "darcy2d": "grid_n",
    "ns2d": "n_points",
    "elasticity": "base_points",
    "inductor2d": "base_points",
    "heatsink3d": "base_points",
}


def synth(name: str, n_samples: int, seed: int, size: int = 0) -> list[MeshSample]:
    """One synthetic split: ``size`` 0 keeps the generator's default."""
    kwargs = {_SIZE_KWARG[name]: size} if size else {}
    return SYNTHETIC[name](n_samples, seed=seed, **kwargs)


def load(data_cfg) -> tuple[list[MeshSample], list[MeshSample]]:
    """Load (train, test) per DataConfig: pickle paths or synthetic."""
    if data_cfg.train_path:
        train = load_pickle(data_cfg.train_path)
        test = load_pickle(data_cfg.test_path) if data_cfg.test_path else []
        return train, test
    train = synth(data_cfg.synthetic, data_cfg.n_train, data_cfg.seed, data_cfg.synth_size)
    test = synth(data_cfg.synthetic, data_cfg.n_test, data_cfg.seed + 1, data_cfg.synth_size)
    return train, test


def infer_model_dims(samples: Sequence[MeshSample]) -> dict[str, int]:
    """Shape inference from sample 0 (reference main.py:30-35)."""
    s = samples[0]
    return dict(
        input_dim=s.coords.shape[1],
        theta_dim=int(np.atleast_1d(s.theta).shape[0]),
        input_func_dim=s.funcs[0].shape[1] if s.funcs else 1,
        out_dim=s.y.shape[1],
        n_input_functions=len(s.funcs),
    )
