"""The one mesh generator: a seeded pool of synthetic PDE meshes.

A configuration's ``data`` block gives the shape of a mesh; a traffic
mix gives how many make the pool. The sizes (evenly spaced over the
stated ranges), the pairing of a mesh's points with its functions' and
the sending order are drawn from the pool's size alone, so every seed
sends the same sequence of shapes and carries the same work (in a closed
loop the order decides which meshes share a dispatch); the seed draws
the points, theta and the values. Each mesh has ``coords [n, dim]`` uniform in the unit cube,
``theta [T]`` uniform in its range, input functions of ``dim + 1``
columns (points uniform in the unit cube and ``sin(2 pi x.w)`` with
``w`` uniform in [1, 2]), and the smooth target of the repo's synthetic
sets (``gnot_tpu_torch/data/datasets.py::_smooth_target``, copied), as
``gnot_tpu_torch/tools/reference_scale_demo.py`` makes its
reference-scale records.

``data`` keys: ``dim``, ``theta_dim``, ``theta`` ([lo, hi]), ``nodes``
([lo, hi]), ``n_functions``, and ``func_points`` ([lo, hi], the points
of each input function, spread apart from the nodes).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Mesh:
    coords: np.ndarray  # [n, dim]
    y: np.ndarray  # [n, 1]
    theta: np.ndarray  # [T]
    funcs: tuple  # each [m, dim + 1]


def smooth_target(coords: np.ndarray, theta: np.ndarray, funcs) -> np.ndarray:
    """A smooth operator output, learnable but not trivial."""
    t = float(np.sum(theta))
    base = np.sin(np.pi * coords).prod(axis=1, keepdims=True)
    mod = 1.0 + 0.5 * np.cos(2 * np.pi * coords[:, :1] + t)
    fmean = 0.0
    for f in funcs:
        fmean = fmean + float(f[:, -1].mean())
    return (base * mod + 0.1 * fmean + 0.2).astype(np.float32)


def spread(lo: int, hi: int, count: int) -> list[int]:
    """``count`` whole numbers evenly spaced over ``[lo, hi]``, each at the
    middle of its share."""
    width = hi - lo + 1
    return [lo + ((2 * i + 1) * width) // (2 * count) for i in range(count)]


def _order(sizes: list[int], rng: np.random.Generator) -> list[int]:
    """Indices of ``sizes``: the smaller and the larger half each in
    ``rng``'s order, taken in turn, so any run of the order holds both
    halves alike."""
    by_size = sorted(range(len(sizes)), key=lambda i: sizes[i])
    half = len(sizes) // 2
    small, large = by_size[:half], by_size[half:]
    small = [small[i] for i in rng.permutation(len(small))]
    large = [large[i] for i in rng.permutation(len(large))]
    out = []
    for i in range(max(len(small), len(large))):
        out += [x[i] for x in (small, large) if i < len(x)]
    return out


def pool(data: dict, count: int, seed: int) -> list[Mesh]:
    """``count`` meshes in sending order for ``seed``."""
    layout = np.random.default_rng(count)
    nodes = spread(*data["nodes"], count)
    fpts = spread(*data["func_points"], count)
    fpts = [fpts[i] for i in layout.permutation(count)]
    rng = np.random.default_rng([seed, count])
    dim, n_funcs = data["dim"], data["n_functions"]
    meshes = []
    for i in _order(nodes, layout):
        n, m = nodes[i], fpts[i]
        coords = rng.uniform(0, 1, size=(n, dim)).astype(np.float32)
        theta = rng.uniform(*data["theta"], size=(data["theta_dim"],)).astype(np.float32)
        funcs = []
        for _ in range(n_funcs):
            fc = rng.uniform(0, 1, size=(m, dim)).astype(np.float32)
            w = rng.uniform(1, 2, size=(dim, 1))
            val = np.sin(2 * np.pi * fc @ w).astype(np.float32)
            funcs.append(np.concatenate([fc, val], axis=1))
        meshes.append(Mesh(coords=coords, y=smooth_target(coords, theta, funcs), theta=theta,
                           funcs=tuple(funcs)))
    return meshes
