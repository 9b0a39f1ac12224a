"""PyTorch port: the fused KNN select (kernel B1) against the TPU kernel.

The port's plain version `ops/knn.py::knn_xy_reference` is held against
`trafficbotsv15_tpu/ops/pallas_knn.py::knn_xy_pallas` run in interpret mode
on the CPU, on the same numpy inputs:
  - indices identical in every case, ties included;
  - distances bit-equal on an integer grid (every dx*dx + dy*dy is exact
    there, and the grid makes ties common) and within 1 ULP on float
    coordinates, where XLA on the CPU may fuse a multiply-add that torch
    rounds twice (pallas_knn.py's FMA caveat).
The CUDA kernel itself runs only on the card: `tests/test_torch_knn_cuda.py`
holds it against the plain version there, and chip_smoke.py does so at the
rollout's shapes.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_torch_helpers import jax_sort_knn, t2n
from trafficbotsv15_tpu.ops.pallas_knn import knn_xy_pallas, pallas_knn_wanted
from trafficbotsv15_tpu.ops.rpe import get_tgt_knn_lazy as jax_get_tgt_knn_lazy
from trafficbotsv15_tpu_torch.ops import knn
from trafficbotsv15_tpu_torch.ops.rpe import get_tgt_knn_lazy

torch.set_num_threads(2)


def _case(seed, n_rows, n_src, n_tgt, integer_grid, p_invalid=0.2):
    rng = np.random.default_rng(seed)
    src = rng.uniform(-100, 100, (n_rows, n_src, 2)).astype(np.float32)
    tgt = rng.uniform(-100, 100, (n_rows, n_tgt, 2)).astype(np.float32)
    if integer_grid:
        src, tgt = np.round(src / 10) * 10, np.round(tgt / 10) * 10
    src_inv = rng.uniform(size=(n_rows, n_src)) < p_invalid
    tgt_inv = rng.uniform(size=(n_rows, n_tgt)) < p_invalid
    return src, src_inv, tgt, tgt_inv


def _both(src, src_inv, tgt, tgt_inv, k):
    d_pl, i_pl = knn_xy_pallas(jnp.asarray(src), jnp.asarray(src_inv), jnp.asarray(tgt), jnp.asarray(tgt_inv),
                               k, interpret=True)
    d_pt, i_pt = knn.knn_xy(torch.from_numpy(src), torch.from_numpy(src_inv), torch.from_numpy(tgt),
                            torch.from_numpy(tgt_inv), k)
    return np.asarray(d_pl), np.asarray(i_pl), t2n(d_pt), i_pt.numpy()


def _assert_within_1ulp(a, b):
    fin = np.isfinite(a)
    assert np.array_equal(fin, np.isfinite(b))
    assert np.array_equal(a[~fin], b[~fin])
    np.testing.assert_array_max_ulp(a[fin], b[fin], maxulp=1)


SHAPES = [
    (3, 8, 128, 4),
    (2, 16, 256, 32),
    (1, 8, 128, 128),  # k == n_tgt
    (2, 64, 384, 64),
    (8, 64, 512, 32),
    (2, 64, 1024, 64),  # the rollout's agent->map relation, two scenario rows
]


@pytest.mark.parametrize("integer_grid", [True, False], ids=["grid", "float"])
@pytest.mark.parametrize("n_rows,n_src,n_tgt,k", SHAPES)
def test_plain_version_matches_pallas_kernel(n_rows, n_src, n_tgt, k, integer_grid):
    src, src_inv, tgt, tgt_inv = _case(n_rows * 1000 + n_tgt + k, n_rows, n_src, n_tgt, integer_grid)
    d_pl, i_pl, d_pt, i_pt = _both(src, src_inv, tgt, tgt_inv, k)
    np.testing.assert_array_equal(i_pt, i_pl)
    if integer_grid:
        np.testing.assert_array_equal(d_pt, d_pl)
        flat = d_pl.reshape(-1, k)  # the grid must really produce ties
        assert any(len(np.unique(r[np.isfinite(r)])) < np.isfinite(r).sum() for r in flat)
    else:
        _assert_within_1ulp(d_pt, d_pl)


def test_plain_version_all_invalid_rows_and_targets():
    """Fewer valid targets than k: the +inf tail lists ascending indices; an
    invalid source is all +inf."""
    src, _, tgt, _ = _case(0, 2, 8, 128, True)
    src_inv = np.zeros((2, 8), bool)
    src_inv[0, 3] = True
    tgt_inv = np.ones((2, 128), bool)
    tgt_inv[:, :5] = False
    d_pl, i_pl, d_pt, i_pt = _both(src, src_inv, tgt, tgt_inv, 16)
    np.testing.assert_array_equal(i_pt, i_pl)
    np.testing.assert_array_equal(d_pt, d_pl)
    assert np.all(np.isinf(d_pt[0, 3]))
    np.testing.assert_array_equal(i_pt[1, 0, 5:], np.arange(5, 16))


@pytest.mark.parametrize("n_src,n_tgt", [(64, 1024), (64, 512), (64, 128), (64, 64), (60, 1024), (64, 1000)])
def test_gate_matches_jax(n_src, n_tgt):
    assert knn.knn_wanted(n_src, n_tgt, True) == pallas_knn_wanted(n_src, n_tgt)
    assert not knn.knn_wanted(n_src, n_tgt, False)


def test_get_tgt_knn_lazy_routes_like_jax(monkeypatch):
    """At n_tgt=1024 both packages take their kernel path (the XLA sort on the
    JAX side on CPU, the plain version through the wrapper here) and agree on
    indices, validity and the relative poses of the winners."""
    rng = np.random.default_rng(3)
    n_sc, n_src, n_tgt, k = 2, 64, 1024, 64
    src_pose = np.concatenate([rng.uniform(-100, 100, (n_sc, n_src, 2)),
                               rng.uniform(-np.pi, np.pi, (n_sc, n_src, 1))], -1).astype(np.float32)
    tgt_pose = np.concatenate([rng.uniform(-100, 100, (n_sc, n_tgt, 2)),
                               rng.uniform(-np.pi, np.pi, (n_sc, n_tgt, 1))], -1).astype(np.float32)
    src_inv = rng.uniform(size=(n_sc, n_src)) < 0.2
    tgt_inv = rng.uniform(size=(n_sc, n_tgt)) < 0.2
    calls = []
    real = knn.knn_xy
    monkeypatch.setattr(knn, "knn_xy", lambda *a: calls.append(a[-1]) or real(*a))
    with jax_sort_knn():
        j_idx, j_inv, j_rpe = jax_get_tgt_knn_lazy(jnp.asarray(src_pose), jnp.asarray(src_inv),
                                                   jnp.asarray(tgt_pose), jnp.asarray(tgt_inv), k, 150.0)
    p_idx, p_inv, p_rpe = get_tgt_knn_lazy(torch.from_numpy(src_pose), torch.from_numpy(src_inv),
                                           torch.from_numpy(tgt_pose), torch.from_numpy(tgt_inv), k, 150.0)
    assert calls == [k]
    np.testing.assert_array_equal(p_idx.numpy(), np.asarray(j_idx))
    np.testing.assert_array_equal(p_inv.numpy(), np.asarray(j_inv))
    np.testing.assert_allclose(t2n(p_rpe), np.asarray(j_rpe), rtol=0, atol=1e-4)  # metres / radians, f32 rotation
