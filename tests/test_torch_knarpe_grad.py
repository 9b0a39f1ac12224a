"""PyTorch port: the KNARPE attention backwards' plain versions against the TPU backward kernels.

The port's plain backwards, `knarpe_attention_bwd_reference` (B4-bwd) and
`knarpe_cross_attention_bwd_reference` (B2-bwd, also B3's), are autograd
through the plain forwards. They are held against
`trafficbotsv15_tpu/ops/pallas_knarpe.py`'s `_knarpe_bwd_pallas` and
`_knarpe_x_bwd_pallas` in interpret mode, as `tests/test_pallas_knarpe.py`
runs them, at its shapes (B=2, S=8, K=4, H=2, d_head=8, R=16) and with
source counts that are no multiple of the Pallas tile (S=10 and 9 with tiles
of 4 and 8), plus a larger K=89 case; every case has a source whose targets
are all invalid (its gradients are zero) and a source with one valid target.

Tolerances (gradients of size up to ~30):
  - float32: 5e-5 absolute plus 1e-5 relative, summation order only (the
    Pallas kernel sums per head through segment matmuls and over the tile's
    sources in another order);
  - bfloat16, the interpret-mode kernel computing in float32 inside against
    a plain version that rounds every op to bf16: 2^-4 of the largest
    gradient of each output.
The wrappers' autograd on the CPU takes these plain backwards and counts no
launch; B3's CPU backward is B2's, as in the JAX package.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_torch_helpers import set_threads, t2n
from trafficbotsv15_tpu.ops import pallas_knarpe as jk
from trafficbotsv15_tpu_torch.ops import knarpe

set_threads()
N_HEAD, D_HEAD, R = 2, 8, 16
D = N_HEAD * D_HEAD
F32_ATOL, F32_RTOL, BF16_REL = 5e-5, 1e-5, 2.0 ** -4
# (n_b, n_s, K, s_tile): test_pallas_knarpe.py's shapes, non-divisible tiles, a wide K
SHAPES = [(2, 8, 4, 4), (1, 10, 4, 4), (1, 9, 4, 8), (2, 10, 4, 4), (2, 33, 89, 8)]
ATTN_NAMES = ("dq", "dk", "dv", "drpe", "dw_rpe", "db_rpe")
CROSS_NAMES = ("dq", "dtgt", "drpe", "dw_kv", "dw_rpe", "db")


def _inputs(n_b, n_s, n_knn, seed, cross):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    inv = rng.uniform(size=(n_b, n_s, n_knn)) < 0.3
    inv[0, 1] = True  # a source with no valid target
    inv[-1, 0, :-1] = True  # a source with one valid target
    inv[-1, 0, -1] = False
    g = f(n_b, n_s, D)
    if cross:
        return dict(q=f(n_b, n_s, D), tgt=f(n_b, n_s, n_knn, D), rpe=f(n_b, n_s, n_knn, R), invalid=inv,
                    w_kv=0.3 * f(D, 2 * D), w_rpe=0.3 * f(R, 2 * D), b=0.1 * f(2 * D)), g
    return dict(q=f(n_b, n_s, D), k=f(n_b, n_s, n_knn, D), v=f(n_b, n_s, n_knn, D), rpe=f(n_b, n_s, n_knn, R),
                invalid=inv, w_rpe=0.3 * f(R, 2 * D), b_rpe=0.1 * f(2 * D)), g


def _both(args, g, jdt, tdt):
    j = [jnp.asarray(v) if v.dtype == bool else jnp.asarray(v).astype(jdt) for v in args.values()]
    t = [torch.from_numpy(v) if v.dtype == bool else torch.from_numpy(v).to(tdt) for v in args.values()]
    return j, jnp.asarray(g).astype(jdt), t, torch.from_numpy(g).to(tdt)


def _pallas_grads(cross, j, jg, s_tile):
    fn = jk._knarpe_x_bwd_pallas if cross else jk._knarpe_bwd_pallas
    return [np.asarray(x, dtype=np.float32) for x in fn(*j, jg, N_HEAD, s_tile, interpret=True)]


def _plain_grads(cross, t, tg):
    fn = knarpe.knarpe_cross_attention_bwd_reference if cross else knarpe.knarpe_attention_bwd_reference
    return [t2n(x) for x in fn(*t, tg, N_HEAD)]


@pytest.mark.parametrize("cross", [False, True], ids=["B4", "B2"])
@pytest.mark.parametrize("n_b,n_s,n_knn,s_tile", SHAPES)
def test_plain_backward_matches_tpu_kernel_f32(cross, n_b, n_s, n_knn, s_tile):
    args, g = _inputs(n_b, n_s, n_knn, seed=n_s * 100 + n_knn + n_b, cross=cross)
    j, jg, t, tg = _both(args, g, jnp.float32, torch.float32)
    want = _pallas_grads(cross, j, jg, s_tile)
    got = _plain_grads(cross, t, tg)
    for name, a, b in zip(CROSS_NAMES if cross else ATTN_NAMES, got, want):
        assert a.shape == b.reshape(a.shape).shape, name
        np.testing.assert_allclose(a, b.reshape(a.shape), rtol=F32_RTOL, atol=F32_ATOL, err_msg=name)
    np.testing.assert_array_equal(got[0][0, 1], 0.0)  # the all-invalid source's dq
    np.testing.assert_array_equal(got[1][0, 1], 0.0)  # and its dk / dtgt


@pytest.mark.parametrize("cross", [False, True], ids=["B4", "B2"])
def test_plain_backward_matches_tpu_kernel_bf16(cross):
    args, g = _inputs(2, 10, 5, seed=7, cross=cross)
    j, jg, t, tg = _both(args, g, jnp.bfloat16, torch.bfloat16)
    want = _pallas_grads(cross, j, jg, 4)
    got = _plain_grads(cross, t, tg)
    for name, a, b in zip(CROSS_NAMES if cross else ATTN_NAMES, got, want):
        b = b.reshape(a.shape)
        assert np.abs(a - b).max() <= BF16_REL * np.abs(b).max(), name


@pytest.mark.parametrize("name", ["knarpe_attention", "knarpe_cross_attention", "knarpe_cross_attention_v3"])
def test_cpu_wrapper_gradients_are_the_plain_backward(name):
    """Autograd through the CPU wrapper gives the plain backward (B2's for B3) and counts no launch."""
    cross = name != "knarpe_attention"
    args, g = _inputs(2, 8, 5, seed=11, cross=cross)
    _, _, t, tg = _both(args, g, jnp.float32, torch.float32)
    leaves = [x.requires_grad_(x.is_floating_point()) for x in t]
    before = dict(knarpe.LAUNCHES)
    out = getattr(knarpe, name)(*leaves, N_HEAD)
    assert out.grad_fn is not None
    out.backward(tg)
    assert knarpe.LAUNCHES == before
    want = _plain_grads(cross, [x.detach() for x in t], tg)
    got = [t2n(x.grad) for x in leaves if x.requires_grad]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_bwd_chunks_fixed_by_shape():
    """The reduction's chunking depends on the shapes only (so its sum order is fixed)."""
    assert knarpe.bwd_chunks(8192, 257, 128, 4) == knarpe.bwd_chunks(8192, 257, 128, 4) == 13
    assert knarpe.bwd_chunks(5, 33, 16, 2) == 1
    assert all(knarpe.bwd_chunks(n, 129, 128, 4) >= 1 for n in (1, 63, 64, 4096))
