"""PyTorch port: the CUDA KNN kernel (B1) against its plain version, on the card.

Skips without an NVIDIA GPU: the kernel has no CPU mode (its CPU-side
contract is held against the TPU kernel in test_torch_knn.py). Imports
nothing of JAX, so it runs on a machine with the card and without JAX:

    python -m pytest --noconftest tests/test_torch_knn_cuda.py -m cuda -q

Indices must be identical and distances bit-equal (the kernel rounds each
operation on its own, as the plain version does), at the rollout's shape, the
training path's [8, 64, 1024] and the edges of the threshold select: all
distances tied, k=1, k = n_tgt, n_tgt of 1000 and 2048, fewer valid targets
than k, every source invalid.
"""

import numpy as np
import pytest
import torch

from trafficbotsv15_tpu_torch.ops import knn


def _case(seed, n_rows, n_src, n_tgt, integer_grid, p_invalid=0.2):
    rng = np.random.default_rng(seed)
    src = rng.uniform(-100, 100, (n_rows, n_src, 2)).astype(np.float32)
    tgt = rng.uniform(-100, 100, (n_rows, n_tgt, 2)).astype(np.float32)
    if integer_grid:
        src, tgt = np.round(src / 10) * 10, np.round(tgt / 10) * 10
    src_inv = rng.uniform(size=(n_rows, n_src)) < p_invalid
    tgt_inv = rng.uniform(size=(n_rows, n_tgt)) < p_invalid
    return src, src_inv, tgt, tgt_inv


@pytest.mark.cuda
@pytest.mark.parametrize("n_rows,n_src,n_tgt,k", [(128, 64, 1024, 64), (2, 8, 128, 128), (3, 24, 2048, 16)])
def test_cuda_kernel_matches_plain_version_on_card(n_rows, n_src, n_tgt, k):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernel has no CPU mode)")
    for integer_grid in (True, False):
        arrays = _case(7, n_rows, n_src, n_tgt, integer_grid)
        args = [torch.from_numpy(a).cuda() for a in arrays]
        before = knn.LAUNCHES
        d, i = knn.knn_xy(*args, k)
        torch.cuda.synchronize()
        dr, ir = knn.knn_xy_reference(*args, k)
        assert knn.LAUNCHES == before + 1
        assert torch.equal(i, ir) and torch.equal(d, dr)


def _edge_case(name):
    """(arrays, k) of one edge case of the threshold select (csrc/knn.cu)."""
    if name == "all_targets_at_one_point":  # every distance tied: the first k targets in index order
        src, src_inv, tgt, tgt_inv = _case(11, 4, 64, 1024, integer_grid=False, p_invalid=0.0)
        tgt[:] = np.float32([3.0, -7.0])
        return (src, src_inv, tgt, tgt_inv), 64
    if name == "k_1":
        return _case(12, 16, 64, 1024, integer_grid=True), 1
    if name == "k_equals_n_tgt":
        return _case(13, 4, 16, 1024, integer_grid=True), 1024
    if name == "n_tgt_1000":
        return _case(14, 8, 64, 1000, integer_grid=False), 64
    if name == "n_tgt_2048":
        return _case(15, 4, 64, 2048, integer_grid=True), 64
    if name == "fewer_valid_than_k":  # ~10 valid targets per row: each source emits its +inf tail
        return _case(16, 8, 64, 1024, integer_grid=True, p_invalid=0.99), 64
    if name == "every_source_invalid":
        src, src_inv, tgt, tgt_inv = _case(17, 4, 64, 1024, integer_grid=False)
        src_inv[:] = True
        return (src, src_inv, tgt, tgt_inv), 64
    assert name == "training_shape"  # the training path's agent->map launch: 512 sources
    return _case(18, 8, 64, 1024, integer_grid=False), 64


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["all_targets_at_one_point", "k_1", "k_equals_n_tgt", "n_tgt_1000", "n_tgt_2048",
                                  "fewer_valid_than_k", "every_source_invalid", "training_shape"])
def test_cuda_kernel_edge_cases_match_plain_version(name):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernel has no CPU mode)")
    arrays, k = _edge_case(name)
    args = [torch.from_numpy(a).cuda() for a in arrays]
    d, i = knn.knn_xy(*args, k)
    torch.cuda.synchronize()
    dr, ir = knn.knn_xy_reference(*args, k)
    assert torch.equal(i, ir) and torch.equal(d, dr)
    if name in ("all_targets_at_one_point", "every_source_invalid"):  # ties in target order
        assert torch.equal(i, torch.arange(k, dtype=torch.int32, device="cuda").expand_as(i))
    if name == "fewer_valid_than_k":
        assert bool(torch.isinf(d[:, :, -1]).all())


@pytest.mark.cuda
def test_cuda_kernel_takes_masks_at_odd_offsets():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernel has no CPU mode)")
    src, src_inv, tgt, tgt_inv = _case(3, 4, 16, 512, integer_grid=True)

    def odd_view(a):  # contiguous bool view whose first byte sits at an odd address
        flat = torch.zeros(a.size + 1, dtype=torch.bool, device="cuda")
        flat[1:] = torch.from_numpy(a.reshape(-1)).cuda()
        return flat[1:].view(a.shape)

    args = [torch.from_numpy(src).cuda(), odd_view(src_inv), torch.from_numpy(tgt).cuda(), odd_view(tgt_inv)]
    assert args[1].data_ptr() % 2 == 1 and args[3].data_ptr() % 2 == 1
    d, i = knn.knn_xy(*args, 32)
    dr, ir = knn.knn_xy_reference(*args, 32)
    assert torch.equal(i, ir) and torch.equal(d, dr)
