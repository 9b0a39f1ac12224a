"""PyTorch port: the CUDA KNARPE attention kernels (B4, B2, B3) against their plain versions, on the card.

Skips without an NVIDIA GPU: the kernels have no CPU mode (their CPU-side
contract is held against the TPU kernels in test_torch_knarpe.py). Imports
nothing of JAX, so it runs on a machine with the card and without JAX:

    python -m pytest --noconftest tests/test_torch_knarpe_cuda.py -m cuda -q

Inputs come from a numpy seed, at the rollout's shapes and at small ones,
with an all-invalid source, a source with one valid target, odd K=89 and
source counts that are no multiple of the kernel's grid. Tolerances:
  - float32 kernel vs float32 plain version: 1e-4 on outputs of size ~1-5;
    the kernel reassociates the projections with the attention
    (csrc/knarpe.cu), so the two differ by float32 summation order only;
  - bfloat16 kernel vs the float32 plain version on the same (bf16-valued)
    inputs: the kernel computes in float32 and rounds once at the output, so
    half a bf16 ulp plus the float32 tolerance; bf16 keeps 8 significant
    bits, so half an ulp is at most 2^-8 of the value;
    B3 rounds kk and q*k to bf16 like `_x3_fwd_kernel`, so it is held to its
    own plain version in bf16 instead: one bf16 ulp of the output plus 2^-8
    of the largest output, for a rounding of kk or q*k that the other float32
    summation order flips (it moves a logit by an ulp of one q*k term), and
    a mean error under a quarter of the plain version's distance from the
    unrounded (float32) result, so the roundings are really there;
  - bfloat16 kernel vs the bfloat16 plain version (which rounds each op to
    bf16, as XLA does): 2^-4 relative to the output's largest magnitude.
"""

import numpy as np
import pytest
import torch

from trafficbotsv15_tpu_torch.ops import knarpe

F32_ATOL = 1e-4
BF16_REL = 2.0 ** -4

# (n_b, n_s, K, D, R, H): the rollout's B2/B3 and map encoder's B4 shapes, then small ones
CROSS_SHAPES = [(128, 64, 89, 128, 128, 4), (3, 7, 5, 16, 16, 2), (1, 33, 89, 32, 16, 8)]
ATTN_SHAPES = [(4, 1024, 32, 128, 128, 4), (3, 7, 5, 16, 16, 2), (2, 17, 89, 64, 32, 1)]


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False


def _inputs(shape, cross, seed):
    n_b, n_s, n_knn, d, r, _ = shape
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: torch.from_numpy((scale * rng.normal(size=s)).astype(np.float32)).cuda()
    inv = rng.uniform(size=(n_b, n_s, n_knn)) < 0.3
    inv[0, 0] = True  # no valid target
    inv[-1, -1, 1:] = True  # one valid target
    inv = torch.from_numpy(inv).cuda()
    if cross:
        return [f(n_b, n_s, d), f(n_b, n_s, n_knn, d), f(n_b, n_s, n_knn, r), inv,
                f(d, 2 * d, scale=d ** -0.5), f(r, 2 * d, scale=r ** -0.5), f(2 * d, scale=0.1)]
    return [f(n_b, n_s, d), f(n_b, n_s, n_knn, d), f(n_b, n_s, n_knn, d), f(n_b, n_s, n_knn, r), inv,
            f(r, 2 * d, scale=r ** -0.5), f(2 * d, scale=0.1)]


def _cast(args, dtype):
    return [a if a.dtype == torch.bool else a.to(dtype) for a in args]


CASES = [(name, shape) for name in ("knarpe_cross_attention", "knarpe_cross_attention_v3") for shape in CROSS_SHAPES]
CASES += [("knarpe_attention", shape) for shape in ATTN_SHAPES]


@pytest.mark.cuda
@pytest.mark.parametrize("name,shape", CASES)
def test_kernel_matches_plain_version_on_card(name, shape):
    _need_card()
    kernel, plain = getattr(knarpe, name), getattr(knarpe, f"{name}_reference")
    n_head = shape[-1]
    args = _inputs(shape, name != "knarpe_attention", seed=sum(shape))
    before = knarpe.LAUNCHES[name]
    out = kernel(*args, n_head)
    torch.cuda.synchronize()
    assert knarpe.LAUNCHES[name] == before + 1
    ref = plain(*args, n_head)
    assert out.shape == ref.shape and out.dtype == torch.float32
    torch.testing.assert_close(out, ref, rtol=0, atol=F32_ATOL)
    assert torch.all(out[0, 0] == 0)
    if name == "knarpe_attention":  # the map encoder passes the k/v halves of one [.., 2D] tensor
        kv = torch.cat(args[1:3], -1)
        assert torch.equal(kernel(args[0], *kv.chunk(2, -1), *args[3:], n_head), out)

    a16 = _cast(args, torch.bfloat16)
    out16 = kernel(*a16, n_head)
    torch.cuda.synchronize()
    assert out16.dtype == torch.bfloat16 and torch.all(out16[0, 0] == 0)
    ref32 = plain(*_cast(a16, torch.float32), n_head)
    if name.endswith("_v3"):
        ref16 = plain(*a16, n_head).float()
        torch.testing.assert_close(out16.float(), ref16, rtol=2.0 ** -7, atol=2.0 ** -8 * float(ref16.abs().max()))
        assert (out16.float() - ref16).abs().mean() <= 0.25 * (ref32 - ref16).abs().mean()
    else:
        torch.testing.assert_close(out16.float(), ref32, rtol=2.0 ** -8, atol=F32_ATOL)
        ref16 = plain(*a16, n_head).float()
        assert (out16.float() - ref16).abs().max() <= BF16_REL * ref16.abs().max()
