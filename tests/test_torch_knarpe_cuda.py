"""PyTorch port: the CUDA KNARPE attention kernels (B4, B2, B3) and their backwards against their plain versions, on the card.

Skips without an NVIDIA GPU: the kernels have no CPU mode (their CPU-side
contract is held against the TPU kernels in test_torch_knarpe.py). Imports
nothing of JAX, so it runs on a machine with the card and without JAX:

    python -m pytest --noconftest tests/test_torch_knarpe_cuda.py -m cuda -q

Inputs come from a numpy seed, at the rollout's shapes and at small ones,
with an all-invalid source, a source with one valid target, odd K=89 and
source counts that are no multiple of the kernel's grid. bf16 B2 and B3 run on
the staged kernel (csrc/knarpe_staged.cuh) where it takes the shape, held at the
training path's shapes, K below 16 and no multiple of 16, fewer sources than
SMs, an odd count and a single source; the library takes each of those shapes,
two launches give the same bits, and an operand off a 16-byte boundary raises.
Of the shapes it refuses, bf16 B2 at the scaled preset's D=R=256 with H=8 takes
the cluster kernel (csrc/knarpe_cluster.cuh; at its eval and training shapes, K=5,
K=24 and K=104, the largest it takes, at 21 sources, and a single source); B3
there its heads kernel (csrc/knarpe_v3_heads.cuh; at the scaled eval and training
shapes, K=5, 24, 32, 33 and 200 at 21 sources, a single source and 8192 + 7
sources; an operand off a 16-byte boundary raises); B2 at K=120 (the cluster
kernel's shared memory), both at K=90 and K=128 at D=R=128 (widths neither wide
kernel is compiled for), and both at refusals of every other kind, take the
general kernel (csrc/knarpe.cu); the route is named and counted, and two
launches give the same bits. Tolerances:
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
Backward kernels (B4-bwd, B2-bwd, and B3's, which is B2's) against autograd
of the plain forwards, each gradient against its own largest magnitude M:
  - float32: 1e-4 M (summation order; dW and db sum over every source);
  - bfloat16 against the float32 plain backward on the same bf16-valued
    inputs: the kernel sums in float32 and rounds once, so 2^-8 of each
    value plus 1e-4 M.
A kernel output made from inputs that require grad has a `grad_fn`, and its
backward launches the backward kernel once. The bf16 B2 backward runs on the
staged kernel (csrc/knarpe_bwd_staged.cuh) where it takes the shape: at the
training path's shapes, K below 16 and no multiple of 16, source counts under
and over the 132-block grid, one head, a single source and K=128; the shapes
it refuses (eight heads, K=200) take the general kernel, named and counted;
two launches give the same bits, and an operand off a 16-byte boundary raises.
bf16 B4 and its backward run on the staged kernels (csrc/knarpe_attn_staged.cuh,
csrc/knarpe_attn_bwd_staged.cuh): held at the eval and training paths' shapes,
K=5 and K=24, 1, 97 and 8 x 1024 + 7 sources, one head at K=89, with k and v
both the halves of one [.., 2D] tensor and separate tensors, at the tolerances
above; the route is asserted and counted, two launches give the same bits, and
an operand off a 16-byte boundary or k/v rows 8 bytes off a multiple of 16
apart raise. The shapes they refuse (K=200, D=24, eight heads) and float32 take
the general kernels. Of the bf16 B4 shapes the staged kernel refuses, those at the
scaled preset's D=R=256 with H=8 take the heads kernel (csrc/knarpe_attn_heads.cuh;
at its eval and training shapes, K=5, K=24 and K=40, the largest it takes, at 97
sources, a single source and 8 x 1024 + 7 sources, k and v the halves of one tensor
and two tensors), the route named and counted, two launches bit-identical; K=89
there (its shared memory) and eight heads at other widths take the general kernel,
by the heads kernel's code. Their backward takes the heads backward
(csrc/knarpe_attn_bwd_heads.cuh) at the scaled training shape, K=5, K=24 and K=40
(the largest it takes) at 97 sources, a single source and 8 x 1024 + 7 sources, k
and v the halves of one tensor and two tensors, against autograd of the plain
version at the bf16 tolerance above, the route named and counted, two launches
bit-identical; K=48 (its shared memory), K=89 (over its softmax's 64) and eight
heads at other widths take the general backward, by its code, and an operand off
a 16-byte boundary or k/v rows 8 bytes off a multiple of 16 apart raise. The bf16
B2 backward (B3's too) at the scaled preset's D=R=256 with H=8 takes the heads
backward (csrc/knarpe_bwd_heads.cuh) at the scaled training shapes [1·64, K=89] and
[1·128, K=24], K=1, K=5, K=81 and K=128 (the largest it takes) at 21 sources, a
single source and 8 x 64 + 7 sources, at the bf16 tolerance above, the route named
and counted, two launches bit-identical; K=129 (over its softmax's 128) and eight
heads at other widths take the general backward, by its code, and an operand off
a 16-byte boundary raises.
"""

import threading

import numpy as np
import pytest
import torch

from trafficbotsv15_tpu_torch.ops import knarpe

F32_ATOL = 1e-4
BF16_REL = 2.0 ** -4

# (n_b, n_s, K, D, R, H): the rollout's B2/B3 and map encoder's B4 shapes, then small ones
CROSS_SHAPES = [(128, 64, 89, 128, 128, 4), (3, 7, 5, 16, 16, 2), (1, 33, 89, 32, 16, 8)]
ATTN_SHAPES = [(4, 1024, 32, 128, 128, 4), (3, 7, 5, 16, 16, 2), (2, 17, 89, 64, 32, 1)]
# the staged bf16 B2/B3 kernel (csrc/knarpe_staged.cuh): the training path's agent decoder and
# posterior agent encoder, the posterior TL encoder (K=24); K below 16 and no multiple of 16;
# source counts under the 132 SMs, odd (no multiple of the two-stage ring) and a single source
STAGED_SHAPES = [(8, 64, 89, 128, 128, 4), (8, 128, 24, 128, 128, 4), (1, 1, 3, 128, 128, 4),
                 (1, 97, 11, 64, 64, 2), (3, 15, 24, 32, 32, 8), (1, 131, 89, 128, 128, 4), (2, 5, 89, 32, 32, 1)]


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
STAGED_CASES = [(name, shape) for name in ("knarpe_cross_attention", "knarpe_cross_attention_v3")
                for shape in STAGED_SHAPES]


@pytest.mark.cuda
@pytest.mark.parametrize("name,shape", CASES + STAGED_CASES)
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


def _grad_case(name, shape, dtype):
    args = _cast(_inputs(shape, name != "knarpe_attention", seed=sum(shape) + 1), dtype)
    g = torch.from_numpy(np.random.default_rng(sum(shape)).normal(size=args[0].shape).astype(np.float32)).cuda()
    return args, g.to(dtype)


def _kernel_grads(name, args, g, n_head):
    leaves = [a.clone().requires_grad_(a.is_floating_point()) for a in args]
    out = getattr(knarpe, name)(*leaves, n_head)
    assert out.grad_fn is not None and out.requires_grad
    bwd = "knarpe_attention_bwd" if name == "knarpe_attention" else "knarpe_cross_attention_bwd"
    before = knarpe.LAUNCHES[bwd]
    out.backward(g)
    torch.cuda.synchronize()
    assert knarpe.LAUNCHES[bwd] == before + 1
    return [a.grad for a in leaves if a.requires_grad]


def _plain_grads(name, args, g, n_head):
    if name == "knarpe_attention":
        return list(knarpe.knarpe_attention_bwd_reference(*args, g, n_head))
    return list(knarpe.knarpe_cross_attention_bwd_reference(*args, g, n_head))


# B2-bwd (B3's backward too) at shapes the staged bf16 forward refuses: the scaled preset's D=R=256 with 8
# heads, and K=128 at D=R=128
WIDE_BWD_CASES = [("knarpe_cross_attention", (2, 16, 89, 256, 256, 8)), ("knarpe_cross_attention", (2, 16, 128, 128, 128, 4))]


@pytest.mark.cuda
@pytest.mark.parametrize("name,shape", CASES + WIDE_BWD_CASES)
def test_backward_kernel_matches_plain_autograd_on_card(name, shape):
    _need_card()
    n_head = shape[-1]
    args, g = _grad_case(name, shape, torch.float32)
    got = _kernel_grads(name, args, g, n_head)
    want = _plain_grads(name, args, g, n_head)
    assert len(got) == len(want) == 6
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert float((a - b).abs().max()) <= 1e-4 * max(float(b.abs().max()), 1e-30)
    assert torch.all(got[0][0, 0] == 0) and torch.all(got[1][0, 0] == 0)  # the all-invalid source

    a16, g16 = _grad_case(name, shape, torch.bfloat16)
    got16 = _kernel_grads(name, a16, g16, n_head)
    want32 = _plain_grads(name, _cast(a16, torch.float32), g16.float(), n_head)
    for a, b in zip(got16, want32):
        assert a.dtype == torch.bfloat16
        tol = 2.0 ** -8 * b.abs() + 1e-4 * float(b.abs().max())
        assert bool(((a.float() - b).abs() <= tol).all())


@pytest.mark.cuda
def test_kernel_output_carries_gradients():
    """The wrapper once returned a bare tensor on the card: no grad_fn, so every parameter
    upstream of B2 and B4 silently stopped learning. It must carry a grad_fn now."""
    _need_card()
    for name, shape in (("knarpe_cross_attention", CROSS_SHAPES[1]), ("knarpe_attention", ATTN_SHAPES[1])):
        args = _inputs(shape, name != "knarpe_attention", seed=3)
        w = args[-2].clone().requires_grad_(True)
        out = getattr(knarpe, name)(*args[:-2], w, args[-1], shape[-1])
        assert out.requires_grad and out.grad_fn is not None
        (grad,) = torch.autograd.grad(out.square().sum(), w)
        assert torch.isfinite(grad).all() and float(grad.abs().max()) > 0


@pytest.mark.cuda
def test_shapes_planned_later_do_not_break_earlier_ones():
    """A kernel's shared-memory limit is one attribute of the kernel function: planning a shape that
    needs less after one that needs more once lowered it, and the larger shape's next launch failed
    (cudaErrorInvalidValue). Large, small, large again, forward and backward."""
    _need_card()
    large, small = (2, 9, 71, 64, 64, 2), (2, 9, 3, 64, 64, 2)
    for shape in (large, small, large):
        args, g = _grad_case("knarpe_cross_attention", shape, torch.float32)
        grads = _kernel_grads("knarpe_cross_attention", args, g, shape[-1])
        assert all(torch.isfinite(x).all() for x in grads)


def _launch_counts(name):
    """Launches of a B2/B3 forward kernel, and by route: staged, general, then B2's cluster or B3's heads route."""
    wide = f"{name}/cluster" if name == "knarpe_cross_attention" else f"{name}/heads"
    return (knarpe.LAUNCHES[name], knarpe.ROUTE_LAUNCHES[f"{name}/staged"], knarpe.ROUTE_LAUNCHES[f"{name}/general"],
            knarpe.ROUTE_LAUNCHES[wide])


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["knarpe_cross_attention", "knarpe_cross_attention_v3"])
def test_bf16_shapes_the_staged_kernel_refuses_take_the_general_route(name):
    """Every bf16 B2/B3 shape above takes the staged kernel on the card; a shape it refuses (two
    stages of K=120 overflow the shared memory; D=24 is no multiple of 16; for B3 a d_head of 64 spans
    two warps' column blocks) takes the general kernel, named by `route` and counted under it, and
    matches the plain version (B2's cluster kernel and B3's heads kernel refuse them all: widths they are not
    compiled for, code 2); an operand off a 16-byte boundary at a staged shape raises."""
    _need_card()
    dev = torch.cuda.current_device()
    for shape in STAGED_SHAPES + CROSS_SHAPES:
        assert knarpe.staged_refusal(name, *shape[2:], dev) == 0
        assert knarpe.route(name, torch.bfloat16, *shape[2:], dev) == "staged"
    refused = [((1, 3, 120, 128, 128, 4), 5), ((1, 3, 5, 24, 16, 2), 2)]
    if name.endswith("_v3"):
        refused.append(((1, 3, 5, 128, 128, 2), 4))
    for shape, code in refused:
        assert knarpe.staged_refusal(name, *shape[2:], dev) == code
        wide = knarpe.cluster_refusal if name == "knarpe_cross_attention" else knarpe.v3_heads_refusal
        assert wide(*shape[2:], dev) == 2
        assert knarpe.general_refusal(name, *shape[2:], dev) == 0
        assert knarpe.route(name, torch.bfloat16, *shape[2:], dev) == "general"
        args = _cast(_inputs(shape, True, seed=9), torch.bfloat16)
        n, staged, general, cluster = _launch_counts(name)
        out16 = getattr(knarpe, name)(*args, shape[-1])
        torch.cuda.synchronize()
        assert _launch_counts(name) == (n + 1, staged, general + 1, cluster)
        _check_bf16(name, out16, args, shape[-1])
    args = _cast(_inputs(CROSS_SHAPES[1], True, seed=9), torch.bfloat16)
    buf = torch.empty(args[1].numel() + 1, dtype=torch.bfloat16, device="cuda")
    buf[1:] = args[1].reshape(-1)
    args[1] = buf[1:].view(args[1].shape)
    with pytest.raises(ValueError, match="16-byte aligned"):
        getattr(knarpe, name)(*args, CROSS_SHAPES[1][-1])


# bf16 B3 shapes the staged kernel refuses (C1) that take the general kernel, with the heads kernel's refusal code:
# K=90 and K=128 at the flagship's D=R=128, H=4 (widths it is not compiled for)
GENERAL_SHAPES = {(2, 64, 90, 128, 128, 4): 2, (2, 64, 128, 128, 128, 4): 2}
# and in B2, with the cluster kernel's refusal code: K=120 at D=R=256, H=8 (its shared memory), and the
# D=R=128 shapes (widths it is not compiled for)
GENERAL_B2_SHAPES = {(2, 64, 120, 256, 256, 8): 3, (2, 64, 90, 128, 128, 4): 2, (2, 64, 128, 128, 128, 4): 2}
# bf16 B2 on the cluster kernel: D=R=256, H=8 at K=89, the scaled training path's (1 x 64 agents), K=5 and
# K=24 (no multiple of 16) and K=104 (the largest its shared memory takes) at 21 sources, and a single
# source (fewer sources than clusters)
CLUSTER_SHAPES = [(2, 64, 89, 256, 256, 8), (1, 64, 89, 256, 256, 8), (1, 21, 5, 256, 256, 8),
                  (1, 21, 24, 256, 256, 8), (1, 21, 104, 256, 256, 8), (1, 1, 89, 256, 256, 8)]


def _check_bf16(name, out16, a16, n_head):
    """bf16 kernel output against the plain versions, at this file's bf16 tolerances."""
    assert out16.dtype == torch.bfloat16 and torch.all(out16[0, 0] == 0)
    out16 = out16.float()
    plain = getattr(knarpe, f"{name}_reference")
    ref32, ref16 = plain(*_cast(a16, torch.float32), n_head), plain(*a16, n_head).float()
    if name.endswith("_v3"):
        torch.testing.assert_close(out16, ref16, rtol=2.0 ** -7, atol=2.0 ** -8 * float(ref16.abs().max()))
        assert (out16 - ref16).abs().mean() <= 0.25 * (ref32 - ref16).abs().mean()
    else:
        torch.testing.assert_close(out16, ref32, rtol=2.0 ** -8, atol=F32_ATOL)
        assert (out16 - ref16).abs().max() <= BF16_REL * ref16.abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("name,shape", [*[("knarpe_cross_attention", s) for s in GENERAL_B2_SHAPES],
                                        *[("knarpe_cross_attention_v3", s) for s in GENERAL_SHAPES]])
def test_general_bf16_route_matches_plain_version(name, shape):
    """bf16 on the general route, and float32 at the same shapes (the general kernel reads B3's
    inputs from device memory where they do not fit in shared memory: float32 at D=R=256); B2 at
    shapes the cluster kernel refuses too, B3 at shapes its heads kernel refuses too, by the code named."""
    _need_card()
    dev, n_head = torch.cuda.current_device(), shape[-1]
    assert knarpe.staged_refusal(name, *shape[2:], dev) == 5
    if name == "knarpe_cross_attention":
        assert knarpe.cluster_refusal(*shape[2:], dev) == GENERAL_B2_SHAPES[shape]
    else:
        assert knarpe.v3_heads_refusal(*shape[2:], dev) == GENERAL_SHAPES[shape]
    assert knarpe.route(name, torch.bfloat16, *shape[2:], dev) == "general"
    args = _inputs(shape, True, seed=sum(shape))
    out = getattr(knarpe, name)(*args, n_head)
    torch.testing.assert_close(out, getattr(knarpe, f"{name}_reference")(*args, n_head), rtol=0, atol=F32_ATOL)
    a16 = _cast(args, torch.bfloat16)
    n, staged, general, cluster = _launch_counts(name)
    out16 = getattr(knarpe, name)(*a16, n_head)
    torch.cuda.synchronize()
    assert _launch_counts(name) == (n + 1, staged, general + 1, cluster)
    _check_bf16(name, out16, a16, n_head)
    assert torch.equal(getattr(knarpe, name)(*a16, n_head), out16)  # no atomics


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CLUSTER_SHAPES)
def test_cluster_bf16_route_matches_plain_version(shape):
    """bf16 B2 where the staged kernel refuses the shape (code 5, its resident weights) and the cluster kernel
    takes it: the cluster route, named and counted, within the bf16 tolerance of the float32 plain version on
    the same bf16-valued inputs, the all-invalid source zero, two launches bit-identical (no atomics: every
    sum, the partials exchanged between the cluster's blocks too, has a fixed order); float32 at the same
    shape takes the general kernel."""
    _need_card()
    name, dev, n_head = "knarpe_cross_attention", torch.cuda.current_device(), shape[-1]
    assert knarpe.staged_refusal(name, *shape[2:], dev) == 5 and knarpe.cluster_refusal(*shape[2:], dev) == 0
    assert knarpe.route(name, torch.bfloat16, *shape[2:], dev) == "cluster"
    assert knarpe.route(name, torch.float32, *shape[2:], dev) == "general"
    a16 = _cast(_inputs(shape, True, seed=sum(shape)), torch.bfloat16)
    n, staged, general, cluster = _launch_counts(name)
    out16 = knarpe.knarpe_cross_attention(*a16, n_head)
    torch.cuda.synchronize()
    assert _launch_counts(name) == (n + 1, staged, general, cluster + 1)
    _check_bf16(name, out16, a16, n_head)
    assert torch.equal(knarpe.knarpe_cross_attention(*a16, n_head), out16)


# bf16 B3 on its heads kernel (csrc/knarpe_v3_heads.cuh) at D=R=256, H=8: the scaled eval shape and its training
# path's (1 x 64 agents), K=5, K=24, K=32 (one whole tile) and K=33 (a one-target last tile) at 21 sources, K=200
# (seven tiles: the ring streams any K) at 21 sources, a single source (fewer sources than the grid's slots) and
# 8192 + 7 sources (no multiple of the grid)
V3_HEADS_SHAPES = [(128, 64, 89, 256, 256, 8), (1, 64, 89, 256, 256, 8), (1, 21, 5, 256, 256, 8),
                   (1, 21, 24, 256, 256, 8), (1, 21, 32, 256, 256, 8), (1, 21, 33, 256, 256, 8),
                   (1, 21, 200, 256, 256, 8), (1, 1, 89, 256, 256, 8), (1, 8199, 89, 256, 256, 8)]


def _v3_reference_exact_kk(q, tgt, rpe, invalid, w_kv, w_rpe, b, n_head):
    """B3's bf16 plain version with kk summed in float64 before its rounding (the correctly rounded kk), the rest as
    `knarpe_cross_attention_v3_reference`. -> [B, S, D] float32 (the bf16 output's values)."""
    n_b, n_s, n_knn, d = tgt.shape
    kk = (tgt.double() @ w_kv.double()[:, :d] + rpe.double() @ w_rpe.double()[:, :d] + b.double()[:d]).float()
    prod = q[:, :, None, :] * kk.to(torch.bfloat16)
    logits = prod.float().reshape(n_b, n_s, n_knn, n_head, d // n_head).sum(-1).transpose(2, 3) / (d // n_head) ** 0.5
    masked = invalid[:, :, None, :]
    e = torch.where(masked, 0.0, torch.exp(logits - torch.where(masked, -1e9, logits).amax(-1, keepdim=True)))
    den = e.sum(-1, keepdim=True)
    attn = e / torch.where(den <= 0, 1.0, den)
    vv = tgt.float() @ w_kv.float()[:, d:] + rpe.float() @ w_rpe.float()[:, d:] + b.float()[d:]
    out = torch.einsum("bshk,bskhd->bshd", attn, vv.reshape(n_b, n_s, n_knn, n_head, d // n_head))
    out = torch.where(den <= 0, 0.0, out)
    return out.reshape(n_b, n_s, d).to(torch.bfloat16).float()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", V3_HEADS_SHAPES)
def test_v3_heads_bf16_route_matches_plain_version(shape):
    """bf16 B3 where the staged kernel refuses the shape (code 5, its resident weights) and its heads kernel takes it:
    the heads route, named and counted, within B3's tolerance (one bf16 ulp relative plus 2^-8 of the largest output)
    of its bf16 plain version, or, element by element, of the same with kk summed in float64; the mean check against
    the plain version; the all-invalid source zero; two launches bit-identical (no atomics); float32 at the same shape
    takes the general kernel. Why the second reference: the float32 order of kk's 512 products is free, and where kk
    lies on a bf16 rounding boundary two orders round it apart; through q * kk, one ulp of a product as large as 16-32
    (0.125), that moves a logit by 0.022 and, with the attention split between two targets whose v differ by a few
    units, an output by ~0.03: at [1, 8199, 89] (seed 8809) one element of 2.1 M, 0.0293 from the plain version (0.0165
    allowed) and equal to the float64-summed result (measured on an H100 and on the CPU)."""
    _need_card()
    name, dev, n_head = "knarpe_cross_attention_v3", torch.cuda.current_device(), shape[-1]
    assert knarpe.staged_refusal(name, *shape[2:], dev) == 5 and knarpe.v3_heads_refusal(*shape[2:], dev) == 0
    assert knarpe.route(name, torch.bfloat16, *shape[2:], dev) == "heads"
    assert knarpe.route(name, torch.float32, *shape[2:], dev) == "general"
    a16 = _cast(_inputs(shape, True, seed=sum(shape)), torch.bfloat16)
    n, staged, general, heads = _launch_counts(name)
    out16 = knarpe.knarpe_cross_attention_v3(*a16, n_head)
    torch.cuda.synchronize()
    assert _launch_counts(name) == (n + 1, staged, general, heads + 1)
    assert out16.dtype == torch.bfloat16 and torch.all(out16[0, 0] == 0)
    got = out16.float()
    ref32, ref16 = knarpe.knarpe_cross_attention_v3_reference(*_cast(a16, torch.float32), n_head), \
        knarpe.knarpe_cross_attention_v3_reference(*a16, n_head).float()
    tol = 2.0 ** -7 * ref16.abs() + 2.0 ** -8 * float(ref16.abs().max())
    err = torch.minimum((got - ref16).abs(), (got - _v3_reference_exact_kk(*a16, n_head)).abs())
    assert float((err - tol).max()) <= 0
    assert (got - ref16).abs().mean() <= 0.25 * (ref32 - ref16).abs().mean()
    assert torch.equal(knarpe.knarpe_cross_attention_v3(*a16, n_head), out16)


@pytest.mark.cuda
def test_v3_heads_route_raises_for_misaligned_operands():
    """At a shape B3's heads kernel takes, an operand off a 16-byte boundary raises, naming the route."""
    _need_card()
    shape = V3_HEADS_SHAPES[2]
    args = _cast(_inputs(shape, True, seed=9), torch.bfloat16)
    buf = torch.empty(args[2].numel() + 1, dtype=torch.bfloat16, device="cuda")
    buf[1:] = args[2].reshape(-1)
    args[2] = buf[1:].view(args[2].shape)
    with pytest.raises(ValueError, match="the heads bf16 kernel copies 16-byte chunks"):
        knarpe.knarpe_cross_attention_v3(*args, shape[-1])


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["knarpe_cross_attention", "knarpe_cross_attention_v3"])
@pytest.mark.parametrize("shape", [CROSS_SHAPES[0], STAGED_SHAPES[0], STAGED_SHAPES[4]])
def test_two_launches_give_the_same_bits(name, shape):
    """No atomics: every sum of the staged kernels, forward and backward (and of the general backward,
    which takes the eight-head shape), has a fixed order."""
    _need_card()
    args = _cast(_inputs(shape, True, seed=7), torch.bfloat16)
    kernel = getattr(knarpe, name)
    first = kernel(*args, shape[-1])
    second = kernel(*args, shape[-1])
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    g = _grad_case(name, shape, torch.bfloat16)[1]
    grads = [_kernel_grads(name, args, g, shape[-1]) for _ in range(2)]
    assert all(torch.equal(a, b) for a, b in zip(*grads))


# the staged bf16 B2 backward (csrc/knarpe_bwd_staged.cuh; B3's backward is B2's): the training path's
# agent decoder and posterior agent encoder, the posterior TL encoder (K=24); K below 16 and no multiple
# of 16 with fewer sources than SMs; 131 sources; 200 sources (no multiple of the 132-block grid); one
# head; a single source; K=128, which one stage still holds
BWD_STAGED_SHAPES = [(8, 64, 89, 128, 128, 4), (8, 128, 24, 128, 128, 4), (1, 97, 11, 64, 64, 2),
                     (1, 131, 89, 128, 128, 4), (2, 100, 40, 128, 128, 4), (2, 5, 89, 32, 32, 1),
                     (1, 1, 3, 128, 128, 4), (2, 16, 128, 128, 128, 4)]
# bf16 B2 backward shapes the staged kernel refuses, with the code, that take the general route: K=200 (over
# the softmax's 128), eight heads (the scaled preset's D=R=256 at K=129, over the heads backward's 128 too, and
# D=32, R=16), and D=R=256 with four heads, whose weights alone overflow the shared memory
BWD_GENERAL_SHAPES = [((1, 9, 200, 128, 128, 4), 1), ((1, 9, 129, 256, 256, 8), 1), ((1, 33, 89, 32, 16, 8), 3),
                      ((1, 9, 16, 256, 256, 4), 4)]
BWD_ROUTES = ("staged", "heads", "general")


def _bwd_route_counts():
    return tuple(knarpe.ROUTE_LAUNCHES[f"knarpe_cross_attention_bwd/{way}"] for way in BWD_ROUTES)


def _check_bf16_grads(name, shape, want_route):
    """bf16 gradients through the wrapper's Function on want_route against the float32 plain backward on
    the same bf16-valued inputs: 2^-8 of each value plus 1e-4 of each gradient's largest magnitude."""
    n_head = shape[-1]
    a16, g16 = _grad_case(name, shape, torch.bfloat16)
    before = _bwd_route_counts()
    got16 = _kernel_grads(name, a16, g16, n_head)
    assert _bwd_route_counts() == tuple(n + (way == want_route) for n, way in zip(before, BWD_ROUTES))
    want32 = _plain_grads(name, _cast(a16, torch.float32), g16.float(), n_head)
    for a, b in zip(got16, want32):
        assert a.dtype == torch.bfloat16 and a.shape == b.shape
        tol = 2.0 ** -8 * b.abs() + 1e-4 * float(b.abs().max())
        assert bool(((a.float() - b).abs() <= tol).all())
    assert all(torch.all(x[0, 0] == 0) for x in got16[:3])  # dq, dtgt, drpe of the all-invalid source


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["knarpe_cross_attention", "knarpe_cross_attention_v3"])
@pytest.mark.parametrize("shape", BWD_STAGED_SHAPES)
def test_staged_backward_matches_plain_autograd_on_card(name, shape):
    _need_card()
    dev = torch.cuda.current_device()
    assert knarpe.bwd_staged_refusal(*shape[2:], dev) == 0
    assert knarpe.bwd_route("knarpe_cross_attention", torch.bfloat16, *shape[2:], dev) == "staged"
    _check_bf16_grads(name, shape, "staged")


@pytest.mark.cuda
@pytest.mark.parametrize("shape,code", BWD_GENERAL_SHAPES)
def test_bf16_backward_shapes_the_staged_kernel_refuses_take_the_general_route(shape, code):
    """`WIDE_BWD_CASES`' D=R=256 with 8 heads, which the staged kernel refuses (code 3), takes the heads
    route; its K=128 at D=R=128 fits one stage and takes the staged route (`BWD_STAGED_SHAPES`)."""
    _need_card()
    dev = torch.cuda.current_device()
    assert knarpe.bwd_staged_refusal(*shape[2:], dev) == code
    assert knarpe.bwd_route("knarpe_cross_attention", torch.bfloat16, *shape[2:], dev) == "general"
    _check_bf16_grads("knarpe_cross_attention", shape, "general")
    assert [knarpe.bwd_route("knarpe_cross_attention", torch.bfloat16, *s[2:], dev) for _, s in WIDE_BWD_CASES] == [
        "heads", "staged"]


@pytest.mark.cuda
def test_staged_backward_raises_for_misaligned_operands():
    """An operand off a 16-byte boundary at a staged shape raises; it does not slide onto the general kernel."""
    _need_card()
    shape = BWD_STAGED_SHAPES[2]
    (q, tgt, rpe, inv, w_kv, w_rpe, b), g = _grad_case("knarpe_cross_attention", shape, torch.bfloat16)
    buf = torch.empty(tgt.numel() + 1, dtype=torch.bfloat16, device="cuda")
    buf[1:] = tgt.reshape(-1)
    tgt = buf[1:].view(tgt.shape)
    counts = _bwd_route_counts()
    with pytest.raises(ValueError, match="16-byte aligned"):
        knarpe._launch_bwd("knarpe_cross_attention", q, None, None, tgt, rpe, inv, w_kv, w_rpe, b, g, shape[-1])
    assert _bwd_route_counts() == counts


# the heads bf16 B2 backward (csrc/knarpe_bwd_heads.cuh; B3's backward is B2's): the scaled preset's training shapes
# (the agent decoder's [1·64, K=89], the posterior TL encoder's [1·128, K=24]); K=1, K=5, K=81 (no multiple of 16) and
# K=128 (the largest it takes) at 21 sources; a single source; 8 x 64 + 7 sources (no multiple of the grid's slots)
X_HEADS_BWD_SHAPES = [(1, 64, 89, 256, 256, 8), (1, 128, 24, 256, 256, 8), (1, 21, 1, 256, 256, 8),
                      (1, 21, 5, 256, 256, 8), (1, 21, 81, 256, 256, 8), (1, 21, 128, 256, 256, 8),
                      (1, 1, 89, 256, 256, 8), (1, 519, 89, 256, 256, 8)]
# bf16 B2 backward shapes at eight heads the heads backward refuses too, with its code: K=129 at D=R=256 (over its
# softmax's 128) and D=32, R=16 (widths it is not compiled for)
X_HEADS_BWD_GENERAL_SHAPES = [((1, 9, 129, 256, 256, 8), 1), ((1, 33, 89, 32, 16, 8), 2)]


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["knarpe_cross_attention", "knarpe_cross_attention_v3"])
@pytest.mark.parametrize("shape", X_HEADS_BWD_SHAPES)
def test_heads_cross_backward_matches_plain_autograd_on_card(name, shape):
    """bf16 B2-bwd (through B2's and B3's Function) where the staged backward refuses the shape (more than 4 heads,
    code 3) and the heads backward takes it: the heads route, named and counted, within the bf16 tolerance of autograd
    of the float32 plain version, the all-invalid source zero, two launches bit-identical; float32 takes the general
    backward."""
    _need_card()
    dev = torch.cuda.current_device()
    assert knarpe.bwd_staged_refusal(*shape[2:], dev) == 3
    assert knarpe.x_bwd_heads_refusal(*shape[2:], dev) == 0
    assert knarpe.bwd_route("knarpe_cross_attention", torch.bfloat16, *shape[2:], dev) == "heads"
    assert knarpe.bwd_route("knarpe_cross_attention", torch.float32, *shape[2:], dev) == "general"
    _check_bf16_grads(name, shape, "heads")
    a16, g16 = _grad_case(name, shape, torch.bfloat16)
    grads = [_kernel_grads(name, a16, g16, shape[-1]) for _ in range(2)]
    assert all(torch.equal(a, b) for a, b in zip(*grads))


@pytest.mark.cuda
@pytest.mark.parametrize("shape,code", X_HEADS_BWD_GENERAL_SHAPES)
def test_bf16_cross_backward_shapes_the_heads_kernel_refuses_take_the_general_route(shape, code):
    """bf16 B2-bwd where the staged and heads backwards both refuse: the general route, by the heads backward's code,
    within the bf16 tolerance."""
    _need_card()
    dev = torch.cuda.current_device()
    assert knarpe.bwd_staged_refusal(*shape[2:], dev) != 0
    assert knarpe.x_bwd_heads_refusal(*shape[2:], dev) == code
    assert knarpe.bwd_route("knarpe_cross_attention", torch.bfloat16, *shape[2:], dev) == "general"
    _check_bf16_grads("knarpe_cross_attention", shape, "general")


@pytest.mark.cuda
def test_heads_cross_backward_raises_for_misaligned_operands():
    """At a shape the heads B2 backward takes, an operand off a 16-byte boundary raises before any launch; it does not
    slide onto the general kernel."""
    _need_card()
    shape = X_HEADS_BWD_SHAPES[3]
    (q, tgt, rpe, inv, w_kv, w_rpe, b), g = _grad_case("knarpe_cross_attention", shape, torch.bfloat16)
    buf = torch.empty(rpe.numel() + 1, dtype=torch.bfloat16, device="cuda")
    buf[1:] = rpe.reshape(-1)
    rpe = buf[1:].view(rpe.shape)
    counts = _bwd_route_counts()
    with pytest.raises(ValueError, match="16-byte aligned"):
        knarpe._launch_bwd("knarpe_cross_attention", q, None, None, tgt, rpe, inv, w_kv, w_rpe, b, g, shape[-1])
    assert _bwd_route_counts() == counts


# the staged bf16 B4 and B4-bwd (csrc/knarpe_attn_staged.cuh, csrc/knarpe_attn_bwd_staged.cuh): the eval and
# training paths' map encoder; K=5 and K=24 (no multiple of 16) at 97 sources (under the 132 SMs, no
# multiple of the four groups or of the ring); a single source; 8 x 1024 + 7 sources; one head at K=89
ATTN_STAGED_SHAPES = [(4, 1024, 32, 128, 128, 4), (8, 1024, 32, 128, 128, 4), (1, 97, 5, 128, 128, 4),
                      (1, 97, 24, 64, 64, 2), (1, 1, 32, 128, 128, 4), (1, 8199, 32, 128, 128, 4),
                      (2, 5, 89, 32, 32, 1)]
# bf16 B4 shapes the staged kernels refuse, with the code (the same in both directions): K=200 (over the
# softmax's 128), D=24 (no multiple of 16), eight heads
ATTN_GENERAL_SHAPES = [((1, 9, 200, 128, 128, 4), 1), ((1, 9, 5, 24, 16, 2), 2), ((1, 33, 89, 32, 16, 8), 3)]


def _attn_counts(kernel):
    return (knarpe.LAUNCHES[kernel], knarpe.ROUTE_LAUNCHES[f"{kernel}/staged"],
            knarpe.ROUTE_LAUNCHES[f"{kernel}/general"])


def _as_halves(args):
    """B4's operands with k and v the halves of one [.., 2D] tensor, as the map encoder passes them."""
    kv = torch.cat(args[1:3], -1)
    return [args[0], *kv.chunk(2, -1), *args[3:]]


def _attn_grads(args, g, n_head, halves):
    """bf16 B4 gradients through the Function (dq, dk, dv, drpe, dw_rpe, db); with halves, k and v are
    views of one leaf [.., 2D] tensor whose gradient is split back."""
    leaves = [a.clone().requires_grad_(a.is_floating_point()) for a in args]
    if halves:
        kv = torch.cat([leaves[1].detach(), leaves[2].detach()], -1).requires_grad_(True)
        call = [leaves[0], *kv.chunk(2, -1), *leaves[3:]]
    else:
        call = leaves
    out = knarpe.knarpe_attention(*call, n_head)
    out.backward(g)
    torch.cuda.synchronize()
    dk, dv = kv.grad.chunk(2, -1) if halves else (leaves[1].grad, leaves[2].grad)
    return [leaves[0].grad, dk, dv, leaves[3].grad, leaves[5].grad, leaves[6].grad]


def _check_attn(shape, want_route, halves):
    """bf16 B4 and its backward on want_route against the float32 plain versions, routes counted, two
    launches bit-identical, zero for the all-invalid source."""
    n_head = shape[-1]
    a16 = _cast(_inputs(shape, False, seed=sum(shape) + 5), torch.bfloat16)
    if halves:
        a16 = _as_halves(a16)
    n, staged, general = _attn_counts("knarpe_attention")
    out16 = knarpe.knarpe_attention(*a16, n_head)
    torch.cuda.synchronize()
    assert _attn_counts("knarpe_attention") == ((n + 1, staged + 1, general) if want_route == "staged"
                                                else (n + 1, staged, general + 1))
    _check_bf16("knarpe_attention", out16, a16, n_head)
    assert torch.equal(knarpe.knarpe_attention(*a16, n_head), out16)  # no atomics

    g16 = torch.from_numpy(np.random.default_rng(sum(shape)).normal(size=a16[0].shape).astype(np.float32))
    g16 = g16.cuda().to(torch.bfloat16)
    n, staged, general = _attn_counts("knarpe_attention_bwd")
    got16 = _attn_grads(a16, g16, n_head, halves)
    assert _attn_counts("knarpe_attention_bwd") == ((n + 1, staged + 1, general) if want_route == "staged"
                                                    else (n + 1, staged, general + 1))
    want32 = _plain_grads("knarpe_attention", _cast(a16, torch.float32), g16.float(), n_head)
    for a, b in zip(got16, want32):
        assert a.dtype == torch.bfloat16 and a.shape == b.shape
        tol = 2.0 ** -8 * b.abs() + 1e-4 * float(b.abs().max())
        assert bool(((a.float() - b).abs() <= tol).all())
    assert all(torch.all(x[0, 0] == 0) for x in got16[:4])  # dq, dk, dv, drpe of the all-invalid source
    assert all(torch.equal(a, b) for a, b in zip(_attn_grads(a16, g16, n_head, halves), got16))


@pytest.mark.cuda
@pytest.mark.parametrize("halves", [True, False], ids=["kv_halves", "kv_separate"])
@pytest.mark.parametrize("shape", ATTN_STAGED_SHAPES)
def test_staged_attention_matches_plain_versions_on_card(shape, halves):
    _need_card()
    dev = torch.cuda.current_device()
    assert knarpe.staged_refusal("knarpe_attention", *shape[2:], dev) == 0
    assert knarpe.attn_bwd_staged_refusal(*shape[2:], dev) == 0
    assert knarpe.route("knarpe_attention", torch.bfloat16, *shape[2:], dev) == "staged"
    assert knarpe.bwd_route("knarpe_attention", torch.bfloat16, *shape[2:], dev) == "staged"
    _check_attn(shape, "staged", halves)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,code", ATTN_GENERAL_SHAPES)
def test_bf16_attention_shapes_the_staged_kernels_refuse_take_the_general_route(shape, code):
    _need_card()
    dev = torch.cuda.current_device()
    assert knarpe.staged_refusal("knarpe_attention", *shape[2:], dev) == code
    assert knarpe.attn_bwd_staged_refusal(*shape[2:], dev) == code
    assert knarpe.route("knarpe_attention", torch.bfloat16, *shape[2:], dev) == "general"
    assert knarpe.bwd_route("knarpe_attention", torch.bfloat16, *shape[2:], dev) == "general"
    _check_attn(shape, "general", halves=True)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ATTN_SHAPES[1:])
def test_attention_edge_shapes_pass_on_their_named_route(shape):
    """The edge shapes of `ATTN_SHAPES` (K=5 at D=R=16 with two heads; K=89 at D=64, R=32 with one head)
    on whichever route `route` names for them, which both the forward and the backward take."""
    _need_card()
    dev = torch.cuda.current_device()
    way = knarpe.route("knarpe_attention", torch.bfloat16, *shape[2:], dev)
    assert way == knarpe.bwd_route("knarpe_attention", torch.bfloat16, *shape[2:], dev) == "staged"
    _check_attn(shape, way, halves=True)


@pytest.mark.cuda
def test_float32_attention_stays_on_the_general_route():
    _need_card()
    shape = ATTN_STAGED_SHAPES[2]
    args, g = _grad_case("knarpe_attention", shape, torch.float32)
    assert knarpe.route("knarpe_attention", torch.float32, *shape[2:], 0) == "general"
    n, staged, general = _attn_counts("knarpe_attention")
    n_b, staged_b, general_b = _attn_counts("knarpe_attention_bwd")
    _kernel_grads("knarpe_attention", args, g, shape[-1])
    assert _attn_counts("knarpe_attention") == (n + 1, staged, general + 1)
    assert _attn_counts("knarpe_attention_bwd") == (n_b + 1, staged_b, general_b + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("fault", ["misaligned_rpe", "kv_stride_off_16_bytes"])
def test_staged_attention_raises_for_misaligned_operands(fault):
    """At a staged shape an operand off a 16-byte boundary, or k and v rows 8 bytes off a multiple of 16
    bytes apart, raises in both directions; it does not slide onto the general kernel."""
    _need_card()
    shape = ATTN_STAGED_SHAPES[2]
    n_b, n_s, n_knn, d, _, n_head = shape
    (q, k, v, rpe, inv, w, b), g = _grad_case("knarpe_attention", shape, torch.bfloat16)
    if fault == "misaligned_rpe":
        buf = torch.empty(rpe.numel() + 1, dtype=torch.bfloat16, device="cuda")
        buf[1:] = rpe.reshape(-1)
        rpe, match = buf[1:].view(rpe.shape), "16-byte aligned"
    else:  # rows of 2D + 4 elements: k and v keep one stride, 8 bytes off a multiple of 16
        buf = torch.zeros(n_b, n_s, n_knn, 2 * d + 4, dtype=torch.bfloat16, device="cuda")
        buf[..., :d], buf[..., d:2 * d] = k, v
        k, v, match = buf[..., :d], buf[..., d:2 * d], "multiple of 16 bytes"
    counts = (_attn_counts("knarpe_attention"), _attn_counts("knarpe_attention_bwd"))
    with pytest.raises(ValueError, match=match):
        knarpe.knarpe_attention(q, k, v, rpe, inv, w, b, n_head)
    with pytest.raises(ValueError, match=match):
        knarpe._launch_bwd("knarpe_attention", q, k, v, None, rpe, inv, None, w, b, g, n_head)
    assert (_attn_counts("knarpe_attention"), _attn_counts("knarpe_attention_bwd")) == counts


# bf16 B4 on the heads kernel (csrc/knarpe_attn_heads.cuh): the scaled preset's eval and training shapes, K=5, K=24
# and K=40 (the largest its shared memory takes) at 97 sources, a single source and 8 x 1024 + 7 sources
HEADS_ATTN_SHAPES = [(4, 1024, 32, 256, 256, 8), (1, 1024, 32, 256, 256, 8), (1, 97, 5, 256, 256, 8),
                     (1, 97, 24, 256, 256, 8), (1, 97, 40, 256, 256, 8), (1, 1, 32, 256, 256, 8),
                     (1, 8199, 32, 256, 256, 8)]
# bf16 B4 shapes the heads kernel refuses too, with its code: K=89 at D=R=256, 8 heads (its shared memory), and
# ATTN_GENERAL_SHAPES' eight heads at other widths (widths it is not compiled for)
HEADS_GENERAL_SHAPES = [((1, 33, 89, 256, 256, 8), 3), (ATTN_GENERAL_SHAPES[2][0], 2)]


def _heads_counts():
    return (knarpe.LAUNCHES["knarpe_attention"],
            *(knarpe.ROUTE_LAUNCHES[f"knarpe_attention/{way}"] for way in ("staged", "heads", "general")))


@pytest.mark.cuda
@pytest.mark.parametrize("halves", [True, False], ids=["kv_halves", "kv_separate"])
@pytest.mark.parametrize("shape", HEADS_ATTN_SHAPES)
def test_heads_attention_matches_plain_version_on_card(shape, halves):
    """bf16 B4 where the staged kernel refuses the shape (more than 4 heads, code 3) and the heads kernel takes it:
    the heads route, named and counted, within the bf16 tolerance of the float32 plain version on the same
    bf16-valued inputs, the all-invalid source zero, two launches bit-identical (no atomics); float32 at the same
    shape takes the general kernel; the bf16 backward the heads backward."""
    _need_card()
    dev, n_head = torch.cuda.current_device(), shape[-1]
    assert knarpe.staged_refusal("knarpe_attention", *shape[2:], dev) == 3
    assert knarpe.heads_refusal(*shape[2:], dev) == 0
    assert knarpe.route("knarpe_attention", torch.bfloat16, *shape[2:], dev) == "heads"
    assert knarpe.route("knarpe_attention", torch.float32, *shape[2:], dev) == "general"
    assert knarpe.bwd_route("knarpe_attention", torch.bfloat16, *shape[2:], dev) == "heads"
    a16 = _cast(_inputs(shape, False, seed=sum(shape) + 7), torch.bfloat16)
    if halves:
        a16 = _as_halves(a16)
    n, staged, heads, general = _heads_counts()
    out16 = knarpe.knarpe_attention(*a16, n_head)
    torch.cuda.synchronize()
    assert _heads_counts() == (n + 1, staged, heads + 1, general)
    _check_bf16("knarpe_attention", out16, a16, n_head)
    assert torch.equal(knarpe.knarpe_attention(*a16, n_head), out16)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,code", HEADS_GENERAL_SHAPES)
def test_bf16_attention_shapes_the_heads_kernel_refuses_take_the_general_route(shape, code):
    """bf16 B4 where the staged and heads kernels both refuse: the general route, by the heads kernel's code, within
    the bf16 tolerance, two launches bit-identical."""
    _need_card()
    dev, n_head = torch.cuda.current_device(), shape[-1]
    assert knarpe.staged_refusal("knarpe_attention", *shape[2:], dev) == 3
    assert knarpe.heads_refusal(*shape[2:], dev) == code
    assert knarpe.route("knarpe_attention", torch.bfloat16, *shape[2:], dev) == "general"
    a16 = _as_halves(_cast(_inputs(shape, False, seed=sum(shape) + 7), torch.bfloat16))
    n, staged, heads, general = _heads_counts()
    out16 = knarpe.knarpe_attention(*a16, n_head)
    torch.cuda.synchronize()
    assert _heads_counts() == (n + 1, staged, heads, general + 1)
    _check_bf16("knarpe_attention", out16, a16, n_head)
    assert torch.equal(knarpe.knarpe_attention(*a16, n_head), out16)


@pytest.mark.cuda
@pytest.mark.parametrize("fault", ["misaligned_rpe", "kv_stride_off_16_bytes"])
def test_heads_attention_raises_for_misaligned_operands(fault):
    """At a heads shape an operand off a 16-byte boundary, or k and v rows 8 bytes off a multiple of 16 bytes
    apart, raises; it does not slide onto the general kernel."""
    _need_card()
    shape = HEADS_ATTN_SHAPES[2]
    n_b, n_s, n_knn, d, _, n_head = shape
    q, k, v, rpe, inv, w, b = _cast(_inputs(shape, False, seed=3), torch.bfloat16)
    if fault == "misaligned_rpe":
        buf = torch.empty(rpe.numel() + 1, dtype=torch.bfloat16, device="cuda")
        buf[1:] = rpe.reshape(-1)
        rpe, match = buf[1:].view(rpe.shape), "16-byte aligned"
    else:
        buf = torch.zeros(n_b, n_s, n_knn, 2 * d + 4, dtype=torch.bfloat16, device="cuda")
        buf[..., :d], buf[..., d:2 * d] = k, v
        k, v, match = buf[..., :d], buf[..., d:2 * d], "multiple of 16 bytes"
    counts = _heads_counts()
    with pytest.raises(ValueError, match=match):
        knarpe.knarpe_attention(q, k, v, rpe, inv, w, b, n_head)
    assert _heads_counts() == counts


# bf16 B4-bwd on the heads backward (csrc/knarpe_attn_bwd_heads.cuh): the scaled preset's training shape, K=5, K=24 and
# K=40 (the largest its shared memory takes) at 97 sources, a single source and 8 x 1024 + 7 sources
HEADS_ATTN_BWD_SHAPES = [(1, 1024, 32, 256, 256, 8), (1, 97, 5, 256, 256, 8), (1, 97, 24, 256, 256, 8),
                         (1, 97, 40, 256, 256, 8), (1, 1, 32, 256, 256, 8), (1, 8199, 32, 256, 256, 8)]
# bf16 B4-bwd shapes the heads backward refuses too, with its code: K=48 at D=R=256, 8 heads (its shared memory), K=89
# there (over its softmax's 64), and ATTN_GENERAL_SHAPES' eight heads at other widths (widths it is not compiled for)
HEADS_BWD_GENERAL_SHAPES = [((1, 33, 48, 256, 256, 8), 3), ((1, 33, 89, 256, 256, 8), 1),
                            (ATTN_GENERAL_SHAPES[2][0], 2)]


def _bwd_heads_counts():
    return (knarpe.LAUNCHES["knarpe_attention_bwd"],
            *(knarpe.ROUTE_LAUNCHES[f"knarpe_attention_bwd/{way}"] for way in ("staged", "heads", "general")))


def _check_attn_bwd(shape, want_route, halves):
    """bf16 B4-bwd on want_route against the float32 plain backward on the same bf16-valued inputs (2^-8 of each
    value plus 1e-4 of each gradient's largest), the route counted, the all-invalid source's dq, dk, dv and drpe
    zero, two launches bit-identical."""
    n_head = shape[-1]
    a16 = _cast(_inputs(shape, False, seed=sum(shape) + 9), torch.bfloat16)
    if halves:
        a16 = _as_halves(a16)
    g16 = torch.from_numpy(np.random.default_rng(sum(shape) + 2).normal(size=a16[0].shape).astype(np.float32))
    g16 = g16.cuda().to(torch.bfloat16)
    n, staged, heads, general = _bwd_heads_counts()
    got16 = _attn_grads(a16, g16, n_head, halves)
    assert _bwd_heads_counts() == ((n + 1, staged, heads + 1, general) if want_route == "heads"
                                   else (n + 1, staged, heads, general + 1))
    want32 = _plain_grads("knarpe_attention", _cast(a16, torch.float32), g16.float(), n_head)
    for a, b in zip(got16, want32):
        assert a.dtype == torch.bfloat16 and a.shape == b.shape
        tol = 2.0 ** -8 * b.abs() + 1e-4 * float(b.abs().max())
        assert bool(((a.float() - b).abs() <= tol).all())
    assert all(torch.all(x[0, 0] == 0) for x in got16[:4])
    assert all(torch.equal(a, b) for a, b in zip(_attn_grads(a16, g16, n_head, halves), got16))


@pytest.mark.cuda
@pytest.mark.parametrize("halves", [True, False], ids=["kv_halves", "kv_separate"])
@pytest.mark.parametrize("shape", HEADS_ATTN_BWD_SHAPES)
def test_heads_attention_backward_matches_plain_autograd_on_card(shape, halves):
    """bf16 B4-bwd where the staged backward refuses the shape (more than 4 heads, code 3) and the heads backward takes
    it: the heads route, named and counted, within the bf16 tolerance of autograd of the float32 plain version; float32
    takes the general backward."""
    _need_card()
    dev = torch.cuda.current_device()
    assert knarpe.attn_bwd_staged_refusal(*shape[2:], dev) == 3
    assert knarpe.attn_bwd_heads_refusal(*shape[2:], dev) == 0
    assert knarpe.bwd_route("knarpe_attention", torch.bfloat16, *shape[2:], dev) == "heads"
    assert knarpe.bwd_route("knarpe_attention", torch.float32, *shape[2:], dev) == "general"
    _check_attn_bwd(shape, "heads", halves)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,code", HEADS_BWD_GENERAL_SHAPES)
def test_bf16_attention_backward_shapes_the_heads_kernel_refuses_take_the_general_route(shape, code):
    """bf16 B4-bwd where the staged and heads backwards both refuse: the general route, by the heads backward's code,
    within the bf16 tolerance, two launches bit-identical."""
    _need_card()
    dev = torch.cuda.current_device()
    assert knarpe.attn_bwd_staged_refusal(*shape[2:], dev) == 3
    assert knarpe.attn_bwd_heads_refusal(*shape[2:], dev) == code
    assert knarpe.bwd_route("knarpe_attention", torch.bfloat16, *shape[2:], dev) == "general"
    _check_attn_bwd(shape, "general", halves=True)


@pytest.mark.cuda
@pytest.mark.parametrize("fault", ["misaligned_rpe", "kv_stride_off_16_bytes"])
def test_heads_attention_backward_raises_for_misaligned_operands(fault):
    """At a shape the heads backward takes, an operand off a 16-byte boundary, or k and v rows 8 bytes off a multiple
    of 16 bytes apart, raises before any launch; it does not slide onto the general kernel."""
    _need_card()
    shape = HEADS_ATTN_BWD_SHAPES[1]
    n_b, n_s, n_knn, d, _, n_head = shape
    (q, k, v, rpe, inv, w, b), g = _grad_case("knarpe_attention", shape, torch.bfloat16)
    if fault == "misaligned_rpe":
        buf = torch.empty(rpe.numel() + 1, dtype=torch.bfloat16, device="cuda")
        buf[1:] = rpe.reshape(-1)
        rpe, match = buf[1:].view(rpe.shape), "16-byte aligned"
    else:
        buf = torch.zeros(n_b, n_s, n_knn, 2 * d + 4, dtype=torch.bfloat16, device="cuda")
        buf[..., :d], buf[..., d:2 * d] = k, v
        k, v, match = buf[..., :d], buf[..., d:2 * d], "multiple of 16 bytes"
    counts = _bwd_heads_counts()
    with pytest.raises(ValueError, match=f"the heads bf16 kernel .*{match}"):
        knarpe._launch_bwd("knarpe_attention", q, k, v, None, rpe, inv, None, w, b, g, n_head)
    assert _bwd_heads_counts() == counts


@pytest.mark.cuda
def test_launches_from_a_thread_without_a_current_context():
    """A launch that encodes tensor maps from a thread that has issued no CUDA call yet, as autograd's worker thread
    does for the first backward launch, succeeds: the heads B4 forward and backward, each the first CUDA call of a
    fresh thread, give the same bits as from this thread (without a context cuTensorMapEncodeTiled refuses)."""
    _need_card()
    shape = HEADS_ATTN_BWD_SHAPES[1]
    n_head = shape[-1]
    (q, k, v, rpe, inv, w, b), g = _grad_case("knarpe_attention", shape, torch.bfloat16)
    fwd = lambda: knarpe._launch("knarpe_attention", q, k, v, None, rpe, inv, None, w, b, n_head)
    bwd = lambda: knarpe._launch_bwd("knarpe_attention", q, k, v, None, rpe, inv, None, w, b, g, n_head)
    got = {}

    def in_thread(name, fn):
        try:
            got[name] = fn()
            torch.cuda.synchronize()
        except Exception as exc:  # re-raised below, on the test's thread
            got[name] = exc

    for name, fn in (("fwd", fwd), ("bwd", bwd)):
        worker = threading.Thread(target=in_thread, args=(name, fn))
        worker.start()
        worker.join()
        if isinstance(got[name], Exception):
            raise got[name]
    assert torch.equal(got["fwd"], fwd())
    assert all(a is None or torch.equal(a, c) for a, c in zip(got["bwd"], bwd()))
