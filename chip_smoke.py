#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:
  1. device: needs CUDA; prints the card's name and power limit and turns
     TF32 off for matmuls and cuDNN;
  2. build: compiles every CUDA source of the path from csrc/ (nvcc, sm_90a),
     one nvcc per source, all started together;
  3. kernels: each kernel against its plain PyTorch version on the card, at
     the main path's shapes and at edge cases; times kernel, plain version and
     the nearest PyTorch call or composition of calls (`library_ms`):
     B1 (`knn_xy`), B4 (`knarpe_attention`), B2 (`knarpe_cross_attention`)
     and B3 (`knarpe_cross_attention_v3`, which only this phase launches);
     then the backward kernels B4-bwd and B2-bwd (B3's backward is B2's)
     through the wrappers' autograd: the card's output has a grad_fn, and its
     gradients match autograd of the plain versions in float32 and bf16;
     timed against the plain backward and the library composition's backward;
  4. slice checked: a reduced-depth float32 config whose map has 512
     polylines runs `joint_future_pred` (check_level=1) on the card and on
     the CPU with the same weights, once with use_pallas=False and once with
     use_pallas=True; the K0 futures and their rule flags must agree, and the
     kernels must launch as often as the config's layers and steps say;
  5. slice at full width, use_pallas=False: `leaderboard_config()` (bf16
     compute), 4 synthetic scenarios x K=32 futures, 64 agents, 1024
     polylines, 90 steps, check_level=1: finite poses of the documented
     shapes, 90 KNN launches and no attention-kernel launch per call, seconds
     per call, peak memory and agent-steps/s;
  6. slice at full width, use_pallas=True (the eval main path): the same
     call with the KNARPE attention kernels; B1, B2 and B4 launches per call
     asserted (90, 4 layers x 90 steps, 8 map layers); then one more call
     whose level-1 rule checks at four steps are replayed on the CPU from the
     card's inputs, the flags to agree;
  7. train step checked: the phase-4 config with every dropout rate at 0
     (CPU and CUDA generators draw different masks) runs one
     `make_train_step` on the card and on the CPU with the same weights and
     the same draws, with use_pallas False and True: loss, grad_norm and every
     parameter's gradient (as the optimizer applies it) agree, and the kernels
     launch, forward and backward, as often as the config implies;
  8. training at full width (the training main path): `leaderboard_config()`
     with use_pallas=True, 8 synthetic scenarios per step, bf16 compute with
     f32 parameters: one warm-up step, then 3 timed steps; seconds per step,
     train samples/s, peak memory, forward and backward launches per step
     (asserted); loss and grad_norm finite and non-zero, parameters changed.
Then it prints the `kernels` JSON line (forward launches from phase 6,
backward ones from phase 8), the card line, and last
`{"ok": true, "device": {...}}`. Imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from trafficbotsv15_tpu_torch.config import leaderboard_config, tiny_config, with_pallas
from trafficbotsv15_tpu_torch.data.synthetic import make_batch
from trafficbotsv15_tpu_torch.ops import knarpe, knn
from trafficbotsv15_tpu_torch.sim import rollout as rollout_lib
from trafficbotsv15_tpu_torch.train import pipeline as train_lib
from trafficbotsv15_tpu_torch.train.evaluation import joint_future_pred
from trafficbotsv15_tpu_torch.train.optimizer import make_optimizer
from trafficbotsv15_tpu_torch.train.pipeline import build_model

HBM_BYTES_PER_S = 3.35e12  # H100 SXM (NVIDIA data sheet, 700 W)
FP32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
BF16_FLOPS = 989e12  # H100 SXM bf16 on the tensor cores, dense
KNN_ROWS, KNN_SRC, KNN_TGT, KNN_K = 128, 64, 1024, 64  # 4 scenarios x 32 futures, agents, polylines, 2.0 * 32
SLICE_POSE_ATOL = 1e-3  # m; float32 on card vs CPU, reduction order only
# KNARPE shapes (n_b, n_s, K, D, R, H) on the full-width path: the agent decoder's
# cross-attention (128 rollouts x 64 agents, 64 map + 25 TL targets) and the map encoder
X_PATH = (128, 64, 89, 128, 128, 4)
ATTN_PATH = (4, 1024, 32, 128, 128, 4)
# and on the training path (8 scenarios, no K-fold replication): the agent decoder's B2 and its
# backward at 8 x 64 sources, the map encoder's B4 and its backward at 8 x 1024
TRAIN_X_PATH = (8, 64, 89, 128, 128, 4)
TRAIN_ATTN_PATH = (8, 1024, 32, 128, 128, 4)
# edge cases: an all-invalid and a one-target source in each; source counts that are
# no multiple of any tile; odd K; one and eight heads
X_EDGE = [(3, 7, 5, 16, 16, 2), (1, 33, 89, 32, 16, 8)]
ATTN_EDGE = [(3, 7, 5, 16, 16, 2), (2, 17, 89, 64, 32, 1)]
# kernel vs plain version: float32 differs by summation order only (the kernel
# reassociates the projections with the attention, csrc/knarpe.cu); bf16 rounds
# once at the output, so half a bf16 ulp (<= 2^-8 of the value) on top. B3 rounds
# k and q*k to bf16 as its plain version does, and a rounding that the other
# float32 summation order flips moves a logit by up to an ulp of one q*k term: one
# ulp of the output (2^-7) plus 2^-8 of the largest output; and its mean error
# must stay under a quarter of what leaving its roundings out would give
KNARPE_F32_ATOL, BF16_HALF_ULP, BF16_ULP = 1e-4, 2.0 ** -8, 2.0 ** -7
# rollout steps whose rule checks phase 6 replays on the CPU; the flags may differ
# where CUDA's sinf/cosf (within 2 ulp of the CPU's) move a box corner across a
# threshold, so at most this share of the flags may differ
RULE_STEPS, RULE_FLAG_SHARE = (0, 30, 60, 89), 1e-4
# backward kernels vs autograd of the plain versions, each gradient against its own largest
# magnitude M: float32 1e-4 M (summation order; dW and db sum over every source); bf16 against
# the float32 plain backward on the same bf16-valued inputs: 2^-8 of each value plus 1e-4 M
KNARPE_BWD_F32_REL = 1e-4
# training step, card vs CPU in float32 (phase 7): loss terms and grad_norm to 1e-4 relative,
# every parameter's gradient to 1e-3 of its scale: summation order in the kernels and cuBLAS
# through 30 BPTT steps of a damped closed loop. A gradient's scale is its largest magnitude, but
# at least 1e-3 of the largest over the model, so that one ~0 by cancellation (a bias before a
# LayerNorm) is not held to its rounding noise
TRAIN_LOSS_REL, TRAIN_GRAD_REL, TRAIN_GRAD_FLOOR = 1e-4, 1e-3, 1e-3


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 5) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def knn_case(gen, n_rows, n_src, n_tgt, grid=False, p_src=0.2, p_tgt=0.2):
    src = torch.rand(n_rows, n_src, 2, generator=gen) * 200 - 100
    tgt = torch.rand(n_rows, n_tgt, 2, generator=gen) * 200 - 100
    if grid:  # integer grid: exact squares and many distance ties
        src, tgt = (src / 10).round() * 10, (tgt / 10).round() * 10
    src_inv = torch.rand(n_rows, n_src, generator=gen) < p_src
    tgt_inv = torch.rand(n_rows, n_tgt, generator=gen) < p_tgt
    return [t.cuda().contiguous() for t in (src, src_inv, tgt, tgt_inv)]


def check_knn_kernel() -> dict:
    """Kernel B1 vs its plain version: identical indices, bit-equal distances."""
    gen = torch.Generator().manual_seed(0)
    cases = {
        "main_path_float": (knn_case(gen, KNN_ROWS, KNN_SRC, KNN_TGT), KNN_K),
        "integer_grid_ties": (knn_case(gen, KNN_ROWS, KNN_SRC, KNN_TGT, grid=True), KNN_K),
        "invalid_rows_and_targets": (knn_case(gen, 8, 64, 1024, grid=True, p_src=0.3, p_tgt=0.97), KNN_K),
        "k_equals_n_tgt": (knn_case(gen, 2, 8, 128), 128),
    }
    src_inv, tgt_inv = cases["invalid_rows_and_targets"][0][1::2]
    tgt_inv[0] = True  # a row with no valid target: every source emits its +inf tail
    src_inv[1, 5] = True  # an invalid source in another row
    max_err = 0.0
    for name, (args, k) in cases.items():
        d, i = knn.knn_xy(*args, k)
        torch.cuda.synchronize()
        d_ref, i_ref = knn.knn_xy_reference(*args, k)
        if not torch.equal(i, i_ref):
            raise AssertionError(f"knn_xy {name}: indices differ from the plain version")
        if not torch.equal(d, d_ref):
            raise AssertionError(f"knn_xy {name}: distances not bit-equal to the plain version")
        fin = torch.isfinite(d_ref)
        max_err = max(max_err, float((d[fin] - d_ref[fin]).abs().max()) if fin.any() else 0.0)
        log(f"  knn_xy {name}: shape {list(d.shape)} indices identical, distances bit-equal "
            f"(+inf entries {int((~fin).sum())})")

    args, k = cases["main_path_float"]
    ms = cuda_ms(lambda: knn.knn_xy(*args, k), 200)
    plain_ms = cuda_ms(lambda: knn.knn_xy_reference(*args, k), 20)
    src, src_inv, tgt, tgt_inv = args
    dist = torch.cdist(src, tgt)
    dist = torch.where(src_inv[:, :, None] | tgt_inv[:, None, :], float("inf"), dist)
    library_ms = cuda_ms(lambda: torch.topk(dist, k, dim=-1, largest=False), 100)  # timing yardstick only
    n_rows, n_src, n_tgt = src.shape[0], src.shape[1], tgt.shape[1]
    bytes_moved = (src.numel() * 4 + src_inv.numel() + tgt.numel() * 4 + tgt_inv.numel()
                   + n_rows * n_src * k * (4 + 4))
    ops = n_rows * n_src * n_tgt * 7  # 2 sub, 2 mul, add, sqrt, one compare per pair
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S * 1e3, ops / FP32_FLOPS * 1e3
    bound_ms = max(t_bytes, t_ops)
    log(f"  knn_xy timing at [{n_rows},{n_src},{n_tgt}] k={k}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"torch.topk on materialised distances {library_ms:.4f} ms, bound {bound_ms * 1e3:.2f} us "
        f"({bytes_moved / 1e6:.2f} MB), kernel at {100 * bound_ms / ms:.2f}% of the bound")
    return {"name": "knn_xy", "route": "cuda", "source": "trafficbotsv15_tpu_torch/csrc/knn.cu",
            "replaces": "trafficbotsv15_tpu/ops/pallas_knn.py:143", "launches": None, "max_abs_err": max_err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations", "library_ms": library_ms}


def knarpe_inputs(shape, cross: bool, seed: int, dtype=torch.float32):
    """Operands of B2/B3 (cross) or B4 from a numpy seed, on the card; one source
    has no valid target and one has a single valid target."""
    n_b, n_s, n_knn, d, r, _ = shape
    rng = np.random.default_rng(seed)

    def f(*size, scale=1.0):
        return torch.from_numpy((scale * rng.normal(size=size)).astype(np.float32)).to("cuda", dtype)

    inv = rng.uniform(size=(n_b, n_s, n_knn)) < 0.3
    inv[0, 0] = True
    inv[-1, -1, 1:] = True
    inv = torch.from_numpy(inv).cuda()
    w_rpe, b = f(r, 2 * d, scale=r ** -0.5), f(2 * d, scale=0.1)
    if cross:
        return [f(n_b, n_s, d), f(n_b, n_s, n_knn, d), f(n_b, n_s, n_knn, r), inv, f(d, 2 * d, scale=d ** -0.5),
                w_rpe, b]
    kv = f(n_b, n_s, n_knn, 2 * d)  # the map encoder hands B4 the halves of one gathered [.., 2D] tensor
    return [f(n_b, n_s, d), *kv.chunk(2, -1), f(n_b, n_s, n_knn, r), inv, w_rpe, b]


def knarpe_library_call(name: str, args, n_head: int):
    """The PyTorch composition that computes the same function (timing yardstick
    only, never called by the port): one matmul for the projections, then
    scaled_dot_product_attention with a boolean mask."""
    if name == "knarpe_attention":
        q, k, v, rpe, inv, w, b = args
        rk, rv = (rpe @ w + b).chunk(2, -1)
        k, v = k + rk, v + rv
    else:
        q, tgt, rpe, inv, w_kv, w_rpe, b = args
        k, v = (torch.matmul(torch.cat([tgt, rpe], -1), torch.cat([w_kv, w_rpe], 0)) + b).chunk(2, -1)
    n_b, n_s, n_knn, d = k.shape
    dh = d // n_head

    def heads(t):  # [b, s, K, D] -> [b*s, H, K, dh]
        return t.reshape(n_b * n_s, n_knn, n_head, dh).transpose(1, 2)

    out = torch.nn.functional.scaled_dot_product_attention(
        q.reshape(n_b * n_s, n_head, 1, dh), heads(k), heads(v), attn_mask=~inv.reshape(n_b * n_s, 1, 1, n_knn))
    return out.reshape(n_b, n_s, d)


def knarpe_bound(name: str, args, n_head: int) -> tuple:
    """(bytes, operations) the function needs: each operand read once, the output written once; the
    multiply-adds of the reassociated forward (csrc/knarpe.cu), per source with input width X (R for
    B4, D + R for B2/B3): u_h = W_k[:, h] q_h and out_h = y_h W_v[:, h], 2 X D; logits and
    y_h = sum_j attn_hj x_j, 2 K X H; for B4 q.k and attn.v, 2 K D. B3 forms k for its roundings
    (K X D in place of the logits' K X H, plus q.k, K D). The softmax's K H terms are left out."""
    q = args[0]
    n_b, n_s, d = q.shape
    rpe = args[3] if name == "knarpe_attention" else args[2]
    n_knn, r = rpe.shape[2], rpe.shape[3]
    n_src = n_b * n_s
    nbytes = sum(a.numel() * a.element_size() for a in args) + q.numel() * q.element_size()
    x = r if name == "knarpe_attention" else d + r
    macs = 2 * x * d + 2 * n_knn * x * n_head
    if name == "knarpe_attention":
        macs += 2 * n_knn * d
    elif name == "knarpe_cross_attention_v3":
        macs += n_knn * x * d - n_knn * x * n_head + n_knn * d
    return nbytes, 2 * n_src * macs


def check_one_knarpe(name: str, shape, seed: int) -> float:
    """Kernel vs plain version in float32 and bfloat16; returns the float32 max |err|."""
    kernel, plain = getattr(knarpe, name), getattr(knarpe, f"{name}_reference")
    cross, n_head = name != "knarpe_attention", shape[-1]
    args = knarpe_inputs(shape, cross, seed)
    out = kernel(*args, n_head)
    torch.cuda.synchronize()
    ref = plain(*args, n_head)
    err = float((out - ref).abs().max())
    if not (torch.isfinite(out).all() and err <= KNARPE_F32_ATOL and torch.all(out[0, 0] == 0)):
        raise AssertionError(f"{name} {shape} float32: max |err| {err} (tolerance {KNARPE_F32_ATOL}), "
                             f"all-invalid source zero: {bool(torch.all(out[0, 0] == 0))}")
    a16 = [a if a.dtype == torch.bool else a.to(torch.bfloat16) for a in args]
    out16 = kernel(*a16, n_head).float()
    torch.cuda.synchronize()
    ref32 = plain(*[a if a.dtype == torch.bool else a.float() for a in a16], n_head)
    note = ""
    if name.endswith("_v3"):  # B3's roundings are in its plain version, in bf16
        ref16 = plain(*a16, n_head).float()
        rtol, atol = BF16_ULP, 2.0 ** -8 * float(ref16.abs().max())
        mean_err, mean_unrounded = float((out16 - ref16).abs().mean()), float((ref32 - ref16).abs().mean())
        if not mean_err <= 0.25 * mean_unrounded:
            raise AssertionError(f"{name} {shape} bf16: mean |err| {mean_err} vs {mean_unrounded} without roundings")
        note = f"; mean |err| {mean_err:.2e} against {mean_unrounded:.2e} without its roundings"
    else:
        ref16, rtol, atol = ref32, BF16_HALF_ULP, KNARPE_F32_ATOL
    excess = float(((out16 - ref16).abs() - (rtol * ref16.abs() + atol)).max())
    if not (torch.isfinite(out16).all() and excess <= 0 and torch.all(out16[0, 0] == 0)):
        raise AssertionError(f"{name} {shape} bf16: |err| exceeds {rtol} relative + {atol} by {excess}")
    log(f"  {name} {list(shape)} (n_b, n_s, K, D, R, H): float32 max |err| {err:.3e} (tolerance "
        f"{KNARPE_F32_ATOL}); bf16 within {rtol:g} relative + {atol:.3g} absolute{note}; all-invalid source zero")
    return err


def check_knarpe_kernels() -> list:
    """Kernels B4, B2, B3 vs their plain versions at the path's and edge shapes; times at the path's shapes (bf16)."""
    rows = []
    for name, path, edges, replaces in (
            ("knarpe_attention", ATTN_PATH, ATTN_EDGE, "trafficbotsv15_tpu/ops/pallas_knarpe.py:243"),
            ("knarpe_cross_attention", X_PATH, X_EDGE, "trafficbotsv15_tpu/ops/pallas_knarpe.py:443"),
            ("knarpe_cross_attention_v3", X_PATH, X_EDGE, "trafficbotsv15_tpu/ops/pallas_knarpe.py:742")):
        max_err = check_one_knarpe(name, path, seed=1)
        for i, shape in enumerate(edges):
            check_one_knarpe(name, shape, seed=2 + i)
        kernel, plain = getattr(knarpe, name), getattr(knarpe, f"{name}_reference")
        n_head = path[-1]
        args = knarpe_inputs(path, name != "knarpe_attention", seed=1, dtype=torch.bfloat16)
        ms = cuda_ms(lambda: kernel(*args, n_head), 50)
        plain_ms = cuda_ms(lambda: plain(*args, n_head), 10)
        library_ms = cuda_ms(lambda: knarpe_library_call(name, args, n_head), 20)
        nbytes, ops = knarpe_bound(name, args, n_head)
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / BF16_FLOPS * 1e3
        bound_ms = max(t_bytes, t_ops)
        log(f"  {name} timing at {list(path)} bf16: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"matmul + scaled_dot_product_attention {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
            f"({nbytes / 1e6:.1f} MB, {ops / 1e9:.3f} GFLOP), kernel at {100 * bound_ms / ms:.2f}% of the bound")
        rows.append({"name": name, "route": "cuda", "source": "trafficbotsv15_tpu_torch/csrc/knarpe.cu",
                     "replaces": replaces, "launches": None, "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                     "library_ms": library_ms})
    return rows


def knarpe_bwd_bound(name: str, args, g, n_head: int) -> tuple:
    """(bytes, operations) of a backward: operands and g read once, every gradient written once; the
    multiply-adds of the reassociated backward (csrc/knarpe_bwd.cu), per source with input width X:
    u_h, w_h = W_v[:, h] g_h, dq's z_h W_k[:, h] and the rank-1 weight-gradient terms, 5 X D; the
    logits, dattn, dx (two terms), y_h and z_h, 6 K X H; for B4 the k and v terms of the logits, dattn
    and dq, and dk and dv, 5 K D. The softmax's K H terms are left out."""
    q = args[0]
    n_b, n_s, d = q.shape
    rpe = args[3] if name == "knarpe_attention" else args[2]
    n_knn, r = rpe.shape[2], rpe.shape[3]
    n_src = n_b * n_s
    floats = [a for a in args if a.is_floating_point()]
    nbytes = 2 * sum(a.numel() * a.element_size() for a in floats) + g.numel() * g.element_size()
    nbytes += sum(a.numel() * a.element_size() for a in args if not a.is_floating_point())
    x = r if name == "knarpe_attention" else d + r
    macs = 5 * x * d + 6 * n_knn * x * n_head + (5 * n_knn * d if name == "knarpe_attention" else 0)
    return nbytes, 2 * n_src * macs


def _plain_bwd(name: str, args, g, n_head: int):
    if name == "knarpe_attention":
        return list(knarpe.knarpe_attention_bwd_reference(*args, g, n_head))
    return list(knarpe.knarpe_cross_attention_bwd_reference(*args, g, n_head))


def _kernel_bwd(name: str, args, g, n_head: int):
    """Gradients through the wrapper's autograd Function on the card (one backward launch)."""
    leaves = [a.clone().requires_grad_(a.is_floating_point()) for a in args]
    out = getattr(knarpe, name)(*leaves, n_head)
    if not (out.requires_grad and out.grad_fn is not None):
        raise AssertionError(f"{name}: the card's output carries no grad_fn")
    bwd = "knarpe_attention_bwd" if name == "knarpe_attention" else "knarpe_cross_attention_bwd"
    before = knarpe.LAUNCHES[bwd]
    out.backward(g)
    torch.cuda.synchronize()
    if knarpe.LAUNCHES[bwd] != before + 1:
        raise AssertionError(f"{name}: backward launched {knarpe.LAUNCHES[bwd] - before} kernels, expected 1")
    return [a.grad for a in leaves if a.requires_grad]


def check_one_knarpe_bwd(name: str, shape, seed: int) -> float:
    """Backward kernel vs autograd of the plain version, float32 and bf16; returns the float32 max |err|."""
    n_head = shape[-1]
    args = knarpe_inputs(shape, name != "knarpe_attention", seed)
    g = torch.from_numpy(np.random.default_rng(seed + 100).normal(size=args[0].shape).astype(np.float32)).cuda()
    got, want = _kernel_bwd(name, args, g, n_head), _plain_bwd(name, args, g, n_head)
    max_err, worst = 0.0, 0.0
    for a, b in zip(got, want):
        err, scale = float((a - b).abs().max()), float(b.abs().max())
        max_err, worst = max(max_err, err), max(worst, err / max(scale, 1e-30))
    if not worst <= KNARPE_BWD_F32_REL or not (torch.all(got[0][0, 0] == 0) and torch.all(got[1][0, 0] == 0)):
        raise AssertionError(f"{name} backward {shape} float32: max |err| / max |grad| {worst} "
                             f"(tolerance {KNARPE_BWD_F32_REL}), all-invalid source zero: {bool(torch.all(got[0][0, 0] == 0))}")
    a16 = [a if a.dtype == torch.bool else a.to(torch.bfloat16) for a in args]
    got16 = _kernel_bwd(name, a16, g.to(torch.bfloat16), n_head)
    want32 = _plain_bwd(name, [a if a.dtype == torch.bool else a.float() for a in a16], g.bfloat16().float(), n_head)
    for a, b in zip(got16, want32):
        tol = BF16_HALF_ULP * b.abs() + KNARPE_BWD_F32_REL * float(b.abs().max())
        if not (a.dtype == torch.bfloat16 and bool(((a.float() - b).abs() <= tol).all())):
            raise AssertionError(f"{name} backward {shape} bf16: |err| above 2^-8 relative + 1e-4 of the max")
    log(f"  {name} backward {list(shape)}: output has a grad_fn; float32 max |err| {max_err:.3e}, "
        f"{worst:.2e} of the largest gradient (tolerance {KNARPE_BWD_F32_REL:g}); bf16 within 2^-8 relative + "
        f"1e-4 of the largest; all-invalid source zero")
    return max_err


def check_knarpe_bwd_kernels() -> list:
    """B4-bwd, B2-bwd and B3's backward (B2-bwd through B3's Function) vs autograd of the plain
    versions at the training path's and edge shapes; B4-bwd and B2-bwd timed at the training
    path's shapes (bf16)."""
    rows = []
    for name, path, edges, replaces in (
            ("knarpe_attention", TRAIN_ATTN_PATH, ATTN_EDGE, "trafficbotsv15_tpu/ops/pallas_knarpe.py:293"),
            ("knarpe_cross_attention", TRAIN_X_PATH, X_EDGE, "trafficbotsv15_tpu/ops/pallas_knarpe.py:579")):
        max_err = check_one_knarpe_bwd(name, path, seed=11)
        for i, shape in enumerate(edges):
            check_one_knarpe_bwd(name, shape, seed=12 + i)
        if name == "knarpe_cross_attention":
            check_one_knarpe_bwd("knarpe_cross_attention_v3", path, seed=15)
            check_one_knarpe_bwd("knarpe_cross_attention_v3", X_EDGE[1], seed=16)
        n_head = path[-1]
        args = knarpe_inputs(path, name != "knarpe_attention", seed=11, dtype=torch.bfloat16)
        g = torch.randn(args[0].shape, generator=torch.Generator().manual_seed(3)).to("cuda", torch.bfloat16)
        if name == "knarpe_attention":
            q, k, v, rpe, inv, w, b = args
            kernel = lambda: knarpe._launch_bwd(name, q, k, v, None, rpe, inv, None, w, b, g, n_head)
        else:
            q, tgt, rpe, inv, w_kv, w_rpe, b = args
            kernel = lambda: knarpe._launch_bwd(name, q, None, None, tgt, rpe, inv, w_kv, w_rpe, b, g, n_head)
        ms = cuda_ms(kernel, 20)
        plain_ms = cuda_ms(lambda: _plain_bwd(name, args, g, n_head), 5)
        leaves = [a.clone().requires_grad_(a.is_floating_point()) for a in args]
        lib_out = knarpe_library_call(name, leaves, n_head)
        want = [a for a in leaves if a.requires_grad]
        library_ms = cuda_ms(lambda: torch.autograd.grad(lib_out, want, g, retain_graph=True), 10)
        nbytes, ops = knarpe_bwd_bound(name, args, g, n_head)
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / BF16_FLOPS * 1e3
        bound_ms = max(t_bytes, t_ops)
        log(f"  {name} backward timing at the training path's {list(path)} bf16: kernel {ms:.4f} ms, plain (autograd through the plain "
            f"forward) {plain_ms:.4f} ms, backward of matmul + scaled_dot_product_attention {library_ms:.4f} ms, "
            f"bound {bound_ms:.4f} ms ({nbytes / 1e6:.1f} MB, {ops / 1e9:.3f} GFLOP), kernel at "
            f"{100 * bound_ms / ms:.2f}% of the bound")
        rows.append({"name": f"{name}_bwd", "route": "cuda", "source": "trafficbotsv15_tpu_torch/csrc/knarpe_bwd.cu",
                     "replaces": replaces, "launches": None, "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                     "library_ms": library_ms})
    return rows


def reset_launches() -> None:
    knn.LAUNCHES = 0
    for name in knarpe.LAUNCHES:
        knarpe.LAUNCHES[name] = 0


def launches() -> dict:
    return {"knn_xy": knn.LAUNCHES, **knarpe.LAUNCHES}


def expected_launches(cfg, n_step: int) -> dict:
    """Kernel launches per joint_future_pred call that the config implies."""
    pallas = cfg.model.tf_cfg.use_pallas
    return {"knn_xy": n_step,
            "knarpe_attention": cfg.model.mp_encoder.n_layer_tf if pallas else 0,
            "knarpe_cross_attention": cfg.model.ag_encoder.n_layer_tf * n_step if pallas else 0,
            "knarpe_cross_attention_v3": 0, "knarpe_attention_bwd": 0, "knarpe_cross_attention_bwd": 0}


def expected_train_launches(cfg) -> dict:
    """Kernel launches per training step that the config implies: the rollout's per-step
    recompute runs the step's forward kernels (the agent->map KNN, the agent decoder's B2) a
    second time in the backward pass; the posterior encoders add one KNN and one B2 per TL and
    agent layer; each forward outside a recompute has one backward."""
    m, n = cfg.model, cfg.time_step_end
    pallas = m.tf_cfg.use_pallas
    post = m.tl_encoder.n_layer_tf + m.ag_encoder.n_layer_tf
    return {"knn_xy": 2 * n + 1,
            "knarpe_attention": m.mp_encoder.n_layer_tf if pallas else 0,
            "knarpe_cross_attention": 2 * m.ag_encoder.n_layer_tf * n + post if pallas else 0,
            "knarpe_cross_attention_v3": 0,
            "knarpe_attention_bwd": m.mp_encoder.n_layer_tf if pallas else 0,
            "knarpe_cross_attention_bwd": m.ag_encoder.n_layer_tf * n + post if pallas else 0}


def damp_weights(model: torch.nn.Module, gain: float) -> None:
    """Scale every weight matrix: a random policy at full gain is chaotic in closed
    loop, so card-vs-CPU rounding differences would grow instead of showing parity."""
    with torch.no_grad():
        for p in model.parameters():
            if p.dim() == 2:
                p.mul_(gain)


def check_slice_card_vs_cpu(use_pallas: bool) -> None:
    base = tiny_config(n_ag=16, n_mp=512, n_tl=16, n_step=31, hidden_dim=64)
    cfg = with_pallas(dataclasses.replace(base, joint_future_pred_deterministic_k0=True), use_pallas)
    batch = make_batch(cfg.data, n_sc=1, seed=3)
    bufs = {}
    for device in ("cpu", "cuda"):
        model = build_model(cfg, seed=1, device=device)
        damp_weights(model, 0.5)
        reset_launches()
        _, buf = joint_future_pred(cfg, model, batch, generator=torch.Generator().manual_seed(0),
                                   n_joint_future=2, device=device, check_level=1)
        if device == "cuda":
            torch.cuda.synchronize()
            want = expected_launches(cfg, cfg.time_step_end)
            if launches() != want:
                raise AssertionError(f"slice check: kernel launches {launches()}, expected {want}")
        bufs[device] = buf
    cpu, gpu = bufs["cpu"], bufs["cuda"]
    pose_err = float((gpu.pred_pose[:, 0].cpu() - cpu.pred_pose[:, 0]).abs().max())
    if not torch.equal(gpu.pred_valid[:, 0].cpu(), cpu.pred_valid[:, 0]) or not pose_err <= SLICE_POSE_ATOL:
        raise AssertionError(f"slice check: K0 futures differ card vs CPU (max pose err {pose_err})")
    differ = [k for k in cpu.violation if not torch.equal(gpu.violation[k][:, 0].cpu(), cpu.violation[k][:, 0])]
    if differ:
        raise AssertionError(f"slice check: K0 rule flags differ card vs CPU: {differ}")
    fired = sorted(k for k, v in cpu.violation.items() if not k.endswith("_this_step") and bool(v[:, 0].any()))
    log(f"  use_pallas={use_pallas}: card vs CPU, K0 futures of {list(gpu.pred_pose.shape)}: pred_valid equal, "
        f"max |pose err| {pose_err:.3e} m (tolerance {SLICE_POSE_ATOL}); rule flags equal (fired: {fired}); "
        f"kernel launches {expected_launches(cfg, cfg.time_step_end)} as the config implies")


def to_cpu(obj):
    """A rule checker's statics or state (dataclass of tensors and Nones) on the CPU."""
    return dataclasses.replace(obj, **{f.name: getattr(obj, f.name).cpu() for f in dataclasses.fields(obj)
                                       if isinstance(getattr(obj, f.name), torch.Tensor)})


def replay_rule_checks_on_cpu(cfg, model, batch, gen) -> None:
    """One more full-width call, recording the rule checker's inputs and flags at
    RULE_STEPS; the CPU recomputes the flags from the same inputs."""
    real, recorded, step = rollout_lib.check_rules, [], [0]

    def recorder(statics, state, *inputs):
        new_state, viol = real(statics, state, *inputs)
        if step[0] in RULE_STEPS:
            recorded.append((statics, state, inputs, viol))
        step[0] += 1
        return new_state, viol

    rollout_lib.check_rules = recorder
    try:
        joint_future_pred(cfg, model, batch, generator=gen, check_level=1)
    finally:
        rollout_lib.check_rules = real
    n_diff = n_flags = 0
    fired = set()
    for statics, state, inputs, viol in recorded:
        _, ref = real(to_cpu(statics), to_cpu(state), *(x.cpu() if isinstance(x, torch.Tensor) else x
                                                         for x in inputs))
        for key, val in ref.items():
            n_diff += int((viol[key].cpu() != val).sum())
            n_flags += val.numel()
            if key.endswith("_this_step") and bool(val.any()):
                fired.add(key.removesuffix("_this_step"))
    if len(recorded) != len(RULE_STEPS) or n_diff > RULE_FLAG_SHARE * n_flags:
        raise AssertionError(f"rule checks card vs CPU: {n_diff} of {n_flags} flags differ at {len(recorded)} steps")
    log(f"  rule checks of steps {list(RULE_STEPS)} replayed on the CPU from the card's inputs: {n_diff} of "
        f"{n_flags} flags differ (tolerance {RULE_FLAG_SHARE:g} of them); fired: {sorted(fired)}")


def run_full_width(card: str, use_pallas: bool, n_timed: int = 3, replay_rules: bool = False) -> dict:
    cfg = with_pallas(leaderboard_config(), use_pallas)
    n_sc, k = 4, cfg.n_joint_future_wosac
    batch = make_batch(cfg.data, n_sc=n_sc, seed=0)
    model = build_model(cfg, seed=0, device="cuda")
    gen = torch.Generator().manual_seed(0)
    n_params = sum(p.numel() for p in model.parameters())
    t0 = time.perf_counter()
    joint_future_pred(cfg, model, batch, generator=gen, check_level=1)
    torch.cuda.synchronize()
    log(f"  warm-up call {time.perf_counter() - t0:.3f} s ({n_params} parameters, bf16 compute)")
    torch.cuda.reset_peak_memory_stats()
    times, per_call = [], []
    for _ in range(n_timed):
        reset_launches()
        t0 = time.perf_counter()
        _, buf = joint_future_pred(cfg, model, batch, generator=gen, check_level=1)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        per_call.append(launches())
    n_ag, n_step, n_tl = cfg.data.n_ag, cfg.time_step_end, cfg.data.n_tl_lane
    shapes = {"pred_pose": (n_sc, k, n_ag, n_step, 3), "pred_valid": (n_sc, k, n_ag, n_step),
              "pred_action": (n_sc, k, n_ag, n_step, 2), "tl_state": (n_sc, k, n_tl, n_step, 5),
              "log_prob": (n_sc, k, n_ag)}
    for name, shape in shapes.items():
        got = tuple(getattr(buf, name).shape)
        if got != shape:
            raise AssertionError(f"full width: {name} is {got}, expected {shape}")
    if not (torch.isfinite(buf.pred_pose).all() and torch.isfinite(buf.log_prob).all()):
        raise AssertionError("full width: non-finite poses or scores")
    want = expected_launches(cfg, n_step)
    if any(c != want for c in per_call):
        raise AssertionError(f"full width: kernel launches per call {per_call}, expected {want}")
    sec = float(np.median(times))
    agent_steps = n_sc * k * n_ag * (cfg.time_step_end - cfg.time_step_current)
    flags = {key: int(v.sum()) for key, v in buf.violation.items() if not key.endswith("_this_step")}
    log(f"  leaderboard_config use_pallas={use_pallas} check_level=1 joint_future_pred: {n_sc} scenarios x K={k}, "
        f"{n_ag} agents, {cfg.data.n_mp} polylines, {n_step} steps: seconds per call {[round(t, 4) for t in times]} "
        f"(median {sec:.4f} s), peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
        f"{agent_steps / sec:.1f} agent-steps/s, kernel launches per call {per_call[-1]}, "
        f"agent-steps flagged {flags} [{card}]")
    if replay_rules:
        replay_rule_checks_on_cpu(cfg, model, batch, gen)
    return per_call[-1]


def no_dropout(cfg):
    """cfg with every dropout rate at 0: CPU and CUDA generators draw different masks from one seed."""
    m = cfg.model
    return dataclasses.replace(cfg, model=dataclasses.replace(
        m, tf_cfg=dataclasses.replace(m.tf_cfg, dropout_p=0.0),
        mp_encoder=dataclasses.replace(m.mp_encoder, pl_encoder=dataclasses.replace(m.mp_encoder.pl_encoder,
                                                                                      mlp_dropout_p=0.0)),
        add_navi_latent=dataclasses.replace(m.add_navi_latent, mlp_dropout_p=0.0)))


def check_train_step_card_vs_cpu(use_pallas: bool) -> None:
    """One make_train_step on the card and on the CPU: same weights, same draws, no dropout."""
    cfg = with_pallas(no_dropout(tiny_config(n_ag=16, n_mp=512, n_tl=16, n_step=31, hidden_dim=64)), use_pallas)
    batch = make_batch(cfg.data, n_sc=2, seed=3)
    noise = train_lib.draw_training_noise(cfg, batch, torch.Generator().manual_seed(0), "cpu")
    runs = {}
    for device in ("cpu", "cuda"):
        model = build_model(cfg, seed=1, device=device)
        damp_weights(model, 0.5)
        step = train_lib.make_train_step(cfg, model, *make_optimizer(cfg.optimizer, model), device=device)
        dev_noise = {k: v.to(device) if isinstance(v, torch.Tensor) else v for k, v in noise.items()}
        reset_launches()
        metrics = step(batch, noise=dev_noise)
        if device == "cuda":
            torch.cuda.synchronize()
            want = expected_train_launches(cfg)
            if launches() != want:
                raise AssertionError(f"train step check: kernel launches {launches()}, expected {want}")
        # the gradients the optimizer applied (clipped where grad_norm exceeds the clip norm)
        runs[device] = ({k: float(v) for k, v in metrics.items()},
                        {n: p.grad.float().cpu() for n, p in model.named_parameters()})
    (m_cpu, g_cpu), (m_gpu, g_gpu) = runs["cpu"], runs["cuda"]
    loss_err = max(abs(m_gpu[k] - v) / max(abs(v), 1.0) for k, v in m_cpu.items())
    floor = TRAIN_GRAD_FLOOR * max(float(g.abs().max()) for g in g_cpu.values())
    worst, worst_name, n_floored = 0.0, "", 0
    for name, g in g_cpu.items():
        own = float(g.abs().max())
        n_floored += own < floor
        rel = float((g_gpu[name] - g).abs().max()) / max(own, floor)
        if rel > worst:
            worst, worst_name = rel, name
    if not (loss_err <= TRAIN_LOSS_REL and worst <= TRAIN_GRAD_REL and set(g_cpu) == set(g_gpu)):
        raise AssertionError(f"train step check use_pallas={use_pallas}: loss terms / grad_norm off by {loss_err} "
                             f"(tolerance {TRAIN_LOSS_REL}), gradient of {worst_name} off by {worst} of its scale "
                             f"(tolerance {TRAIN_GRAD_REL})")
    norm_tgt = [n for n in g_cpu if n.endswith("norm_tgt_scale") and float(g_cpu[n].abs().max()) > 0]
    log(f"  use_pallas={use_pallas}: card vs CPU, loss {m_gpu['training/loss']:.6f} vs {m_cpu['training/loss']:.6f}, "
        f"grad_norm {m_gpu['grad_norm']:.6f} vs {m_cpu['grad_norm']:.6f}, loss terms and grad_norm within "
        f"{loss_err:.2e} relative (tolerance {TRAIN_LOSS_REL:g}); {len(g_cpu)} parameter gradients within "
        f"{worst:.2e} of their scale (worst {worst_name}; tolerance {TRAIN_GRAD_REL:g}; scale floored at "
        f"{TRAIN_GRAD_FLOOR:g} of the model's largest, {floor:.3e}, for {n_floored} of them); {len(norm_tgt)} "
        f"folded norm_tgt_scale gradients non-zero; launches {expected_train_launches(cfg)} as the config implies")


def run_train_full_width(card: str, n_timed: int = 3) -> dict:
    """leaderboard_config() training with use_pallas=True, 8 scenarios per step, bf16 compute."""
    cfg = with_pallas(leaderboard_config(), True)
    n_sc = 8
    model = build_model(cfg, seed=0, device="cuda")
    step = train_lib.make_train_step(cfg, model, *make_optimizer(cfg.optimizer, model))
    batch = train_lib.batch_to_device(make_batch(cfg.data, n_sc=n_sc, seed=0), torch.device("cuda"))
    gen = torch.Generator().manual_seed(0)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    t0 = time.perf_counter()
    step(batch, gen)
    torch.cuda.synchronize()
    log(f"  warm-up step {time.perf_counter() - t0:.3f} s")
    torch.cuda.reset_peak_memory_stats()
    times, per_step, metrics = [], [], []
    for _ in range(n_timed):
        reset_launches()
        t0 = time.perf_counter()
        m = step(batch, gen)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        per_step.append(launches())
        metrics.append({k: float(v) for k, v in m.items()})
    want = expected_train_launches(cfg)
    if any(c != want for c in per_step):
        raise AssertionError(f"training at full width: kernel launches per step {per_step}, expected {want}")
    for m in metrics:
        if not (math.isfinite(m["training/loss"]) and m["training/loss"] != 0 and math.isfinite(m["grad_norm"])
                and m["grad_norm"] > 0):
            raise AssertionError(f"training at full width: loss {m['training/loss']}, grad_norm {m['grad_norm']}")
    changed = sum(not torch.equal(p, before[n]) for n, p in model.named_parameters())
    if changed < 0.95 * len(before):
        raise AssertionError(f"training at full width: only {changed} of {len(before)} parameters changed")
    sec = float(np.median(times))
    log(f"  leaderboard_config use_pallas=True training: {n_sc} scenarios per step, {cfg.data.n_ag} agents, "
        f"{cfg.data.n_mp} polylines, {cfg.time_step_end} steps: seconds per step {[round(t, 4) for t in times]} "
        f"(median {sec:.4f} s), {n_sc / sec:.3f} train samples/s, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, losses {[round(m['training/loss'], 4) for m in metrics]}, "
        f"grad_norm {[round(m['grad_norm'], 4) for m in metrics]}, {changed} of {len(before)} parameters changed, "
        f"kernel launches per step {per_step[-1]} [{card}]")
    return per_step[-1]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; the port's main path needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    card = card_line()
    log(f"[1/8] device: {torch.cuda.get_device_name(0)}; nvidia-smi: {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"  torch {torch.__version__} cuda {torch.version.cuda}; allow_tf32 matmul="
        f"{torch.backends.cuda.matmul.allow_tf32} cudnn={torch.backends.cudnn.allow_tf32}")

    t0 = time.perf_counter()
    with ThreadPoolExecutor(3) as pool:  # one nvcc per source, all at once
        for fut in [pool.submit(knn.load_library), pool.submit(knarpe.load_library),
                    pool.submit(knarpe.load_bwd_library)]:
            fut.result()
    log(f"[2/8] build: csrc/knn.cu, csrc/knarpe.cu and csrc/knarpe_bwd.cu in {time.perf_counter() - t0:.2f} s")

    log("[3/8] kernels vs plain versions")
    rows = [check_knn_kernel(), *check_knarpe_kernels()]
    bwd_rows = check_knarpe_bwd_kernels()

    log("[4/8] slice checked: reduced-depth fp32 config, 512 polylines, card vs CPU")
    check_slice_card_vs_cpu(use_pallas=False)
    check_slice_card_vs_cpu(use_pallas=True)

    log("[5/8] slice at full width, use_pallas=False")
    run_full_width(card, use_pallas=False)

    log("[6/8] slice at full width, use_pallas=True (the KNARPE attention kernels)")
    counts = run_full_width(card, use_pallas=True, replay_rules=True)

    log("[7/8] train step checked: reduced-depth fp32 config, 512 polylines, card vs CPU")
    check_train_step_card_vs_cpu(use_pallas=False)
    check_train_step_card_vs_cpu(use_pallas=True)

    log("[8/8] training at full width, use_pallas=True (the KNARPE kernels and their backwards)")
    train_counts = run_train_full_width(card)
    for row in rows:
        row["launches"] = counts[row["name"]]
    for row in bwd_rows:
        row["launches"] = train_counts[row["name"]]
    rows += bwd_rows
    for row in rows:
        for key, val in row.items():
            if isinstance(val, float) and not math.isfinite(val):
                raise AssertionError(f"kernels line: {row['name']} {key} is not finite")

    log(f"chip_smoke: all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
