"""Fused KNARPE attention: the hand-written CUDA kernels, their plain versions and wrappers.

Replaces the forward kernels of `trafficbotsv15_tpu/ops/pallas_knarpe.py`:
  - `knarpe_attention` (B4, `_fwd_kernel`): KNN attention over gathered,
    already projected k/v with the RPE projection fused,
        rpe_kv = rpe @ w_rpe + b_rpe
        logits = q . (k + rpe_k) / sqrt(d_head)  per head, masked softmax over K
        out    = sum attn * (v + rpe_v);
  - `knarpe_cross_attention` (B2, `_x_fwd_kernel`): cross-attention over raw
    (standardized) targets with both projections fused,
        kv = tgt @ w_kv + rpe @ w_rpe + b, then B4's attention core;
  - `knarpe_cross_attention_v3` (B3, `_x3_fwd_kernel`): B2's contract with the
    k half rounded to the operand type before the q.k product, and that
    product rounded too; attn and the v half stay in float32.
A source whose targets are all invalid gets a zero output. Layouts are the
JAX package's: q [B,S,D], k/v/tgt [B,S,K,D], rpe [B,S,K,R], invalid [B,S,K]
bool (True = invalid), w_rpe [R,2D], w_kv [D,2D], b [2D]; out [B,S,D] in q's
dtype. Every operand has one dtype, float32 or bfloat16.

What bounds them on the card is the bytes: at the rollout's shapes B2 reads
~373 MB of targets and relative poses per launch and writes 2 MB, and the
[K, 2D] projection output, which an unfused path writes and reads back, is
what the kernels keep out of device memory (`csrc/knarpe.cu` says how).

Each wrapper takes the plain version for tensors on the CPU and launches its
kernel for CUDA tensors, or raises; it never falls back. `LAUNCHES` counts
kernel launches per kernel (never plain-version calls).
"""

from __future__ import annotations

import ctypes
import math

import torch

from trafficbotsv15_tpu_torch.ops.attention import _masked_softmax, knn_attention
from trafficbotsv15_tpu_torch.utils import build

# kernel launches since the last reset, one plain int per kernel (read by chip_smoke.py)
LAUNCHES = {"knarpe_attention": 0, "knarpe_cross_attention": 0, "knarpe_cross_attention_v3": 0}

_MODES = {"knarpe_attention": 0, "knarpe_cross_attention": 1, "knarpe_cross_attention_v3": 2}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_LAUNCH_FN = None  # the bound C entry point, set once by load_library


# -- plain versions ----------------------------------------------------------
def knarpe_attention_reference(q, k, v, rpe, invalid, w_rpe, b_rpe, n_head: int) -> torch.Tensor:
    """Plain B4 (`pallas_knarpe.py::_reference`): the RPE projection, then
    `knn_attention` with rpe_k/rpe_v, in the operands' dtype. -> [B, S, D]."""
    n_b, n_s, n_knn, d_model = k.shape
    d_head = d_model // n_head
    rpe_kv = rpe @ w_rpe + b_rpe
    rpe_k, rpe_v = (t.reshape(n_b, n_s, n_knn, n_head, d_head) for t in rpe_kv.chunk(2, -1))
    return knn_attention(q.reshape(n_b, n_s, n_head, d_head), k.reshape(n_b, n_s, n_knn, n_head, d_head),
                         v.reshape(n_b, n_s, n_knn, n_head, d_head), invalid, rpe_k, rpe_v)


def knarpe_cross_attention_reference(q, tgt, rpe, invalid, w_kv, w_rpe, b, n_head: int) -> torch.Tensor:
    """Plain B2 (`pallas_knarpe.py::knarpe_cross_attention_reference`): one
    projection of targets and relative poses, then `knn_attention`. -> [B, S, D]."""
    n_b, n_s, n_knn, d_model = tgt.shape
    d_head = d_model // n_head
    kv = tgt.reshape(-1, d_model) @ w_kv + rpe.reshape(-1, rpe.shape[-1]) @ w_rpe + b
    k, v = (t.reshape(n_b, n_s, n_knn, n_head, d_head) for t in kv.reshape(n_b, n_s, n_knn, 2 * d_model).chunk(2, -1))
    return knn_attention(q.reshape(n_b, n_s, n_head, d_head), k, v, invalid)


def knarpe_cross_attention_v3_reference(q, tgt, rpe, invalid, w_kv, w_rpe, b, n_head: int) -> torch.Tensor:
    """Plain B3, with `_x3_fwd_kernel`'s roundings (`pallas_knarpe.py:668-720`):
    products of operand-typed values summed in float32; the k half rounded to
    the operand type, q * k rounded to it too; softmax, attn and the v half in
    float32; the output cast to q's dtype. -> [B, S, D]."""
    n_b, n_s, n_knn, d_model = tgt.shape
    d_head = d_model // n_head
    cdt = tgt.dtype
    x_t, x_r = tgt.float(), rpe.float()
    w_kv, w_rpe, b = w_kv.float(), w_rpe.float(), b.float()
    kk = (x_t @ w_kv[:, :d_model] + x_r @ w_rpe[:, :d_model] + b[:d_model]).to(cdt)
    prod = q[:, :, None, :] * kk  # [b, s, K, D] in the operand type
    logits = prod.float().reshape(n_b, n_s, n_knn, n_head, d_head).sum(-1).transpose(2, 3)
    logits = logits * (1.0 / (d_model // n_head) ** 0.5)  # [b, s, h, K]
    attn, no_valid = _masked_softmax(logits, invalid[:, :, None, :])
    vv = x_t @ w_kv[:, d_model:] + x_r @ w_rpe[:, d_model:] + b[d_model:]
    out = torch.einsum("bshk,bskhd->bshd", attn, vv.reshape(n_b, n_s, n_knn, n_head, d_head))
    out = torch.where(no_valid[..., None], 0.0, out)
    return out.reshape(n_b, n_s, d_model).to(q.dtype)


# -- kernels -----------------------------------------------------------------
def load_library():
    """Build csrc/knarpe.cu and bind its C entry point, once per process."""
    global _LAUNCH_FN
    if _LAUNCH_FN is None:
        fn = build.load("knarpe", "knarpe.cu").knarpe_launch
        fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 3 + [ctypes.c_longlong]
                       + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _LAUNCH_FN = fn
    return _LAUNCH_FN


def _check(kernel: str, name: str, t: torch.Tensor, shape, dtype, device) -> None:
    if t.device != device:
        raise ValueError(f"{kernel}: {name} is on {t.device}, expected {device}")
    if tuple(t.shape) != tuple(shape) or t.dtype != dtype:
        raise ValueError(f"{kernel}: {name} is {tuple(t.shape)} {t.dtype}, expected {tuple(shape)} {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{kernel}: {name} must be contiguous")


def _row_stride(kernel: str, name: str, t: torch.Tensor, shape, dtype, device) -> int:
    """Rows of t ([B, S, K, D], last dim contiguous) sit at one stride: the halves of a split [.., 2D] qualify."""
    if t.device != device or tuple(t.shape) != tuple(shape) or t.dtype != dtype:
        raise ValueError(f"{kernel}: {name} is {tuple(t.shape)} {t.dtype} on {t.device}, "
                         f"expected {tuple(shape)} {dtype} on {device}")
    ld = t.stride(2)
    n_b, n_s, n_knn, _ = shape
    if t.stride(3) != 1 or t.stride(1) != n_knn * ld or (n_b > 1 and t.stride(0) != n_s * n_knn * ld):
        raise ValueError(f"{kernel}: {name} needs contiguous rows at one stride, got strides {t.stride()}")
    return ld


def _launch(kernel: str, q, k, v, tgt, rpe, invalid, w_kv, w_rpe, b, n_head: int) -> torch.Tensor:
    device = q.device
    dtype = q.dtype
    if dtype not in _DTYPES:
        raise ValueError(f"{kernel}: dtype {dtype} not supported (float32 or bfloat16)")
    n_b, n_s, d_model = q.shape
    n_knn, d_rpe = rpe.shape[2], rpe.shape[3]
    d_tgt = 0 if tgt is None else d_model
    if n_head not in (1, 2, 4, 8) or d_model % n_head or d_model % 2 or n_knn < 1:
        raise ValueError(f"{kernel}: unsupported n_head={n_head}, d_model={d_model}, K={n_knn}")
    if kernel == "knarpe_cross_attention_v3" and (d_model // n_head) % 4:
        raise ValueError(f"{kernel}: d_head={d_model // n_head} must be a multiple of 4")
    _check(kernel, "q", q, (n_b, n_s, d_model), dtype, device)
    _check(kernel, "rpe", rpe, (n_b, n_s, n_knn, d_rpe), dtype, device)
    _check(kernel, "invalid", invalid, (n_b, n_s, n_knn), torch.bool, device)
    _check(kernel, "b", b, (2 * d_model,), dtype, device)
    ld_kv = 0
    if k is not None:
        ld_kv = _row_stride(kernel, "k", k, (n_b, n_s, n_knn, d_model), dtype, device)
        if _row_stride(kernel, "v", v, (n_b, n_s, n_knn, d_model), dtype, device) != ld_kv:
            raise ValueError(f"{kernel}: k and v rows must share one stride")
    else:
        _check(kernel, "tgt", tgt, (n_b, n_s, n_knn, d_model), dtype, device)
        _check(kernel, "w_kv", w_kv, (d_model, 2 * d_model), dtype, device)
    _check(kernel, "w_rpe", w_rpe, (d_rpe, 2 * d_model), dtype, device)
    out = torch.empty((n_b, n_s, d_model), dtype=dtype, device=device)
    n_src = n_b * n_s
    if n_src == 0:
        return out
    launch = load_library()

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = launch(_MODES[kernel], _DTYPES[dtype], ptr(q), ptr(k), ptr(v), ld_kv, ptr(tgt), ptr(rpe),
                    ptr(invalid), ptr(w_kv), ptr(w_rpe), ptr(b), ptr(out),
                    n_src, n_knn, d_model, d_tgt, d_rpe, n_head, 1.0 / math.sqrt(d_model // n_head),
                    torch.cuda.current_device(), stream)
    if rc != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: cudaError {rc}")
    LAUNCHES[kernel] += 1
    return out


def _on_cpu(kernel: str, q: torch.Tensor) -> bool:
    if q.device.type == "cpu":
        return True
    if q.device.type != "cuda":
        raise ValueError(f"{kernel}: no kernel for device {q.device}")
    return False


def knarpe_attention(q, k, v, rpe, invalid, w_rpe, b_rpe, n_head: int) -> torch.Tensor:
    """B4; see the module docstring. k/v may be the halves of one [.., 2D] tensor."""
    if _on_cpu("knarpe_attention", q):
        return knarpe_attention_reference(q, k, v, rpe, invalid, w_rpe, b_rpe, n_head)
    return _launch("knarpe_attention", q, k, v, None, rpe, invalid, None, w_rpe, b_rpe, n_head)


def knarpe_cross_attention(q, tgt, rpe, invalid, w_kv, w_rpe, b, n_head: int) -> torch.Tensor:
    """B2; see the module docstring. The target LayerNorm is folded into w_kv / b by the caller."""
    if _on_cpu("knarpe_cross_attention", q):
        return knarpe_cross_attention_reference(q, tgt, rpe, invalid, w_kv, w_rpe, b, n_head)
    return _launch("knarpe_cross_attention", q, None, None, tgt, rpe, invalid, w_kv, w_rpe, b, n_head)


def knarpe_cross_attention_v3(q, tgt, rpe, invalid, w_kv, w_rpe, b, n_head: int) -> torch.Tensor:
    """B3; B2's contract with `_x3_fwd_kernel`'s roundings."""
    if _on_cpu("knarpe_cross_attention_v3", q):
        return knarpe_cross_attention_v3_reference(q, tgt, rpe, invalid, w_kv, w_rpe, b, n_head)
    return _launch("knarpe_cross_attention_v3", q, None, None, tgt, rpe, invalid, w_kv, w_rpe, b, n_head)
