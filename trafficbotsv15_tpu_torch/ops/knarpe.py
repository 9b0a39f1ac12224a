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
what the kernels keep out of device memory (`csrc/knarpe.cu` says how). A
launch takes one of three routes, named by `route` from the shape alone:
"staged", for bf16 at every shape a staged kernel takes, every product on the
tensor cores: B4 on `csrc/knarpe_attn_staged.cuh` (a ring of source stages
filled by tensor copies, four groups of warps each on its own source), B2
and B3 on `csrc/knarpe_staged.cuh` (each source's targets staged in shared
memory while the previous source computes); "cluster", for bf16 B2 at the
scaled preset's D = R = 256 with 8 heads (K <= 104), which the staged kernel
refuses, on `csrc/knarpe_cluster.cuh`: a cluster of four blocks per source,
each holding a quarter of the weights and taking a quarter of the source's
columns, the partial sums exchanged through distributed shared memory;
"heads", for bf16 B4 at the same widths (K <= 40), which the staged kernel
refuses, on `csrc/knarpe_attn_heads.cuh`: four blocks per source, each on two
of the eight heads with their quarter of W_rpe, with no exchange between them;
and "general", the kernel of `csrc/knarpe.cu`, for float32 and the remaining
bf16 shapes (B4 where the heads kernel refuses too, such as K > 40 at D = R =
256 or more than 4 heads at other widths; B3 at D = R = 256 and at K >= 90;
B2 where the cluster kernel refuses too, such as K >= 90 at D = R = 128).
A bf16 B2 or B3 shape that every bf16 kernel refuses raises; so does an
operand of a staged, cluster or heads launch not at a 16-byte aligned address,
or B4's k and v rows not a multiple of 16 bytes apart.

Each wrapper is a `torch.autograd.Function`: its forward launches the
forward kernel and its backward the backward kernel of `csrc/knarpe_bwd.cu`,
which replaces `_bwd_kernel` (B4-bwd) and `_x_bwd_kernel` (B2-bwd; B3's
backward is B2's, as `pallas_knarpe.py:778-783` has it). The backward also
takes one of two routes, named by `bwd_route` from the shape alone: "staged"
for bf16 wherever a staged backward takes the shape
(`csrc/knarpe_attn_bwd_staged.cuh` for B4, `csrc/knarpe_bwd_staged.cuh` for
B2 and B3), and "general" (the kernel of `csrc/knarpe_bwd.cu`) for float32
and the bf16 shapes they refuse (more than 4 heads, K > 128, or a layout
beyond the block's shared memory), with the same alignment checks. For
tensors on the CPU both directions take the plain versions (the
`*_reference` forwards and autograd through them, `*_bwd_reference`); for
CUDA tensors they launch the kernels or raise; they never fall back.
`LAUNCHES` counts kernel launches per kernel, backward ones under `*_bwd`
(never plain-version calls), and `ROUTE_LAUNCHES` every launch by route.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from trafficbotsv15_tpu_torch.ops.attention import _masked_softmax, knn_attention
from trafficbotsv15_tpu_torch.utils import build

# kernel launches since the last reset, one plain int per kernel (read by chip_smoke.py)
LAUNCHES = {"knarpe_attention": 0, "knarpe_cross_attention": 0, "knarpe_cross_attention_v3": 0,
            "knarpe_attention_bwd": 0, "knarpe_cross_attention_bwd": 0}

_MODES = {"knarpe_attention": 0, "knarpe_cross_attention": 1, "knarpe_cross_attention_v3": 2}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# forward and backward launches by route since the last reset (read by chip_smoke.py); B3's backward
# counts as B2's; only B2 has the cluster route, only B4 the heads route
ROUTE_LAUNCHES = {**{f"{kernel}/{route}": 0 for kernel in ("knarpe_attention", "knarpe_cross_attention",
                                                           "knarpe_cross_attention_v3", "knarpe_attention_bwd",
                                                           "knarpe_cross_attention_bwd")
                     for route in ("staged", "general")},
                  "knarpe_cross_attention/cluster": 0, "knarpe_attention/heads": 0}

_LAUNCH_FN = None  # the bound C entry points, set once by load_library / load_bwd_library
_BWD_FN = None

# why the staged bf16 B2/B3 kernel (csrc/knarpe_staged.cuh) refuses a shape, by the code of
# `knarpe_staged_route` (`staged::refusal`)
STAGED_REFUSALS = {
    1: "K must be in [1, 512], one thread per target",
    2: "d_model and d_rpe must be multiples of 16 (the tensor cores' k steps)",
    3: "d_model must be a multiple of the 8-column tiles a warp takes",
    4: "d_head must be 4, or a multiple of 8 that divides the warp's column block",
    5: "the weights and two source stages exceed the device's shared memory per block",
    6: "no block fits a multiprocessor",
}
# why the staged bf16 B2 backward (csrc/knarpe_bwd_staged.cuh) refuses a shape, by the code of
# `knarpe_bwd_staged_route` (`staged_bwd::refusal`); such a shape takes the general backward kernel
BWD_STAGED_REFUSALS = {
    1: "K must be in [1, 128]: the softmax keeps each head's K / 32 targets per lane in registers",
    2: "d_model and d_rpe must be multiples of 16 (the tensor cores' k steps)",
    3: "n_head must be at most 4: [U | W] hi and lo share one 16-column tile",
    4: "the weights and one source stage exceed the device's shared memory per block",
    5: "no block fits a multiprocessor",
}
# why the staged bf16 B4 (csrc/knarpe_attn_staged.cuh) refuses a shape, by the code of `knarpe_staged_route`
# in mode 0 (`staged_attn::refusal`); such a shape takes the general kernel
ATTN_STAGED_REFUSALS = {
    1: "K must be in [1, 128]: the softmax keeps each head's K / 32 targets per lane in registers",
    2: "d_model and d_rpe must be multiples of 16 (the tensor cores' k steps)",
    3: "n_head must be at most 4: [U_hi | U_lo] takes 2 n_head <= 8 columns",
    4: "the weights, four source stages (one per group of warps) and the groups' scratch exceed the device's "
       "shared memory per block",
    5: "no block fits a multiprocessor",
}
# why the staged bf16 B4 backward (csrc/knarpe_attn_bwd_staged.cuh) refuses a shape, by the code of
# `knarpe_bwd_staged_route` in mode 0 (`staged_attn_bwd::refusal`); such a shape takes the general kernel
ATTN_BWD_STAGED_REFUSALS = {
    1: "K must be in [1, 128]: the softmax keeps each head's K / 32 targets per lane in registers",
    2: "d_model and d_rpe must be multiples of 16 (the tensor cores' k steps)",
    3: "n_head must be at most 4: [U | W] hi and lo share one 16-column tile",
    4: "the weights, four source stages (one per group of warps) and the groups' scratch exceed the device's "
       "shared memory per block",
    5: "no block fits a multiprocessor",
}
# why the cluster bf16 B2 kernel (csrc/knarpe_cluster.cuh) refuses a shape, by the code of
# `knarpe_cluster_route` (`cluster_x::refusal`); such a shape takes the general kernel
CLUSTER_REFUSALS = {
    1: "K must be in [1, 128]: the softmax holds a head's logits in one warp's registers, at most four a lane",
    2: "d_model = d_rpe = 256 with 8 heads are the only widths the kernel is compiled for",
    3: "a quarter of the weights and two source stages exceed the device's shared memory per block",
    4: "no cluster of four blocks fits the device",
}
# why the heads bf16 B4 kernel (csrc/knarpe_attn_heads.cuh) refuses a shape, by the code of
# `knarpe_attn_heads_route` (`heads_attn::refusal`); such a shape takes the general kernel
HEADS_REFUSALS = {
    1: "K must be in [1, 128]: the softmax keeps each head's K / 32 targets per lane in registers",
    2: "d_model = d_rpe = 256 with 8 heads are the only widths the kernel is compiled for",
    3: "a quarter of the weights, four source stages (one per group of warps) and the groups' scratch exceed the "
       "device's shared memory per block (K > 40 on an H100)",
    4: "no block of the four a source takes fits a multiprocessor",
}
# why the general kernel (csrc/knarpe.cu) refuses a shape, by the code of `knarpe_general_route`
GENERAL_REFUSALS = {
    1: "its smallest layout (the weights and B3's inputs read through L1/L2) exceeds the device's shared memory "
       "per block",
}


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


def _plain_grads(fn, inputs, g):
    """Gradients of <fn(*inputs), g> with respect to the float inputs (None for the mask)."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(t.is_floating_point()) for t in inputs]
        out = fn(*leaves)
        want = [t for t in leaves if t.requires_grad]
        grads = iter(torch.autograd.grad(out, want, g))
    return tuple(next(grads) if t.requires_grad else None for t in leaves)


def knarpe_attention_bwd_reference(q, k, v, rpe, invalid, w_rpe, b_rpe, g, n_head: int):
    """Plain B4-bwd: autograd through `knarpe_attention_reference`.
    -> (dq, dk, dv, drpe, dw_rpe, db_rpe), the contract of `_knarpe_bwd_pallas`."""
    dq, dk, dv, drpe, _, dw, db = _plain_grads(
        lambda *a: knarpe_attention_reference(*a, n_head), (q, k, v, rpe, invalid, w_rpe, b_rpe), g)
    return dq, dk, dv, drpe, dw, db


def knarpe_cross_attention_bwd_reference(q, tgt, rpe, invalid, w_kv, w_rpe, b, g, n_head: int):
    """Plain B2-bwd (and B3's): autograd through `knarpe_cross_attention_reference`.
    -> (dq, dtgt, drpe, dw_kv, dw_rpe, db), the contract of `_knarpe_x_bwd_pallas`."""
    dq, dtgt, drpe, _, dwk, dwr, db = _plain_grads(
        lambda *a: knarpe_cross_attention_reference(*a, n_head), (q, tgt, rpe, invalid, w_kv, w_rpe, b), g)
    return dq, dtgt, drpe, dwk, dwr, db


# -- kernels -----------------------------------------------------------------
def load_library():
    """Build csrc/knarpe.cu and bind its C entry points, once per process."""
    global _LAUNCH_FN
    if _LAUNCH_FN is None:
        lib = build.load("knarpe", "knarpe.cu")
        for fn in (lib.knarpe_staged_route, lib.knarpe_general_route):
            fn.argtypes = [ctypes.c_int] * 7
            fn.restype = ctypes.c_int
        for fn in (lib.knarpe_cluster_route, lib.knarpe_attn_heads_route):
            fn.argtypes = [ctypes.c_int] * 5
            fn.restype = ctypes.c_int
        _LAUNCH_FN = bind_launch(lib)
    return _LAUNCH_FN


def bind_launch(lib: ctypes.CDLL):
    """The `knarpe_launch` C entry point of a built csrc/knarpe.cu, with its argument types."""
    fn = lib.knarpe_launch
    fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 3 + [ctypes.c_longlong]
                   + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _route_code(entry: str, kernel: str, n_knn: int, d_model: int, d_rpe: int, n_head: int, device_index: int) -> int:
    """The built library's answer (`knarpe_staged_route` or `knarpe_general_route`) for a bf16 launch."""
    load_library()
    code = getattr(build.load("knarpe", "knarpe.cu"), entry)(
        _MODES[kernel], _DTYPES[torch.bfloat16], n_knn, d_model, d_rpe, n_head, device_index)
    if code < 0:
        raise RuntimeError(f"{kernel}: planning a launch ({entry}) failed: code {code}")
    return code


@functools.lru_cache(maxsize=None)
def staged_refusal(kernel: str, n_knn: int, d_model: int, d_rpe: int, n_head: int, device_index: int) -> int:
    """0 if the staged kernel takes a bf16 launch of B4, B2 or B3 at this shape on the card, else the
    built library's refusal code (`ATTN_STAGED_REFUSALS` for B4, `STAGED_REFUSALS` for B2 and B3 say why)."""
    return _route_code("knarpe_staged_route", kernel, n_knn, d_model, d_rpe, n_head, device_index)


@functools.lru_cache(maxsize=None)
def general_refusal(kernel: str, n_knn: int, d_model: int, d_rpe: int, n_head: int, device_index: int) -> int:
    """0 if the general kernel takes a bf16 launch at this shape on the card, else the built
    library's refusal code (`GENERAL_REFUSALS` says why)."""
    return _route_code("knarpe_general_route", kernel, n_knn, d_model, d_rpe, n_head, device_index)


@functools.lru_cache(maxsize=None)
def cluster_refusal(n_knn: int, d_model: int, d_rpe: int, n_head: int, device_index: int) -> int:
    """0 if the cluster kernel takes a bf16 B2 launch at this shape on the card, else the built library's
    refusal code (`CLUSTER_REFUSALS` says why)."""
    load_library()
    code = build.load("knarpe", "knarpe.cu").knarpe_cluster_route(n_knn, d_model, d_rpe, n_head, device_index)
    if code < 0:
        raise RuntimeError(f"knarpe_cross_attention: planning a launch (knarpe_cluster_route) failed: code {code}")
    return code


@functools.lru_cache(maxsize=None)
def heads_refusal(n_knn: int, d_model: int, d_rpe: int, n_head: int, device_index: int) -> int:
    """0 if the heads kernel takes a bf16 B4 launch at this shape on the card, else the built library's
    refusal code (`HEADS_REFUSALS` says why)."""
    load_library()
    code = build.load("knarpe", "knarpe.cu").knarpe_attn_heads_route(n_knn, d_model, d_rpe, n_head, device_index)
    if code < 0:
        raise RuntimeError(f"knarpe_attention: planning a launch (knarpe_attn_heads_route) failed: code {code}")
    return code


def route(kernel: str, dtype, n_knn: int, d_model: int, d_rpe: int, n_head: int, device_index: int) -> str:
    """The kernel a forward launch takes, from its shape alone: "staged" in bf16 where the staged kernel
    takes the shape; then for bf16 B4 "heads" where the heads kernel takes it, for bf16 B2 "cluster" where
    the cluster kernel takes it; else "general"; for B2 and B3, raises when no bf16 kernel takes it."""
    if dtype != torch.bfloat16:
        return "general"
    code = staged_refusal(kernel, n_knn, d_model, d_rpe, n_head, device_index)
    if code == 0:
        return "staged"
    if kernel == "knarpe_attention":
        return "heads" if heads_refusal(n_knn, d_model, d_rpe, n_head, device_index) == 0 else "general"
    why = f"the staged kernel refuses it ({STAGED_REFUSALS[code]})"
    if kernel == "knarpe_cross_attention":
        cluster = cluster_refusal(n_knn, d_model, d_rpe, n_head, device_index)
        if cluster == 0:
            return "cluster"
        why += f", the cluster kernel too ({CLUSTER_REFUSALS[cluster]})"
    general = general_refusal(kernel, n_knn, d_model, d_rpe, n_head, device_index)
    if general == 0:
        return "general"
    raise ValueError(f"{kernel}: no bf16 kernel takes K={n_knn}, d_model={d_model}, d_rpe={d_rpe}, "
                     f"n_head={n_head}: {why}, and the general kernel too ({GENERAL_REFUSALS[general]})")


def load_bwd_library():
    """Build csrc/knarpe_bwd.cu and bind its C entry point, once per process."""
    global _BWD_FN
    if _BWD_FN is None:
        lib = build.load("knarpe_bwd", "knarpe_bwd.cu")
        lib.knarpe_bwd_staged_route.argtypes = [ctypes.c_int] * 7
        lib.knarpe_bwd_staged_route.restype = ctypes.c_int
        _BWD_FN = bind_bwd_launch(lib)
    return _BWD_FN


def bind_bwd_launch(lib: ctypes.CDLL):
    """The `knarpe_bwd_launch` C entry point of a built csrc/knarpe_bwd.cu, with its argument types."""
    fn = lib.knarpe_bwd_launch
    fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 3 + [ctypes.c_longlong]
                   + [ctypes.c_void_p] * 17 + [ctypes.c_int] * 6
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _bwd_route_code(kernel: str, n_knn: int, d_model: int, d_rpe: int, n_head: int, device_index: int) -> int:
    """The built library's answer (`knarpe_bwd_staged_route`) for a bf16 backward launch."""
    load_bwd_library()
    code = build.load("knarpe_bwd", "knarpe_bwd.cu").knarpe_bwd_staged_route(
        _MODES[kernel], _DTYPES[torch.bfloat16], n_knn, d_model, d_rpe, n_head, device_index)
    if code < 0:
        raise RuntimeError(f"{kernel} backward: planning a launch (knarpe_bwd_staged_route) failed: code {code}")
    return code


@functools.lru_cache(maxsize=None)
def bwd_staged_refusal(n_knn: int, d_model: int, d_rpe: int, n_head: int, device_index: int) -> int:
    """0 if the staged backward takes a bf16 B2 (or B3) backward at this shape on the card, else the
    built library's refusal code (`BWD_STAGED_REFUSALS` says why)."""
    return _bwd_route_code("knarpe_cross_attention", n_knn, d_model, d_rpe, n_head, device_index)


@functools.lru_cache(maxsize=None)
def attn_bwd_staged_refusal(n_knn: int, d_model: int, d_rpe: int, n_head: int, device_index: int) -> int:
    """0 if the staged B4 backward takes a bf16 B4 backward at this shape on the card, else the built
    library's refusal code (`ATTN_BWD_STAGED_REFUSALS` says why)."""
    return _bwd_route_code("knarpe_attention", n_knn, d_model, d_rpe, n_head, device_index)


def bwd_route(kernel: str, dtype, n_knn: int, d_model: int, d_rpe: int, n_head: int, device_index: int) -> str:
    """The kernel a backward launch takes, from its shape alone: "staged" in bf16 where the staged backward
    (of B4, or of B2 and B3) takes the shape, else "general" (float32, and the bf16 shapes it refuses)."""
    if dtype != torch.bfloat16:
        return "general"
    refusal = attn_bwd_staged_refusal if kernel == "knarpe_attention" else bwd_staged_refusal
    return "staged" if refusal(n_knn, d_model, d_rpe, n_head, device_index) == 0 else "general"


def _check_staged_alignment(kernel: str, tensors, ld_kv: int, way: str = "staged") -> None:
    """A staged, cluster or heads launch copies 16-byte chunks: every operand starts at a 16-byte aligned
    address and B4's k and v rows lie a multiple of 16 bytes apart (ld_kv elements of 2 bytes)."""
    if any(t.data_ptr() % 16 for t in tensors if t is not None):
        raise ValueError(f"{kernel}: the {way} bf16 kernel copies 16-byte chunks; its operands must start at "
                         f"16-byte aligned addresses")
    if ld_kv % 8:
        raise ValueError(f"{kernel}: the {way} bf16 kernel copies k and v rows by tensor copies, whose rows must "
                         f"lie a multiple of 16 bytes apart; got a stride of {ld_kv} elements")


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


def _validate(kernel: str, q, k, v, tgt, rpe, invalid, w_kv, w_rpe, b, n_head: int, forward: bool = True):
    """Check the operands against the forward (or, with forward=False, the backward) kernel's
    contract; -> (n_b, n_s, K, D, R, d_tgt, ld_kv, route), route None for the backward."""
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
    way = route(kernel, dtype, n_knn, d_model, d_rpe, n_head, device.index or 0) if forward else None
    if way in ("staged", "cluster", "heads"):
        _check_staged_alignment(kernel, (q, k, v, tgt, rpe, w_kv, w_rpe, b), ld_kv, way)
    return n_b, n_s, n_knn, d_model, d_rpe, d_tgt, ld_kv, way


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch(kernel: str, q, k, v, tgt, rpe, invalid, w_kv, w_rpe, b, n_head: int) -> torch.Tensor:
    n_b, n_s, n_knn, d_model, d_rpe, d_tgt, ld_kv, way = _validate(kernel, q, k, v, tgt, rpe, invalid, w_kv, w_rpe,
                                                                   b, n_head)
    out = torch.empty((n_b, n_s, d_model), dtype=q.dtype, device=q.device)
    n_src = n_b * n_s
    if n_src == 0:
        return out
    launch = load_library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = launch(_MODES[kernel], _DTYPES[q.dtype], _ptr(q), _ptr(k), _ptr(v), ld_kv, _ptr(tgt), _ptr(rpe),
                    _ptr(invalid), _ptr(w_kv), _ptr(w_rpe), _ptr(b), _ptr(out),
                    n_src, n_knn, d_model, d_tgt, d_rpe, n_head, 1.0 / math.sqrt(d_model // n_head),
                    torch.cuda.current_device(), stream)
    if rc != 0:
        raise RuntimeError(f"{kernel} kernel launch failed ({way} route): cudaError {rc}")
    LAUNCHES[kernel] += 1
    ROUTE_LAUNCHES[f"{kernel}/{way}"] += 1
    return out


def bwd_chunks(n_src: int, x1: int, d_model: int, n_head: int) -> int:
    """Source chunks of the weight-gradient reduction: about four blocks per SM of an H100
    in its first pass, at least 64 sources per chunk. Fixed by the shapes, so the sums are
    taken in the same order on every call."""
    d_head = d_model // n_head
    blocks = -(-x1 // 64) * 2 * n_head * -(-d_head // 32)
    return max(1, min(-(-n_src // 64), 528 // blocks))


def _launch_bwd(kernel: str, q, k, v, tgt, rpe, invalid, w_kv, w_rpe, b, g, n_head: int):
    """The backward kernel of B4 (k/v given) or B2 (tgt given): (dq, dk, dv, dtgt, drpe, dw_kv, dw_rpe, db),
    None where the kernel has no such input."""
    n_b, n_s, n_knn, d_model, d_rpe, d_tgt, ld_kv, _ = _validate(kernel, q, k, v, tgt, rpe, invalid, w_kv, w_rpe,
                                                                 b, n_head, forward=False)
    dtype, device = q.dtype, q.device
    _check(kernel, "g", g, (n_b, n_s, d_model), dtype, device)
    way = bwd_route(kernel, dtype, n_knn, d_model, d_rpe, n_head, device.index or 0)
    if way == "staged":
        _check_staged_alignment(f"{kernel} backward", (q, k, v, tgt, rpe, w_kv, w_rpe, b, g), ld_kv)

    def empty(*shape, dt=dtype):
        return torch.empty(shape, dtype=dt, device=device)

    attn = k is not None
    dq = empty(n_b, n_s, d_model)
    dk, dv = (empty(n_b, n_s, n_knn, d_model), empty(n_b, n_s, n_knn, d_model)) if attn else (None, None)
    dtgt = None if attn else empty(n_b, n_s, n_knn, d_model)
    drpe = empty(n_b, n_s, n_knn, d_rpe)
    dw_kv = None if attn else empty(d_model, 2 * d_model)
    dw_rpe, db = empty(d_rpe, 2 * d_model), empty(2 * d_model)
    n_src = n_b * n_s
    if n_src == 0:
        return (dq, dk, dv, dtgt, drpe) + tuple(None if t is None else t.zero_() for t in (dw_kv, dw_rpe, db))
    x1 = d_tgt + d_rpe + 1
    n_chunks = bwd_chunks(n_src, x1, d_model, n_head)
    pbuf = empty(n_src * 2 * n_head * x1, dt=torch.float32)
    partial = empty(n_chunks * x1 * 2 * d_model, dt=torch.float32)
    launch = load_bwd_library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = launch(1 if tgt is not None else 0, _DTYPES[dtype], _ptr(q), _ptr(k), _ptr(v), ld_kv, _ptr(tgt), _ptr(rpe),
                    _ptr(invalid), _ptr(w_kv), _ptr(w_rpe), _ptr(b), _ptr(g), _ptr(dq), _ptr(dk), _ptr(dv),
                    _ptr(dtgt), _ptr(drpe), _ptr(dw_kv), _ptr(dw_rpe), _ptr(db), _ptr(pbuf), _ptr(partial),
                    n_src, n_knn, d_model, d_tgt, d_rpe, n_head, 1.0 / math.sqrt(d_model // n_head), n_chunks,
                    torch.cuda.current_device(), stream)
    if rc != 0:
        raise RuntimeError(f"{kernel} backward kernel launch failed ({way} route): cudaError {rc}")
    name = "knarpe_attention_bwd" if attn else "knarpe_cross_attention_bwd"
    LAUNCHES[name] += 1
    ROUTE_LAUNCHES[f"{name}/{way}"] += 1
    return dq, dk, dv, dtgt, drpe, dw_kv, dw_rpe, db


def _on_cpu(kernel: str, q: torch.Tensor) -> bool:
    if q.device.type == "cpu":
        return True
    if q.device.type != "cuda":
        raise ValueError(f"{kernel}: no kernel for device {q.device}")
    return False


_PLAIN = {"knarpe_attention": knarpe_attention_reference,
          "knarpe_cross_attention": knarpe_cross_attention_reference,
          "knarpe_cross_attention_v3": knarpe_cross_attention_v3_reference}


class _KnarpeFn(torch.autograd.Function):
    """One KNARPE kernel with its backward. tensors: (q, k, v, rpe, invalid, w_rpe, b_rpe) for B4,
    (q, tgt, rpe, invalid, w_kv, w_rpe, b) for B2 and B3; B3's backward is B2's."""

    @staticmethod
    def forward(ctx, kernel: str, n_head: int, *tensors):
        ctx.kernel, ctx.n_head = kernel, n_head
        ctx.save_for_backward(*tensors)
        if _on_cpu(kernel, tensors[0]):
            return _PLAIN[kernel](*tensors, n_head)
        if kernel == "knarpe_attention":
            q, k, v, rpe, invalid, w_rpe, b = tensors
            return _launch(kernel, q, k, v, None, rpe, invalid, None, w_rpe, b, n_head)
        q, tgt, rpe, invalid, w_kv, w_rpe, b = tensors
        return _launch(kernel, q, None, None, tgt, rpe, invalid, w_kv, w_rpe, b, n_head)

    @staticmethod
    def backward(ctx, g):
        tensors, n_head = ctx.saved_tensors, ctx.n_head
        g = g.contiguous()
        cpu = tensors[0].device.type == "cpu"
        if ctx.kernel == "knarpe_attention":
            q, k, v, rpe, invalid, w_rpe, b = tensors
            if cpu:
                dq, dk, dv, drpe, dw, db = knarpe_attention_bwd_reference(*tensors, g, n_head)
            else:
                dq, dk, dv, _, drpe, _, dw, db = _launch_bwd(ctx.kernel, q, k, v, None, rpe, invalid, None, w_rpe,
                                                             b, g, n_head)
            return None, None, dq, dk, dv, drpe, None, dw, db
        q, tgt, rpe, invalid, w_kv, w_rpe, b = tensors
        if cpu:
            dq, dtgt, drpe, dwk, dwr, db = knarpe_cross_attention_bwd_reference(*tensors, g, n_head)
        else:
            dq, _, _, dtgt, drpe, dwk, dwr, db = _launch_bwd("knarpe_cross_attention", q, None, None, tgt, rpe,
                                                             invalid, w_kv, w_rpe, b, g, n_head)
        return None, None, dq, dtgt, drpe, None, dwk, dwr, db


def knarpe_attention(q, k, v, rpe, invalid, w_rpe, b_rpe, n_head: int) -> torch.Tensor:
    """B4 with its backward; see the module docstring. k/v may be the halves of one [.., 2D] tensor."""
    return _KnarpeFn.apply("knarpe_attention", n_head, q, k, v, rpe, invalid, w_rpe, b_rpe)


def knarpe_cross_attention(q, tgt, rpe, invalid, w_kv, w_rpe, b, n_head: int) -> torch.Tensor:
    """B2 with its backward; see the module docstring. The target LayerNorm is folded into w_kv / b by the caller."""
    return _KnarpeFn.apply("knarpe_cross_attention", n_head, q, tgt, rpe, invalid, w_kv, w_rpe, b)


def knarpe_cross_attention_v3(q, tgt, rpe, invalid, w_kv, w_rpe, b, n_head: int) -> torch.Tensor:
    """B3; B2's contract with `_x3_fwd_kernel`'s roundings, and B2's backward."""
    return _KnarpeFn.apply("knarpe_cross_attention_v3", n_head, q, tgt, rpe, invalid, w_kv, w_rpe, b)
