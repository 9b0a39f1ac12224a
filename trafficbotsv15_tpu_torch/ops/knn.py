"""Fused KNN select: the hand-written CUDA kernel, its plain version and the gate.

Replaces `trafficbotsv15_tpu/ops/pallas_knn.py::knn_xy_pallas`, the TPU
kernel on the rollout's agent->map relation (one launch per rollout step,
`[n_rows=128, n_src=64, n_tgt=1024]`, k=64 at the flagship).

By the bound it is the bytes (~1.2 MB of coordinates and masks in, ~4.2 MB
of distances and indices out at the flagship shape); what bounds the kernel
(`csrc/knn.cu`) is the instructions of the selection, so it selects by
threshold rather than by k extractions: a block stages its row's targets in
shared memory, a warp per source keeps its distance keys in registers, finds
the k-th smallest by a radix select on the distance bits, compacts the k
selected keys in target order and sorts them with a bitonic network; the
[n_src, n_tgt] distance tile never reaches device memory.

The wrapper `knn_xy` takes the plain version for a tensor on the CPU and
launches the kernel for a CUDA tensor, or raises; it never falls back.
`LAUNCHES` counts kernel launches (never plain-version calls).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from trafficbotsv15_tpu_torch.utils import build

LAUNCHES = 0  # kernel launches since the last reset (a plain int, read by chip_smoke.py)

MAX_TGT = 2048  # 64 register keys per lane (csrc/knn.cu)

_LAUNCH_FN = None  # the bound C entry point, set once by load_library


def knn_wanted(n_src: int, n_tgt: int, knn_kernel_on: bool) -> bool:
    """The gate of `pallas_knn.py::pallas_knn_wanted`: both packages use their
    kernel at the same call sites."""
    return knn_kernel_on and n_tgt >= 512 and n_tgt % 128 == 0 and n_src % 8 == 0


def sqrt_rn(sq: torch.Tensor) -> torch.Tensor:
    """The correctly rounded float32 root of float32 `sq`, as the kernel's __fsqrt_rn and XLA's sqrt give it. On the
    CPU it is taken in float64 and rounded once (torch's vectorised float32 sqrt there can be 1 ULP off); CUDA's
    float32 sqrt is correctly rounded already. Every plain distance of the port takes its root here."""
    if sq.is_cuda:
        return torch.sqrt(sq)
    return torch.sqrt(sq.double()).float()


def knn_xy_reference(src_xy, src_invalid, tgt_xy, tgt_invalid, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: masked distances + stable sort, first k.

    src_xy [n_rows, n_src, 2], src_invalid [n_rows, n_src] bool,
    tgt_xy [n_rows, n_tgt, 2], tgt_invalid [n_rows, n_tgt] bool ->
    (dist [n_rows, n_src, k] f32 ascending, idx [n_rows, n_src, k] int32).
    """
    src_xy, tgt_xy = src_xy.float(), tgt_xy.float()
    dx = src_xy[:, :, None, 0] - tgt_xy[:, None, :, 0]
    dy = src_xy[:, :, None, 1] - tgt_xy[:, None, :, 1]
    # the float32 sum is rounded per operation as in the kernel, the root correctly
    dist = sqrt_rn(dx * dx + dy * dy)
    dist = torch.where(src_invalid[:, :, None] | tgt_invalid[:, None, :], float("inf"), dist)
    d, i = torch.sort(dist, dim=-1, stable=True)
    return d[..., :k].contiguous(), i[..., :k].to(torch.int32).contiguous()


NVCC_FLAGS = ("--fmad=false",)  # every multiply and add rounded on its own, as the plain version


def load_library():
    """Build csrc/knn.cu and bind its C entry point, once per process."""
    global _LAUNCH_FN
    if _LAUNCH_FN is None:
        _LAUNCH_FN = bind_launch(build.load("knn", "knn.cu", extra_flags=NVCC_FLAGS))
    return _LAUNCH_FN


def bind_launch(lib: ctypes.CDLL):
    """The `knn_xy_launch` C entry point of a built csrc/knn.cu, with its argument types."""
    fn = lib.knn_xy_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(name: str, t: torch.Tensor, shape, dtype) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"knn_xy: {name} is on {t.device}, expected the CUDA device of src_xy")
    if tuple(t.shape) != tuple(shape) or t.dtype != dtype:
        raise ValueError(f"knn_xy: {name} is {tuple(t.shape)} {t.dtype}, expected {tuple(shape)} {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"knn_xy: {name} must be contiguous")
    if dtype == torch.float32 and t.data_ptr() % 8:  # the kernel reads coordinates as float2
        raise ValueError(f"knn_xy: {name} must be 8-byte aligned")


def knn_xy(src_xy, src_invalid, tgt_xy, tgt_invalid, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dist, idx) of the k nearest targets per source; see knn_xy_reference.

    CPU tensors take the plain version. CUDA tensors launch the kernel
    (f32 coordinates, bool masks, contiguous; 0 < k <= n_tgt <= 2048) or raise.
    """
    global LAUNCHES
    if src_xy.device.type == "cpu":
        return knn_xy_reference(src_xy, src_invalid, tgt_xy, tgt_invalid, k)
    if src_xy.device.type != "cuda":
        raise ValueError(f"knn_xy: no kernel for device {src_xy.device}")
    n_rows, n_src, _ = src_xy.shape
    n_tgt = tgt_xy.shape[1]
    if not (0 < k <= n_tgt <= MAX_TGT) or n_rows > 65535:
        raise ValueError(f"knn_xy: unsupported k={k}, n_tgt={n_tgt}, n_rows={n_rows}")
    _check("src_xy", src_xy, (n_rows, n_src, 2), torch.float32)
    _check("src_invalid", src_invalid, (n_rows, n_src), torch.bool)
    _check("tgt_xy", tgt_xy, (n_rows, n_tgt, 2), torch.float32)
    _check("tgt_invalid", tgt_invalid, (n_rows, n_tgt), torch.bool)
    if len({t.device for t in (src_xy, src_invalid, tgt_xy, tgt_invalid)}) != 1:
        raise ValueError("knn_xy: inputs on different devices")
    launch = load_library()
    dist = torch.empty((n_rows, n_src, k), dtype=torch.float32, device=src_xy.device)
    idx = torch.empty((n_rows, n_src, k), dtype=torch.int32, device=src_xy.device)
    with torch.cuda.device(src_xy.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = launch(src_xy.data_ptr(), src_invalid.data_ptr(), tgt_xy.data_ptr(),
                    tgt_invalid.data_ptr(), dist.data_ptr(), idx.data_ptr(), n_rows, n_src, n_tgt, k, stream)
    if rc != 0:
        raise RuntimeError(f"knn_xy kernel launch failed: cudaError {rc}")
    LAUNCHES += 1
    return dist, idx
