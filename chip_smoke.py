#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:
  1. device: needs CUDA; prints the card's name and power limit and turns
     TF32 off for matmuls and cuDNN;
  2. build: compiles every CUDA kernel of the path from csrc/ (nvcc, sm_90a);
  3. kernels: each kernel against its plain PyTorch version on the card, at
     the main path's shapes and at edge cases; times kernel, plain version and
     the nearest single PyTorch call (`library_ms`);
  4. slice checked: a reduced-depth float32 config whose map has 512
     polylines (so the KNN kernel gate fires) runs `joint_future_pred` on the
     card and on the CPU with the same weights; the K0 futures must agree and
     the kernel must launch once per rollout step;
  5. slice at full width: `leaderboard_config()` (bf16 compute), 4 synthetic
     scenarios x K=32 futures, 64 agents, 1024 polylines, 90 steps,
     check_level=0: finite poses of the documented shapes, 90 KNN launches
     per call, seconds per call, peak memory and agent-steps/s.
Then it prints the `kernels` JSON line, the card line, and last
`{"ok": true, "device": {...}}`. Imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

from trafficbotsv15_tpu_torch.config import leaderboard_config, tiny_config
from trafficbotsv15_tpu_torch.data.synthetic import make_batch
from trafficbotsv15_tpu_torch.ops import knn
from trafficbotsv15_tpu_torch.train.evaluation import joint_future_pred
from trafficbotsv15_tpu_torch.train.pipeline import build_model

HBM_BYTES_PER_S = 3.35e12  # H100 SXM (NVIDIA data sheet, 700 W)
FP32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
KNN_ROWS, KNN_SRC, KNN_TGT, KNN_K = 128, 64, 1024, 64  # 4 scenarios x 32 futures, agents, polylines, 2.0 * 32
SLICE_POSE_ATOL = 1e-3  # m; float32 on card vs CPU, reduction order only


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


def damp_weights(model: torch.nn.Module, gain: float) -> None:
    """Scale every weight matrix: a random policy at full gain is chaotic in closed
    loop, so card-vs-CPU rounding differences would grow instead of showing parity."""
    with torch.no_grad():
        for p in model.parameters():
            if p.dim() == 2:
                p.mul_(gain)


def check_slice_card_vs_cpu() -> None:
    base = tiny_config(n_ag=16, n_mp=512, n_tl=16, n_step=31, hidden_dim=64)
    cfg = dataclasses.replace(base, joint_future_pred_deterministic_k0=True)
    batch = make_batch(cfg.data, n_sc=1, seed=3)
    bufs = {}
    for device in ("cpu", "cuda"):
        model = build_model(cfg, seed=1, device=device)
        damp_weights(model, 0.5)
        knn.LAUNCHES = 0
        _, buf = joint_future_pred(cfg, model, batch, generator=torch.Generator().manual_seed(0),
                                   n_joint_future=2, device=device)
        if device == "cuda":
            torch.cuda.synchronize()
            if knn.LAUNCHES != cfg.time_step_end:
                raise AssertionError(f"slice check: {knn.LAUNCHES} KNN launches, expected {cfg.time_step_end}")
        bufs[device] = buf
    cpu, gpu = bufs["cpu"], bufs["cuda"]
    pose_err = float((gpu.pred_pose[:, 0].cpu() - cpu.pred_pose[:, 0]).abs().max())
    if not torch.equal(gpu.pred_valid[:, 0].cpu(), cpu.pred_valid[:, 0]) or not pose_err <= SLICE_POSE_ATOL:
        raise AssertionError(f"slice check: K0 futures differ card vs CPU (max pose err {pose_err})")
    log(f"  card vs CPU, K0 futures of {list(gpu.pred_pose.shape)}: pred_valid equal, max |pose err| "
        f"{pose_err:.3e} m (tolerance {SLICE_POSE_ATOL}); KNN kernel launches {cfg.time_step_end} "
        f"= rollout steps")


def run_full_width(card: str, n_timed: int = 3) -> int:
    cfg = leaderboard_config()
    n_sc, k = 4, cfg.n_joint_future_wosac
    batch = make_batch(cfg.data, n_sc=n_sc, seed=0)
    model = build_model(cfg, seed=0, device="cuda")
    gen = torch.Generator().manual_seed(0)
    n_params = sum(p.numel() for p in model.parameters())
    t0 = time.perf_counter()
    joint_future_pred(cfg, model, batch, generator=gen, check_level=0)
    torch.cuda.synchronize()
    log(f"  warm-up call {time.perf_counter() - t0:.3f} s ({n_params} parameters, bf16 compute)")
    torch.cuda.reset_peak_memory_stats()
    times, launches = [], []
    for _ in range(n_timed):
        knn.LAUNCHES = 0
        t0 = time.perf_counter()
        _, buf = joint_future_pred(cfg, model, batch, generator=gen, check_level=0)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        launches.append(knn.LAUNCHES)
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
    if any(n != n_step for n in launches):
        raise AssertionError(f"full width: KNN launches per call {launches}, expected {n_step}")
    sec = float(np.median(times))
    agent_steps = n_sc * k * n_ag * (cfg.time_step_end - cfg.time_step_current)
    log(f"  leaderboard_config joint_future_pred: {n_sc} scenarios x K={k}, {n_ag} agents, "
        f"{cfg.data.n_mp} polylines, {n_step} steps: seconds per call {[round(t, 4) for t in times]} "
        f"(median {sec:.4f} s), peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
        f"{agent_steps / sec:.1f} agent-steps/s, KNN launches per call {launches} [{card}]")
    return launches[-1]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; the port's main path needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    card = card_line()
    log(f"[1/5] device: {torch.cuda.get_device_name(0)}; nvidia-smi: {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"  torch {torch.__version__} cuda {torch.version.cuda}; allow_tf32 matmul="
        f"{torch.backends.cuda.matmul.allow_tf32} cudnn={torch.backends.cudnn.allow_tf32}")

    t0 = time.perf_counter()
    knn.load_library()
    log(f"[2/5] build: csrc/knn.cu in {time.perf_counter() - t0:.2f} s")

    log("[3/5] kernels vs plain versions")
    knn_row = check_knn_kernel()

    log("[4/5] slice checked: reduced-depth fp32 config, 512 polylines, card vs CPU")
    check_slice_card_vs_cpu()

    log("[5/5] slice at full width")
    knn_row["launches"] = run_full_width(card)
    for key, val in knn_row.items():
        if isinstance(val, float) and not math.isfinite(val):
            raise AssertionError(f"kernels line: {key} is not finite")

    print(json.dumps({"kernels": [knn_row]}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
