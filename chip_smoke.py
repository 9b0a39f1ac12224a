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
     B1 (`knn_xy`; also at the training path's [8, 64, 1024], the training
     entry point's [2, 64, 1024] and its validation's [4, 64, 1024], the
     scaled preset's training [1, 64, 1024], all
     distances tied, k=1, k = n_tgt, n_tgt 1000 and 2048, every
     source invalid; timed at the eval and training shapes), B4 (`knarpe_attention`; in bf16 on
     the staged kernel of csrc/knarpe_attn_staged.cuh, the route asserted,
     at both paths' shapes and the entry point's 2 x 1024, K=5, K=24, 1, 97
     and 8 x 1024 + 7 sources and the edge shapes; at the scaled preset's
     D=R=256 with 8 heads on the heads kernel of csrc/knarpe_attn_heads.cuh
     (asserted; at the eval shape [4, 1024, 32, 256, 256, 8], the training
     shape [1, 1024, 32, 256, 256, 8], K=5, K=24 and K=40 (the largest its
     shared memory takes) at 97 sources, a single source and 8 x 1024 + 7
     sources, k and v the halves of one tensor and two tensors, each with an
     all-invalid and a one-target source, the same bits on a second launch);
     on the general route (asserted, the heads kernel's refusal code too) at
     K=89 there and at an eight-head shape of other widths; timed at both
     paths' shapes and the scaled preset's two), B2
     (`knarpe_cross_attention`) and B3 (`knarpe_cross_attention_v3`, which
     only this phase launches); B2 and B3 also at the training path's shapes
     (the agent decoder and posterior agent encoder, the posterior TL encoder
     at K=24), at the entry point's batch of 2 and its validation's of 4, and
     timed at the first of them; in bf16 these run on the staged
     kernel of csrc/knarpe_staged.cuh (the route asserted); at the shapes it
     refuses, bf16 B2 at the scaled preset's D=R=256 with 8 heads runs on the
     cluster route (csrc/knarpe_cluster.cuh, asserted; at the eval shape, the
     training shape [1, 64, 89, 256, 256, 8], K=5, K=24 and K=104 at 21
     sources, a single source and 8192 + 7 sources, each with an all-invalid
     and a one-target source; timed at the scaled preset's eval and training
     shapes), and on the general route (csrc/knarpe.cu, asserted, the cluster
     kernel's refusal code too) at K=120 there and at K=90 and K=128 at
     D=R=128; B3 runs on the general route at D=R=256 and at K=90 and K=128
     (asserted; timed at the scaled preset's eval shape); every bf16 B2/B3 must give the same bits
     on a second launch; then the backward kernels B4-bwd and B2-bwd (B3's backward is B2's)
     through the wrappers' autograd: the card's output has a grad_fn, and its
     gradients match autograd of the plain versions in float32 and bf16, the
     same bits on a second launch; bf16 B2-bwd and B3's backward run on the
     staged kernel of csrc/knarpe_bwd_staged.cuh (the route asserted) at both
     training shapes, K=5 at 21 sources and 200 sources, the eight-head edge
     shape on the general route (csrc/knarpe_bwd.cu), and the entry point's
     batch-2 shapes; bf16 B4-bwd on the
     staged kernel of csrc/knarpe_attn_bwd_staged.cuh at B4's shapes above,
     the eight-head shape on the general route; timed (eager, and device
     time from a CUDA graph) against the plain backward and the library
     composition's backward, B2-bwd at both training shapes; B2-bwd and
     B4-bwd also at the scaled preset's training shapes ([1, 64, 89, 256,
     256, 8], [1, 1024, 32, 256, 256, 8]) on the general route (asserted);
  4. slice checked: a reduced-depth float32 config whose map has 512
     polylines runs `joint_future_pred` (check_level=1) on the card and on
     the CPU with the same weights, once with use_pallas=False and once with
     use_pallas=True; the K0 futures and their rule flags must agree, and the
     kernels must launch as often as the config's layers and steps say;
  5. slice at full width, use_pallas=False: `leaderboard_config()` (bf16
     compute), 4 synthetic scenarios x K=32 futures, 64 agents, 1024
     polylines, 90 steps, check_level=1: finite poses of the documented
     shapes, 90 KNN launches and no attention-kernel launch per call, seconds
     per call, peak memory and agent-steps/s; phases 6 and 8 record the
     shapes at which the paths launch B4 and B2 and fail on one phase 3 did
     not check, and on any B4 or B2 launch, forward or backward, that did not
     take the staged route;
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
     f32 parameters: one warm-up step, then 2 timed steps; seconds per step,
     train samples/s, peak memory, forward and backward launches per step
     (asserted), every bf16 B4 and B2 forward and backward launch on the
     staged route at a shape phase 3 checked; loss and grad_norm finite and non-zero,
     parameters changed;
  9. validation step (`eval/runner.py::make_validate_step`: reactive replay, its
     loss and metric sums, K joint futures, WOMD post-processing and native
     motion metrics, the WOSAC filter, native realism): the phase-4 config with
     K=34 futures on the card and on the CPU, same weights and draws, use_pallas
     False and True: buffers, flags and every entry of `out` agree, and the
     card's realism agrees with the CPU's on the card's own futures; then
     `leaderboard_config()` with use_pallas=True, 4 scenarios, K=32, level 1,
     native realism: one warm-up, 2 timed steps (seconds per step,
     wosac_validate_scenarios_per_sec_per_chip, peak memory), launches per step
     asserted (B1 181, B4 16, B2 728, staged, at shapes phase 3 checked), one
     more step split by part with the realism part's working set;
 10. submission: `test_submission` at `leaderboard_config()` for one test-split
     scenario with K=128 futures: WOMD and WOSAC arrays of the submission's
     shapes, finite, in the global frame; the card's 32 futures equal the CPU's
     filter on the same buffer; the call timed;
 11. the training entry point (`trafficbotsv15_tpu_torch/run.py`), in a
     temporary directory: (a) `run.fit` for 4 calls (accumulate_grad_batches=2,
     EMA 0.5, SWA from step 0) on the card and on the CPU from the same damped
     seed-0 weights and tbcache file: the first update's gradients agree, and
     each device's parameters, EMA and SWA agree with a CPU replay of its own
     updates; (b) `run.main(["action=fit", ...])` on `leaderboard_config()` with
     use_pallas=True from a tbcache of 8 training and 4 validation scenarios at
     batch 2: 3 steps, launches per step asserted (all staged, every launch at
     a full shape phase 3 checked), loss and grad_norm finite, "last" and "best"
     written, the restored parameters equal the live ones; then `resume=true`
     to step 4 from exactly the saved state and the next batch; (c) a
     `python -m trafficbotsv15_tpu_torch.run action=fit` subprocess at the
     phase-4 config gets SIGTERM after its first step: exit 143, and a resume
     adds one step; (d) `action=validate` from "last" gives the fit's own
     val/loss, `action=test` from "best" writes the K=128 arrays; (e) seconds
     per fit step, samples/s, peak memory, save and write seconds, checkpoint
     bytes, resume seconds;
 12. reference-torch goldens (`tests/golden/`, the original PyTorch modules'
     outputs), through the case functions of `tests/test_torch_golden_model.py`
     and `tests/test_torch_golden_sim.py` on the card: (a) every golden that
     reaches an attention kernel, in float32 with use_pallas=True (`attn_rpe`,
     `tfblock_enc_cross`: B2; `tfblock_enc_self_knn` at dense_knn_max=0: B4;
     `tfblock_dec_cross` at 0: both; `traffic_bots_full` at 0: B4 8, B2 6),
     each output within the CPU test's tolerance, the launches asserted
     exactly and all on the general route (float32); then every model and sim
     case with use_pallas=False, no kernel launched; (b) `leaderboard_config()`
     with use_pallas=True and damped seed-0 weights exported to the
     reference's state_dict layout (`tests/torch_reference_layout.py`, which
     gives `traffic_bots_full`'s 526 names and shapes), loaded back through
     `utils/torch_import.py::load_reference_state_dict`: every parameter
     bit-equal; one full-width call launches B1 90, B4 8, B2 360 (staged, at
     shapes phase 3 checked) and its K0 futures and rule flags equal, bit for
     bit, the directly loaded model's call. Phase 12's float32 golden launches
     are not recorded for the shape check of phases 6, 8, 9 and 11: the
     goldens themselves hold them;
 13. the scaled preset (`scaled_config()`: hidden 256, 8 heads, 12/6/6
     map/TL/agent layers, 120 steps against the 91 the log holds, bf16
     compute), random seed-0 weights, synthetic scenarios, use_pallas=False
     unless said: (a) `joint_future_pred`, 4 scenarios x K=32, level 1: one
     warm-up and 2 timed calls, in turns with (d)'s, B1 120 per call all at
     [128, 64, 1024], poses [4, 32, 64, 120, 3] finite, past the log no
     agent forced and the TL NLL masked; (b) `make_train_step` at the preset's batch of 1: one
     warm-up and 2 timed steps, B1 241 per step at [1, 64, 1024] (the
     rollout, its recompute, the posterior encoder), loss and grad_norm
     finite, every parameter a finite non-zero gradient but the action
     head's log_std; (c) `make_validate_step`, 4 scenarios x K=32: a warm-up
     and one step split by part, B1 120 + 121; (d) `joint_future_pred` with
     use_pallas=True, one warm-up and 2 timed calls in turns with (a)'s
     (a d d a): B1 120, B4 12 and B2 720 per call, every B4 on the heads
     route and every B2 on the cluster route, none on the general route, at
     shapes phase 3 checked (B4 [4, 1024, 32, 256, 256, 8], B2 [128, 64, 89,
     256, 256, 8]); the first B4 and the first B2 launch of its warm-up call,
     captured, against the float32 plain versions on their own inputs at
     phase 3's bf16 tolerance;
     (e) the phase-4 config rolled out to 40 steps against its 31 logged:
     the training step's gradients (phase 7's check) and the validation step
     with reactive replay's buffer (phase 9's) card vs CPU. (a)-(d) log
     seconds and peak memory.
Then it prints the `kernels` JSON line (forward launches from phase 6 and, as
`validate_launches`, from phase 9; training-shape and backward ones from phase
8, B4's and the backwards' by route; `fit_launches` per full-width fit step
from phase 11; `reference_layout_launches` from phase 12 (b); `scaled_launches`
per call or step of each path of phase 13; B3's `general_route`, B4's
`heads_route` and B2's `cluster_route` times at the scaled preset's shapes,
the latter two with their launches per phase 13 (d) call), the card line, and last
`{"ok": true, "device": {...}}`.
Imports nothing of JAX.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
import math
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from trafficbotsv15_tpu_torch import run as run_lib
from trafficbotsv15_tpu_torch.config import leaderboard_config, scaled_config, tiny_config, with_pallas
from trafficbotsv15_tpu_torch.data import tbcache
from trafficbotsv15_tpu_torch.data.preprocessing import pre_processing
from trafficbotsv15_tpu_torch.data.synthetic import make_batch
from trafficbotsv15_tpu_torch.eval import runner as eval_runner
from trafficbotsv15_tpu_torch.eval import wosac_likelihood
from trafficbotsv15_tpu_torch.eval.wosac_post_processing import filter_futures
from trafficbotsv15_tpu_torch.ops import knarpe, knn
from trafficbotsv15_tpu_torch.sim import rollout as rollout_lib
from trafficbotsv15_tpu_torch.train import checkpoint as checkpoint_lib
from trafficbotsv15_tpu_torch.train import evaluation as eval_lib
from trafficbotsv15_tpu_torch.train import pipeline as train_lib
from trafficbotsv15_tpu_torch.train import swa as swa_lib
from trafficbotsv15_tpu_torch.train.evaluation import joint_future_pred
from trafficbotsv15_tpu_torch.train.optimizer import make_optimizer
from trafficbotsv15_tpu_torch.train.pipeline import build_model
from trafficbotsv15_tpu_torch.utils.timing import cuda_ms, graph_ms

HBM_BYTES_PER_S = 3.35e12  # H100 SXM (NVIDIA data sheet, 700 W)
FP32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
BF16_FLOPS = 989e12  # H100 SXM bf16 on the tensor cores, dense
KNN_ROWS, KNN_SRC, KNN_TGT, KNN_K = 128, 64, 1024, 64  # 4 scenarios x 32 futures, agents, polylines, 2.0 * 32
KNN_TRAIN_ROWS = 8  # the training path's agent->map launch: 8 scenarios, no K-fold replication
SLICE_POSE_ATOL = 1e-3  # m; float32 on card vs CPU, reduction order only
# KNARPE shapes (n_b, n_s, K, D, R, H) on the full-width path: the agent decoder's
# cross-attention (128 rollouts x 64 agents, 64 map + 25 TL targets) and the map encoder
X_PATH = (128, 64, 89, 128, 128, 4)
ATTN_PATH = (4, 1024, 32, 128, 128, 4)
# and on the training path (8 scenarios, no K-fold replication): the agent decoder's B2 and its
# backward at 8 x 64 sources, the map encoder's B4 and its backward at 8 x 1024
TRAIN_X_PATH = (8, 64, 89, 128, 128, 4)
TRAIN_ATTN_PATH = (8, 1024, 32, 128, 128, 4)
# the training path's posterior encoders: the agent encoder's B2 at TRAIN_X_PATH, the TL encoder's
# at 8 x 128 TL lanes over K=24 map targets (0.75 x 32)
POST_TL_X_PATH = (8, 128, 24, 128, 128, 4)
# and the training entry point's (phase 11: `run.fit` at the flagship's batch_size_train=2): the agent decoder's
# B2 and its backward at 2 x 64, the posterior TL encoder's at 2 x 128 over K=24, the map encoder's B4 and its
# backward at 2 x 1024; B1 at [2, 64, 1024]; and its validation's (4 scenarios, as phase 9's): reactive replay's
# B2 at 4 x 64 and its posterior TL encoder's at 4 x 128, B1 at [4, 64, 1024]
FIT_X = [(2, 64, 89, 128, 128, 4), (2, 128, 24, 128, 128, 4)]
VAL_X = [(4, 64, 89, 128, 128, 4), (4, 128, 24, 128, 128, 4)]
FIT_ATTN_PATH = (2, 1024, 32, 128, 128, 4)
FIT_KNN = [(2, 64, 1024, 64), (4, 64, 1024, 64)]
# edge cases: an all-invalid and a one-target source in each; source counts that are
# no multiple of any tile; odd K; one and eight heads
X_EDGE = [(3, 7, 5, 16, 16, 2), (1, 33, 89, 32, 16, 8)]
ATTN_EDGE = [(3, 7, 5, 16, 16, 2), (2, 17, 89, 64, 32, 1)]
# bf16 B4 and B4-bwd shapes phase 3 holds on the staged route (csrc/knarpe_attn_staged.cuh,
# csrc/knarpe_attn_bwd_staged.cuh) besides the paths' and ATTN_EDGE: K=5 and K=24 (no multiple of 16) at
# 97 sources (under the 132-block grid, no multiple of the four groups or the ring), a single source and
# 8 x 1024 + 7 sources; and an eight-head shape the staged kernels refuse, on the general route
ATTN_STAGED_EDGE = [(1, 97, 5, 128, 128, 4), (1, 97, 24, 64, 64, 2), (1, 1, 32, 128, 128, 4),
                    (1, 8199, 32, 128, 128, 4), FIT_ATTN_PATH]
ATTN_GENERAL = [(1, 33, 89, 32, 16, 8)]
# the scaled preset's map encoder (4 scenarios x 1024 polylines, D=R=256, 8 heads): B4 forward on the heads route
SCALED_ATTN_PATH = (4, 1024, 32, 256, 256, 8)
# and its training path's (batch 1): B4 forward timed there on the heads route, B4-bwd on the general route
# (csrc/knarpe_bwd.cu)
SCALED_TRAIN_ATTN_PATH = (1, 1024, 32, 256, 256, 8)
# bf16 B4 on the heads route (csrc/knarpe_attn_heads.cuh) at D=R=256, 8 heads: both scaled shapes, K=5 and K=24
# (no multiple of 16) and K=40 (the largest its shared memory takes) at 97 sources (no multiple of the grid or the
# groups), a single source (fewer than the grid's slots) and 8 x 1024 + 7 sources; each has an all-invalid and a
# one-target source and runs with k and v the halves of one tensor and as two tensors
HEADS_ATTN = [SCALED_ATTN_PATH, SCALED_TRAIN_ATTN_PATH, (1, 97, 5, 256, 256, 8), (1, 97, 24, 256, 256, 8),
              (1, 97, 40, 256, 256, 8), (1, 1, 32, 256, 256, 8), (1, 8199, 32, 256, 256, 8)]
# and the general route where the heads kernel refuses too, by its refusal code: K=89 at D=R=256, 8 heads (its
# shared memory, code 3), and ATTN_GENERAL's eight heads at other widths (widths it is not compiled for, code 2)
GENERAL_B4 = {(1, 33, 89, 256, 256, 8): 3, ATTN_GENERAL[0]: 2}
# bf16 B2 backward shapes phase 3 holds on the staged route (csrc/knarpe_bwd_staged.cuh) besides the
# training path's: K not a multiple of 16 with an all-invalid source at 21 sources (under the 132-block
# grid), and 200 sources (no multiple of the grid); and the eight-head edge shape the staged backward
# refuses, which takes the general route (csrc/knarpe_bwd.cu)
X_BWD_EDGE = [(3, 7, 5, 16, 16, 2), (2, 100, 40, 128, 128, 4), *FIT_X]
X_BWD_GENERAL = [X_EDGE[1]]
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
# validation step, card vs CPU in float32 (phase 9): the rollout buffers to SLICE_POSE_ATOL, the rule flags
# to RULE_FLAG_SHARE; loss terms, error and rule sums, WOMD modes and scores, native motion metrics and the
# realism fields to 1e-4 relative (1e-6 absolute near zero; modes also SLICE_POSE_ATOL absolute). The joint
# futures are more than the 32 the WOSAC filter keeps, so that it selects
VALIDATE_REL, VALIDATE_K = 1e-4, 34


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def knn_case(gen, n_rows, n_src, n_tgt, grid=False, p_src=0.2, p_tgt=0.2):
    src = torch.rand(n_rows, n_src, 2, generator=gen) * 200 - 100
    tgt = torch.rand(n_rows, n_tgt, 2, generator=gen) * 200 - 100
    if grid:  # integer grid: exact squares and many distance ties
        src, tgt = (src / 10).round() * 10, (tgt / 10).round() * 10
    src_inv = torch.rand(n_rows, n_src, generator=gen) < p_src
    tgt_inv = torch.rand(n_rows, n_tgt, generator=gen) < p_tgt
    return [t.cuda().contiguous() for t in (src, src_inv, tgt, tgt_inv)]


def time_knn(args, k: int) -> dict:
    """Kernel B1 (eager, and device time from a CUDA graph), its plain version and torch.topk on the
    materialised distances at one shape, with the bound."""
    ms = cuda_ms(lambda: knn.knn_xy(*args, k), 200)
    device_ms = graph_ms(lambda: knn.knn_xy(*args, k))
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
    log(f"  knn_xy timing at [{n_rows},{n_src},{n_tgt}] k={k}: kernel {ms:.4f} ms ({device_ms:.4f} ms of device "
        f"time, launched from a CUDA graph), plain {plain_ms:.4f} ms, torch.topk on materialised distances "
        f"{library_ms:.4f} ms, bound {bound_ms * 1e3:.2f} us ({bytes_moved / 1e6:.2f} MB), kernel at "
        f"{100 * bound_ms / ms:.2f}% of the bound")
    return {"shape": [n_rows, n_src, n_tgt, k], "ms": ms, "device_ms": device_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": "bytes" if t_bytes >= t_ops else "operations", "library_ms": library_ms}


# B1 cases phase 3 checks, name: (rows, sources, targets, k, knn_case options)
KNN_CASES = {
    "main_path_float": (KNN_ROWS, KNN_SRC, KNN_TGT, KNN_K, {}),
    "integer_grid_ties": (KNN_ROWS, KNN_SRC, KNN_TGT, KNN_K, dict(grid=True)),
    "invalid_rows_and_targets": (8, 64, 1024, KNN_K, dict(grid=True, p_src=0.3, p_tgt=0.97)),
    "k_equals_n_tgt": (2, 8, 128, 128, {}),
    "training_shape": (KNN_TRAIN_ROWS, KNN_SRC, KNN_TGT, KNN_K, {}),
    "all_targets_at_one_point": (4, 64, 1024, KNN_K, dict(p_tgt=0.0)),
    "k_1": (16, 64, 1024, 1, dict(grid=True)),
    "k_equals_n_tgt_1024": (4, 16, 1024, 1024, dict(grid=True)),
    "n_tgt_1000": (8, 64, 1000, KNN_K, {}),
    "n_tgt_2048": (4, 64, 2048, KNN_K, dict(grid=True)),
    "every_source_invalid": (4, 64, 1024, KNN_K, dict(p_src=1.0)),
    "scaled_training_shape": (1, KNN_SRC, KNN_TGT, KNN_K, {}),  # the scaled preset's batch_size_train=1
    **{f"entry_{rows}x{src}_k{k}": (rows, src, tgt, k, {}) for rows, src, tgt, k in FIT_KNN},
}


def check_knn_kernel() -> dict:
    """Kernel B1 vs its plain version: identical indices, bit-equal distances; timed at the eval and
    the training path's shapes."""
    gen = torch.Generator().manual_seed(0)
    cases = {name: (knn_case(gen, rows, src, tgt, **kw), k) for name, (rows, src, tgt, k, kw) in KNN_CASES.items()}
    src_inv, tgt_inv = cases["invalid_rows_and_targets"][0][1::2]
    tgt_inv[0] = True  # a row with no valid target: every source emits its +inf tail
    src_inv[1, 5] = True  # an invalid source in another row
    cases["all_targets_at_one_point"][0][2][:] = torch.tensor([3.0, -7.0], device="cuda")  # every distance tied
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

    row = time_knn(*cases["main_path_float"])
    train = time_knn(*cases["training_shape"])
    row.pop("shape")
    return {"name": "knn_xy", "route": "cuda", "source": "trafficbotsv15_tpu_torch/csrc/knn.cu",
            "replaces": "trafficbotsv15_tpu/ops/pallas_knn.py:143", "launches": None, "max_abs_err": max_err,
            **row, "training_shape": train}


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


def check_one_knarpe(name: str, shape, seed: int, want_route: str = "staged", separate_kv: bool = False) -> tuple:
    """Kernel vs plain version in float32 and bfloat16, bf16 on want_route; B4's k and v the halves of one
    tensor, or with separate_kv two tensors; returns the float32 and the bf16 max |err| (the bf16 one against
    the reference the tolerance is taken from)."""
    kernel, plain = getattr(knarpe, name), getattr(knarpe, f"{name}_reference")
    cross, n_head = name != "knarpe_attention", shape[-1]
    args = knarpe_inputs(shape, cross, seed)
    if separate_kv:
        args[1], args[2] = args[1].contiguous(), args[2].contiguous()
    out = kernel(*args, n_head)
    torch.cuda.synchronize()
    ref = plain(*args, n_head)
    err = float((out - ref).abs().max())
    if not (torch.isfinite(out).all() and err <= KNARPE_F32_ATOL and torch.all(out[0, 0] == 0)):
        raise AssertionError(f"{name} {shape} float32: max |err| {err} (tolerance {KNARPE_F32_ATOL}), "
                             f"all-invalid source zero: {bool(torch.all(out[0, 0] == 0))}")
    a16 = [a if a.dtype == torch.bool else a.to(torch.bfloat16) for a in args]
    before = dict(knarpe.ROUTE_LAUNCHES)
    out16 = kernel(*a16, n_head).float()
    torch.cuda.synchronize()
    took = [key.split("/")[1] for key, n in knarpe.ROUTE_LAUNCHES.items() if n != before[key]]
    if took != [want_route]:
        raise AssertionError(f"{name} {shape} bf16: launched on the {took} route, expected {want_route}")
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
    if not torch.equal(kernel(*a16, n_head).float(), out16):  # no bf16 kernel has atomics
        raise AssertionError(f"{name} {shape} bf16: two launches on the same inputs differ")
    note += f"; {want_route} route, two launches bit-identical" + ("; k and v two tensors" if separate_kv else "")
    err16 = float((out16 - ref16).abs().max())
    log(f"  {name} {list(shape)} (n_b, n_s, K, D, R, H): float32 max |err| {err:.3e} (tolerance "
        f"{KNARPE_F32_ATOL}); bf16 max |err| {err16:.3e}, within {rtol:g} relative + {atol:.3g} absolute{note}; "
        f"all-invalid source zero")
    return err, err16


def time_knarpe(name: str, shape) -> dict:
    """Kernel, plain version and library composition at one shape (bf16), with the bound. The kernel's
    eager time includes the host's launch cost where that is longer (the training path's small
    launches), so its device time from a CUDA graph of 50 launches is logged beside it."""
    kernel, plain = getattr(knarpe, name), getattr(knarpe, f"{name}_reference")
    n_head = shape[-1]
    args = knarpe_inputs(shape, name != "knarpe_attention", seed=1, dtype=torch.bfloat16)
    ms = cuda_ms(lambda: kernel(*args, n_head), 50)
    device_ms = graph_ms(lambda: kernel(*args, n_head))
    plain_ms = cuda_ms(lambda: plain(*args, n_head), 10)
    library_ms = cuda_ms(lambda: knarpe_library_call(name, args, n_head), 20)
    nbytes, ops = knarpe_bound(name, args, n_head)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / BF16_FLOPS * 1e3
    bound_ms = max(t_bytes, t_ops)
    log(f"  {name} timing at {list(shape)} bf16: kernel {ms:.4f} ms ({device_ms:.4f} ms of device time, launched "
        f"from a CUDA graph), plain {plain_ms:.4f} ms, "
        f"matmul + scaled_dot_product_attention {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
        f"({nbytes / 1e6:.1f} MB, {ops / 1e9:.3f} GFLOP), kernel at {100 * bound_ms / ms:.2f}% of the bound")
    return {"ms": ms, "device_ms": device_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations", "library_ms": library_ms}


# bf16 B2/B3 shapes that phase 3 holds against the plain versions on the staged route; phases 6 and 8
# check that the paths launch no other
CHECKED_X = {s[2:] for s in (X_PATH, TRAIN_X_PATH, POST_TL_X_PATH, *X_EDGE, *FIT_X, *VAL_X)}
# bf16 B2/B3 shapes the staged kernel refuses: the scaled preset's widths (D=R=256, 8 heads), at its eval
# shape (4 scenarios x 32 futures x 64 agents, K=89) too, and K=90 and K=128 at the flagship's D=R=128, H=4.
# B3 takes the general route there (csrc/knarpe.cu), timed at the scaled preset's eval shape
SCALED_X_PATH = (128, 64, 89, 256, 256, 8)
GENERAL_X = [(2, 64, 89, 256, 256, 8), SCALED_X_PATH, (2, 64, 90, 128, 128, 4), (2, 64, 128, 128, 128, 4)]
# B2 the cluster route (csrc/knarpe_cluster.cuh) at D=R=256, 8 heads: the eval shape, the scaled training path's
# (batch 1 x 64 agents), K=5 and K=24 (no multiple of 16) and K=104 (the largest its shared memory takes) at 21
# sources, a single source (fewer than the clusters), and 8192 + 7 sources (no multiple of the grid); each has an
# all-invalid and a one-target source. Timed at the scaled preset's eval shape
SCALED_TRAIN_X_PATH = (1, 64, 89, 256, 256, 8)
CLUSTER_X = [SCALED_X_PATH, (2, 64, 89, 256, 256, 8), SCALED_TRAIN_X_PATH, (1, 21, 5, 256, 256, 8),
             (1, 21, 24, 256, 256, 8), (1, 21, 104, 256, 256, 8), (1, 1, 89, 256, 256, 8), (1, 8199, 89, 256, 256, 8)]
# and the general route where the cluster kernel refuses too, by its refusal code: K=120 at D=R=256, 8 heads (its
# shared memory, code 3), K=90 and K=128 at D=R=128 (widths it is not compiled for, code 2)
GENERAL_B2_X = {(2, 64, 120, 256, 256, 8): 3, (2, 64, 90, 128, 128, 4): 2, (2, 64, 128, 128, 128, 4): 2}


def check_knarpe_kernels() -> list:
    """Kernels B4, B2, B3 vs their plain versions at the paths' and edge shapes; times at the eval
    path's shapes (the row) and at the training path's (B4: the row's `training_shape`; B2, B3: logged)
    (bf16)."""
    rows = []
    for name, path, edges, replaces, source in (
            ("knarpe_attention", ATTN_PATH, ATTN_EDGE + [TRAIN_ATTN_PATH, *ATTN_STAGED_EDGE],
             "trafficbotsv15_tpu/ops/pallas_knarpe.py:243", "trafficbotsv15_tpu_torch/csrc/knarpe_attn_staged.cuh"),
            ("knarpe_cross_attention", X_PATH, X_EDGE + [TRAIN_X_PATH, POST_TL_X_PATH, *FIT_X, *VAL_X],
             "trafficbotsv15_tpu/ops/pallas_knarpe.py:443", "trafficbotsv15_tpu_torch/csrc/knarpe_staged.cuh"),
            ("knarpe_cross_attention_v3", X_PATH, X_EDGE + [TRAIN_X_PATH, POST_TL_X_PATH, *FIT_X, *VAL_X],
             "trafficbotsv15_tpu/ops/pallas_knarpe.py:742", "trafficbotsv15_tpu_torch/csrc/knarpe_staged.cuh")):
        max_err = check_one_knarpe(name, path, seed=1)[0]
        for i, shape in enumerate(edges):
            check_one_knarpe(name, shape, seed=2 + i)
        row = time_knarpe(name, path)
        if name == "knarpe_attention":
            row["training_shape"] = {"shape": list(TRAIN_ATTN_PATH), **time_knarpe(name, TRAIN_ATTN_PATH)}
            # bf16 only: float32 B4 takes the general kernel at these shapes, which check_one_knarpe holds too
            err16 = max(check_one_knarpe(name, shape, seed=20 + i, want_route="heads", separate_kv=separate)[1]
                        for separate in (False, True) for i, shape in enumerate(HEADS_ATTN))
            row["heads_route"] = {"name": "knarpe_attention", "route": "cuda",
                                  "source": "trafficbotsv15_tpu_torch/csrc/knarpe_attn_heads.cuh",
                                  "replaces": replaces, "shape": list(SCALED_ATTN_PATH), "launches": None,
                                  "max_abs_err": err16, **time_knarpe(name, SCALED_ATTN_PATH)}
            row["heads_route"]["scaled_training_shape"] = {"shape": list(SCALED_TRAIN_ATTN_PATH),
                                                           **time_knarpe(name, SCALED_TRAIN_ATTN_PATH)}
            for i, (shape, code) in enumerate(GENERAL_B4.items()):
                got = knarpe.heads_refusal(*shape[2:], torch.cuda.current_device())
                if got != code:
                    raise AssertionError(f"{name} {shape}: the heads kernel's refusal code {got}, expected {code}")
                log(f"  {name} {list(shape)}: the heads kernel refuses it with code {got} "
                    f"({knarpe.HEADS_REFUSALS[got]}), so it takes the general route")
                check_one_knarpe(name, shape, seed=40 + i, want_route="general")
        elif name == "knarpe_cross_attention":
            time_knarpe(name, TRAIN_X_PATH)
            # bf16 only: float32 B2 takes the general kernel at these shapes, which check_one_knarpe holds too
            err16 = max(check_one_knarpe(name, shape, seed=20 + i, want_route="cluster")[1]
                        for i, shape in enumerate(CLUSTER_X))
            row["cluster_route"] = {"name": "knarpe_cross_attention", "route": "cuda",
                                    "source": "trafficbotsv15_tpu_torch/csrc/knarpe_cluster.cuh",
                                    "replaces": replaces, "shape": list(SCALED_X_PATH), "launches": None,
                                    "max_abs_err": err16, **time_knarpe(name, SCALED_X_PATH)}
            row["cluster_route"]["scaled_training_shape"] = {"shape": list(SCALED_TRAIN_X_PATH),
                                                             **time_knarpe(name, SCALED_TRAIN_X_PATH)}
            for i, (shape, code) in enumerate(GENERAL_B2_X.items()):
                got = knarpe.cluster_refusal(*shape[2:], torch.cuda.current_device())
                if got != code:
                    raise AssertionError(f"{name} {shape}: the cluster kernel's refusal code {got}, expected {code}")
                check_one_knarpe(name, shape, seed=40 + i, want_route="general")
        else:
            time_knarpe(name, TRAIN_X_PATH)
            for i, shape in enumerate(GENERAL_X):
                check_one_knarpe(name, shape, seed=20 + i, want_route="general")
            row["general_route"] = {"source": "trafficbotsv15_tpu_torch/csrc/knarpe.cu", "shape": list(SCALED_X_PATH),
                                    **time_knarpe(name, SCALED_X_PATH)}
        rows.append({"name": name, "route": "cuda", "source": source, "replaces": replaces, "launches": None,
                     "max_abs_err": max_err, **row})
    return rows


# bf16 B4 shapes that phase 3 holds against the plain version on the staged route, forward and backward
CHECKED_ATTN = {s[2:] for s in (ATTN_PATH, TRAIN_ATTN_PATH, *ATTN_EDGE, *ATTN_STAGED_EDGE)}


@contextlib.contextmanager
def recorded_forward_shapes():
    """The (kernel, dtype, K, D, R, H) of every B4, B2 and B3 forward launch inside the block."""
    real, seen = knarpe._launch, set()

    def recorder(kernel, q, k, v, tgt, rpe, invalid, w_kv, w_rpe, b, n_head):
        seen.add((kernel, q.dtype, rpe.shape[2], q.shape[2], rpe.shape[3], n_head))
        return real(kernel, q, k, v, tgt, rpe, invalid, w_kv, w_rpe, b, n_head)

    knarpe._launch = recorder
    try:
        yield seen
    finally:
        knarpe._launch = real


def check_path_forward_shapes(where: str, seen: set) -> None:
    """Every B4 and B2 launch of a path was in bf16 at a shape phase 3 checked on the staged route."""
    for kernel, dtype, *k_d_r_h in sorted(seen, key=str):
        checked = CHECKED_ATTN if kernel == "knarpe_attention" else CHECKED_X
        if dtype != torch.bfloat16 or tuple(k_d_r_h) not in checked:
            raise AssertionError(f"{where}: {kernel} launched in {dtype} at (K, D, R, H)={tuple(k_d_r_h)}, "
                                 f"which phase 3 did not check")
    log(f"  {where}: B4 and B2 launched at (kernel, K, D, R, H) {sorted((s[0], *s[2:]) for s in seen)}, each "
        f"checked in phase 3 on the staged route")


# bf16 B2 backward shapes that phase 3 holds against autograd of the plain version on the staged route;
# phase 8 checks that the training step launches no other
CHECKED_X_BWD = {s[2:] for s in (TRAIN_X_PATH, POST_TL_X_PATH, *X_BWD_EDGE)}


@contextlib.contextmanager
def recorded_bwd_shapes():
    """Counts of the B4 and B2 backward launches inside the block by (kernel, K, D, R, H); bf16 only."""
    real, seen = knarpe._launch_bwd, collections.Counter()

    def recorder(kernel, q, k, v, tgt, rpe, invalid, w_kv, w_rpe, b, g, n_head):
        if q.dtype != torch.bfloat16:
            raise AssertionError(f"{kernel} backward launched in {q.dtype}, expected bf16")
        seen[(kernel, rpe.shape[2], q.shape[2], rpe.shape[3], n_head)] += 1
        return real(kernel, q, k, v, tgt, rpe, invalid, w_kv, w_rpe, b, g, n_head)

    knarpe._launch_bwd = recorder
    try:
        yield seen
    finally:
        knarpe._launch_bwd = real


def check_path_bwd_shapes(where: str, seen) -> None:
    """Every B4 and B2 backward launch of a path was at a shape phase 3 checked on the staged route."""
    unchecked = [key for key in seen if key[1:] not in (CHECKED_ATTN if key[0] == "knarpe_attention" else CHECKED_X_BWD)]
    if unchecked:
        raise AssertionError(f"{where}: backward launched at (kernel, K, D, R, H) {sorted(unchecked)}, which phase 3 "
                             f"did not check")
    log(f"  {where}: B4 and B2 backward launches by (kernel, K, D, R, H) {dict(seen)}, each shape checked in "
        f"phase 3 on the staged route")


def check_staged_route(where: str) -> None:
    """Every bf16 B4, B2 and B3 forward launch and every B4 and B2 backward launch since the last reset
    took the staged route: the flagship must not slide onto the slower general kernels unseen."""
    routes = dict(knarpe.ROUTE_LAUNCHES)
    if (any(routes[f"{kernel}/staged"] != n for kernel, n in knarpe.LAUNCHES.items())
            or any(v for key, v in routes.items() if key.endswith("/general"))):
        raise AssertionError(f"{where}: launches by route {routes}, expected all of {knarpe.LAUNCHES} on the "
                             f"staged route")


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


def check_one_knarpe_bwd(name: str, shape, seed: int, want_route: str = "staged") -> float:
    """Backward kernel vs autograd of the plain version, float32 and bf16, the bf16 backward on want_route
    and bit-identical on a second launch; returns the float32 max |err|."""
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
    before = dict(knarpe.ROUTE_LAUNCHES)
    got16 = _kernel_bwd(name, a16, g.to(torch.bfloat16), n_head)
    bwd = "knarpe_attention_bwd" if name == "knarpe_attention" else "knarpe_cross_attention_bwd"
    took = [key.split("/")[1] for key, n in knarpe.ROUTE_LAUNCHES.items()
            if key.startswith(f"{bwd}/") and n != before[key]]
    if took != [want_route]:
        raise AssertionError(f"{name} backward {shape} bf16: launched on the {took} route, expected {want_route}")
    want32 = _plain_bwd(name, [a if a.dtype == torch.bool else a.float() for a in a16], g.bfloat16().float(), n_head)
    for a, b in zip(got16, want32):
        tol = BF16_HALF_ULP * b.abs() + KNARPE_BWD_F32_REL * float(b.abs().max())
        if not (a.dtype == torch.bfloat16 and bool(((a.float() - b).abs() <= tol).all())):
            raise AssertionError(f"{name} backward {shape} bf16: |err| above 2^-8 relative + 1e-4 of the max")
    if not all(torch.all(x[0, 0] == 0) for x in got16[:2]):
        raise AssertionError(f"{name} backward {shape} bf16: the all-invalid source has non-zero gradients")
    if not all(torch.equal(a, b) for a, b in zip(_kernel_bwd(name, a16, g.to(torch.bfloat16), n_head), got16)):
        raise AssertionError(f"{name} backward {shape} bf16: two launches on the same inputs differ")
    log(f"  {name} backward {list(shape)}: output has a grad_fn; float32 max |err| {max_err:.3e}, "
        f"{worst:.2e} of the largest gradient (tolerance {KNARPE_BWD_F32_REL:g}); bf16 within 2^-8 relative + "
        f"1e-4 of the largest, {want_route} route, two launches bit-identical; all-invalid source zero")
    return max_err


def time_knarpe_bwd(name: str, shape) -> dict:
    """A backward launch (`_launch_bwd`, bf16) eager and as device time from a CUDA graph, its plain
    version and the library composition's backward, with the bound, at one shape."""
    n_head = shape[-1]
    args = knarpe_inputs(shape, name != "knarpe_attention", seed=11, dtype=torch.bfloat16)
    g = torch.randn(args[0].shape, generator=torch.Generator().manual_seed(3)).to("cuda", torch.bfloat16)
    if name == "knarpe_attention":
        q, k, v, rpe, inv, w, b = args
        kernel = lambda: knarpe._launch_bwd(name, q, k, v, None, rpe, inv, None, w, b, g, n_head)
    else:
        q, tgt, rpe, inv, w_kv, w_rpe, b = args
        kernel = lambda: knarpe._launch_bwd(name, q, None, None, tgt, rpe, inv, w_kv, w_rpe, b, g, n_head)
    way = knarpe.bwd_route(name, torch.bfloat16, *shape[2:], torch.cuda.current_device())
    ms = cuda_ms(kernel, 20)
    device_ms = graph_ms(kernel)
    plain_ms = cuda_ms(lambda: _plain_bwd(name, args, g, n_head), 5)
    leaves = [a.clone().requires_grad_(a.is_floating_point()) for a in args]
    lib_out = knarpe_library_call(name, leaves, n_head)
    want = [a for a in leaves if a.requires_grad]
    library_ms = cuda_ms(lambda: torch.autograd.grad(lib_out, want, g, retain_graph=True), 10)
    nbytes, ops = knarpe_bwd_bound(name, args, g, n_head)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / BF16_FLOPS * 1e3
    bound_ms = max(t_bytes, t_ops)
    log(f"  {name} backward timing at {list(shape)} bf16, {way} route: kernel {ms:.4f} ms ({device_ms:.4f} ms of "
        f"device time, launched from a CUDA graph), plain (autograd through the plain forward) {plain_ms:.4f} ms, "
        f"backward of matmul + scaled_dot_product_attention {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
        f"({nbytes / 1e6:.1f} MB, {ops / 1e9:.3f} GFLOP), kernel at {100 * bound_ms / ms:.2f}% of the bound "
        f"({100 * bound_ms / device_ms:.2f}% by device time)")
    return {"kernel_route": way, "ms": ms, "device_ms": device_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations", "library_ms": library_ms}


def check_knarpe_bwd_kernels() -> list:
    """B4-bwd, B2-bwd and B3's backward (B2-bwd through B3's Function) vs autograd of the plain
    versions at the training path's and edge shapes, bf16 on the staged route where it takes the shape
    and on the general route at the shapes it refuses; B4-bwd timed at the training path's shape, B2-bwd
    at both of its training shapes (bf16)."""
    rows = []
    for name, path, edges, replaces in (
            ("knarpe_attention", TRAIN_ATTN_PATH, ATTN_EDGE + ATTN_STAGED_EDGE,
             "trafficbotsv15_tpu/ops/pallas_knarpe.py:293"),
            ("knarpe_cross_attention", TRAIN_X_PATH, X_BWD_EDGE, "trafficbotsv15_tpu/ops/pallas_knarpe.py:579")):
        cross = name != "knarpe_attention"
        max_err = check_one_knarpe_bwd(name, path, seed=11)
        for i, shape in enumerate(edges):
            check_one_knarpe_bwd(name, shape, seed=12 + i)
        if not cross:
            for i, shape in enumerate(ATTN_GENERAL):
                check_one_knarpe_bwd(name, shape, seed=30 + i, want_route="general")
        if cross:
            check_one_knarpe_bwd(name, POST_TL_X_PATH, seed=14, want_route="staged")
            for i, shape in enumerate(X_BWD_GENERAL):
                check_one_knarpe_bwd(name, shape, seed=17 + i, want_route="general")
            for i, shape in enumerate([path, POST_TL_X_PATH, *X_BWD_EDGE]):
                check_one_knarpe_bwd("knarpe_cross_attention_v3", shape, seed=20 + i, want_route="staged")
        row = time_knarpe_bwd(name, path)
        # the scaled preset's training shape (batch 1, D=R=256, 8 heads), which the staged backwards refuse (more
        # than 4 heads): timed on the general route, where the layout of csrc/knarpe_bwd.cu fits (the weights read
        # through L1/L2)
        scaled = SCALED_TRAIN_X_PATH if cross else SCALED_TRAIN_ATTN_PATH
        row["scaled_training_shape"] = {"shape": list(scaled), **time_knarpe_bwd(name, scaled)}
        if row["scaled_training_shape"]["kernel_route"] != "general":
            raise AssertionError(f"{name} backward at {list(scaled)}: {row['scaled_training_shape']['kernel_route']} "
                                 f"route, expected general")
        source = "trafficbotsv15_tpu_torch/csrc/knarpe_bwd_staged.cuh" if cross else \
            "trafficbotsv15_tpu_torch/csrc/knarpe_attn_bwd_staged.cuh"
        rows.append({"name": f"{name}_bwd", "route": "cuda", "source": source, "replaces": replaces, "launches": None,
                     "max_abs_err": max_err, **row})
        if cross:
            rows[-1]["post_tl_shape"] = {"shape": list(POST_TL_X_PATH), **time_knarpe_bwd(name, POST_TL_X_PATH)}
    return rows


def reset_launches() -> None:
    knn.LAUNCHES = 0
    for counts in (knarpe.LAUNCHES, knarpe.ROUTE_LAUNCHES):
        for name in counts:
            counts[name] = 0


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


def run_full_width(card: str, use_pallas: bool, n_timed: int = 2, replay_rules: bool = False) -> dict:
    cfg = with_pallas(leaderboard_config(), use_pallas)
    n_sc, k = 4, cfg.n_joint_future_wosac
    batch = make_batch(cfg.data, n_sc=n_sc, seed=0)
    model = build_model(cfg, seed=0, device="cuda")
    gen = torch.Generator().manual_seed(0)
    n_params = sum(p.numel() for p in model.parameters())
    t0 = time.perf_counter()
    with recorded_forward_shapes() as seen:
        joint_future_pred(cfg, model, batch, generator=gen, check_level=1)
    torch.cuda.synchronize()
    log(f"  warm-up call {time.perf_counter() - t0:.3f} s ({n_params} parameters, bf16 compute)")
    if use_pallas:
        check_path_forward_shapes("eval call", seen)
    torch.cuda.reset_peak_memory_stats()
    times, per_call = [], []
    for _ in range(n_timed):
        reset_launches()
        t0 = time.perf_counter()
        _, buf = joint_future_pred(cfg, model, batch, generator=gen, check_level=1)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        per_call.append(launches())
        check_staged_route("eval call")
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
        f"agent-steps flagged {flags}, launches by route {knarpe.ROUTE_LAUNCHES} [{card}]")
    routes = dict(knarpe.ROUTE_LAUNCHES)
    if replay_rules:
        replay_rule_checks_on_cpu(cfg, model, batch, gen)
    return per_call[-1], routes


def no_dropout(cfg):
    """cfg with every dropout rate at 0: CPU and CUDA generators draw different masks from one seed."""
    m = cfg.model
    return dataclasses.replace(cfg, model=dataclasses.replace(
        m, tf_cfg=dataclasses.replace(m.tf_cfg, dropout_p=0.0),
        mp_encoder=dataclasses.replace(m.mp_encoder, pl_encoder=dataclasses.replace(m.mp_encoder.pl_encoder,
                                                                                      mlp_dropout_p=0.0)),
        add_navi_latent=dataclasses.replace(m.add_navi_latent, mlp_dropout_p=0.0)))


def check_train_step_card_vs_cpu(use_pallas: bool, time_step_end: int = None) -> None:
    """One make_train_step on the card and on the CPU: same weights, same draws, no dropout. time_step_end past
    the log's 30 steps takes the TL pass step by step (phase 13 (e))."""
    cfg = with_pallas(no_dropout(horizon(phase4_config(), time_step_end)), use_pallas)
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
    log(f"  use_pallas={use_pallas}, {cfg.time_step_end} steps: card vs CPU, loss {m_gpu['training/loss']:.6f} vs "
        f"{m_cpu['training/loss']:.6f}, "
        f"grad_norm {m_gpu['grad_norm']:.6f} vs {m_cpu['grad_norm']:.6f}, loss terms and grad_norm within "
        f"{loss_err:.2e} relative (tolerance {TRAIN_LOSS_REL:g}); {len(g_cpu)} parameter gradients within "
        f"{worst:.2e} of their scale (worst {worst_name}; tolerance {TRAIN_GRAD_REL:g}; scale floored at "
        f"{TRAIN_GRAD_FLOOR:g} of the model's largest, {floor:.3e}, for {n_floored} of them); {len(norm_tgt)} "
        f"folded norm_tgt_scale gradients non-zero; launches {expected_train_launches(cfg)} as the config implies")


def run_train_full_width(card: str, n_timed: int = 2) -> dict:
    """leaderboard_config() training with use_pallas=True, 8 scenarios per step, bf16 compute."""
    cfg = with_pallas(leaderboard_config(), True)
    n_sc = 8
    model = build_model(cfg, seed=0, device="cuda")
    step = train_lib.make_train_step(cfg, model, *make_optimizer(cfg.optimizer, model))
    batch = train_lib.batch_to_device(make_batch(cfg.data, n_sc=n_sc, seed=0), torch.device("cuda"))
    gen = torch.Generator().manual_seed(0)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    t0 = time.perf_counter()
    with recorded_forward_shapes() as seen, recorded_bwd_shapes() as seen_bwd:
        step(batch, gen)
    torch.cuda.synchronize()
    log(f"  warm-up step {time.perf_counter() - t0:.3f} s")
    check_path_forward_shapes("training step", seen)
    check_path_bwd_shapes("training step", seen_bwd)
    torch.cuda.reset_peak_memory_stats()
    times, per_step, metrics = [], [], []
    for _ in range(n_timed):
        reset_launches()
        t0 = time.perf_counter()
        m = step(batch, gen)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        per_step.append(launches())
        check_staged_route("training step")
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
        f"kernel launches per step {per_step[-1]}, launches by route {knarpe.ROUTE_LAUNCHES} [{card}]")
    return per_step[-1], dict(knarpe.ROUTE_LAUNCHES), seen_bwd


def expected_validate_launches(cfg) -> dict:
    """Kernel launches per validation step that the config implies: reactive replay encodes the scene
    (the map encoder's B4), the posterior latent (one TL KNN, one B2 per TL and agent layer) and runs the
    rollout (one agent->map KNN and the agent decoder's B2 per step); then one joint-future call."""
    m, n = cfg.model, cfg.time_step_end
    pallas = m.tf_cfg.use_pallas
    jf = expected_launches(cfg, n)
    post = m.tl_encoder.n_layer_tf + m.ag_encoder.n_layer_tf
    return {**jf, "knn_xy": jf["knn_xy"] + n + 1,
            "knarpe_attention": 2 * jf["knarpe_attention"],
            "knarpe_cross_attention": 2 * jf["knarpe_cross_attention"] + (post if pallas else 0)}


@contextlib.contextmanager
def captured_rollouts():
    """The reactive-replay and joint-future results (pp, buffer) of the validation steps inside the block."""
    real_rr, real_jf, seen = eval_lib.reactive_replay, eval_lib.joint_future_pred, {}

    def rr(*args, **kwargs):
        out = real_rr(*args, **kwargs)
        seen["reactive_replay"] = out[:2]
        return out

    def jf(*args, **kwargs):
        out = real_jf(*args, **kwargs)
        seen["joint_futures"] = out
        return out

    eval_lib.reactive_replay, eval_lib.joint_future_pred = rr, jf
    try:
        yield seen
    finally:
        eval_lib.reactive_replay, eval_lib.joint_future_pred = real_rr, real_jf


def buffer_to_cpu(buf):
    """A RolloutBuffer with every tensor (and every tensor of its dicts) on the CPU."""
    def cpu(x):
        if isinstance(x, dict):
            return {k: v.cpu() for k, v in x.items()}
        return x.cpu() if isinstance(x, torch.Tensor) else x
    return dataclasses.replace(buf, **{f.name: cpu(getattr(buf, f.name)) for f in dataclasses.fields(buf)})


def _flat_out(out: dict) -> dict:
    """A validation step's `out` as {name: tensor on the CPU}, nested dicts flattened."""
    flat = {}
    for key, val in out.items():
        for sub, v in (val.items() if isinstance(val, dict) else [("", val)]):
            flat[f"{key}/{sub}" if sub else key] = v.detach().float().cpu()
    return flat


def _rel_excess(got: torch.Tensor, want: torch.Tensor, rtol: float, atol: float) -> float:
    """max(|got - want| - rtol |want| - atol): <= 0 where got is within the tolerance."""
    return float(((got - want).abs() - rtol * want.abs() - atol).max())


def check_validate_card_vs_cpu(use_pallas: bool, time_step_end: int = None) -> None:
    """One validation step on the card and on the CPU: the phase-4 config with K=34 joint futures, the same
    weights and the same draws. Every comparison is made and logged before any failure is raised. time_step_end
    past the log's 30 steps runs reactive replay's TL step by step past it (phase 13 (e))."""
    cfg = with_pallas(dataclasses.replace(horizon(phase4_config(), time_step_end), n_joint_future_wosac=VALIDATE_K),
                      use_pallas)
    batch = make_batch(cfg.data, n_sc=1, seed=3)
    runs = {}
    for device in ("cpu", "cuda"):
        model = build_model(cfg, seed=1, device=device)
        damp_weights(model, 0.5)
        reset_launches()
        with captured_rollouts() as seen:
            out = eval_runner.make_validate_step(cfg, model, device=device)(batch, torch.Generator().manual_seed(0))
        if device == "cuda":
            torch.cuda.synchronize()
            want = expected_validate_launches(cfg)
            if launches() != want:
                raise AssertionError(f"validate check: kernel launches {launches()}, expected {want}")
        runs[device] = (_flat_out(out), seen)
    (cpu, cpu_seen), (gpu, gpu_seen) = runs["cpu"], runs["cuda"]
    failures, notes = [], []
    if set(cpu) != set(gpu):
        failures.append(f"out entries differ: {sorted(set(cpu) ^ set(gpu))}")
    n_diff = n_flags = 0
    for part in ("reactive_replay", "joint_futures"):
        c_buf, g_buf = cpu_seen[part][1], gpu_seen[part][1]
        pose_err = float((g_buf.pred_pose.cpu() - c_buf.pred_pose).abs().max())
        notes.append(f"{part} poses {pose_err:.2e}")
        if not (torch.equal(g_buf.pred_valid.cpu(), c_buf.pred_valid) and pose_err <= SLICE_POSE_ATOL):
            failures.append(f"{part} buffer: max pose err {pose_err} (tolerance {SLICE_POSE_ATOL}) or validity differs")
        for key, val in c_buf.violation.items():
            n_diff += int((g_buf.violation[key].cpu() != val).sum())
            n_flags += val.numel()
    notes.append(f"{n_diff} of {n_flags} flags differ")
    if n_diff > RULE_FLAG_SHARE * n_flags:
        failures.append(f"rule flags: {n_diff} of {n_flags} differ (tolerance {RULE_FLAG_SHARE:g} of them)")
    worst = {}
    for key in sorted(set(cpu) & set(gpu)):
        atol = SLICE_POSE_ATOL if key.endswith("trajs") else 1e-6
        excess = _rel_excess(gpu[key], cpu[key], VALIDATE_REL, atol)
        rel = float(((gpu[key] - cpu[key]).abs() / cpu[key].abs().clamp_min(1e-12)).max())
        worst[key] = rel
        if excess > 0:
            failures.append(f"{key}: off by {rel:.3e} relative (tolerance {VALIDATE_REL:g} + {atol:g})")
    # the realism code alone: the card's realism against the CPU's on the card's own joint futures
    g_jf = gpu_seen["joint_futures"][1]
    cpu_batch = train_lib.batch_to_device(batch, torch.device("cpu"))
    pp = pre_processing(cpu_batch, tl_mode=cfg.model.tl_mode, navi_mode=cfg.model.navi_mode,
                        n_step_hist=cfg.n_step_hist, training=True)
    replay = wosac_likelihood.realism_from_rollout(cpu_batch, pp, buffer_to_cpu(g_jf), cfg.time_step_current)
    replay_worst = 0.0
    for key, val in replay.items():
        got = gpu[f"wosac_realism/{key}"]
        replay_worst = max(replay_worst, float(((got - val).abs() / val.abs().clamp_min(1e-12)).max()))
        if _rel_excess(got, val, VALIDATE_REL, 1e-6) > 0:
            failures.append(f"realism of the card's futures, card vs CPU: {key} {got.tolist()} vs {val.tolist()}")
    top = sorted(worst.items(), key=lambda kv: -kv[1])[:4]
    log(f"  use_pallas={use_pallas}: validation step card vs CPU, K={VALIDATE_K}, {cfg.time_step_end} steps: "
        f"{'; '.join(notes)}; {len(worst)} out "
        f"values, worst relative {[(k, f'{v:.2e}') for k, v in top]} (tolerance {VALIDATE_REL:g}); realism of the "
        f"card's futures recomputed on the CPU: worst relative {replay_worst:.2e}; kernel launches "
        f"{expected_validate_launches(cfg)} as the config implies")
    if failures:
        raise AssertionError(f"validate check use_pallas={use_pallas}: " + "; ".join(failures))


def run_validate_full_width(card: str, n_timed: int = 2) -> dict:
    """The validation step at full width: leaderboard_config() with use_pallas=True, 4 scenarios, K=32, level-1
    rule checks, native realism. One warm-up, then n_timed steps; one more step split by part."""
    cfg = with_pallas(leaderboard_config(), True)
    if not cfg.native_wosac_realism or cfg.n_joint_future_wosac != 32:
        raise AssertionError("full-width validation: expected native realism and K=32 in leaderboard_config()")
    n_sc = 4
    model = build_model(cfg, seed=0, device="cuda")
    step = eval_runner.make_validate_step(cfg, model)
    batch = train_lib.batch_to_device(make_batch(cfg.data, n_sc=n_sc, seed=0), torch.device("cuda"))
    gen = torch.Generator().manual_seed(0)
    t0 = time.perf_counter()
    with recorded_forward_shapes() as seen:
        step(batch, gen)
    torch.cuda.synchronize()
    log(f"  warm-up step {time.perf_counter() - t0:.3f} s")
    check_path_forward_shapes("validation step", seen)
    torch.cuda.reset_peak_memory_stats()
    times, per_step = [], []
    for _ in range(n_timed):
        reset_launches()
        t0 = time.perf_counter()
        out = step(batch, gen)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        per_step.append(launches())
        check_staged_route("validation step")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    want = expected_validate_launches(cfg)
    if any(c != want for c in per_step):
        raise AssertionError(f"full-width validation: kernel launches per step {per_step}, expected {want}")
    n_ag, k = cfg.data.n_ag, cfg.n_joint_future_wosac
    n_fut = cfg.time_step_gt - cfg.time_step_current
    shapes = {"womd_trajs": (n_sc, n_ag, 6, n_fut // 5, 3), "womd_scores": (n_sc, n_ag, 6),
              "wosac_trajs": (n_sc, 32, n_ag, n_fut, 3)}
    for name, shape in shapes.items():
        if tuple(out[name].shape) != shape or not torch.isfinite(out[name]).all():
            raise AssertionError(f"full-width validation: {name} is {tuple(out[name].shape)} (expected {shape}) or "
                                 f"not finite")
    realism = {key: v.float().cpu() for key, v in out["wosac_realism"].items()}
    loss = {key: float(v) for key, v in out["loss_metrics"].items()}
    if not (all(tuple(v.shape) == (n_sc,) and bool(torch.isfinite(v).all()) for v in realism.values())
            and all(0 < float(v) <= 1 for key, val in realism.items() if key.endswith("likelihood") for v in val)
            and all(math.isfinite(v) for v in loss.values()) and loss["reactive_replay/diffbar_reward"] != 0):
        raise AssertionError(f"full-width validation: realism {realism} or losses {loss} out of range")

    # one more step, split by part (synchronised at the part boundaries), with the realism part's own peak
    real_realism, realism_peak = eval_runner.realism_from_rollout, {}

    def realism_with_peak(*args, **kwargs):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        result = real_realism(*args, **kwargs)
        torch.cuda.synchronize()
        realism_peak["GiB"] = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
        return result

    split = {}
    eval_runner.realism_from_rollout = realism_with_peak
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(batch, gen, split=split)
        t_split = time.perf_counter() - t0
    finally:
        eval_runner.realism_from_rollout = real_realism
    sec = float(np.median(times))
    log(f"  leaderboard_config use_pallas=True validation step: {n_sc} scenarios, K={k} joint futures, {n_ag} agents, "
        f"{cfg.data.n_mp} polylines, {cfg.time_step_end} steps, check_level=1, native realism: seconds per step "
        f"{[round(t, 4) for t in times]} (median {sec:.4f} s), wosac_validate_scenarios_per_sec_per_chip "
        f"{n_sc / sec:.4f}, peak memory {peak:.2f} GiB; split step {t_split:.4f} s: "
        f"{ {part: round(split.get(part, 0.0), 4) for part in eval_runner.SPLIT_PARTS} }, realism working set above "
        f"its inputs {realism_peak['GiB']:.2f} GiB (chunks of at most {wosac_likelihood.CHUNK_ELEMS} elements); "
        f"metametric {[round(v, 4) for v in realism['metametric'].tolist()]}, val loss "
        f"{loss['reactive_replay/loss']:.4f}; kernel launches per step {per_step[-1]}, launches by route "
        f"{knarpe.ROUTE_LAUNCHES} [{card}]")
    return per_step[-1]


def run_submission(card: str) -> None:
    """test_submission at full width: one test-split scenario, K=128 futures filtered to the 32 of the
    submission; the card's filter against the CPU's on the same buffer."""
    cfg = with_pallas(leaderboard_config(), True)
    model = build_model(cfg, seed=0, device="cuda")
    batch = make_batch(cfg.data, n_sc=1, seed=0, test_mode=True)
    n_ag, n_fut = cfg.data.n_ag, cfg.time_step_gt - cfg.time_step_current
    with captured_rollouts() as seen:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = eval_runner.test_submission(cfg, model, [batch], n_joint_future=128)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
    if not isinstance(result, list):  # no waymo_open_dataset: the arrays come back
        raise AssertionError(f"submission: expected the arrays without waymo_open_dataset, got {result}")
    (out,) = result
    shapes = {"womd_trajs": (1, n_ag, 6, n_fut // 5, 3), "womd_scores": (1, n_ag, 6),
              "wosac_trajs": (1, 32, n_ag, n_fut, 3)}
    for name, shape in shapes.items():
        if out[name].shape != shape or not np.isfinite(out[name]).all():
            raise AssertionError(f"submission: {name} is {out[name].shape} (expected {shape}) or not finite")
    pp, buf = seen["joint_futures"]
    if tuple(buf.pred_pose.shape[:2]) != (1, 128):
        raise AssertionError(f"submission: {tuple(buf.pred_pose.shape[:2])} futures, expected (1, 128)")
    on_card = filter_futures(cfg.wosac_post, buf, pp.ag_role, cfg.time_step_current).cpu()
    on_cpu = filter_futures(cfg.wosac_post, buffer_to_cpu(buf), pp.ag_role.cpu(), cfg.time_step_current)
    if not torch.equal(on_card, on_cpu):
        raise AssertionError("submission: the card's 32 futures differ from the CPU's on the same buffer")
    log(f"  test_submission, leaderboard_config use_pallas=True, 1 test scenario, K=128 -> 32: {sec:.4f} s for the "
        f"call; WOMD {out['womd_trajs'].shape}, WOSAC {out['wosac_trajs'].shape} in the global frame, all finite; "
        f"filter_futures on the card keeps the CPU's 32 futures [{card}]")


# phase 11, the training entry point, card vs CPU after two accumulated updates (float32): the first
# update's gradient (the mean of two calls' at the same parameters) to phase 7's tolerance (TRAIN_GRAD_REL
# of its scale); and the parameters, EMA and SWA elementwise to FIT_REL relative + FIT_ATOL absolute
# against a CPU replay of the same updates from each device's own gradients. Adam turns every gradient
# into a step of about lr whatever its size, so an element whose gradient lies within the gradient
# tolerance of 0 steps by +lr on one device and -lr on the other (89-96 of 758,474 values did in chip
# runs); from then on the two runs' parameters differ, so the second update's gradients are only logged,
# and the replay holds the card's optimizer, EMA and SWA to tight tolerances without that amplification. `action=validate` from the checkpoint against the fit's own
# validation of the same parameters, val/loss to VAL_LOSS_REL relative
FIT_REL, FIT_ATOL, VAL_LOSS_REL = 1e-4, 1e-6, 1e-4


def phase4_config():
    return tiny_config(n_ag=16, n_mp=512, n_tl=16, n_step=31, hidden_dim=64)


def horizon(cfg, time_step_end=None):
    """cfg rolled out to time_step_end steps (None: its own)."""
    return cfg if time_step_end is None else dataclasses.replace(cfg, time_step_end=time_step_end)


def config_overrides(base, cfg) -> list:
    """The run.py key=value arguments that turn config `base` into `cfg` (dotted keys, JSON values)."""
    out = []

    def walk(a, b, prefix):
        for key, val in b.items():
            if isinstance(val, dict):
                walk(a[key], val, f"{prefix}{key}.")
            elif a[key] != val:
                out.append(f"{prefix}{key}={json.dumps(val)}")

    walk(run_lib.config_to_dict(base), run_lib.config_to_dict(cfg), "")
    return out


def write_tbcache_split(path, cfg, n_sc: int, seed: int, test_mode: bool = False) -> None:
    """n_sc synthetic scenarios (`make_batch`) as a tbcache file, one episode each."""
    batch = make_batch(cfg.data, n_sc=n_sc, seed=seed, test_mode=test_mode)
    tbcache.write_cache(str(path), ({k: v[i] for k, v in batch.items()} for i in range(n_sc)))


def seed_checkpoint(cfg, ckpt_dir, steps_per_epoch: int) -> None:
    """A "last" checkpoint at step 0 holding the seed-0 weights damped to gain 0.5 (`damp_weights`) and a
    fresh optimizer and schedule: a fit with resume=true starts from it, on the card as on the CPU."""
    model = build_model(cfg, seed=0, device="cpu")
    damp_weights(model, 0.5)
    opt, schedule = make_optimizer(cfg.optimizer, model, steps_per_epoch=steps_per_epoch)
    ckpt = checkpoint_lib.CheckpointManager(str(ckpt_dir))
    ckpt.save_last({"model": model.state_dict(), "optimizer": opt.state_dict(), "schedule": schedule.state_dict()},
                   cfg, {"step": 0, "epoch": 0})
    ckpt.wait()


@contextlib.contextmanager
def recorded_launch_shapes():
    """The full shape of every B1, B4 and B2/B3 forward launch inside the block, counted: (kernel, dtype, n_b, n_s,
    K, D, R, H), or ("knn_xy", rows, sources, targets, k)."""
    shapes, real_fwd, real_knn = collections.Counter(), knarpe._launch, knn.load_library()

    def fwd(kernel, q, k, v, tgt, rpe, invalid, w_kv, w_rpe, b, n_head):
        shapes[(kernel, str(q.dtype), *q.shape[:2], rpe.shape[2], q.shape[2], rpe.shape[3], n_head)] += 1
        return real_fwd(kernel, q, k, v, tgt, rpe, invalid, w_kv, w_rpe, b, n_head)

    def knn_launch(*args):
        shapes[("knn_xy", *args[6:10])] += 1
        return real_knn(*args)

    knarpe._launch, knn._LAUNCH_FN = fwd, knn_launch
    try:
        yield shapes
    finally:
        knarpe._launch, knn._LAUNCH_FN = real_fwd, real_knn


@contextlib.contextmanager
def recorded_fit(with_grads: bool = False):
    """What the fits inside the block do: per train-step call its seconds (synchronised), launches, launches by
    route, metrics and batch (with_grads: on an update, the gradients it applied, on the CPU); the full shape of every B1, B4 and B2 launch, forward and backward; the seconds of
    each save_last until it returns and of each background write; restore_resume's seconds; each validation's
    metrics; and the model and optimizer state each fit's first step starts from."""
    rec = {"steps": [], "save_return": [], "write": [], "restore": [], "validate": [], "start_state": []}
    manager = checkpoint_lib.CheckpointManager
    real = dict(make=run_lib.make_train_step, bwd=knarpe._launch_bwd, save_last=manager.save_last,
                write=checkpoint_lib._Write._run, restore=manager.restore_resume, validate=eval_runner.validate)

    def make(cfg, model, opt, *args, **kwargs):
        step, calls = real["make"](cfg, model, opt, *args, **kwargs), []

        def timed(batch, *a, **kw):
            if not calls:  # the state the first step starts from, after a resume's restore
                rec["start_state"].append((checkpoint_lib.to_host(model.state_dict()),
                                           checkpoint_lib.to_host(opt.state_dict())))
            calls.append(1)
            before, routes = launches(), dict(knarpe.ROUTE_LAUNCHES)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            metrics = step(batch, *a, **kw)
            torch.cuda.synchronize()
            rec["steps"].append(dict(sec=time.perf_counter() - t0, batch=batch,
                                     launches={k: v - before[k] for k, v in launches().items()},
                                     routes={k: v - routes[k] for k, v in knarpe.ROUTE_LAUNCHES.items()},
                                     metrics={k: float(v) for k, v in metrics.items()}))
            if with_grads and "grad_norm" in metrics:
                rec["steps"][-1]["grads"] = {n: p.grad.detach().float().cpu() for n, p in model.named_parameters()}
            return metrics

        timed.accumulator = step.accumulator
        return timed

    def bwd(kernel, q, k, v, tgt, rpe, invalid, w_kv, w_rpe, b, g, n_head):
        key = (f"{kernel}_bwd", str(q.dtype), *q.shape[:2], rpe.shape[2], q.shape[2], rpe.shape[3], n_head)
        rec["shapes"][key] += 1
        return real["bwd"](kernel, q, k, v, tgt, rpe, invalid, w_kv, w_rpe, b, g, n_head)

    def save_last(self, *args, **kwargs):
        t0 = time.perf_counter()
        real["save_last"](self, *args, **kwargs)
        rec["save_return"].append(time.perf_counter() - t0)

    def write(self, *args):
        t0 = time.perf_counter()
        real["write"](self, *args)
        rec["write"].append(time.perf_counter() - t0)

    def restore(self, *args, **kwargs):
        t0 = time.perf_counter()
        out = real["restore"](self, *args, **kwargs)
        rec["restore"].append(time.perf_counter() - t0)
        return out

    def validate(*args, **kwargs):
        metrics = real["validate"](*args, **kwargs)
        rec["validate"].append(metrics)
        return metrics

    run_lib.make_train_step, knarpe._launch_bwd = make, bwd
    checkpoint_lib.CheckpointManager.save_last, checkpoint_lib._Write._run = save_last, write
    checkpoint_lib.CheckpointManager.restore_resume, eval_runner.validate = restore, validate
    try:
        with recorded_launch_shapes() as shapes:  # the forwards and B1; the backwards join them below
            rec["shapes"] = shapes
            yield rec
    finally:
        run_lib.make_train_step, knarpe._launch_bwd = real["make"], real["bwd"]
        checkpoint_lib.CheckpointManager.save_last, checkpoint_lib._Write._run = real["save_last"], real["write"]
        checkpoint_lib.CheckpointManager.restore_resume, eval_runner.validate = real["restore"], real["validate"]


def grads_excess(got: dict, want: dict) -> tuple:
    """(worst |got - want| over its scale, its name) as phase 7 measures gradients: a tensor's scale is its largest
    |want|, floored at TRAIN_GRAD_FLOOR of the largest over the model."""
    floor = TRAIN_GRAD_FLOOR * max(float(g.abs().max()) for g in want.values())
    worst = max((float((got[n] - g).abs().max()) / max(float(g.abs().max()), floor), n) for n, g in want.items())
    return worst


def replay_fit(cfg, seed_model: dict, updates: list, n_calls: int, steps_per_epoch: int) -> dict:
    """The parameters, EMA and SWA that `n_calls` calls of a fit reach on the CPU from `seed_model` when update j
    applies the gradients `updates[j]` (after the clip): AdamW and the schedule on every k-th call, the EMA and
    the SWA average after every call, as `run.fit` does."""
    model = build_model(cfg, seed=0, device="cpu")
    model.load_state_dict(seed_model)
    names, params = zip(*model.named_parameters())
    opt, schedule = make_optimizer(cfg.optimizer, model, steps_per_epoch=steps_per_epoch)
    ema, swa_state = swa_lib.ema_init(params), swa_lib.swa_init(params)
    swa_start = int(cfg.swa_epoch_start * cfg.max_epochs) * steps_per_epoch
    pending = iter(updates)
    for call in range(n_calls):
        if (call + 1) % cfg.optimizer.accumulate_grad_batches == 0:
            grads = next(pending)
            for n, p in zip(names, params):
                p.grad = grads[n].clone()
            opt.step()
            schedule.step()
        swa_lib.ema_update(ema, params, cfg.ema_decay)
        swa_lib.swa_update(swa_state, params, call, swa_start)
    return {"model": dict(model.state_dict()), "ema": dict(zip(names, ema)),
            "swa": dict(zip(names, swa_lib.swa_params(swa_state, params)))}


def states_excess(got: dict, want: dict) -> tuple:
    """(largest |got - want| - FIT_REL |want| - FIT_ATOL over every tensor, its name, elements outside)."""
    if set(got) != set(want):
        raise AssertionError(f"fit card vs CPU: entries differ: {sorted(set(got) ^ set(want))}")
    worst, worst_name, n_out = -math.inf, "", 0
    for name, w in want.items():
        excess = (got[name].float() - w.float()).abs() - FIT_REL * w.float().abs() - FIT_ATOL
        n_out += int((excess > 0).sum())
        if float(excess.max()) > worst:
            worst, worst_name = float(excess.max()), name
    return worst, worst_name, n_out


def check_fit_card_vs_cpu(tmp) -> None:
    """(a) run.fit for 4 calls (2 updates, accumulate_grad_batches=2) with EMA and SWA on the card and on the CPU,
    from the same damped seed-0 weights and the same tbcache file: parameters, EMA and SWA agree."""
    base = no_dropout(with_pallas(phase4_config(), True))
    cfg = dataclasses.replace(base, ema_decay=0.5, swa=True, swa_epoch_start=0.0, limit_train_batches=1.0,
                              validate_every_epoch=False,
                              optimizer=dataclasses.replace(base.optimizer, accumulate_grad_batches=2))
    data_dir = tmp / "fit_a_data"
    data_dir.mkdir()
    write_tbcache_split(data_dir / "training.tbcache", cfg, 8, seed=3)
    write_tbcache_split(data_dir / "validation.tbcache", cfg, 2, seed=4)
    states, updates = {}, {}
    for device in ("cpu", "cuda"):
        ckpt_dir = tmp / f"fit_a_{device}"
        train_loader, val_loader = run_lib.make_dataloaders(cfg, "tbcache", str(data_dir))
        seed_checkpoint(cfg, ckpt_dir, len(train_loader))
        seed_model = checkpoint_lib.CheckpointManager(str(ckpt_dir)).restore("last")[0]["model"]
        t0 = time.perf_counter()
        with recorded_fit(with_grads=True) as rec:
            _, _, stopped = run_lib.fit(cfg, train_loader, val_loader, ckpt_dir=str(ckpt_dir), max_steps=4,
                                        resume=True, device=device)
        sec = time.perf_counter() - t0
        updates[device] = [st["grads"] for st in rec["steps"] if "grads" in st]
        state, _, meta = checkpoint_lib.CheckpointManager(str(ckpt_dir)).restore("last")
        if stopped or meta["step"] != 4 or not {"ema", "swa", "swa_state", "accumulator"} <= set(state):
            raise AssertionError(f"fit card vs CPU on {device}: stopped {stopped}, last at {meta}, entries "
                                 f"{sorted(state)}")
        states[device] = state
        log(f"  run.fit on {device}: 4 calls, 2 updates in {sec:.2f} s; last.json meta {meta}")
    if not len(updates["cpu"]) == len(updates["cuda"]) == 2:
        raise AssertionError(f"fit card vs CPU: {len(updates['cpu'])} and {len(updates['cuda'])} updates, expected 2")
    notes, failures = [], []
    for j, (g_gpu, g_cpu) in enumerate(zip(updates["cuda"], updates["cpu"])):
        worst, name = grads_excess(g_gpu, g_cpu)
        gated = j == 0  # the later updates' gradients are taken at parameters Adam's sign steps already moved apart
        notes.append(f"update {j + 1}'s gradients within {worst:.2e} of their scale ({name}"
                     f"{f', tolerance {TRAIN_GRAD_REL:g}' if gated else ', not gated'})")
        if gated and not worst <= TRAIN_GRAD_REL:
            failures.append(f"update {j + 1}'s gradient of {name} off by {worst} of its scale")
    steps_per_epoch = len(train_loader)
    for device in ("cpu", "cuda"):
        replay = replay_fit(cfg, seed_model, updates[device], 4, steps_per_epoch)
        for entry in ("model", "ema", "swa"):
            worst, name, n_out = states_excess(states[device][entry], replay[entry])
            notes.append(f"{device} {entry} against the replay of its own gradients: worst excess over the tolerance "
                         f"{worst:.3e} ({name}), {n_out} of {sum(v.numel() for v in replay[entry].values())} outside")
            if n_out:
                failures.append(f"{device} {entry}: {n_out} values beyond {FIT_REL:g} relative + {FIT_ATOL:g} of the "
                                f"replay")
    direct = states_excess(states["cuda"]["model"], states["cpu"]["model"])
    notes.append(f"parameters card vs CPU directly: {direct[2]} values beyond {FIT_REL:g} relative + {FIT_ATOL:g} "
                 f"(Adam's sign steps), worst excess {direct[0]:.3e} ({direct[1]})")
    log("  card vs CPU after 2 accumulated updates: " + "; ".join(notes))
    if failures:
        raise AssertionError("fit card vs CPU: " + "; ".join(failures))


def check_fit_shapes(shapes) -> None:
    """Every B1, B4 and B2 launch of the fits, forward and backward, at a full shape phase 3 checked: bf16 B4 and
    B2 on the staged route, B1 against its plain version."""
    fwd_x = [X_PATH, TRAIN_X_PATH, POST_TL_X_PATH, *X_EDGE, *FIT_X, *VAL_X]
    attn = [ATTN_PATH, TRAIN_ATTN_PATH, *ATTN_EDGE, *ATTN_STAGED_EDGE]
    checked = {("knarpe_attention", *s) for s in attn} | {("knarpe_attention_bwd", *s) for s in attn}
    checked |= {("knarpe_cross_attention", *s) for s in fwd_x}
    checked |= {("knarpe_cross_attention_bwd", *s) for s in [TRAIN_X_PATH, POST_TL_X_PATH, *X_BWD_EDGE]}
    checked_knn = {case[:4] for case in KNN_CASES.values()}
    bad = []
    for key in shapes:  # (kernel, dtype, n_b, n_s, K, D, R, H), or ("knn_xy", rows, sources, targets, k)
        if key[0] == "knn_xy":
            ok = tuple(key[1:]) in checked_knn
        else:
            ok = key[1] == str(torch.bfloat16) and (key[0], *key[2:]) in checked
        if not ok:
            bad.append(key)
    if bad:
        raise AssertionError(f"fit: launches at shapes phase 3 did not check: {sorted(bad, key=str)}")


def run_fit_full_width(card: str, tmp) -> tuple:
    """(b) `run.main(["action=fit", ...])` on leaderboard_config() with use_pallas=True from a tbcache of 8
    training and 4 validation scenarios: 3 steps, then a resume to 4. -> (launches per step, ckpt_dir, data_dir,
    the resumed fit's validation loss, times)."""
    cfg = with_pallas(leaderboard_config(), True)
    data_dir, ckpt_dir = tmp / "fit_b_data", tmp / "fit_b_ckpt"
    data_dir.mkdir()
    t0 = time.perf_counter()
    write_tbcache_split(data_dir / "training.tbcache", cfg, 8, seed=0)
    write_tbcache_split(data_dir / "validation.tbcache", cfg, 4, seed=1)
    log(f"  tbcache of 8 training and 4 validation scenarios at full width written in {time.perf_counter() - t0:.2f} s "
        f"({(data_dir / 'training.tbcache').stat().st_size} and {(data_dir / 'validation.tbcache').stat().st_size} "
        f"bytes)")
    args = ["action=fit", "data=tbcache", f"data_dir={data_dir}", f"ckpt_dir={ckpt_dir}", "model.tf_cfg.use_pallas=true",
            "ckpt_every_steps=2", "ema_decay=0.999", "val_epoch_batches=1", "batch_size_test=4", "limit_train_batches=1.0",
            "log_every=1"]
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    with recorded_fit() as rec:
        t0 = time.perf_counter()
        model, _, stopped = run_lib.main(args + ["max_steps=3"])
        torch.cuda.synchronize()
        t_fit = time.perf_counter() - t0
    run_counts = launches()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    steps, want = rec["steps"], expected_train_launches(cfg)  # a fit step's are a training step's at any batch
    if stopped or len(steps) != 3 or len(rec["validate"]) != 1:
        raise AssertionError(f"fit: stopped {stopped}, {len(steps)} steps, {len(rec['validate'])} validations")
    for i, st in enumerate(steps):
        m = st["metrics"]
        if st["launches"] != want:
            raise AssertionError(f"fit step {i + 1}: kernel launches {st['launches']}, expected {want}")
        if any(v for key, v in st["routes"].items() if key.endswith("/general")):
            raise AssertionError(f"fit step {i + 1}: launches by route {st['routes']}, expected all staged")
        if not (math.isfinite(m["training/loss"]) and math.isfinite(m.get("grad_norm", math.nan)) and m["grad_norm"] > 0):
            raise AssertionError(f"fit step {i + 1}: loss {m['training/loss']}, grad_norm {m.get('grad_norm')}")
    want_run = {k: 3 * want[k] + expected_validate_launches(cfg)[k] for k in want}
    if run_counts != want_run:
        raise AssertionError(f"fit: launches over the run {run_counts}, expected 3 steps and one validation {want_run}")
    check_fit_shapes(rec["shapes"])
    ckpt = checkpoint_lib.CheckpointManager(str(ckpt_dir))
    last, _, meta = ckpt.restore("last")
    _, _, best_meta = ckpt.restore("best")
    live = checkpoint_lib.to_host(model.state_dict())
    if meta["step"] != 3 or best_meta["step"] != 3 or not all(torch.equal(last["model"][n], v) for n, v in live.items()):
        raise AssertionError(f"fit: last {meta}, best {best_meta}, or the restored parameters differ from the live ones")
    ckpt_bytes = ckpt.path("last").stat().st_size
    n_params = sum(v.numel() for v in live.values())
    sec = [st["sec"] for st in steps]
    log(f"  leaderboard_config use_pallas=True run.main action=fit, tbcache, batch 2: steps {[round(t, 4) for t in sec]} s "
        f"(median of the steps after the first {np.median(sec[1:]):.4f} s, {2 / np.median(sec[1:]):.3f} train samples/s), "
        f"whole run {t_fit:.2f} s, peak memory {peak:.2f} GiB, losses "
        f"{[round(st['metrics']['training/loss'], 4) for st in steps]}, grad_norm "
        f"{[round(st['metrics']['grad_norm'], 4) for st in steps]}; launches per step {steps[-1]['launches']} (all "
        f"staged), over the run {run_counts}; launches by full shape {dict(rec['shapes'])}, each checked in phase 3; "
        f"save_last returns in {[round(t, 4) for t in rec['save_return']]} s, writes {[round(t, 4) for t in rec['write']]}"
        f" s; checkpoint {ckpt_bytes} bytes ({n_params} parameters); last {meta}, best {best_meta}; the restored "
        f"parameters equal the live model's bit for bit [{card}]")

    # the resume: from step 3, exactly the saved state, the 4th batch of epoch 0's permutation
    saved = checkpoint_lib.to_host(ckpt.restore("last")[0])
    with recorded_fit() as rec2:
        t0 = time.perf_counter()
        run_lib.main(args + ["max_steps=4", "resume=true"])
        t_resume_run = time.perf_counter() - t0
    state, _, meta2 = ckpt.restore("last")
    start_model, start_opt = rec2["start_state"][0]
    same_model = all(torch.equal(start_model[n], v) for n, v in saved["model"].items())
    same_opt = all(torch.equal(a, b) for a, b in zip(_tensors(start_opt), _tensors(saved["optimizer"])))
    idx = np.arange(8)
    np.random.default_rng(cfg.seed).shuffle(idx)
    want_batch = tbcache.TBCacheDataset(str(data_dir / "training.tbcache")).get_batch(idx[6:8])
    got_batch = rec2["steps"][0]["batch"]
    same_batch = all(np.array_equal(np.asarray(got_batch[k]), v) for k, v in want_batch.items())
    if not (len(rec2["steps"]) == 1 and meta2["step"] == 4 and same_model and same_opt and same_batch):
        raise AssertionError(f"fit resume: {len(rec2['steps'])} steps, last at {meta2}, starts from the saved model "
                             f"{same_model} and optimizer {same_opt}, on the 4th batch {same_batch}")
    log(f"  resume=true max_steps=4: restore_resume {rec2['restore'][0]:.4f} s, whole resumed run {t_resume_run:.2f} s "
        f"(one step {rec2['steps'][0]['sec']:.4f} s and one validation); started from the saved model and optimizer "
        f"state bit for bit, at step 3 on the 4th batch of epoch 0's permutation; last {meta2} [{card}]")
    times = dict(step_s=float(np.median(sec[1:])), samples_per_s=2 / float(np.median(sec[1:])), peak_gib=peak,
                 save_return_s=rec["save_return"], write_s=rec["write"], ckpt_bytes=ckpt_bytes,
                 resume_s=rec2["restore"][0])
    return steps[-1]["launches"], ckpt_dir, data_dir, rec2["validate"][0]["val/loss"], times


def _tensors(obj):
    """The tensors of a nested dict / list, in order."""
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, dict):
        return [t for v in obj.values() for t in _tensors(v)]
    if isinstance(obj, (list, tuple)):
        return [t for v in obj for t in _tensors(v)]
    return []


def check_fit_preemption(card: str, tmp) -> None:
    """(c) A `python -m trafficbotsv15_tpu_torch.run action=fit` subprocess at the phase-4 config gets SIGTERM once
    it has logged its first step (its handler installed): exit 143 with "last" at a step >= 1; a resume=true
    relaunch adds exactly one step."""
    import signal

    ckpt_dir = tmp / "fit_c_ckpt"
    base = tiny_config()
    cfg = dataclasses.replace(with_pallas(phase4_config(), True), validate_every_epoch=False, max_epochs=5)
    args = [sys.executable, "-u", "-m", "trafficbotsv15_tpu_torch.run", "action=fit", "preset=tiny", "data=synthetic",
            f"ckpt_dir={ckpt_dir}", "log_every=1", *config_overrides(base, cfg)]
    t0 = time.perf_counter()
    repo = Path(__file__).resolve().parent
    proc = subprocess.Popen(args, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=repo)
    try:
        lines = []
        for line in proc.stdout:
            lines.append(line)
            if line.startswith("[step 1]"):
                proc.send_signal(signal.SIGTERM)
                break
        rest, _ = proc.communicate(timeout=300)
        lines.append(rest)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if proc.returncode != 143:
        raise AssertionError(f"fit preemption: exit {proc.returncode}, expected 143:\n{''.join(lines)[-3000:]}")
    _, _, meta = checkpoint_lib.CheckpointManager(str(ckpt_dir)).restore("last")
    t_stop = time.perf_counter() - t0
    resumed = subprocess.run(args + ["resume=true", f"max_steps={meta['step'] + 1}"], capture_output=True, text=True,
                             timeout=300, cwd=repo)
    _, _, meta2 = checkpoint_lib.CheckpointManager(str(ckpt_dir)).restore("last")
    if meta["step"] < 1 or resumed.returncode != 0 or meta2["step"] != meta["step"] + 1:
        raise AssertionError(f"fit preemption: stopped at {meta}, resume exit {resumed.returncode} at {meta2}:\n"
                             f"{resumed.stdout[-2000:]}{resumed.stderr[-2000:]}")
    log(f"  SIGTERM after the first logged step: exit 143 in {t_stop:.2f} s with last at step {meta['step']}; "
        f"resume=true relaunch: exit 0, last at step {meta2['step']} [{card}]")


def check_validate_and_test(card: str, ckpt_dir, data_dir, fit_val_loss: float, tmp) -> None:
    """(d) `action=validate` from the fit's checkpoint gives the fit's own val/loss; `action=test` from "best" at
    K=128 makes the submission arrays phase 10 checks."""
    common = [f"ckpt_dir={ckpt_dir}", "data=tbcache"]
    t0 = time.perf_counter()
    metrics = run_lib.main(["action=validate", f"data_dir={data_dir}", "model.tf_cfg.use_pallas=true",
                            "batch_size_test=4", *common])
    t_val = time.perf_counter() - t0
    rel = abs(metrics["val/loss"] - fit_val_loss) / max(abs(fit_val_loss), 1e-12)
    if not rel <= VAL_LOSS_REL:
        raise AssertionError(f"action=validate: val/loss {metrics['val/loss']} against the fit's {fit_val_loss}")
    cfg = leaderboard_config()
    test_dir = tmp / "fit_d_test"
    test_dir.mkdir()
    write_tbcache_split(test_dir / "validation.tbcache", cfg, 1, seed=0, test_mode=True)
    write_tbcache_split(test_dir / "training.tbcache", cfg, 1, seed=0)
    t0 = time.perf_counter()
    result = run_lib.main(["action=test", f"data_dir={test_dir}", *common])
    t_test = time.perf_counter() - t0
    if not isinstance(result, list) or len(result) != 1:
        raise AssertionError(f"action=test: expected one batch of arrays without waymo_open_dataset, got {type(result)}")
    (out,) = result
    n_ag, n_fut = cfg.data.n_ag, cfg.time_step_gt - cfg.time_step_current
    shapes = {"womd_trajs": (1, n_ag, 6, n_fut // 5, 3), "womd_scores": (1, n_ag, 6),
              "wosac_trajs": (1, 32, n_ag, n_fut, 3)}
    for name, shape in shapes.items():
        if out[name].shape != shape or not np.isfinite(out[name]).all():
            raise AssertionError(f"action=test: {name} is {out[name].shape} (expected {shape}) or not finite")
    log(f"  action=validate from last: val/loss {metrics['val/loss']:.6f} against the fit's {fit_val_loss:.6f} "
        f"({rel:.2e} relative, tolerance {VAL_LOSS_REL:g}) in {t_val:.2f} s; action=test from best, K=128, batch 1: "
        f"WOMD {out['womd_trajs'].shape}, WOSAC {out['wosac_trajs'].shape}, finite, in {t_test:.2f} s [{card}]")


def run_fit_phase(card: str) -> dict:
    """Phase 11: (a)-(d); -> launches per full-width fit step."""
    import tempfile

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_fit_") as name:
        tmp = Path(name)
        check_fit_card_vs_cpu(tmp)
        t_a = time.perf_counter() - t0
        counts, ckpt_dir, data_dir, val_loss, times = run_fit_full_width(card, tmp)
        t_b = time.perf_counter() - t0 - t_a
        check_fit_preemption(card, tmp)
        t_c = time.perf_counter() - t0 - t_a - t_b
        check_validate_and_test(card, ckpt_dir, data_dir, val_loss, tmp)
    total = time.perf_counter() - t0
    log(f"  (e) fit at full width, batch 2: {times['step_s']:.4f} s per step, {times['samples_per_s']:.4f} train "
        f"samples/s, peak {times['peak_gib']:.2f} GiB; save_last returns in "
        f"{[round(t, 4) for t in times['save_return_s']]} s, background writes "
        f"{[round(t, 4) for t in times['write_s']]} s, checkpoint {times['ckpt_bytes']} bytes, resume (restore_resume) "
        f"{times['resume_s']:.4f} s; phase 11 {total:.1f} s ((a) {t_a:.1f}, (b) {t_b:.1f}, (c) {t_c:.1f}, (d) "
        f"{total - t_a - t_b - t_c:.1f}) [{card}]")
    return counts


def _worst(checks) -> str:
    """The toleranced check nearest its tolerance (largest excess), with its error and tolerance; the checks
    held to equality pass only when equal."""
    tol = [c for c in checks if c.atol or c.rtol]
    if not tol:
        return "every check equal"
    c = max(tol, key=lambda c: c.excess())
    return (f"{c.name}: max |err| {c.max_abs_err():.3e} against atol {c.atol:g} + rtol {c.rtol:g} * |golden|, "
            f"excess {c.excess():.3e}")


def _run_golden(module, case: str, use_pallas: bool, kw: dict, want: dict) -> list:
    """One golden case on the card; every check within its tolerance and the kernels launched exactly as `want`
    says (the others not at all), float32 on the general route."""
    reset_launches()
    checks = module.run_case(case, device="cuda", use_pallas=use_pallas, **kw)
    torch.cuda.synchronize()
    want = {name: want.get(name, 0) for name in launches()}
    routes = {f"{kernel}/{way}": (n if way == "general" else 0) for kernel, n in want.items() if kernel != "knn_xy"
              for way in ("staged", "general")}
    got_routes = {key: knarpe.ROUTE_LAUNCHES[key] for key in routes}
    if launches() != want or got_routes != routes:
        raise AssertionError(f"golden {case} use_pallas={use_pallas} {kw}: launches {launches()} by route "
                             f"{got_routes}, expected {want} on the general route")
    bad = [c for c in checks if not c.excess() <= 0.0]
    if bad:
        raise AssertionError(f"golden {case} use_pallas={use_pallas} {kw} on the card: " + "; ".join(_worst([c])
                                                                                                for c in bad))
    return checks


def check_reference_layout_flagship(card: str, gm, reference_state_dict) -> dict:
    """(b) leaderboard_config's weights through the reference layout: exported, loaded back through
    `load_reference_state_dict`, bit-equal, and one full-width call bit-equal to the directly loaded model's."""
    from trafficbotsv15_tpu_torch.utils.torch_import import load_reference_state_dict

    t0 = time.perf_counter()
    sd = gm.load_golden("model", "traffic_bots_full")[0]
    exported = reference_state_dict(gm.full_model("traffic_bots_full", "cpu")[0])
    if len(sd) != 526 or {k: v.shape for k, v in exported.items()} != {k: v.shape for k, v in sd.items()}:
        raise AssertionError(f"reference layout at traffic_bots_full's config: {len(exported)} keys, the golden "
                             f"{len(sd)}; names or shapes differ")
    cfg = with_pallas(leaderboard_config(), True)
    src = build_model(cfg, seed=0, device="cuda")
    damp_weights(src, 0.5)
    t1 = time.perf_counter()
    ref_sd = reference_state_dict(src, cfg.data)
    t_export = time.perf_counter() - t1
    dst = build_model(cfg, seed=1, device="cuda")
    t1 = time.perf_counter()
    load_reference_state_dict(dst, ref_sd, cfg.model, cfg.time_step_gt)
    t_load = time.perf_counter() - t1
    want = src.state_dict()
    differ = [k for k, v in dst.state_dict().items() if not torch.equal(v.view(torch.int32), want[k].view(torch.int32))]
    if differ:
        raise AssertionError(f"reference layout: parameters differ after the round trip: {differ[:8]}")
    log(f"  (b) the inverse at traffic_bots_full's config gives the golden's {len(sd)} names and shapes; "
        f"leaderboard_config (use_pallas=True, seed 0, damped 0.5): {len(ref_sd)} reference entries exported in "
        f"{t_export:.2f} s, loaded through load_reference_state_dict in {t_load:.2f} s, all {len(want)} parameters "
        f"bit-equal")
    batch = make_batch(cfg.data, n_sc=4, seed=0)
    bufs, counts = {}, {}
    for name, model in (("direct", src), ("reference layout", dst)):
        reset_launches()
        with recorded_forward_shapes() as seen:
            _, bufs[name] = joint_future_pred(cfg, model, batch, generator=torch.Generator().manual_seed(0),
                                              check_level=1)
        torch.cuda.synchronize()
        counts[name] = launches()
        check_staged_route(f"reference-layout {name} call")
        check_path_forward_shapes(f"reference-layout {name} call", seen)
    want_counts = expected_launches(cfg, cfg.time_step_end)
    if counts["reference layout"] != want_counts or counts["direct"] != want_counts:
        raise AssertionError(f"reference layout: launches {counts}, expected {want_counts} each")
    a, b = bufs["direct"], bufs["reference layout"]
    same = {"pred_pose": torch.equal(a.pred_pose[:, 0], b.pred_pose[:, 0]),
            "pred_valid": torch.equal(a.pred_valid[:, 0], b.pred_valid[:, 0]),
            **{f"violation/{k}": torch.equal(a.violation[k][:, 0], b.violation[k][:, 0]) for k in a.violation}}
    if not all(same.values()):
        raise AssertionError(f"reference layout: K0 futures or rule flags differ from the direct model's: "
                             f"{[k for k, v in same.items() if not v]}")
    flags = {k: int(v[:, 0].sum()) for k, v in b.violation.items() if not k.endswith("_this_step")}
    log(f"  (b) joint_future_pred 4 scenarios x K=32, 64 agents, 1024 polylines, 90 steps, check_level=1 from the "
        f"reloaded model: launches {counts['reference layout']} (as the direct model's, all staged); K0 futures "
        f"{list(b.pred_pose[:, 0].shape)} and all {len(a.violation)} rule flags bit-equal to the direct model's "
        f"(K0 agent-steps flagged {flags}); phase (b) {time.perf_counter() - t0:.1f} s [{card}]")
    return counts["reference layout"]


def run_golden_phase(card: str) -> dict:
    """Phase 12: (a) the reference-torch goldens through the kernels and through the card's plain path; (b) the
    flagship through the reference layout. -> launches of (b)'s full-width call."""
    t0 = time.perf_counter()
    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    import test_torch_golden_model as gm
    import test_torch_golden_sim as gs
    from torch_reference_layout import reference_state_dict

    for case, (kw, want) in gm.KERNEL_CASES.items():
        checks = _run_golden(gm, case, True, kw, want)
        errs = ", ".join(f"{c.name} {c.max_abs_err():.3e} ({c.atol:g}, {c.rtol:g})" for c in checks)
        log(f"  (a) {case} {kw or ''} use_pallas=True float32: launches {want} on the general route; max |err| "
            f"(atol, rtol): {errs}; worst {_worst(checks)}")
    sweep = [(gm, name, kw) for name, kw in gm.MODEL_CASES] + [(gm, "traffic_bots_full", {})]
    sweep += [(gs, name, {}) for name in gs.SIM_CASES]
    worst = []
    for module, case, kw in sweep:
        checks = [c for c in _run_golden(module, case, False, kw, {}) if c.atol or c.rtol]
        worst += [(c.excess(), case, kw, c) for c in checks]
    excess, case, kw, c = max(worst, key=lambda w: w[0])
    log(f"  (a) sweep on the card with use_pallas=False: {len(sweep)} golden cases ({len(gm.MODEL_CASES) + 1} model, "
        f"{len(gs.SIM_CASES)} sim), every check within its tolerance (the exact ones equal), no kernel launch; "
        f"nearest its tolerance: {case} {kw or ''} {_worst([c])} [{card}]")
    counts = check_reference_layout_flagship(card, gm, reference_state_dict)
    log(f"  phase 12 {time.perf_counter() - t0:.1f} s [{card}]")
    return counts

# phase 13, the scaled preset: 4 scenarios x K=32 futures for eval and validation, the preset's own batch of 1 for
# training; (e) rolls the phase-4 config out 10 steps past its 30 logged ones
SCALED_N_SC, SCALED_CHECK_END = 4, 40


def check_scaled_shapes(where: str, shapes, want: dict) -> None:
    """The launches of a scaled-preset call, by full shape, are exactly `want`, and each shape is one phase 3 checked:
    B1 against its plain version, bf16 B4 against its own on the heads route and bf16 B2 on the cluster route."""
    checked = {("knn_xy", *case[:4]) for case in KNN_CASES.values()}
    checked |= {("knarpe_attention", str(torch.bfloat16), *s) for s in HEADS_ATTN}
    checked |= {("knarpe_cross_attention", str(torch.bfloat16), *s) for s in CLUSTER_X}
    if dict(shapes) != want or not set(shapes) <= checked:
        raise AssertionError(f"{where}: launches by shape {dict(shapes)}, expected {want}, each at a shape phase 3 "
                             f"checked (unchecked: {sorted(set(shapes) - checked, key=str)})")


@contextlib.contextmanager
def captured_launches(*kernels: str):
    """The operands (B4: q, k, v, rpe, invalid, w_rpe, b; B2: q, tgt, rpe, invalid, w_kv, w_rpe, b), n_head and
    output of the first forward launch of each of `kernels` inside the block, cloned: {kernel: {"args": [...],
    "n_head": H, "out": tensor}}, without the kernels that did not launch."""
    real, got = knarpe._launch, {}

    def capture(name, q, k, v, tgt, rpe, invalid, w_kv, w_rpe, b, n_head):
        out = real(name, q, k, v, tgt, rpe, invalid, w_kv, w_rpe, b, n_head)
        if name in kernels and name not in got:
            ops = (q, k, v, rpe, invalid, w_rpe, b) if name == "knarpe_attention" else (q, tgt, rpe, invalid, w_kv,
                                                                                          w_rpe, b)
            got[name] = {"args": [t.clone() for t in ops], "n_head": n_head, "out": out.clone()}
        return out

    knarpe._launch = capture
    try:
        yield got
    finally:
        knarpe._launch = real


def check_path_launch(where: str, kernel: str, got: dict) -> float:
    """A captured bf16 B4 or B2 launch of a path against the float32 plain version on its own (bf16-valued)
    operands, at phase 3's bf16 tolerance; returns the max |err|."""
    what = "B4" if kernel == "knarpe_attention" else "B2"
    if not got:
        raise AssertionError(f"{where}: no {what} launch to check")
    plain = getattr(knarpe, f"{kernel}_reference")
    ref = plain(*[a if a.dtype == torch.bool else a.float() for a in got["args"]], got["n_head"])
    out = got["out"].float()
    err = float((out - ref).abs().max())
    excess = float(((out - ref).abs() - (BF16_HALF_ULP * ref.abs() + KNARPE_F32_ATOL)).max())
    if not (got["out"].dtype == torch.bfloat16 and torch.isfinite(out).all() and excess <= 0):
        raise AssertionError(f"{where}: the first {what} launch's output exceeds {BF16_HALF_ULP} relative + "
                             f"{KNARPE_F32_ATOL} of the plain version on its inputs by {excess}")
    log(f"  {where}: the first {what} launch {list(got['out'].shape)} against the float32 plain version on its own "
        f"inputs: max |err| {err:.3e}, within {BF16_HALF_ULP:g} relative + {KNARPE_F32_ATOL:g} absolute")
    return err


def peak_gib() -> float:
    return torch.cuda.max_memory_allocated() / 2 ** 30


def run_scaled_phase(card: str) -> dict:
    """`scaled_config()` at full width (hidden 256, 8 heads, 12/6/6 layers, 120 steps past the log's 91, bf16
    compute), random seed-0 weights, synthetic scenarios: (a) joint_future_pred, use_pallas=False, and (d) with
    use_pallas=True, B4 on the heads route and B2 on the cluster route, timed in turns; (b) the training step at
    batch 1; (c) the validation step; (e) the phase-4 config past its log, card against CPU. Returns the launches
    per call or step by path, and the max |err| of (d)'s first B4 and first B2 launch against the plain versions on
    their inputs, by kernel."""
    t_phase = time.perf_counter()
    n_sc = SCALED_N_SC
    knn_eval = ("knn_xy", n_sc * 32, KNN_SRC, KNN_TGT, KNN_K)  # the agent->map KNN of 4 x 32 rollouts

    # (a) eval with use_pallas=False and (d) with use_pallas=True, where B4 in bf16 at D=R=256, H=8 takes the heads
    # route and B2 the cluster route: a warm-up call each, then two timed calls each, in turns (a d d a); the first
    # B4 and B2 launches of (d)'s warm-up call are captured and held against the plain versions on their own inputs
    t0 = time.perf_counter()
    cfg = with_pallas(scaled_config(), False)
    n_step, n_ag, k = cfg.time_step_end, cfg.data.n_ag, cfg.n_joint_future_wosac
    n_logged = cfg.data.n_step
    if not (n_step >= n_logged and k == 32 and cfg.precision == "bf16"):
        raise AssertionError(f"scaled_config(): {n_step} steps against {n_logged} logged, K={k}, {cfg.precision}")
    batch = make_batch(cfg.data, n_sc=n_sc, seed=0)
    model = build_model(cfg, seed=0, device="cuda")
    n_params = sum(p.numel() for p in model.parameters())
    gen = torch.Generator().manual_seed(0)
    joint_future_pred(cfg, model, batch, generator=gen, check_level=1)
    torch.cuda.synchronize()
    t_warm = time.perf_counter() - t0
    t0 = time.perf_counter()
    pcfg = with_pallas(scaled_config(), True)
    pmodel = build_model(pcfg, seed=0, device="cuda")
    pgen = torch.Generator().manual_seed(0)
    with captured_launches("knarpe_attention", "knarpe_cross_attention") as first:
        joint_future_pred(pcfg, pmodel, batch, generator=pgen, check_level=1)
    torch.cuda.synchronize()
    t_pwarm = time.perf_counter() - t0
    first_errs = {kernel: check_path_launch("(d) scaled eval call use_pallas=True", kernel, first.get(kernel, {}))
                  for kernel in ("knarpe_attention", "knarpe_cross_attention")}
    del first
    n_b4, n_b2 = pcfg.model.mp_encoder.n_layer_tf, pcfg.model.ag_encoder.n_layer_tf * n_step
    arms = {"a": (cfg, model, gen, {knn_eval: n_step}, {}),
            "d": (pcfg, pmodel, pgen,
                  {knn_eval: n_step, ("knarpe_attention", str(torch.bfloat16), *SCALED_ATTN_PATH): n_b4,
                   ("knarpe_cross_attention", str(torch.bfloat16), *SCALED_X_PATH): n_b2},
                  {"knarpe_attention/heads": n_b4, "knarpe_cross_attention/cluster": n_b2})}
    times, peaks, counts, bufs, routes = {}, {}, {}, {}, {}
    for arm in "adda":
        acfg, amodel, agen, want_shapes, want_routes = arms[arm]
        where = f"scaled eval call use_pallas={acfg.model.tf_cfg.use_pallas}"
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t1 = time.perf_counter()
        with recorded_launch_shapes() as shapes:
            _, bufs[arm] = joint_future_pred(acfg, amodel, batch, generator=agen, check_level=1)
        torch.cuda.synchronize()
        times.setdefault(arm, []).append(time.perf_counter() - t1)
        peaks[arm] = max(peaks.get(arm, 0.0), peak_gib())
        check_scaled_shapes(where, shapes, want_shapes)
        counts[arm], routes[arm] = launches(), dict(knarpe.ROUTE_LAUNCHES)
        by_route = {key: want_routes.get(key, 0) for key in routes[arm]}
        if counts[arm] != expected_launches(acfg, n_step) or routes[arm] != by_route:
            raise AssertionError(f"{where}: launches {counts[arm]}, by route {routes[arm]}, expected "
                                 f"{expected_launches(acfg, n_step)}, by route {by_route}")
    buf, pbuf = bufs["a"], bufs["d"]
    eval_counts, pallas_counts = counts["a"], counts["d"]
    if tuple(buf.pred_pose.shape) != (n_sc, k, n_ag, n_step, 3) or not (torch.isfinite(buf.pred_pose).all()
                                                                         and torch.isfinite(buf.log_prob).all()):
        raise AssertionError(f"scaled eval call: pred_pose {tuple(buf.pred_pose.shape)} or not finite")
    past = n_logged - 1  # buffer index of step 91, the first the log does not hold
    free = int(torch.nonzero(~buf.tl_state_nll_invalid.flatten(0, 2).all(0)).max()) + 1  # first all-invalid index
    if not (buf.tl_state_nll_invalid[..., past:].all() and not buf.mask_teacher_forcing[..., past:].any()):
        raise AssertionError("scaled eval call: TL NLL not masked or agents forced past the log")
    if tuple(pbuf.pred_pose.shape) != tuple(buf.pred_pose.shape) or not torch.isfinite(pbuf.pred_pose).all():
        raise AssertionError("scaled eval call use_pallas=True: poses out of shape or not finite")
    eval_s, pallas_s = (float(np.median(times[arm])) for arm in "ad")
    log(f"  (a) scaled_config use_pallas=False joint_future_pred: {n_sc} scenarios x K={k}, {n_ag} agents, "
        f"{cfg.data.n_mp} polylines, {n_step} steps ({n_logged} logged), {n_params} parameters, bf16 compute: warm-up "
        f"{t_warm:.3f} s, seconds per call {[round(t, 4) for t in times['a']]} (median {eval_s:.4f} s), "
        f"{n_sc * k * n_ag * (n_step - cfg.time_step_current) / eval_s:.1f} agent-steps/s, peak memory "
        f"{peaks['a']:.2f} GiB; launches per call {eval_counts} (B1 all at {list(knn_eval[1:])}); poses "
        f"{list(buf.pred_pose.shape)} finite; from buffer index {free} on (history ends there) and so past index "
        f"{past}: TL NLL masked, no agent forced [{card}]")
    log(f"  (d) scaled_config use_pallas=True joint_future_pred: warm-up {t_pwarm:.3f} s, seconds per call "
        f"{[round(t, 4) for t in times['d']]} (median {pallas_s:.4f} s) against (a)'s median {eval_s:.4f} s, in turns "
        f"a d d a ({pallas_s - eval_s:+.4f} s), peak memory {peaks['d']:.2f} GiB; launches per call {pallas_counts}, "
        f"by route {routes['d']} (B4 at {list(SCALED_ATTN_PATH)} on the heads route, B2 at {list(SCALED_X_PATH)} on "
        f"the cluster route, shapes phase 3 checked); poses finite [{card}]")
    del pmodel, arms
    torch.cuda.empty_cache()

    # (b) the training step at the preset's batch_size_train
    t0 = time.perf_counter()
    n_train = cfg.batch_size_train
    step = train_lib.make_train_step(cfg, model, *make_optimizer(cfg.optimizer, model))
    tbatch = train_lib.batch_to_device(make_batch(cfg.data, n_sc=n_train, seed=0), torch.device("cuda"))
    step(tbatch, gen)
    torch.cuda.synchronize()
    t_warm = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    times, metrics = [], []
    for _ in range(2):
        reset_launches()
        t1 = time.perf_counter()
        with recorded_launch_shapes() as shapes:
            m = step(tbatch, gen)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t1)
        metrics.append({key: float(v) for key, v in m.items()})
        check_scaled_shapes("scaled training step", shapes,
                            {("knn_xy", n_train, KNN_SRC, KNN_TGT, KNN_K): 2 * n_step + 1})
        # every parameter has a finite gradient, non-zero but for the action head's log_std: with deterministic
        # training actions the loss reads the action distribution's mean only (JAX's gradient there is 0 too)
        grads = {n: p.grad for n, p in model.named_parameters()}
        bad = [n for n, g in grads.items() if g is None or not bool(torch.isfinite(g).all())]
        zero = [n for n, g in grads.items() if n not in bad and not bool(g.any())]
        unread = [n for n in zero if cfg.training_deterministic_action and n.startswith("action_head.log_std")]
        if bad or zero != unread:
            raise AssertionError(f"scaled training step: parameters without a finite gradient {bad[:8]}, with a zero "
                                 f"one {zero[:8]}")
    train_counts, train_peak = launches(), peak_gib()
    if train_counts != expected_train_launches(cfg):
        raise AssertionError(f"scaled training step: launches {train_counts}, expected {expected_train_launches(cfg)}")
    if not all(math.isfinite(mm["training/loss"]) and math.isfinite(mm["grad_norm"]) and mm["grad_norm"] > 0
               for mm in metrics):
        raise AssertionError(f"scaled training step: metrics {metrics}")
    train_s = float(np.median(times))
    log(f"  (b) scaled_config use_pallas=False training step, batch {n_train}: warm-up {t_warm:.3f} s, seconds per "
        f"step {[round(t, 4) for t in times]} (median {train_s:.4f} s), {n_train / train_s:.4f} train samples/s, "
        f"peak memory {train_peak:.2f} GiB, losses {[round(mm['training/loss'], 4) for mm in metrics]}, grad_norm "
        f"{[round(mm['grad_norm'], 4) for mm in metrics]}, all {len(grads)} parameters with a finite, non-zero "
        f"gradient but the {len(unread)} log_std the loss does not read; launches per step {train_counts} (B1 all "
        f"at {[n_train, *knn_eval[2:]]}) [{card}]")

    # (c) the validation step
    t0 = time.perf_counter()
    vstep = eval_runner.make_validate_step(cfg, model)
    vbatch = train_lib.batch_to_device(batch, torch.device("cuda"))
    vstep(vbatch, gen)
    torch.cuda.synchronize()
    t_warm = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    split = {}
    t1 = time.perf_counter()
    with recorded_launch_shapes() as shapes:
        out = vstep(vbatch, gen, split=split)
    val_s = time.perf_counter() - t1
    val_counts, val_peak = launches(), peak_gib()
    check_scaled_shapes("scaled validation step", shapes, {knn_eval: n_step, ("knn_xy", n_sc, KNN_SRC, KNN_TGT, KNN_K):
                                                            n_step + 1})
    if val_counts != expected_validate_launches(cfg):
        raise AssertionError(f"scaled validation step: launches {val_counts}, expected "
                             f"{expected_validate_launches(cfg)}")
    n_fut = cfg.time_step_gt - cfg.time_step_current
    realism = {key: v.float().cpu() for key, v in out["wosac_realism"].items()}
    loss = {key: float(v) for key, v in out["loss_metrics"].items()}
    if not (tuple(out["womd_trajs"].shape) == (n_sc, n_ag, 6, n_fut // 5, 3)
            and tuple(out["wosac_trajs"].shape) == (n_sc, 32, n_ag, n_step - cfg.time_step_current, 3)
            and all(torch.isfinite(out[key]).all() for key in ("womd_trajs", "womd_scores", "wosac_trajs"))
            and all(bool(torch.isfinite(v).all()) for v in realism.values())
            and all(math.isfinite(v) for v in loss.values()) and float(out["err_sums"]["err_counter"]) > 0):
        raise AssertionError(f"scaled validation step: outputs out of shape or not finite: losses {loss}")
    log(f"  (c) scaled_config validation step, {n_sc} scenarios, K={k}, native realism: warm-up {t_warm:.3f} s, "
        f"split step {val_s:.4f} s: { {part: round(split.get(part, 0.0), 4) for part in eval_runner.SPLIT_PARTS} }, "
        f"{n_sc / val_s:.4f} scenarios/s, peak memory {val_peak:.2f} GiB; launches per step {val_counts} (B1 "
        f"{n_step} at {list(knn_eval[1:])}, {n_step + 1} at {[n_sc, *knn_eval[2:]]}); WOMD modes over the {n_fut} "
        f"logged future steps, WOSAC futures over all {n_step - cfg.time_step_current}, realism over the logged ones: "
        f"metametric {[round(v, 4) for v in realism['metametric'].tolist()]}, val loss "
        f"{loss['reactive_replay/loss']:.4f} [{card}]")

    del model, step, vstep
    torch.cuda.empty_cache()

    # (e) the TL pass past the log, card against CPU at reduced depth
    t0 = time.perf_counter()
    check_train_step_card_vs_cpu(use_pallas=False, time_step_end=SCALED_CHECK_END)
    check_validate_card_vs_cpu(use_pallas=False, time_step_end=SCALED_CHECK_END)
    log(f"  (e) phase-4 config at {SCALED_CHECK_END} steps against 31 logged, card vs CPU: "
        f"{time.perf_counter() - t0:.1f} s")
    log(f"  phase 13 {time.perf_counter() - t_phase:.1f} s [{card}]")
    return {"eval": eval_counts, "train": train_counts, "validate": val_counts,
            "eval_use_pallas": pallas_counts}, first_errs


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; the port's main path needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    card = card_line()
    log(f"[1/13] device: {torch.cuda.get_device_name(0)}; nvidia-smi: {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"  torch {torch.__version__} cuda {torch.version.cuda}; allow_tf32 matmul="
        f"{torch.backends.cuda.matmul.allow_tf32} cudnn={torch.backends.cudnn.allow_tf32}")

    t0 = time.perf_counter()
    with ThreadPoolExecutor(3) as pool:  # one nvcc per source, all at once
        for fut in [pool.submit(knn.load_library), pool.submit(knarpe.load_library),
                    pool.submit(knarpe.load_bwd_library)]:
            fut.result()
    log(f"[2/13] build: csrc/knn.cu, csrc/knarpe.cu and csrc/knarpe_bwd.cu in {time.perf_counter() - t0:.2f} s")

    log("[3/13] kernels vs plain versions")
    rows = [check_knn_kernel(), *check_knarpe_kernels()]
    bwd_rows = check_knarpe_bwd_kernels()

    log("[4/13] slice checked: reduced-depth fp32 config, 512 polylines, card vs CPU")
    check_slice_card_vs_cpu(use_pallas=False)
    check_slice_card_vs_cpu(use_pallas=True)

    log("[5/13] slice at full width, use_pallas=False")
    run_full_width(card, use_pallas=False)

    log("[6/13] slice at full width, use_pallas=True (the KNARPE attention kernels)")
    counts, routes = run_full_width(card, use_pallas=True, replay_rules=True)

    log("[7/13] train step checked: reduced-depth fp32 config, 512 polylines, card vs CPU")
    check_train_step_card_vs_cpu(use_pallas=False)
    check_train_step_card_vs_cpu(use_pallas=True)

    log("[8/13] training at full width, use_pallas=True (the KNARPE kernels and their backwards)")
    train_counts, train_routes, train_bwd_shapes = run_train_full_width(card)

    log("[9/13] validation step: reduced-depth fp32 config card vs CPU, then full width")
    check_validate_card_vs_cpu(use_pallas=False)
    check_validate_card_vs_cpu(use_pallas=True)
    validate_counts = run_validate_full_width(card)

    log("[10/13] submission: test_submission at full width, K=128")
    run_submission(card)

    log("[11/13] the training entry point: run.fit card vs CPU, run.main fit / resume / SIGTERM / validate / test")
    fit_counts = run_fit_phase(card)

    log("[12/13] reference-torch goldens: through the kernels and the card's plain path; the flagship through the "
        "reference layout")
    layout_counts = run_golden_phase(card)

    log("[13/13] the scaled preset at full width: eval, training, validation, eval through the kernels (B4 heads, "
        "B2 cluster route); the TL pass past the log, card vs CPU")
    scaled_counts, first_errs = run_scaled_phase(card)
    by_route = lambda counts, kernel: {key.split("/")[1]: n for key, n in counts.items() if key.split("/")[0] == kernel}
    for row in rows:
        row["launches"] = counts[row["name"]]
        row["validate_launches"] = validate_counts[row["name"]]  # per full-width validation step (phase 9)
        row["fit_launches"] = fit_counts[row["name"]]  # per full-width fit step at batch 2 (phase 11)
        row["reference_layout_launches"] = layout_counts[row["name"]]  # phase 12 (b)'s call
        # per call or step of phase 13's paths at scaled_config(): eval (a), training (b), validation (c), and the
        # eval call through the kernels (d), whose B4 launches all take the heads route and B2's the cluster route
        row["scaled_launches"] = {path: counts_[row["name"]] for path, counts_ in scaled_counts.items()}
    for row, key in ((rows[1], "heads_route"), (rows[2], "cluster_route")):  # launches per (d) call, (d)'s first
        row[key].update(launches=scaled_counts["eval_use_pallas"][row["name"]],  # launch's error
                        path_launch_max_abs_err=first_errs[row["name"]])
    rows[0]["training_shape"]["launches"] = train_counts["knn_xy"]  # B1: 180 at this shape, 1 posterior TL
    b4 = rows[1]  # per eval call (phase 6), and at the training shape per step (phase 8)
    b4["launches_by_route"] = by_route(routes, "knarpe_attention")
    b4["training_shape"].update(launches=train_counts["knarpe_attention"],
                                launches_by_route=by_route(train_routes, "knarpe_attention"))
    for row in bwd_rows:
        row["launches"] = train_counts[row["name"]]
        row["fit_launches"] = fit_counts[row["name"]]
        row["scaled_launches"] = {path: counts_[row["name"]] for path, counts_ in scaled_counts.items()}
        row["launches_by_route"] = by_route(train_routes, row["name"])
        if row["name"] == "knarpe_cross_attention_bwd":  # of the 368, per step
            row["post_tl_shape"]["launches"] = train_bwd_shapes[("knarpe_cross_attention", *POST_TL_X_PATH[2:])]
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
