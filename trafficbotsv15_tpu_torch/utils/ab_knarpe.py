"""Time this tree's kernels against another tree's sources, in turns, on one GPU.

    python -m trafficbotsv15_tpu_torch.utils.ab_knarpe [--other PATH/TO/csrc/knarpe.cu]
        [--other-knn PATH/TO/csrc/knn.cu] [--other-bwd PATH/TO/csrc/knarpe_bwd.cu] [--split]
        [--rounds 3] [--only TEXT] [--calls ROUNDS] [--steps ROUNDS]

Builds the other sources with the nvcc flags of `utils/build.py` (and
`ops/knn.py::NVCC_FLAGS` for knn.cu) into `build/` and binds their
`knarpe_launch` / `knn_xy_launch` / `knarpe_bwd_launch`, whose C interfaces
both trees share; the wrappers then launch through one library or the other.
With `--other`, on
the same bf16 inputs (numpy seed 1; 30 % of targets invalid), for B2
(`knarpe_cross_attention`) and B3 (`knarpe_cross_attention_v3`) at the eval
path's shape [128·64 sources, K=89, D=R=128, H=4] and the training path's
[8·64, K=89], both also at the scaled preset's eval shape [128·64, K=89,
D=R=256, H=8] (this tree's cluster route for B2 and heads route for B3 against,
say, the parent's general kernel: the route is named by this tree, the launch
goes through the side's library), B2 at pose_rpe "xy_dir"'s 4-wide RPE at the
eval and training shapes [128·64, K=89, D=128, R=4, H=4] and [8·64, K=89] and
B3 at the former, and B4 (`knarpe_attention`) at the eval path's [4·1024, K=32]
and the training path's [8·1024, K=32], and at the scaled preset's eval
[4·1024, K=32, D=R=256, H=8] and training [1·1024] shapes (this tree's heads
route against, say, the parent's general kernel) (k and v the halves of one
[.., 2D] tensor, as the map encoder passes them).
With `--other-knn`, B1 (`knn_xy`) at the eval path's [128, 64, 1024] and the
training path's [8, 64, 1024], k=64 (numpy seed 1; coordinates uniform in
±100 m, 20 % of sources and targets invalid). Each case times the other
library and this one ROUNDS times in the order other, this, this, other, each
time as the device time of 50 launches captured in a CUDA graph (no host
launch cost; at the training shapes eager launches are bound by the host)
and as the CUDA-event time of 50 eager launches; it prints each side's
medians and their ratio, and each output's largest distance from the float32
plain version (B1: whether indices and distances equal the plain version's
exactly). With `--other-bwd`, the B2 backward (`ops/knarpe.py::_launch_bwd`,
which B3's backward is too) at the training path's two bf16 shapes, the agent
decoder's [8·64 sources, K=89, D=R=128, H=4] and the posterior TL encoder's
[8·128, K=24], and B3's forward and backward through `knarpe_cross_attention_v3`'s
autograd Function at the same shapes (only the backward library differs between
the sides), and the B4 backward at the training path's [8·1024, K=32]; then the
scaled preset's training shapes, the B4 backward at [1·1024, K=32, D=R=256,
H=8] (this tree's heads route against, say, the parent's general kernel) and
the B2 backward (and B3's) at the agent decoder's [1·64, K=89, D=R=256, H=8] and
the posterior TL encoder's [1·128, K=24] (this tree's heads route against, say,
the parent's general kernel), and the B2 backward at d_rpe = 4 at the training
shapes [8·64, K=89, D=128, R=4, H=4] and [8·128, K=24] (numpy seed 1, 30 % of
targets invalid, one source with none); each side's gradients
against the float32 plain backward (`*_bwd_reference`), as the largest |error|
over all six gradients relative to that gradient's largest magnitude. `--only
TEXT` keeps the kernel cases whose label holds TEXT (`--only rpe4`: the d_rpe = 4
ones). With `--split`, each backward case is also traced by `torch.profiler`
through each side's library: its device time per kernel, averaged over 20
launches. With `--calls`, it also times the full-width `joint_future_pred`
(`leaderboard_config()`, `use_pallas=True`, 4 scenarios x K=32,
check_level=1) and with `--steps` the full-width training step (8
scenarios), whole calls in the same turns, one set of libraries against the
other (through every library given, the backward's included). Needs a CUDA
device; prints the card's name and power limit, and one JSON line last.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import hashlib
import json
import re
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

from trafficbotsv15_tpu_torch.config import leaderboard_config, with_pallas
from trafficbotsv15_tpu_torch.data.synthetic import make_batch
from trafficbotsv15_tpu_torch.ops import knarpe, knn
from trafficbotsv15_tpu_torch.train import pipeline as train_lib
from trafficbotsv15_tpu_torch.train.evaluation import batch_to_device, joint_future_pred
from trafficbotsv15_tpu_torch.train.optimizer import make_optimizer
from trafficbotsv15_tpu_torch.utils import build
from trafficbotsv15_tpu_torch.utils.timing import card_line, cuda_ms, graph_ms

# (kernel, label, (n_b, n_s, K, D, R, H))
CASES = [("knarpe_cross_attention", "eval", (128, 64, 89, 128, 128, 4)),
         ("knarpe_cross_attention", "train", (8, 64, 89, 128, 128, 4)),
         ("knarpe_cross_attention", "scaled_eval", (128, 64, 89, 256, 256, 8)),
         ("knarpe_cross_attention_v3", "eval", (128, 64, 89, 128, 128, 4)),
         ("knarpe_cross_attention_v3", "train", (8, 64, 89, 128, 128, 4)),
         ("knarpe_cross_attention_v3", "scaled_eval", (128, 64, 89, 256, 256, 8)),
         ("knarpe_attention", "eval", (4, 1024, 32, 128, 128, 4)),
         ("knarpe_attention", "train", (8, 1024, 32, 128, 128, 4)),
         ("knarpe_attention", "scaled_eval", (4, 1024, 32, 256, 256, 8)),
         ("knarpe_attention", "scaled_train", (1, 1024, 32, 256, 256, 8)),
         # pose_rpe "xy_dir"'s 4-wide RPE at the flagship's widths (this tree's staged route against, say, the
         # parent's general kernel)
         ("knarpe_cross_attention", "rpe4_eval", (128, 64, 89, 128, 4, 4)),
         ("knarpe_cross_attention", "rpe4_train", (8, 64, 89, 128, 4, 4)),
         ("knarpe_cross_attention_v3", "rpe4_eval", (128, 64, 89, 128, 4, 4))]
# (label, (n_rows, n_src, n_tgt, k))
KNN_CASES = [("eval", (128, 64, 1024, 64)), ("train", (8, 64, 1024, 64))]
# (kernel, label, (n_b, n_s, K, D, R, H)) of the training path's bf16 B2 and B4 backward launches, and of the scaled
# preset's training path (batch 1, D=R=256, 8 heads)
BWD_CASES = [("knarpe_cross_attention", "train", (8, 64, 89, 128, 128, 4)),
             ("knarpe_cross_attention", "post_tl", (8, 128, 24, 128, 128, 4)),
             ("knarpe_attention", "train", (8, 1024, 32, 128, 128, 4)),
             ("knarpe_attention", "scaled_train", (1, 1024, 32, 256, 256, 8)),
             ("knarpe_cross_attention", "scaled_train", (1, 64, 89, 256, 256, 8)),
             ("knarpe_cross_attention", "scaled_post_tl", (1, 128, 24, 256, 256, 8)),
             ("knarpe_cross_attention", "rpe4_train", (8, 64, 89, 128, 4, 4)),
             ("knarpe_cross_attention", "rpe4_post_tl", (8, 128, 24, 128, 4, 4))]
ORDER = ("other", "this", "this", "other")


def build_other(src: Path, name: str, extra_flags=()) -> ctypes.CDLL:
    """Compile another tree's source (its own includes resolve beside it) and load it."""
    digest = hashlib.sha256(src.read_bytes() + "\0".join(extra_flags).encode()).hexdigest()[:16]
    out = build.BUILD_DIR / f"lib{name}-other-{digest}.so"
    if not out.exists():
        build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        cmd = [build.nvcc_path(), *build.ARCH_FLAGS, *build.BASE_FLAGS, *extra_flags, "-o", str(out), str(src)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src} (rc {proc.returncode}):\n{proc.stderr}")
    return ctypes.CDLL(str(out))


@contextlib.contextmanager
def launching_with(fns: dict):
    """The wrappers launch through fns[(module, attribute)] (a bound C entry point) inside the block."""
    real = {key: getattr(*key) for key in fns}
    for (module, attr), fn in fns.items():
        setattr(module, attr, fn)
    try:
        yield
    finally:
        for (module, attr), fn in real.items():
            setattr(module, attr, fn)


def inputs(kernel: str, shape):
    n_b, n_s, n_knn, d, r, _ = shape
    rng = np.random.default_rng(1)

    def f(*size, scale=1.0):
        return torch.from_numpy((scale * rng.normal(size=size)).astype(np.float32)).to("cuda", torch.bfloat16)

    inv = torch.from_numpy(rng.uniform(size=(n_b, n_s, n_knn)) < 0.3).cuda()
    w_rpe, b = f(r, 2 * d, scale=r ** -0.5), f(2 * d, scale=0.1)
    if kernel == "knarpe_attention":
        kv = f(n_b, n_s, n_knn, 2 * d)
        return [f(n_b, n_s, d), *kv.chunk(2, -1), f(n_b, n_s, n_knn, r), inv, w_rpe, b]
    return [f(n_b, n_s, d), f(n_b, n_s, n_knn, d), f(n_b, n_s, n_knn, r), inv, f(d, 2 * d, scale=d ** -0.5), w_rpe, b]


def bwd_inputs(kernel: str, shape):
    """bf16 operands of B2 or B4 and the incoming gradient g; source 0 has no valid target."""
    ops = inputs(kernel, shape)
    ops[4 if kernel == "knarpe_attention" else 3][0, 0] = True
    rng = np.random.default_rng(2)
    g = torch.from_numpy(rng.normal(size=tuple(ops[0].shape)).astype(np.float32)).to("cuda", torch.bfloat16)
    return ops, g


def bwd_worst_err(kernel: str, grads, ops, g, n_head: int) -> float:
    """Largest |error| of the bf16 gradients against the float32 plain backward on the same bf16-valued
    inputs, each relative to its own gradient's largest magnitude."""
    plain = getattr(knarpe, f"{kernel}_bwd_reference")
    want = plain(*[a if a.dtype == torch.bool else a.float() for a in ops], g.float(), n_head)
    return max(float((a.float() - b).abs().max()) / max(float(b.abs().max()), 1e-30) for a, b in zip(grads, want))


def kernel_split(fn, n: int = 20) -> dict:
    """Device time per kernel (ms per call of fn) from a torch.profiler trace of n calls after a warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    split = {}
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", None)
        us = e.cuda_time_total if us is None else us
        if us > 0:
            name = re.sub(r"^void |\(.*$", "", e.key.replace("(anonymous namespace)::", ""))
            split[name] = split.get(name, 0.0) + us / 1e3 / n
    return split


def knn_inputs(shape):
    n_rows, n_src, n_tgt, _ = shape
    rng = np.random.default_rng(1)
    arrays = [rng.uniform(-100, 100, (n_rows, n_src, 2)), rng.uniform(size=(n_rows, n_src)) < 0.2,
              rng.uniform(-100, 100, (n_rows, n_tgt, 2)), rng.uniform(size=(n_rows, n_tgt)) < 0.2]
    return [torch.from_numpy(a.astype(np.float32) if a.dtype == np.float64 else a).cuda() for a in arrays]


def in_turns(fns: dict, rounds: int, timer) -> dict:
    """{side: [timer(fn) per turn]} over rounds of ORDER, each side launching through its libraries."""
    times = {side: [] for side in fns}
    for _ in range(rounds):
        for side in ORDER:
            launch, fn = fns[side]
            with launching_with(launch):
                times[side].append(timer(fn))
    return times


def wall_s(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def summary(times: list) -> dict:
    q1, med, q3 = (float(x) for x in np.quantile(times, [0.25, 0.5, 0.75]))
    return {"median": med, "q1": q1, "q3": q3, "all": times}


def time_case(libs: dict, call, rounds: int, what: str, card: str) -> dict:
    """Device (graph) and eager times of call() through each side's libraries, in turns."""
    fns = {side: (libs[side], call) for side in libs}
    device = in_turns(fns, rounds, graph_ms)
    eager = in_turns(fns, rounds, cuda_ms)
    row = {**{f"{side}_device_ms": summary(device[side]) for side in libs},
           **{f"{side}_eager_ms": summary(eager[side]) for side in libs}}
    dev = {side: row[f"{side}_device_ms"]["median"] for side in libs}
    eag = {side: row[f"{side}_eager_ms"]["median"] for side in libs}
    print(f"{what}: device (graph) other {dev['other']:.4f} ms, this {dev['this']:.4f} ms "
          f"({dev['other'] / dev['this']:.2f}x); eager other {eag['other']:.4f} ms, this {eag['this']:.4f} ms "
          f"({eag['other'] / eag['this']:.2f}x) [{card}]", flush=True)
    return row


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", type=Path, help="the other tree's csrc/knarpe.cu (B2, B3, B4)")
    ap.add_argument("--other-knn", type=Path, help="the other tree's csrc/knn.cu (B1)")
    ap.add_argument("--other-bwd", type=Path, help="the other tree's csrc/knarpe_bwd.cu (B2/B3-bwd, B4-bwd)")
    ap.add_argument("--split", action="store_true", help="each backward case's device time per kernel, per side")
    ap.add_argument("--rounds", type=int, default=3, help="rounds of other, this, this, other per kernel case")
    ap.add_argument("--only", default="", help="time only the kernel cases whose label contains this text "
                                               "(e.g. rpe4)")
    ap.add_argument("--calls", type=int, default=0, help="rounds of full-width joint_future_pred calls")
    ap.add_argument("--steps", type=int, default=0, help="rounds of full-width training steps")
    args = ap.parse_args()
    if args.other is None and args.other_knn is None and args.other_bwd is None:
        ap.error("give --other, --other-knn, --other-bwd or several")
    if not torch.cuda.is_available():
        raise SystemExit("ab_knarpe: needs a CUDA device")
    card = card_line()
    libs = {"this": {}, "other": {}}  # side -> {(module, attribute): bound launch}
    if args.other is not None:
        libs["this"][knarpe, "_LAUNCH_FN"] = knarpe.load_library()
        libs["other"][knarpe, "_LAUNCH_FN"] = knarpe.bind_launch(build_other(args.other.resolve(), "knarpe"))
    if args.other_knn is not None:
        libs["this"][knn, "_LAUNCH_FN"] = knn.load_library()
        libs["other"][knn, "_LAUNCH_FN"] = knn.bind_launch(build_other(args.other_knn.resolve(), "knn",
                                                                       knn.NVCC_FLAGS))
    if args.other_bwd is not None:
        libs["this"][knarpe, "_BWD_FN"] = knarpe.load_bwd_library()
        libs["other"][knarpe, "_BWD_FN"] = knarpe.bind_bwd_launch(build_other(args.other_bwd.resolve(),
                                                                              "knarpe_bwd"))
    results = {"card": card, "kernels": [], "backward": [], "calls": None, "steps": None}
    for kernel, label, shape in CASES if args.other is not None else []:
        if args.only not in label:
            continue
        ops = inputs(kernel, shape)
        n_head = shape[-1]
        call = getattr(knarpe, kernel)
        plain = getattr(knarpe, f"{kernel}_reference")(*[a if a.dtype == torch.bool else a.float() for a in ops],
                                                       n_head)
        row = {"kernel": kernel, "shape": label, "dims": list(shape),
               **time_case(libs, lambda: call(*ops, n_head), args.rounds, f"{kernel} {label} {list(shape)}", card)}
        for side in libs:
            with launching_with(libs[side]):
                row[f"{side}_max_err_vs_f32_plain"] = float((call(*ops, n_head).float() - plain).abs().max())
        print(f"  max |out - f32 plain| other {row['other_max_err_vs_f32_plain']:.3e}, this "
              f"{row['this_max_err_vs_f32_plain']:.3e}", flush=True)
        results["kernels"].append(row)
    for label, shape in KNN_CASES if args.other_knn is not None else []:
        if args.only not in label:
            continue
        ops, k = knn_inputs(shape), shape[-1]
        row = {"kernel": "knn_xy", "shape": label, "dims": list(shape),
               **time_case(libs, lambda: knn.knn_xy(*ops, k), args.rounds, f"knn_xy {label} {list(shape)}", card)}
        d_ref, i_ref = knn.knn_xy_reference(*ops, k)
        for side in libs:
            with launching_with(libs[side]):
                d, i = knn.knn_xy(*ops, k)
            row[f"{side}_equals_plain"] = bool(torch.equal(d, d_ref) and torch.equal(i, i_ref))
        print(f"  indices and distances equal to the plain version: other {row['other_equals_plain']}, "
              f"this {row['this_equals_plain']}", flush=True)
        results["kernels"].append(row)
    for kernel, label, shape in BWD_CASES if args.other_bwd is not None else []:
        if args.only not in label:
            continue
        results["backward"] += time_bwd(libs, kernel, label, shape, args.rounds, args.split, card)

    if args.calls:
        cfg = with_pallas(leaderboard_config(), True)
        batch = make_batch(cfg.data, n_sc=4, seed=0)
        model = train_lib.build_model(cfg, seed=0, device="cuda")
        gen = torch.Generator().manual_seed(0)
        fn = lambda: joint_future_pred(cfg, model, batch, generator=gen, check_level=1)
        results["calls"] = whole(libs, fn, args.calls, "joint_future_pred call, use_pallas=True", card)
    if args.steps:
        cfg = with_pallas(leaderboard_config(), True)
        model = train_lib.build_model(cfg, seed=0, device="cuda")
        step = train_lib.make_train_step(cfg, model, *make_optimizer(cfg.optimizer, model.named_parameters()))
        batch = batch_to_device(make_batch(cfg.data, n_sc=8, seed=0), torch.device("cuda"))
        gen = torch.Generator().manual_seed(0)
        results["steps"] = whole(libs, lambda: step(batch, gen), args.steps, "training step, use_pallas=True", card)
    print(json.dumps(results))


def time_bwd(libs: dict, kernel: str, label: str, shape, rounds: int, split: bool, card: str) -> list:
    """The backward launch of B2 or B4 alone, and for B2 also B3's forward and backward through its
    autograd Function, through each side's backward library, in turns; each side's error against the
    float32 plain backward."""
    n_head = shape[-1]
    ops, g = bwd_inputs(kernel, shape)
    if kernel == "knarpe_attention":
        q, k, v, rpe, inv, w_rpe, b = ops
        launch = lambda: knarpe._launch_bwd(kernel, q, k, v, None, rpe, inv, None, w_rpe, b, g, n_head)
    else:
        q, tgt, rpe, inv, w_kv, w_rpe, b = ops
        launch = lambda: knarpe._launch_bwd(kernel, q, None, None, tgt, rpe, inv, w_kv, w_rpe, b, g, n_head)
    cases = [(f"{kernel}_bwd", kernel, "backward launch", launch,
              lambda: [t for t in launch() if t is not None])]
    if kernel == "knarpe_cross_attention":
        leaves = [a.clone().requires_grad_(a.is_floating_point()) for a in ops]
        want = [a for a in leaves if a.requires_grad]
        b3 = lambda: torch.autograd.grad(knarpe.knarpe_cross_attention_v3(*leaves, n_head), want, g)
        cases.append(("knarpe_cross_attention_v3", kernel, "forward + backward through the Function", b3, b3))
    rows = []
    for name, plain, what, call, grads in cases:
        is_launch = name.endswith("_bwd")
        row = {"kernel": name, "what": what, "shape": label, "dims": list(shape),
               **time_case(libs, call, rounds, f"{name} {what} {label} {list(shape)}", card)}
        for side in libs:
            with launching_with(libs[side]):
                row[f"{side}_worst_rel_err_vs_f32_plain"] = bwd_worst_err(plain, grads(), ops, g, n_head)
                if split and is_launch:
                    row[f"{side}_split_ms"] = kernel_split(call)
        print(f"  max |grad - f32 plain| / max |grad|: other {row['other_worst_rel_err_vs_f32_plain']:.3e}, this "
              f"{row['this_worst_rel_err_vs_f32_plain']:.3e}", flush=True)
        for side in libs if split and is_launch else []:
            print(f"  {side}'s device time per kernel (torch.profiler, ms per launch): "
                  f"{ {k: round(v, 5) for k, v in row[f'{side}_split_ms'].items()} } [{card}]", flush=True)
        rows.append(row)
    return rows


def whole(libs: dict, fn, rounds: int, what: str, card: str) -> dict:
    """Seconds of whole calls of fn in turns, after one warm-up call through each library."""
    for side in libs:
        with launching_with(libs[side]):
            wall_s(fn)
    times = in_turns({side: (libs[side], fn) for side in libs}, rounds, wall_s)
    out = {side: summary(times[side]) for side in libs}
    print(f"{what}, {rounds} rounds of other, this, this, other: other median {out['other']['median']:.4f} s "
          f"(quartiles {out['other']['q1']:.4f}-{out['other']['q3']:.4f}), this median {out['this']['median']:.4f} s "
          f"(quartiles {out['this']['q1']:.4f}-{out['this']['q3']:.4f}); all other "
          f"{[round(t, 4) for t in times['other']]}, this {[round(t, 4) for t in times['this']]} [{card}]", flush=True)
    return out


if __name__ == "__main__":
    main()
