"""Time this tree's forward kernels against another tree's sources, in turns, on one GPU.

    python -m trafficbotsv15_tpu_torch.utils.ab_knarpe [--other PATH/TO/csrc/knarpe.cu]
        [--other-knn PATH/TO/csrc/knn.cu] [--rounds 3] [--calls ROUNDS] [--steps ROUNDS]

Builds the other sources with the nvcc flags of `utils/build.py` (and
`ops/knn.py::NVCC_FLAGS` for knn.cu) into `build/` and binds their
`knarpe_launch` / `knn_xy_launch`, whose C interfaces both trees share; the
wrappers then launch through one library or the other. With `--other`, on
the same bf16 inputs (numpy seed 1; 30 % of targets invalid), for B2
(`knarpe_cross_attention`) and B3 (`knarpe_cross_attention_v3`) at the eval
path's shape [128·64 sources, K=89, D=R=128, H=4] and the training path's
[8·64, K=89], and B4 (`knarpe_attention`) at the eval path's [4·1024, K=32].
With `--other-knn`, B1 (`knn_xy`) at the eval path's [128, 64, 1024] and the
training path's [8, 64, 1024], k=64 (numpy seed 1; coordinates uniform in
±100 m, 20 % of sources and targets invalid). Each case times the other
library and this one ROUNDS times in the order other, this, this, other, each
time as the device time of 50 launches captured in a CUDA graph (no host
launch cost; at the training shapes eager launches are bound by the host)
and as the CUDA-event time of 50 eager launches; it prints each side's
medians and their ratio, and each output's largest distance from the float32
plain version (B1: whether indices and distances equal the plain version's
exactly). With `--calls`, it also times the full-width `joint_future_pred`
(`leaderboard_config()`, `use_pallas=True`, 4 scenarios x K=32,
check_level=1) and with `--steps` the full-width training step (8
scenarios), whole calls in the same turns, one set of libraries against the
other. Needs a CUDA device; prints the card's name and power limit, and one
JSON line last.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import hashlib
import json
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
from trafficbotsv15_tpu_torch.utils.timing import cuda_ms, graph_ms

# (kernel, label, (n_b, n_s, K, D, R, H))
CASES = [("knarpe_cross_attention", "eval", (128, 64, 89, 128, 128, 4)),
         ("knarpe_cross_attention", "train", (8, 64, 89, 128, 128, 4)),
         ("knarpe_cross_attention_v3", "eval", (128, 64, 89, 128, 128, 4)),
         ("knarpe_cross_attention_v3", "train", (8, 64, 89, 128, 128, 4)),
         ("knarpe_attention", "eval", (4, 1024, 32, 128, 128, 4))]
# (label, (n_rows, n_src, n_tgt, k))
KNN_CASES = [("eval", (128, 64, 1024, 64)), ("train", (8, 64, 1024, 64))]
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
    """The wrappers launch through fns[module] (a bound C entry point) inside the block."""
    real = {module: module._LAUNCH_FN for module in fns}
    for module, fn in fns.items():
        module._LAUNCH_FN = fn
    try:
        yield
    finally:
        for module, fn in real.items():
            module._LAUNCH_FN = fn


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
    ap.add_argument("--rounds", type=int, default=3, help="rounds of other, this, this, other per kernel case")
    ap.add_argument("--calls", type=int, default=0, help="rounds of full-width joint_future_pred calls")
    ap.add_argument("--steps", type=int, default=0, help="rounds of full-width training steps")
    args = ap.parse_args()
    if args.other is None and args.other_knn is None:
        ap.error("give --other, --other-knn or both")
    if not torch.cuda.is_available():
        raise SystemExit("ab_knarpe: needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    libs = {"this": {}, "other": {}}  # side -> {module: bound launch}
    if args.other is not None:
        libs["this"][knarpe] = knarpe.load_library()
        libs["other"][knarpe] = knarpe.bind_launch(build_other(args.other.resolve(), "knarpe"))
    if args.other_knn is not None:
        libs["this"][knn] = knn.load_library()
        libs["other"][knn] = knn.bind_launch(build_other(args.other_knn.resolve(), "knn", knn.NVCC_FLAGS))
    results = {"card": card, "kernels": [], "calls": None, "steps": None}
    for kernel, label, shape in CASES if args.other is not None else []:
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
        step = train_lib.make_train_step(cfg, model, *make_optimizer(cfg.optimizer, model))
        batch = batch_to_device(make_batch(cfg.data, n_sc=8, seed=0), torch.device("cuda"))
        gen = torch.Generator().manual_seed(0)
        results["steps"] = whole(libs, lambda: step(batch, gen), args.steps, "training step, use_pallas=True", card)
    print(json.dumps(results))


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
