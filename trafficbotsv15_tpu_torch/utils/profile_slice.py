"""Where the time of the full-width joint-future call, or of a training step, goes, on one GPU.

    python -m trafficbotsv15_tpu_torch.utils.profile_slice [--use-pallas] [--out DIR] [--ab ROUNDS] [--train]
                                                          [--validate] [--serve]

Runs `joint_future_pred` on `leaderboard_config()` (bf16 compute, seeded
random weights, 4 synthetic scenarios x K=32 futures, check_level=1; with
`--use-pallas`, `TransformerCfg.use_pallas=True`, so the map encoder and the
agent decoder run the KNARPE attention kernels) once to warm up, then:
  - times the phases (scene preparation incl. the TL pre-pass, and the
    K-replicated rollout) with host clocks around synchronised work;
  - traces one whole call with torch.profiler and prints the top device
    kernels by total time, the device busy time (sum of kernel times; one
    stream) against the wall time, and hence the device's idle share;
  - writes the Chrome trace to DIR when given.
With `--ab ROUNDS` it instead times whole calls of three arms in turns,
ROUNDS times in the order A B C C B A: use_pallas=False and True at
check_level=1, and use_pallas=False at check_level=0 (so the first and the
last arm differ by the level-1 rule checks alone); it prints each arm's
seconds per call (median, quartiles) and agent-steps/s.
With `--train` it profiles `make_train_step` instead: `leaderboard_config()`
(bf16 compute, f32 parameters), 8 synthetic scenarios per step as the JAX
package's `bench.py` trains, one warm-up step, then the seconds of 3 steps
and of 3 forwards alone (training_forward without backward and update),
train samples/s (8 / seconds per step), peak memory, and one traced step:
device busy and idle share and the top device ops.
With `--validate` it profiles the validation step (`eval/runner.py::make_validate_step`) instead:
`leaderboard_config()`, 4 synthetic scenarios, K=32, check_level=1, native realism; one warm-up step, the
seconds of 3 steps (wosac_validate_scenarios_per_sec_per_chip = 4 / seconds per step), peak memory, the
median of 3 steps split by part (reactive replay, joint futures, post-processing and metrics, realism;
synchronised at the part boundaries), and one traced step: device busy and idle share and the top device ops.
With `--serve` it profiles the serving step (`serve.py::InteractiveSimulator.step`) instead: `leaderboard_config()`,
one synthetic scenario, reset once, 3 warm-up steps, then 3 runs of 50 steps with fetch=False, each ending in one
synchronize (`bench.py`'s serve definition: ms per step, serve_policy_steps_per_sec), peak memory, and 10 traced
steps: device busy and idle share and the top device ops.
Needs a CUDA device; prints the card's name and power limit with the numbers.
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import torch

from trafficbotsv15_tpu_torch.config import leaderboard_config, with_pallas
from trafficbotsv15_tpu_torch.data.synthetic import make_batch
from trafficbotsv15_tpu_torch.train import evaluation as ev
from trafficbotsv15_tpu_torch.train import pipeline as tp
from trafficbotsv15_tpu_torch.train.optimizer import make_optimizer
from trafficbotsv15_tpu_torch.train.pipeline import build_model
from trafficbotsv15_tpu_torch.utils.timing import card_line


def compare_arms(card: str, rounds: int) -> None:
    """Whole-call seconds of three arms, timed in turns (A B C C B A per round)."""
    base = leaderboard_config()
    n_sc, k = 4, base.n_joint_future_wosac
    batch = make_batch(base.data, n_sc=n_sc, seed=0)
    arms = {"use_pallas=False check_level=1": (False, 1), "use_pallas=True check_level=1": (True, 1),
            "use_pallas=False check_level=0": (False, 0)}
    runs = {}
    for name, (use_pallas, level) in arms.items():
        cfg = with_pallas(base, use_pallas)
        model = build_model(cfg, seed=0, device="cuda")
        gen = torch.Generator().manual_seed(0)

        def call(cfg=cfg, model=model, gen=gen, level=level):
            return ev.joint_future_pred(cfg, model, batch, generator=gen, check_level=level)

        _timed(call)  # warm-up
        runs[name] = call
    times = {name: [] for name in arms}
    order = list(arms) + list(arms)[::-1]
    for _ in range(rounds):
        for name in order:
            times[name].append(_timed(runs[name])[1])
    agent_steps = n_sc * k * base.data.n_ag * (base.time_step_end - base.time_step_current)
    print(f"card: {card}; {rounds} rounds of A B C C B A, {2 * rounds} calls per arm")
    for name, ts in times.items():
        q1, med, q3 = (float(x) for x in torch.tensor(ts).quantile(torch.tensor([0.25, 0.5, 0.75])))
        print(f"{name}: median {med:.4f} s per call (quartiles {q1:.4f}-{q3:.4f}, min {min(ts):.4f}, "
              f"max {max(ts):.4f}), {agent_steps / med:.1f} agent-steps/s; all {[round(t, 4) for t in ts]}")


def _timed(fn, repeats: int = 1):
    """(last result, median seconds) of fn over synchronised repeats."""
    times = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return out, sorted(times)[len(times) // 2]


def _trace(fn, n_step: int, t_untraced: float, out, name: str) -> None:
    """Trace one call of fn: device busy time, idle share against t_untraced, the top device ops."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        _, t_prof = _timed(fn)
    events = prof.key_averages()
    # device-side rows only (kernels, memcpy/memset): the operator rows repeat their time
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e6
    n_launch = sum(e.count for e in kernels)
    print(f"traced call {t_prof:.4f} s wall (profiler on); device busy {busy:.4f} s in {n_launch} device ops "
          f"({n_launch / n_step:.0f} per rollout step); idle share of the untraced call "
          f"{1 - busy / t_untraced:.3f}")
    print(events.table(sort_by="self_device_time_total", row_limit=25, max_name_column_width=60))
    if out is not None:
        out.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(out / f"{name}_trace.json"))


def profile_train(card: str, use_pallas: bool, out) -> None:
    """The training step at full width: seconds per step, samples/s, peak memory, one traced step."""
    cfg = with_pallas(leaderboard_config(), use_pallas)
    n_sc = 8
    model = build_model(cfg, seed=0, device="cuda")
    step = tp.make_train_step(cfg, model, *make_optimizer(cfg.optimizer, model.named_parameters()))
    batch = make_batch(cfg.data, n_sc=n_sc, seed=0)
    dev_batch = ev.batch_to_device(batch, torch.device("cuda"))
    gen = torch.Generator().manual_seed(0)
    _timed(lambda: step(dev_batch, gen))  # warm-up
    torch.cuda.reset_peak_memory_stats()
    _, t_step = _timed(lambda: step(dev_batch, gen), 3)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    noise = tp.draw_training_noise(cfg, dev_batch, gen, "cuda")
    _, t_fwd = _timed(lambda: tp.training_forward(cfg, model, dev_batch, noise)[0].detach(), 3)
    print(f"card: {card}; training step, use_pallas={use_pallas}, {n_sc} scenarios, bf16 compute")
    print(f"medians of 3: step {t_step:.4f} s ({n_sc / t_step:.3f} train samples/s) | forward alone {t_fwd:.4f} s | "
          f"backward and update {t_step - t_fwd:.4f} s | peak memory {peak:.2f} GiB")
    _trace(lambda: step(dev_batch, gen), cfg.time_step_end, t_step, out,
           f"train_step_{'use_pallas' if use_pallas else 'plain'}")


def profile_validate(card: str, use_pallas: bool, out) -> None:
    """The validation step at full width: seconds per step, scenarios/s, peak memory, the split by part, one
    traced step."""
    from trafficbotsv15_tpu_torch.eval.runner import SPLIT_PARTS, make_validate_step

    cfg = with_pallas(leaderboard_config(), use_pallas)
    n_sc = 4
    model = build_model(cfg, seed=0, device="cuda")
    step = make_validate_step(cfg, model)
    batch = ev.batch_to_device(make_batch(cfg.data, n_sc=n_sc, seed=0), torch.device("cuda"))
    gen = torch.Generator().manual_seed(0)
    _timed(lambda: step(batch, gen))  # warm-up
    torch.cuda.reset_peak_memory_stats()
    _, t_step = _timed(lambda: step(batch, gen), 3)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    splits = []
    for _ in range(3):
        split = {}
        step(batch, gen, split=split)
        splits.append(split)
    parts = {p: sorted(s[p] for s in splits)[1] for p in SPLIT_PARTS}
    print(f"card: {card}; validation step, use_pallas={use_pallas}, {n_sc} scenarios x K={cfg.n_joint_future_wosac}, "
          f"check_level=1, native realism")
    print(f"median of 3: step {t_step:.4f} s ({n_sc / t_step:.4f} wosac_validate_scenarios_per_sec_per_chip), peak "
          f"memory {peak:.2f} GiB | split, medians of 3 synchronised steps: "
          + " | ".join(f"{p} {t:.4f} s" for p, t in parts.items()))
    _trace(lambda: step(batch, gen), 2 * cfg.time_step_end, t_step, out,
           f"validate_step_{'use_pallas' if use_pallas else 'plain'}")


def profile_serve(card: str, use_pallas: bool, out) -> None:
    """The serving step at full width: ms per step, peak memory, 10 traced steps."""
    from trafficbotsv15_tpu_torch.serve import InteractiveSimulator

    cfg = with_pallas(leaderboard_config(), use_pallas)
    sim = InteractiveSimulator(cfg, build_model(cfg, seed=0, device="cuda"))
    torch.cuda.reset_peak_memory_stats()
    sim.reset(make_batch(cfg.data, n_sc=1, seed=0), torch.Generator().manual_seed(0))

    def steps(n: int):
        for _ in range(n):
            out = sim.step(fetch=False)
        return out

    n_step = 50
    _timed(lambda: steps(3))  # warm-up
    _, t_run = _timed(lambda: steps(n_step), 3)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    ms = 1e3 * t_run / n_step
    print(f"card: {card}; serving step, use_pallas={use_pallas}, 1 scenario x {cfg.data.n_ag} agents x "
          f"{cfg.data.n_mp} polylines")
    print(f"median of 3 runs of {n_step} steps (fetch=False, one synchronize each): {ms:.4f} ms per step "
          f"({1e3 / ms:.2f} serve_policy_steps_per_sec) | peak memory {peak:.3f} GiB")
    name = f"serve_step_{'use_pallas' if use_pallas else 'plain'}"
    _trace(lambda: steps(10), 10, t_run * 10 / n_step, out, name)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", type=Path, default=None, help="directory for the Chrome trace")
    ap.add_argument("--use-pallas", action="store_true", help="run the KNARPE attention kernels (B4, B2)")
    ap.add_argument("--ab", type=int, default=0, metavar="ROUNDS", help="time the three arms in turns instead")
    ap.add_argument("--train", action="store_true", help="profile the training step instead")
    ap.add_argument("--validate", action="store_true", help="profile the validation step instead")
    ap.add_argument("--serve", action="store_true", help="profile the serving step instead")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_slice needs a CUDA device")
    card = card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.train:
        return profile_train(card, args.use_pallas, args.out)
    if args.validate:
        return profile_validate(card, args.use_pallas, args.out)
    if args.serve:
        return profile_serve(card, args.use_pallas, args.out)
    if args.ab:
        return compare_arms(card, args.ab)
    return profile_call(card, args.use_pallas, args.out)


@torch.no_grad()  # as inside joint_future_pred; tl_rollout_scan is called bare below
def profile_call(card: str, use_pallas: bool, out) -> None:
    """The joint-future call: phase times and one traced call."""
    cfg = with_pallas(leaderboard_config(), use_pallas)
    n_sc, k = 4, cfg.n_joint_future_wosac
    model = build_model(cfg, seed=0, device="cuda")
    batch = make_batch(cfg.data, n_sc=n_sc, seed=0)
    gen = torch.Generator().manual_seed(0)

    def call():
        return ev.joint_future_pred(cfg, model, batch, generator=gen, n_joint_future=k)

    _timed(call)  # warm-up
    dev_batch = ev.batch_to_device(batch, torch.device("cuda"))
    scene, t_prep = _timed(lambda: ev.prepare_joint_future(cfg, model, dev_batch), 3)
    _, t_tl = _timed(lambda: ev.tl_prepass.tl_rollout_scan(
        model, scene.tl_tokens, scene.pp.tl_state.float(),
        torch.ones(scene.pp.tl_state.shape[:3], dtype=torch.bool, device="cuda"),
        cfg.time_step_end, cfg.model.temp_window_size), 3)
    samples = ev.sample_joint_futures(cfg, scene, k, gen)
    samples.pop("latent_log_prob")
    _, t_roll = _timed(lambda: ev.rollout_joint_futures(cfg, model, dev_batch, scene, k, **samples), 3)
    _, t_call = _timed(call, 3)
    n_step = cfg.time_step_end
    print(f"card: {card}; use_pallas={use_pallas}, check_level=1")
    print(f"medians of 3: whole call {t_call:.4f} s | scene preparation {t_prep:.4f} s (of which TL pre-pass {t_tl:.4f} s) | "
          f"rollout {t_roll:.4f} s = {1e3 * t_roll / n_step:.3f} ms per step")
    _trace(call, n_step, t_call, out, f"joint_future_pred_{'use_pallas' if use_pallas else 'plain'}")


if __name__ == "__main__":
    main()
