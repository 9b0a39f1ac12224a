"""The command line: fit, validate and test (counterpart of `trafficbotsv15_tpu/run.py`).

    python -m trafficbotsv15_tpu_torch.run action=fit data=tbcache data_dir=DIR max_steps=100
    python -m trafficbotsv15_tpu_torch.run action=validate data=tbcache data_dir=DIR ckpt_dir=ckpt
    python -m trafficbotsv15_tpu_torch.run action=test data=tbcache data_dir=DIR ckpt_dir=ckpt

Arguments are key=value, values parsed as JSON where they parse; dots nest
(`optimizer.lr=1e-4`). Besides the config's own fields: `action`
(fit | validate | test), `data` (synthetic | tbcache | h5, with `data_dir`
holding training.* and validation.*), `preset` (leaderboard | tiny | scaled),
`max_steps`, `log_every`, `ckpt_dir`, `resume`, `device` (the rank's card
unless `device=cpu`), `profile_dir`, `video_dir` and `debug_nans`. JAX's PRNG
switch `rbg` has no counterpart and raises `NotImplementedError`.

`profile_dir=DIR` traces fit steps 3-5 (`utils/profiling.py`: each rank writes
`DIR/rank<r>.pt.trace.json.gz`, each step a range named "fit step N"), as
JAX's fit does; a fit that ends inside those steps still writes its trace
(JAX's leaves it open). `debug_nans=true` runs the action under anomaly mode
with NaN checks and restores the previous mode after it (JAX's flag stays on
for the process and checks forward outputs too). `video_dir=DIR` makes
`validate` render `n_vis_batch` scenarios of a reactive replay of the first
batch (`eval/runner.py::save_validation_videos`); it needs `cv2`, and without
it `main` raises an ImportError before it builds a model or reads a batch
(JAX's fails at its first frame). Each of the two belongs to one action:
`profile_dir` to fit, `video_dir` to validate; with another action they raise
a ValueError (JAX ignores them).

One process runs on one device. Over N processes, one device each, launched
by torchrun (or with RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and MASTER_PORT
set), fit runs on a (data, model) mesh of the ranks (`parallel/mesh.py`) with
`parallel.model_axis` ranks in its model dim (it must divide N), and places
the parameters by `parallel.strategy`: dp (the default) replicates them, fsdp
splits the large ones over the data dim, tp splits the projections over the
model dim, as the JAX package does:

    torchrun --nproc_per_node=4 -m trafficbotsv15_tpu_torch.run action=fit data=tbcache data_dir=DIR
    torchrun --nproc_per_node=2 -m trafficbotsv15_tpu_torch.run action=fit device=cpu preset=tiny \
        parallel.strategy=tp parallel.model_axis=2

over NCCL on the cards (rank r on cuda:LOCAL_RANK) and gloo on the CPU. fsdp
and tp need a process group; on one process they raise a ValueError, as an
unknown strategy does. Each data shard of the training batch holds
`batch_size_train` scenarios per rank of its model group, and every rank of
that group loads it (JAX's global batch is `batch_size_train` per device); a
step computes what one process computes on the union batch
(`train/pipeline.py`). Validation and test run data parallel over every rank
with the full parameters (`batch_size_test` per rank), as JAX evaluates on a
data-only mesh: their metrics are the union's on every rank. Rank 0 alone
writes checkpoints, metrics and the submission; a checkpoint holds full,
placement-free tensors, so it restores under any strategy.

`preset=scaled` is `config.scaled_config()` (hidden 256, 8 heads, 12/6/6
map/TL/agent layers, a 120-step horizon past the data's 91 logged steps).
JAX's `run.py` has no `scaled` preset (its bench takes it) and gives the
leaderboard config for any name it does not know; here an unknown preset
raises a `ValueError` that names the presets.

`fit` trains with checkpoints ("last" every `ckpt_every_steps` and at each
epoch's end, "best" on `val/loss` after each epoch's validation), EMA and SWA
when configured, and resumes from "last" with `resume=true`; SIGTERM or SIGINT
finishes the current step, saves "last" and exits 143. `validate` restores
"last", `test` restores "best" with K=128 futures (unless
`n_joint_future_wosac` is given) at batch 1 (unless `batch_size_test` is) and
writes the submission into `ckpt_dir` (with `waymo_open_dataset`; without it,
`main` returns the arrays).
"""

from __future__ import annotations

import dataclasses
import json
import signal
import sys
import time
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch

from trafficbotsv15_tpu_torch.config import (ExperimentCfg, config_from_dict, config_to_dict, leaderboard_config,
                                             scaled_config, tiny_config)
from trafficbotsv15_tpu_torch.ops.flags import check_supported
from trafficbotsv15_tpu_torch.parallel.mesh import (STRATEGIES, ShardedParams, barrier, batch_sharding,
                                                    broadcast_params, cross_process_max, data_count, device_prefetch,
                                                    is_distributed, make_mesh, maybe_init_distributed, model_count,
                                                    process_count, process_index, strategy_placements)
from trafficbotsv15_tpu_torch.train.checkpoint import CheckpointManager, deep_update
from trafficbotsv15_tpu_torch.train.optimizer import make_optimizer
from trafficbotsv15_tpu_torch.train.pipeline import build_model, make_train_step
from trafficbotsv15_tpu_torch.train.swa import ema_init, ema_update, swa_init, swa_params, swa_update
from trafficbotsv15_tpu_torch.utils.device import resolve_device
from trafficbotsv15_tpu_torch.utils.logging import MetricsLogger
from trafficbotsv15_tpu_torch.utils.profiling import Tracer, annotate, nan_checks


PRESETS = {"leaderboard": leaderboard_config, "tiny": tiny_config, "scaled": scaled_config}
RUN_KEYS = ("action", "data", "data_dir", "preset", "max_steps", "log_every", "ckpt_dir", "resume", "device",
            "profile_dir", "video_dir", "rbg", "debug_nans")


def parse_overrides(argv) -> Dict[str, Any]:
    """key=value arguments as a nested dict (dots nest; values parsed as JSON where they parse)."""
    out: Dict[str, Any] = {}
    for arg in argv:
        if "=" not in arg:
            continue
        k, v = arg.split("=", 1)
        try:
            v = json.loads(v)
        except json.JSONDecodeError:
            pass
        cur = out
        parts = k.split(".")
        for p in parts[:-1]:
            cur = cur.setdefault(p, {})
        cur[parts[-1]] = v
    return out


def apply_overrides(cfg: ExperimentCfg, overrides: Dict[str, Any]) -> ExperimentCfg:
    return config_from_dict(deep_update(config_to_dict(cfg), overrides))


class SynthLoader:
    """`n_batches` synthetic batches of `n_sc` scenarios, batch i of shard s of n from seed seed0 + i·n + s (the JAX
    loader's disjoint per-process streams; seed0 + i on one process)."""

    def __init__(self, cfg: ExperimentCfg, n_batches: int, n_sc: int, seed0: int, test_mode: bool = False,
                 shard_index: int = 0, num_shards: int = 1):
        self.cfg, self.n_batches, self.n_sc, self.seed0, self.test_mode = cfg, n_batches, n_sc, seed0, test_mode
        self.shard_index, self.num_shards = shard_index, num_shards

    def __len__(self) -> int:
        return self.n_batches

    def __iter__(self):
        return self.iter_from(0)

    def iter_from(self, start_batch: int = 0):
        from trafficbotsv15_tpu_torch.data.synthetic import make_batch

        for i in range(start_batch, self.n_batches):
            seed = self.seed0 + i * self.num_shards + self.shard_index
            yield make_batch(self.cfg.data, n_sc=self.n_sc, seed=seed, test_mode=self.test_mode)


def make_dataloaders(cfg: ExperimentCfg, data: str, data_dir: Optional[str], n_synthetic: int = 64,
                     test_mode: bool = False, mesh=None):
    """(train loader, validation loader) of this process's shards: synthetic scenes, a tbcache or an h5 split pair.
    The training shards are the data dim's of `mesh` (`parallel/mesh.py::batch_sharding`; without a mesh, every
    rank's), of `batch_size_train` scenarios per rank of a model group; the validation shards every rank's, of
    `batch_size_test`. Shards are disjoint and of equal length, so the ranks run the same number of batches of the
    same size."""
    shard = dict(shard_index=process_index(), num_shards=process_count())
    train_shard = shard if mesh is None else batch_sharding(mesh)
    bs_train, bs_test = max(cfg.batch_size_train, 1) * model_count(mesh), max(cfg.batch_size_test, 1)
    if data == "synthetic":
        return (SynthLoader(cfg, n_synthetic // bs_train, bs_train, 0, **train_shard),
                SynthLoader(cfg, max(n_synthetic // bs_test // 4, 1), bs_test, 10_000, test_mode=test_mode, **shard))
    if data_dir is None:
        raise ValueError(f"data={data} needs data_dir=<directory with training.* and validation.*>")
    if data == "tbcache":
        from trafficbotsv15_tpu_torch.data.tbcache import TBCacheDataset, TBCacheLoader

        return (TBCacheLoader(TBCacheDataset(f"{data_dir}/training.tbcache"), bs_train, shuffle=True,
                              seed=cfg.seed, **train_shard),
                TBCacheLoader(TBCacheDataset(f"{data_dir}/validation.tbcache"), cfg.batch_size_test, **shard))
    if data == "h5":
        from trafficbotsv15_tpu_torch.data.h5_dataset import DataLoader, H5Dataset, tensor_size_train, tensor_size_val

        train_ds = H5Dataset(f"{data_dir}/training.h5", tensor_size_train(cfg.data))
        val_ds = H5Dataset(f"{data_dir}/validation.h5", tensor_size_val(cfg.data), with_attrs=True)
        return (DataLoader(train_ds, bs_train, shuffle=True, seed=cfg.seed, **train_shard),
                DataLoader(val_ds, cfg.batch_size_test, **shard))
    raise ValueError(f"unknown data {data!r}: synthetic | tbcache | h5")


def init_distributed(device: torch.device) -> bool:
    """`maybe_init_distributed` with the backend of `device`: NCCL on the card, gloo on the CPU."""
    return maybe_init_distributed("nccl" if device.type == "cuda" else "gloo")


def build_kernels(cfg: ExperimentCfg) -> None:
    """Build (or find) the CUDA libraries cfg's path launches, one nvcc per source, all at once. The entry point
    calls it before the process group forms, so that no rank waits in a collective on another's compile."""
    from concurrent.futures import ThreadPoolExecutor

    from trafficbotsv15_tpu_torch.ops import knarpe, knn

    loaders = [knn.load_library]
    if cfg.model.tf_cfg.use_pallas:
        loaders += [knarpe.load_library, knarpe.load_bwd_library]
    with ThreadPoolExecutor(len(loaders)) as pool:
        for fut in [pool.submit(f) for f in loaders]:
            fut.result()


def step_generator(seed: int, step: int) -> torch.Generator:
    """The CPU generator of training step `step`'s draws, seeded from (seed, step) alone: a resumed run draws
    what the uninterrupted run would, on the card as on the CPU (the JAX loop's fold_in of the step)."""
    return torch.Generator().manual_seed(int(np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)[0]))


# the fit steps `profile_dir` traces: from the step with this index up to, not including, the second (JAX run.py)
TRACED_STEPS = (3, 6)


def training_mesh(cfg: ExperimentCfg):
    """`parallel/mesh.py::make_mesh` of cfg.parallel: `with training_mesh(cfg) as mesh:` the (data, model) mesh over
    the ranks for the block (entering and leaving are collectives), None on one process and on a rank the mesh leaves
    out. Raises a ValueError for an unknown strategy, for fsdp or tp without a process group, and for a model_axis
    that does not divide the ranks."""
    strategy = cfg.parallel.strategy
    if strategy not in STRATEGIES:
        raise ValueError(f"unknown parallel.strategy {strategy!r}: expected one of {', '.join(STRATEGIES)}")
    if strategy != "dp" and not is_distributed():
        raise ValueError(f"parallel.strategy={strategy} places the parameters over ranks, and this process has no "
                         "process group: run it under torchrun")
    return make_mesh(n_model=cfg.parallel.model_axis)


def fit(cfg: ExperimentCfg, train_loader, val_loader, ckpt_dir: str = "ckpt", max_steps: Optional[int] = None,
        log_every: int = 50, resume: bool = False, device=None, profile_dir: Optional[str] = None, mesh=None):
    """Train cfg's model on `device` (the card unless "cpu"); -> (model, logger, stopped by a signal).

    With `profile_dir`, steps 3-5 (counted from 0, over the whole run: a fit resumed past step 3 traces none) are
    traced into it (`utils/profiling.py::Tracer`); a fit that ends before step 6 writes what it traced.

    A step is one call of the train step on one batch (with gradient accumulation, every
    `accumulate_grad_batches`-th call updates); `max_steps` and `ckpt_every_steps` count calls. The EMA and
    the SWA average fold in the parameters after every call, as the JAX loop does. Metrics go to
    `<ckpt_dir>/metrics.jsonl`.

    Over several ranks (a torchrun environment, `parallel/mesh.py`) fit runs on `mesh`, made by `training_mesh(cfg)`
    around the call (`main` does so); without one it runs data parallel over every rank, and another strategy or
    model axis raises a ValueError. Every rank builds or resumes the model, takes rank 0's parameters, places them
    by `parallel.strategy` (`ShardedParams`: the optimizer's moments, the accumulator, the EMA and the SWA average
    live on the shards) and steps on its data shard; a checkpoint gathers the full tensors; a signal on any rank
    stops every rank after the same step."""
    device = resolve_device(device)
    init_distributed(device)
    if mesh is None and (cfg.parallel.strategy, cfg.parallel.model_axis) != ("dp", 1):
        raise ValueError(f"parallel.strategy={cfg.parallel.strategy!r} with model_axis={cfg.parallel.model_axis} runs "
                         "on a mesh: call fit inside `with training_mesh(cfg) as mesh` and pass it")
    logger = MetricsLogger(str(Path(ckpt_dir) / "metrics.jsonl"))
    model = build_model(cfg, device=device)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"model parameters: {n_params / 1e6:.2f}M, device: {device}, parallel: {cfg.parallel.strategy}, mesh "
          f"(data, model) = ({data_count(mesh)}, {model_count(mesh)})")

    steps_per_epoch = max(int(len(train_loader) * cfg.limit_train_batches), 1)
    ckpt = CheckpointManager(ckpt_dir)
    start_step, restored = 0, {}
    if resume and not (ckpt.dir / "last.json").exists():
        # restart wrappers pass resume=true every time; the first launch has nothing to restore
        print(f"resume requested but {ckpt_dir}/last not found: starting fresh")
        resume = False
    if resume:
        keep = {"model", "optimizer", "schedule"}
        keep |= {"accumulator"} if cfg.optimizer.accumulate_grad_batches > 1 else set()
        keep |= {"ema"} if cfg.ema_decay > 0 else set()
        keep |= {"swa_state"} if cfg.swa else set()
        restored, _, meta = ckpt.restore_resume(keep)
        model.load_state_dict(restored["model"])
        start_step = int(meta.get("step", 0))
        print(f"resumed from {ckpt_dir}/last at step {start_step}")
    broadcast_params(model)  # before the placement: its flat buckets take whole parameters
    sharded = ShardedParams(model, strategy_placements(cfg.parallel, model, mesh), mesh)
    names, params = zip(*sharded.named_parameters())
    opt, schedule = make_optimizer(cfg.optimizer, sharded.named_parameters(), steps_per_epoch=steps_per_epoch)
    train_step = make_train_step(cfg, model, opt, schedule, device=device, sharded=sharded)
    accumulator = train_step.accumulator
    if resume:
        sharded.load_optimizer_state(opt, restored["optimizer"])
        schedule.load_state_dict(restored["schedule"])
        if "accumulator" in restored:
            acc = restored["accumulator"]
            accumulator.load_state_dict({**acc, "acc": list(sharded.local_of(dict(zip(names, acc["acc"]))).values())})

    def by_name(tensors):
        return dict(zip(names, tensors))

    def restored_local(entry):  # a restored placement-free {name: tensor} as this rank's parts, in names' order
        return [t.to(device) for t in sharded.local_of({n: entry[n] for n in names}).values()]

    ema = None
    if cfg.ema_decay > 0:
        ema = ema_init(params)
        if "ema" in restored:
            with torch.no_grad():
                torch._foreach_copy_(ema, restored_local(restored["ema"]))
    # SWA (the reference's StochasticWeightAveraging callback): the equal-weight average of the parameters
    # from swa_epoch_start * max_epochs on
    swa_state, swa_start = None, int(cfg.swa_epoch_start * cfg.max_epochs) * steps_per_epoch
    if cfg.swa:
        swa_state = swa_init(params)
        if "swa_state" in restored:
            with torch.no_grad():
                torch._foreach_copy_(swa_state[0], restored_local(restored["swa_state"]["avg"]))
                swa_state[1].copy_(restored["swa_state"]["count"])

    def snapshot():
        """The fit's state as full, placement-free tensors (collectives where parameters are sharded); the model's
        parameters hold the full values after it."""
        sharded.gather()
        state = {"model": model.state_dict(), "optimizer": sharded.optimizer_state(opt),
                 "schedule": schedule.state_dict()}
        if accumulator is not None:
            acc = accumulator.state_dict()
            state["accumulator"] = {**acc, "acc": list(sharded.full(by_name(acc["acc"])).values())}
        if ema is not None:
            state["ema"] = sharded.full(by_name(ema))
        if swa_state is not None:
            state["swa"] = sharded.full(by_name(swa_params(swa_state, params)))
            state["swa_state"] = {"avg": sharded.full(by_name(swa_state[0])), "count": swa_state[1]}
        return state

    # preemption: SIGTERM / SIGINT ask for a graceful stop: the current step finishes, "last" is saved and
    # fit returns, so a wrapper can relaunch with resume=true; a second SIGINT raises KeyboardInterrupt
    stop_signal, prev_handlers = [], {}

    def request_stop(signum, frame):
        if stop_signal and signum == signal.SIGINT:
            raise KeyboardInterrupt
        stop_signal.append(signum)
        print(f"signal {signal.Signals(signum).name} received: saving 'last' after this step, then stopping "
              "(resume with resume=true)", flush=True)

    try:
        for sig in (signal.SIGTERM, signal.SIGINT):
            prev_handlers[sig] = signal.signal(sig, request_stop)
    except ValueError:  # not in the main thread
        prev_handlers = {}

    def stop_agreed() -> bool:
        """Whether any rank got a signal (a collective: every rank asks at the same points, or one rank's next
        save would wait on the others forever)."""
        return cross_process_max(float(bool(stop_signal))) > 0

    step = start_step
    start_epoch = min(start_step // steps_per_epoch, max(cfg.max_epochs - 1, 0))
    last_saved_step = -1
    stopped = False
    tracer = None

    def end_trace():
        """Stop and write a running trace of the fit's steps."""
        if tracer is not None and tracer.active:
            print(f"trace of fit steps {TRACED_STEPS[0]}-{step - 1} written to {tracer.stop()}", flush=True)

    t_start = time.time()
    try:
        for epoch in range(start_epoch, cfg.max_epochs):
            if hasattr(train_loader, "set_epoch"):  # the resumed epoch replays the interrupted one's order
                train_loader.set_epoch(epoch)
            skip = max(step - epoch * steps_per_epoch, 0)
            if hasattr(train_loader, "iter_from"):
                epoch_iter = train_loader.iter_from(skip)  # skipped by index, nothing read
            else:
                epoch_iter = iter(train_loader)
                for _ in range(skip):
                    next(epoch_iter, None)
            for batch in device_prefetch(epoch_iter, device):
                if step >= steps_per_epoch * (epoch + 1):
                    break
                if profile_dir and step == TRACED_STEPS[0]:
                    tracer = Tracer(profile_dir, device).start()
                with annotate(f"fit step {step}"):
                    metrics = train_step(batch, step_generator(cfg.seed + 1, step), epoch)
                    if ema is not None:
                        ema_update(ema, params, cfg.ema_decay)
                    if swa_state is not None:
                        swa_update(swa_state, params, step, swa_start)
                step += 1
                if tracer is not None and step == TRACED_STEPS[1]:
                    end_trace()
                if step % log_every == 0 or step == 1:
                    m = {k: float(v) for k, v in metrics.items()}
                    m["steps_per_sec"] = (step - start_step) / (time.time() - t_start)
                    m["lr"] = schedule.get_last_lr()[0]
                    logger.log(step, m)
                if cfg.ckpt_every_steps and step % cfg.ckpt_every_steps == 0:
                    ckpt.save_last(snapshot(), cfg, {"step": step, "epoch": epoch})
                    last_saved_step = step
                stopped = stop_agreed()
                if stopped or (max_steps and step >= max_steps):
                    break
            if stopped or (max_steps and step >= max_steps) or epoch == cfg.max_epochs - 1:
                end_trace()  # no step follows: the trace ends with the fit's steps, before the saves
            state = snapshot()
            if step != last_saved_step:  # not when the step's own save already wrote this step
                ckpt.save_last(state, cfg, {"step": step, "epoch": epoch})
                last_saved_step = step
            stopped = stop_agreed()
            if stopped:
                break
            if cfg.validate_every_epoch:
                from trafficbotsv15_tpu_torch.eval.runner import validate

                vm = validate(cfg, model, val_loader, max_batches=cfg.val_epoch_batches, logger=logger, device=device)
                ckpt.save_best(state, cfg, vm.get("val/loss", 0.0), {"step": step, "epoch": epoch})
            if max_steps and step >= max_steps:
                break
    finally:
        # the handlers are restored even when the last write fails: a leaked handler would swallow every
        # later SIGTERM of the process; a trace the fit ended inside is written (JAX leaves it open), on an
        # error too
        try:
            end_trace()
            ckpt.wait()
        finally:
            for sig, h in prev_handlers.items():
                signal.signal(sig, h)
    return model, logger, stopped or bool(stop_signal)


def restore_model(ckpt_dir: str, name: str, device, cfg: Optional[ExperimentCfg] = None, config_overrides=None):
    """(model of cfg with checkpoint `name`'s weights on device, cfg); without cfg, the checkpoint's own config
    with config_overrides merged in. Every rank restores, once they all are here."""
    barrier()
    state, saved_cfg, _ = CheckpointManager(ckpt_dir).restore(name, config_overrides=config_overrides)
    cfg = saved_cfg if cfg is None else cfg
    model = build_model(cfg, device=device)
    model.load_state_dict(state["model"])
    return model, cfg


def preset_config(preset: str) -> ExperimentCfg:
    """The config a `preset=` names; an unknown name raises."""
    if preset not in PRESETS:
        raise ValueError(f"unknown preset {preset!r}: expected one of {', '.join(PRESETS)}")
    return PRESETS[preset]()


def main(argv=None):
    """Run one action from key=value arguments; -> fit's (model, logger, stopped), validate's metrics or
    test_submission's result. A fit stopped by a signal exits 143. In a torchrun environment it joins the process
    group first (after building the kernels); fit then runs inside the mesh of cfg.parallel (`training_mesh`), and a
    rank the mesh leaves out returns (None, None, False)."""
    argv = sys.argv[1:] if argv is None else argv
    # the run's own keys apart from the config's, so that data=tbcache and data.n_ag=16 can stand side by side
    is_run_key = lambda arg: arg.split("=", 1)[0] in RUN_KEYS
    run_args = parse_overrides([a for a in argv if is_run_key(a)])
    overrides = parse_overrides([a for a in argv if not is_run_key(a)])
    action = run_args.get("action", "fit")
    data = run_args.get("data", "synthetic")
    data_dir = run_args.get("data_dir")
    preset = run_args.get("preset", "leaderboard")
    max_steps = run_args.get("max_steps")
    log_every = int(run_args.get("log_every", 50))
    ckpt_dir = run_args.get("ckpt_dir", "ckpt")
    resume = bool(run_args.get("resume", False))
    profile_dir, video_dir = run_args.get("profile_dir"), run_args.get("video_dir")
    debug_nans = bool(run_args.get("debug_nans", False))
    for key, val, owner in (("profile_dir", profile_dir, "fit"), ("video_dir", video_dir, "validate")):
        if val is not None and action != owner:
            raise ValueError(f"{key} belongs to action={owner}, not action={action}")
    if run_args.get("rbg"):
        raise NotImplementedError("rbg selects JAX's PRNG implementation; the port has no counterpart")
    if video_dir is not None:  # before any model or batch: JAX's fails at its first frame, after the replay
        from trafficbotsv15_tpu_torch.utils.visualization import require_cv2

        require_cv2(f"video_dir={video_dir}")
    device = resolve_device(run_args.get("device"))

    cfg = preset_config(preset)
    last_json = Path(ckpt_dir) / "last.json"
    if resume and last_json.exists():  # the checkpoint's own config, the command line's overrides on top
        cfg = config_from_dict(json.loads(last_json.read_text())["config"])
    cfg = apply_overrides(cfg, overrides)
    check_supported(cfg.ops)
    if device.type == "cuda":
        build_kernels(cfg)
    init_distributed(device)
    if action == "fit":  # on the mesh of cfg.parallel; validate and test run data parallel over every rank
        with training_mesh(cfg) as mesh:
            if mesh is None and is_distributed():
                print(f"rank {process_index()}: left out of the mesh, trains nothing", flush=True)
                return None, None, False
            train_loader, val_loader = make_dataloaders(cfg, data, data_dir, mesh=mesh)
            with nan_checks(debug_nans):  # this action only: the tests and chip_smoke.py call main in one process
                out = fit(cfg, train_loader, val_loader, ckpt_dir=ckpt_dir, max_steps=max_steps, log_every=log_every,
                          resume=resume, device=device, profile_dir=profile_dir, mesh=mesh)
        if out[2]:  # a signal's stop is no clean finish: 128 + SIGTERM tells a restart wrapper to resume
            raise SystemExit(143)
        return out
    if action == "test" and "batch_size_test" not in overrides:
        # the submission's K=128 futures of one scenario share its map and KNN work: batch 1
        cfg = dataclasses.replace(cfg, batch_size_test=1)

    _, val_loader = make_dataloaders(cfg, data, data_dir, test_mode=action == "test")
    logger = MetricsLogger(str(Path(ckpt_dir) / "metrics.jsonl"))
    with nan_checks(debug_nans):
        if action == "validate":
            from trafficbotsv15_tpu_torch.eval.runner import validate

            model, _ = restore_model(ckpt_dir, "last", device, cfg=cfg)
            return validate(cfg, model, val_loader, logger=logger, device=device, video_dir=video_dir)
        if action == "test":
            from trafficbotsv15_tpu_torch.eval.runner import test_submission

            # the morph for submission: the checkpoint's config with K=128 futures unless K is given
            sub_k = int(overrides.get("n_joint_future_wosac", 128))
            model, cfg = restore_model(ckpt_dir, "best", device, config_overrides={"n_joint_future_wosac": sub_k})
            return test_submission(cfg, model, val_loader, out_dir=ckpt_dir, device=device)
    raise SystemExit(f"unknown action {action}")


if __name__ == "__main__":
    main()
