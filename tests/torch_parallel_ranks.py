"""Rank processes of the port's data-parallel tests (`tests/test_torch_parallel*.py`).

`spawn(fn, world, tmp_path, *args)` starts `world` processes (the spawn start
method), joins them into one gloo group over a file store in `tmp_path` (no
TCP port) and returns what `fn(rank, world, *args)` returned on each rank. The
rank functions live here, in a module that imports no JAX, so that a spawned
rank imports only torch and the port.
"""

from __future__ import annotations

import datetime
import json
import multiprocessing as mp
import os
import pickle
import time
import traceback
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

RANK_TIMEOUT_S = 240  # a rank that outlives this fails the test (it is killed)


def spawn(fn, world: int, tmp_path: Path, *args) -> list:
    """[fn(rank, world, *args) for each rank], each run in its own process of one gloo group. A rank that raises
    or exits non-zero fails the call with its traceback."""
    ctx = mp.get_context("spawn")
    store, outs = tmp_path / "gloo_store", [tmp_path / f"rank{r}.pkl" for r in range(world)]
    store.unlink(missing_ok=True)
    procs = [ctx.Process(target=_rank_main, args=(fn, rank, world, str(store), str(outs[rank]), args))
             for rank in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + RANK_TIMEOUT_S
    for p in procs:
        p.join(max(deadline - time.monotonic(), 1.0))
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    results = []
    for rank, (p, out) in enumerate(zip(procs, outs)):
        status, value = pickle.loads(out.read_bytes()) if out.exists() else ("missing", None)
        if p.exitcode != 0 or status != "ok":
            raise AssertionError(f"rank {rank} of {world}: exit {p.exitcode}, {status}\n{value}")
        results.append(value)
    return results


def _rank_main(fn, rank: int, world: int, store: str, out: str, args) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=RANK_TIMEOUT_S / 2))
    try:
        result = ("ok", fn(rank, world, *args))
    except Exception:
        result = ("raised", traceback.format_exc())
    Path(out).write_bytes(pickle.dumps(result))
    dist.destroy_process_group()
    if result[0] != "ok":
        raise SystemExit(1)


# -- the rank functions --------------------------------------------------------------------------------------------
def collectives(rank: int, world: int, tmp: Path) -> dict:
    """Each of parallel/mesh.py's collectives once, and the rank-0 writes of MetricsLogger and CheckpointManager."""
    from trafficbotsv15_tpu_torch.config import tiny_config
    from trafficbotsv15_tpu_torch.parallel import mesh
    from trafficbotsv15_tpu_torch.train.checkpoint import CheckpointManager
    from trafficbotsv15_tpu_torch.utils.logging import MetricsLogger

    out = {"rank": mesh.process_index(), "count": mesh.process_count(),
           "init_again": mesh.maybe_init_distributed()}
    out["sum"] = mesh.cross_process_sum({"a": torch.tensor(rank + 1.0), "b": {"c": np.arange(3) * (rank + 1)},
                                         "empty": {}, "n": rank})
    try:
        mesh.cross_process_sum({f"only_on_rank_{rank}": 1.0})
        out["mismatch"] = None
    except ValueError as e:
        out["mismatch"] = str(e)
    out["max"] = mesh.cross_process_max(2.5 * rank)
    out["rows"] = mesh.allgather_rows({"x": np.full((rank + 1, 2), rank), "y": np.arange(rank + 1)})
    out["object"] = mesh.broadcast_object({"from": rank})

    if rank == 1:  # rank 0 passes the barrier only after rank 1 has written
        time.sleep(0.5)
        (tmp / "written_by_rank_1").write_text("1")
    mesh.barrier()
    out["seen_after_barrier"] = (tmp / "written_by_rank_1").exists()

    torch.manual_seed(rank)
    lin = torch.nn.Linear(3, 2)
    lin.register_buffer("steps", torch.full((2,), float(rank)))
    mesh.broadcast_params(lin)
    out["params"] = [t.detach().clone() for t in (*lin.parameters(), *lin.buffers())]
    a, b = torch.nn.Parameter(torch.zeros(4)), torch.nn.Parameter(torch.zeros(2, 3))
    a.grad = torch.full((4,), rank + 1.0)
    b.grad = None if rank == 0 else torch.full((2, 3), 3.0)  # rank 0 never touched b
    mesh.all_reduce_grads([a, b])
    out["grads"] = [a.grad.clone(), b.grad.clone()]

    MetricsLogger(str(tmp / "metrics.jsonl"), echo=False).log(1, {"x": float(rank)})
    ckpt_dir = tmp / "ckpt"
    ckpt = CheckpointManager(str(ckpt_dir))
    cfg = tiny_config()
    state = {"w": torch.full((2,), float(rank))}
    ckpt.save_last(state, cfg, {"step": 1})
    ckpt.save_last(state, cfg, {"step": 2})  # finalises the first save on every rank, then starts the second
    ckpt.wait()
    out["last"] = ckpt.restore("last")[0]["w"].clone()
    out["best_saved"] = [ckpt.save_best(state, cfg, 0.5, {"step": 2}), ckpt.save_best(state, cfg, 0.7, {"step": 3})]
    out["best"] = ckpt.restore("best")[0]["w"].clone()
    mesh.barrier()
    out["files"] = sorted(os.listdir(ckpt_dir))
    return out


def train_steps(rank: int, world: int, cfg, tree, cases) -> dict:
    """For each (union batch, union noise) case: this rank's share through `make_train_step` (clip off, the optimizer
    a recorder of the gradients it would apply) -> its metrics and gradients, and this rank's loss with its own
    counts alone (the mean-of-ranks reduction, for comparison); then all cases as the calls of one update with
    `accumulate_grad_batches` = the number of cases -> the gradients of that update."""
    import dataclasses

    from trafficbotsv15_tpu_torch.train import pipeline
    from trafficbotsv15_tpu_torch.train.evaluation import batch_to_device

    model, recorded, step = recorded_step(cfg, tree)
    out = {"cases": []}
    for batch, noise in cases:
        mine, shard = share(batch, noise, rank, world)
        metrics = {k: float(v) for k, v in step(mine, noise=shard).items()}
        with torch.no_grad():
            local_loss, _ = pipeline.training_forward(cfg, model, batch_to_device(mine, "cpu"), shard)
        out["cases"].append({"metrics": metrics, "grads": dict(recorded), "local_loss": float(local_loss)})
    acc_cfg = dataclasses.replace(cfg, optimizer=dataclasses.replace(cfg.optimizer,
                                                                     accumulate_grad_batches=len(cases)))
    _, recorded, step = recorded_step(acc_cfg, tree)
    for batch, noise in cases:
        mine, shard = share(batch, noise, rank, world)
        step(mine, noise=shard)
    out["accumulated"] = dict(recorded)
    return out


def unequal_counts(batch):
    """batch with the second scenario's last half of agents invalid: the data shards' valid counts differ."""
    out = dict(batch)
    valid = batch["agent/valid"].copy()
    valid[1, valid.shape[1] // 2:] = False
    out["agent/valid"] = valid
    return out


def share(batch, noise, rank: int, world: int):
    """(rank's rows of the union batch, its share of the union's draws)."""
    from trafficbotsv15_tpu_torch.train.pipeline import shard_noise

    n = next(iter(batch.values())).shape[0] // world
    return {k: v[rank * n:(rank + 1) * n] for k, v in batch.items()}, shard_noise(noise, rank, world)


def recorded_step(cfg, tree):
    """(model with the tree's weights on the CPU, {name: gradient} of the last update, its `make_train_step`, the
    optimizer a recorder of the gradients and nothing else)."""
    from trafficbotsv15_tpu_torch.train import pipeline
    from trafficbotsv15_tpu_torch.utils.jax_import import load_jax_params

    model = pipeline.build_model(cfg, device="cpu")
    load_jax_params(model, tree)
    recorded = {}

    class Recorder:
        param_groups = [{"params": list(model.parameters())}]

        def step(self):
            recorded.update({n: p.grad.detach().clone() for n, p in model.named_parameters()})

    return model, recorded, pipeline.make_train_step(cfg, model, Recorder(), device="cpu")


def entry_points(rank: int, world: int, tmp: Path, tests_dir: str) -> dict:
    """On 2 ranks: `run.main` fit for 2 steps, then a resume to 3; `validate` of one batch; `test_submission` of one
    batch without waymo_open_dataset, then with the stub protos (the scenario ids each rank's writer received
    recorded)."""
    import sys

    from trafficbotsv15_tpu_torch import run
    from trafficbotsv15_tpu_torch.config import tiny_config
    from trafficbotsv15_tpu_torch.eval import runner, submission
    from trafficbotsv15_tpu_torch.train.pipeline import build_model

    ckpt = tmp / "fit"
    common = ["action=fit", "device=cpu", "preset=tiny", f"ckpt_dir={ckpt}", "val_epoch_batches=1", "log_every=1"]
    run.main(common + ["max_steps=2"])
    model, _, stopped = run.main(common + ["max_steps=3", "resume=true"])
    out = {"params": {n: p.detach().clone() for n, p in model.named_parameters()}, "stopped": stopped,
           "files": sorted(os.listdir(ckpt)), "metrics_lines": (ckpt / "metrics.jsonl").read_text().splitlines()}
    out["signalled"] = signalled_fit(rank, tmp / "fit_signalled", run)

    cfg = tiny_config()
    model = build_model(cfg, device="cpu")
    out["validate"] = runner.validate(cfg, model, validation_loader(cfg, rank, world), max_batches=1, device="cpu")

    test_cfg = tiny_config()
    loader = run.SynthLoader(test_cfg, 1, 2, 100, test_mode=True, shard_index=rank, num_shards=world)
    stub_dir = str(Path(tests_dir) / "waymo_stub")  # the stub gone, wherever the parent had installed it
    sys.path[:] = [p for p in sys.path if p != stub_dir]
    os.environ["PYTHONPATH"] = os.pathsep.join(p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep)
                                               if p != stub_dir)
    for name in [m for m in sys.modules if m.split(".")[0] == "waymo_open_dataset"]:
        del sys.modules[name]
    out["arrays"] = runner.test_submission(test_cfg, model, loader, n_joint_future=32, device="cpu")

    sys.path.insert(0, tests_dir)
    import waymo_stub

    waymo_stub.install()
    added, real_add = [], submission.SubWOMD.add

    def add(self, scenario_ids, *rest):
        added.extend(scenario_ids)
        return real_add(self, scenario_ids, *rest)

    submission.SubWOMD.add = add
    out["submission"] = runner.test_submission(test_cfg, model, loader, out_dir=str(tmp / "sub"), n_joint_future=32,
                                               device="cpu")
    out["submission_ids"] = added
    return out


def signalled_fit(rank: int, ckpt: Path, run) -> dict:
    """`run.main` fit for up to 4 steps where rank 1 alone gets SIGTERM during its first step: -> the exit code and
    the step "last" holds, as this rank sees them."""
    import signal

    real_make = run.make_train_step

    def make(*args, **kwargs):
        step = real_make(*args, **kwargs)

        def signalled(*step_args, **step_kwargs):
            if rank == 1:
                os.kill(os.getpid(), signal.SIGTERM)  # the handler only records it: the step finishes
            return step(*step_args, **step_kwargs)

        signalled.accumulator = step.accumulator
        return signalled

    run.make_train_step = make
    try:
        run.main(["action=fit", "device=cpu", "preset=tiny", f"ckpt_dir={ckpt}", "max_steps=4",
                  "validate_every_epoch=false"])
        code = 0
    except SystemExit as e:
        code = e.code
    finally:
        run.make_train_step = real_make
    return {"exit": code, "last_step": json.loads((ckpt / "last.json").read_text())["meta"]["step"]}


def validation_loader(cfg, rank: int, world: int):
    """Shard `rank` of `world` of the synthetic validation split (`run.make_dataloaders`' seeds)."""
    from trafficbotsv15_tpu_torch.run import SynthLoader

    return SynthLoader(cfg, 1, cfg.batch_size_test, 10_000, shard_index=rank, num_shards=world)


# -- FSDP, tensor parallelism and the mesh -------------------------------------------------------------------------
def with_parallel(cfg, strategy: str, model_axis: int):
    import dataclasses

    return dataclasses.replace(cfg, parallel=dataclasses.replace(cfg.parallel, strategy=strategy,
                                                                 model_axis=model_axis))


def placed_step(cfg, tree, mesh, accumulate: int = 1):
    """(model with the tree's weights on the CPU, its ShardedParams under cfg.parallel on mesh, a real AdamW over
    them, the `make_train_step`)."""
    import dataclasses

    from trafficbotsv15_tpu_torch.parallel import mesh as mesh_lib
    from trafficbotsv15_tpu_torch.train import pipeline
    from trafficbotsv15_tpu_torch.train.optimizer import make_optimizer
    from trafficbotsv15_tpu_torch.utils.jax_import import load_jax_params

    cfg = dataclasses.replace(cfg, optimizer=dataclasses.replace(cfg.optimizer, accumulate_grad_batches=accumulate))
    model = pipeline.build_model(cfg, device="cpu")
    load_jax_params(model, tree)
    sharded = mesh_lib.ShardedParams(model, mesh_lib.strategy_placements(cfg.parallel, model, mesh), mesh)
    opt, schedule = make_optimizer(cfg.optimizer, sharded.named_parameters())
    return model, sharded, opt, pipeline.make_train_step(cfg, model, opt, schedule, device="cpu", sharded=sharded)


def sharded_steps(rank: int, world: int, cfg, tree, cases, settings) -> dict:
    """For each (strategy, model_axis, accumulate) setting, on its mesh: each (union batch, union noise) case as one
    update from the tree's weights (AdamW, the clip off in cfg), this rank taking its data index's share -> the
    metrics, the update's gradients and the parameters after it (full, gathered), and each parameter's local shape
    with its AdamW moments'; with accumulate, the cases as the calls of one accumulated update -> its gradients."""
    from trafficbotsv15_tpu_torch.parallel import mesh as mesh_lib

    out = {}
    for strategy, n_model, accumulate in settings:
        with mesh_lib.make_mesh(n_model=n_model) as mesh:
            out[(strategy, n_model)] = sharded_cases(with_parallel(cfg, strategy, n_model), tree, cases, mesh,
                                                     accumulate)
    return out


def sharded_cases(cfg, tree, cases, mesh, accumulate: bool) -> dict:
    """sharded_steps' results of one setting on its mesh."""
    from trafficbotsv15_tpu_torch.parallel import mesh as mesh_lib

    d, n_data = mesh_lib.data_index(mesh), mesh_lib.data_count(mesh)
    res = {"coord": (d, mesh_lib.model_index(mesh)), "mesh": tuple(mesh.mesh.shape), "cases": []}
    for batch, noise in cases:
        model, sharded, opt, step = placed_step(cfg, tree, mesh)
        mine, shard = share(batch, noise, d, n_data)
        metrics = {k: float(v) for k, v in step(mine, noise=shard).items()}
        grads = sharded.full({n: t.grad for n, t in sharded.named_parameters()})
        sharded.gather()
        res["cases"].append({
            "metrics": metrics, "grads": grads,
            "params": {n: p.detach().clone() for n, p in model.named_parameters()},
            "local": {n: (tuple(t.shape), tuple(opt.state[t]["exp_avg"].shape),
                          tuple(opt.state[t]["exp_avg_sq"].shape)) for n, t in sharded.named_parameters()},
            "axes": dict(sharded.axes)})
    if accumulate:
        model, sharded, opt, step = placed_step(cfg, tree, mesh, accumulate=len(cases))
        for batch, noise in cases:
            mine, shard = share(batch, noise, d, n_data)
            step(mine, noise=shard)
        res["accumulated"] = sharded.full({n: t.grad for n, t in sharded.named_parameters()})
    return res


def sharded_entry_points(rank: int, world: int, tmp: Path) -> dict:
    """On 2 ranks, `run.main` fits of 2 steps (fsdp with min size 256, and tp on a model axis of 2), each resumed to
    3 under its own strategy and from a copy of its checkpoint under another: fsdp's under dp (the same data split),
    tp's under dp with the model axis of 2 (the same split) and under fsdp; then the tp fit's "last" restored and
    validated data parallel on one batch. -> the parameters after each resume, the files, the metrics lines and the
    validation."""
    import shutil

    from trafficbotsv15_tpu_torch import run
    from trafficbotsv15_tpu_torch.eval import runner
    from trafficbotsv15_tpu_torch.parallel import mesh as mesh_lib

    out = {"resumed": {}}
    try:
        run.main(["action=fit", "device=cpu", "preset=tiny", f"ckpt_dir={tmp / 'm3'}", "parallel.model_axis=3"])
        out["model_axis_3"] = None
    except ValueError as e:
        out["model_axis_3"] = str(e)
    common = ["action=fit", "device=cpu", "preset=tiny", "val_epoch_batches=1", "log_every=1",
              "parallel.fsdp_min_size=256"]
    settings = {"fsdp": ["parallel.strategy=fsdp"], "tp": ["parallel.strategy=tp", "parallel.model_axis=2"],
                "dp": ["parallel.strategy=dp", "parallel.model_axis=1"],
                "dp_m2": ["parallel.strategy=dp", "parallel.model_axis=2"]}
    for first, others in (("fsdp", ("dp",)), ("tp", ("dp_m2", "fsdp"))):
        ckpt = tmp / first
        run.main(common + settings[first] + [f"ckpt_dir={ckpt}", "max_steps=2"])
        copies = {}
        for other in others:
            copies[other] = tmp / f"{first}_as_{other}"
            if rank == 0:
                shutil.copytree(ckpt, copies[other])
        mesh_lib.barrier()
        for strategy, ckpt_dir in ((first, ckpt), *copies.items()):
            model, _, _ = run.main(common + settings[strategy] + [f"ckpt_dir={ckpt_dir}", "max_steps=3",
                                                                  "resume=true"])
            out["resumed"][(first, strategy)] = {n: p.detach().clone() for n, p in model.named_parameters()}
        out[first] = {"files": sorted(os.listdir(ckpt)), "metrics_lines": (ckpt / "metrics.jsonl").read_text(),
                      "last_step": json.loads((ckpt / "last.json").read_text())["meta"]["step"]}
    # the tp fit's first validation ran at step 2 on the gathered parameters; "best" holds them
    model, cfg = run.restore_model(str(tmp / "tp"), "best", "cpu")
    out["validate_best"] = runner.validate(cfg, model, validation_loader(cfg, rank, world), max_batches=1, device="cpu")
    return out


def left_out_rank(rank: int, world: int, tmp: Path) -> dict:
    """On 3 ranks over two hosts ([0, 0, 1] by GROUP_RANK): the mesh keeps a rank of each host, rank 1 leaves fit with
    nothing trained after JAX's warning, and ranks 0 and 2 fit 1 step together (the rank count and index inside the
    fit recorded); then, the mesh's block left, every rank sees the whole world again and validates "last" data
    parallel over all three."""
    import warnings

    from trafficbotsv15_tpu_torch import run
    from trafficbotsv15_tpu_torch.parallel import mesh as mesh_lib

    os.environ["GROUP_RANK"] = str([0, 0, 1][rank])
    seen, real_fit = [], run.fit

    def spy(*args, **kwargs):
        seen.append((mesh_lib.process_count(), mesh_lib.process_index()))
        return real_fit(*args, **kwargs)

    run.fit = spy
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            model, logger, stopped = run.main(["action=fit", "device=cpu", "preset=tiny", f"ckpt_dir={tmp / 'fit'}",
                                               "max_steps=1", "validate_every_epoch=false"])
    finally:
        run.fit = real_fit
    after = (mesh_lib.process_count(), mesh_lib.process_index())
    validated = run.main(["action=validate", "device=cpu", "preset=tiny", f"ckpt_dir={tmp / 'fit'}",
                          "val_epoch_batches=1"])
    return {"trained": model is not None, "stopped": stopped, "warnings": [str(w.message) for w in caught],
            "in_fit": seen, "after": after, "validated": validated,
            "params": None if model is None else {n: p.detach().clone() for n, p in model.named_parameters()}}
