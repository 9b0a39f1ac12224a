"""PyTorch port: data-parallel training, validation and submission on 2 gloo ranks (CPU) against the JAX package.

Tiny config, float32, dropout 0, random weights of gain 0.5 from a numpy seed (`test_torch_helpers.py::
train_step_parity`'s setting). Two ranks of one scenario each (`tests/torch_parallel_ranks.py`):
  - one step against JAX's jitted `value_and_grad(training_forward)` on the union batch of 2, JAX's draws split by
    rows (`pipeline.shard_noise`): the loss and its terms and `grad_norm` to 1e-5 relative, every gradient to 1e-4
    of its parameter's largest + 1e-7 (the parity tests' tolerances); against the port's own one-process step on
    the union, the loss to 1e-6 relative; two calls accumulated into one update, against one process's on the union
    batches, every gradient to the same tolerance;
  - the same with unequal valid counts on the two ranks (half the agents of one scenario invalid), where the mean
    of the ranks' own ratios is shown to miss JAX's loss by more than 1e-3 relative;
  - `draw_training_noise` per rank: the union's rows, one shared prior draw, dropout seeds of their own;
  - `run.main` fit for 2 steps and a resume to 3: the same parameters on both ranks, one "last" and one
    metrics line per step; SIGTERM on rank 1 alone stopping both ranks after the same step;
  - `validate`: the same metrics on both ranks, and to 1e-6 relative the metrics of the two shards' one-process
    running sums combined as JAX `runner.py:486-547` combines its hosts';
  - `test_submission` without `waymo_open_dataset`: each rank its own arrays; with `tests/waymo_stub`: rank 0 writes
    both shards' scenarios, rank 1 returns (None, None).
"""

import dataclasses
import json
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_ranks as ranks
from test_torch_helpers import (assert_grads_match, assert_loss_matches, jax_model_params, jax_sort_knn,
                                jax_training_noise, no_dropout, port_cfg, set_threads, to_jnp)
from trafficbotsv15_tpu.config import tiny_config as jax_tiny_config
from trafficbotsv15_tpu.data.synthetic import make_batch
from trafficbotsv15_tpu.train import pipeline as jax_pipeline
from trafficbotsv15_tpu_torch.config import tiny_config
from trafficbotsv15_tpu_torch.eval import runner
from trafficbotsv15_tpu_torch.run import step_generator
from trafficbotsv15_tpu_torch.train import pipeline
from trafficbotsv15_tpu_torch.train.evaluation import batch_to_device
from trafficbotsv15_tpu_torch.train.pipeline import build_model
from trafficbotsv15_tpu_torch.utils.jax_import import params_from_jax

set_threads()
TESTS = Path(__file__).resolve().parent
UNION_LOSS_RTOL = 1e-6  # two ranks against one process on the union: float32 summation order only
PER_RANK_MEAN_GAP = 1e-3
VALIDATE_RTOL = 1e-6


@pytest.fixture(scope="module")
def step_parity(tmp_path_factory):
    cfg = no_dropout(jax_tiny_config())
    jmodel, tree = jax_model_params(cfg, seed=0, gain=0.5)
    key = jax.random.PRNGKey(3)
    batch = make_batch(cfg.data, n_sc=2, seed=1)
    cases = [batch, ranks.unequal_counts(batch)]
    grad_fn = jax.jit(jax.value_and_grad(lambda p, b: jax_pipeline.training_forward(cfg, jmodel, p, b, key, 0),
                                         has_aux=True))
    jax_runs = []
    with jax_sort_knn():
        for b in cases:
            (jloss, jmetrics), jgrads = grad_fn(to_jnp(tree), {k: jnp.asarray(v) for k, v in b.items()})
            jax_runs.append(dict(jax_loss=float(jloss), jax_metrics={k: float(v) for k, v in jmetrics.items()},
                                 jax_grads=params_from_jax(jax.tree_util.tree_map(np.asarray, jgrads))))
    pcfg = port_cfg(cfg)
    pcfg = dataclasses.replace(pcfg, optimizer=dataclasses.replace(pcfg.optimizer, grad_clip_norm=math.inf))
    noises = [jax_training_noise(cfg, b, key) for b in cases]
    tmp = tmp_path_factory.mktemp("step_parity")
    rank_runs = ranks.spawn(ranks.train_steps, 2, tmp, pcfg, tree, list(zip(cases, noises)))

    _, _, step = ranks.recorded_step(pcfg, tree)  # the port's one process on the union
    union = [{k: float(v) for k, v in step(b, noise=noise).items()} for b, noise in zip(cases, noises)]
    acc_cfg = dataclasses.replace(pcfg, optimizer=dataclasses.replace(pcfg.optimizer, accumulate_grad_batches=2))
    _, union_accumulated, step = ranks.recorded_step(acc_cfg, tree)
    for b, noise in zip(cases, noises):
        step(b, noise=noise)
    return jax_runs, rank_runs, union, union_accumulated


@pytest.mark.parametrize("case", [0, 1], ids=["equal_counts", "unequal_counts"])
def test_two_ranks_match_jax_on_the_union(step_parity, case):
    jax_runs, rank_runs, _, _ = step_parity
    for rank_run in rank_runs:
        got = rank_run["cases"][case]
        run = dict(jax_runs[case], port_metrics=got["metrics"], port_grads=got["grads"])
        assert_loss_matches(run)
        assert_grads_match(run)
    r0, r1 = (r["cases"][case] for r in rank_runs)
    assert all(torch.equal(r0["grads"][n], r1["grads"][n]) for n in r0["grads"])  # one sum, the same bits on both
    assert r0["metrics"] == r1["metrics"]


@pytest.mark.parametrize("case", [0, 1], ids=["equal_counts", "unequal_counts"])
def test_two_ranks_match_one_process_on_the_union(step_parity, case):
    _, rank_runs, union, _ = step_parity
    got, want = rank_runs[0]["cases"][case]["metrics"], union[case]
    assert set(got) == set(want)
    assert abs(got["training/loss"] - want["training/loss"]) <= UNION_LOSS_RTOL * abs(want["training/loss"])


def test_unequal_counts_need_the_global_denominators(step_parity):
    """With the ranks' valid counts apart, the mean of their own ratios is not the union's loss: the global
    denominators are what make the two ranks match JAX in the case above."""
    jax_runs, rank_runs, _, _ = step_parity
    want = jax_runs[1]["jax_loss"]
    per_rank_mean = 0.5 * sum(r["cases"][1]["local_loss"] for r in rank_runs)
    assert abs(per_rank_mean - want) > PER_RANK_MEAN_GAP * abs(want), (per_rank_mean, want)


def test_accumulated_update_on_two_ranks(step_parity):
    """Two calls accumulated into one update (`accumulate_grad_batches=2`), the gradients summed over the ranks once,
    on the second call: the update's gradients are one process's accumulated ones on the union batches."""
    _, rank_runs, _, union_accumulated = step_parity
    run = dict(port_grads=rank_runs[0]["accumulated"], jax_grads=union_accumulated)
    assert_grads_match(run)
    assert all(torch.equal(rank_runs[0]["accumulated"][n], rank_runs[1]["accumulated"][n]) for n in union_accumulated)


def test_draws_split_the_union_and_share_the_prior_draw():
    cfg = tiny_config()
    union = {k: torch.from_numpy(v) for k, v in make_batch(jax_tiny_config().data, n_sc=2, seed=1).items()}
    whole = pipeline.draw_training_noise(cfg, union, step_generator(5, 0), "cpu")
    shares = [pipeline.draw_training_noise(cfg, batch_to_device({k: v[r:r + 1] for k, v in union.items()}, "cpu"),
                                           step_generator(5, 0), "cpu", rank=r, world=2) for r in range(2)]
    for r, share in enumerate(shares):
        assert torch.equal(share["u_prior"], whole["u_prior"])
        for key in pipeline.ROW_NOISE:
            if whole[key] is not None:
                assert torch.equal(share[key], whole[key][r:r + 1]), key
    assert shares[0]["seed_encoders"] == whole["seed_encoders"] and shares[0]["seeds_step"] == whole["seeds_step"]
    assert shares[1]["seed_encoders"] != shares[0]["seed_encoders"]
    for key in pipeline.SEED_NOISE:
        assert all(a != b for a, b in zip(shares[0][key], shares[1][key])), key


@pytest.fixture(scope="module")
def entry_points(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("entry_points")
    return tmp, ranks.spawn(ranks.entry_points, 2, tmp, tmp, str(TESTS))


def test_fit_and_resume_on_two_ranks(entry_points):
    tmp, (r0, r1) = entry_points
    assert not r0["stopped"] and not r1["stopped"]
    assert set(r0["params"]) == set(r1["params"])
    assert all(torch.equal(r0["params"][n], r1["params"][n]) for n in r0["params"])
    assert r0["files"] == ["best", "best.json", "last", "last.json", "metrics.jsonl"]  # no .tmp, no .old
    assert json.loads((tmp / "fit" / "last.json").read_text())["meta"]["step"] == 3
    steps = [json.loads(line)["step"] for line in r0["metrics_lines"] if "training/loss" in line]
    assert steps == [1, 2, 3]  # rank 0 alone logs


def test_a_signal_on_one_rank_stops_both(entry_points):
    """SIGTERM on rank 1 alone: both ranks stop after the same step, save "last" there and exit 143 (a rank that
    carried on would wait forever in its next collective)."""
    _, outs = entry_points
    assert [out["signalled"] for out in outs] == [{"exit": 143, "last_step": 1}] * 2


def test_validate_on_two_ranks_is_the_union(entry_points, monkeypatch):
    _, (r0, r1) = entry_points
    assert r0["validate"] == r1["validate"]
    cfg = tiny_config()
    model = build_model(cfg, device="cpu")
    trees = []
    monkeypatch.setattr(runner, "cross_process_sum", lambda tree: trees.append(tree) or tree)
    for rank in range(2):  # each shard in one process, its running sums recorded
        runner.validate(cfg, model, ranks.validation_loader(cfg, rank, 2), max_batches=1, device="cpu")
    shards = [tree for tree in trees if "err" in tree]  # not the WOSAC pool's, where the stub is installed

    def add(a, b):
        return {k: add(a[k], b[k]) for k in a} if isinstance(a, dict) else np.float64(float(a) + float(b))

    want = runner.metrics_from_sums(add(*shards))
    got = r0["validate"]
    assert set(got) == set(want) | {"val/scenarios_per_sec"}
    for k, v in want.items():
        assert abs(got[k] - v) <= VALIDATE_RTOL * max(abs(v), 1e-12), (k, got[k], v)


def test_submission_without_protos_on_two_ranks(entry_points):
    """Without waymo_open_dataset on any rank, each rank returns its own shard's arrays (and no rank waits in a
    gather the other never joins)."""
    _, outs = entry_points
    cfg = tiny_config()
    n_fut = cfg.time_step_gt - cfg.time_step_current
    for out in outs:
        (arrays,) = out["arrays"]
        assert arrays["wosac_trajs"].shape == (2, 32, cfg.data.n_ag, n_fut, 3)
        assert np.isfinite(arrays["wosac_trajs"]).all()
    assert not np.array_equal(outs[0]["arrays"][0]["wosac_trajs"], outs[1]["arrays"][0]["wosac_trajs"])


def test_submission_on_two_ranks(entry_points):
    _, (r0, r1) = entry_points
    assert r1["submission"] == (None, None) and r1["submission_ids"] == []
    assert all(p is not None and Path(p).exists() for p in r0["submission"])
    want = [f"synthetic_{100 + s}_{i}" for s in range(2) for i in range(2)]  # both shards' scenes
    assert r0["submission_ids"] == want
