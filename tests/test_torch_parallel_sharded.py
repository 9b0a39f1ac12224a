"""PyTorch port: one training step under FSDP, tensor parallelism and a (data, model) mesh on gloo ranks (CPU),
against the JAX package and against the port's data-parallel step.

Tiny config, float32, dropout 0, random weights of gain 0.5 (`test_torch_parallel_fit.py::step_parity`'s setting,
`parallel.fsdp_min_size=256` as JAX's `test_fit_parallel_strategy`), the union batch of 2 scenarios with equal and
unequal valid counts. Spawned ranks (`tests/torch_parallel_ranks.py::sharded_steps`), each update a real AdamW with
the clip off:
  - fsdp on a (2, 1) mesh and tp on a (1, 2) mesh (2 ranks; dp beside them), tp and fsdp on a (2, 2) mesh (4 ranks:
    the counts, the metrics and the gradients sum over the data dim alone);
  - every rank's loss and terms to 1e-5 relative of JAX's jitted `value_and_grad(training_forward)` on the union, and
    every gathered gradient to 1e-4 of its parameter's largest + 1e-7 (the parity tests' tolerances);
  - the parameters after the update to 1e-6 of their largest against the port's dp step on the same data split (dp
    on 2 ranks where the data dim is 2, one process on the union where it is 1), the same on every rank;
  - each sharded parameter's local shard and AdamW moments of the placement's shape after the update (JAX's n_out
    check), 114 leaves sharded under fsdp and 122 under tp (JAX's counts at this config);
  - two calls accumulated into one update under fsdp and tp: their gradients the mean of JAX's two.
"""

import dataclasses
import math
from concurrent.futures import ThreadPoolExecutor

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
from trafficbotsv15_tpu_torch.utils.jax_import import params_from_jax

set_threads()
PARAM_RTOL = 1e-6  # against the dp step on the same data split: the same sums, summation order at most
TWO_RANKS = [("dp", 1, False), ("fsdp", 1, True), ("tp", 2, True)]
FOUR_RANKS = [("tp", 2, False), ("fsdp", 2, False)]
SHARDED = {"fsdp-2": (2, ("fsdp", 1)), "tp-2": (2, ("tp", 2)), "tp-2x2": (4, ("tp", 2)), "fsdp-2x2": (4, ("fsdp", 2))}
N_SHARDED = {"fsdp": 114, "tp": 122}  # jax fsdp_shard_params(min_size=256) / tp_shard_params on tiny_config()


@pytest.fixture(scope="module")
def sharded_parity(tmp_path_factory):
    cfg = no_dropout(jax_tiny_config())
    jmodel, tree = jax_model_params(cfg, seed=0, gain=0.5)
    key = jax.random.PRNGKey(3)
    batch = make_batch(cfg.data, n_sc=2, seed=1)
    cases = [batch, ranks.unequal_counts(batch)]
    pcfg = port_cfg(cfg)
    pcfg = dataclasses.replace(pcfg, optimizer=dataclasses.replace(pcfg.optimizer, grad_clip_norm=math.inf),
                               parallel=dataclasses.replace(pcfg.parallel, fsdp_min_size=256))
    args = (pcfg, tree, list(zip(cases, [jax_training_noise(cfg, b, key) for b in cases])))
    with ThreadPoolExecutor(2) as pool:  # the ranks run while JAX compiles
        spawns = {world: pool.submit(ranks.spawn, ranks.sharded_steps, world, tmp_path_factory.mktemp(f"w{world}"),
                                     *args, settings) for world, settings in ((2, TWO_RANKS), (4, FOUR_RANKS))}
        jax_runs = _jax_runs(cfg, jmodel, tree, key, cases)
        runs = {world: fut.result() for world, fut in spawns.items()}
    union = []  # the port's one process on the union, a real AdamW update
    for b, noise in args[2]:
        model, sharded, _, step = ranks.placed_step(pcfg, tree, None)
        step(b, noise=noise)
        union.append({n: p.detach().clone() for n, p in model.named_parameters()})
    return jax_runs, runs, union


def _jax_runs(cfg, jmodel, tree, key, cases) -> list:
    """JAX's jitted value_and_grad(training_forward) on each union batch: loss, metrics and gradients."""
    grad_fn = jax.jit(jax.value_and_grad(lambda p, b: jax_pipeline.training_forward(cfg, jmodel, p, b, key, 0),
                                         has_aux=True))
    jax_runs = []
    with jax_sort_knn():
        for b in cases:
            (jloss, jmetrics), jgrads = grad_fn(to_jnp(tree), {k: jnp.asarray(v) for k, v in b.items()})
            jax_runs.append(dict(jax_loss=float(jloss), jax_metrics={k: float(v) for k, v in jmetrics.items()},
                                 jax_grads=params_from_jax(jax.tree_util.tree_map(np.asarray, jgrads))))
    return jax_runs


def _runs(sharded_parity, setting):
    _, runs, _ = sharded_parity
    world, key = SHARDED[setting]
    return [r[key] for r in runs[world]]


@pytest.mark.parametrize("case", [0, 1], ids=["equal_counts", "unequal_counts"])
@pytest.mark.parametrize("setting", list(SHARDED))
def test_sharded_step_matches_jax_on_the_union(sharded_parity, setting, case):
    jax_runs = sharded_parity[0]
    for rank_run in _runs(sharded_parity, setting):
        got = rank_run["cases"][case]
        run = dict(jax_runs[case], port_metrics=got["metrics"], port_grads=got["grads"])
        assert_loss_matches(run)
        assert_grads_match(run)


@pytest.mark.parametrize("case", [0, 1], ids=["equal_counts", "unequal_counts"])
@pytest.mark.parametrize("setting", list(SHARDED))
def test_sharded_update_matches_the_dp_step(sharded_parity, setting, case):
    """The parameters after the update against the port's dp step on the same data split; every rank's the same."""
    _, runs, union = sharded_parity
    rank_runs = _runs(sharded_parity, setting)
    n_data = rank_runs[0]["mesh"][0]
    want = runs[2][0][("dp", 1)]["cases"][case]["params"] if n_data == 2 else union[case]
    for r in rank_runs:
        got = r["cases"][case]["params"]
        assert set(got) == set(want)
        bad = [(n, float((got[n] - w).abs().max())) for n, w in want.items()
               if float((got[n] - w).abs().max()) > PARAM_RTOL * float(w.abs().max())]
        assert not bad, bad[:10]
        assert all(torch.equal(got[n], rank_runs[0]["cases"][case]["params"][n]) for n in got)


@pytest.mark.parametrize("setting", list(SHARDED))
def test_placements_are_kept_after_the_update(sharded_parity, setting):
    """Each sharded parameter's local shard and its AdamW moments keep the placement's shape after the update; the
    strategy shards JAX's number of leaves; the mesh coordinates cover the mesh once."""
    rank_runs = _runs(sharded_parity, setting)
    strategy = SHARDED[setting][1][0]
    n_data, n_model = rank_runs[0]["mesh"]
    assert sorted(r["coord"] for r in rank_runs) == [(d, m) for d in range(n_data) for m in range(n_model)]
    for r in rank_runs:
        got = r["cases"][0]
        assert len(got["axes"]) == N_SHARDED[strategy]
        for name, full in got["params"].items():
            want = list(full.shape)
            if name in got["axes"]:
                axis, dim = got["axes"][name]
                assert dim == ("data" if strategy == "fsdp" else "model")
                want[axis] //= n_data if dim == "data" else n_model
            assert got["local"][name] == (tuple(want),) * 3, name


@pytest.mark.parametrize("setting", ["fsdp-2", "tp-2"])
def test_accumulated_sharded_update(sharded_parity, setting):
    """Two calls accumulated into one update, the accumulator on the shards: the update's gradients are the mean of
    JAX's union gradients of the two calls."""
    jax_runs = sharded_parity[0]
    want = {n: (jax_runs[0]["jax_grads"][n] + jax_runs[1]["jax_grads"][n]) / 2 for n in jax_runs[0]["jax_grads"]}
    for r in _runs(sharded_parity, setting):
        assert_grads_match(dict(port_grads=r["accumulated"], jax_grads=want))
