"""PyTorch port: the mesh, the strategies' placements, device prefetch and the sharded entry points
(`parallel/mesh.py`, `run.py`), on the CPU.

In one process, against the JAX package on the 8 virtual CPU devices of `tests/conftest.py`: the placement of every
parameter of the tiny model under `fsdp_shard_params` (min size 256, mesh n_data=2; 114 leaves) and
`tp_shard_params` (n_model=2; 122 leaves), leaf by leaf through `utils/jax_import.py`'s name and transpose map;
`order_devices_for_slices` on JAX's own cases (`tests/test_parallel_fit.py`); `device_prefetch` against the loader.
Spawned gloo ranks (`tests/torch_parallel_ranks.py`): `run.main` fit for 2 steps under fsdp and under tp and resumes
to 3, the checkpoints restored across strategies (fsdp's under dp and tp's under dp with the model axis of 2 continue
the same run, to 1e-6; tp's under fsdp runs), validation after a sharded fit equal to data-parallel validation of its
parameters, a model axis that does not divide the ranks refused; and on 3 ranks over two hosts the rank the mesh
leaves out returning with nothing trained, and the next action running over all three again.
"""

import json
import math

import jax
import numpy as np
import pytest
import torch

import torch_parallel_ranks as ranks
from test_torch_helpers import jax_model_params, set_threads
from trafficbotsv15_tpu.config import tiny_config as jax_tiny_config
from trafficbotsv15_tpu.parallel import mesh as jax_mesh
from trafficbotsv15_tpu_torch import run
from trafficbotsv15_tpu_torch.config import tiny_config
from trafficbotsv15_tpu_torch.parallel import mesh
from trafficbotsv15_tpu_torch.train.pipeline import build_model

set_threads()
RESUME_RTOL = 1e-6  # a checkpoint resumed under another strategy on the same data split: summation order at most


def _jax_placements(tree) -> dict:
    """{port name: placement in the port's layout} of a flax tree of placed arrays (the inverse of the port's map:
    a kernel's spec reversed)."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        keys = [k.key for k in path]
        spec = tuple(leaf.sharding.spec) + (None,) * (leaf.ndim - len(leaf.sharding.spec))
        if keys[-1] == "kernel":
            keys[-1], spec = "weight", spec[::-1]
        elif keys[-1] == "scale":
            keys[-1] = "weight"
        out[".".join(keys)] = spec
    return out


@pytest.mark.parametrize("strategy,n_sharded,n_elements", [("fsdp", 114, 185_280), ("tp", 122, 154_816)])
def test_placements_match_jax(strategy, n_sharded, n_elements):
    _, tree = jax_model_params(jax_tiny_config(), seed=0)
    if strategy == "fsdp":
        want = _jax_placements(jax_mesh.fsdp_shard_params(tree, jax_mesh.make_mesh(n_data=2), min_size=256))
    else:
        want = _jax_placements(jax_mesh.tp_shard_params(tree, jax_mesh.make_mesh(n_data=1, n_model=2)))
    model = build_model(tiny_config(), device="cpu")
    named = list(model.named_parameters())
    got = (mesh.fsdp_shard_params(named, 2, min_size=256) if strategy == "fsdp" else
           mesh.tp_shard_params(named, 2))
    assert set(got) == set(want)
    differ = {n: (got[n], want[n]) for n in got if got[n] != want[n]}
    assert not differ, differ
    sizes = dict(named)
    sharded = [n for n, spec in got.items() if any(spec)]
    assert len(sharded) == n_sharded and sum(sizes[n].numel() for n in sharded) == n_elements


def test_order_devices_for_slices_matches_jax():
    """JAX's cases from tests/test_parallel_fit.py: interleaved slices, uneven ones truncated with the warning, and a
    slice smaller than the model axis refused; the port's order over ranks is JAX's over device ids."""
    devs = jax.devices()
    ids = [d.id for d in devs]
    interleaved = [0, 1, 0, 1, 0, 1, 0, 1]
    order, n_data = mesh.order_devices_for_slices(ids, interleaved, n_model=2)
    jorder, jn_data = jax_mesh.order_devices_for_slices(devs, interleaved, n_model=2)
    assert (order, n_data) == ([d.id for d in jorder], jn_data) and n_data == 4
    assert [r % 2 for r in order] == [0] * 4 + [1] * 4
    uneven = [0, 0, 0, 1, 1, 2, 2, 2]
    with pytest.warns(UserWarning, match="dropping 2 of 8"):
        order, n_data = mesh.order_devices_for_slices(ids, uneven, n_model=1)
    with pytest.warns(UserWarning, match="dropping 2 of 8"):
        jorder, jn_data = jax_mesh.order_devices_for_slices(devs, uneven, n_model=1)
    assert (order, n_data) == ([d.id for d in jorder], jn_data) == ([0, 1, 3, 4, 5, 6], 6)
    for fn, devices in ((mesh.order_devices_for_slices, ids[:6]), (jax_mesh.order_devices_for_slices, devs[:6])):
        with pytest.raises(ValueError, match="n_model=4"):
            fn(devices, [0, 0, 0, 0, 1, 1], n_model=4)


def test_device_prefetch_keeps_the_loaders_order_and_values():
    """On the CPU: every batch in the loader's order with its values, scenario_bytes and list values left out, as
    JAX's device_prefetch leaves them."""
    cfg = tiny_config()
    loader = run.SynthLoader(cfg, 3, 2, 0)

    def with_extras():
        for batch in loader:
            yield {**batch, "scenario_bytes": np.zeros(2, np.uint8), "names": ["a", "b"]}

    got = list(mesh.device_prefetch(with_extras(), "cpu"))
    want = list(loader)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            assert isinstance(g[k], torch.Tensor) and np.array_equal(g[k].numpy(), w[k]), k


def test_make_mesh_on_one_process():
    with mesh.make_mesh() as one:
        assert one is None
    assert (mesh.data_index(), mesh.data_count(), mesh.model_index(), mesh.model_count()) == (0, 1, 0, 1)
    assert mesh.batch_sharding() == dict(shard_index=0, num_shards=1)
    with pytest.raises(ValueError, match="does not divide the 1 rank"):
        with mesh.make_mesh(n_model=2):
            pass


@pytest.fixture(scope="module")
def sharded_fits(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded_fits")
    return tmp, ranks.spawn(ranks.sharded_entry_points, 2, tmp, tmp)


@pytest.mark.parametrize("strategy", ["fsdp", "tp"])
def test_sharded_fit_and_resume_on_two_ranks(sharded_fits, strategy):
    tmp, outs = sharded_fits
    for out in outs:
        assert out[strategy]["last_step"] == 3
        assert out[strategy]["files"] == ["best", "best.json", "last", "last.json", "metrics.jsonl"]
    steps = [json.loads(line)["step"] for line in outs[0][strategy]["metrics_lines"].splitlines()
             if "training/loss" in line]
    assert steps == [1, 2, 3]
    state = torch.load(tmp / strategy / "last", weights_only=True)  # full, placement-free tensors
    model = dict(build_model(tiny_config(), device="cpu").named_parameters())
    assert {n: t.shape for n, t in state["model"].items() if n in model} == {n: p.shape for n, p in model.items()}
    for i, (n, p) in enumerate(model.items()):
        assert state["optimizer"]["state"][i]["exp_avg"].shape == p.shape, n
    got = outs[0]["resumed"][(strategy, strategy)]
    assert all(torch.isfinite(t).all() for t in got.values())
    assert all(torch.equal(got[n], outs[1]["resumed"][(strategy, strategy)][n]) for n in got)


@pytest.mark.parametrize("first,other", [("fsdp", "dp"), ("tp", "dp_m2"), ("tp", "fsdp")])
def test_checkpoint_restores_across_strategies(sharded_fits, first, other):
    """A checkpoint of one strategy resumed under another: on the same data split (dp, and dp with the model axis of
    2 for tp's) the resumed step is the original strategy's to 1e-6 of each parameter's largest; tp's under fsdp
    (another split) runs to finite parameters, the same on both ranks."""
    _, outs = sharded_fits
    got = outs[0]["resumed"][(first, other)]
    assert all(torch.equal(got[n], outs[1]["resumed"][(first, other)][n]) for n in got)
    if other == "fsdp":
        assert all(torch.isfinite(t).all() for t in got.values())
        return
    want = outs[0]["resumed"][(first, first)]
    bad = [n for n, w in want.items() if float((got[n] - w).abs().max()) > RESUME_RTOL * float(w.abs().max())]
    assert not bad, bad[:10]


def test_validate_after_a_sharded_fit_is_data_parallel(sharded_fits):
    """The tp fit's validation of "best" (run in the fit on the gathered parameters, the logged line whose val/loss is
    best's score) equals the data-parallel validate of "best" restored on the same two ranks; both ranks agree."""
    tmp, (r0, r1) = sharded_fits
    score = json.loads((tmp / "tp" / "best.json").read_text())["meta"]["score"]
    logged = [json.loads(line) for line in r0["tp"]["metrics_lines"].splitlines() if "val/loss" in line]
    logged = [m for m in logged if m["val/loss"] == score][0]
    assert r0["validate_best"] == r1["validate_best"]
    for k, v in r0["validate_best"].items():
        if k != "val/scenarios_per_sec":
            assert math.isclose(logged[k], v, rel_tol=1e-6, abs_tol=1e-9), (k, logged[k], v)


def test_model_axis_that_does_not_divide_the_ranks_raises(sharded_fits):
    _, outs = sharded_fits
    assert all("parallel.model_axis=3 does not divide the 2 ranks" in out["model_axis_3"] for out in outs)


@pytest.fixture(scope="module")
def left_out(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("left_out")
    return tmp, ranks.spawn(ranks.left_out_rank, 3, tmp, tmp)


def test_a_rank_the_mesh_leaves_out_trains_nothing(left_out):
    """3 ranks on hosts [0, 0, 1]: JAX's warning, rank 1 returns at once with nothing trained, ranks 0 and 2 fit one
    step as a group of 2 (rank 0 writing "last")."""
    tmp, (r0, r1, r2) = left_out
    for out in (r0, r1, r2):
        assert any("dropping 1 of 3" in w for w in out["warnings"]), out["warnings"]
    assert not r1["trained"] and r1["params"] is None and r1["in_fit"] == []
    assert r0["trained"] and r2["trained"] and not r0["stopped"] and not r2["stopped"]
    assert (r0["in_fit"], r2["in_fit"]) == ([(2, 0)], [(2, 1)])
    assert all(torch.equal(r0["params"][n], r2["params"][n]) for n in r0["params"])
    assert json.loads((tmp / "fit" / "last.json").read_text())["meta"]["step"] == 1


def test_the_next_action_after_a_mesh_sees_the_whole_world(left_out):
    """After the fit whose mesh left rank 1 out, the collectives run over all 3 ranks again: each rank has its own
    index of 3, and a second `run.main` (validate of "last") runs data parallel over all three, the same metrics on
    each."""
    _, outs = left_out
    assert [out["after"] for out in outs] == [(3, 0), (3, 1), (3, 2)]
    metrics = [{k: v for k, v in out["validated"].items() if k != "val/scenarios_per_sec"} for out in outs]
    assert metrics[0] and metrics[1] == metrics[0] and metrics[2] == metrics[0]
