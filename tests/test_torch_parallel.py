"""PyTorch port: the data-parallel units (`parallel/mesh.py` and what it touches), on the CPU.

Two ranks over gloo, spawned once for the module (`tests/torch_parallel_ranks.py`, a file store, no TCP port):
each collective against its one-process definition (sums and gathers in rank order, rank 0's parameters, the
gradient sum with a None gradient as zeros, a barrier that waits for the slower rank, a sum over trees of other
shapes refused on every rank), and the rank-0-only writes of `MetricsLogger` and `CheckpointManager` (every rank
restores rank 0's state; no `.tmp` or `.old` left behind). In one process: `resolve_device` under LOCAL_RANK,
`SynthLoader`'s per-shard seeds against the JAX loader's by scenario id, `pad_batch_to_devices` against JAX's,
and the parallel settings one process refuses (fsdp, tp, a model axis over one rank).
"""

import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import torch_parallel_ranks as ranks
from test_torch_helpers import set_threads
from trafficbotsv15_tpu import run as jax_run
from trafficbotsv15_tpu.config import tiny_config as jax_tiny_config
from trafficbotsv15_tpu.parallel import mesh as jax_mesh
from trafficbotsv15_tpu_torch import run
from trafficbotsv15_tpu_torch.config import tiny_config
from trafficbotsv15_tpu_torch.parallel import mesh
from trafficbotsv15_tpu_torch.utils import device as device_lib

set_threads()


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("collectives")
    return tmp, ranks.spawn(ranks.collectives, 2, tmp, tmp)


def test_ranks_join_one_group(two_ranks):
    _, (r0, r1) = two_ranks
    assert (r0["rank"], r1["rank"]) == (0, 1) and r0["count"] == r1["count"] == 2
    assert r0["init_again"] and r1["init_again"]  # a group already up is left as it is


def test_cross_process_sum_and_max(two_ranks):
    _, outs = two_ranks
    for out in outs:
        s = out["sum"]
        assert float(s["a"]) == 3.0 and float(s["n"]) == 1.0 and s["empty"] == {}
        np.testing.assert_array_equal(s["b"]["c"], np.arange(3) * 3.0)
        assert s["b"]["c"].dtype == np.float64
        assert out["max"] == 2.5
        assert out["mismatch"] is not None and "differ" in out["mismatch"]


def test_allgather_rows_and_broadcast_object(two_ranks):
    _, outs = two_ranks
    for out in outs:  # blocks of unequal length, in rank order, on every rank
        np.testing.assert_array_equal(out["rows"]["x"], [[0, 0], [1, 1], [1, 1]])
        np.testing.assert_array_equal(out["rows"]["y"], [0, 0, 1])
        assert out["object"] == {"from": 0}


def test_barrier_waits_for_every_rank(two_ranks):
    _, outs = two_ranks
    assert all(out["seen_after_barrier"] for out in outs)


def test_broadcast_params_and_all_reduce_grads(two_ranks):
    _, (r0, r1) = two_ranks
    torch.manual_seed(0)
    want = [t.detach() for t in torch.nn.Linear(3, 2).parameters()] + [torch.zeros(2)]
    for out in (r0, r1):
        assert all(torch.equal(got, w) for got, w in zip(out["params"], want))  # rank 0's, buffers too
        torch.testing.assert_close(out["grads"][0], torch.full((4,), 3.0), rtol=0, atol=0)
        torch.testing.assert_close(out["grads"][1], torch.full((2, 3), 3.0), rtol=0, atol=0)  # None on rank 0


def test_rank0_alone_writes_metrics_and_checkpoints(two_ranks):
    tmp, outs = two_ranks
    lines = (tmp / "metrics.jsonl").read_text().splitlines()
    assert len(lines) == 1 and json.loads(lines[0])["x"] == 0.0
    for out in outs:
        assert torch.equal(out["last"], torch.zeros(2)) and torch.equal(out["best"], torch.zeros(2))
        assert out["best_saved"] == [True, False]  # the same decision on both ranks
        assert out["files"] == ["best", "best.json", "last", "last.json"]  # no last.tmp, no .old
    assert json.loads((tmp / "ckpt" / "last.json").read_text())["meta"]["step"] == 2


def test_one_process_is_the_identity():
    tree = {"a": torch.tensor(1.5), "b": {"c": np.arange(3)}, "n": 2}
    assert mesh.process_index() == 0 and mesh.process_count() == 1
    assert mesh.cross_process_sum(tree) is tree and mesh.cross_process_max(4.0) == 4.0
    rows = {"x": np.ones((2, 3))}
    assert mesh.allgather_rows(rows) is rows and mesh.broadcast_object(rows) is rows
    mesh.barrier()
    p = torch.nn.Parameter(torch.ones(3))
    mesh.all_reduce_grads([p])  # a None gradient as zeros, nothing summed
    assert torch.equal(p.grad, torch.zeros(3))


def test_maybe_init_distributed_without_torchrun(monkeypatch):
    for key in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(key, raising=False)
    assert mesh.maybe_init_distributed() is False and not mesh.is_distributed()


@pytest.mark.parametrize("n_devices", [1, 2, 3, 5])
def test_pad_batch_to_devices_matches_jax(n_devices):
    rng = np.random.default_rng(0)
    batch = {"a": rng.normal(size=(4, 3)).astype(np.float32), "b": rng.integers(0, 9, size=(4,))}
    ours, n_ours = mesh.pad_batch_to_devices(batch, n_devices)
    ref, n_ref = jax_mesh.pad_batch_to_devices(batch, n_devices)
    assert n_ours == n_ref == 4 and set(ours) == set(ref)
    for k in batch:
        np.testing.assert_array_equal(ours[k], ref[k])
        assert ours[k].dtype == ref[k].dtype


@pytest.mark.parametrize("local_rank,n_cards,want", [(None, 1, 0), ("1", 2, 1), ("3", 4, 3), ("2", 2, None),
                                                     ("1", 1, None)])
def test_resolve_device_takes_the_rank_card(monkeypatch, local_rank, n_cards, want):
    """The default device is cuda:LOCAL_RANK, made current; past the cards it raises, never wrapping around."""
    current = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: n_cards)
    monkeypatch.setattr(torch.cuda, "set_device", current.append)
    if local_rank is None:
        monkeypatch.delenv("LOCAL_RANK", raising=False)
    else:
        monkeypatch.setenv("LOCAL_RANK", local_rank)
    if want is None:
        with pytest.raises(RuntimeError, match="LOCAL_RANK"):
            device_lib.resolve_device()
        return
    assert device_lib.resolve_device() == torch.device("cuda", want) and current == [torch.device("cuda", want)]
    assert device_lib.resolve_device("cpu") == torch.device("cpu")  # a named device is honoured
    assert len(current) == 1


def test_resolve_device_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("LOCAL_RANK", "1")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        device_lib.resolve_device()
    assert device_lib.resolve_device("cpu") == torch.device("cpu")


def _sids(batch):
    return ["".join(chr(c) for c in row if c > 0) for row in batch["scenario_id"]]


@pytest.mark.parametrize("shard,num_shards", [(0, 1), (0, 2), (1, 2), (2, 4)])
def test_synth_loader_shards_match_jax(monkeypatch, shard, num_shards):
    """Both loaders give shard s of n the scenes of seeds seed0 + i·n + s, by scenario id (JAX with one local
    device, as a process of the port holds)."""
    monkeypatch.setattr(jax, "process_index", lambda: shard)
    monkeypatch.setattr(jax, "process_count", lambda: num_shards)
    monkeypatch.setattr(jax, "local_device_count", lambda: 1)
    monkeypatch.setattr(run, "process_index", lambda: shard)
    monkeypatch.setattr(run, "process_count", lambda: num_shards)
    ours = run.make_dataloaders(tiny_config(), "synthetic", None, test_mode=True)
    ref = jax_run.make_dataloaders(jax_tiny_config(), "synthetic", None, test_mode=True)
    for ours_loader, ref_loader in zip(ours, ref):  # the last two batches of each split, every array
        assert len(ours_loader) == len(ref_loader)
        start = len(ours_loader) - 2
        for got, want in zip(ours_loader.iter_from(start), ref_loader.iter_from(start), strict=True):
            assert set(got) == set(want)
            for k in got:
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    last = list(ours[1].iter_from(len(ours[1]) - 1))[0]  # the test-mode validation split carries the ids
    seed = 10_000 + (len(ours[1]) - 1) * num_shards + shard
    assert _sids(last) == [f"synthetic_{seed}_{i}"[:16] for i in range(len(_sids(last)))]


@pytest.mark.parametrize("arg", ["parallel.strategy=fsdp", "parallel.strategy=tp", "parallel.model_axis=2"])
def test_other_strategies_still_raise(tmp_path, arg):
    """On one process (no process group) fsdp and tp, which place parameters over ranks, and a model axis of 2,
    which does not divide the one rank, raise a ValueError before anything is built or written."""
    match = "does not divide" if "model_axis" in arg else "process group"
    with pytest.raises(ValueError, match=match):
        run.main(["action=fit", "device=cpu", "preset=tiny", f"ckpt_dir={tmp_path}", "max_steps=1", arg])
    assert not (Path(tmp_path) / "last").exists()
