"""The port's ETL packer (`trafficbotsv15_tpu_torch/data/pack_episode.py`) and h5 writer
(`data/pack_h5_womd.py`) against the reference's goldens and the JAX package's packer.

Every case of `tests/golden/etl_parity_golden.npz` (50 seeds x training / validation / testing, made by the
reference's pack_h5.py through `tests/etl_parity_common.py::run_pipeline`) goes through the same call sequence with
the port's module, at `test_etl_parity.py`'s tolerances: integers and bools bit-exact, floats atol 5e-5 and
rtol 1e-5. The port's packer equals the JAX package's bit for bit on the same seeds. The JAX unit tests of
`tests/test_pack_episode.py` are mirrored on the port's module, and packed episodes written by `write_h5` are
read back through `data=h5` by a tiny-width `joint_future_pred` on the CPU.
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_helpers import set_threads
from tests.etl_parity_common import make_raw, run_pipeline
from trafficbotsv15_tpu.data import pack_episode as jax_pk
from trafficbotsv15_tpu_torch.config import DataCfg, tiny_config
from trafficbotsv15_tpu_torch.data import pack_episode as pk
from trafficbotsv15_tpu_torch.data import pack_h5_womd
from trafficbotsv15_tpu_torch.data.h5_dataset import tensor_size_train

set_threads()
GOLDEN = Path(__file__).parent / "golden/etl_parity_golden.npz"
SEEDS, DATASETS = range(50), ("training", "validation", "testing")

_PORT_RUNS = {}


def port_run(seed: int, dataset: str) -> dict:
    """The port's packer on case (seed, dataset), run once per file (the two parity tests read it)."""
    if (seed, dataset) not in _PORT_RUNS:
        _PORT_RUNS[(seed, dataset)] = run_pipeline(pk, make_raw(seed), dataset, is_ref=False, seed=seed)
    return _PORT_RUNS[(seed, dataset)]


@pytest.fixture(scope="module")
def golden():
    return np.load(GOLDEN)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("dataset", DATASETS)
def test_port_packer_matches_the_reference_goldens(golden, seed, dataset):
    ours = port_run(seed, dataset)
    keys = {k.split("|", 2)[2] for k in golden.files if k.startswith(f"{seed}|{dataset}|")}
    assert keys, "no goldens for this case"
    assert not keys - set(ours), f"the port's packer lacks keys: {sorted(keys - set(ours))}"
    for key in sorted(keys):
        exp = golden[f"{seed}|{dataset}|{key}"]
        got = np.asarray(ours[key])
        assert got.shape == exp.shape, (key, got.shape, exp.shape)
        if exp.dtype.kind in "biu":
            np.testing.assert_array_equal(got, exp, err_msg=key)
        else:
            np.testing.assert_allclose(got, exp, atol=5e-5, rtol=1e-5, err_msg=key)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("dataset", DATASETS)
def test_port_packer_equals_the_jax_packer_bit_for_bit(seed, dataset):
    ours = port_run(seed, dataset)
    theirs = run_pipeline(jax_pk, make_raw(seed), dataset, is_ref=False, seed=seed)
    assert set(ours) == set(theirs)
    for key, want in theirs.items():
        got = np.asarray(ours[key])
        assert got.dtype == np.asarray(want).dtype and got.shape == np.shape(want), key
        np.testing.assert_array_equal(got, want, err_msg=key)


def test_polygon_to_polylines_parity(golden):
    """get_polylines_from_polygon against the reference (pack_h5.py:822-849)."""
    for p in range(4):
        quad = golden[f"polygon|{p}|in"]
        for j, pl in enumerate(pk.get_polylines_from_polygon(quad)):
            np.testing.assert_allclose(np.asarray(pl), golden[f"polygon|{p}|out{j}"], atol=1e-6,
                                       err_msg=f"polygon {p} part {j}")


def _packed(seed: int = 0, dataset: str = "training") -> dict:
    return {k: v for k, v in port_run(seed, dataset).items() if not k.startswith("__")}


def test_schema_matches_the_ports_h5_sizes():
    """The packed training episode has the port's h5 train contract at the packer's sizes, sdc first."""
    from tests.etl_parity_common import N_AG_H5_SIM, N_MP_H5, N_MP_PL_NODE, N_TL_DATA, N_TL_LANE_H5

    reduced = _packed()
    schema = tensor_size_train(DataCfg(n_ag=N_AG_H5_SIM, n_mp=N_MP_H5, n_mp_pl_node=N_MP_PL_NODE,
                                       n_tl_lane=N_TL_LANE_H5, n_tl_stop=N_TL_DATA))
    for k, size in schema.items():
        assert tuple(reduced[k].shape) == size, (k, reduced[k].shape, size)
    assert reduced["agent/role"][0, 0]
    valid = reduced["agent/valid"]
    for a in range(valid.shape[0]):  # interpolation fills internal gaps: valid runs are contiguous
        idx = np.where(valid[a])[0]
        assert len(idx) == 0 or (np.diff(idx) == 1).all()
    dests = reduced["agent/dest"][valid.any(-1)]
    assert (dests >= 0).all() and (dests < N_MP_H5).all()


def test_pack_map_splits_polylines_and_centres_the_sdc():
    raw = make_raw(1)
    episode = {}
    n = pk.pack_episode_map(episode, raw["mp_id"], raw["mp_xyz"], raw["mp_type"], raw["mp_edge"], 512, 20)
    assert n > len(raw["mp_id"]) and episode["map/valid"].sum(-1).max() <= 20
    reduced = _packed(1)
    np.testing.assert_allclose(reduced["agent/pos"][0, 10, :2], 0.0, atol=1e-4)
    np.testing.assert_allclose(reduced["agent/yaw_bbox"][0, 10, 0], 0.0, atol=1e-4)


def test_classify_track():
    n = 50
    valid = np.ones(n, bool)
    assert pk.classify_track(valid, np.zeros((n, 2)), np.zeros(n), np.zeros(n)) == 0  # stationary
    pos = np.stack([np.linspace(0, 50, n), np.zeros(n)], -1)
    assert pk.classify_track(valid, pos, np.zeros(n), np.full(n, 10.0)) == 1  # straight at 10 m/s
    yaw = np.linspace(0, np.pi / 2, n)
    pos = np.stack([np.sin(yaw) * 20, (1 - np.cos(yaw)) * 20], -1)
    assert pk.classify_track(valid, pos, yaw, np.full(n, 5.0)) == 5  # left turn
    yaw = np.linspace(0, -np.pi / 2, n)
    pos = np.stack([np.sin(-yaw) * 20, -(1 - np.cos(yaw)) * 20], -1)
    assert pk.classify_track(valid, pos, yaw, np.full(n, 5.0)) == 7  # right turn


def test_find_dest_out_of_contract_guards():
    """The two guards for inputs the reference crashes on: no road edge at all returns polyline 0; a lane whose id
    has no outgoing edge row ends the topology walk at that lane."""
    rng = np.random.default_rng(0)
    empty = np.zeros((0, 2))
    dest = pk.find_dest(
        np.array([False, True, False]), np.array([1.0, 2.0, 0.0, 3.0]), np.zeros((0, 2), np.int64),
        empty, empty, np.zeros(0, np.int64), np.zeros(0, np.int64),
        empty, empty, np.zeros(0, np.int64), empty, np.zeros(0, np.int64), rng=rng)
    assert dest == 0
    dest = pk.find_dest(
        np.array([True, False, False]), np.array([0.0, 0.0, 0.0, 5.0]), np.zeros((0, 2), np.int64),
        np.array([[0.5, 0.0]]), np.array([[1.0, 0.0]]), np.array([77]), np.array([9]),
        empty, empty, np.zeros(0, np.int64), np.array([[100.0, 100.0]]), np.array([3]), rng=rng)
    assert dest == 9


def test_packer_schema_constants_match_the_jax_script():
    """The packer CLI's schema constants and TL state map are the JAX script's."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("jax_pack_h5_womd", Path(__file__).parents[1]
                                                  / "scripts/pack_h5_womd.py")
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    for name in ("N_MP_TYPE", "N_MP_PL_NODE", "DIM_VEH_LANES", "DIM_CYC_LANES", "DIM_PED_LANES", "N_TL_STATE",
                 "N_AG_TYPE", "N_MP_DATA", "N_TL_DATA", "N_AG_DATA", "N_MP_H5", "N_TL_LANE_H5", "N_AG_H5_SIM",
                 "N_AG_H5_NO_SIM", "DIST_THRESH_MP", "DIST_THRESH_AG", "N_STEP", "STEP_CURRENT", "DATASET_SIZE",
                 "_TL_STATE_MAP"):
        assert getattr(pack_h5_womd, name) == getattr(script, name), name


def test_missing_packages_raise_naming_them(monkeypatch, tmp_path):
    import sys

    for name in ("h5py", "waymo_open_dataset", "tensorflow"):  # None in sys.modules: the import raises
        monkeypatch.setitem(sys.modules, name, None)
    with pytest.raises(ImportError, match="h5py"):
        pack_h5_womd.write_h5(tmp_path / "x.h5", [])
    with pytest.raises(ImportError, match="waymo_open_dataset"):
        pack_h5_womd.pack_scenario((b"", "training", -1.0, -1.0, False, 0))
    with pytest.raises(ImportError, match="h5py"):
        pack_h5_womd.main(["--data-dir", str(tmp_path), "--out-dir", str(tmp_path)])
    monkeypatch.delitem(sys.modules, "h5py")
    with pytest.raises(ImportError, match="waymo_open_dataset"):
        pack_h5_womd.main(["--data-dir", str(tmp_path), "--out-dir", str(tmp_path)])


def test_write_h5_round_trips_through_data_h5_into_joint_future_pred(tmp_path):
    """Packed episodes written by write_h5 come back bit for bit through run.py's data=h5 loaders, and a
    tiny-width joint_future_pred runs on a validation batch of them on the CPU."""
    from trafficbotsv15_tpu_torch import run as run_lib
    from trafficbotsv15_tpu_torch.train.evaluation import joint_future_pred
    from trafficbotsv15_tpu_torch.train.pipeline import build_model

    packed = {}
    for split in ("training", "validation"):
        records = []
        for seed in (0, 1):
            reduced = dict(port_run(seed, split))
            center, yaw = reduced.pop("__center"), reduced.pop("__yaw")
            records.append((f"scenario-{seed}", center, float(yaw), True, reduced))
        packed[split] = records
        assert pack_h5_womd.write_h5(tmp_path / f"{split}.h5", records) == 2

    cfg = tiny_config(n_ag=8, n_mp=24, n_tl=32, n_step=91)
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, n_mp_pl_node=20, n_tl_stop=64))
    train_loader, val_loader = run_lib.make_dataloaders(cfg, "h5", str(tmp_path))
    batch = next(iter(val_loader))
    for i, (sid, center, yaw, _, reduced) in enumerate(packed["validation"]):
        for k in batch:
            if k in reduced:
                np.testing.assert_array_equal(batch[k][i], reduced[k], err_msg=k)
        assert bytes(batch["scenario_id"][i]).rstrip(b"\0").decode() == sid
        np.testing.assert_array_equal(batch["scenario_center"][i], np.asarray(center, np.float32))
    assert set(tensor_size_train(cfg.data)) <= set(next(iter(train_loader)))

    model = build_model(cfg, seed=0, device="cpu")
    _, buf = joint_future_pred(cfg, model, batch, generator=torch.Generator().manual_seed(0), n_joint_future=2,
                               device="cpu")
    assert tuple(buf.pred_pose.shape) == (2, 2, 8, cfg.time_step_end, 3)
    assert torch.isfinite(buf.pred_pose).all() and torch.isfinite(buf.log_prob).all()
