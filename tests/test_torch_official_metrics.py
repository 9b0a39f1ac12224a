"""PyTorch port: the official Waymo metrics plumbing of validation, on the CPU.

With the structural waymo_open_dataset stubs installed (`tests/waymo_stub`, whose per-scenario WOSAC
"metrics" are deterministic functions of the rollout's structure):
  - the port's `WOSACMetrics` end to end: forkserver pool, running sums, bucket aggregation;
  - `pack_waymo_inputs` bit for bit against the JAX package's on seeded random inputs, and against
    `tests/golden/womd_pack_golden.npz`;
  - `validate` with the WOMD op's gate and the op itself monkeypatched (TensorFlow and Waymo's op are absent
    here): one official call per flavour at the end over every batch's packed rows, K modes for the joint
    futures and one for reactive replay; and with scenario bytes attached, the WOSAC pool fed from the
    filtered futures in the global frame;
  - `H5Dataset(scenario_dir=...)` yields each scenario's bytes, as the JAX package's does, and the collate
    keeps them a ragged list.
"""

import importlib.util
import pickle
from pathlib import Path

import numpy as np
import pytest

import waymo_stub

waymo_stub.install()

from test_torch_helpers import set_threads  # noqa: E402
from trafficbotsv15_tpu.data import h5_dataset as jax_h5  # noqa: E402
from trafficbotsv15_tpu.eval.womd_metrics import pack_waymo_inputs as jax_pack  # noqa: E402
from trafficbotsv15_tpu_torch.config import DataCfg, WOSACPostCfg, tiny_config  # noqa: E402
from trafficbotsv15_tpu_torch.data import h5_dataset  # noqa: E402
from trafficbotsv15_tpu_torch.data.synthetic import make_batch  # noqa: E402
from trafficbotsv15_tpu_torch.eval import runner  # noqa: E402
from trafficbotsv15_tpu_torch.eval import womd_metrics  # noqa: E402
from trafficbotsv15_tpu_torch.eval.wosac_metrics import FIELD_NAMES, WOSACMetrics  # noqa: E402
from trafficbotsv15_tpu_torch.eval.wosac_post_processing import get_scenario_rollouts  # noqa: E402
from trafficbotsv15_tpu_torch.train.pipeline import build_model  # noqa: E402
from trafficbotsv15_tpu_torch.utils.logging import MetricsLogger  # noqa: E402

set_threads()
REPO = Path(__file__).resolve().parents[1]
STEP_CURRENT, STEP_GT = 3, 8  # tiny horizon: 5 future steps
N_SC, N_FUT, N_AG, N_NS = 2, 3, 2, 1


def _stub_metametric(n_scene: int, n_traj: int) -> float:
    """The stub's per-scenario metametric (its first field)."""
    return 0.1 + 0.001 * n_scene + 0.0001 * n_traj


def test_wosac_metrics_pool_end_to_end():
    rng = np.random.default_rng(7)
    hist = STEP_CURRENT + 1
    data = {
        "trajs": rng.normal(size=(N_SC, N_FUT, N_AG, STEP_GT - STEP_CURRENT, 3)).astype(np.float32),
        "history/agent/valid": np.ones((N_SC, N_AG, hist), bool),
        "history/agent/pos": rng.normal(size=(N_SC, N_AG, hist, 3)).astype(np.float32),
        "history/agent/yaw_bbox": rng.normal(size=(N_SC, N_AG, hist, 1)).astype(np.float32),
        "history/agent/object_id": np.array([[11, 12], [21, 22]]),
        "history/agent_no_sim/valid": np.ones((N_SC, N_NS, hist), bool),
        "history/agent_no_sim/pos": rng.normal(size=(N_SC, N_NS, hist, 3)).astype(np.float32),
        "history/agent_no_sim/yaw_bbox": rng.normal(size=(N_SC, N_NS, hist, 1)).astype(np.float32),
        "history/agent_no_sim/object_id": np.array([[91], [92]]),
    }
    rollouts = get_scenario_rollouts(WOSACPostCfg(), data, STEP_CURRENT, STEP_GT, ["a", "b"])
    m = WOSACMetrics("val")
    m.update(rollouts, [b"\x01\x02".hex(), b"\x03\x04".hex()])
    assert m.counter == 2
    out = m.compute()
    expect = _stub_metametric(N_FUT, N_AG + N_NS)
    assert out["val/wosac/realism_meta_metric"] == pytest.approx(expect, rel=1e-5)
    assert out["val/wosac_likelihood/metametric"] == pytest.approx(expect, rel=1e-5)
    for key in ("kinematic_metrics", "interactive_metrics", "map_based_metrics", "min_ade"):
        assert np.isfinite(out[f"val/wosac/{key}"])
    assert {f"val/wosac_likelihood/{k}" for k in FIELD_NAMES} <= set(out)


def _random_pack_inputs(seed: int):
    cfg = tiny_config()
    batch = make_batch(cfg.data, n_sc=3, seed=seed)
    rng = np.random.default_rng(seed)
    n_sc, n_ag = batch["agent/valid"].shape[:2]
    batch["agent/role"][..., 2] = rng.uniform(size=(n_sc, n_ag)) < 0.4
    batch["agent/valid"] &= rng.uniform(size=batch["agent/valid"].shape) < 0.9
    trajs = rng.normal(size=(n_sc, n_ag, 6, 2, 3)).astype(np.float32)
    scores = rng.uniform(size=(n_sc, n_ag, 6)).astype(np.float32)
    return batch, trajs, scores, cfg.time_step_gt, cfg.time_step_current


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pack_waymo_inputs_bit_equal_to_jax(seed):
    args = _random_pack_inputs(seed)
    got, want = womd_metrics.pack_waymo_inputs(*args), jax_pack(*args)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        assert got[k].tobytes() == want[k].tobytes(), k
    assert got["prediction_ground_truth_indices_mask"].any()


def test_pack_waymo_inputs_byte_golden():
    spec = importlib.util.spec_from_file_location("gen_womd_pack_golden", REPO / "scripts" / "gen_womd_pack_golden.py")
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    packed = womd_metrics.pack_waymo_inputs(*gen.build_inputs())
    with np.load(REPO / "tests" / "golden" / "womd_pack_golden.npz") as gold:
        assert sorted(packed) == sorted(gold.files)
        for k in gold.files:
            assert packed[k].dtype == gold[k].dtype and packed[k].shape == gold[k].shape, k
            assert packed[k].tobytes() == gold[k].tobytes(), f"packing drift in {k}"


def _val_cfg():
    return tiny_config(n_ag=6, n_mp=20, n_tl=6, n_step=21, hidden_dim=32)


def _val_batches(cfg, with_scenario: bool):
    """Two validation batches of 2 scenarios: the ground truth and, with_scenario, the test split's history
    keys, scenario ids, frames and the scenario bytes (a ragged list) the WOSAC pool reads."""
    out = []
    for i in range(2):
        batch = make_batch(cfg.data, n_sc=2, seed=100 + i)
        if with_scenario:
            test = make_batch(cfg.data, n_sc=2, seed=100 + i, test_mode=True)
            batch.update({k: v for k, v in test.items() if k.startswith("history/agent") or k.startswith("scenario_")})
            batch["scenario_bytes"] = [np.arange(3 + j, dtype=np.uint8) for j in range(2)]
        out.append(batch)
    return out


def _model(cfg):
    return build_model(cfg, seed=0, device="cpu")


def test_validate_official_womd_wiring(monkeypatch):
    """One official call per flavour at the end, over both batches' rows concatenated."""
    cfg = _val_cfg()
    calls = []

    def fake_op(packed, step_current, prefix):
        calls.append((packed, step_current, prefix))
        return {f"{prefix}/waymo_metrics/mean_average_precision": 0.5}

    monkeypatch.setattr(runner, "_womd_official_available", lambda: True)
    monkeypatch.setattr(womd_metrics, "official_motion_metrics", fake_op)
    metrics = runner.validate(cfg, _model(cfg), _val_batches(cfg, False), logger=MetricsLogger(None, echo=False),
                              device="cpu")
    assert metrics["joint_future_pred/waymo_metrics/mean_average_precision"] == 0.5
    assert metrics["reactive_replay/waymo_metrics/mean_average_precision"] == 0.5
    assert [c[2] for c in calls] == ["joint_future_pred", "reactive_replay"]
    for packed, step_current, _ in calls:
        assert step_current == cfg.time_step_current
        assert packed["prediction_trajectory"].shape[0] == 4  # 2 batches x 2 scenarios
        assert packed["ground_truth_trajectory"].shape[-1] == 7
        assert packed["prediction_ground_truth_indices_mask"].any()
        assert all(isinstance(v, np.ndarray) for v in packed.values())
    assert calls[0][0]["prediction_trajectory"].shape[2] > 1  # K modes of the joint futures
    assert calls[1][0]["prediction_trajectory"].shape[2] == 1  # reactive replay's one
    assert not any(k.startswith("wosac/wosac/") for k in metrics)  # no scenario bytes, no pool


def test_validate_gate_closed_makes_no_official_call(monkeypatch):
    monkeypatch.setattr(womd_metrics, "official_motion_metrics", lambda *a: pytest.fail("official op called"))
    assert runner._womd_official_available() is False  # no TensorFlow, no Waymo op here
    cfg = _val_cfg()
    metrics = runner.validate(cfg, _model(cfg), _val_batches(cfg, False)[:1], logger=MetricsLogger(None, echo=False),
                              device="cpu")
    assert not any("waymo_metrics" in k for k in metrics) and np.isfinite(metrics["val/loss"])


def test_validate_feeds_the_wosac_pool(monkeypatch):
    """With scenario bytes and ids in the batches, the pool gets every scenario's filtered futures."""
    cfg = _val_cfg()
    seen = []
    real_update = WOSACMetrics.update

    def update(self, rollouts, scenario_bytes):
        seen.append((rollouts, scenario_bytes))
        return real_update(self, rollouts, scenario_bytes)

    monkeypatch.setattr(WOSACMetrics, "update", update)
    batches = _val_batches(cfg, True)
    metrics = runner.validate(cfg, _model(cfg), batches, logger=MetricsLogger(None, echo=False), device="cpu")
    assert len(seen) == 2
    assert seen[0][1] == [x.tobytes().hex() for x in batches[0]["scenario_bytes"]]
    rollouts = [r for rs, _ in seen for r in rs]
    sids = [r.scenario_id for r in rollouts]
    assert sids == runner._decode_sids(np.concatenate([b["scenario_id"] for b in batches]))
    n_scene = min(cfg.n_joint_future_wosac, 32)
    expect = np.mean([_stub_metametric(n_scene, len(r.joint_scenes[0].simulated_trajectories)) for r in rollouts])
    assert all(len(r.joint_scenes) == n_scene for r in rollouts)
    assert metrics["wosac/wosac/realism_meta_metric"] == pytest.approx(expect, rel=1e-5)
    for key in ("kinematic_metrics", "interactive_metrics", "map_based_metrics", "min_ade"):
        assert np.isfinite(metrics[f"wosac/wosac/{key}"])
    assert np.isfinite(metrics["wosac/realism_meta_metric"])  # the native metametric stays beside it


# ------------------------------------------------------------------ scenario bytes through the h5 loader

SIZES = dict(n_ag=8, n_mp=16, n_step=21, n_tl_lane=8, n_tl_stop=8)
N_H5 = 5


@pytest.fixture(scope="module")
def h5_split(tmp_path_factory):
    h5py = pytest.importorskip("h5py")
    root = tmp_path_factory.mktemp("h5_scenarios")
    scenes = make_batch(DataCfg(**SIZES), n_sc=N_H5, seed=1)
    with h5py.File(root / "validation.h5", "w") as hf:
        for i in range(N_H5):
            g = hf.create_group(str(i))
            for k, v in scenes.items():
                g.create_dataset(k, data=v[i])
        hf.attrs["data_len"] = N_H5
    (root / "scenarios").mkdir()
    payloads = [bytes(np.random.default_rng(i).integers(0, 256, 10 + 7 * i, dtype=np.uint8)) for i in range(N_H5)]
    for i, p in enumerate(payloads):
        with open(root / "scenarios" / f"{i}.pickle", "wb") as f:
            pickle.dump(p, f)
    return root, payloads


def test_h5_dataset_scenario_bytes(h5_split):
    root, payloads = h5_split
    schema = h5_dataset.tensor_size_train(DataCfg(**SIZES))
    ours = h5_dataset.H5Dataset(root / "validation.h5", schema, scenario_dir=str(root / "scenarios"))
    ref = jax_h5.H5Dataset(root / "validation.h5", schema, scenario_dir=str(root / "scenarios"))
    for i in range(N_H5):
        got, want = ours[i], ref[i]
        assert set(got) == set(want) and got["scenario_bytes"].dtype == np.uint8
        assert got["scenario_bytes"].tobytes() == payloads[i] == want["scenario_bytes"].tobytes()
    assert "scenario_bytes" not in h5_dataset.H5Dataset(root / "validation.h5", schema)[0]


@pytest.mark.parametrize("workers", [0, 2])
def test_h5_loader_keeps_scenario_bytes_ragged(h5_split, workers):
    root, payloads = h5_split
    schema = h5_dataset.tensor_size_train(DataCfg(**SIZES))
    ds = h5_dataset.H5Dataset(root / "validation.h5", schema, scenario_dir=str(root / "scenarios"))
    batches = list(h5_dataset.DataLoader(ds, batch_size=2, num_workers=workers))
    assert [len(b["scenario_bytes"]) for b in batches] == [2, 2, 1]
    got = [x.tobytes() for b in batches for x in b["scenario_bytes"]]
    assert got == payloads
    assert all(isinstance(b["scenario_bytes"], list) and b["agent/valid"].shape[0] == len(b["scenario_bytes"])
               for b in batches)
