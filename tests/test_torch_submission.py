"""PyTorch port: the submission path on the CPU.

With the structural waymo_open_dataset stubs installed (`tests/waymo_stub`,
as `tests/test_submission_protos.py` installs them), the port's
`SubWOMD`, `SubWOSAC` and `get_scenario_rollouts` serialise the same arrays
to the same bytes as the JAX package's. `test_submission` runs at tiny size
on the CPU: K=40 futures filtered to 32 in the global frame, a padded tail
batch, every scenario once in the WOMD and the WOSAC submissions.
"""

import numpy as np
import pytest
import torch

import waymo_stub

waymo_stub.install()

from test_torch_helpers import set_threads  # noqa: E402
from trafficbotsv15_tpu.config import WOSACPostCfg as JaxWOSACPostCfg  # noqa: E402
from trafficbotsv15_tpu.eval import submission as jsub  # noqa: E402
from trafficbotsv15_tpu.eval import wosac_post_processing as jws  # noqa: E402
from trafficbotsv15_tpu_torch.config import WOSACPostCfg, tiny_config  # noqa: E402
from trafficbotsv15_tpu_torch.data.synthetic import make_batch  # noqa: E402
from trafficbotsv15_tpu_torch.eval import runner  # noqa: E402
from trafficbotsv15_tpu_torch.eval import submission as psub  # noqa: E402
from trafficbotsv15_tpu_torch.eval import wosac_post_processing as pws  # noqa: E402
from trafficbotsv15_tpu_torch.train.pipeline import build_model  # noqa: E402

set_threads()
STEP_CURRENT, STEP_GT = 3, 8


def _wosac_data(seed, n_sc=2, n_fut=3, n_ag=3, n_ns=2):
    rng = np.random.default_rng(seed)
    hist = STEP_CURRENT + 1
    data = {
        "trajs": rng.normal(size=(n_sc, n_fut, n_ag, STEP_GT - STEP_CURRENT, 3)).astype(np.float32),
        "history/agent/valid": rng.uniform(size=(n_sc, n_ag, hist)) < 0.8,
        "history/agent/pos": rng.normal(size=(n_sc, n_ag, hist, 3)).astype(np.float32),
        "history/agent/yaw_bbox": rng.normal(size=(n_sc, n_ag, hist, 1)).astype(np.float32),
        "history/agent/object_id": np.arange(n_sc * n_ag).reshape(n_sc, n_ag) + 11,
        "history/agent_no_sim/valid": rng.uniform(size=(n_sc, n_ns, hist)) < 0.8,
        "history/agent_no_sim/pos": rng.normal(size=(n_sc, n_ns, hist, 3)).astype(np.float32),
        "history/agent_no_sim/yaw_bbox": rng.normal(size=(n_sc, n_ns, hist, 1)).astype(np.float32),
        "history/agent_no_sim/object_id": np.arange(n_sc * n_ns).reshape(n_sc, n_ns) + 91,
    }
    data["history/agent/valid"][:, :, STEP_CURRENT] = True
    data["history/agent/valid"][0, 0, STEP_CURRENT] = False  # not simulated
    return data


@pytest.mark.parametrize("const_vel", [True, False])
@pytest.mark.parametrize("global_frame", [False, True])
def test_scenario_rollouts_same_bytes_as_jax(const_vel, global_frame):
    data = _wosac_data(0)
    frame = dict(scenario_center=np.array([[100.0, -50.0], [3.0, 4.0]]), scenario_yaw=np.array([0.3, -1.2])) \
        if global_frame else {}
    want = jws.get_scenario_rollouts(JaxWOSACPostCfg(const_vel_z_sim=const_vel, const_vel_no_sim=const_vel), data,
                                     STEP_CURRENT, STEP_GT, ["a", "b"], **frame)
    got = pws.get_scenario_rollouts(WOSACPostCfg(const_vel_z_sim=const_vel, const_vel_no_sim=const_vel), data,
                                    STEP_CURRENT, STEP_GT, ["a", "b"], **frame)
    assert [r.SerializeToString() for r in got] == [r.SerializeToString() for r in want]
    assert len(got[1].joint_scenes) == 3 and len(got[0].joint_scenes[0].simulated_trajectories) >= 2


def test_sub_wosac_shard_same_bytes_as_jax(tmp_path):
    data = _wosac_data(1)
    blobs = []
    for mod, post, cfg in ((jsub, jws, JaxWOSACPostCfg()), (psub, pws, WOSACPostCfg())):
        out = tmp_path / mod.__name__.split(".")[0]
        sub = mod.SubWOSAC(mod.SubmissionMeta(), out_dir=str(out / "WOSAC"))
        rollouts = post.get_scenario_rollouts(cfg, data, STEP_CURRENT, STEP_GT, ["a", "b"])
        sub.add(rollouts)
        sub.add(rollouts)  # duplicates dropped
        sub.save()
        blobs.append((out / "WOSAC" / "submission.binproto-00000").read_bytes())
    assert blobs[0] == blobs[1] and len(blobs[0]) > 100


def test_sub_womd_same_bytes_as_jax(tmp_path):
    rng = np.random.default_rng(2)
    n_sc, n_ag, k, n_step = 2, 3, 6, 16
    args = (["sa", "sb"], rng.normal(size=(n_sc, n_ag, k, n_step, 2)).astype(np.float32),
            rng.random((n_sc, n_ag, k)).astype(np.float32), np.arange(n_sc * n_ag).reshape(n_sc, n_ag),
            np.array([[True, False, True], [True, True, False]]))
    blobs = []
    for mod in (jsub, psub):
        sub = mod.SubWOMD(mod.SubmissionMeta())
        sub.add(*args)
        sub.add(["sa"], *(a[:1] for a in args[1:]))  # duplicate dropped
        assert sub.save(str(tmp_path / mod.__name__.split(".")[0])).endswith("_WOMD.tar.gz")
        blobs.append(sub.submission.SerializeToString())
    assert blobs[0] == blobs[1]


def test_test_submission_tiny_on_cpu(tmp_path):
    """Two test batches, the second a one-scenario tail that is padded: every scenario once in both
    submissions, 32 futures of the test horizon each, trajectories finite."""
    from waymo_open_dataset.protos import motion_submission_pb2 as mpb
    from waymo_open_dataset.protos import sim_agents_submission_pb2 as spb

    cfg = tiny_config()
    model = build_model(cfg, seed=0, device="cpu")
    loader = [make_batch(cfg.data, n_sc=2, seed=5, test_mode=True),
              make_batch(cfg.data, n_sc=1, seed=9, test_mode=True)]
    womd_tar, wosac_tar = runner.test_submission(cfg, model, loader, out_dir=str(tmp_path), n_joint_future=40,
                                                 device="cpu")
    assert womd_tar.endswith(".tar.gz") and wosac_tar.endswith(".tar.gz")
    womd = mpb.MotionChallengeSubmission.FromString(next(tmp_path.glob("*_WOMD/*_WOMD.bin")).read_bytes())
    sids = [p.scenario_id for p in womd.scenario_predictions]
    assert sids == ["synthetic_5_0", "synthetic_5_1", "synthetic_9_0"]
    pred = womd.scenario_predictions[0].single_predictions.predictions[0]
    assert len(pred.trajectories) == 6 and len(pred.trajectories[0].trajectory.center_x) == 2  # 10 steps at 2 Hz
    shard = spb.SimAgentsChallengeSubmission.FromString((tmp_path / "WOSAC" / "submission.binproto-00000").read_bytes())
    assert [r.scenario_id for r in shard.scenario_rollouts] == sids
    for i, r in enumerate(shard.scenario_rollouts):
        b = loader[i // 2]
        n_sim = int(b["history/agent/valid"][i % 2, :, cfg.time_step_current].sum())
        n_ns = int(b["history/agent_no_sim/valid"][i % 2, :, cfg.time_step_current].sum())
        assert len(r.joint_scenes) == 32
        traj = r.joint_scenes[31].simulated_trajectories
        assert len(traj) == n_sim + n_ns and len(traj[0].center_x) == cfg.time_step_gt - cfg.time_step_current
        assert np.isfinite(np.asarray(traj[0].center_x)).all() and np.isfinite(np.asarray(traj[0].heading)).all()


def test_test_submission_returns_arrays_without_the_package(monkeypatch):
    """Without waymo_open_dataset the runner returns the arrays: WOMD modes and the 32 futures in the global
    frame, which are the filtered futures of the same draws moved by the scenario's center and yaw."""
    def no_package(*a, **kw):
        raise ImportError("waymo_open_dataset")

    monkeypatch.setattr(psub, "SubWOMD", no_package)
    cfg = tiny_config()
    model = build_model(cfg, seed=0, device="cpu")
    batch = make_batch(cfg.data, n_sc=2, seed=5, test_mode=True)
    (out,) = runner.test_submission(cfg, model, [batch], n_joint_future=40, device="cpu")
    assert out["womd_trajs"].shape == (2, cfg.data.n_ag, 6, 2, 3) and out["womd_scores"].shape == (2, cfg.data.n_ag, 6)
    assert out["wosac_trajs"].shape == (2, 32, cfg.data.n_ag, cfg.time_step_gt - cfg.time_step_current, 3)
    pp, buf = runner.evaluation.joint_future_pred(cfg, model, batch, generator=torch.Generator().manual_seed(cfg.seed),
                                                  n_joint_future=40, device="cpu")
    want = pws.to_global_frame(pws.filter_futures(cfg.wosac_post, buf, pp.ag_role, cfg.time_step_current),
                               torch.from_numpy(batch["scenario_center"]), torch.from_numpy(batch["scenario_yaw"]))
    np.testing.assert_array_equal(out["wosac_trajs"], want.numpy())
    np.testing.assert_allclose(out["womd_scores"].sum(-1), 1.0, rtol=1e-5)
