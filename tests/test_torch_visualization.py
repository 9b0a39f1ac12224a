"""The port's visualization (`trafficbotsv15_tpu_torch/utils/visualization.py`) and validation videos
(`eval/runner.py::validation_video_inputs`, `save_validation_videos`) against the JAX package's.

Frames are compared pixel for pixel on the same numpy inputs: the map raster, a step, the TL overlay, the
agent-centric warp, the text sidebar, the destination heatmap, and every frame `save_prediction_videos` and
`save_rollout_video` hand to their writer, with the same file names. The videos' inputs are compared with the
dicts JAX's `save_validation_videos` hands its renderers (caught by patching the JAX module) from one buffer's
values, so that no JAX rollout is compiled. Without cv2, `run.main` with `video_dir` raises before it builds a
model or reads a batch.
"""

import dataclasses
import os
import sys
import types

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from trafficbotsv15_tpu import config as jax_config
from trafficbotsv15_tpu.data.synthetic import make_batch
from trafficbotsv15_tpu.eval import runner as jax_runner
from trafficbotsv15_tpu.utils import visualization as jax_vis
from trafficbotsv15_tpu_torch import config as port_config
from trafficbotsv15_tpu_torch import run as run_lib
from trafficbotsv15_tpu_torch.eval import runner
from trafficbotsv15_tpu_torch.sim.rollout import RolloutBuffer
from trafficbotsv15_tpu_torch.utils import visualization as vis

VIOLATIONS = ("outside_map", "collided", "collided_wosac", "run_road_edge", "run_red_light", "passive", "goal_reached",
              "dest_reached")
STEP_CURRENT = 4


@pytest.fixture(scope="module")
def ep():
    batch = make_batch(jax_config.DataCfg(n_ag=8, n_mp=16, n_step=15, n_tl_lane=8, n_tl_stop=8), n_sc=1, seed=2)
    return {k: np.asarray(v)[0] for k, v in batch.items()
            if not isinstance(v, list) and k.startswith(("map/", "agent/", "tl_lane/", "tl_stop/"))}


def _map(ep):
    return ep["map/valid"], ep["map/type"], ep["map/pos"], ep["map/boundary"]


def _prediction(ep):
    """A prediction dict with every optional key the sidebar reads."""
    n_ag, n_step = ep["agent/valid"].shape
    n_fut = n_step - STEP_CURRENT - 1
    rng = np.random.default_rng(0)
    pred = {"step_current": STEP_CURRENT, "step_gt": n_step - 1, "step_end": n_step - 1,
            "agent/valid": ep["agent/valid"][:, STEP_CURRENT + 1:],
            "agent/pos": ep["agent/pos"][:, STEP_CURRENT + 1:, :2] + 0.5,
            "agent/yaw_bbox": ep["agent/yaw_bbox"][:, STEP_CURRENT + 1:],
            "tl_lane/state": ep["tl_lane/state"][:, STEP_CURRENT + 1:],
            "tl_stop/state": ep["tl_stop/state"][:, STEP_CURRENT + 1:],
            "ag_navi_valid": np.ones((n_ag, n_fut), bool),
            "action": rng.normal(size=(n_ag, n_fut, 2)).astype(np.float32),
            "act_P": rng.normal(size=(n_ag, n_fut)).astype(np.float32),
            "score": rng.normal(size=(n_ag,)).astype(np.float32),
            "diffbar_reward": rng.normal(size=(n_ag, n_fut)).astype(np.float32)}
    for key in VIOLATIONS:
        pred[f"{key}_this_step"] = rng.random((n_ag, n_fut)) < 0.1
        pred[key] = pred[f"{key}_this_step"].cumsum(-1) > 0
    return pred


def test_map_step_tl_and_agent_view_frames_equal_jax(ep):
    port, jax = vis.SceneRenderer(*_map(ep)), jax_vis.SceneRenderer(*_map(ep))
    np.testing.assert_array_equal(port.base, jax.base)
    assert port.base.sum() > 0
    pose = np.concatenate([ep["agent/pos"][:, 5, :2], ep["agent/yaw_bbox"][:, 5]], -1)
    violation = np.arange(pose.shape[0]) % 3 == 0
    tl = dict(tl_lane_valid=ep["tl_lane/valid"][:, 0], tl_lane_state=ep["tl_lane/state"][:, 0],
              tl_lane_idx=ep["tl_lane/idx"], tl_stop_valid=ep["tl_stop/valid"][:, 0],
              tl_stop_state=ep["tl_stop/state"][:, 0], tl_stop_pos=ep["tl_stop/pos"], tl_stop_dir=ep["tl_stop/dir"])
    step = dict(ag_role=ep["agent/role"], violation=violation, gt_pose=pose + 0.7, gt_valid=ep["agent/valid"][:, 6],
                tl_kwargs=tl)
    frames = [r.draw_step(pose, ep["agent/valid"][:, 5], ep["agent/size"], **step) for r in (port, jax)]
    np.testing.assert_array_equal(*frames)
    lit = [r.draw_tl(r.base.copy(), **tl) for r in (port, jax)]
    np.testing.assert_array_equal(*lit)
    views = [r.agent_view(f, pose[0, :2], float(pose[0, 2])) for r, f in zip((port, jax), frames)]
    np.testing.assert_array_equal(*views)
    assert views[0].shape == (480, 480, 3)


def test_sidebar_and_dest_prob_image_equal_jax(ep):
    img = np.random.default_rng(3).integers(0, 255, (64, 80, 3), dtype=np.uint8)
    lines = vis._txt_lines(_prediction(ep), 1, 2)
    assert lines == jax_vis._txt_lines(_prediction(ep), 1, 2)
    np.testing.assert_array_equal(vis._sidebar(img, lines), jax_vis._sidebar(img, lines))
    probs = np.random.default_rng(1).random(ep["map/valid"].shape[0])
    probs /= probs.sum()
    kw = dict(agent_pose=np.concatenate([ep["agent/pos"][0, 0, :2], ep["agent/yaw_bbox"][0, 0]]),
              agent_size=ep["agent/size"][0], gt_dest=int(ep["agent/dest"][0]))
    got, want = vis.dest_prob_image(*_map(ep), probs, **kw), jax_vis.dest_prob_image(*_map(ep), probs, **kw)
    np.testing.assert_array_equal(got, want)
    assert got.sum() > 0


def _captured_videos(monkeypatch, module, run):
    """{file name: frames} that module's renderers hand to its writer during run()."""
    videos = {}

    def write(path, frames, fps):
        videos[os.path.basename(path)] = np.stack(frames)
        return str(path)

    monkeypatch.setattr(module, "_write_video", write)
    run()
    monkeypatch.undo()
    return videos


def test_prediction_and_rollout_videos_equal_jax(ep, monkeypatch, tmp_path):
    pred = _prediction(ep)
    pose = np.concatenate([ep["agent/pos"][:, :, :2], ep["agent/yaw_bbox"]], -1)
    roll = dict(pred_pose=pose, pred_valid=ep["agent/valid"], ag_size=ep["agent/size"], ag_role=ep["agent/role"],
                violation=pred["collided"].any(-1, keepdims=True).repeat(pose.shape[1], 1))
    got, want = [_captured_videos(monkeypatch, module, lambda m=module: (
        m.save_prediction_videos(str(tmp_path / "ep0"), ep, pred), m.save_rollout_video(
            str(tmp_path / "roll.mp4"), *_map(ep), **roll))) for module in (vis, jax_vis)]
    assert sorted(got) == sorted(want)
    assert {"ep0-gt.mp4", "ep0-pd.mp4", "ep0-mix.mp4", "ep0-sdc.mp4", "roll.mp4"} <= set(got)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    # the port's own writer: an mp4, or the PNG fallback's directory where no codec opens
    path = vis._write_video(str(tmp_path / "port.mp4"), list(got["ep0-sdc.mp4"][:3]), 10)
    assert os.path.exists(path) and (os.path.isdir(path) or os.path.getsize(path) > 0)
    images = vis.get_dest_prob_images(str(tmp_path / "dest"), ep, np.full((8, ep["map/valid"].shape[0]), 1 / 16))
    assert images and all(os.path.getsize(p) > 0 for p in images)


@pytest.mark.parametrize("tl_mode", ["lane", "stop"])
def test_validation_video_inputs_equal_the_jax_renderers_inputs(ep, monkeypatch, tmp_path, tl_mode):
    """One buffer's values through JAX's save_validation_videos (its renderers patched to record their arguments)
    and the port's validation_video_inputs and save_validation_videos."""
    n_sc, n_ag, n_step, n_tl = 2, 8, 14, 8
    rng = np.random.default_rng(5)
    vals = {"pred_valid": rng.random((n_sc, 1, n_ag, n_step)) < 0.9,
            "pred_pose": rng.normal(size=(n_sc, 1, n_ag, n_step, 3)).astype(np.float32),
            "pred_action": rng.normal(size=(n_sc, 1, n_ag, n_step, 2)).astype(np.float32),
            "action_log_prob": rng.normal(size=(n_sc, 1, n_ag, n_step)).astype(np.float32),
            "tl_state": rng.random((n_sc, 1, n_tl, n_step, 5)).astype(np.float32),
            "log_prob": rng.normal(size=(n_sc, 1, n_ag)).astype(np.float32)}
    violation = {}
    for key in VIOLATIONS:
        violation[f"{key}_this_step"] = rng.random((n_sc, 1, n_ag, n_step)) < 0.1
        violation[key] = np.cumsum(violation[f"{key}_this_step"], -1) > 0
    reward = {k: rng.normal(size=(n_sc, 1, n_ag, n_step)).astype(np.float32)
              for k in ("diffbar_reward", "r_imitation_pos", "diffbar_reward_valid")}
    batch = {k: np.stack([v, v]) for k, v in ep.items()}

    jcfg = jax_config.tiny_config(n_step=15)
    jcfg = dataclasses.replace(jcfg, model=dataclasses.replace(jcfg.model, tl_mode=tl_mode))
    pcfg = port_config.tiny_config(n_step=15)
    pcfg = dataclasses.replace(pcfg, model=dataclasses.replace(pcfg.model, tl_mode=tl_mode))
    assert (jcfg.time_step_current, jcfg.time_step_gt, jcfg.time_step_end) == (
        pcfg.time_step_current, pcfg.time_step_gt, pcfg.time_step_end)

    calls = {"pred": [], "roll": []}
    monkeypatch.setattr(jax_vis, "save_prediction_videos",
                        lambda name, episode, prediction: calls["pred"].append((name, episode, prediction)) or [])
    monkeypatch.setattr(jax_vis, "save_rollout_video",
                        lambda path, *a, **kw: calls["roll"].append((path, a, kw)) or path)
    jax_buf = types.SimpleNamespace(**vals, violation=violation, diffbar_reward=reward)
    jax_runner.save_validation_videos(jcfg, batch, jax_buf, out_dir=str(tmp_path / "jax"), n_vis=2)
    monkeypatch.undo()
    assert len(calls["pred"]) == len(calls["roll"]) == 2

    t = {k: torch.from_numpy(v) for k, v in vals.items()}
    zeros = torch.zeros(n_sc, 1, n_ag, n_step)
    buf = RolloutBuffer(**t, pred_motion=zeros, tl_state_nll=zeros, tl_state_nll_invalid=zeros,
                        mask_teacher_forcing=zeros.bool(), navi_log_prob=zeros[..., :1],
                        navi_log_prob_valid=zeros[..., :1].bool(),
                        violation={k: torch.from_numpy(v) for k, v in violation.items()},
                        diffbar_reward={k: torch.from_numpy(v) for k, v in reward.items()})
    for i, (_, episode_want, pred_want) in enumerate(calls["pred"]):
        episode, prediction = runner.validation_video_inputs(pcfg, batch, buf, i)
        assert sorted(episode) == sorted(episode_want) and sorted(prediction) == sorted(pred_want)
        for got, want in ((episode, episode_want), (prediction, pred_want)):
            for k, w in want.items():
                g = got[k]
                assert np.shape(g) == np.shape(w), k
                np.testing.assert_array_equal(np.asarray(g), np.asarray(w), err_msg=k)
        assert "diffbar_reward" in prediction and ("tl_lane/state" if tl_mode == "lane" else "tl_stop/state") in prediction

    # the port's overview video gets what JAX's got; every file is written
    roll = []
    monkeypatch.setattr(vis, "save_rollout_video", lambda path, *a, **kw: roll.append((path, a, kw)) or path)
    monkeypatch.setattr(vis, "save_prediction_videos", lambda *a, **kw: [])
    runner.save_validation_videos(pcfg, batch, buf, out_dir=str(tmp_path / "port"), n_vis=2)
    monkeypatch.undo()
    for (path, a, kw), (jpath, ja, jkw) in zip(roll, calls["roll"]):
        assert os.path.basename(path) == os.path.basename(jpath) and sorted(kw) == sorted(jkw)
        for g, w in zip(a, ja):
            np.testing.assert_array_equal(g, w)
        for k in jkw:
            np.testing.assert_array_equal(np.asarray(kw[k]), np.asarray(jkw[k]), err_msg=k)
    paths = runner.save_validation_videos(pcfg, batch, buf, out_dir=str(tmp_path / "port"), n_vis=1)
    assert "scenario_0.mp4" in {os.path.basename(p) for p in paths}
    assert all(os.path.exists(p) for p in paths)


def test_video_dir_without_cv2_raises_before_a_model_or_a_batch(monkeypatch, tmp_path):
    monkeypatch.setitem(sys.modules, "cv2", None)  # the import raises

    def must_not_run(*a, **kw):
        raise AssertionError("reached past the cv2 check")

    for name in ("make_dataloaders", "build_kernels", "restore_model", "preset_config"):
        monkeypatch.setattr(run_lib, name, must_not_run)
    with pytest.raises(ImportError, match=r"cv2.*|video_dir") as err:
        run_lib.main(["action=validate", "device=cpu", "preset=tiny", f"ckpt_dir={tmp_path}",
                      f"video_dir={tmp_path / 'videos'}"])
    assert "cv2" in str(err.value) and f"video_dir={tmp_path / 'videos'}" in str(err.value)
    with pytest.raises(ImportError, match="cv2"):
        vis.SceneRenderer(np.ones((1, 2), bool), np.ones((1, 11), bool), np.zeros((1, 2, 3)), np.zeros(4))
    with pytest.raises(ValueError, match="video_dir belongs to action=validate"):
        run_lib.main(["action=fit", "device=cpu", f"video_dir={tmp_path}"])
