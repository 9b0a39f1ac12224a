"""PyTorch port: the simulator, preprocessing and post-processing against the reference-torch goldens.

`tests/golden/sim/*.npz` hold the inputs and outputs of the original
PyTorch code (`scripts/gen_sim_golden.py`); `tests/test_sim_parity.py` holds
the JAX package to the same files, and each case here uses that test's
tolerance for the same golden:
  - pose embeddings 1e-5;
  - diffbar rewards 1e-5 (forward values), validity equal;
  - dynamics over 16 scripted steps (player overrides, teacher forcing, TL
    override, sticky disable, navi bookkeeping): actions 1e-5 / 1e-6, log
    probs 1e-5, poses and motions 1e-5 / 2e-5, flags equal; the integrator
    variant 1e-6 / 1e-5 / 1e-4;
  - teacher-forcing masks and per-step overrides equal;
  - L2 preprocessing 1e-6, ints and flags equal. Invalid lane-TL rows of
    `sc/tl_pose` are left out: the reference reads the last polyline there,
    the port clips the index (a known reference quirk; every consumer masks
    them on `sc/tl_valid`);
  - WOMD post-processing 1e-4 on trajectories, 1e-4 / 1e-5 on scores (topk
    compared after ordering both sides by score);
  - WOSAC post-processing 1e-4 / 1e-3 on positions, 1e-5 on yaws, after a
    canonical sort of the selected futures.
`rule_checker`, `wosac_collision` (`tests/test_torch_rules.py`) and
`logging_metrics` (`tests/test_torch_eval.py`) are held where their modules'
other tests are.

Each case is `run_<case>(device, use_pallas, dense_knn_max)` returning
`Check`s, as in `tests/test_torch_golden_model.py` (whose `load_golden` this
file uses); the simulator has no attention, so the last two arguments go
unused. This file imports no JAX.
"""

from __future__ import annotations

import types
from typing import List

import numpy as np
import pytest
import torch

from test_torch_golden_model import TORCH_THREADS, Check, assert_checks, load_golden, to_np
from trafficbotsv15_tpu_torch import config as pc


def _sim(name, device):
    _, ins, outs, meta = load_golden("sim", name)
    return {k: torch.from_numpy(np.asarray(v)).to(device) for k, v in ins.items()}, ins, outs, meta


def _check(name, got, want, atol=0.0, rtol=0.0) -> Check:
    got = to_np(got)
    if want.dtype == bool or want.dtype.kind in "iu":
        got = got.astype(want.dtype)
    return Check(name, got, want, atol, rtol)


# ----------------------------------------------------------------- pose embeddings


def _pose_emb(mode, device):
    from trafficbotsv15_tpu_torch.ops.pose_emb import PoseEmbConfig, apply_pose_emb

    a, _, outs, meta = _sim(f"pose_emb_{mode}", device)
    cfg = PoseEmbConfig(mode=mode, pe_dim=meta["pe_dim"], theta_xy=1e3, theta_cs=1e1)
    return [_check("out_yaw", apply_pose_emb(cfg, a["xy"], a["yaw"]), outs["out_yaw"], 1e-5, 1e-5),
            _check("out_dir", apply_pose_emb(cfg, a["xy"], a["dvec"]), outs["out_dir"], 1e-5, 1e-5)]


def run_pose_emb_mpa_pl(device="cpu", use_pallas=False, dense_knn_max=128) -> List[Check]:
    return _pose_emb("mpa_pl", device)


def run_pose_emb_pe_xy_yaw(device="cpu", use_pallas=False, dense_knn_max=128) -> List[Check]:
    return _pose_emb("pe_xy_yaw", device)


def run_pose_emb_xy_dir(device="cpu", use_pallas=False, dense_knn_max=128) -> List[Check]:
    return _pose_emb("xy_dir", device)


def run_pose_emb_pe_xy_dir(device="cpu", use_pallas=False, dense_knn_max=128) -> List[Check]:
    return _pose_emb("pe_xy_dir", device)


# ----------------------------------------------------------------- rewards


def _diffbar_reward(case, w_collision, reduce_max, device):
    from trafficbotsv15_tpu_torch.sim.rewards import diffbar_reward

    a, _, outs, _ = _sim(f"diffbar_reward_{case}", device)
    cfg = pc.RewardCfg(w_collision=w_collision, reduce_collision_with_max=reduce_max, use_il_loss=True,
                       w_pos=1e-1, w_rot=1e1, w_spd=1e-1, angular_type="cosine")
    got = diffbar_reward(cfg, a["pred_valid"], a["pred_pose"], a["pred_motion"], a["gt_valid"], a["gt_pose"],
                         a["gt_motion"], a["size"])
    keys = ("diffbar_reward", "r_imitation_pos", "r_imitation_rot", "r_imitation_spd", "r_traffic_rule_approx")
    return ([_check(k, got[k], outs[k], 1e-5, 1e-5) for k in keys]
            + [_check("diffbar_reward_valid", got["diffbar_reward_valid"], outs["diffbar_reward_valid"])])


def run_diffbar_reward_il(device="cpu", use_pallas=False, dense_knn_max=128) -> List[Check]:
    return _diffbar_reward("il", 0.0, True, device)


def run_diffbar_reward_coll_max(device="cpu", use_pallas=False, dense_knn_max=128) -> List[Check]:
    return _diffbar_reward("coll_max", 1.0, True, device)


def run_diffbar_reward_coll_mean(device="cpu", use_pallas=False, dense_knn_max=128) -> List[Check]:
    return _diffbar_reward("coll_mean", 1.0, False, device)


# ----------------------------------------------------------------- dynamics


def _dynamics(case, device):
    """The reference's stateful Dynamics over its scripted steps, every public state compared per step."""
    from trafficbotsv15_tpu_torch.ops.distributions import DiagGaussian
    from trafficbotsv15_tpu_torch.sim import dynamics as dyn

    a, ins, outs, meta = _sim(case, device)
    cfg = pc.DynamicsCfg(use_veh_dynamics_for_all=bool(meta["veh_all"]))
    valid = a["gt_valid"][:, :, 0]
    disabled = torch.zeros_like(valid)
    pose, motion = a["gt_pose"][:, :, 0], a["gt_motion"][:, :, 0]
    navi, navi_valid = a["ag_navi0"], torch.ones_like(valid)
    steps = {k: [] for k in outs}
    for t in range(ins["locs"].shape[0]):
        loc, scale = a["locs"][t], a["scales"][t]
        log_prob = torch.where(valid, DiagGaussian(loc, scale).log_prob(loc), 0.0)
        po = {"valid": a["po_valid"][t], "action": a["po_action"][t]} if ins["po_valid"][t].any() else None
        new_pose, new_motion, action = dyn.step_dynamics(pose, motion, valid, loc, a["ag_type"], cfg, po)
        valid, pose, motion = dyn.override_ag(valid, new_pose, new_motion, disabled, a["tf_valid"][t],
                                              a["tf_pose"][t], a["tf_motion"][t])
        tl_state = dyn.override_tl(torch.log(a["tl_probs"][t]), a["tl_ov_valid"][t], a["tl_ov_state"][t])
        valid, disabled = dyn.disable_outside_map(valid, disabled, a["outside"][t], a["dis_gt_valid"][t])
        reached = a["reached"][t]
        navi, navi_valid = dyn.update_navi_on_reached(navi, navi_valid, reached,
                                                      a["new_navi"][t] if ins["reached"][t].any() else None)
        got = dict(action=action, action_log_prob=log_prob, ag_valid=valid, ag_disabled=disabled, ag_pose=pose,
                   ag_motion=motion, tl_state=tl_state, mask_navi_reached=reached, ag_navi_valid=navi_valid,
                   ag_navi=navi)
        for k in steps:
            steps[k].append(to_np(got[k]))
    tol = dict(action=(1e-6, 1e-5), action_log_prob=(1e-5, 1e-5), ag_pose=(2e-5, 1e-5), ag_motion=(2e-5, 1e-5))
    if meta["navi_mode"] != "dest":
        tol["ag_navi"] = (1e-6, 1e-6)
    return [_check(k, np.stack(v), outs[k], *tol.get(k, (0.0, 0.0))) for k, v in steps.items()]


def run_dynamics_dest(device="cpu", use_pallas=False, dense_knn_max=128) -> List[Check]:
    return _dynamics("dynamics_dest", device)


def run_dynamics_vehall(device="cpu", use_pallas=False, dense_knn_max=128) -> List[Check]:
    return _dynamics("dynamics_vehall", device)


def run_dynamics_goal(device="cpu", use_pallas=False, dense_knn_max=128) -> List[Check]:
    return _dynamics("dynamics_goal", device)


def run_dynamics_integrator(device="cpu", use_pallas=False, dense_knn_max=128) -> List[Check]:
    from trafficbotsv15_tpu_torch.sim.dynamics import process_action_integrator, update_integrator

    a, _, outs, meta = _sim("dynamics_integrator", device)
    act = process_action_integrator(a["action_unbounded"], max_v=meta["max_v"])
    pose, motion = update_integrator(a["pose"], a["motion"], act, meta["dt"])
    return [_check("action", act, outs["action"], 1e-6, 1e-6),
            _check("pred_pose", pose, outs["pred_pose"], 1e-5, 1e-5),
            _check("pred_motion", motion, outs["pred_motion"], 1e-4, 1e-4)]


# ----------------------------------------------------------------- teacher forcing


def _teacher_forcing(case, device):
    """Forcing masks and per-step overrides on the deterministic subspace (probabilities 0 or 1)."""
    from trafficbotsv15_tpu_torch.sim.teacher_forcing import build_forcing_masks, error_reset_mask

    a, ins, outs, meta = _sim(f"teacher_forcing_{case}", device)
    meta = dict(meta)
    epoch = meta.pop("epoch")
    cfg = pc.TeacherForcingCfg(prob_forcing_agent_decrease_per_epoch=0.0, prob_scheduled_sampling=0.0, **meta)
    ag_valid = a["ag_valid"]
    n_sc, n_ag, n_step = ag_valid.shape
    # a probability of 1 forces whatever the draw (draws lie in [0, 1))
    u_agent = torch.zeros((n_sc, n_ag), device=device) if cfg.prob_forcing_agent > 0 else None
    tl_valid_step = torch.ones(ins["tl_state"].shape[:3], dtype=torch.bool, device=device)
    forcing, tl_forcing = build_forcing_masks(cfg, ag_valid, tl_valid_step, epoch, u_agent=u_agent)
    ov_steps, tl_steps = [], []
    for step in range(n_step + 1):
        s = max(step - 1, 0)
        if 0 < step < n_step:
            ov = forcing[:, :, step] | error_reset_mask(
                cfg, a["pred_valid"][:, :, s], a["ag_pose"][:, :, s] + a["drift_pose"],
                a["ag_motion"][:, :, s] + a["drift_motion"], ag_valid[:, :, s], a["ag_pose"][:, :, s],
                a["ag_motion"][:, :, s])
            tl_ov = tl_forcing[:, :, step]
        else:
            ov, tl_ov = torch.zeros_like(forcing[:, :, 0]), torch.zeros_like(tl_forcing[:, :, 0])
        ov_steps.append(to_np(ov))
        tl_steps.append(to_np(tl_ov))
    return [_check("forcing_mask", forcing, ins["forcing_mask"]),
            _check("ag_override_valid", np.stack(ov_steps), outs["ag_override_valid"]),
            _check("tl_override_valid", np.stack(tl_steps), outs["tl_override_valid"])]


def run_teacher_forcing_flagship(device="cpu", use_pallas=False, dense_knn_max=128) -> List[Check]:
    return _teacher_forcing("flagship", device)


def run_teacher_forcing_reset(device="cpu", use_pallas=False, dense_knn_max=128) -> List[Check]:
    return _teacher_forcing("reset", device)


def run_teacher_forcing_gtsdc_prob1(device="cpu", use_pallas=False, dense_knn_max=128) -> List[Check]:
    return _teacher_forcing("gtsdc_prob1", device)


# ----------------------------------------------------------------- L2 preprocessing

PREPROC_FIELDS = {
    "sc__mp_valid": "mp_valid", "sc__mp_attr": "mp_attr", "sc__mp_pose": "mp_pose",
    "sc__tl_valid": "tl_valid", "sc__tl_attr": "tl_attr", "sc__tl_state": "tl_state",
    "sc__tl_pose": "tl_pose", "sc__ag_valid": "ag_valid", "sc__ag_attr": "ag_attr",
    "sc__ag_motion": "ag_motion", "sc__ag_pose": "ag_pose",
    "gt__ag_valid": "gt_valid", "gt__ag_motion": "gt_motion",
    "gt__ag_pose": "gt_pose", "gt__ag_navi": "gt_navi",
    "gt__tl_valid": "gt_tl_valid", "gt__tl_state": "gt_tl_state",
    "ref__ag_type": "ag_type", "ref__ag_role": "ag_role",
    "ref__ag_size": "ag_size", "ref__mp_type": "mp_type",
}


def _preprocessing(case, device):
    from trafficbotsv15_tpu_torch.data.preprocessing import pre_processing

    a, _, outs, meta = _sim(f"preproc_{case}", device)
    batch = {k.replace("__", "/"): v for k, v in a.items()}
    pp = pre_processing(batch, tl_mode=meta["tl_mode"], navi_mode=meta["navi_mode"], n_step_hist=11,
                        training=meta["training"])
    checks = []
    for gk, field in PREPROC_FIELDS.items():
        if gk not in outs:
            continue
        got, want = to_np(getattr(pp, field)), outs[gk]
        if gk == "sc__tl_pose" and meta["tl_mode"] == "lane":
            valid = outs["sc__tl_valid"][..., None]  # invalid rows: the reference quirk above
            got, want = np.where(valid, got, 0.0), np.where(valid, want, 0.0)
        exact = want.dtype == bool or want.dtype.kind in "iu"
        checks.append(_check(gk, got, want, *((0.0, 0.0) if exact else (1e-6, 1e-6))))
    assert len(checks) >= (11 if case.startswith("test") else 17), len(checks)
    return checks


def run_preproc_train_lane_dest(device="cpu", use_pallas=False, dense_knn_max=128) -> List[Check]:
    return _preprocessing("train_lane_dest", device)


def run_preproc_train_stop_cmd(device="cpu", use_pallas=False, dense_knn_max=128) -> List[Check]:
    return _preprocessing("train_stop_cmd", device)


def run_preproc_test_lane_goal(device="cpu", use_pallas=False, dense_knn_max=128) -> List[Check]:
    return _preprocessing("test_lane_goal", device)


# ----------------------------------------------------------------- post-processing


def _womd_post(case, device):
    from trafficbotsv15_tpu_torch.eval.womd_post_processing import womd_post_process

    a, _, outs, meta = _sim(f"womd_post_{case}", device)
    cfg = pc.WOMDPostCfg(k_pred=6, use_ade=True, n_iter_em=3, score_temperature=meta["score_temperature"],
                         mpa_nms_thresh=tuple(meta["mpa_nms_thresh"]), mtr_nms_thresh=tuple(meta["mtr_nms_thresh"]),
                         aggr_thresh=tuple(meta["aggr_thresh"]))
    # the golden holds [n_sc, n_ag, K, ...]; the entry point takes [n_sc, K, n_ag, ...]
    got = womd_post_process(cfg, a["ag_type"], a["trajs"].transpose(1, 2), a["scores"].transpose(1, 2),
                            track_future_samples=80)
    got_t, got_s, want_t, want_s = to_np(got["trajs"]), to_np(got["scores"]), outs["trajs"], outs["scores"]
    if case == "topk":
        # the reference's topk leaves the mode order unspecified: order both sides by descending score
        def order(t, s):
            idx = np.argsort(-s, axis=-1, kind="stable")
            return np.take_along_axis(t, idx[..., None, None], axis=2), np.take_along_axis(s, idx, axis=2)

        (got_t, got_s), (want_t, want_s) = order(got_t, got_s), order(want_t, want_s)
    return [_check("trajs", got_t, want_t, 1e-4, 1e-4), _check("scores", got_s, want_s, 1e-5, 1e-4)]


def run_womd_post_topk(device="cpu", use_pallas=False, dense_knn_max=128) -> List[Check]:
    return _womd_post("topk", device)


def run_womd_post_mtr(device="cpu", use_pallas=False, dense_knn_max=128) -> List[Check]:
    return _womd_post("mtr", device)


def run_womd_post_aggr(device="cpu", use_pallas=False, dense_knn_max=128) -> List[Check]:
    return _womd_post("aggr", device)


def run_wosac_post(device="cpu", use_pallas=False, dense_knn_max=128) -> List[Check]:
    """Best-32 selection and the global frame; the selected set is unique, its order is not: compare
    after a sort on each future's first coordinate."""
    from trafficbotsv15_tpu_torch.eval.wosac_post_processing import filter_futures, to_global_frame

    a, _, outs, meta = _sim("wosac_post", device)
    cfg = pc.WOSACPostCfg(w_road_edge=meta["w_road_edge"], use_wosac_col=meta["use_wosac_col"])
    buffer = types.SimpleNamespace(pred_pose=a["pred_pose"],
                                   violation={k[5:]: v for k, v in a.items() if k.startswith("viol_")})
    glob = to_np(to_global_frame(filter_futures(cfg, buffer, a["role"], meta["step_future_start"]),
                                 a["scenario_center"], a["scenario_yaw"]))

    def order(pos, aux):
        idx = np.argsort(pos[:, :, 0, 0, 0], axis=1, kind="stable")[:, :, None, None, None]
        return np.take_along_axis(pos, idx, axis=1), np.take_along_axis(aux, idx, axis=1)

    got_pos, got_yaw = order(glob[..., :2], glob[..., 2:3])
    want_pos, want_yaw = order(outs["pos_sim"], outs["yaw_sim"])
    no_sim = torch.cat([a["history__agent_no_sim__pos"][..., :2], a["history__agent_no_sim__yaw_bbox"]], -1)
    glob_ns = to_np(to_global_frame(no_sim, a["scenario_center"], a["scenario_yaw"]))
    return [_check("pos_sim", got_pos, want_pos, 1e-3, 1e-4), _check("yaw_sim", got_yaw, want_yaw, 1e-5, 1e-5),
            _check("pos_no_sim", glob_ns[..., :2], outs["pos_no_sim"], 1e-3, 1e-4),
            _check("yaw_no_sim", glob_ns[..., 2:3], outs["yaw_no_sim"], 1e-5, 1e-5)]


SIM_CASES = ["pose_emb_mpa_pl", "pose_emb_pe_xy_yaw", "diffbar_reward_il", "diffbar_reward_coll_mean",
             "diffbar_reward_coll_max", "dynamics_dest", "dynamics_vehall", "dynamics_goal", "dynamics_integrator",
             "teacher_forcing_flagship", "teacher_forcing_reset", "teacher_forcing_gtsdc_prob1",
             "preproc_train_lane_dest", "preproc_test_lane_goal", "womd_post_topk", "womd_post_mtr",
             "womd_post_aggr", "wosac_post", "pose_emb_xy_dir", "pose_emb_pe_xy_dir", "preproc_train_stop_cmd"]


def run_case(case: str, device="cpu", use_pallas=False, dense_knn_max=128) -> List[Check]:
    return globals()[f"run_{case}"](device=device, use_pallas=use_pallas, dense_knn_max=dense_knn_max)


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(TORCH_THREADS)


@pytest.mark.parametrize("case", SIM_CASES)
def test_sim_golden(case):
    assert_checks(run_case(case))


def test_dynamics_goldens_reach_the_player_override_and_the_new_navi():
    """The scripted steps exercise both optional inputs, so the match above is not vacuous."""
    for case in ("dynamics_dest", "dynamics_goal"):
        _, ins, _, _ = load_golden("sim", case)
        assert ins["po_valid"].any() and ins["reached"].any(), case
