"""WOSAC post-processing (counterpart of `trafficbotsv15_tpu/eval/wosac_post_processing.py`): keep the
32 futures with the fewest violations, move them to the global frame, and assemble ScenarioRollouts
protos.

Filtering and the frame change run on the tensors' device; the proto
assembly runs on the host in numpy and imports `waymo_open_dataset` only
when called (ImportError without it), as in the JAX package.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from trafficbotsv15_tpu_torch.config import WOSACPostCfg
from trafficbotsv15_tpu_torch.ops.transform import pos2global, rad2global, rad2rot

N_JOINT_FUTURE_WOSAC = 32  # fixed by the challenge
WOSAC_HIST_KEYS = (
    "history/agent/valid", "history/agent/pos", "history/agent/yaw_bbox", "history/agent/object_id",
    "history/agent_no_sim/valid", "history/agent_no_sim/pos", "history/agent_no_sim/yaw_bbox",
    "history/agent_no_sim/object_id",
)


def filter_futures(cfg: WOSACPostCfg, buffer, ag_role: torch.Tensor, step_future_start: int) -> torch.Tensor:
    """The 32 futures with the fewest violations of relevant agents, ties to the lower index (as
    `jax.lax.top_k`). buffer flattened [n_sc, K, n_ag, n_step, ...] -> trajs [n_sc, 32, n_ag, n_future, 3]."""
    trajs = buffer.pred_pose[:, :, :, step_future_start:]
    if trajs.shape[1] <= N_JOINT_FUTURE_WOSAC:
        return trajs
    role = ag_role.any(-1).float()[:, None]  # [n_sc, 1, n_ag]
    key = "collided_wosac" if cfg.use_wosac_col else "collided"
    collided = buffer.violation[key][..., step_future_start:].any(-1)
    road_edge = buffer.violation["run_road_edge"][..., step_future_start:].any(-1)
    violation = (collided * role).sum(-1) + cfg.w_road_edge * (road_edge * role).sum(-1)
    idx = torch.sort(violation, dim=-1, stable=True).indices[:, :N_JOINT_FUTURE_WOSAC]
    return torch.gather(trajs, 1, idx[:, :, None, None, None].expand(-1, -1, *trajs.shape[2:]))


def to_global_frame(trajs: torch.Tensor, scenario_center: torch.Tensor, scenario_yaw: torch.Tensor) -> torch.Tensor:
    """Scene-centric trajs [n_sc, K, n_ag, n_step, 3] -> the global WOMD frame; center [n_sc, 2], yaw [n_sc]."""
    n_sc = trajs.shape[0]
    pos = trajs[..., :2].reshape(n_sc, -1, 2)
    pos = pos2global(pos, scenario_center[:, None, :], rad2rot(scenario_yaw)).reshape(trajs.shape[:-1] + (2,))
    yaw = rad2global(trajs[..., 2].reshape(n_sc, -1), scenario_yaw).reshape(trajs.shape[:-1])
    return torch.cat([pos, yaw[..., None]], -1)


def build_wosac_data(cfg: WOSACPostCfg, buffer, ag_role: torch.Tensor, batch: Dict[str, torch.Tensor],
                     step_current: int, scenario_center: Optional[torch.Tensor] = None,
                     scenario_yaw: Optional[torch.Tensor] = None) -> Dict[str, np.ndarray]:
    """The filtered futures (global frame where a center is given) and the history arrays the protos
    need, on the host."""
    trajs = filter_futures(cfg, buffer, ag_role, step_current)
    if scenario_center is not None:
        trajs = to_global_frame(trajs, scenario_center, scenario_yaw)
    out = {"trajs": trajs.cpu().numpy()}
    for k in WOSAC_HIST_KEYS:
        if k in batch:
            v = batch[k]
            out[k] = v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
    return out


def get_scenario_rollouts(cfg: WOSACPostCfg, wosac_data: Dict[str, np.ndarray], step_current: int, step_gt: int,
                          scenario_ids: List[str], scenario_center: Optional[np.ndarray] = None,
                          scenario_yaw: Optional[np.ndarray] = None):
    """Host-side ScenarioRollouts protos: the simulated agents' futures, and the agents not simulated
    extrapolated at constant velocity from their history. Needs waymo_open_dataset."""
    from waymo_open_dataset.protos import sim_agents_submission_pb2 as pb

    trajs = wosac_data["trajs"]
    n_sc, n_future = trajs.shape[:2]
    t_step = np.arange(step_gt - step_current) + 1

    def global_np(pos, yaw, i):
        if scenario_center is None:
            return pos, yaw
        c, s = np.cos(scenario_yaw[i]), np.sin(scenario_yaw[i])
        rot_t = np.array([[c, s], [-s, c]])  # transpose of rot
        return pos @ rot_t + scenario_center[i], yaw + scenario_yaw[i]

    rollouts = []
    for i in range(n_sc):
        no_sim = []
        valid_ns = wosac_data["history/agent_no_sim/valid"][i]
        pos_ns = wosac_data["history/agent_no_sim/pos"][i]
        yaw_ns = wosac_data["history/agent_no_sim/yaw_bbox"][i]
        oid_ns = wosac_data["history/agent_no_sim/object_id"][i]
        for a in np.where(valid_ns[:, step_current])[0]:
            if cfg.const_vel_no_sim and valid_ns[a, step_current - 1]:
                v = pos_ns[a, step_current] - pos_ns[a, step_current - 1]
            else:
                v = np.zeros(3)
            xy = pos_ns[a, step_current, :2] + v[None, :2] * t_step[:, None]
            yaw = np.full(len(t_step), yaw_ns[a, step_current, 0])
            xy, yaw = global_np(xy, yaw, i)
            no_sim.append(pb.SimulatedTrajectory(
                center_x=xy[:, 0], center_y=xy[:, 1], center_z=pos_ns[a, step_current, 2] + v[2] * t_step,
                heading=yaw, object_id=int(oid_ns[a]),
            ))

        valid_s = wosac_data["history/agent/valid"][i]
        pos_s = wosac_data["history/agent/pos"][i]
        oid_s = wosac_data["history/agent/object_id"][i]
        joint_scenes = []
        for r in range(n_future):
            sim = []
            for a in np.where(valid_s[:, step_current])[0]:
                if cfg.const_vel_z_sim and valid_s[a, step_current - 1]:
                    v_z = pos_s[a, step_current, 2] - pos_s[a, step_current - 1, 2]
                else:
                    v_z = 0.0
                sim.append(pb.SimulatedTrajectory(
                    center_x=trajs[i, r, a, :, 0], center_y=trajs[i, r, a, :, 1],
                    center_z=pos_s[a, step_current, 2] + v_z * t_step,
                    heading=trajs[i, r, a, :, 2], object_id=int(oid_s[a]),
                ))
            joint_scenes.append(pb.JointScene(simulated_trajectories=sim + no_sim))
        rollouts.append(pb.ScenarioRollouts(joint_scenes=joint_scenes, scenario_id=scenario_ids[i]))
    return rollouts
