"""Agent dynamics and state overrides (counterpart of `trafficbotsv15_tpu/sim/dynamics.py`).

The MultiPathPP integrator: tanh-bounded (acc, yaw_rate) per agent type,
midpoint integration, with an optional player override of the bounded
action; and the StateIntegrator variant (tanh-bounded (vx, vy)).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from trafficbotsv15_tpu_torch.config import DynamicsCfg
from trafficbotsv15_tpu_torch.ops.transform import cast_rad


def process_action_multipathpp(action: torch.Tensor, ag_type: torch.Tensor, cfg: DynamicsCfg) -> torch.Tensor:
    """Unbounded [n_sc, n_ag, 2] -> (acc, yaw_rate), bounds from the type one-hot [n_sc, n_ag, 3]."""
    t = torch.tanh(action)
    if cfg.use_veh_dynamics_for_all:
        max_acc, max_yr = cfg.max_acc[0], cfg.max_yaw_rate[0]
    else:
        types = ag_type.to(action.dtype)
        max_acc = types @ torch.tensor(cfg.max_acc, dtype=action.dtype, device=action.device)
        max_yr = types @ torch.tensor(cfg.max_yaw_rate, dtype=action.dtype, device=action.device)
    return torch.stack([t[..., 0] * max_acc, t[..., 1] * max_yr], -1)


def update_multipathpp(pose, motion, action, dt: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Midpoint integration. pose (x, y, yaw), motion (spd, acc, yaw_rate), action (acc, yaw_rate)."""
    acc, yaw_rate = action[..., 0], action[..., 1]
    v_tilde = motion[..., 0] + 0.5 * dt * acc
    theta_tilde = pose[..., 2] + 0.5 * dt * yaw_rate
    delta = torch.stack([v_tilde * torch.cos(theta_tilde), v_tilde * torch.sin(theta_tilde), yaw_rate], -1)
    pred_pose = pose + dt * delta
    spd = motion[..., 0] + dt * acc
    return pred_pose, torch.stack([spd, acc, yaw_rate], -1)


def process_action_integrator(action: torch.Tensor, max_v: float = 3.0) -> torch.Tensor:
    """StateIntegrator variant: tanh-bounded (vx, vy)."""
    return torch.tanh(action) * max_v


def update_integrator(pose, motion, action, dt: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """vx/vy integrator: the heading follows the velocity."""
    vx, vy = action[..., 0], action[..., 1]
    theta = torch.atan2(vy, vx)
    pred_pose = torch.stack([pose[..., 0] + vx * dt, pose[..., 1] + vy * dt, theta], -1)
    spd = torch.linalg.vector_norm(action, dim=-1)
    acc = (spd - motion[..., 0]) / dt
    yaw_rate = cast_rad(theta - pose[..., 2]) / dt
    return pred_pose, torch.stack([spd, acc, yaw_rate], -1)


def step_dynamics(pose, motion, valid, action_unbounded, ag_type, cfg: DynamicsCfg,
                  player_override: Optional[Dict[str, torch.Tensor]] = None):
    """One dynamics update; returns (new_pose, new_motion, bounded_action), invalid agents at 0.
    `player_override` {"valid" [n_sc, n_ag], "action" [n_sc, n_ag, 2]} replaces the bounded action
    of the valid agents it marks."""
    action = process_action_multipathpp(action_unbounded, ag_type, cfg)
    invalid = ~valid[..., None]
    action = torch.where(invalid, 0.0, action)
    if player_override is not None:
        action = torch.where((player_override["valid"] & valid)[..., None], player_override["action"], action)
    new_pose, new_motion = update_multipathpp(pose, motion, action, cfg.dt)
    return torch.where(invalid, 0.0, new_pose), torch.where(invalid, 0.0, new_motion), action


def override_ag(valid, pose, motion, disabled, ov_valid, ov_pose, ov_motion):
    """Teacher forcing / spawn override; disabled agents are never re-spawned."""
    ov = ov_valid & ~disabled
    ovx = ov[..., None]
    return valid | ov, torch.where(ovx, ov_pose, pose), torch.where(ovx, ov_motion, motion)


def disable_outside_map(valid, disabled, outside_map_this_step, gt_valid):
    """Disable agents that left the map unless GT-valid. Returns (new_valid, new_disabled)."""
    disable = outside_map_this_step & ~gt_valid
    return valid & ~disable, disabled | disable


def update_navi_on_reached(navi, navi_valid, reached, new_navi: Optional[torch.Tensor] = None):
    """A reached navigation target is invalidated; a re-predicted `new_navi` (dest [n_sc, n_ag],
    goal / cmd [n_sc, n_ag, d]) replaces it for the reached agents and makes it valid again."""
    navi_valid = navi_valid & ~reached
    if new_navi is not None:
        m = reached if navi.ndim == 2 else reached[..., None]
        navi = torch.where(m, new_navi.to(navi.dtype), navi)
        navi_valid = navi_valid | reached
    return navi, navi_valid


def override_tl(tl_logits, ov_valid, ov_state) -> torch.Tensor:
    """Next TL state = one-hot argmax of the logits, overridden by GT where forced. Bool [n_sc, n_tl, 5]."""
    n_state = tl_logits.shape[-1]
    pred = torch.argmax(tl_logits, -1)
    one_hot = torch.arange(n_state, device=tl_logits.device) == pred[..., None]
    return torch.where(ov_valid[..., None], ov_state.bool(), one_hot)
