"""Differentiable per-step imitation reward (counterpart of `trafficbotsv15_tpu/sim/rewards.py`).

-SmoothL1(pos) * w_pos, -angular error * w_rot, -SmoothL1(spd) * w_spd,
masked by pred and GT validity, and an optional relaxed 5-circle collision
penalty. The training rollout puts these into its buffer every step.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from trafficbotsv15_tpu_torch.config import RewardCfg
from trafficbotsv15_tpu_torch.ops.transform import cast_rad


def smooth_l1(pred: torch.Tensor, target: torch.Tensor, beta: float = 1.0) -> torch.Tensor:
    d = torch.abs(pred - target)
    return torch.where(d < beta, 0.5 * d * d / beta, d - 0.5 * beta)


def angular_error(pred: torch.Tensor, target: torch.Tensor, angular_type: str) -> torch.Tensor:
    if angular_type == "cosine":
        return 0.5 * (1.0 - torch.cos(pred - target))
    if angular_type == "cast":
        return smooth_l1(cast_rad(pred - target), torch.zeros_like(pred))
    if angular_type == "vector":
        return smooth_l1(torch.cos(pred), torch.cos(target)) + smooth_l1(torch.sin(pred), torch.sin(target))
    return smooth_l1(pred, target)


def soft_collision_5circle(pred_valid: torch.Tensor, pred_pose: torch.Tensor, ag_size: torch.Tensor,
                           reduce_with_max: bool) -> torch.Tensor:
    """Relaxed pairwise collision in [0, 1] from five circles along each box. -> [n_sc, n_ag]."""
    n_sc, n_ag = pred_valid.shape
    eps = torch.finfo(pred_pose.dtype).eps
    xy, yaw = pred_pose[..., :2], pred_pose[..., 2]
    heading = torch.stack([torch.cos(yaw), torch.sin(yaw)], -1)
    w = ag_size[..., :2].amin(-1)
    length = ag_size[..., :2].amax(-1)
    d = ((length - w) / 4.0)[..., None]
    offsets = torch.tensor([-2.0, -1.0, 0.0, 1.0, 2.0], dtype=pred_pose.dtype, device=pred_pose.device)
    centroids = xy[:, :, None, :] + offsets[None, None, :, None] * heading[:, :, None, :] * d[:, :, None, :]
    diff = centroids[:, :, None, :, None, :] - centroids[:, None, :, None, :, :]
    dist = torch.linalg.norm(diff, dim=-1) + eps  # [n_sc, n_ag, n_ag, 5, 5]
    dist = dist.reshape(n_sc, n_ag, n_ag, 25).amin(-1)
    r = w / 2.0 + eps
    r_sum = r[:, :, None] + r[:, None, :]
    collision = torch.clamp(1.0 - dist / r_sum, min=0.0)
    invalid = ~pred_valid
    ego = torch.eye(n_ag, dtype=torch.bool, device=pred_valid.device)[None]
    collision = torch.where(ego | invalid[:, :, None] | invalid[:, None, :], 0.0, collision)
    if reduce_with_max:
        return collision.amax(2)
    collision = torch.clamp(collision, max=1.0)
    return collision.sum(-1) / pred_valid.sum(-1, keepdim=True)


def diffbar_reward(cfg: RewardCfg, pred_valid: torch.Tensor, pred_pose: torch.Tensor, pred_motion: torch.Tensor,
                   gt_valid: Optional[torch.Tensor], gt_pose: Optional[torch.Tensor],
                   gt_motion: Optional[torch.Tensor], ag_size: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Per-step rewards, each [n_sc, n_ag]; the keys of the JAX buffer."""
    zeros = torch.zeros_like(pred_pose[..., 0])
    out = {"diffbar_reward_valid": pred_valid, "diffbar_reward": zeros, "r_imitation_pos": zeros,
           "r_imitation_rot": zeros, "r_imitation_spd": zeros, "r_traffic_rule_approx": zeros}
    if cfg.use_il_loss and gt_valid is not None:
        valid = pred_valid & gt_valid
        out["diffbar_reward_valid"] = valid
        e_pos = smooth_l1(gt_pose[..., :2], pred_pose[..., :2]).sum(-1)
        e_rot = angular_error(gt_pose[..., 2], pred_pose[..., 2], cfg.angular_type)
        e_spd = smooth_l1(gt_motion[..., 0], pred_motion[..., 0])
        inv = ~valid
        out["r_imitation_pos"] = torch.where(inv, 0.0, -cfg.w_pos * e_pos)
        out["r_imitation_rot"] = torch.where(inv, 0.0, -cfg.w_rot * e_rot)
        out["r_imitation_spd"] = torch.where(inv, 0.0, -cfg.w_spd * e_spd)
        out["diffbar_reward"] = out["r_imitation_pos"] + out["r_imitation_rot"] + out["r_imitation_spd"]
    if cfg.w_collision > 0:
        out["diffbar_reward_valid"] = pred_valid
        col = soft_collision_5circle(pred_valid, pred_pose, ag_size, cfg.reduce_collision_with_max)
        col = torch.where(~pred_valid, 0.0, -cfg.w_collision * col)
        out["r_traffic_rule_approx"] = col
        out["diffbar_reward"] = out["diffbar_reward"] + col
    return out
