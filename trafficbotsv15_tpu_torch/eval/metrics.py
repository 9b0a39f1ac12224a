"""Rollout logging metrics as running sums (counterpart of `trafficbotsv15_tpu/eval/metrics.py`).

The `*_sums` functions return dicts of scalar tensors on the rollout's
device: the validation step hands them back without a host sync.
`merge_sums` accumulates them across steps and `compute_*` normalises,
reading each sum once on the host.
"""

from __future__ import annotations

from typing import Dict

import torch

from trafficbotsv15_tpu_torch.ops.transform import cast_rad


def error_metric_sums(buffer, gt_valid: torch.Tensor, gt_pose: torch.Tensor, gt_motion: torch.Tensor,
                      step_start: int = 1) -> Dict[str, torch.Tensor]:
    """Reconstruction errors against the ground truth. buffer flattened [n_sc, K=1, n_ag, n_step(, d)], its
    steps the absolute steps [step_start, step_start + n_step); gt_* [n_sc, n_ag, n_step_gt] from step 0.
    A rollout past the log's horizon (the scaled preset) counts its logged steps only; JAX's function
    raises there (the buffer and the log do not broadcast)."""
    n_step = min(buffer.pred_valid.shape[-1], gt_valid.shape[2] - step_start)
    gt_valid = gt_valid[:, :, step_start:step_start + n_step]
    gt_pose = gt_pose[:, :, step_start:step_start + n_step]
    gt_motion = gt_motion[:, :, step_start:step_start + n_step]
    err_valid = buffer.pred_valid[:, 0, :, :n_step] & gt_valid
    inv = ~err_valid[..., None]
    err_pose = torch.where(inv, 0.0, buffer.pred_pose[:, 0, :, :n_step] - gt_pose)
    err_motion = torch.where(inv, 0.0, buffer.pred_motion[:, 0, :, :n_step] - gt_motion)
    return {
        "err_counter": err_valid.sum().float(),
        "err_pos_meter": torch.linalg.vector_norm(err_pose[..., :2], dim=-1).sum(),
        "err_rot_deg": torch.rad2deg(cast_rad(err_pose[..., 2])).abs().sum(),
        "err_spd_m_per_s": err_motion[..., 0].abs().sum(),
    }


def compute_error_metrics(sums: Dict[str, torch.Tensor], prefix: str) -> Dict[str, float]:
    c = max(float(sums["err_counter"]), 1e-8)
    return {
        f"{prefix}/err/pos_meter": float(sums["err_pos_meter"]) / c,
        f"{prefix}/err/rot_deg": float(sums["err_rot_deg"]) / c,
        f"{prefix}/err/spd_m_per_s": float(sums["err_spd_m_per_s"]) / c,
    }


def traffic_rule_sums(buffer, ag_type: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Numerators and denominators of the violation rates. buffer flattened: leaves [n_sc, K, n_ag, n_step]."""
    valid = buffer.pred_valid

    def acc(name):
        return (buffer.violation[name] & valid).any(-1).sum().float()

    valid_any = valid.any(-1)  # [n_sc, K, n_ag]
    mask_veh = ag_type[:, None, :, 0]
    return {
        "counter_agent": valid_any.sum().float(),
        "counter_veh": (valid_any & mask_veh).sum().float(),
        **{name: acc(name) for name in ("outside_map", "collided", "run_road_edge", "run_red_light", "passive",
                                        "goal_reached", "dest_reached")},
    }


def compute_traffic_rule_metrics(sums: Dict[str, torch.Tensor], prefix: str) -> Dict[str, float]:
    ca = max(float(sums["counter_agent"]), 1e-8)
    cv = max(float(sums["counter_veh"]), 1e-8)
    return {
        f"{prefix}/traffic_rule/outside_map": float(sums["outside_map"]) / ca,
        f"{prefix}/traffic_rule/collided": float(sums["collided"]) / ca,
        f"{prefix}/traffic_rule/run_road_edge": float(sums["run_road_edge"]) / cv,
        f"{prefix}/traffic_rule/run_red_light": float(sums["run_red_light"]) / cv,
        f"{prefix}/traffic_rule/passive": float(sums["passive"]) / cv,
        f"{prefix}/traffic_rule/goal_reached": float(sums["goal_reached"]) / ca,
        f"{prefix}/traffic_rule/dest_reached": float(sums["dest_reached"]) / ca,
    }


def merge_sums(a: Dict[str, torch.Tensor], b: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    if not a:
        return dict(b)
    return {k: a[k] + b[k] for k in a}
