"""WOMD motion metrics (counterpart of `trafficbotsv15_tpu/eval/womd_metrics.py`).

  - `native_motion_metrics`: minADE, minFDE and miss rate at 3, 5 and 8 s over
    the 2 Hz modes, after Waymo's published definitions, on the device;
  - `pack_waymo_inputs`: the host-side packing of predictions and ground truth
    into the layout of Waymo's official C++ op (predict-role agents first, 8
    joint slots, 7-dim ground-truth trajectories), numpy only;
  - `official_motion_metrics`: that op on the packed rows. It imports
    `tensorflow` and `waymo_open_dataset` when called and raises ImportError
    without them.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from trafficbotsv15_tpu_torch.sim.wosac_collision import norm2

# Waymo miss-rate thresholds at 3 s / 5 s / 8 s (lateral, longitudinal), scaled by the initial speed
_MISS_THRESH_LAT = {3: 1.0, 5: 1.8, 8: 3.0}
_MISS_THRESH_LON = {3: 2.0, 5: 3.6, 8: 6.0}


def native_motion_metrics(trajs: torch.Tensor, scores: torch.Tensor, gt_pos: torch.Tensor, gt_yaw: torch.Tensor,
                          gt_valid: torch.Tensor, gt_spd: torch.Tensor, mask_pred: torch.Tensor,
                          step_current: int = 10) -> Dict[str, torch.Tensor]:
    """trajs [n_sc, n_ag, K, n_step_2hz, >=2] at 2 Hz, scores [n_sc, n_ag, K]; gt_* [n_sc, n_ag, n_step_gt(, 2)]
    at 10 Hz from step 0; mask_pred [n_sc, n_ag] the agents evaluated. Predictions are at steps
    current + 5 k (k = 1..16); miss thresholds scale with the initial speed, 0.5 to 1 over 1.4 to 11 m/s;
    displacement split into lateral and longitudinal in the ground truth's heading. -> scalar tensors."""
    n_step_pred = trajs.shape[3]
    if n_step_pred == 0:  # degenerate short horizon: nothing to measure
        return {}
    steps = step_current + 5 * (torch.arange(n_step_pred, device=trajs.device) + 1)
    gt_pos_2hz, gt_yaw_2hz, gt_valid_2hz = gt_pos[:, :, steps], gt_yaw[:, :, steps], gt_valid[:, :, steps]

    d = trajs[..., :2] - gt_pos_2hz[:, :, None]  # [n_sc, n_ag, K, n_step, 2]
    dist = torch.where(gt_valid_2hz[:, :, None], norm2(d[..., 0], d[..., 1]), 0.0)
    v0 = gt_spd[:, :, step_current]
    scale = 0.5 + 0.5 * torch.clamp((v0 - 1.4) / (11.0 - 1.4), 0.0, 1.0)
    valid_ag = mask_pred & gt_valid_2hz.any(-1)
    n_valid = valid_ag.sum().clamp_min(1)

    out = {}
    horizons = [(h, m) for h, m in ((3, 5), (5, 9), (8, 15)) if m < n_step_pred]
    if not horizons:  # short-horizon configs: measure at the last sample
        horizons = [(max((n_step_pred * 5) // 10, 1), n_step_pred - 1)]
    for horizon_s, meas in horizons:
        upto = meas + 1
        c2 = gt_valid_2hz[:, :, :upto].sum(-1).clamp_min(1)[:, :, None]
        min_ade = (dist[..., :upto].sum(-1) / c2).amin(-1)  # [n_sc, n_ag]
        has_final = gt_valid_2hz[:, :, meas]
        min_fde = dist[..., meas].amin(-1)
        yaw = gt_yaw_2hz[:, :, meas]
        c, s = torch.cos(yaw)[:, :, None], torch.sin(yaw)[:, :, None]
        dx = d[:, :, :, meas, 0] * c + d[:, :, :, meas, 1] * s
        dy = -d[:, :, :, meas, 0] * s + d[:, :, :, meas, 1] * c
        lat_t = (_MISS_THRESH_LAT.get(horizon_s, 1.0) * scale)[:, :, None]
        lon_t = (_MISS_THRESH_LON.get(horizon_s, 2.0) * scale)[:, :, None]
        miss = ~((dy.abs() <= lat_t) & (dx.abs() <= lon_t)).any(-1)  # missed by every mode
        m_ag = valid_ag & has_final
        n_m = m_ag.sum().clamp_min(1)
        out[f"min_ade_{horizon_s}s"] = torch.where(valid_ag, min_ade, 0.0).sum() / n_valid
        out[f"min_fde_{horizon_s}s"] = torch.where(m_ag, min_fde, 0.0).sum() / n_m
        out[f"miss_rate_{horizon_s}s"] = (m_ag & miss).sum() / n_m
    for name in ("min_ade", "min_fde", "miss_rate"):
        out[name] = torch.stack([v for k, v in out.items() if k.startswith(f"{name}_")]).mean()
    return out


def pack_waymo_inputs(batch: Dict[str, np.ndarray], trajs: np.ndarray, scores: np.ndarray, step_gt: int,
                      step_current: int, m_joint: int = 8) -> Dict[str, np.ndarray]:
    """The official op's inputs: trajs [n_sc, n_ag, K, n_step_2hz, >=2], scores [n_sc, n_ag, K] (float32 numpy),
    batch the ground truth's h5 keys as numpy. Predict-role agents fill the first of the m_joint slots (one
    agent per prediction); the ground truth lists them first, then the other agents observed over the whole
    history."""
    mask_pred = np.asarray(batch["agent/role"][..., 2], bool)
    mask_other = (~mask_pred) & np.asarray(batch["agent/valid"][:, :, : step_current + 1]).all(-1)

    pos = np.asarray(batch["agent/pos"])
    gt_traj = np.concatenate([
        pos[..., :2],
        np.broadcast_to(np.asarray(batch["agent/size"])[:, :, None, :2], pos[..., :2].shape),
        np.asarray(batch["agent/yaw_bbox"]),
        np.asarray(batch["agent/vel"]),
    ], axis=-1)[:, :, : step_gt + 1]
    gt_valid = np.asarray(batch["agent/valid"])[:, :, : step_gt + 1]
    agent_type = np.asarray(batch["agent/type"]).argmax(-1) + 1.0

    n_sc, n_ag, n_step_gt = gt_valid.shape
    n_k, n_step_pred = trajs.shape[2], trajs.shape[3]
    out = {
        "prediction_trajectory": np.zeros([n_sc, m_joint, n_k, 1, n_step_pred, 2], np.float32),
        "prediction_score": np.zeros([n_sc, m_joint, n_k], np.float32),
        "ground_truth_trajectory": np.zeros([n_sc, n_ag, n_step_gt, 7], np.float32),
        "ground_truth_is_valid": np.zeros([n_sc, n_ag, n_step_gt], bool),
        "prediction_ground_truth_indices_mask": np.zeros([n_sc, m_joint, 1], bool),
        "object_type": np.zeros([n_sc, n_ag], np.float32),
    }
    for i in range(n_sc):
        np_pred = int(mask_pred[i].sum())
        np_other = int(mask_other[i].sum())
        out["prediction_trajectory"][i, :np_pred] = trajs[i, mask_pred[i], :, None, :, :2]
        out["prediction_score"][i, :np_pred] = scores[i, mask_pred[i]]
        out["prediction_ground_truth_indices_mask"][i, :np_pred] = True
        out["ground_truth_trajectory"][i, :np_pred] = gt_traj[i, mask_pred[i]]
        out["ground_truth_is_valid"][i, :np_pred] = gt_valid[i, mask_pred[i]]
        out["ground_truth_trajectory"][i, np_pred: np_pred + np_other] = gt_traj[i, mask_other[i]]
        out["ground_truth_is_valid"][i, np_pred: np_pred + np_other] = gt_valid[i, mask_other[i]]
        out["object_type"][i, :np_pred] = agent_type[i, mask_pred[i]]
        out["object_type"][i, np_pred: np_pred + np_other] = agent_type[i, mask_other[i]]
    return out


def official_motion_metrics(packed: Dict[str, np.ndarray], step_current: int, prefix: str) -> Dict[str, float]:
    """Waymo's C++/TensorFlow motion-metrics op on `pack_waymo_inputs` rows: min_ade, min_fde, miss_rate,
    overlap_rate and mean_average_precision, per breakdown and their means, under `<prefix>/waymo_metrics/`."""
    import tensorflow as tf
    from google.protobuf import text_format
    from waymo_open_dataset.metrics.ops import py_metrics_ops
    from waymo_open_dataset.metrics.python.config_util_py import get_breakdown_names_from_motion_config
    from waymo_open_dataset.protos import motion_metrics_pb2

    config = motion_metrics_pb2.MotionMetricsConfig()
    text_format.Parse(
        f"""
        track_steps_per_second: 10
        prediction_steps_per_second: 2
        track_history_samples: {step_current}
        track_future_samples: 80
        speed_lower_bound: 1.4
        speed_upper_bound: 11.0
        speed_scale_lower: 0.5
        speed_scale_upper: 1.0
        step_configurations {{ measurement_step: 5 lateral_miss_threshold: 1.0 longitudinal_miss_threshold: 2.0 }}
        step_configurations {{ measurement_step: 9 lateral_miss_threshold: 1.8 longitudinal_miss_threshold: 3.6 }}
        step_configurations {{ measurement_step: 15 lateral_miss_threshold: 3.0 longitudinal_miss_threshold: 6.0 }}
        max_predictions: 6
        """,
        config,
    )
    metrics = py_metrics_ops.motion_metrics(
        config=config.SerializeToString(),
        prediction_trajectory=tf.convert_to_tensor(packed["prediction_trajectory"]),
        prediction_score=tf.convert_to_tensor(packed["prediction_score"]),
        ground_truth_trajectory=tf.convert_to_tensor(packed["ground_truth_trajectory"]),
        ground_truth_is_valid=tf.convert_to_tensor(packed["ground_truth_is_valid"]),
        prediction_ground_truth_indices=tf.zeros(packed["prediction_ground_truth_indices_mask"].shape, tf.int64),
        prediction_ground_truth_indices_mask=tf.convert_to_tensor(packed["prediction_ground_truth_indices_mask"]),
        object_type=tf.convert_to_tensor(packed["object_type"]),
    )
    names = get_breakdown_names_from_motion_config(config)
    out = {}
    for metric_type in ("min_ade", "min_fde", "miss_rate", "overlap_rate", "mean_average_precision"):
        values = np.asarray(getattr(metrics, metric_type))
        for i, n in enumerate(names):
            out[f"{prefix}/waymo_metrics/{metric_type}_{n}"] = float(values[i])
        out[f"{prefix}/waymo_metrics/{metric_type}"] = float(values.mean())
    return out
