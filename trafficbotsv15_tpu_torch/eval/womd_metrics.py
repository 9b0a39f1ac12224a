"""Native WOMD motion metrics (counterpart of `trafficbotsv15_tpu/eval/womd_metrics.py::native_motion_metrics`).

minADE, minFDE and miss rate at 3, 5 and 8 s over the 2 Hz modes, after
Waymo's published definitions, without the official op. The official
metrics (`official_motion_metrics`, fed by `pack_waymo_inputs`) need the
`waymo_open_dataset` package and are not ported yet.
"""

from __future__ import annotations

from typing import Dict

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
