"""Scene-centric pre-processing: batch dict -> model inputs (counterpart of
`trafficbotsv15_tpu/data/preprocessing.py`).

The traffic-light tokens are lanes (`tl_mode="lane"`: `tl_lane/*`, the
lane's index as tl_attr and its first node's pose) or stop lines (`"stop"`:
`tl_stop/*`, no tl_attr, the stop's position with the heading atan2 of its
direction; the JAX package's corrected form of the reference's concat,
`docs/PARITY.md` L2).

Training adds history dropout: each map node but the first and each agent
history step but the last is dropped with probability `dropout_p_history`,
from uniform draws the caller makes (`train/pipeline.py` draws them from
its generator; the JAX package from its `k_pre` key).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch


@dataclasses.dataclass
class PreProcessedBatch:
    """Model-ready tensors. All bools use True = valid."""

    mp_valid: torch.Tensor  # [n_sc, n_mp, n_node]
    mp_attr: torch.Tensor  # [n_sc, n_mp, n_mp_type] float
    mp_pose: torch.Tensor  # [n_sc, n_mp, n_node, 3]
    mp_type: torch.Tensor  # [n_sc, n_mp, n_mp_type] bool
    tl_valid: torch.Tensor  # [n_sc, n_tl]
    tl_attr: Optional[torch.Tensor]  # [n_sc, n_tl] lane index (lane mode) or None
    tl_state: torch.Tensor  # [n_sc, n_tl, n_step_hist, 5]
    tl_pose: torch.Tensor  # [n_sc, n_tl, 3]
    ag_valid: torch.Tensor  # [n_sc, n_ag, n_step_hist]
    ag_attr: torch.Tensor  # [n_sc, n_ag, 6] (size ++ type)
    ag_motion: torch.Tensor  # [n_sc, n_ag, n_step_hist, 3]
    ag_pose: torch.Tensor  # [n_sc, n_ag, n_step_hist, 3]
    gt_valid: Optional[torch.Tensor]  # [n_sc, n_ag, n_step]
    gt_motion: Optional[torch.Tensor]
    gt_pose: Optional[torch.Tensor]
    gt_navi: Optional[torch.Tensor]
    gt_tl_valid: Optional[torch.Tensor]
    gt_tl_state: Optional[torch.Tensor]
    ag_type: torch.Tensor  # [n_sc, n_ag, 3] bool
    ag_role: torch.Tensor  # [n_sc, n_ag, 3] bool
    ag_size: torch.Tensor  # [n_sc, n_ag, 3]


def merge_invalid_tl_into_state(tl_valid: torch.Tensor, tl_state: torch.Tensor):
    """Invalid TL steps become state UNKNOWN=0. tl_valid [n_sc, n_tl, n_step], tl_state one-hot bool."""
    tl_valid_any = tl_valid.any(-1)
    invalid_steps = ~tl_valid & tl_valid_any[..., None]
    unknown = torch.zeros_like(tl_state)
    unknown[..., 0] = invalid_steps
    return tl_valid_any, tl_state | unknown


def _atan2_dir(d: torch.Tensor) -> torch.Tensor:
    return torch.atan2(d[..., 1:2], d[..., 0:1])


def pre_processing(batch: Dict[str, torch.Tensor], tl_mode: str = "lane", navi_mode: str = "dest",
                   n_step_hist: int = 11, training: bool = True, dropout_p_history: float = -1.0,
                   u_mp: Optional[torch.Tensor] = None, u_ag: Optional[torch.Tensor] = None) -> PreProcessedBatch:
    """batch keys follow the h5 schema; at test time history tensors carry the 'history/' prefix.

    With training, 0 < dropout_p_history <= 1 and the uniform draws u_mp [n_sc, n_mp, n_node - 1]
    and u_ag [n_sc, n_ag, n_step_hist - 1], a node or step is kept where its draw is below
    1 - dropout_p_history (jax.random.bernoulli's rule)."""
    if tl_mode not in ("lane", "stop"):
        raise ValueError(f"tl_mode {tl_mode!r}")
    prefix = "" if (training or "agent/valid" in batch) else "history/"
    mp_pose = torch.cat([batch["map/pos"][..., :2], _atan2_dir(batch["map/dir"])], -1)

    tlk = f"tl_{tl_mode}"
    tl_valid, tl_state = merge_invalid_tl_into_state(
        batch[f"{prefix}{tlk}/valid"][:, :, :n_step_hist], batch[f"{prefix}{tlk}/state"][:, :, :n_step_hist])
    if tl_mode == "stop":
        tl_attr = None
        tl_pose = torch.cat([batch[f"{prefix}tl_stop/pos"][..., :2], _atan2_dir(batch[f"{prefix}tl_stop/dir"])], -1)
    else:
        tl_attr = batch[f"{prefix}tl_lane/idx"]
        idx = torch.clamp(tl_attr, 0, mp_pose.shape[1] - 1).long()
        tl_pose = torch.gather(mp_pose[:, :, 0], 1, idx[..., None].expand(-1, -1, 3))

    size = batch[f"{prefix}agent/size"]
    ag_motion = torch.cat([batch[f"{prefix}agent/{k}"][:, :, :n_step_hist] for k in ("spd", "acc", "yaw_rate")], -1)
    ag_pose = torch.cat([batch[f"{prefix}agent/pos"][:, :, :n_step_hist, :2],
                         batch[f"{prefix}agent/yaw_bbox"][:, :, :n_step_hist]], -1)

    mp_valid = batch["map/valid"]
    ag_valid = batch[f"{prefix}agent/valid"][:, :, :n_step_hist]
    if training and 0 < dropout_p_history <= 1.0 and u_mp is not None:
        keep = 1.0 - dropout_p_history
        mp_valid = torch.cat([mp_valid[:, :, :1], mp_valid[:, :, 1:] & (u_mp < keep)], 2)
        ag_valid = torch.cat([ag_valid[..., :-1] & (u_ag < keep), ag_valid[..., -1:]], -1)

    gt = dict(gt_valid=None, gt_motion=None, gt_pose=None, gt_navi=None, gt_tl_valid=None, gt_tl_state=None)
    if "agent/valid" in batch:
        gt_tl_valid, gt_tl_state = merge_invalid_tl_into_state(batch[f"{tlk}/valid"], batch[f"{tlk}/state"])
        gt.update(
            gt_valid=batch["agent/valid"],
            gt_motion=torch.cat([batch["agent/spd"], batch["agent/acc"], batch["agent/yaw_rate"]], -1),
            gt_pose=torch.cat([batch["agent/pos"][..., :2], batch["agent/yaw_bbox"]], -1),
            gt_navi=batch[f"agent/{navi_mode}"] if navi_mode != "dummy" else None,
            gt_tl_valid=gt_tl_valid, gt_tl_state=gt_tl_state,
        )
    return PreProcessedBatch(
        mp_valid=mp_valid,
        mp_attr=batch["map/type"].float(),
        mp_pose=mp_pose,
        mp_type=batch["map/type"].bool(),
        tl_valid=tl_valid,
        tl_attr=tl_attr,
        tl_state=tl_state,
        tl_pose=tl_pose,
        ag_valid=ag_valid,
        ag_attr=torch.cat([size, batch[f"{prefix}agent/type"].to(size.dtype)], -1),
        ag_motion=ag_motion,
        ag_pose=ag_pose,
        ag_type=batch[f"{prefix}agent/type"].bool(),
        ag_role=batch[f"{prefix}agent/role"].bool(),
        ag_size=size,
        **gt,
    )
