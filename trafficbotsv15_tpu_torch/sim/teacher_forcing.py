"""Teacher-forcing masks (counterpart of `trafficbotsv15_tpu/sim/teacher_forcing.py`).

The joint-future configuration forces no agent at random and resets on no
error threshold; those random and threshold branches are training features
and raise here until the training slice.
"""

from __future__ import annotations

from typing import Tuple

import torch

from trafficbotsv15_tpu_torch.config import TeacherForcingCfg


def build_forcing_masks(cfg: TeacherForcingCfg, ag_valid: torch.Tensor, tl_valid_step: torch.Tensor,
                        current_epoch: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ag forcing [n_sc, n_ag, n_step], tl forcing [n_sc, n_tl, n_step])."""
    if cfg.prob_forcing_agent > 0 or cfg.prob_scheduled_sampling > 0:
        raise NotImplementedError("random teacher forcing comes with the training slice")
    n_step = ag_valid.shape[2]
    forcing = torch.zeros_like(ag_valid)
    forcing[:, :, 0] = ag_valid[:, :, 0]  # always spawn at step 0
    if cfg.step_spawn_agent > 0:  # spawn on a rising edge of validity up to step_spawn_agent
        spawn = ~ag_valid[:, :, :-1] & ag_valid[:, :, 1:]
        step_idx = torch.arange(1, n_step, device=ag_valid.device)[None, None, :]
        forcing[:, :, 1:] |= spawn & (step_idx <= cfg.step_spawn_agent)
    if cfg.step_warm_start >= 0:  # warm start: force every valid agent up to step_warm_start
        upto = min(cfg.step_warm_start + 1, n_step)
        forcing[:, :, :upto] |= ag_valid[:, :, :upto]
    step_horizon = cfg.step_horizon - cfg.step_horizon_decrease_per_epoch * current_epoch
    step_idx_full = torch.arange(n_step, device=ag_valid.device)[None, None, :]
    forcing = forcing | (ag_valid & (step_idx_full < step_horizon))
    if cfg.gt_sdc:
        forcing[:, 0] |= ag_valid[:, 0]
    return forcing, tl_valid_step


def check_error_reset(cfg: TeacherForcingCfg) -> None:
    """The error-threshold reset is off on the joint-future path (all thresholds <= 0)."""
    if cfg.threshold_xy > 0 or cfg.threshold_yaw > 0 or cfg.threshold_spd > 0:
        raise NotImplementedError("error-threshold teacher-forcing resets come with the training slice")
