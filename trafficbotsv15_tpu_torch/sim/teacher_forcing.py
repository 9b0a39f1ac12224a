"""Teacher-forcing masks (counterpart of `trafficbotsv15_tpu/sim/teacher_forcing.py`).

The random branches (per-agent forcing, scheduled sampling, both decreasing
per epoch) take uniform draws from the caller: a mask entry is set where its
draw is below the probability (jax.random.bernoulli's rule). The
error-threshold reset raises (no configuration of the repo sets one).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from trafficbotsv15_tpu_torch.config import TeacherForcingCfg


def build_forcing_masks(cfg: TeacherForcingCfg, ag_valid: torch.Tensor, tl_valid_step: torch.Tensor,
                        current_epoch: int = 0, u_agent: Optional[torch.Tensor] = None,
                        u_ss: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ag forcing [n_sc, n_ag, n_step], tl forcing [n_sc, n_tl, n_step]).

    u_agent [n_sc, n_ag] and u_ss [n_sc, n_ag, n_step] are uniform draws, needed when
    prob_forcing_agent > 0, resp. prob_scheduled_sampling > 0."""
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
    p_agent = cfg.prob_forcing_agent - cfg.prob_forcing_agent_decrease_per_epoch * current_epoch
    if cfg.prob_forcing_agent > 0:
        if u_agent is None:
            raise ValueError("prob_forcing_agent > 0 needs the uniform draws u_agent")
        mask = (u_agent < min(max(p_agent, 0.0), 1.0)) & (p_agent > 0)
        forcing = forcing | (mask[..., None] & ag_valid)
    p_ss = cfg.prob_scheduled_sampling - cfg.prob_scheduled_sampling_decrease_per_epoch * current_epoch
    if cfg.prob_scheduled_sampling > 0:
        if u_ss is None:
            raise ValueError("prob_scheduled_sampling > 0 needs the uniform draws u_ss")
        forcing = forcing | ((u_ss < min(max(p_ss, 0.0), 1.0)) & (p_ss > 0) & ag_valid)
    if cfg.gt_sdc:
        forcing[:, 0] |= ag_valid[:, 0]
    return forcing, tl_valid_step


def check_error_reset(cfg: TeacherForcingCfg) -> None:
    """The error-threshold reset is not ported: every threshold must be off (<= 0)."""
    if cfg.threshold_xy > 0 or cfg.threshold_yaw > 0 or cfg.threshold_spd > 0:
        raise NotImplementedError("error-threshold teacher-forcing resets are not ported")
