"""Training loss (counterpart of `trafficbotsv15_tpu/train/losses.py::training_loss`).

Balanced CVAE KL with free nats, the differentiable reward (subtracted), the
navigation NLL and the TL-state NLL, masked as the JAX package masks them:
from `step_training_start` on, optionally relevant agents only (irrelevant
ones kept with probability `p_loss_for_irrelevant`, from uniform draws the
caller makes), optionally without teacher-forced steps, optionally weighted
towards relevant agents and discounted after teacher-forced steps.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from trafficbotsv15_tpu_torch.config import TrainingMetricsCfg
from trafficbotsv15_tpu_torch.ops.distributions import DestCategorical, balanced_kl
from trafficbotsv15_tpu_torch.sim.rollout import RolloutBuffer

_EPS = 1e-8


def training_loss(cfg: TrainingMetricsCfg, buffer: RolloutBuffer, ag_role: torch.Tensor, navi_pred,
                  navi_gt: Optional[torch.Tensor], latent_post, latent_prior,
                  u_irrelevant: Optional[torch.Tensor] = None,
                  prefix: str = "training") -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """buffer leaves [n_sc, n_ag / n_tl, n_step, ...]; ag_role [n_sc, n_ag, 3]; u_irrelevant [n_sc, n_ag, 1]
    uniform draws, needed when 0 < p_loss_for_irrelevant < 1. -> (loss, metrics)."""
    loss_valid = buffer.pred_valid.detach()
    n_step = loss_valid.shape[2]
    dev = loss_valid.device
    if cfg.p_loss_for_irrelevant < 1.0:
        relevant = ag_role.any(-1, keepdim=True)
        if cfg.p_loss_for_irrelevant > 0.0 and u_irrelevant is not None:
            relevant = relevant | (u_irrelevant < cfg.p_loss_for_irrelevant)
        loss_valid = loss_valid & relevant
    if cfg.step_training_start > 0:
        step_abs = torch.arange(1, n_step + 1, device=dev)  # the buffer starts at step 1
        loss_valid = loss_valid & (step_abs >= cfg.step_training_start)[None, None, :]
    if not cfg.loss_for_teacher_forcing:
        loss_valid = loss_valid & ~buffer.mask_teacher_forcing

    w_rel = None
    if cfg.w_relevant_agent > 0:
        w_rel = loss_valid.any(-1).float() + ag_role.any(-1) * cfg.w_relevant_agent

    out: Dict[str, torch.Tensor] = {}
    loss = torch.zeros((), device=dev)
    if latent_post is not None and cfg.w_vae_kl > 0:
        kl_valid = latent_post.valid if cfg.kl_for_unseen_agent else latent_prior.valid
        kl_valid = kl_valid & loss_valid.any(-1)
        err = balanced_kl(latent_post, latent_prior, cfg.kl_balance_scale, cfg.kl_free_nats)
        if w_rel is not None:
            err = err * w_rel
        kl_sum = torch.where(kl_valid, err, 0.0).sum()
        out[f"{prefix}/vae_kl"] = cfg.w_vae_kl * kl_sum / (kl_valid.sum() + _EPS)
        loss = loss + out[f"{prefix}/vae_kl"]

    if cfg.w_diffbar_reward > 0:
        rew = buffer.diffbar_reward
        r_valid = loss_valid & rew["diffbar_reward_valid"]
        r = torch.where(r_valid, rew["diffbar_reward"], 0.0)
        if w_rel is not None:
            r = r * w_rel[..., None]
        if cfg.temporal_discount > 0:
            tf = buffer.mask_teacher_forcing.float()
            cur, discs = torch.ones_like(tf[:, :, 0]), []
            for t in range(n_step):
                cur = tf[:, :, t] + (1.0 - tf[:, :, t]) * cur * cfg.temporal_discount
                discs.append(cur)
            r = r * torch.stack(discs, 2)
        cnt = r_valid.sum()
        out[f"{prefix}/diffbar_reward"] = cfg.w_diffbar_reward * r.sum() / (cnt + _EPS)
        for k in ("r_imitation_pos", "r_imitation_rot", "r_imitation_spd", "r_traffic_rule_approx"):
            out[f"{prefix}/dr_{k}"] = rew[k].sum() / (cnt + _EPS)
        loss = loss - out[f"{prefix}/diffbar_reward"]

    if navi_pred is not None and cfg.w_navi > 0:
        navi_valid = navi_pred.valid & loss_valid.any(-1)
        if isinstance(navi_pred, DestCategorical) and navi_gt.ndim == navi_pred.logits.ndim:
            navi_gt = torch.argmax(navi_gt, -1)  # one-hot command -> class index
        nll = torch.where(navi_valid, -navi_pred.log_prob(navi_gt), 0.0)
        if w_rel is not None:
            nll = nll * w_rel
        out[f"{prefix}/navi_loss"] = cfg.w_navi * nll.sum() / (navi_valid.sum() + _EPS)
        loss = loss + out[f"{prefix}/navi_loss"]

    if cfg.w_tl_state > 0:
        tl_valid = ~buffer.tl_state_nll_invalid
        nll = torch.where(tl_valid, buffer.tl_state_nll, 0.0)
        out[f"{prefix}/tl_state_loss"] = cfg.w_tl_state * nll.sum() / (tl_valid.sum() + _EPS)
        loss = loss + out[f"{prefix}/tl_state_loss"]

    out[f"{prefix}/loss"] = loss
    return loss, out
