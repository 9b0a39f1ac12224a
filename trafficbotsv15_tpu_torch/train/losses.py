"""Training loss (counterpart of `trafficbotsv15_tpu/train/losses.py::training_loss`).

Balanced CVAE KL with free nats, the differentiable reward (subtracted), the
navigation NLL and the TL-state NLL, masked as the JAX package masks them:
from `step_training_start` on, optionally relevant agents only (irrelevant
ones kept with probability `p_loss_for_irrelevant`, from uniform draws the
caller makes), optionally without teacher-forced steps, optionally weighted
towards relevant agents and discounted after teacher-forced steps.

Each term is a masked sum over its valid count, `sum / (count + eps)`. The
JAX package sums over the whole sharded batch; over several ranks
(`parallel/mesh.py`) the caller hands in `count_sum`, the sum of the detached
counts over the ranks, so that each rank's term is its own sum over the global
count: the ranks' terms then add up to the global term, and the sum of their
gradients is the global batch's gradient.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch

from trafficbotsv15_tpu_torch.config import TrainingMetricsCfg
from trafficbotsv15_tpu_torch.ops.distributions import DestCategorical, balanced_kl
from trafficbotsv15_tpu_torch.sim.rollout import RolloutBuffer

_EPS = 1e-8


def training_loss(cfg: TrainingMetricsCfg, buffer: RolloutBuffer, ag_role: torch.Tensor, navi_pred,
                  navi_gt: Optional[torch.Tensor], latent_post, latent_prior,
                  u_irrelevant: Optional[torch.Tensor] = None, prefix: str = "training",
                  count_sum: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """buffer leaves [n_sc, n_ag / n_tl, n_step, ...]; ag_role [n_sc, n_ag, 3]; u_irrelevant [n_sc, n_ag, 1]
    uniform draws, needed when 0 < p_loss_for_irrelevant < 1; count_sum(counts) -> the counts summed over the
    ranks (None: this process's batch is the whole batch). -> (loss, metrics)."""
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

    # each term as (name, weight, masked sum, index of its count); the counts are summed over the ranks at once
    terms: List[Tuple[str, float, torch.Tensor, int]] = []
    counts: List[torch.Tensor] = []
    if latent_post is not None and cfg.w_vae_kl > 0:
        kl_valid = latent_post.valid if cfg.kl_for_unseen_agent else latent_prior.valid
        kl_valid = kl_valid & loss_valid.any(-1)
        err = balanced_kl(latent_post, latent_prior, cfg.kl_balance_scale, cfg.kl_free_nats)
        if w_rel is not None:
            err = err * w_rel
        terms.append(("vae_kl", cfg.w_vae_kl, torch.where(kl_valid, err, 0.0).sum(), len(counts)))
        counts.append(kl_valid.sum())

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
        terms.append(("diffbar_reward", cfg.w_diffbar_reward, r.sum(), len(counts)))
        for k in ("r_imitation_pos", "r_imitation_rot", "r_imitation_spd", "r_traffic_rule_approx"):
            terms.append((f"dr_{k}", None, rew[k].sum(), len(counts)))
        counts.append(r_valid.sum())

    if navi_pred is not None and cfg.w_navi > 0:
        navi_valid = navi_pred.valid & loss_valid.any(-1)
        if isinstance(navi_pred, DestCategorical) and navi_gt.ndim == navi_pred.logits.ndim:
            navi_gt = torch.argmax(navi_gt.float(), -1)  # one-hot command -> class index (the first)
        nll = torch.where(navi_valid, -navi_pred.log_prob(navi_gt), 0.0)
        if w_rel is not None:
            nll = nll * w_rel
        terms.append(("navi_loss", cfg.w_navi, nll.sum(), len(counts)))
        counts.append(navi_valid.sum())

    if cfg.w_tl_state > 0:
        tl_valid = ~buffer.tl_state_nll_invalid
        nll = torch.where(tl_valid, buffer.tl_state_nll, 0.0)
        terms.append(("tl_state_loss", cfg.w_tl_state, nll.sum(), len(counts)))
        counts.append(tl_valid.sum())

    if counts and count_sum is not None:
        counts = list(count_sum(torch.stack(counts)).unbind())
    out: Dict[str, torch.Tensor] = {}
    loss = torch.zeros((), device=dev)
    for name, weight, total, i in terms:
        out[f"{prefix}/{name}"] = (total if weight is None else weight * total) / (counts[i] + _EPS)
        if name == "diffbar_reward":
            loss = loss - out[f"{prefix}/{name}"]
        elif weight is not None:
            loss = loss + out[f"{prefix}/{name}"]
    out[f"{prefix}/loss"] = loss
    return loss, out
