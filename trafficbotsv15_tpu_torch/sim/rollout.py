"""Closed-loop rollout as a Python step loop (counterpart of `trafficbotsv15_tpu/sim/rollout.py`).

The JAX `lax.scan` becomes a loop over a carry; each step's outputs are
stacked at the end with the step axis at dim 2, as in the JAX buffer. The
slice runs the joint-future flavour: TL from the pre-pass, deterministic
actions, no training signal. Training rollouts (sampled actions, remat,
dropout, `diffbar_reward` from `sim/rewards.py`) and the player override
come with later slices; `pred_navi_after_reached`, the in-rollout TL path
and token dedup raise where the config asks for them.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from trafficbotsv15_tpu_torch.config import ExperimentCfg
from trafficbotsv15_tpu_torch.models.tokens import MapTokens, TlTokens
from trafficbotsv15_tpu_torch.sim import dynamics as dyn
from trafficbotsv15_tpu_torch.sim.rule_checker import RuleCheckerState, RuleCheckerStatics, check_rules
from trafficbotsv15_tpu_torch.sim.teacher_forcing import check_error_reset
from trafficbotsv15_tpu_torch.sim.tl_prepass import pad_steps


@dataclasses.dataclass
class RolloutBuffer:
    """Stacked rollout outputs, step axis at dim 2."""

    pred_valid: torch.Tensor  # [n_sc, n_ag, n_step]
    pred_pose: torch.Tensor  # [n_sc, n_ag, n_step, 3]
    pred_motion: torch.Tensor  # [n_sc, n_ag, n_step, 3]
    pred_action: torch.Tensor  # [n_sc, n_ag, n_step, 2] bounded (acc, yaw_rate)
    action_log_prob: torch.Tensor  # [n_sc, n_ag, n_step]
    tl_state_nll: torch.Tensor  # [n_sc, n_tl, n_step]
    tl_state_nll_invalid: torch.Tensor  # [n_sc, n_tl, n_step]
    mask_teacher_forcing: torch.Tensor  # [n_sc, n_ag, n_step]
    violation: Dict[str, torch.Tensor]  # each [n_sc, n_ag, n_step]
    tl_state: torch.Tensor  # [n_sc, n_tl, n_step, 5]
    navi_log_prob: torch.Tensor  # [n_sc, n_ag, 1]
    navi_log_prob_valid: torch.Tensor  # [n_sc, n_ag, 1]
    log_prob: Optional[torch.Tensor] = None  # [n_sc, n_ag] joint-future scores

    def flatten_joint_future(self, k: int) -> "RolloutBuffer":
        """[n_sc * k, ...] -> [n_sc, k, ...] on every tensor."""
        def r(x):
            if x is None:
                return None
            if isinstance(x, dict):
                return {key: r(v) for key, v in x.items()}
            return x.reshape(x.shape[0] // k, k, *x.shape[1:])
        return RolloutBuffer(**{f.name: r(getattr(self, f.name)) for f in dataclasses.fields(self)})


def compute_log_prob(buffer: RolloutBuffer, latent_log_prob: Optional[torch.Tensor]) -> RolloutBuffer:
    """Joint-future scores from the navi and latent log probs."""
    valid = buffer.navi_log_prob_valid
    lp = torch.sum(buffer.navi_log_prob * valid, -1)
    denom = valid.sum(-1)
    lp = torch.where(denom > 0, lp / denom.clamp_min(1), 0.0)
    if latent_log_prob is not None:
        lp = lp + latent_log_prob.reshape(lp.shape)
    return dataclasses.replace(buffer, log_prob=lp)


@torch.no_grad()
def rollout(model, cfg: ExperimentCfg, mp_tokens: MapTokens, tl_tokens: TlTokens, *,
            ag_attr, ag_type, ag_size, ag_latent, ag_latent_valid, ag_navi, ag_navi_valid, ag_navi_log_prob,
            gt_valid, gt_pose, gt_motion, gt_tl_state, ag_forcing,
            rule_statics: RuleCheckerStatics, rule_state0: RuleCheckerState, check_level: int,
            tl_precomputed: Dict[str, torch.Tensor], tf_cfg=None) -> RolloutBuffer:
    """Run the closed-loop simulation from step 1 to cfg.time_step_end inclusive.

    gt_* cover the first T steps ([n_sc, n_ag, T]); ag_forcing is the
    precomputed teacher-forcing mask over them. tl_precomputed holds the
    pre-pass outputs over the un-replicated scenarios (n_sc_u divides n_sc).
    """
    if tl_precomputed is None:
        raise NotImplementedError("the in-rollout TL path is out of this slice: run the TL pre-pass")
    if cfg.pred_navi_after_reached:
        raise NotImplementedError("pred_navi_after_reached is out of this slice")
    if cfg.rollout_token_dedup:
        raise NotImplementedError("rollout_token_dedup is out of this slice")
    tf_cfg = cfg.teacher_forcing_training if tf_cfg is None else tf_cfg
    check_error_reset(tf_cfg)
    n_step_roll = cfg.time_step_end
    n_sc, n_ag, t_gt = gt_valid.shape
    w = max(cfg.model.temp_window_size, 1)
    n_sc_u = tl_precomputed["feature"].shape[1]
    if n_sc % n_sc_u or tl_precomputed["feature"].shape[0] != n_step_roll:
        raise ValueError("TL pre-pass batch must divide the rollout batch and cover every rollout step")
    tl_rep = n_sc // n_sc_u

    tf_valid = pad_steps(ag_forcing, n_step_roll, False)
    tf_pose = pad_steps(gt_pose, n_step_roll)
    tf_motion = pad_steps(gt_motion, n_step_roll)
    gt_valid_s = pad_steps(gt_valid, n_step_roll, False)
    t_tl = gt_tl_state.shape[2]
    dev = gt_valid.device

    valid = gt_valid[:, :, 0]
    disabled = torch.zeros((n_sc, n_ag), dtype=torch.bool, device=dev)
    pose, motion = gt_pose[:, :, 0], gt_motion[:, :, 0]
    hist_valid = torch.zeros((n_sc, n_ag, w), dtype=torch.bool, device=dev)
    hist_pose = torch.zeros((n_sc, n_ag, w, 3), dtype=gt_pose.dtype, device=dev)
    hist_motion = torch.zeros((n_sc, n_ag, w, 3), dtype=gt_motion.dtype, device=dev)
    hist_step_invalid = torch.ones(w, dtype=torch.bool, device=dev)
    rule_state, navi, navi_valid = rule_state0, ag_navi, ag_navi_valid
    navi_mode = cfg.model.navi_mode

    outs = {k: [] for k in ("pred_valid", "pred_pose", "pred_motion", "pred_action", "action_log_prob",
                            "mask_teacher_forcing", "violation")}
    for i in range(n_step_roll):
        hist_valid = torch.cat([hist_valid[:, :, 1:], valid[:, :, None]], 2)
        hist_pose = torch.cat([hist_pose[:, :, 1:], pose[:, :, None]], 2)
        hist_motion = torch.cat([hist_motion[:, :, 1:], motion[:, :, None]], 2)
        hist_step_invalid = torch.cat([hist_step_invalid[1:], hist_step_invalid.new_zeros(1)])
        tl_feature = tl_precomputed["feature"][i]
        tl_state = tl_precomputed["state"][i]
        if tl_rep > 1:
            tl_feature = torch.repeat_interleave(tl_feature, tl_rep, 0)
            tl_state = torch.repeat_interleave(tl_state, tl_rep, 0)

        action_dist = model.step(valid, hist_valid, hist_pose, hist_motion, ag_attr, ag_type, ag_latent,
                                 ag_latent_valid, navi, navi_valid, tl_tokens, mp_tokens, tl_feature)
        action = action_dist.mean  # deterministic action
        action_log_prob = torch.where(valid, action_dist.log_prob(action), 0.0)
        pred_pose, pred_motion, action_bounded = dyn.step_dynamics(pose, motion, valid, action, ag_type,
                                                                   cfg.dynamics)
        pred_valid = valid
        force = tf_valid[:, :, i]
        ov_valid, ov_pose, ov_motion = dyn.override_ag(pred_valid, pred_pose, pred_motion, disabled, force,
                                                       tf_pose[:, :, i], tf_motion[:, :, i])
        # rule checking on the pre-override prediction
        rule_state, violations = check_rules(rule_statics, rule_state, pred_valid, pred_pose, pred_motion,
                                             tl_state, check_level)
        step_gt_valid = gt_valid_s[:, :, i] & (i + 1 < t_gt)
        valid, disabled = dyn.disable_outside_map(ov_valid, disabled, violations["outside_map_this_step"],
                                                  step_gt_valid)
        pose, motion = ov_pose, ov_motion
        if navi_mode == "dest":
            reached = violations["dest_reached_this_step"]
        elif navi_mode == "goal":
            reached = violations["goal_reached_this_step"]
        else:
            reached = torch.zeros_like(valid)
        navi, navi_valid = dyn.update_navi_on_reached(navi, navi_valid, reached)

        for key, val in (("pred_valid", pred_valid), ("pred_pose", pred_pose), ("pred_motion", pred_motion),
                         ("pred_action", action_bounded), ("action_log_prob", action_log_prob),
                         ("mask_teacher_forcing", force), ("violation", violations)):
            outs[key].append(val)

    def stack(seq):
        return torch.stack(seq, 2)

    # TL NLL and state trajectory from the pre-pass, over all steps at once
    logits = torch.repeat_interleave(tl_precomputed["logits"], tl_rep, 1)
    state_pre = torch.repeat_interleave(tl_precomputed["state"], tl_rep, 1)
    gt_tl_idx = torch.argmax(pad_steps(gt_tl_state, n_step_roll, 0).float(), -1).movedim(2, 0)
    tl_avail = torch.arange(1, n_step_roll + 1, device=dev) < t_tl
    nll = -torch.gather(torch.log_softmax(logits, -1), -1, gt_tl_idx[..., None])[..., 0]
    nll = torch.where(tl_avail[:, None, None], nll, 0.0)
    nll_invalid = tl_tokens.invalid[None] | ~tl_avail[:, None, None]

    def to_buffer(x):  # step axis first -> dim 2
        return x.movedim(0, 2)

    return RolloutBuffer(
        pred_valid=stack(outs["pred_valid"]),
        pred_pose=stack(outs["pred_pose"]),
        pred_motion=stack(outs["pred_motion"]),
        pred_action=stack(outs["pred_action"]),
        action_log_prob=stack(outs["action_log_prob"]),
        tl_state_nll=to_buffer(nll),
        tl_state_nll_invalid=to_buffer(nll_invalid),
        mask_teacher_forcing=stack(outs["mask_teacher_forcing"]),
        violation={k: stack([v[k] for v in outs["violation"]]) for k in outs["violation"][0]},
        tl_state=to_buffer(state_pre),
        navi_log_prob=ag_navi_log_prob[..., None],
        navi_log_prob_valid=ag_navi_valid[..., None],
    )
