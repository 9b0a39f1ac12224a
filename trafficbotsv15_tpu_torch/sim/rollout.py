"""Closed-loop rollout as a Python step loop (counterpart of `trafficbotsv15_tpu/sim/rollout.py`).

The JAX `lax.scan` becomes a loop over a carry; each step's outputs are
stacked at the end with the step axis at dim 2, as in the JAX buffer. Two
flavours:
  - `rollout`, evaluation (joint-future prediction, reactive replay): no
    gradients, deterministic actions, rule checks at the caller's level,
    `diffbar_reward` in the buffer where the caller asks for it (reactive
    replay's validation loss reads it; joint-future prediction leaves it
    None and runs no reward ops);
  - `rollout_train`, training: gradients through the dynamics chain (the
    history window the encoders read is detached under
    `training_detach_model_input`), rule checks at level 0 on detached
    states, `diffbar_reward` in the buffer, dropout from one seed per step,
    and `torch.utils.checkpoint` around each step unless `remat_policy` is
    "none" (the whole step is recomputed in the backward pass; JAX's
    "names" / "names+kv" save lists are not ported).
Both apply the teacher-forcing config's error-threshold reset
(`sim/teacher_forcing.py::error_reset_mask`) where it sets a threshold. Both
take JAX's optional player override: `player_valid` [n_sc, n_ag, n_step_roll]
and `player_action` [n_sc, n_ag, n_step_roll, 2] (bounded acc, yaw_rate)
script the marked agents step by step; the action is replaced after it is
sampled and its log-prob taken, so the log-prob stays the policy's own.

K-futures token dedup (`rollout(token_rep=K)`, which `train/evaluation.py`
asks for under `rollout_token_dedup`, as JAX's `joint_future_pred` does): the
map and TL tokens and the pre-pass's TL feature stay the unique scenarios'
[n_sc // K, ...], and each step's map and TL selections and gathers read them
(`models/agent_encoder.py`); the TL state the rule checker reads, the
TL-state NLL and its mask repeat to the rollout's batch. It needs the TL
pre-pass and no navi re-prediction, and gives the replicated rollout's result.

With `pred_navi_after_reached` (dest and goal modes, as in JAX) the navi
predictor runs inside every step on the step's history window: its draw
(always sampled) replaces the navi of the agents that reached theirs this
step, the rule checker's destination statics or goal follow it and its
reached flag clears, and the buffer's `navi_log_prob` / `navi_log_prob_valid`
gain one entry per step ([n_sc, n_ag, 1 + n_step]: the draw's log-prob where
an agent re-predicted). Each rollout takes its draws from one `navi_draw(dist,
i)` (`navi_draws`): a generator's, the step's dropout stream (`rollout_train`'s
default), or noise handed in per step (`DiagGaussian` / `DestCategorical.noise`'s
form).

TL takes one of two paths, as in JAX:
  - the pre-pass (`tl_precomputed`, HPTR mode with `tl_prepass`): a pass made
    before the loop (`sim/tl_prepass.py::tl_rollout_scan`) hands each step
    its TL feature and state; `_tl_outputs` takes the TL-state NLL from its
    logits over all steps at once;
  - in the rollout (`tl_precomputed=None`: the TrafficBots RNN family, and
    HPTR with `tl_prepass=False`): each step pushes the TL state into the
    carry's TL window, `model.step` runs the TL encoder and state predictor
    on it, the next state is the log's where `tl_forcing` forces it and the
    log has the step, else the one-hot argmax of the logits, and the step's
    NLL against the log goes into the buffer.
In RNN mode (temp_window_size <= 0) the agent encoder's and the TL state
predictor's GRU hiddens ride in the carry from zeros.
Past the GT horizon (`time_step_end` >= T) nothing is forced or reset,
`step_gt_valid` and so the reward are off, and the TL-state NLL is masked
off (`tl_state_nll_invalid` true) as JAX's `tl_avail` does.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence

import torch
from torch.utils.checkpoint import checkpoint

from trafficbotsv15_tpu_torch.config import ExperimentCfg
from trafficbotsv15_tpu_torch.models.tokens import MapTokens, TlTokens
from trafficbotsv15_tpu_torch.ops.dropout import dropout_scope
from trafficbotsv15_tpu_torch.ops.dropout import generator as dropout_generator
from trafficbotsv15_tpu_torch.ops.dropout import normal as dropout_normal
from trafficbotsv15_tpu_torch.sim import dynamics as dyn
from trafficbotsv15_tpu_torch.sim.rewards import diffbar_reward
from trafficbotsv15_tpu_torch.sim.rule_checker import (RuleCheckerState, RuleCheckerStatics, check_rules,
                                                      dest_statics_from_navi)
from trafficbotsv15_tpu_torch.sim.teacher_forcing import error_reset_mask
from trafficbotsv15_tpu_torch.sim.tl_prepass import pad_steps

# re-prediction's draw: (navi distribution, rollout step) -> the noise its sample is made from
NaviDraw = Callable[[object, int], torch.Tensor]


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
    navi_log_prob: torch.Tensor  # [n_sc, n_ag, 1], [n_sc, n_ag, 1 + n_step] with re-prediction
    navi_log_prob_valid: torch.Tensor  # as navi_log_prob
    log_prob: Optional[torch.Tensor] = None  # [n_sc, n_ag] joint-future scores
    diffbar_reward: Optional[Dict[str, torch.Tensor]] = None  # training, reactive replay: each [n_sc, n_ag, n_step]

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
            tl_precomputed: Optional[Dict[str, torch.Tensor]] = None, tl_forcing: Optional[torch.Tensor] = None,
            tf_cfg=None, with_reward: bool = False,
            player_valid: Optional[torch.Tensor] = None, player_action: Optional[torch.Tensor] = None,
            navi_update_inputs: Optional[Dict[str, torch.Tensor]] = None,
            navi_draw: Optional[NaviDraw] = None, token_rep: int = 1) -> RolloutBuffer:
    """Run the closed-loop simulation from step 1 to cfg.time_step_end inclusive.

    gt_* cover the first T steps ([n_sc, n_ag, T]); ag_forcing is the
    precomputed teacher-forcing mask over them. tl_precomputed holds the
    pre-pass outputs over the un-replicated scenarios (n_sc_u divides n_sc);
    without it TL runs in the rollout, forced to gt_tl_state where tl_forcing
    [n_sc, n_tl, T_tl] says so, and tl_tokens must carry every encoder field
    of the rollout's batch (`TlTokens.repeat`).
    with_reward fills `diffbar_reward` (the JAX eval rollout always does).
    player_valid / player_action, if given, script the agents they mark at each step.
    With re-prediction (`repredicts(cfg)`) navi_update_inputs holds the map arrays of the rollout's batch
    (`navi_map_arrays`) and navi_draw gives each step's draws (`navi_draws`).
    token_rep > 1: mp_tokens and tl_tokens hold the unique scenarios (token dedup, see the module docstring).
    """
    tf_cfg = cfg.teacher_forcing_training if tf_cfg is None else tf_cfg
    n_step_roll = cfg.time_step_end
    n_sc, n_ag, t_gt = gt_valid.shape
    tl_rep = _check_rollout_cfg(cfg, tl_precomputed, tl_forcing, n_sc, n_step_roll)
    _check_token_rep(cfg, token_rep, tl_rep, mp_tokens, n_sc)
    w = max(cfg.model.temp_window_size, 1)

    tf_valid = pad_steps(ag_forcing, n_step_roll, False)
    tf_pose = pad_steps(gt_pose, n_step_roll)
    tf_motion = pad_steps(gt_motion, n_step_roll)
    gt_valid_s = pad_steps(gt_valid, n_step_roll, False)
    reset = _error_reset(tf_cfg, gt_valid, gt_pose, gt_motion, n_step_roll)
    tl_in = None if tl_precomputed is not None else _TlInRollout(gt_tl_state, tl_forcing, tl_tokens, n_step_roll)
    dev = gt_valid.device

    valid = gt_valid[:, :, 0]
    disabled = torch.zeros((n_sc, n_ag), dtype=torch.bool, device=dev)
    pose, motion = gt_pose[:, :, 0], gt_motion[:, :, 0]
    hist_valid = torch.zeros((n_sc, n_ag, w), dtype=torch.bool, device=dev)
    hist_pose = torch.zeros((n_sc, n_ag, w, 3), dtype=gt_pose.dtype, device=dev)
    hist_motion = torch.zeros((n_sc, n_ag, w, 3), dtype=gt_motion.dtype, device=dev)
    hist_step_invalid = torch.ones(w, dtype=torch.bool, device=dev)
    tl_state, hist_tl = _tl_carry0(gt_tl_state, w, tl_in)
    rnn_hidden, tl_rnn_hidden = _rnn_hidden0(cfg, n_sc, n_ag, gt_tl_state.shape[1], dev)
    rule_state, navi, navi_valid = rule_state0, ag_navi, ag_navi_valid
    navi_mode = cfg.model.navi_mode
    draw = _repredict_draw(cfg, navi_update_inputs, navi_draw)

    outs = {k: [] for k in ("pred_valid", "pred_pose", "pred_motion", "pred_action", "action_log_prob",
                            "mask_teacher_forcing", "violation", "diffbar_reward", "tl", "navi")}
    for i in range(n_step_roll):
        hist_valid = torch.cat([hist_valid[:, :, 1:], valid[:, :, None]], 2)
        hist_pose = torch.cat([hist_pose[:, :, 1:], pose[:, :, None]], 2)
        hist_motion = torch.cat([hist_motion[:, :, 1:], motion[:, :, None]], 2)
        hist_step_invalid = torch.cat([hist_step_invalid[1:], hist_step_invalid.new_zeros(1)])
        tl_feature, tl_state_pre = _tl_pre_step(tl_precomputed, tl_rep, i, token_rep)
        if tl_in is not None:
            hist_tl = torch.cat([hist_tl[:, :, 1:], tl_state[:, :, None]], 2)

        action_dist, tl_logits, rnn_hidden, tl_rnn_hidden = model.step(
            valid, hist_valid, hist_pose, hist_motion, ag_attr, ag_type, ag_latent, ag_latent_valid, navi,
            navi_valid, tl_tokens, mp_tokens, tl_feature, hist_tl_state=hist_tl, hist_step_invalid=hist_step_invalid,
            rnn_hidden=rnn_hidden, tl_rnn_hidden=tl_rnn_hidden, token_rep=token_rep)
        if tl_in is None:
            tl_state = tl_state_pre
        else:
            tl_state, tl_out = tl_in.step(i, tl_logits)
            outs["tl"].append(tl_out)
        action = action_dist.mean  # deterministic action
        action_log_prob = torch.where(valid, action_dist.log_prob(action), 0.0)
        pred_pose, pred_motion, action_bounded = dyn.step_dynamics(pose, motion, valid, action, ag_type, cfg.dynamics,
                                                                   _player(player_valid, player_action, i))
        pred_valid = valid
        force = tf_valid[:, :, i] if reset is None else tf_valid[:, :, i] | reset(i, valid, pose, motion)
        ov_valid, ov_pose, ov_motion = dyn.override_ag(pred_valid, pred_pose, pred_motion, disabled, force,
                                                       tf_pose[:, :, i], tf_motion[:, :, i])
        # rule checking on the pre-override prediction
        rule_state, violations = check_rules(rule_statics, rule_state, pred_valid, pred_pose, pred_motion,
                                             tl_state, check_level)
        step_gt_valid = gt_valid_s[:, :, i] & (i + 1 < t_gt)
        if with_reward:
            outs["diffbar_reward"].append(diffbar_reward(cfg.reward, pred_valid, pred_pose, pred_motion, step_gt_valid,
                                                         tf_pose[:, :, i], tf_motion[:, :, i], ag_size))
        valid, disabled = dyn.disable_outside_map(ov_valid, disabled, violations["outside_map_this_step"],
                                                  step_gt_valid)
        pose, motion = ov_pose, ov_motion
        navi, navi_valid, rule_statics, rule_state, navi_out = _navi_step(
            model, navi_mode, draw, i, _navi_reached(navi_mode, violations, valid), navi, navi_valid, rule_statics,
            rule_state, navi_update_inputs, (hist_valid, ag_attr, hist_motion, hist_pose, ag_type, mp_tokens))
        if navi_out is not None:
            outs["navi"].append(navi_out)

        for key, val in (("pred_valid", pred_valid), ("pred_pose", pred_pose), ("pred_motion", pred_motion),
                         ("pred_action", action_bounded), ("action_log_prob", action_log_prob),
                         ("mask_teacher_forcing", force), ("violation", violations)):
            outs[key].append(val)

    tl_outs = outs.pop("tl")
    buf = (_tl_outputs(tl_precomputed, tl_rep, gt_tl_state, tl_tokens, n_step_roll, token_rep) if tl_in is None
           else _stack_dicts(tl_outs))
    reward = outs.pop("diffbar_reward")
    navi_outs = outs.pop("navi")
    return RolloutBuffer(**{k: _stack(outs[k]) for k in outs if k != "violation"}, **buf,
                         violation=_stack_dicts(outs["violation"]),
                         diffbar_reward=_stack_dicts(reward) if reward else None,
                         **_navi_log_probs(ag_navi_log_prob, ag_navi_valid, navi_outs))


def repredicts(cfg: ExperimentCfg) -> bool:
    """Whether the rollout re-predicts the navi of the agents that reached theirs (JAX: dest and goal modes)."""
    return bool(cfg.pred_navi_after_reached) and cfg.model.navi_mode in ("dest", "goal")


def navi_map_arrays(cfg: ExperimentCfg, batch: Dict[str, torch.Tensor], k: int = 1):
    """The map arrays re-prediction derives new destination statics from (None without re-prediction), each
    repeated k times along the scenario axis for K joint futures."""
    if not repredicts(cfg):
        return None
    r = lambda x: torch.repeat_interleave(x, k, 0) if k > 1 else x  # noqa: E731
    return dict(mp_valid=r(batch["map/valid"]), mp_type=r(batch["map/type"]).bool(), mp_pos=r(batch["map/pos"]),
                mp_dir=r(batch["map/dir"]))


def navi_draws(generator: Optional[torch.Generator] = None,
               noise: Optional[Sequence[torch.Tensor]] = None) -> NaviDraw:
    """Re-prediction's draw function (dist, step) -> noise: noise[step] where noise is given, else the distribution's
    noise from generator (None: the step's dropout stream, inside `rollout_train`'s per-step scope)."""
    if noise is None:
        return lambda dist, i: dist.noise(dropout_generator() if generator is None else generator)

    def given(dist, i):
        if i >= len(noise):
            raise ValueError(f"navi_noise has {len(noise)} steps; the rollout asks for step {i}")
        return noise[i]

    return given


def _navi_step(model, navi_mode: str, draw: Optional[NaviDraw], i: int, reached, navi, navi_valid,
               statics: RuleCheckerStatics, rule_state: RuleCheckerState, update_inputs, predictor_inputs):
    """Step i's navi after its rule checks: the reached agents' navi turns invalid, or with a draw (re-prediction)
    the predictor's draw on the step's history window (predictor_inputs, `predict_navi`'s) replaces it. -> (navi,
    navi_valid, statics, rule_state, (the draw's log-prob, reached) or None)."""
    if draw is None:
        return (*dyn.update_navi_on_reached(navi, navi_valid, reached), statics, rule_state, None)
    navi_dist = model.predict_navi(*predictor_inputs)
    navi, navi_valid, statics, rule_state, log_prob = repredict_navi(
        navi_mode, navi_dist, draw(navi_dist, i), navi, navi_valid, reached, statics, rule_state, update_inputs)
    return navi, navi_valid, statics, rule_state, (log_prob, reached)


def repredict_navi(navi_mode: str, navi_dist, noise, navi, navi_valid, reached, statics: RuleCheckerStatics,
                   rule_state: RuleCheckerState, update_inputs: Dict[str, torch.Tensor]):
    """One step's re-prediction: the draw of navi_dist for `noise` replaces the navi of the `reached` agents and
    makes it valid; the rule checker's destination statics (dest) or goal (goal) follow it and its reached flag
    clears for them. -> (navi, navi_valid, statics, rule_state, the draw's log-prob where reached, else 0)."""
    sample = navi_dist.rsample(noise)
    log_prob = navi_dist.log_prob(sample.detach())
    navi, navi_valid = dyn.update_navi_on_reached(navi, navi_valid, reached, sample)
    if navi_mode == "dest":
        new = dest_statics_from_navi(navi, **update_inputs)
        new = {k: torch.where(reached.reshape(reached.shape + (1,) * (v.ndim - 2)), v, getattr(statics, k))
               for k, v in new.items()}
        statics = dataclasses.replace(statics, **new)
        rule_state = dataclasses.replace(rule_state, dest_reached=rule_state.dest_reached & ~reached)
    else:
        statics = dataclasses.replace(statics, ag_goal=torch.where(reached[..., None], navi, statics.ag_goal))
        rule_state = dataclasses.replace(rule_state, goal_reached=rule_state.goal_reached & ~reached)
    return navi, navi_valid, statics, rule_state, torch.where(reached, log_prob, 0.0)


def _navi_log_probs(ag_navi_log_prob, ag_navi_valid, step_log_probs) -> Dict[str, torch.Tensor]:
    """The buffer's navi log-probs: the rollout's initial navi, then each re-predicting step's, by step."""
    lp, valid = [ag_navi_log_prob[..., None]], [ag_navi_valid[..., None]]
    if step_log_probs:
        lp.append(_stack([s[0] for s in step_log_probs]))
        valid.append(_stack([s[1] for s in step_log_probs]))
    return dict(navi_log_prob=torch.cat(lp, -1), navi_log_prob_valid=torch.cat(valid, -1))


class _TlInRollout:
    """The in-rollout TL path's per-step inputs: the forcing masks and log states, slid to rollout steps."""

    def __init__(self, gt_tl_state, tl_forcing, tl_tokens: TlTokens, n_step_roll: int):
        self.t_tl = gt_tl_state.shape[2]
        self.forcing = pad_steps(tl_forcing, n_step_roll, False)
        self.gt = pad_steps(gt_tl_state, n_step_roll, 0)
        self.gt_idx = torch.argmax(self.gt.float(), -1)
        self.invalid = tl_tokens.invalid

    def step(self, i: int, tl_logits):
        """Rollout step i's next TL state (float) and its buffer entries: the log's where it is forced and
        available (`tl_avail`: i + 1 < T_tl), else the one-hot argmax; the NLL of the log's state."""
        avail = i + 1 < self.t_tl
        state = dyn.override_tl(tl_logits, self.forcing[:, :, i] & avail, self.gt[:, :, i]).float()
        nll = -torch.gather(torch.log_softmax(tl_logits, -1), -1, self.gt_idx[:, :, i, None])[..., 0]
        if not avail:
            nll = torch.zeros_like(nll)
        return state, dict(tl_state_nll=nll, tl_state_nll_invalid=self.invalid | (not avail), tl_state=state)


def _tl_carry0(gt_tl_state, w: int, tl_in):
    """The TL state at step 0 and an empty TL window (both None on the pre-pass path)."""
    if tl_in is None:
        return None, None
    n_sc, n_tl = gt_tl_state.shape[:2]
    return gt_tl_state[:, :, 0].float(), torch.zeros((n_sc, n_tl, w, 5), device=gt_tl_state.device)


def _tl_pre_step(tl_precomputed, tl_rep: int, i: int, token_rep: int = 1):
    """Step i's TL feature and state from the pre-pass, repeated to the rollout batch (the feature stays the unique
    scenarios' under token dedup); (None, None) without it."""
    if tl_precomputed is None:
        return None, None
    feature, state = tl_precomputed["feature"][i], tl_precomputed["state"][i]
    if tl_rep > 1:
        state = torch.repeat_interleave(state, tl_rep, 0)
        if token_rep == 1:
            feature = torch.repeat_interleave(feature, tl_rep, 0)
    return feature, state


def _rnn_hidden0(cfg: ExperimentCfg, n_sc: int, n_ag: int, n_tl: int, dev):
    """Zero GRU hiddens of the agent encoder and the TL state predictor in RNN mode (float32), else None."""
    m = cfg.model
    if m.temp_window_size > 0:
        return None, None
    return (torch.zeros((m.mp_encoder.pl_encoder.n_layer, n_sc, n_ag, m.hidden_dim), device=dev),
            torch.zeros((m.tl_state_predictor.n_layer, n_sc, n_tl, m.hidden_dim), device=dev))


def _navi_reached(navi_mode: str, violations, valid):
    if navi_mode == "dest":
        return violations["dest_reached_this_step"]
    if navi_mode == "goal":
        return violations["goal_reached_this_step"]
    return torch.zeros_like(valid)


def _player(player_valid, player_action, i: int):
    """Step i's player override for `dyn.step_dynamics`, or None without one."""
    if player_valid is None:
        return None
    return {"valid": player_valid[:, :, i], "action": player_action[:, :, i]}


def _stack(seq):
    return torch.stack(seq, 2)


def _stack_dicts(seq):
    """Per-step dicts of tensors -> one dict of tensors stacked at dim 2."""
    return {k: _stack([d[k] for d in seq]) for k in seq[0]}


def _error_reset(tf_cfg, gt_valid, gt_pose, gt_motion, n_step_roll: int):
    """None when tf_cfg sets no error threshold, else reset(i, valid, pose, motion) -> the agents that
    rollout step i forces back to the log: the carry (the state after step i - 1's override, without
    gradient) against the log at that step, within the log's horizon. Comparing the freshly integrated
    state with the previous step's log would count speed * dt as error and reset every fast agent."""
    if tf_cfg.threshold_xy <= 0 and tf_cfg.threshold_yaw <= 0 and tf_cfg.threshold_spd <= 0:
        return None
    t_gt = gt_valid.shape[2]
    prev_valid = pad_steps(torch.roll(gt_valid, 1, 2), n_step_roll, False)
    prev_pose = pad_steps(torch.roll(gt_pose, 1, 2), n_step_roll)
    prev_motion = pad_steps(torch.roll(gt_motion, 1, 2), n_step_roll)

    def reset(i, valid, pose, motion):
        mask = error_reset_mask(tf_cfg, valid, pose.detach(), motion.detach(), prev_valid[:, :, i],
                                prev_pose[:, :, i], prev_motion[:, :, i])
        return mask & (i + 1 < t_gt)

    return reset


def _repredict_draw(cfg: ExperimentCfg, update_inputs, draw: Optional[NaviDraw]) -> Optional[NaviDraw]:
    """The rollout's re-prediction draw, None where it does not re-predict (`repredicts`); raises where it would
    lack its map arrays or its draws."""
    if not repredicts(cfg):
        return None
    if update_inputs is None:
        raise ValueError("pred_navi_after_reached needs the map arrays (navi_update_inputs)")
    if draw is None:
        raise ValueError("pred_navi_after_reached needs a navi_draw (a generator or navi_noise, `navi_draws`)")
    return draw


def _check_token_rep(cfg: ExperimentCfg, token_rep: int, tl_rep: int, mp_tokens: MapTokens, n_sc: int) -> None:
    """Raise where token dedup's inputs do not fit: it needs the pre-pass at the same replication and no navi
    re-prediction (JAX's asserts), and map tokens of the unique scenarios."""
    if token_rep == 1:
        return
    if token_rep != tl_rep:
        raise ValueError(f"token dedup needs the TL pre-pass over the unique scenarios (token_rep {token_rep}, "
                         f"pre-pass replication {tl_rep})")
    if repredicts(cfg):
        raise ValueError("token dedup does not run the in-rollout navi predictor: pred_navi_after_reached replicates")
    if mp_tokens.feature.shape[0] * token_rep != n_sc:
        raise ValueError(f"unique map batch {mp_tokens.feature.shape[0]} x {token_rep} != rollout batch {n_sc}")


def _check_rollout_cfg(cfg: ExperimentCfg, tl_precomputed, tl_forcing, n_sc: int, n_step_roll: int) -> int:
    """Raise for TL inputs that do not fit; -> how often each pre-pass scenario repeats (1 on the in-rollout TL
    path)."""
    if tl_precomputed is None:
        if tl_forcing is None:
            raise ValueError("the in-rollout TL path needs tl_forcing")
        return 1
    if cfg.model.temp_window_size <= 0:
        raise ValueError("the TL pre-pass needs HPTR mode: in RNN mode TL runs in the rollout")
    n_sc_u = tl_precomputed["feature"].shape[1]
    if n_sc % n_sc_u or tl_precomputed["feature"].shape[0] != n_step_roll:
        raise ValueError("TL pre-pass batch must divide the rollout batch and cover every rollout step")
    return n_sc // n_sc_u


def _tl_outputs(tl_precomputed, tl_rep: int, gt_tl_state, tl_tokens: TlTokens, n_step_roll: int,
                token_rep: int = 1):
    """TL NLL and state trajectory from the pre-pass, over all steps at once (buffer layout); under token dedup
    tl_tokens are the unique scenarios', their mask repeated to the rollout batch."""
    dev = gt_tl_state.device
    t_tl = gt_tl_state.shape[2]
    logits = torch.repeat_interleave(tl_precomputed["logits"], tl_rep, 1)
    state_pre = torch.repeat_interleave(tl_precomputed["state"], tl_rep, 1)
    gt_tl_idx = torch.argmax(pad_steps(gt_tl_state, n_step_roll, 0).float(), -1).movedim(2, 0)
    tl_avail = torch.arange(1, n_step_roll + 1, device=dev) < t_tl
    nll = -torch.gather(torch.log_softmax(logits, -1), -1, gt_tl_idx[..., None])[..., 0]
    nll = torch.where(tl_avail[:, None, None], nll, 0.0)
    nll_invalid = torch.repeat_interleave(tl_tokens.invalid, token_rep, 0)[None] | ~tl_avail[:, None, None]
    return dict(tl_state_nll=nll.movedim(0, 2), tl_state_nll_invalid=nll_invalid.movedim(0, 2),
                tl_state=state_pre.movedim(0, 2))


def rollout_train(model, cfg: ExperimentCfg, mp_tokens: MapTokens, tl_tokens: TlTokens, *,
                  ag_attr, ag_type, ag_size, ag_latent, ag_latent_valid, ag_navi, ag_navi_valid, ag_navi_log_prob,
                  gt_valid, gt_pose, gt_motion, gt_tl_state, ag_forcing,
                  rule_statics: RuleCheckerStatics, rule_state0: RuleCheckerState,
                  step_seeds: Sequence[int], tl_precomputed: Optional[Dict[str, torch.Tensor]] = None,
                  tl_forcing: Optional[torch.Tensor] = None,
                  player_valid: Optional[torch.Tensor] = None,
                  player_action: Optional[torch.Tensor] = None,
                  navi_update_inputs: Optional[Dict[str, torch.Tensor]] = None,
                  navi_draw: Optional[NaviDraw] = None) -> RolloutBuffer:
    """The training rollout (JAX `rollout(..., train=True)`), from step 1 to cfg.time_step_end.

    Gradients flow through the poses and motions of the dynamics chain and into every
    encoder; step i draws its dropout masks (and sampled actions and, unless navi_draw says
    otherwise, re-predicted navi) from step_seeds[i], so the per-step recompute of the backward pass draws them again alike. TL
    comes from tl_precomputed or runs in the rollout, as in `rollout`; in RNN mode the GRU
    hiddens carry gradients from step to step. With re-prediction the navi carries gradients too:
    a goal's draw is the predictor's mean plus its std times the noise, and the navi encoder
    reads its speed.
    """
    n_step_roll = cfg.time_step_end
    n_sc, n_ag, t_gt = gt_valid.shape
    tl_rep = _check_rollout_cfg(cfg, tl_precomputed, tl_forcing, n_sc, n_step_roll)
    w = max(cfg.model.temp_window_size, 1)
    dev = gt_valid.device
    detach = cfg.training_detach_model_input
    tf_valid = pad_steps(ag_forcing, n_step_roll, False)
    tf_pose = pad_steps(gt_pose, n_step_roll)
    tf_motion = pad_steps(gt_motion, n_step_roll)
    gt_valid_s = pad_steps(gt_valid, n_step_roll, False)
    reset = _error_reset(cfg.teacher_forcing_training, gt_valid, gt_pose, gt_motion, n_step_roll)
    tl_in = None if tl_precomputed is not None else _TlInRollout(gt_tl_state, tl_forcing, tl_tokens, n_step_roll)
    navi_mode = cfg.model.navi_mode
    draw = _repredict_draw(cfg, navi_update_inputs, navi_draws() if navi_draw is None else navi_draw)

    def step(i, valid, disabled, pose, motion, hist_valid, hist_pose, hist_motion, hist_step_invalid,
             rule_statics, rule_state, navi, navi_valid, tl_state, hist_tl, rnn_hidden, tl_rnn_hidden):
        with dropout_scope(step_seeds[i], dev):
            sg = (lambda x: x.detach()) if detach else (lambda x: x)
            hist_valid = torch.cat([hist_valid[:, :, 1:], valid[:, :, None]], 2)
            hist_pose = torch.cat([hist_pose[:, :, 1:], sg(pose)[:, :, None]], 2)
            hist_motion = torch.cat([hist_motion[:, :, 1:], sg(motion)[:, :, None]], 2)
            hist_step_invalid = torch.cat([hist_step_invalid[1:], hist_step_invalid.new_zeros(1)])
            tl_feature, tl_state_pre = _tl_pre_step(tl_precomputed, tl_rep, i)
            if tl_in is not None:
                hist_tl = torch.cat([hist_tl[:, :, 1:], tl_state[:, :, None]], 2)
            action_dist, tl_logits, rnn_hidden, tl_rnn_hidden = model.step(
                valid, hist_valid, hist_pose, hist_motion, ag_attr, ag_type, ag_latent, ag_latent_valid, navi,
                navi_valid, tl_tokens, mp_tokens, tl_feature, hist_tl_state=hist_tl,
                hist_step_invalid=hist_step_invalid, rnn_hidden=rnn_hidden, tl_rnn_hidden=tl_rnn_hidden)
            out = {}
            if tl_in is None:
                tl_state = tl_state_pre
            else:
                tl_state, out["tl"] = tl_in.step(i, tl_logits)
            if cfg.training_deterministic_action:
                action = action_dist.mean
            else:
                action = action_dist.rsample(dropout_normal(action_dist.mean.shape, dev))
            action_log_prob = torch.where(valid, action_dist.log_prob(action.detach()), 0.0)
            pred_pose, pred_motion, action_bounded = dyn.step_dynamics(pose, motion, valid, action, ag_type,
                                                                       cfg.dynamics,
                                                                       _player(player_valid, player_action, i))
            force = tf_valid[:, :, i] if reset is None else tf_valid[:, :, i] | reset(i, valid, pose, motion)
            ov_valid, ov_pose, ov_motion = dyn.override_ag(valid, pred_pose, pred_motion, disabled, force,
                                                           tf_pose[:, :, i], tf_motion[:, :, i])
            rule_state, violations = check_rules(rule_statics, rule_state, valid, pred_pose.detach(),
                                                 pred_motion.detach(), tl_state, 0)
            step_gt_valid = gt_valid_s[:, :, i] & (i + 1 < t_gt)
            reward = diffbar_reward(cfg.reward, valid, pred_pose, pred_motion, step_gt_valid, tf_pose[:, :, i],
                                    tf_motion[:, :, i], ag_size)
            new_valid, disabled = dyn.disable_outside_map(ov_valid, disabled, violations["outside_map_this_step"],
                                                          step_gt_valid)
            navi, navi_valid, rule_statics, rule_state, navi_out = _navi_step(
                model, navi_mode, draw, i, _navi_reached(navi_mode, violations, valid), navi, navi_valid,
                rule_statics, rule_state, navi_update_inputs,
                (hist_valid, ag_attr, hist_motion, hist_pose, ag_type, mp_tokens))
            if navi_out is not None:
                out["navi"] = navi_out
            carry = (new_valid, disabled, ov_pose, ov_motion, hist_valid, hist_pose, hist_motion, hist_step_invalid,
                     rule_statics, rule_state, navi, navi_valid, tl_state if tl_in is not None else None, hist_tl,
                     rnn_hidden, tl_rnn_hidden)
            out.update(pred_valid=valid, pred_pose=pred_pose, pred_motion=pred_motion,
                       pred_action=action_bounded.detach(), action_log_prob=action_log_prob,
                       mask_teacher_forcing=force, diffbar_reward=reward, violation=violations)
            return carry, out

    carry = (gt_valid[:, :, 0], torch.zeros((n_sc, n_ag), dtype=torch.bool, device=dev),
             gt_pose[:, :, 0], gt_motion[:, :, 0],
             torch.zeros((n_sc, n_ag, w), dtype=torch.bool, device=dev),
             torch.zeros((n_sc, n_ag, w, 3), dtype=gt_pose.dtype, device=dev),
             torch.zeros((n_sc, n_ag, w, 3), dtype=gt_motion.dtype, device=dev),
             torch.ones(w, dtype=torch.bool, device=dev), rule_statics, rule_state0, ag_navi, ag_navi_valid,
             *_tl_carry0(gt_tl_state, w, tl_in), *_rnn_hidden0(cfg, n_sc, n_ag, gt_tl_state.shape[1], dev))
    per_step = cfg.remat_policy != "none" and torch.is_grad_enabled()
    outs = []
    for i in range(n_step_roll):
        if per_step:
            carry, out = checkpoint(step, i, *carry, use_reentrant=False)
        else:
            carry, out = step(i, *carry)
        outs.append(out)

    def stacked(key):
        return _stack([o[key] for o in outs])

    buf = (_tl_outputs(tl_precomputed, tl_rep, gt_tl_state, tl_tokens, n_step_roll) if tl_in is None
           else _stack_dicts([o["tl"] for o in outs]))
    return RolloutBuffer(
        **{k: stacked(k) for k in ("pred_valid", "pred_pose", "pred_motion", "pred_action", "action_log_prob",
                                   "mask_teacher_forcing")},
        **buf, violation=_stack_dicts([o["violation"] for o in outs]),
        diffbar_reward=_stack_dicts([o["diffbar_reward"] for o in outs]),
        **_navi_log_probs(ag_navi_log_prob, ag_navi_valid, [o["navi"] for o in outs if "navi" in o]))
