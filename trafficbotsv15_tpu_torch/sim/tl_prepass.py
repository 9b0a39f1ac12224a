"""Traffic-light pre-pass (counterpart of `trafficbotsv15_tpu/sim/tl_prepass.py`).

The TL encoder and state predictor never see agent state, so the rollout
consumes their per-step feature and state from a pre-pass:
  - `tl_rollout_scan` (joint-future prediction): the TL transition (argmax
    of the logits, overridden by GT where forced) is deterministic in
    evaluation, so the K replicated futures share one TL trajectory, run on
    the un-replicated scenarios;
  - `tl_rollout_forced` (training): TL fully teacher-forced to GT, so every
    window is a GT slice; one encoder call per step, outside the rollout's
    per-step recompute, with a dropout seed per step.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

from trafficbotsv15_tpu_torch.models.tokens import TlTokens
from trafficbotsv15_tpu_torch.ops.dropout import dropout_scope
from trafficbotsv15_tpu_torch.sim import dynamics as dyn


def pad_steps(arr: torch.Tensor, n_step_roll: int, fill=0) -> torch.Tensor:
    """GT covers steps [0, T); the rollout needs steps [1, n_step_roll]: slice or pad axis 2."""
    t = arr.shape[2]
    need = n_step_roll + 1
    if t < need:
        pad = torch.full(arr.shape[:2] + (need - t,) + arr.shape[3:], fill, dtype=arr.dtype, device=arr.device)
        arr = torch.cat([arr, pad], 2)
    return arr[:, :, 1:need]


def tl_rollout_scan(model, tl_tokens: TlTokens, gt_tl_state: torch.Tensor, tl_forcing: torch.Tensor,
                    n_step_roll: int, temp_window_size: int) -> Dict[str, torch.Tensor]:
    """TL-only rollout. gt_tl_state [n_sc, n_tl, T_tl, 5] float, tl_forcing [n_sc, n_tl, T_tl] bool.

    Returns step-axis-first {"feature": [n, n_sc, n_tl, D], "logits": [n, n_sc, n_tl, 5],
    "state": [n, n_sc, n_tl, 5]}.
    """
    w = temp_window_size
    n_sc, n_tl, t_tl = gt_tl_state.shape[:3]
    forcing = pad_steps(tl_forcing, n_step_roll, False)
    gt = pad_steps(gt_tl_state, n_step_roll, 0)
    tl_state = gt_tl_state[:, :, 0].float()
    hist = torch.zeros((n_sc, n_tl, w, 5), device=gt_tl_state.device)
    hist_step_invalid = torch.ones(w, dtype=torch.bool, device=gt_tl_state.device)
    outs = {"feature": [], "logits": [], "state": []}
    for i in range(n_step_roll):
        hist = torch.cat([hist[:, :, 1:], tl_state[:, :, None]], 2)
        hist_step_invalid = torch.cat([hist_step_invalid[1:], hist_step_invalid.new_zeros(1)])
        feature, logits = model.step_tl(hist, hist_step_invalid, tl_tokens)
        force = forcing[:, :, i] & (i + 1 < t_tl)
        tl_state = dyn.override_tl(logits, force, gt[:, :, i]).float()
        for key, val in (("feature", feature), ("logits", logits), ("state", tl_state)):
            outs[key].append(val)
    return {k: torch.stack(v) for k, v in outs.items()}


def fully_forced(tl_forcing: torch.Tensor, tl_forcing_all_true: Optional[torch.Tensor] = None) -> bool:
    """True when TL is teacher-forced everywhere, the regime `tl_rollout_forced` is valid for:
    the mask is the all-true one the caller built (identity), or every entry is True."""
    if tl_forcing_all_true is not None and tl_forcing is tl_forcing_all_true:
        return True
    return bool(tl_forcing.all())


def tl_rollout_forced(model, tl_tokens: TlTokens, states_seq: torch.Tensor, n_step_roll: int,
                      temp_window_size: int, seeds: Optional[Sequence[int]] = None) -> Dict[str, torch.Tensor]:
    """TL encode of every rollout step when TL is forced to GT. states_seq [n_sc, n_tl, T >= n_step_roll + 1, 5]
    float; seeds: one dropout seed per step (None: no dropout).

    Window i holds the states of steps i + 1 - W .. i, zero-padded below step 0, as the rollout's
    shift register would. Returns the `tl_rollout_scan` dict."""
    w = temp_window_size
    n_sc, n_tl = states_seq.shape[:2]
    pad = states_seq.new_zeros((n_sc, n_tl, w - 1, states_seq.shape[-1]))
    padded = torch.cat([pad, states_seq[:, :, :n_step_roll]], 2)
    steps = torch.arange(1, n_step_roll + 1, device=states_seq.device)[:, None]
    step_invalid = steps - w + torch.arange(w, device=states_seq.device)[None, :] < 0  # [n, W]
    features, logits = [], []
    for i in range(n_step_roll):
        with dropout_scope(None if seeds is None else seeds[i], states_seq.device):
            feature, logit = model.step_tl(padded[:, :, i:i + w], step_invalid[i], tl_tokens)
        features.append(feature)
        logits.append(logit)
    return {"feature": torch.stack(features), "logits": torch.stack(logits),
            "state": states_seq[:, :, 1:n_step_roll + 1].movedim(2, 0).float()}
