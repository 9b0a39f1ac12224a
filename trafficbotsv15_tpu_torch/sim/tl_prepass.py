"""Traffic-light pre-pass (counterpart of `trafficbotsv15_tpu/sim/tl_prepass.py::tl_rollout_scan`).

The TL encoder and state predictor never see agent state, and the TL
transition (argmax of the logits, overridden by GT where forced) is
deterministic in evaluation, so the K replicated futures share one TL
trajectory: this loop runs on the un-replicated scenarios and the main
rollout consumes its per-step feature and state.
"""

from __future__ import annotations

from typing import Dict

import torch

from trafficbotsv15_tpu_torch.models.tokens import TlTokens
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
