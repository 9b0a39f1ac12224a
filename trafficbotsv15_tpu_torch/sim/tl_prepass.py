"""Traffic-light pre-pass (counterpart of `trafficbotsv15_tpu/sim/tl_prepass.py`).

The TL encoder and state predictor never see agent state, so the rollout
consumes their per-step feature and state from a pass made before it,
`tl_rollout_scan`, in every rollout of HPTR mode with `tl_prepass`
(`prepass_wanted`): joint-future prediction (GT is the history only),
training and reactive replay (TL forced to GT where the log has it; past the
log's horizon, as in the scaled preset's 120 steps against 91 logged, from
its own predictions). One encoder call per step, outside the
rollout's per-step recompute, with a dropout seed per step.

It is the port's counterpart of JAX's in-scan TL path (`sim/rollout.py` with
`tl_precomputed=None`) and, where TL is forced over a logged horizon, of
JAX's batched pre-pass (`tl_rollout_forced`): with every step forced the
windows are GT slices, the same ones the batched pass builds. The port keeps
no batched pass: both make one encoder call per step here, and the step loop
costs a few more small ops per step (the argmax and the shift register).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

from trafficbotsv15_tpu_torch.models.tokens import TlTokens
from trafficbotsv15_tpu_torch.ops.dropout import dropout_scope
from trafficbotsv15_tpu_torch.sim import dynamics as dyn


def prepass_wanted(cfg) -> bool:
    """Whether the rollouts take TL from this pass: HPTR mode with `tl_prepass` (JAX's joint-future condition).
    Otherwise TL runs inside the rollout's steps (`sim/rollout.py`): the TrafficBots RNN family, whose state
    predictor carries a GRU hidden, and HPTR with `tl_prepass=False`."""
    return cfg.tl_prepass and cfg.model.temp_window_size > 0


def pad_steps(arr: torch.Tensor, n_step_roll: int, fill=0) -> torch.Tensor:
    """GT covers steps [0, T); the rollout needs steps [1, n_step_roll]: slice or pad axis 2."""
    t = arr.shape[2]
    need = n_step_roll + 1
    if t < need:
        pad = torch.full(arr.shape[:2] + (need - t,) + arr.shape[3:], fill, dtype=arr.dtype, device=arr.device)
        arr = torch.cat([arr, pad], 2)
    return arr[:, :, 1:need]


def tl_rollout_scan(model, tl_tokens: TlTokens, gt_tl_state: torch.Tensor, tl_forcing: torch.Tensor,
                    n_step_roll: int, temp_window_size: int,
                    seeds: Optional[Sequence[int]] = None) -> Dict[str, torch.Tensor]:
    """TL-only rollout, one step after the other. gt_tl_state [n_sc, n_tl, T_tl, 5] float, tl_forcing
    [n_sc, n_tl, T_tl] bool; seeds: one dropout seed per step (None: no dropout).

    Step i (rollout step i + 1) does what JAX's in-scan TL path does inside its scan body:
      - the window: a shift register of W states, the newest (the state after step i - 1's override,
        GT step 0 at i = 0) pushed in at the right; `step_invalid` marks the W - 1 - i slots not yet
        filled, as the scan carry's `hist_step_invalid` does. Past the GT horizon the first W - 1
        windows still hold GT states and the rest are predicted, as in the scan;
      - feature and logits from `model.step_tl`, the same TL encoder and state predictor that the JAX
        `step` runs on the same window;
      - the next state: GT where `tl_forcing[i + 1] & (i + 1 < T_tl)` (`tl_avail`: the scan pads the
        mask with False past T_tl), else the one-hot argmax of the logits.
    With grad enabled (training) gradients reach the TL encoder through `feature`, which the agent
    decoder reads, and the state predictor through `logits`, which the TL-state NLL reads. The state
    is a one-hot of an argmax or GT, so nothing flows back through it into the next window: the
    scan's window input carries none either. Dropout draws per step from its own seed, where JAX
    draws from the scan body's key; the two agree at dropout 0.

    The rollout reads the NLL and its mask (`tl_state_nll_invalid` true past T_tl) from `logits` by
    `sim/rollout.py::_tl_outputs`, as the scan computes them per step. The activations of every step
    are kept for the backward; JAX recomputes them under remat.

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
        with dropout_scope(None if seeds is None else seeds[i], gt_tl_state.device):
            feature, logits = model.step_tl(hist, hist_step_invalid, tl_tokens)
        force = forcing[:, :, i] & (i + 1 < t_tl)
        tl_state = dyn.override_tl(logits, force, gt[:, :, i]).float()
        for key, val in (("feature", feature), ("logits", logits), ("state", tl_state)):
            outs[key].append(val)
    return {k: torch.stack(v) for k, v in outs.items()}
