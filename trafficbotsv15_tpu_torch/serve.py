"""Interactive simulation for serving and gym-style closed-loop use (counterpart of `trafficbotsv15_tpu/serve.py`).

The same policy as the evaluation rollouts, as a stateful stepper: `reset`
encodes a scenario once (map encoder, TL tokens, prior latent and
navi, each sampled once from the caller's generator; a command as its
one-hot, where the JAX package's cmd step fails on the class index), then each
`step` advances the world by one 0.1 s step. Any agent can be scripted from
outside (an ego planner under test, for example); the others follow the
policy. Every tensor of the state stays on the device between calls. The TL
encoder and state predictor run inside each step on the rolling TL window, as
the JAX step does without a TL pre-pass: no log of the future TL states
exists in serving.

Example (device=None is the CUDA device; it raises without one):
    sim = InteractiveSimulator(cfg, model, device="cpu")
    obs = sim.reset(batch, torch.Generator().manual_seed(0))
    for _ in range(80):
        out = sim.step()                          # every agent policy-driven
        # or: sim.step(actions={"valid": m, "action": a})  # scripted agents
    trajs = sim.history()
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from trafficbotsv15_tpu_torch.config import ExperimentCfg
from trafficbotsv15_tpu_torch.data.preprocessing import pre_processing
from trafficbotsv15_tpu_torch.models.navigation import navi_of_draw
from trafficbotsv15_tpu_torch.sim import dynamics as dyn
from trafficbotsv15_tpu_torch.train.evaluation import batch_to_device, check_model, encode_scene
from trafficbotsv15_tpu_torch.utils.device import resolve_device, to_host


class InteractiveSimulator:
    """reset(batch, generator) -> obs; step(actions=None, fetch=True) -> out; history().

    `static` holds what reset encoded and sampled for the episode: mp_tokens, tl_tokens, ag_attr, ag_type,
    ag_latent, ag_latent_valid, ag_navi, ag_navi_valid. A caller may replace the samples after reset (the
    parity tests hand in the JAX package's draws)."""

    def __init__(self, cfg: ExperimentCfg, model, deterministic_action: bool = True, device=None):
        self.device = resolve_device(device)
        check_model(model, self.device)
        if cfg.model.temp_window_size <= 0:
            raise NotImplementedError("serving the RNN mode (temp_window_size <= 0): the JAX package serves "
                                      "HPTR mode only (its step_tl carries no GRU hidden)")
        self.cfg, self.model, self.det_action = cfg, model, deterministic_action
        self.static: Optional[dict] = None
        self._state: Optional[dict] = None
        self._generator: Optional[torch.Generator] = None
        self._trajs: list = []

    @torch.no_grad()
    def reset(self, batch: Dict[str, np.ndarray], generator: torch.Generator) -> Dict[str, np.ndarray]:
        """Encode the scenario of an h5-schema batch (values that are lists, such as scenario bytes, are
        skipped) and seed the rolling window with its observed history. The latent and the destination are
        drawn from `generator`, which also draws the actions when deterministic_action is False (a generator
        on the device keeps those steps free of host syncs)."""
        cfg, model = self.cfg, self.model
        batch = batch_to_device({k: v for k, v in batch.items() if not isinstance(v, list)}, self.device)
        pp = pre_processing(batch, tl_mode=cfg.model.tl_mode, navi_mode=cfg.model.navi_mode,
                            n_step_hist=cfg.n_step_hist, training="agent/valid" in batch)
        mp_tokens, tl_tokens = encode_scene(cfg, model, pp)
        tl_state = pp.tl_state.float()
        latent = model.encode_latent(pp.ag_valid, pp.ag_attr, pp.ag_motion, pp.ag_pose, pp.ag_type, tl_state,
                                     mp_tokens, tl_tokens, posterior=False)
        navi_dist = model.predict_navi(pp.ag_valid, pp.ag_attr, pp.ag_motion, pp.ag_pose, pp.ag_type, mp_tokens)
        self.static = dict(
            mp_tokens=mp_tokens, tl_tokens=tl_tokens, ag_attr=pp.ag_attr, ag_type=pp.ag_type,
            ag_latent=None if latent is None else latent.sample(generator, False),
            ag_latent_valid=None if latent is None else latent.valid,
            ag_navi=None if navi_dist is None else navi_of_draw(cfg.model.navi_mode, navi_dist,
                                                                navi_dist.sample(generator, False)),
            ag_navi_valid=(torch.zeros(pp.ag_valid.shape[:2], dtype=torch.bool, device=self.device)
                           if navi_dist is None else navi_dist.valid))

        w = max(cfg.model.temp_window_size, 1)
        n_sc, n_ag, n_hist = pp.ag_valid.shape
        n_tl = pp.tl_valid.shape[1]
        h = min(w, n_hist)  # the last h observed steps fill the right of the window

        def window(x, shape, dtype):
            out = torch.zeros(shape, dtype=dtype, device=self.device)
            out[:, :, w - h:] = x[:, :, n_hist - h:]
            return out

        hist = dict(valid=window(pp.ag_valid, (n_sc, n_ag, w), torch.bool),
                    pose=window(pp.ag_pose, (n_sc, n_ag, w, 3), pp.ag_pose.dtype),
                    motion=window(pp.ag_motion, (n_sc, n_ag, w, 3), pp.ag_motion.dtype),
                    tl=window(tl_state, (n_sc, n_tl, w, 5), torch.float32),
                    step_invalid=torch.arange(w, device=self.device) < w - h)
        self._state = dict(valid=pp.ag_valid[:, :, -1], pose=pp.ag_pose[:, :, -1], motion=pp.ag_motion[:, :, -1],
                           tl_state=tl_state[:, :, -1], hist=hist)
        self._generator = generator
        self._trajs = []
        return {k: to_host(self._state[k]) for k in ("valid", "pose", "motion")}

    @torch.no_grad()
    def step(self, actions: Optional[Dict[str, np.ndarray]] = None, fetch: bool = True) -> dict:
        """Advance one 0.1 s step. `actions` optionally scripts agents: {"valid": [n_sc, n_ag] bool,
        "action": [n_sc, n_ag, 2] (acc, yaw_rate) in the bounded space}, applied to the valid agents it marks.

        -> {"valid", "pose", "motion", "tl_state", "action" (bounded)}: numpy arrays with fetch=True (one host
        sync), tensors left on the device with fetch=False (no sync; history() gathers them at the end)."""
        if self._state is None:
            raise RuntimeError("call reset() first")
        cfg, model, st, s = self.cfg, self.model, self.static, self._state
        hist = s["hist"]
        hist = dict(valid=torch.cat([hist["valid"][:, :, 1:], s["valid"][:, :, None]], 2),
                    pose=torch.cat([hist["pose"][:, :, 1:], s["pose"][:, :, None]], 2),
                    motion=torch.cat([hist["motion"][:, :, 1:], s["motion"][:, :, None]], 2),
                    tl=torch.cat([hist["tl"][:, :, 1:], s["tl_state"][:, :, None]], 2),
                    step_invalid=torch.cat([hist["step_invalid"][1:], hist["step_invalid"].new_zeros(1)]))
        tl_feature, tl_logits = model.step_tl(hist["tl"], hist["step_invalid"], st["tl_tokens"])
        action_dist = model.step(s["valid"], hist["valid"], hist["pose"], hist["motion"], st["ag_attr"],
                                 st["ag_type"], st["ag_latent"], st["ag_latent_valid"], st["ag_navi"],
                                 st["ag_navi_valid"], st["tl_tokens"], st["mp_tokens"], tl_feature)[0]
        if self.det_action:
            action = action_dist.mean
        else:
            eps = torch.randn(action_dist.mean.shape, generator=self._generator, device=self._generator.device)
            action = action_dist.rsample(eps.to(self.device))
        player = None
        if actions is not None:
            player = {"valid": torch.as_tensor(actions["valid"], dtype=torch.bool, device=self.device),
                      "action": torch.as_tensor(actions["action"], dtype=action.dtype, device=self.device)}
        pose, motion, bounded = dyn.step_dynamics(s["pose"], s["motion"], s["valid"], action, st["ag_type"],
                                                  cfg.dynamics, player_override=player)
        no_override = torch.zeros_like(s["tl_state"], dtype=torch.bool)
        tl_state = dyn.override_tl(tl_logits, no_override[..., 0], no_override).float()
        self._state = dict(valid=s["valid"], pose=pose, motion=motion, tl_state=tl_state, hist=hist)
        out = dict(valid=s["valid"], pose=pose, motion=motion, tl_state=tl_state, action=bounded)
        if fetch:
            out = {k: to_host(v) for k, v in out.items()}
        self._trajs.append(out)
        return out

    def history(self) -> Dict[str, np.ndarray]:
        """The trajectory so far as numpy arrays, each [n_sc, n_ag (n_tl), n_step, ...]."""
        if not self._trajs:
            return {}
        return {k: np.stack([to_host(t[k]) for t in self._trajs], 2) for k in self._trajs[0]}
