"""WOSAC joint-future prediction (counterpart of `trafficbotsv15_tpu/train/evaluation.py::joint_future_pred`).

The main path: L2 pre-processing, scene encoding (map encoder, TL
precompute), the prior latent, the navi predictor, the TL-only pre-pass,
replication of everything K times along the scenario axis, and the
closed-loop rollout. Latent and navi draws come from an explicit
`torch.Generator`. Reactive replay comes with the next slice.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from trafficbotsv15_tpu_torch.config import ExperimentCfg
from trafficbotsv15_tpu_torch.data.preprocessing import PreProcessedBatch, pre_processing
from trafficbotsv15_tpu_torch.models.traffic_bots import TrafficBots
from trafficbotsv15_tpu_torch.sim import rollout as rollout_lib
from trafficbotsv15_tpu_torch.sim import tl_prepass
from trafficbotsv15_tpu_torch.sim.rule_checker import init_rule_checker
from trafficbotsv15_tpu_torch.sim.teacher_forcing import build_forcing_masks
from trafficbotsv15_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass
class JointFutureScene:
    """What the K futures share: the pre-processed batch, the encoded scene and the
    prior / navi distributions, with the TL pre-pass over the unique scenarios."""

    pp: PreProcessedBatch
    mp_tokens: object
    tl_tokens: object
    latent_prior: object
    navi_dist: object
    tl_pre: Dict[str, torch.Tensor]


def batch_to_device(batch: Dict[str, np.ndarray], device: torch.device) -> Dict[str, torch.Tensor]:
    """Batch of numpy arrays or tensors (h5 schema) -> tensors on device."""
    return {k: (v if isinstance(v, torch.Tensor) else torch.from_numpy(np.asarray(v))).to(device)
            for k, v in batch.items()}


def _check_model(model: TrafficBots, device: torch.device) -> None:
    model_dev = next(model.parameters()).device
    if model_dev.type != device.type:
        raise ValueError(f"model is on {model_dev}, the run on {device}: build the model on the same device")


def _repeat(x, k: int):
    return None if x is None else torch.repeat_interleave(x, k, dim=0)


@torch.no_grad()
def encode_scene(cfg: ExperimentCfg, model: TrafficBots, pp: PreProcessedBatch):
    mp_tokens = model.encode_map(pp.mp_valid, pp.mp_attr, pp.mp_pose, pp.mp_type)
    tl_tokens = model.precompute_tl(pp.tl_valid, pp.tl_attr, pp.tl_pose, mp_tokens)
    return mp_tokens, tl_tokens


@torch.no_grad()
def prepare_joint_future(cfg: ExperimentCfg, model: TrafficBots, batch: Dict[str, torch.Tensor]) -> JointFutureScene:
    """Everything before replication: pre-processing, scene encoding, prior latent,
    navi distribution and the TL-only pre-pass."""
    if not cfg.tl_prepass or cfg.model.temp_window_size <= 0:
        raise NotImplementedError("the in-rollout TL path is out of this slice (tl_prepass=True, HPTR mode)")
    pp = pre_processing(batch, tl_mode=cfg.model.tl_mode, navi_mode=cfg.model.navi_mode,
                        n_step_hist=cfg.n_step_hist, training="agent/valid" in batch)
    mp_tokens, tl_tokens = encode_scene(cfg, model, pp)
    latent_prior = model.encode_latent(pp.ag_valid, pp.ag_attr, pp.ag_motion, pp.ag_pose, pp.ag_type,
                                       pp.tl_state.float(), mp_tokens, tl_tokens, posterior=False)
    navi_dist = model.predict_navi(pp.ag_valid, pp.ag_attr, pp.ag_motion, pp.ag_pose, pp.ag_type, mp_tokens)
    tl_state = pp.tl_state.float()
    tl_pre = tl_prepass.tl_rollout_scan(model, tl_tokens, tl_state, torch.ones(tl_state.shape[:3], dtype=torch.bool,
                                        device=tl_state.device), cfg.time_step_end, cfg.model.temp_window_size)
    return JointFutureScene(pp, mp_tokens, tl_tokens, latent_prior, navi_dist, tl_pre)


@torch.no_grad()
def sample_joint_futures(cfg: ExperimentCfg, scene: JointFutureScene, k: int, generator: torch.Generator):
    """Latent and navi per future (K0 takes the modes when joint_future_pred_deterministic_k0)."""
    n_sc, n_ag = scene.pp.ag_valid.shape[:2]
    dev = scene.pp.ag_valid.device
    det = False
    if cfg.joint_future_pred_deterministic_k0:
        det = torch.zeros((n_sc * k, n_ag), dtype=torch.bool, device=dev)
        det[::k] = True
    out = dict(ag_latent=None, ag_latent_valid=None, latent_log_prob=None)
    if scene.latent_prior is not None:
        lat = scene.latent_prior.repeat(k, 0)
        ag_latent = lat.sample(generator, det)
        out.update(ag_latent=ag_latent, ag_latent_valid=lat.valid,
                   latent_log_prob=torch.where(lat.valid, lat.log_prob(ag_latent), 0.0))
    nd = scene.navi_dist.repeat(k, 0)
    ag_navi = nd.sample(generator, det)
    out.update(ag_navi=ag_navi, ag_navi_valid=nd.valid,
               ag_navi_log_prob=torch.where(nd.valid, nd.log_prob(ag_navi), 0.0))
    return out


@torch.no_grad()
def rollout_joint_futures(cfg: ExperimentCfg, model: TrafficBots, batch: Dict[str, torch.Tensor],
                          scene: JointFutureScene, k: int, *, ag_latent, ag_latent_valid, ag_navi, ag_navi_valid,
                          ag_navi_log_prob, check_level: int = 1) -> rollout_lib.RolloutBuffer:
    """The K-replicated closed-loop rollout for given latent / navi samples [n_sc * k, ...]."""
    pp = scene.pp
    tl_tokens = scene.tl_tokens.repeat_for_rollout(k)

    def rep(x):
        return _repeat(x, k)

    ag_goal = rep(batch.get("agent/goal"))
    ag_dest = rep(batch.get("agent/dest"))
    if cfg.model.navi_mode == "dest":
        ag_dest = ag_navi
    elif cfg.model.navi_mode == "goal":
        ag_goal = ag_navi
    statics, state0 = init_rule_checker(
        mp_boundary=rep(batch["map/boundary"]), mp_valid=rep(batch["map/valid"]),
        mp_type=rep(batch["map/type"]).bool(), mp_pos=rep(batch["map/pos"]), mp_dir=rep(batch["map/dir"]),
        ag_type=rep(pp.ag_type), ag_size=rep(pp.ag_size), tl_valid=tl_tokens.valid, tl_pose=tl_tokens.pose,
        ag_goal=ag_goal, ag_dest=ag_dest,
    )
    # joint future: GT = history only (spawn / warm start up to step 10)
    gt_valid, gt_pose, gt_motion = rep(pp.ag_valid), rep(pp.ag_pose), rep(pp.ag_motion)
    gt_tl_state = rep(pp.tl_state).float()
    ag_forcing, _ = build_forcing_masks(cfg.teacher_forcing_joint_future_pred, gt_valid,
                                        torch.ones(gt_tl_state.shape[:3], dtype=torch.bool, device=gt_valid.device))
    return rollout_lib.rollout(
        model, cfg, scene.mp_tokens.repeat(k), tl_tokens,
        ag_attr=rep(pp.ag_attr), ag_type=rep(pp.ag_type), ag_size=rep(pp.ag_size),
        ag_latent=ag_latent, ag_latent_valid=ag_latent_valid,
        ag_navi=ag_navi, ag_navi_valid=ag_navi_valid, ag_navi_log_prob=ag_navi_log_prob,
        gt_valid=gt_valid, gt_pose=gt_pose, gt_motion=gt_motion, gt_tl_state=gt_tl_state, ag_forcing=ag_forcing,
        rule_statics=statics, rule_state0=state0, check_level=check_level,
        tl_precomputed=scene.tl_pre, tf_cfg=cfg.teacher_forcing_joint_future_pred,
    )


@torch.no_grad()
def joint_future_pred(cfg: ExperimentCfg, model: TrafficBots, batch, *, generator: torch.Generator,
                      n_joint_future: Optional[int] = None, check_level: int = 1, device=None):
    """Sample K joint futures per scenario: prior latent + predicted destination per future.

    batch: h5-schema dict of numpy arrays or tensors. Runs on `device` (CUDA
    unless device="cpu"), where the model must already be. check_level 1
    (the JAX package's default) runs every rule check, 0 only those that
    feed back into the rollout.
    Returns (pp, buffer) with every buffer tensor shaped [n_sc, K, ...].
    """
    device = resolve_device(device)
    _check_model(model, device)
    k = cfg.n_joint_future_wosac if n_joint_future is None else n_joint_future
    batch = batch_to_device(batch, device)
    scene = prepare_joint_future(cfg, model, batch)
    s = sample_joint_futures(cfg, scene, k, generator)
    latent_log_prob = s.pop("latent_log_prob")
    buffer = rollout_joint_futures(cfg, model, batch, scene, k, check_level=check_level, **s)
    buffer = rollout_lib.compute_log_prob(buffer, latent_log_prob)
    return scene.pp, buffer.flatten_joint_future(k)
