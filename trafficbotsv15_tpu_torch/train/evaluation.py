"""The evaluation rollouts (counterpart of `trafficbotsv15_tpu/train/evaluation.py`).

`joint_future_pred`, the WOSAC joint futures: L2 pre-processing, scene
encoding (map encoder, TL precompute), the prior latent, the navi
predictor, the TL-only pre-pass (HPTR mode with `tl_prepass`; else TL runs
in the rollout, as in the TrafficBots RNN family), replication of
everything K times along the scenario axis, and the closed-loop rollout. Latent and navi draws, and the
navi re-predicted in the rollout, come from an explicit `torch.Generator`. A command's draw enters the
rollout as its one-hot (`models/navigation.py::navi_of_draw`); in dummy mode no navi is drawn.
With `rollout_token_dedup` the rollout reads the unique scenarios' map and TL
tokens instead of K replicas of them (`token_dedup_rep`: JAX's gate).

`reactive_replay`, the validation's reconstruction rollout: the posterior
latent's mode (a Gaussian's mean, a categorical's argmax one-hot), the
ground-truth navi, every agent spawned from the
log (`teacher_forcing_reactive_replay`), TL forced to the log, deterministic
actions; it draws nothing but the navi re-predicted in the rollout
(`pred_navi_after_reached`, from the caller's generator). Past the log's horizon (`time_step_end` >= the
logged steps, the scaled preset) TL runs free from its own predictions, as
in JAX's in-scan TL path (`sim/tl_prepass.py::tl_rollout_scan`, or TL in
the rollout where `tl_prepass.prepass_wanted` says no).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from trafficbotsv15_tpu_torch.config import ExperimentCfg
from trafficbotsv15_tpu_torch.data.preprocessing import PreProcessedBatch, pre_processing
from trafficbotsv15_tpu_torch.models.navigation import navi_of_draw
from trafficbotsv15_tpu_torch.models.traffic_bots import TrafficBots
from trafficbotsv15_tpu_torch.sim import rollout as rollout_lib
from trafficbotsv15_tpu_torch.sim import tl_prepass
from trafficbotsv15_tpu_torch.sim.rule_checker import init_rule_checker
from trafficbotsv15_tpu_torch.sim.teacher_forcing import build_forcing_masks
from trafficbotsv15_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass
class JointFutureScene:
    """What the K futures share: the pre-processed batch, the encoded scene and the
    prior / navi distributions, with the TL pre-pass over the unique scenarios (None where TL runs in the
    rollout)."""

    pp: PreProcessedBatch
    mp_tokens: object
    tl_tokens: object
    latent_prior: object
    navi_dist: object
    tl_pre: Optional[Dict[str, torch.Tensor]]


def batch_to_device(batch: Dict[str, np.ndarray], device: torch.device) -> Dict[str, torch.Tensor]:
    """Batch of numpy arrays or tensors (h5 schema) -> tensors on device."""
    return {k: (v if isinstance(v, torch.Tensor) else torch.from_numpy(np.asarray(v))).to(device)
            for k, v in batch.items()}


def check_model(model: TrafficBots, device: torch.device) -> None:
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
def reactive_replay(cfg: ExperimentCfg, model: TrafficBots, batch, check_level: int = 1, device=None,
                    generator: Optional[torch.Generator] = None, navi_noise=None):
    """Posterior-latent, ground-truth-navi reconstruction rollout over the logged scenarios.

    batch: h5-schema dict of numpy arrays or tensors, with the ground truth. Runs on `device` (CUDA
    unless device="cpu"), where the model must already be. With `pred_navi_after_reached` the rollout's
    re-predicted navi are drawn from generator, or given per step as navi_noise. Returns (pp, buffer
    [n_sc, n_ag, ...] with `diffbar_reward`, navi_pred, latent_post, latent_prior)."""
    device = resolve_device(device)
    check_model(model, device)
    batch = batch_to_device(batch, device)
    pp = pre_processing(batch, tl_mode=cfg.model.tl_mode, navi_mode=cfg.model.navi_mode,
                        n_step_hist=cfg.n_step_hist, training=True)
    mp_tokens, tl_tokens = encode_scene(cfg, model, pp)
    gt_tl_state = pp.gt_tl_state.float()
    latent_post = model.encode_latent(pp.gt_valid, pp.ag_attr, pp.gt_motion, pp.gt_pose, pp.ag_type, gt_tl_state,
                                      mp_tokens, tl_tokens, posterior=True)
    latent_prior = model.encode_latent(pp.ag_valid, pp.ag_attr, pp.ag_motion, pp.ag_pose, pp.ag_type,
                                       pp.tl_state.float(), mp_tokens, tl_tokens, posterior=False)
    ag_latent = None if latent_post is None else latent_post.sample(None, True)
    navi_pred = model.predict_navi(pp.ag_valid, pp.ag_attr, pp.ag_motion, pp.ag_pose, pp.ag_type, mp_tokens)
    statics, state0 = init_rule_checker(
        mp_boundary=batch["map/boundary"], mp_valid=batch["map/valid"], mp_type=batch["map/type"].bool(),
        mp_pos=batch["map/pos"], mp_dir=batch["map/dir"], ag_type=pp.ag_type, ag_size=pp.ag_size,
        tl_valid=tl_tokens.valid, tl_pose=tl_tokens.pose, ag_goal=batch.get("agent/goal"),
        ag_dest=batch.get("agent/dest"))
    tl_forcing0 = torch.ones(gt_tl_state.shape[:3], dtype=torch.bool, device=device)
    ag_forcing, tl_forcing = build_forcing_masks(cfg.teacher_forcing_reactive_replay, pp.gt_valid, tl_forcing0)
    tl_pre = None
    if tl_prepass.prepass_wanted(cfg):
        tl_pre = tl_prepass.tl_rollout_scan(model, tl_tokens, gt_tl_state, tl_forcing, cfg.time_step_end,
                                            cfg.model.temp_window_size)
    buffer = rollout_lib.rollout(
        model, cfg, mp_tokens, tl_tokens, ag_attr=pp.ag_attr, ag_type=pp.ag_type, ag_size=pp.ag_size,
        ag_latent=ag_latent, ag_latent_valid=None if latent_post is None else latent_post.valid,
        ag_navi=pp.gt_navi, ag_navi_valid=pp.gt_valid.any(-1), ag_navi_log_prob=torch.zeros_like(pp.ag_attr[:, :, 0]),
        gt_valid=pp.gt_valid, gt_pose=pp.gt_pose, gt_motion=pp.gt_motion, gt_tl_state=gt_tl_state,
        ag_forcing=ag_forcing, rule_statics=statics, rule_state0=state0, check_level=check_level,
        tl_precomputed=tl_pre, tl_forcing=tl_forcing, tf_cfg=cfg.teacher_forcing_reactive_replay, with_reward=True,
        navi_update_inputs=rollout_lib.navi_map_arrays(cfg, batch),
        navi_draw=rollout_lib.navi_draws(generator, navi_noise))
    return pp, buffer, navi_pred, latent_post, latent_prior


@torch.no_grad()
def prepare_joint_future(cfg: ExperimentCfg, model: TrafficBots, batch: Dict[str, torch.Tensor]) -> JointFutureScene:
    """Everything before replication: pre-processing, scene encoding, prior latent,
    navi distribution and the TL-only pre-pass (None where TL runs in the rollout)."""
    pp = pre_processing(batch, tl_mode=cfg.model.tl_mode, navi_mode=cfg.model.navi_mode,
                        n_step_hist=cfg.n_step_hist, training="agent/valid" in batch)
    mp_tokens, tl_tokens = encode_scene(cfg, model, pp)
    latent_prior = model.encode_latent(pp.ag_valid, pp.ag_attr, pp.ag_motion, pp.ag_pose, pp.ag_type,
                                       pp.tl_state.float(), mp_tokens, tl_tokens, posterior=False)
    navi_dist = model.predict_navi(pp.ag_valid, pp.ag_attr, pp.ag_motion, pp.ag_pose, pp.ag_type, mp_tokens)
    tl_pre = None
    if tl_prepass.prepass_wanted(cfg):
        tl_state = pp.tl_state.float()
        tl_pre = tl_prepass.tl_rollout_scan(model, tl_tokens, tl_state, torch.ones(
            tl_state.shape[:3], dtype=torch.bool, device=tl_state.device), cfg.time_step_end,
            cfg.model.temp_window_size)
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
    if scene.navi_dist is None:  # dummy mode
        out.update(ag_navi=None, ag_navi_valid=torch.zeros((n_sc * k, n_ag), dtype=torch.bool, device=dev),
                   ag_navi_log_prob=torch.zeros((n_sc * k, n_ag), device=dev))
        return out
    nd = scene.navi_dist.repeat(k, 0)
    draw = nd.sample(generator, det)
    out.update(ag_navi=navi_of_draw(cfg.model.navi_mode, nd, draw), ag_navi_valid=nd.valid,
               ag_navi_log_prob=torch.where(nd.valid, nd.log_prob(draw), 0.0))
    return out


def token_dedup_rep(cfg: ExperimentCfg, scene: JointFutureScene, k: int) -> int:
    """The rollout's token_rep, as JAX's joint_future_pred decides it: K under `rollout_token_dedup` where the TL
    pre-pass ran and the config does not set `pred_navi_after_reached` (the in-rollout TL encoder and navi
    predictor read the replicated batch); else 1, the replicated rollout."""
    if cfg.rollout_token_dedup and scene.tl_pre is not None and not cfg.pred_navi_after_reached:
        return k
    return 1


@torch.no_grad()
def rollout_joint_futures(cfg: ExperimentCfg, model: TrafficBots, batch: Dict[str, torch.Tensor],
                          scene: JointFutureScene, k: int, *, ag_latent, ag_latent_valid, ag_navi, ag_navi_valid,
                          ag_navi_log_prob, check_level: int = 1, navi_generator: Optional[torch.Generator] = None,
                          navi_noise=None) -> rollout_lib.RolloutBuffer:
    """The K-replicated closed-loop rollout for given latent / navi samples [n_sc * k, ...]; with
    `pred_navi_after_reached` its re-predicted navi drawn from navi_generator or given per step as navi_noise."""
    pp = scene.pp
    # TL in the rollout runs its encoder on the replicated batch: every token field repeats
    tl_full = scene.tl_tokens.repeat(k) if scene.tl_pre is None else scene.tl_tokens.repeat_for_rollout(k)
    token_rep = token_dedup_rep(cfg, scene, k)

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
        ag_type=rep(pp.ag_type), ag_size=rep(pp.ag_size), tl_valid=tl_full.valid, tl_pose=tl_full.pose,
        ag_goal=ag_goal, ag_dest=ag_dest,
    )
    # joint future: GT = history only (spawn / warm start up to step 10)
    gt_valid, gt_pose, gt_motion = rep(pp.ag_valid), rep(pp.ag_pose), rep(pp.ag_motion)
    gt_tl_state = rep(pp.tl_state).float()
    ag_forcing, tl_forcing = build_forcing_masks(cfg.teacher_forcing_joint_future_pred, gt_valid, torch.ones(
        gt_tl_state.shape[:3], dtype=torch.bool, device=gt_valid.device))
    return rollout_lib.rollout(
        model, cfg, scene.mp_tokens if token_rep > 1 else scene.mp_tokens.repeat(k),
        scene.tl_tokens if token_rep > 1 else tl_full,
        ag_attr=rep(pp.ag_attr), ag_type=rep(pp.ag_type), ag_size=rep(pp.ag_size),
        ag_latent=ag_latent, ag_latent_valid=ag_latent_valid,
        ag_navi=ag_navi, ag_navi_valid=ag_navi_valid, ag_navi_log_prob=ag_navi_log_prob,
        gt_valid=gt_valid, gt_pose=gt_pose, gt_motion=gt_motion, gt_tl_state=gt_tl_state, ag_forcing=ag_forcing,
        rule_statics=statics, rule_state0=state0, check_level=check_level,
        tl_precomputed=scene.tl_pre, tl_forcing=tl_forcing, tf_cfg=cfg.teacher_forcing_joint_future_pred,
        navi_update_inputs=rollout_lib.navi_map_arrays(cfg, batch, k),
        navi_draw=rollout_lib.navi_draws(navi_generator, navi_noise), token_rep=token_rep,
    )


@torch.no_grad()
def joint_future_pred(cfg: ExperimentCfg, model: TrafficBots, batch, *, generator: torch.Generator,
                      n_joint_future: Optional[int] = None, check_level: int = 1, device=None):
    """Sample K joint futures per scenario: prior latent + predicted navi per future.

    batch: h5-schema dict of numpy arrays or tensors. Runs on `device` (CUDA
    unless device="cpu"), where the model must already be. check_level 1
    (the JAX package's default) runs every rule check, 0 only those that
    feed back into the rollout.
    Returns (pp, buffer) with every buffer tensor shaped [n_sc, K, ...].
    """
    device = resolve_device(device)
    check_model(model, device)
    k = cfg.n_joint_future_wosac if n_joint_future is None else n_joint_future
    batch = batch_to_device(batch, device)
    scene = prepare_joint_future(cfg, model, batch)
    s = sample_joint_futures(cfg, scene, k, generator)
    latent_log_prob = s.pop("latent_log_prob")
    buffer = rollout_joint_futures(cfg, model, batch, scene, k, check_level=check_level, navi_generator=generator,
                                   **s)
    buffer = rollout_lib.compute_log_prob(buffer, latent_log_prob)
    return scene.pp, buffer.flatten_joint_future(k)
