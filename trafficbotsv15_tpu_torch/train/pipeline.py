"""Model construction, seeded initialisation and the training step (counterpart of
`trafficbotsv15_tpu/train/pipeline.py`: `build_model`, `training_forward`,
`_select_latent`, `make_train_step`).

The compute dtype follows `cfg.precision` (bfloat16 compute with float32
parameters for the flagship, float32 for `tiny_config`).

Every random draw of a training step comes from the caller's
`torch.Generator` through `draw_training_noise`, made before any compute:
uniforms where the JAX package draws Bernoulli masks (history dropout, the
prior-or-posterior choice, random teacher forcing, the irrelevant-agent
loss mask; a mask entry is set where its uniform is below the probability,
jax.random.bernoulli's rule), the latent's standard-normal noise, and one
dropout seed for the encoders plus one per rollout step for the TL pre-pass
and for the rollout. A test hands the JAX package's draws in instead.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from trafficbotsv15_tpu_torch.config import ExperimentCfg
from trafficbotsv15_tpu_torch.data.preprocessing import pre_processing
from trafficbotsv15_tpu_torch.models.mlp import Dense
from trafficbotsv15_tpu_torch.models.traffic_bots import TrafficBots
from trafficbotsv15_tpu_torch.models.transformer import AttentionRPE
from trafficbotsv15_tpu_torch.ops.dropout import dropout_scope
from trafficbotsv15_tpu_torch.sim import rollout as rollout_lib
from trafficbotsv15_tpu_torch.sim import tl_prepass
from trafficbotsv15_tpu_torch.sim.rule_checker import init_rule_checker
from trafficbotsv15_tpu_torch.sim.teacher_forcing import build_forcing_masks
from trafficbotsv15_tpu_torch.train.evaluation import batch_to_device
from trafficbotsv15_tpu_torch.train.losses import training_loss
from trafficbotsv15_tpu_torch.train.optimizer import clip_by_global_norm
from trafficbotsv15_tpu_torch.utils.device import resolve_device


def compute_dtype(cfg: ExperimentCfg) -> torch.dtype:
    return torch.bfloat16 if cfg.precision == "bf16" else torch.float32


@torch.no_grad()
def init_weights(model: nn.Module, seed: int) -> None:
    """Deterministic random weights from a CPU generator (device-independent):
    Dense weights normal(0, 1/fan_in), K/V and RPE projections Xavier-uniform,
    biases zero. LayerNorm and log_std parameters keep their construction values."""
    g = torch.Generator().manual_seed(seed)
    for _, module in sorted(model.named_modules(), key=lambda kv: kv[0]):
        if isinstance(module, Dense):
            fan_in = module.weight.shape[1]
            module.weight.copy_(torch.randn(module.weight.shape, generator=g) / math.sqrt(fan_in))
        elif isinstance(module, AttentionRPE):
            for w in (module.kv_w, getattr(module, "rpe_proj_w", None)):
                if w is not None:
                    bound = math.sqrt(6.0 / (w.shape[0] + w.shape[1]))
                    w.copy_((torch.rand(w.shape, generator=g) * 2.0 - 1.0) * bound)


def build_model(cfg: ExperimentCfg, seed: Optional[int] = None, device=None) -> TrafficBots:
    """TrafficBots for cfg on `device` (CUDA unless device="cpu"), in eval mode.

    Weights are random from `seed` (default `cfg.seed`), the same values on
    any device; `load_state_dict` replaces them with trained ones.
    """
    device = resolve_device(device)
    model = TrafficBots(cfg.model, cfg.data, ops=cfg.ops, time_step_gt=cfg.time_step_gt, dtype=compute_dtype(cfg))
    init_weights(model, cfg.seed if seed is None else seed)
    return model.to(device).eval()


def draw_training_noise(cfg: ExperimentCfg, batch: Dict[str, torch.Tensor], generator: torch.Generator,
                        device) -> Dict[str, object]:
    """Every random draw of one training step (see the module docstring), on `device`."""
    n_sc, n_mp, n_node = batch["map/valid"].shape
    n_ag, n_step = batch["agent/valid"].shape[1:3]
    n_roll = cfg.time_step_end

    def u(*shape):
        return torch.rand(shape, generator=generator, device=generator.device).to(device)

    def seeds(n):
        return torch.randint(0, 2 ** 62, (n,), generator=generator, device=generator.device).tolist()

    tf, lm = cfg.teacher_forcing_training, cfg.training_metrics
    return dict(
        u_mp=u(n_sc, n_mp, n_node - 1), u_ag=u(n_sc, n_ag, cfg.n_step_hist - 1), u_prior=u(),
        latent_eps=torch.randn((n_sc, n_ag, max(cfg.model.latent_encoder.latent_dim, 1)), generator=generator,
                               device=generator.device).to(device),
        u_agent=u(n_sc, n_ag) if tf.prob_forcing_agent > 0 else None,
        u_ss=u(n_sc, n_ag, n_step) if tf.prob_scheduled_sampling > 0 else None,
        u_irrelevant=u(n_sc, n_ag, 1) if 0 < lm.p_loss_for_irrelevant < 1 else None,
        seed_encoders=seeds(1)[0], seeds_tl=seeds(n_roll), seeds_step=seeds(n_roll),
    )


def select_latent(post, prior, use_prior: torch.Tensor, eps: torch.Tensor):
    """The rollout's latent: the prior's draw where use_prior, else the posterior's, both from the
    same noise (JAX `_select_latent` samples both with one key). -> (latent, valid)."""
    if post is None:
        return None, None
    latent = torch.where(use_prior, prior.rsample(eps), post.rsample(eps))
    return latent, torch.where(use_prior, prior.valid, post.valid)


def training_forward(cfg: ExperimentCfg, model: TrafficBots, batch: Dict[str, torch.Tensor],
                     noise: Dict[str, object], current_epoch: int = 0) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One training forward: pre-processing -> encoders -> CVAE latent -> TL pre-pass -> rollout -> loss.
    batch: tensors on the model's device; noise: `draw_training_noise`'s dict. -> (loss, metrics)."""
    dev = batch["agent/valid"].device
    if not cfg.tl_prepass or cfg.model.temp_window_size <= 0:
        raise NotImplementedError("the in-rollout TL path is not ported (tl_prepass=True, HPTR mode)")
    pp = pre_processing(batch, tl_mode=cfg.model.tl_mode, navi_mode=cfg.model.navi_mode,
                        n_step_hist=cfg.n_step_hist, training=True, dropout_p_history=cfg.dropout_p_history,
                        u_mp=noise["u_mp"], u_ag=noise["u_ag"])
    with dropout_scope(noise["seed_encoders"], dev):
        mp_tokens = model.encode_map(pp.mp_valid, pp.mp_attr, pp.mp_pose, pp.mp_type)
        tl_tokens = model.precompute_tl(pp.tl_valid, pp.tl_attr, pp.tl_pose, mp_tokens)
        latent_post = model.encode_latent(pp.gt_valid, pp.ag_attr, pp.gt_motion, pp.gt_pose, pp.ag_type,
                                          pp.gt_tl_state.float(), mp_tokens, tl_tokens, posterior=True)
        latent_prior = model.encode_latent(pp.ag_valid, pp.ag_attr, pp.ag_motion, pp.ag_pose, pp.ag_type,
                                           pp.tl_state.float(), mp_tokens, tl_tokens, posterior=False)
        ag_latent, ag_latent_valid = select_latent(latent_post, latent_prior,
                                                   noise["u_prior"] < cfg.p_training_rollout_prior, noise["latent_eps"])
        navi_pred = model.predict_navi(pp.ag_valid, pp.ag_attr, pp.ag_motion, pp.ag_pose, pp.ag_type, mp_tokens)

    rule_statics, rule_state0 = init_rule_checker(
        mp_boundary=batch["map/boundary"], mp_valid=batch["map/valid"], mp_type=batch["map/type"].bool(),
        mp_pos=batch["map/pos"], mp_dir=batch["map/dir"], ag_type=pp.ag_type, ag_size=pp.ag_size,
        tl_valid=tl_tokens.valid, tl_pose=tl_tokens.pose, ag_goal=batch.get("agent/goal"),
        ag_dest=batch.get("agent/dest"))
    tl_forcing0 = torch.ones(pp.gt_tl_state.shape[:3], dtype=torch.bool, device=dev)  # TL forced to GT
    ag_forcing, tl_forcing = build_forcing_masks(cfg.teacher_forcing_training, pp.gt_valid, tl_forcing0,
                                                 current_epoch, noise["u_agent"], noise["u_ss"])
    if not (pp.gt_tl_state.shape[2] >= cfg.time_step_end + 1 and tl_prepass.fully_forced(tl_forcing, tl_forcing0)):
        raise NotImplementedError("training needs TL forced over the whole horizon (the in-rollout TL path)")
    tl_pre = tl_prepass.tl_rollout_forced(model, tl_tokens, pp.gt_tl_state.float(), cfg.time_step_end,
                                          cfg.model.temp_window_size, seeds=noise["seeds_tl"])
    buffer = rollout_lib.rollout_train(
        model, cfg, mp_tokens, tl_tokens, ag_attr=pp.ag_attr, ag_type=pp.ag_type, ag_size=pp.ag_size,
        ag_latent=ag_latent, ag_latent_valid=ag_latent_valid, ag_navi=pp.gt_navi,
        ag_navi_valid=pp.gt_valid.any(-1), ag_navi_log_prob=torch.zeros_like(pp.ag_attr[:, :, 0]),
        gt_valid=pp.gt_valid, gt_pose=pp.gt_pose, gt_motion=pp.gt_motion, gt_tl_state=pp.gt_tl_state.float(),
        ag_forcing=ag_forcing, rule_statics=rule_statics, rule_state0=rule_state0, tl_precomputed=tl_pre,
        step_seeds=noise["seeds_step"])
    return training_loss(cfg.training_metrics, buffer, pp.ag_role, navi_pred, pp.gt_navi, latent_post,
                         latent_prior, u_irrelevant=noise["u_irrelevant"])


def make_train_step(cfg: ExperimentCfg, model: TrafficBots, optimizer: torch.optim.Optimizer,
                    schedule: Optional[torch.optim.lr_scheduler.LRScheduler] = None, device=None):
    """The gradient step: train_step(batch, generator, epoch=0, noise=None) -> metrics.

    Runs on `device` (CUDA unless device="cpu"), where the model must be; clips each of the
    optimizer's groups by `cfg.optimizer.grad_clip_norm`, steps the optimizer over the model's
    parameters in place, then the schedule (`train/optimizer.py::make_optimizer` makes both).
    metrics holds the loss terms and `grad_norm`, the global norm of the gradients before clipping."""
    device = resolve_device(device)
    model_dev = next(model.parameters()).device
    if model_dev.type != device.type:
        raise ValueError(f"model is on {model_dev}, the step on {device}: build the model on the same device")

    def train_step(batch, generator: Optional[torch.Generator] = None, epoch: int = 0, noise=None):
        batch = batch_to_device(batch, device)
        if noise is None:
            noise = draw_training_noise(cfg, batch, generator, device)
        model.zero_grad(set_to_none=True)
        loss, metrics = training_forward(cfg, model, batch, noise, epoch)
        loss.backward()
        for p in model.parameters():  # optax updates every parameter: its moments and its decay
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        gnorm = clip_by_global_norm(optimizer.param_groups, cfg.optimizer.grad_clip_norm)
        optimizer.step()
        if schedule is not None:
            schedule.step()
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["grad_norm"] = gnorm
        return metrics

    return train_step
