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
jax.random.bernoulli's rule), the latent's noise (standard normal, or Gumbel
for categorical latents: `latent_noise`), and one
dropout seed for the encoders plus one per rollout step for the TL pre-pass
and for the rollout, whose sampled actions and re-predicted navi a step's
seed draws too. A test hands the JAX package's draws in instead (the
re-predicted navi's per step as `navi_noise`).

Over N ranks (`parallel/mesh.py`, one batch of the same size per index of the
data dim) the step computes what one process computes on the union batch:
every rank draws the union's per-row noise from the same generator and keeps
its data index's rows (`shard_noise`), so the one prior-or-posterior draw is
shared; each loss term is its sum over the global valid count
(`train/losses.py`), the counts and the metrics summed over the data dim; the
gradients are reduced onto what the optimizer owns before the clip
(`ShardedParams.scatter_grads`: summed over the data dim, the shards of FSDP
and tensor parallelism reduce-scattered or cut). The data index is folded into
the dropout seeds, so that the data shards' scenes get masks of their own and
the ranks of one model group the same. No `DistributedDataParallel` and no
FSDP or DTensor hooks: they hook `forward`, and the step calls the model's
submodules and methods directly, the fused kernels on whole weights.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from trafficbotsv15_tpu_torch.config import ExperimentCfg
from trafficbotsv15_tpu_torch.data.preprocessing import pre_processing
from trafficbotsv15_tpu_torch.models.latent_encoder import CATEGORICAL
from trafficbotsv15_tpu_torch.models.mlp import Dense
from trafficbotsv15_tpu_torch.models.traffic_bots import TrafficBots
from trafficbotsv15_tpu_torch.models.transformer import AttentionRPE
from trafficbotsv15_tpu_torch.ops.distributions import gumbel_noise
from trafficbotsv15_tpu_torch.ops.dropout import dropout_scope
from trafficbotsv15_tpu_torch.parallel.mesh import (DATA_AXIS, ShardedParams, all_reduce_sum, data_count, data_index,
                                                    dim_group, model_count)
from trafficbotsv15_tpu_torch.sim import rollout as rollout_lib
from trafficbotsv15_tpu_torch.sim import tl_prepass
from trafficbotsv15_tpu_torch.sim.rule_checker import init_rule_checker
from trafficbotsv15_tpu_torch.sim.teacher_forcing import build_forcing_masks
from trafficbotsv15_tpu_torch.train.evaluation import batch_to_device
from trafficbotsv15_tpu_torch.train.losses import training_loss
from trafficbotsv15_tpu_torch.train.optimizer import clip_by_global_norm, make_accumulator
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


ROW_NOISE = ("u_mp", "u_ag", "latent_eps", "u_agent", "u_ss", "u_irrelevant")  # a row per scenario
SEED_NOISE = ("seeds_tl", "seeds_step")
_SEED_MOD = 2 ** 62


def fold_seed(seed: int, rank: int) -> int:
    """A dropout seed of its own for each rank (rank 0 keeps the seed)."""
    return (seed + rank * 0x9E3779B97F4A7C15) % _SEED_MOD


def shard_noise(noise: Dict[str, object], rank: int, world: int) -> Dict[str, object]:
    """Rank `rank`'s share of one step's draws for the union of `world` equal batches: its rows of each per-row
    draw, the shared `u_prior`, and the dropout seeds with the rank folded in. The identity for world 1."""
    if world == 1:
        return noise
    out = dict(noise)
    for key in ROW_NOISE:
        if noise[key] is not None:
            n = noise[key].shape[0] // world
            out[key] = noise[key][rank * n:(rank + 1) * n]
    out["seed_encoders"] = fold_seed(noise["seed_encoders"], rank)
    for key in SEED_NOISE:
        out[key] = [fold_seed(s, rank) for s in noise[key]]
    return out


def draw_training_noise(cfg: ExperimentCfg, batch: Dict[str, torch.Tensor], generator: torch.Generator,
                        device, rank: int = 0, world: int = 1) -> Dict[str, object]:
    """Every random draw of one training step (see the module docstring), on `device`: with `world` ranks, the
    draws of the union of `world` batches shaped as this one, and rank `rank`'s share of them (`shard_noise`)."""
    n_sc, n_mp, n_node = batch["map/valid"].shape
    n_sc *= world
    n_ag, n_step = batch["agent/valid"].shape[1:3]
    n_roll = cfg.time_step_end

    def u(*shape):
        return torch.rand(shape, generator=generator, device=generator.device)

    def seeds(n):
        return torch.randint(0, _SEED_MOD, (n,), generator=generator, device=generator.device).tolist()

    tf, lm = cfg.teacher_forcing_training, cfg.training_metrics
    noise = shard_noise(dict(
        u_mp=u(n_sc, n_mp, n_node - 1), u_ag=u(n_sc, n_ag, cfg.n_step_hist - 1), u_prior=u(),
        latent_eps=latent_noise(cfg, n_sc, n_ag, generator),
        u_agent=u(n_sc, n_ag) if tf.prob_forcing_agent > 0 else None,
        u_ss=u(n_sc, n_ag, n_step) if tf.prob_scheduled_sampling > 0 else None,
        u_irrelevant=u(n_sc, n_ag, 1) if 0 < lm.p_loss_for_irrelevant < 1 else None,
        seed_encoders=seeds(1)[0], seeds_tl=seeds(n_roll), seeds_step=seeds(n_roll),
    ), rank, world)
    return {k: v.to(device) if isinstance(v, torch.Tensor) else v for k, v in noise.items()}


def latent_noise(cfg: ExperimentCfg, n_sc: int, n_ag: int, generator: torch.Generator) -> torch.Tensor:
    """The noise both latent draws of a training step take, on the generator's device: standard normal
    [n_sc, n_ag, latent_dim] for Gaussian latents, standard Gumbel [n_sc, n_ag, n_cat, latent_dim // n_cat] for
    categorical ones (JAX's `MultiCategorical.sample` is `jax.random.categorical`, a Gumbel-max)."""
    lat = cfg.model.latent_encoder
    if lat.latent_dim > 0 and lat.latent_post.dist_type in CATEGORICAL:
        n_cat = lat.latent_post.n_cat
        return gumbel_noise((n_sc, n_ag, n_cat, lat.latent_dim // n_cat), generator, generator.device)
    return torch.randn((n_sc, n_ag, max(lat.latent_dim, 1)), generator=generator, device=generator.device)


def select_latent(post, prior, use_prior: torch.Tensor, eps: torch.Tensor):
    """The rollout's latent: the prior's draw where use_prior, else the posterior's, both from the
    same noise (JAX `_select_latent` samples both with one key). -> (latent, valid)."""
    if post is None:
        return None, None
    latent = torch.where(use_prior, prior.rsample(eps), post.rsample(eps))
    return latent, torch.where(use_prior, prior.valid, post.valid)


def training_forward(cfg: ExperimentCfg, model: TrafficBots, batch: Dict[str, torch.Tensor],
                     noise: Dict[str, object], current_epoch: int = 0,
                     count_sum=None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One training forward: pre-processing -> encoders -> CVAE latent -> TL pass -> rollout -> loss.
    batch: tensors on the model's device; noise: `draw_training_noise`'s dict; count_sum: `training_loss`'s
    (the loss counts summed over the ranks). -> (loss, metrics).
    TL comes from the pass before the rollout (`sim/tl_prepass.py::tl_rollout_scan`) in HPTR mode with
    `tl_prepass`, else from the rollout's own steps (the TrafficBots RNN family, whose GRU hiddens ride in the
    rollout's carry).
    `cfg.time_step_end` may pass the data's horizon (the scaled preset's 120 steps against 91): past it TL
    runs from its own predictions, and the rollout forces nothing, resets nothing and rewards nothing, and
    the TL-state NLL is masked off."""
    dev = batch["agent/valid"].device
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
    tl_pre = None
    if tl_prepass.prepass_wanted(cfg):
        tl_pre = tl_prepass.tl_rollout_scan(model, tl_tokens, pp.gt_tl_state.float(), tl_forcing,
                                            cfg.time_step_end, cfg.model.temp_window_size, seeds=noise["seeds_tl"])
    buffer = rollout_lib.rollout_train(
        model, cfg, mp_tokens, tl_tokens, ag_attr=pp.ag_attr, ag_type=pp.ag_type, ag_size=pp.ag_size,
        ag_latent=ag_latent, ag_latent_valid=ag_latent_valid, ag_navi=pp.gt_navi,
        ag_navi_valid=pp.gt_valid.any(-1), ag_navi_log_prob=torch.zeros_like(pp.ag_attr[:, :, 0]),
        gt_valid=pp.gt_valid, gt_pose=pp.gt_pose, gt_motion=pp.gt_motion, gt_tl_state=pp.gt_tl_state.float(),
        ag_forcing=ag_forcing, rule_statics=rule_statics, rule_state0=rule_state0, tl_precomputed=tl_pre,
        tl_forcing=tl_forcing, step_seeds=noise["seeds_step"],
        navi_update_inputs=rollout_lib.navi_map_arrays(cfg, batch),
        navi_draw=rollout_lib.navi_draws(noise=noise.get("navi_noise")))
    return training_loss(cfg.training_metrics, buffer, pp.ag_role, navi_pred, pp.gt_navi, latent_post,
                         latent_prior, u_irrelevant=noise["u_irrelevant"], count_sum=count_sum)


def make_train_step(cfg: ExperimentCfg, model: TrafficBots, optimizer: torch.optim.Optimizer,
                    schedule: Optional[torch.optim.lr_scheduler.LRScheduler] = None, device=None,
                    sharded: Optional[ShardedParams] = None):
    """The gradient step: train_step(batch, generator, epoch=0, noise=None) -> metrics.

    Runs on `device` (CUDA unless device="cpu"), where the model must be. With
    `cfg.optimizer.accumulate_grad_batches` k > 1 each call folds its gradients into
    `train_step.accumulator` (a `GradAccumulator`; None when k = 1) and only every k-th call updates.
    An update clips each of the optimizer's groups by `cfg.optimizer.grad_clip_norm`, steps the optimizer
    over the model's parameters in place, then the schedule (`train/optimizer.py::make_optimizer` makes
    both). metrics holds each call's loss terms and, on an update, `grad_norm`, the global norm before
    clipping of the gradients the update applies (with k > 1, their mean over the k calls).

    Over several ranks (the process group up when the step is made) each call takes the batch of this rank's data
    index and `noise` its share of the union's draws; the metrics are the union batch's, the same on every rank.
    `sharded` places the parameters (`parallel/mesh.py::ShardedParams`, whose mesh the step runs on, and over whose
    parameters `optimizer` must be made); without it every parameter is replicated over the ranks (data parallel,
    `parallel.strategy=dp` with model_axis 1). The step gathers the sharded parameters' full values before the
    forward. With accumulation the replicated gradients are summed over the ranks once, on the k-th call (the mean
    over the calls of the ranks' sums is the sum of the ranks' means); sharded ones at every call, since the
    accumulator holds only the shard."""
    device = resolve_device(device)
    model_dev = next(model.parameters()).device
    if model_dev.type != device.type:
        raise ValueError(f"model is on {model_dev}, the step on {device}: build the model on the same device")
    if sharded is None:
        if (cfg.parallel.strategy, cfg.parallel.model_axis) != ("dp", 1):
            raise ValueError(f"parallel.strategy={cfg.parallel.strategy!r} with model_axis={cfg.parallel.model_axis}"
                             " places the parameters on a mesh: pass sharded= (parallel/mesh.py::ShardedParams)")
        sharded = ShardedParams(model, {})
    owned = {id(p) for group in optimizer.param_groups for p in group["params"]}
    if owned != {id(t) for t in sharded.parameters()}:
        raise ValueError("the optimizer must be made over sharded.named_parameters()")
    mesh = sharded.mesh
    if model_count(mesh) != cfg.parallel.model_axis:
        raise ValueError(f"the mesh's model dim is {model_count(mesh)}, parallel.model_axis {cfg.parallel.model_axis}")
    accumulator = make_accumulator(cfg.optimizer, sharded.parameters())
    rank, world, group = data_index(mesh), data_count(mesh), dim_group(mesh, DATA_AXIS)
    count_sum = (lambda counts: all_reduce_sum(counts, group=group)) if world > 1 else None

    def train_step(batch, generator: Optional[torch.Generator] = None, epoch: int = 0, noise=None):
        batch = batch_to_device(batch, device)
        if noise is None:
            noise = draw_training_noise(cfg, batch, generator, device, rank=rank, world=world)
        sharded.gather()
        model.zero_grad(set_to_none=True)
        loss, metrics = training_forward(cfg, model, batch, noise, epoch, count_sum=count_sum)
        loss.backward()
        for p in model.parameters():  # optax updates every parameter: its moments and its decay
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        metrics = {k: v.detach() for k, v in metrics.items()}
        if world > 1:  # the data shards' terms add up to the union's
            metrics = dict(zip(metrics, all_reduce_sum(torch.stack([v.float() for v in metrics.values()]),
                                                       group=group).unbind()))
        reduced = accumulator is None or sharded.sharded
        if reduced:
            sharded.scatter_grads()
        if accumulator is not None and not accumulator.add():
            return metrics
        if not reduced:
            sharded.scatter_grads()
        metrics["grad_norm"] = clip_by_global_norm(optimizer.param_groups, cfg.optimizer.grad_clip_norm,
                                                   sharded.group_squares(optimizer.param_groups))
        optimizer.step()
        if schedule is not None:
            schedule.step()
        return metrics

    train_step.accumulator = accumulator
    return train_step
