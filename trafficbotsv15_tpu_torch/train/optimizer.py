"""AdamW with global-norm clipping, StepLR and the navi LR group (counterpart of
`trafficbotsv15_tpu/train/optimizer.py::make_optimizer`).

optax's chain
    clip_by_global_norm(grad_clip_norm) -> scale_by_adam(b1, b2, eps=1e-8)
    -> add_decayed_weights(weight_decay) -> scale_by_schedule(step_lr) -> scale(-1)
is, per parameter p at update count t (from 0), p - lr(t) * (adam(g') + weight_decay * p):
`torch.optim.AdamW`'s p * (1 - lr(t) * weight_decay) - lr(t) * adam(g'), with
lr(t) = lr * gamma ** ((t // steps_per_epoch) // scheduler_step_epochs) as a LambdaLR.
The clip, g' = g * max_norm / norm where norm >= max_norm, has no epsilon (unlike
`torch.nn.utils.clip_grad_norm_`, which divides by norm + 1e-6): `clip_by_global_norm`.
With `lr_navi` set apart from `lr`, the `navi_predictor.*` parameters form a second group
(optax.multi_transform): their own clipping norm, and lr_navi in place of lr. Gradient
accumulation (MultiSteps) raises.
"""

from __future__ import annotations

from typing import Iterable, Tuple

import torch

from trafficbotsv15_tpu_torch.config import OptimizerCfg


def make_optimizer(cfg: OptimizerCfg, model: torch.nn.Module, steps_per_epoch: int = 1000
                   ) -> Tuple[torch.optim.AdamW, torch.optim.lr_scheduler.LambdaLR]:
    """(optimizer, schedule): step the schedule after each optimizer step."""
    if cfg.accumulate_grad_batches > 1:
        raise NotImplementedError("gradient accumulation (optax.MultiSteps) is not ported")
    split = cfg.lr_navi is not None and cfg.lr_navi != cfg.lr
    groups = {cfg.lr: [], cfg.lr_navi: []}
    for name, p in model.named_parameters():
        groups[cfg.lr_navi if split and "navi_predictor" in name.split(".")[0] else cfg.lr].append(p)
    opt = torch.optim.AdamW([{"params": ps, "lr": lr} for lr, ps in groups.items() if ps],
                            betas=tuple(cfg.betas), eps=1e-8, weight_decay=cfg.weight_decay, foreach=True)
    decay = lambda t: cfg.scheduler_gamma ** ((t // max(steps_per_epoch, 1)) // cfg.scheduler_step_epochs)
    return opt, torch.optim.lr_scheduler.LambdaLR(opt, decay)


@torch.no_grad()
def clip_by_global_norm(param_groups: Iterable[dict], max_norm: float) -> torch.Tensor:
    """Scale each group's gradients in place by max_norm / norm where the group's global norm is at
    least max_norm, as optax clips each chain of its multi_transform. Returns the global norm of
    all groups' gradients before clipping."""
    squares = []
    for group in param_groups:
        grads = [p.grad for p in group["params"]]
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        torch._foreach_mul_(grads, torch.where(norm < max_norm, 1.0, max_norm / norm))
        squares.append(norm.square())
    return torch.sqrt(sum(squares))
