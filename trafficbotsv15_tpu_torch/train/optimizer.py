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
(optax.multi_transform): their own clipping norm, and lr_navi in place of lr.

Gradient accumulation follows `optax.MultiSteps(chain, every_k_schedule=accumulate_grad_batches)`
(`GradAccumulator`): each call folds its raw gradients into a running mean, acc += (g - acc) / (n + 1);
the k-th call hands the mean to the chain (clip, Adam, decay, StepLR) and resets the mean. Parameters,
moments and the schedule's count stay as they are on the other calls, so the StepLR epoch spans k times
more calls, as in the JAX package. `torch.optim.AdamW` decays the weights on every `step()`, so
`optimizer.step()` and `schedule.step()` run only on the k-th call.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Tuple

import torch

from trafficbotsv15_tpu_torch.config import OptimizerCfg


def make_optimizer(cfg: OptimizerCfg, named_params: Iterable[Tuple[str, torch.Tensor]], steps_per_epoch: int = 1000
                   ) -> Tuple[torch.optim.AdamW, torch.optim.lr_scheduler.LambdaLR]:
    """(optimizer, schedule) over (name, tensor) pairs (a module's `named_parameters()`, or what
    `parallel/mesh.py::ShardedParams` places): step the schedule after each optimizer step."""
    if cfg.accumulate_grad_batches < 1:
        raise ValueError(f"accumulate_grad_batches must be at least 1, not {cfg.accumulate_grad_batches}")
    split = cfg.lr_navi is not None and cfg.lr_navi != cfg.lr
    groups = {cfg.lr: [], cfg.lr_navi: []}
    for name, p in named_params:
        groups[cfg.lr_navi if split and "navi_predictor" in name.split(".")[0] else cfg.lr].append(p)
    opt = torch.optim.AdamW([{"params": ps, "lr": lr} for lr, ps in groups.items() if ps],
                            betas=tuple(cfg.betas), eps=1e-8, weight_decay=cfg.weight_decay, foreach=True)
    decay = lambda t: cfg.scheduler_gamma ** ((t // max(steps_per_epoch, 1)) // cfg.scheduler_step_epochs)
    return opt, torch.optim.lr_scheduler.LambdaLR(opt, decay)


@torch.no_grad()
def clip_by_global_norm(param_groups: Iterable[dict], max_norm: float, squares: torch.Tensor) -> torch.Tensor:
    """Scale each group's gradients in place by max_norm / norm where the group's global norm is at
    least max_norm, as optax clips each chain of its multi_transform. squares: [n_groups], each group's
    squared global norm (`parallel/mesh.py::ShardedParams.group_squares`, over the whole parameters where
    the gradients are shards). Returns the global norm of all groups' gradients before clipping."""
    norms = squares.sqrt()
    for group, norm in zip(param_groups, norms.unbind()):
        torch._foreach_mul_([p.grad for p in group["params"]], torch.where(norm < max_norm, 1.0, max_norm / norm))
    return squares.sum().sqrt()


class GradAccumulator:
    """optax.MultiSteps' gradient mean over `k` calls, one float32 buffer per parameter.

    `add()` folds each parameter's `.grad` into the mean and returns True on the k-th call,
    after writing the mean into `.grad` and resetting the buffers; on the other calls it returns
    False and the caller leaves the parameters alone."""

    def __init__(self, params: Iterable[torch.nn.Parameter], k: int):
        self.params: List[torch.nn.Parameter] = list(params)
        self.k = int(k)
        self.mini_step = 0
        self.acc = [torch.zeros_like(p, dtype=torch.float32) for p in self.params]

    @torch.no_grad()
    def add(self) -> bool:
        grads = [p.grad.float() for p in self.params]
        diff = torch._foreach_sub(grads, self.acc)
        torch._foreach_div_(diff, float(self.mini_step + 1))
        torch._foreach_add_(self.acc, diff)
        self.mini_step += 1
        if self.mini_step < self.k:
            return False
        for p, a in zip(self.params, self.acc):
            p.grad = a.to(p.dtype, copy=True)
        torch._foreach_zero_(self.acc)
        self.mini_step = 0
        return True

    def state_dict(self) -> dict:
        return {"mini_step": self.mini_step, "acc": [a.detach() for a in self.acc]}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        self.mini_step = int(state["mini_step"])
        for a, saved in zip(self.acc, state["acc"], strict=True):
            a.copy_(saved)


def make_accumulator(cfg: OptimizerCfg, params: Iterable[torch.Tensor]) -> Optional[GradAccumulator]:
    """A GradAccumulator over params (what the optimizer owns) when cfg accumulates over more than one call, else
    None (`make_optimizer` refuses fewer than one)."""
    return GradAccumulator(params, cfg.accumulate_grad_batches) if cfg.accumulate_grad_batches > 1 else None
