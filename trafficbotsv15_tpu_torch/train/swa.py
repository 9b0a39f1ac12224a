"""Stochastic weight averaging and an exponential moving average of the parameters (counterpart of
`trafficbotsv15_tpu/train/swa.py`).

Both work in place on lists of tensors with `torch._foreach_*` ops:
  - SWA is an equal-weight running average of the parameters from `start_step` on. Its state is
    (avg, count), count a 0-d float32 tensor on the parameters' device; whether a step counts is a
    tensor flag, so an update never reads a value back to the host;
  - the EMA is kept in float32: e <- e * decay + p * (1 - decay).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

Tensors = List[torch.Tensor]


@torch.no_grad()
def swa_init(params: Sequence[torch.Tensor]) -> Tuple[Tensors, torch.Tensor]:
    """(zeros like each parameter, count 0)."""
    return [torch.zeros_like(p) for p in params], torch.zeros((), dtype=torch.float32, device=params[0].device)


@torch.no_grad()
def swa_update(swa_state: Tuple[Tensors, torch.Tensor], params: Sequence[torch.Tensor], step, start_step: int
               ) -> Tuple[Tensors, torch.Tensor]:
    """Fold params into the average where step >= start_step: avg += (p - avg) * take / max(count + take, 1)."""
    avg, count = swa_state
    take = (torch.as_tensor(step, device=count.device) >= start_step).float()
    count.add_(take)
    w = take / torch.clamp(count, min=1.0)
    diff = torch._foreach_sub([p.detach() for p in params], avg)
    torch._foreach_mul_(diff, w)
    torch._foreach_add_(avg, diff)
    return avg, count


@torch.no_grad()
def swa_params(swa_state: Tuple[Tensors, torch.Tensor], fallback: Sequence[torch.Tensor]) -> Tensors:
    """The averaged parameters, or `fallback` while no step has been folded in."""
    avg, count = swa_state
    return [torch.where(count > 0, a, p.detach()) for a, p in zip(avg, fallback)]


@torch.no_grad()
def ema_init(params: Sequence[torch.Tensor]) -> Tensors:
    """float32 copies of the parameters (a copy even where they are float32 already)."""
    return [p.detach().to(torch.float32, copy=True) for p in params]


@torch.no_grad()
def ema_update(ema: Tensors, params: Sequence[torch.Tensor], decay: float = 0.999) -> Tensors:
    """e <- e * decay + p * (1 - decay), in place."""
    torch._foreach_mul_(ema, decay)
    torch._foreach_add_(ema, torch._foreach_mul([p.detach().float() for p in params], 1.0 - decay))
    return ema
