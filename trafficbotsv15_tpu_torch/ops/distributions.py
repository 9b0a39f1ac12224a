"""Distributions and the balanced KL (counterpart of `trafficbotsv15_tpu/ops/distributions.py`).

Sampling takes an explicit `torch.Generator`; draws are made on the
generator's device and moved to the distribution's, so one seed gives the
same futures on any device. `deterministic` may be a bool or a bool mask
over the batch dims (the WOSAC K0 future takes the mode per element).
JAX keys and torch generators never give the same draws.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Union

import torch

_LOG2PI = math.log(2.0 * math.pi)


def _det_mask(deterministic: Union[bool, torch.Tensor], shape, device) -> torch.Tensor:
    """Normalize bool-or-mask `deterministic` to a bool mask of `shape`."""
    if isinstance(deterministic, bool):
        return torch.full(shape, deterministic, dtype=torch.bool, device=device)
    return torch.broadcast_to(deterministic.to(device), shape)


def _repeat(t: Optional[torch.Tensor], repeats: int, dim: int):
    return None if t is None else torch.repeat_interleave(t, repeats, dim=dim)


@dataclasses.dataclass
class DiagGaussian:
    """Independent Normal over the last axis. mean/std: [..., d]."""

    mean: torch.Tensor
    std: torch.Tensor
    valid: Optional[torch.Tensor] = None

    def log_prob(self, x: torch.Tensor) -> torch.Tensor:
        z = (x - self.mean) / self.std
        return torch.sum(-0.5 * (z * z + _LOG2PI) - torch.log(self.std), -1)

    def sample(self, generator: torch.Generator, deterministic: Union[bool, torch.Tensor] = False):
        det = _det_mask(deterministic, self.mean.shape[:-1], self.mean.device)
        if bool(det.all()):
            return self.mean
        eps = torch.randn(self.mean.shape, generator=generator, dtype=torch.float32,
                          device=generator.device).to(self.mean.device, self.mean.dtype)
        return torch.where(det[..., None], self.mean, self.rsample(eps))

    def rsample(self, eps: torch.Tensor) -> torch.Tensor:
        """Reparameterised draw for given standard-normal noise: gradients reach mean and std."""
        return self.mean + self.std * eps.to(self.mean.dtype)

    def detach(self) -> "DiagGaussian":
        return DiagGaussian(self.mean.detach(), self.std.detach(), self.valid)

    def repeat(self, repeats: int, dim: int) -> "DiagGaussian":
        return DiagGaussian(_repeat(self.mean, repeats, dim), _repeat(self.std, repeats, dim),
                            _repeat(self.valid, repeats, dim))


@dataclasses.dataclass
class DestCategorical:
    """Plain categorical over map polylines (the navigation destination)."""

    logits: torch.Tensor  # [..., n_mp]
    valid: Optional[torch.Tensor] = None

    def log_prob(self, sample: torch.Tensor) -> torch.Tensor:
        logp = torch.log_softmax(self.logits, -1)
        return torch.gather(logp, -1, sample[..., None].long())[..., 0]

    def sample(self, generator: torch.Generator, deterministic: Union[bool, torch.Tensor] = False):
        """Gumbel-max draw (the same algorithm as jax.random.categorical); the
        argmax where `deterministic`."""
        det_idx = torch.argmax(self.logits, -1)
        mask = _det_mask(deterministic, self.logits.shape[:-1], self.logits.device)
        if bool(mask.all()):
            return det_idx.to(torch.int32)
        u = torch.rand(self.logits.shape, generator=generator, dtype=torch.float32,
                       device=generator.device).to(self.logits.device)
        tiny = torch.finfo(torch.float32).tiny
        gumbel = -torch.log(-torch.log(u.clamp_min(tiny)))
        rnd = torch.argmax(self.logits.float() + gumbel, -1)
        return torch.where(mask, det_idx, rnd).to(torch.int32)

    def repeat(self, repeats: int, dim: int) -> "DestCategorical":
        return DestCategorical(_repeat(self.logits, repeats, dim), _repeat(self.valid, repeats, dim))


def kl_diag_gaussian(p: DiagGaussian, q: DiagGaussian) -> torch.Tensor:
    """KL(p || q), summed over the event axis."""
    var_ratio = (p.std / q.std) ** 2
    t1 = ((p.mean - q.mean) / q.std) ** 2
    return 0.5 * torch.sum(var_ratio + t1 - 1.0 - torch.log(var_ratio), -1)


def balanced_kl(posterior: DiagGaussian, prior: DiagGaussian, alpha: float, free_nats: float) -> torch.Tensor:
    """DreamerV2-style balanced KL with free nats:
    max(KL(sg(post) || prior), free) + alpha * max(KL(post || sg(prior)), free)."""
    if not isinstance(posterior, DiagGaussian):
        raise NotImplementedError(f"balanced_kl of {type(posterior).__name__} is not ported (diag_gaus only)")
    if alpha > 0:
        e0 = kl_diag_gaussian(posterior.detach(), prior)
        e1 = kl_diag_gaussian(posterior, prior.detach())
        if free_nats > 0:
            e0, e1 = e0.clamp_min(free_nats), e1.clamp_min(free_nats)
        return e0 + alpha * e1
    err = kl_diag_gaussian(posterior, prior)
    return err.clamp_min(free_nats) if free_nats > 0 else err
