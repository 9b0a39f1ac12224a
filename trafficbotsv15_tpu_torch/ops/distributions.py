"""Distributions and the balanced KL (counterpart of `trafficbotsv15_tpu/ops/distributions.py`).

Sampling takes an explicit `torch.Generator`; draws are made on the
generator's device and moved to the distribution's, so one seed gives the
same futures on any device. `noise(generator)` draws a distribution's noise
alone and `rsample(noise)` turns given noise into the draw, so that a caller
can hand in noise drawn elsewhere (the JAX package's, in the parity tests).
The categoricals draw by Gumbel-max, the algorithm of
`jax.random.categorical`: argmax(logits + Gumbel noise of the logits' shape).
`deterministic` may be a bool or a bool mask over the batch dims (the WOSAC
K0 future takes the mode per element).
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


def gumbel_noise(shape, generator: torch.Generator, device) -> torch.Tensor:
    """Standard Gumbel noise of `shape` (float32) on `device`, its uniforms drawn on the generator's device."""
    u = torch.rand(tuple(shape), generator=generator, dtype=torch.float32, device=generator.device).to(device)
    return -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))


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
        return torch.where(det[..., None], self.mean, self.rsample(self.noise(generator)))

    def noise(self, generator: torch.Generator) -> torch.Tensor:
        """Standard-normal noise of the mean's shape, drawn on the generator's device."""
        return torch.randn(self.mean.shape, generator=generator, dtype=torch.float32,
                           device=generator.device).to(self.mean.device, self.mean.dtype)

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
        return torch.where(mask, det_idx, self.rsample(self.noise(generator))).to(torch.int32)

    def noise(self, generator: torch.Generator) -> torch.Tensor:
        """Standard Gumbel noise of the logits' shape (float32), drawn on the generator's device."""
        return gumbel_noise(self.logits.shape, generator, self.logits.device)

    def rsample(self, gumbel: torch.Tensor) -> torch.Tensor:
        """The draw for given Gumbel noise: argmax(logits + gumbel) (int32)."""
        return torch.argmax(self.logits.float() + gumbel.float(), -1).to(torch.int32)

    def repeat(self, repeats: int, dim: int) -> "DestCategorical":
        return DestCategorical(_repeat(self.logits, repeats, dim), _repeat(self.valid, repeats, dim))


@dataclasses.dataclass
class MultiCategorical:
    """Independent one-hot categoricals with straight-through draws: logits [..., n_cat, n_class]; a draw is the
    one-hot flattened to [..., n_cat * n_class], whose gradient flows through the probabilities."""

    logits: torch.Tensor
    valid: Optional[torch.Tensor] = None

    @property
    def n_cat(self) -> int:
        return self.logits.shape[-2]

    @property
    def n_class(self) -> int:
        return self.logits.shape[-1]

    @property
    def probs(self) -> torch.Tensor:
        return torch.softmax(self.logits, -1)

    def log_prob(self, sample_flat: torch.Tensor) -> torch.Tensor:
        one_hot = sample_flat.reshape(*sample_flat.shape[:-1], self.n_cat, self.n_class)
        return torch.sum(one_hot * torch.log_softmax(self.logits, -1), (-1, -2))

    def _flat(self, x: torch.Tensor) -> torch.Tensor:
        return x.reshape(*self.logits.shape[:-2], self.n_cat * self.n_class)

    def _mode(self) -> torch.Tensor:
        """The argmax one-hot (the first class on a tie, as jnp.argmax), without gradient."""
        idx = torch.argmax(self.logits, -1)
        return torch.nn.functional.one_hot(idx, self.n_class).to(self.logits.dtype)

    def sample(self, generator: torch.Generator, deterministic: Union[bool, torch.Tensor] = False):
        """The straight-through draw; the argmax one-hot where `deterministic`."""
        mask = _det_mask(deterministic, self.logits.shape[:-2], self.logits.device)
        det = self._mode()
        if bool(mask.all()):
            return self._flat(det)
        out = torch.where(mask[..., None, None], det, self._straight_through(self.noise(generator)))
        return self._flat(out)

    def noise(self, generator: torch.Generator) -> torch.Tensor:
        """Standard Gumbel noise of the logits' shape [..., n_cat, n_class] (float32)."""
        return gumbel_noise(self.logits.shape, generator, self.logits.device)

    def _straight_through(self, gumbel: torch.Tensor) -> torch.Tensor:
        idx = torch.argmax(self.logits.float() + gumbel.float(), -1)
        one_hot = torch.nn.functional.one_hot(idx, self.n_class).to(self.logits.dtype)
        probs = self.probs
        return one_hot + probs - probs.detach()

    def rsample(self, gumbel: torch.Tensor) -> torch.Tensor:
        """The straight-through draw for given Gumbel noise: the one-hot of argmax(logits + gumbel) in value, the
        probabilities' gradient, flattened to [..., n_cat * n_class]."""
        return self._flat(self._straight_through(gumbel))

    def detach(self) -> "MultiCategorical":
        return MultiCategorical(self.logits.detach(), self.valid)

    def repeat(self, repeats: int, dim: int) -> "MultiCategorical":
        return MultiCategorical(_repeat(self.logits, repeats, dim), _repeat(self.valid, repeats, dim))


def kl_diag_gaussian(p: DiagGaussian, q: DiagGaussian) -> torch.Tensor:
    """KL(p || q), summed over the event axis."""
    var_ratio = (p.std / q.std) ** 2
    t1 = ((p.mean - q.mean) / q.std) ** 2
    return 0.5 * torch.sum(var_ratio + t1 - 1.0 - torch.log(var_ratio), -1)


def kl_multi_categorical(p: MultiCategorical, q: MultiCategorical) -> torch.Tensor:
    """KL(p || q), summed over the categorical factors."""
    logp = torch.log_softmax(p.logits, -1)
    logq = torch.log_softmax(q.logits, -1)
    return torch.sum(torch.sum(torch.exp(logp) * (logp - logq), -1), -1)


_KL = {DiagGaussian: kl_diag_gaussian, MultiCategorical: kl_multi_categorical}


def balanced_kl(posterior, prior, alpha: float, free_nats: float) -> torch.Tensor:
    """DreamerV2-style balanced KL with free nats, for a pair of `DiagGaussian`s or of `MultiCategorical`s:
    max(KL(sg(post) || prior), free) + alpha * max(KL(post || sg(prior)), free)."""
    kl = _KL[type(posterior)]
    if alpha > 0:
        e0 = kl(posterior.detach(), prior)
        e1 = kl(posterior, prior.detach())
        if free_nats > 0:
            e0, e1 = e0.clamp_min(free_nats), e1.clamp_min(free_nats)
        return e0 + alpha * e1
    err = kl(posterior, prior)
    return err.clamp_min(free_nats) if free_nats > 0 else err
