"""Training dropout with explicit, replayable random streams.

The JAX package draws every dropout mask from a `dropout` key handed to
`model.apply`; in evaluation (`deterministic=True`) no mask is drawn. The
port's counterpart is a scope: inside `dropout_scope(seed, device)` every
`dropout(x, p)` call draws its mask, in call order, from one
`torch.Generator` seeded with `seed`; outside any scope `dropout` returns its
input untouched, so evaluation is bit-equal to a model without dropout.

A rollout step that `torch.utils.checkpoint` recomputes during the backward
pass enters the same scope with the same seed at its start, so the recompute
draws the same masks in the same order as the forward did (checkpoint itself
restores only the global RNG states, not an explicit generator).

Masks follow flax's `nn.Dropout`: keep with probability 1 - p, kept values
scaled by 1 / (1 - p).
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Optional

import torch

# the active scope's generator; a context variable, so threads and tasks each see their own
_GEN: contextvars.ContextVar[Optional[torch.Generator]] = contextvars.ContextVar("dropout_generator", default=None)


@contextlib.contextmanager
def dropout_scope(seed: Optional[int], device):
    """Dropout on, its masks drawn from a generator seeded with `seed` (off when seed is None)."""
    gen = None if seed is None else torch.Generator(device=torch.device(device)).manual_seed(int(seed))
    token = _GEN.set(gen)
    try:
        yield
    finally:
        _GEN.reset(token)


def active() -> bool:
    return _GEN.get() is not None


def dropout(x: torch.Tensor, p: float) -> torch.Tensor:
    gen = _GEN.get()
    if p <= 0 or gen is None:
        return x
    keep = torch.rand(x.shape, generator=gen, device=x.device) < 1.0 - p
    return torch.where(keep, x / (1.0 - p), 0.0).to(x.dtype)


def generator() -> torch.Generator:
    """The active scope's generator (the draws of a training rollout step: sampled actions, re-predicted navi)."""
    gen = _GEN.get()
    if gen is None:
        raise RuntimeError("draws from the dropout stream need an active dropout_scope")
    return gen


def normal(shape, device) -> torch.Tensor:
    """Standard normal draws from the scope's stream (sampled actions inside a rollout step)."""
    return torch.randn(shape, generator=generator(), device=device)
