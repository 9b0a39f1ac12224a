"""SE(2) transform helpers (counterpart of `trafficbotsv15_tpu/ops/transform.py`).

Rotations are applied as explicit multiply-adds on the last axis, the same
arithmetic as the JAX package, so pose math stays in float32.
"""

from __future__ import annotations

import math

import torch

TWO_PI = 2.0 * math.pi


def cast_rad(angle: torch.Tensor) -> torch.Tensor:
    """Wrap angles into the [-pi, pi) range."""
    return torch.remainder(angle + math.pi, TWO_PI) - math.pi


def rad2rot(rad: torch.Tensor) -> torch.Tensor:
    """Yaw [...] -> rotation matrices [..., 2, 2], rows [[cos, -sin], [sin, cos]]."""
    c, s = torch.cos(rad), torch.sin(rad)
    return torch.stack([torch.stack([c, -s], -1), torch.stack([s, c], -1)], -2)


def _rot_apply(d: torch.Tensor, rot: torch.Tensor, transpose: bool) -> torch.Tensor:
    """Right-multiply [..., M, 2] vectors by [..., 2, 2] rotations."""
    if transpose:
        r00, r01 = rot[..., None, 0, 0], rot[..., None, 1, 0]
        r10, r11 = rot[..., None, 0, 1], rot[..., None, 1, 1]
    else:
        r00, r01 = rot[..., None, 0, 0], rot[..., None, 0, 1]
        r10, r11 = rot[..., None, 1, 0], rot[..., None, 1, 1]
    x, y = d[..., 0], d[..., 1]
    return torch.stack([x * r00 + y * r10, x * r01 + y * r11], -1)


def pos2local(pos: torch.Tensor, local_pos: torch.Tensor, local_rot: torch.Tensor) -> torch.Tensor:
    """World points [..., M, 2] into the frame at local_pos [..., 1, 2] / local_rot [..., 2, 2]."""
    return _rot_apply(pos - local_pos, local_rot, transpose=False)


def rad2local(rad: torch.Tensor, local_rad: torch.Tensor, cast: bool = True) -> torch.Tensor:
    """Angles [..., M] minus frame yaw [...]; optionally wrapped to [-pi, pi)."""
    out = rad - local_rad[..., None]
    return cast_rad(out) if cast else out


def pos2global(pos: torch.Tensor, local_pos: torch.Tensor, local_rot: torch.Tensor) -> torch.Tensor:
    """Inverse of `pos2local`: points [..., M, 2] of the frame back into the world."""
    return _rot_apply(pos, local_rot, transpose=True) + local_pos


def rad2global(rad: torch.Tensor, local_rad: torch.Tensor) -> torch.Tensor:
    """Inverse of `rad2local` (always wraps)."""
    return cast_rad(rad + local_rad[..., None])
