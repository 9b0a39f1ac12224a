"""Pose embeddings (counterpart of `trafficbotsv15_tpu/ops/pose_emb.py`).

Four modes, each a parameter-free function of float32 coordinates:
`pe_xy_yaw` (the default relative-pose RPE and agent tokens), `mpa_pl` (map
nodes), `xy_dir` (raw x, y, cos, sin: a 4-wide RPE) and `pe_xy_dir`
(sinusoids of x, y, cos and sin, each pe_dim // 4 wide, in the JAX package's
stacked feature order).
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class PoseEmbConfig:
    mode: str
    pe_dim: int = 256
    theta_xy: float = 1e3
    theta_cs: float = 1e1


def pose_emb_out_dim(cfg: PoseEmbConfig) -> int:
    if cfg.mode == "xy_dir":
        return 4
    if cfg.mode == "mpa_pl":
        return 7
    if cfg.mode in ("pe_xy_dir", "pe_xy_yaw"):
        return cfg.pe_dim
    raise ValueError(f"pose embedding {cfg.mode!r}")


def sinusoid_embed(x: torch.Tensor, dim: int, theta: float) -> torch.Tensor:
    """concat(cos(x*f), sin(x*f)), f_i = theta^(-2i/dim). x: [...] -> [..., dim]."""
    half = dim // 2
    exponents = torch.arange(0, dim, 2, dtype=torch.float32, device=x.device)[:half] / dim
    freqs = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32, device=x.device), exponents)
    ang = x[..., None].float() * freqs
    return torch.cat([torch.cos(ang), torch.sin(ang)], -1)


def sinusoid_embed_rad(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Angular embedding with integer frequencies 1..dim/2. x: [...] -> [..., dim]."""
    freqs = torch.arange(1, dim // 2 + 1, dtype=torch.float32, device=x.device)
    ang = x[..., None].float() * freqs
    return torch.cat([torch.cos(ang), torch.sin(ang)], -1)


def _as_cos_sin(direction: torch.Tensor) -> torch.Tensor:
    if direction.shape[-1] == 1:
        yaw = direction[..., 0]
        return torch.stack([torch.cos(yaw), torch.sin(yaw)], -1)
    return direction


def _as_yaw(direction: torch.Tensor) -> torch.Tensor:
    if direction.shape[-1] == 1:
        return direction[..., 0]
    return torch.atan2(direction[..., 1], direction[..., 0])


def _norm2(v: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    """Euclidean norm over a last axis of size 2, as sqrt(x*x + y*y)."""
    out = torch.sqrt(v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1])
    return out[..., None] if keepdim else out


def pose_embed_mpa_pl(xy: torch.Tensor, direction: torch.Tensor) -> torch.Tensor:
    """MPA closest-point polyline features [r_norm, unit closest (2), unit seg (2), seg len, end dist]."""
    direction = _as_cos_sin(direction)
    eps = torch.finfo(xy.dtype).eps
    seg_start, seg_vec = xy, direction
    proj = torch.sum(-seg_start * seg_vec, -1) / (torch.sum(seg_vec * seg_vec, -1) + eps)
    closest = seg_start + torch.clamp(proj, 0.0, 1.0)[..., None] * seg_vec
    r_norm = _norm2(closest, keepdim=True)
    seg_norm = _norm2(seg_vec, keepdim=True)
    end_dist = _norm2(seg_start + seg_vec - closest, keepdim=True)
    return torch.cat([r_norm, closest / (r_norm + eps), seg_vec / (seg_norm + eps), seg_norm, end_dist], -1)


def pose_embed_xy_dir(xy: torch.Tensor, direction: torch.Tensor) -> torch.Tensor:
    """Raw (x, y, cos, sin) features [..., 4]."""
    return torch.cat([xy, _as_cos_sin(direction)], -1)


def pose_embed_pe_xy_dir(xy: torch.Tensor, direction: torch.Tensor, pe_dim: int, theta_xy: float,
                         theta_cs: float) -> torch.Tensor:
    """Sinusoids of (x, y, cos, sin), pe_dim // 4 each: per quantity cos then sin of its pe_dim // 8 frequencies
    (theta_xy's for x and y, theta_cs's for cos and sin), the JAX package's stacked form
    (stack([cos, sin], -2).reshape), whose angles are the same float32 products."""
    q = torch.cat([xy, _as_cos_sin(direction)], -1).float()  # [..., 4]
    quarter = pe_dim // 4
    half = quarter // 2
    exponents = torch.arange(0, quarter, 2, dtype=torch.float32, device=q.device)[:half] / quarter
    f_xy = 1.0 / torch.pow(torch.tensor(theta_xy, dtype=torch.float32, device=q.device), exponents)
    f_cs = 1.0 / torch.pow(torch.tensor(theta_cs, dtype=torch.float32, device=q.device), exponents)
    ang = q[..., :, None] * torch.stack([f_xy, f_xy, f_cs, f_cs])  # [..., 4, half]
    return torch.stack([torch.cos(ang), torch.sin(ang)], -2).reshape(*q.shape[:-1], pe_dim)


def pose_embed_pe_xy_yaw(xy: torch.Tensor, direction: torch.Tensor, pe_dim: int, theta_xy: float) -> torch.Tensor:
    """Sinusoidal x and y (pe_dim//4 each) + angular yaw (pe_dim//2)."""
    yaw = _as_yaw(direction)
    quarter = pe_dim // 4
    return torch.cat([
        sinusoid_embed(xy[..., 0], quarter, theta_xy),
        sinusoid_embed(xy[..., 1], quarter, theta_xy),
        sinusoid_embed_rad(yaw, pe_dim // 2),
    ], -1)


def apply_pose_emb(cfg: PoseEmbConfig, xy: torch.Tensor, direction: torch.Tensor) -> torch.Tensor:
    """xy: [..., 2], direction: yaw [..., 1] or cos/sin [..., 2]."""
    if cfg.mode == "mpa_pl":
        return pose_embed_mpa_pl(xy, direction)
    if cfg.mode == "pe_xy_yaw":
        return pose_embed_pe_xy_yaw(xy, direction, cfg.pe_dim, cfg.theta_xy)
    if cfg.mode == "xy_dir":
        return pose_embed_xy_dir(xy, direction)
    if cfg.mode == "pe_xy_dir":
        return pose_embed_pe_xy_dir(xy, direction, cfg.pe_dim, cfg.theta_xy, cfg.theta_cs)
    raise ValueError(f"pose embedding {cfg.mode!r}")
