"""WOSAC-exact collision check (counterpart of `trafficbotsv15_tpu/sim/wosac_collision.py`).

Corner-rounded boxes, their Minkowski difference and the signed distance of
the origin to it (Waymo's collision metric). The JAX package runs the pair
geometry in structure-of-arrays form with one-hot corner selection, a TPU
layout; here the corners are picked with `torch.gather`, which selects the
same values. Square roots are taken as `sqrt_rn`: correctly rounded, as XLA's.
"""

from __future__ import annotations

from typing import Tuple

import torch

EXTREMELY_LARGE_DISTANCE = 1e10
COLLISION_DISTANCE_THRESHOLD = 0.0
CORNER_ROUNDING_FACTOR = 0.7

_ORDER1 = (0, 0, 1, 1, 2, 2, 3, 3)
_ORDER2 = (0, 1, 1, 2, 2, 3, 3, 0)


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root. On the CPU torch's vectorised
    float32 sqrt can be 1 ULP off (see `ops/knn.py`); the float64 root,
    rounded once, is exact. CUDA's float32 sqrt is already correctly rounded."""
    if x.device.type == "cpu":
        return torch.sqrt(x.double()).to(x.dtype)
    return torch.sqrt(x)


def norm2(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return sqrt_rn(x * x + y * y)


def get_ag_bbox(pose: torch.Tensor, ag_size: torch.Tensor) -> torch.Tensor:
    """Counter-clockwise box corners. pose [n_sc, n_ag, 3], ag_size [n_sc, n_ag, 2]
    (length, width) -> [n_sc, n_ag, 4, 2]."""
    c, s = torch.cos(pose[..., 2]), torch.sin(pose[..., 2])
    heading_f = torch.stack([c, s], -1)
    heading_r = torch.stack([s, -c], -1)
    off_f = 0.5 * ag_size[..., 0:1] * heading_f
    off_r = 0.5 * ag_size[..., 1:2] * heading_r
    corners = torch.stack([off_f - off_r, -off_f - off_r, -off_f + off_r, off_f + off_r], 2)
    return pose[:, :, None, :2] + corners


def _downmost_edge(x: torch.Tensor, y: torch.Tensor):
    """x, y [n_sc, 4, P] ccw corners -> (idx [n_sc, P], unit direction of the edge from it)."""
    idx = torch.argmin(y, 1)
    nxt = (idx + 1) % 4
    sx, sy = torch.gather(x, 1, idx[:, None])[:, 0], torch.gather(y, 1, idx[:, None])[:, 0]
    ex, ey = torch.gather(x, 1, nxt[:, None])[:, 0], torch.gather(y, 1, nxt[:, None])[:, 0]
    dx, dy = ex - sx, ey - sy
    norm = norm2(dx, dy) + 1e-12
    return idx, dx / norm, dy / norm


def _minkowski_sum(x1, y1, x2, y2):
    """Minkowski sum of ccw boxes given as x/y [n_sc, 4, P] -> octagon (px, py) [n_sc, 8, P]."""
    o1 = torch.tensor(_ORDER1, device=x1.device)[None, :, None]
    o2 = torch.tensor(_ORDER2, device=x1.device)[None, :, None]
    idx1, d1x, d1y = _downmost_edge(x1, y1)
    idx2, d2x, d2y = _downmost_edge(x2, y2)
    cond = ((d1x * d2y - d1y * d2x) >= 0.0)[:, None, :]
    sel1 = (torch.where(cond, o2, o1) + idx1[:, None, :]) % 4  # [n_sc, 8, P]
    sel2 = (torch.where(cond, o1, o2) + idx2[:, None, :]) % 4
    px = torch.gather(x1, 1, sel1) + torch.gather(x2, 1, sel2)
    py = torch.gather(y1, 1, sel1) + torch.gather(y2, 1, sel2)
    return px, py


def _signed_distance_origin(px: torch.Tensor, py: torch.Tensor) -> torch.Tensor:
    """Signed distance of the origin to ccw polygons px, py [n_sc, n_pt, P] -> [n_sc, P]."""
    sx, sy = torch.roll(px, -1, 1), torch.roll(py, -1, 1)
    ex, ey = sx - px, sy - py
    length = norm2(ex, ey)
    tx, ty = ex / (length + 1e-12), ey / (length + 1e-12)
    nx, ny = -ty, tx
    vert_dist = norm2(px, py)
    perp = nx * px + ny * py
    is_inside = (perp <= 0).all(1)
    proj = -(tx * px + ty * py) / (length + 1e-12)
    on_edge = (proj >= 0.0) & (proj <= 1.0)
    edge_dist = torch.where(on_edge, perp.abs(), EXTREMELY_LARGE_DISTANCE)
    min_dist = torch.minimum(edge_dist.amin(1), vert_dist.amin(1))
    return torch.where(is_inside, -min_dist, min_dist)


def pairwise_signed_distance_soa(pose: torch.Tensor, ag_size: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Corner-rounded pairwise signed distances [n_sc, n_ag, n_ag].

    pose [n_sc, n_ag, 3]; ag_size [n_sc, n_ag, >=2]; valid [n_sc, n_ag]."""
    n_sc, n_ag, _ = pose.shape
    shrink = torch.minimum(ag_size[..., 0], ag_size[..., 1]) * CORNER_ROUNDING_FACTOR / 2.0
    corners = get_ag_bbox(pose, ag_size[..., :2] - 2.0 * shrink[..., None])
    cx, cy = corners[..., 0], corners[..., 1]  # [n_sc, n_ag, 4]

    def pair(a, as_eval: bool):  # [n_sc, n_ag, 4] -> [n_sc, 4, n_ag * n_ag]
        out = a[:, :, None, :] if as_eval else a[:, None, :, :]
        return out.expand(n_sc, n_ag, n_ag, 4).reshape(n_sc, n_ag * n_ag, 4).transpose(1, 2)

    px, py = _minkowski_sum(pair(cx, True), pair(cy, True), -pair(cx, False), -pair(cy, False))
    sd = _signed_distance_origin(px, py).reshape(n_sc, n_ag, n_ag)
    sd = sd - shrink[:, None, :] - shrink[:, :, None]
    eye = torch.eye(n_ag, dtype=torch.bool, device=pose.device)[None]
    invalid = ~(valid[:, :, None] & valid[:, None, :]) | eye
    return torch.where(invalid, EXTREMELY_LARGE_DISTANCE, sd)


def check_collided_wosac(pose: torch.Tensor, ag_size: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Exact WOSAC collision flag per agent [n_sc, n_ag]."""
    return pairwise_signed_distance_soa(pose, ag_size, valid).amin(2) < COLLISION_DISTANCE_THRESHOLD
