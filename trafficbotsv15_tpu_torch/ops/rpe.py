"""Relative pose and KNN target selection (counterpart of `trafficbotsv15_tpu/ops/rpe.py`).

All selections are the stable sort's: ascending distance, ties by ascending
target index, +inf for invalid pairs. `get_tgt_knn_lazy` routes the wide
agent->map relation through the CUDA kernel of `ops/knn.py` under the JAX
package's gate; every other relation sorts in plain PyTorch. Everything
here is stop-gradient, as in the JAX package: the poses are detached first.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from trafficbotsv15_tpu_torch.ops import knn
from trafficbotsv15_tpu_torch.ops.transform import pos2local, rad2local, rad2rot

_INF = float("inf")


def _norm2(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1])


def _knn_select(rel_dist: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dist, idx) of the k smallest along the last axis, stable tie order."""
    d, i = torch.sort(rel_dist, dim=-1, stable=True)
    return d[..., :k], i[..., :k]


def get_rel_pose(pose, invalid, pose2=None, invalid2=None):
    """Target j in the frame of source i.

    pose [n_sc, n_src, 3], invalid [n_sc, n_src] (targets default to the sources)
    -> rel_pose [n_sc, n_src, n_tgt, 3], rel_dist [n_sc, n_src, n_tgt] (+inf where invalid).
    """
    pose = pose.detach()
    pose2 = pose if pose2 is None else pose2.detach()
    if invalid2 is None:
        invalid2 = invalid
    xy, yaw = pose[..., :2], pose[..., 2]
    xy2, yaw2 = pose2[..., :2], pose2[..., 2]
    local_xy = pos2local(xy2[:, None, :, :], xy[:, :, None, :], rad2rot(yaw))
    local_yaw = rad2local(yaw2[:, None, :], yaw, cast=False)
    rel_pose = torch.cat([local_xy, local_yaw[..., None]], -1)
    rel_dist = _norm2(rel_pose[..., :2])
    rel_dist = torch.where(invalid[:, :, None] | invalid2[:, None, :], _INF, rel_dist)
    return rel_pose, rel_dist


def get_tgt_knn(rel_pose: Optional[torch.Tensor], rel_dist: torch.Tensor, n_tgt_knn: int, dist_limit):
    """K nearest per source from a distance tensor that carries +inf on invalid pairs.

    Returns idx [n_sc, n_src, K] int64, invalid [n_sc, n_src, K], rpe [.., K, 3] or None.
    """
    n_tgt = rel_dist.shape[-1]
    if not 0 < n_tgt_knn < n_tgt:
        raise ValueError(f"need 0 < K < n_tgt, got K={n_tgt_knn}, n_tgt={n_tgt}")
    dist_knn, idx = _knn_select(rel_dist, n_tgt_knn)
    rpe = None
    if rel_pose is not None:
        rpe = torch.gather(rel_pose, 2, idx[..., None].expand(-1, -1, -1, rel_pose.shape[-1]))
    return idx, dist_knn > dist_limit, rpe


def get_tgt_knn_lazy(src_pose, src_invalid, tgt_pose, tgt_invalid, n_tgt_knn: int, dist_limit,
                     knn_kernel_on: bool = True):
    """get_rel_pose + get_tgt_knn with the SE(2) math on the K winners only.

    The selection runs on global-frame distances (rotation-invariant); with
    the JAX package's gate (`knn.knn_wanted`) it goes through `knn.knn_xy`,
    which launches the CUDA kernel for CUDA tensors.
    Returns (idx [n_sc, n_src, K] int64, invalid [n_sc, n_src, K], rpe [n_sc, n_src, K, 3]).
    """
    src_pose, tgt_pose = src_pose.detach(), tgt_pose.detach()
    src_xy, src_yaw = src_pose[..., :2], src_pose[..., 2]
    tgt_xy = tgt_pose[..., :2]
    if knn.knn_wanted(src_xy.shape[1], tgt_xy.shape[1], knn_kernel_on):
        dist_knn, idx = knn.knn_xy(src_xy.float().contiguous(), src_invalid.contiguous(),
                                   tgt_xy.float().contiguous(), tgt_invalid.contiguous(), n_tgt_knn)
        idx = idx.long()
    else:
        d = src_xy[:, :, None, :] - tgt_xy[:, None, :, :]
        rel_dist = torch.where(src_invalid[:, :, None] | tgt_invalid[:, None, :], _INF, _norm2(d))
        dist_knn, idx = _knn_select(rel_dist, n_tgt_knn)
    tgt_pose_knn = gather_tgt(tgt_pose, idx)
    local_xy = pos2local(tgt_pose_knn[..., :2], src_xy[:, :, None, :], rad2rot(src_yaw))
    local_yaw = rad2local(tgt_pose_knn[..., 2], src_yaw, cast=False)
    rpe = torch.cat([local_xy, local_yaw[..., None]], -1)
    return idx, dist_knn > dist_limit, rpe


def gather_tgt(feature: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """feature [n_sc, n_tgt, d], idx [n_sc, n_src, K] -> [n_sc, n_src, K, d] (plain index gather)."""
    n_sc, n_src, k = idx.shape
    flat = idx.reshape(n_sc, n_src * k, 1).expand(-1, -1, feature.shape[-1])
    return torch.gather(feature, 1, flat).reshape(n_sc, n_src, k, feature.shape[-1])
