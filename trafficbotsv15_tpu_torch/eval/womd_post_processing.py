"""WOMD motion-prediction post-processing: K joint futures -> k_pred marginal modes
(counterpart of `trafficbotsv15_tpu/eval/womd_post_processing.py`).

Top-k, MTR-NMS and MPA-NMS run on the tensors' device; the k-means EM
aggregation (`aggr_thresh`, off in the flagship config) runs on the host in
numpy, as in the JAX package, for its data-dependent empty-cluster splits.
Ties are broken as the JAX package breaks them: `jax.lax.top_k` and
`jnp.argsort` keep the lower index first, so selection goes through a stable
sort, and `argmax` takes the first maximum in both.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from trafficbotsv15_tpu_torch.config import WOMDPostCfg
from trafficbotsv15_tpu_torch.sim.wosac_collision import norm2


def _within_dist(xy: torch.Tensor, thresh: torch.Tensor, use_ade: bool) -> torch.Tensor:
    """xy [n_sc, n_ag, K, n_step, 2] -> bool [n_sc, n_ag, K, K]."""
    if use_ade:
        d = xy[:, :, None] - xy[:, :, :, None]
        d = norm2(d[..., 0], d[..., 1]).mean(-1)
    else:
        last = xy[:, :, :, -1]
        d = last[:, :, None] - last[:, :, :, None]
        d = norm2(d[..., 0], d[..., 1])
    return d < thresh


def _type_thresh(ag_type: torch.Tensor, type_thresh) -> torch.Tensor:
    thresh = torch.zeros(ag_type.shape[:2], device=ag_type.device)
    for i, t in enumerate(type_thresh):
        thresh = thresh + ag_type[:, :, i] * t
    return thresh[:, :, None, None]


def _take_modes(trajs: torch.Tensor, scores: torch.Tensor, idx: torch.Tensor):
    """Modes idx [n_sc, n_ag, k] of trajs [n_sc, n_ag, K, n_step, 3] and scores, the scores renormalised."""
    trajs_k = torch.gather(trajs, 2, idx[:, :, :, None, None].expand(-1, -1, -1, *trajs.shape[3:]))
    scores_k = torch.gather(scores, 2, idx)
    return trajs_k, scores_k / scores_k.sum(-1, keepdim=True)


def traj_topk(trajs: torch.Tensor, scores: torch.Tensor, k_pred: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """trajs [n_sc, n_ag, K, n_step, 3], scores [n_sc, n_ag, K] -> the k_pred best, ties to the lower index."""
    idx = torch.sort(scores, dim=-1, descending=True, stable=True).indices[..., :k_pred]
    return _take_modes(trajs, scores, idx)


def mtr_nms(trajs: torch.Tensor, scores: torch.Tensor, k_pred: int, type_thresh, use_ade: bool,
            ag_type: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy NMS selection of k_pred modes. `scores` must be non-negative (softmaxed): the 0.01
    suppression is multiplicative; selected modes are excluded with -inf."""
    within = _within_dist(trajs[..., :2], _type_thresh(ag_type, type_thresh), use_ade)
    s = scores
    idxs = []
    for _ in range(k_pred):
        idx = torch.argmax(s, -1)  # [n_sc, n_ag]
        sel_within = torch.gather(within, 2, idx[:, :, None, None].expand(-1, -1, 1, within.shape[-1]))[:, :, 0]
        s = s * torch.where(sel_within, 0.01, 1.0)
        s = s.scatter(-1, idx[..., None], float("-inf"))
        idxs.append(idx)
    return _take_modes(trajs, scores, torch.stack(idxs, -1))


def mpa_nms(trajs: torch.Tensor, scores: torch.Tensor, type_thresh, use_ade: bool,
            ag_type: torch.Tensor) -> torch.Tensor:
    """Score suppression: a mode within thresh of a higher-scoring mode gets score 1e-3, in descending
    score order so that suppressed modes no longer suppress others."""
    within = _within_dist(trajs[..., :2], _type_thresh(ag_type, type_thresh), use_ade)
    order = torch.argsort(-scores, dim=-1, stable=True)  # [n_sc, n_ag, K]
    s = scores
    for r in range(scores.shape[-1]):
        idx = order[:, :, r:r + 1]  # [n_sc, n_ag, 1]
        row_within = torch.gather(within, 2, idx[..., None].expand(-1, -1, 1, within.shape[-1]))[:, :, 0]
        s_idx = torch.gather(s, 2, idx)
        suppressed = (row_within & (s > s_idx)).any(-1, keepdim=True)
        s = s.scatter(-1, idx, torch.where(suppressed, 1e-3, s_idx))
    return s / s.sum(-1, keepdim=True)


def traj_aggr_np(trajs: np.ndarray, scores: np.ndarray, k_pred: int, thresh, n_iter_em: int,
                 use_ade: bool) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side k-means EM aggregation with empty-cluster splitting. thresh[0] (a scalar) for every
    agent type, as the reference's `traj_aggr` takes one threshold."""
    n_sc, n_ag, n_k = scores.shape
    xy = trajs[..., :2]
    if use_ade:
        within = np.linalg.norm(xy[:, :, None] - xy[:, :, :, None], axis=-1).mean(-1) < thresh[0]
    else:
        last = xy[:, :, :, -1]
        within = np.linalg.norm(last[:, :, None] - last[:, :, :, None], axis=-1) < thresh[0]
    s = scores.copy()
    idxs = []
    for _ in range(k_pred):
        idx = s.argmax(-1)
        sel = np.take_along_axis(within, idx[:, :, None, None], axis=2)[:, :, 0]
        s = s * np.where(sel, 0.1, 1.0)
        np.put_along_axis(s, idx[:, :, None], np.take_along_axis(s, idx[:, :, None], 2) - 1.0, 2)
        idxs.append(idx)
    idx = np.stack(idxs, -1)
    trajs_k = np.take_along_axis(trajs, idx[:, :, :, None, None], axis=2)
    scores_k = np.take_along_axis(scores, idx, axis=2)

    for _ in range(n_iter_em):
        xy_k = trajs_k[..., :2]
        if use_ade:
            dist = np.linalg.norm(xy_k[:, :, None] - xy[:, :, :, None], axis=-1).mean(-1)
        else:
            dist = np.linalg.norm(xy_k[:, :, :, -1][:, :, None] - xy[:, :, :, -1][:, :, :, None], axis=-1)
        assign = np.eye(k_pred, dtype=np.int64)[dist.argmin(-1)]  # [n_sc, n_ag, n_k, k_pred]
        empty = np.argwhere(assign.sum(2) == 0)
        for (i, j, p) in empty:
            counts = assign[i, j].sum(0)
            big = counts.argmax()
            members = np.where(assign[i, j, :, big] == 1)[0][: counts[big] // 2]
            assign[i, j, members, big] = 0
            assign[i, j, members, p] = 1
        n_members = np.maximum(assign.sum(2), 1)
        trajs_k = (trajs[:, :, :, None] * assign[:, :, :, :, None, None]).sum(2) / n_members[:, :, :, None, None]
        scores_k = (scores[:, :, :, None] * assign).sum(2) / n_members
    return trajs_k, scores_k / scores_k.sum(-1, keepdims=True)


def womd_post_process(cfg: WOMDPostCfg, ag_type: torch.Tensor, trajs: torch.Tensor,
                      scores: Optional[torch.Tensor] = None, track_future_samples: int = 80) -> Dict[str, torch.Tensor]:
    """ag_type [n_sc, n_ag, 3], trajs [n_sc, K, n_ag, n_step_future, 3], scores [n_sc, K, n_ag] log probs
    (None: all equal) -> {"trajs": [n_sc, n_ag, k_pred, n_step_2hz, 3] at 2 Hz, "scores": [n_sc, n_ag, k_pred]}."""
    trajs = trajs.transpose(1, 2)  # [n_sc, n_ag, K, n_step, 3]
    scores = torch.zeros(trajs.shape[:3], device=trajs.device) if scores is None else scores.transpose(1, 2)
    scores = torch.softmax(scores, -1)

    if trajs.shape[2] > cfg.k_pred:
        if len(cfg.aggr_thresh) > 0:
            tk, sk = traj_aggr_np(trajs.cpu().numpy(), scores.cpu().numpy(), cfg.k_pred, cfg.aggr_thresh,
                                  cfg.n_iter_em, cfg.use_ade)
            trajs = torch.from_numpy(tk).to(trajs.device, trajs.dtype)
            scores = torch.from_numpy(sk).to(scores.device, scores.dtype)
        elif len(cfg.mtr_nms_thresh) > 0:
            trajs, scores = mtr_nms(trajs, scores, cfg.k_pred, cfg.mtr_nms_thresh, cfg.use_ade, ag_type)
        else:
            trajs, scores = traj_topk(trajs, scores, cfg.k_pred)

    if len(cfg.mpa_nms_thresh) > 0:
        scores = mpa_nms(trajs, scores, cfg.mpa_nms_thresh, cfg.use_ade, ag_type)
    if cfg.score_temperature > 0:
        scores = torch.softmax(torch.log(scores) / cfg.score_temperature, -1)
    # 10 Hz -> 2 Hz
    return {"trajs": trajs[:, :, :, 4:track_future_samples:5], "scores": scores}
