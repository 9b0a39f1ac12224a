"""Map polyline encoder: PointNet + KNN self-attention (counterpart of `trafficbotsv15_tpu/models/map_encoder.py`).

Static per scenario: runs once before the rollout.
"""

from __future__ import annotations

import torch
from torch import nn

from trafficbotsv15_tpu_torch.config import MapEncoderCfg, TransformerCfg
from trafficbotsv15_tpu_torch.models.mlp import InputEncoder, PolylineEncoder
from trafficbotsv15_tpu_torch.models.tokens import MapTokens
from trafficbotsv15_tpu_torch.models.transformer import TransformerBlock
from trafficbotsv15_tpu_torch.ops.pose_emb import PoseEmbConfig, apply_pose_emb, pose_emb_out_dim
from trafficbotsv15_tpu_torch.ops.rpe import get_rel_pose, get_tgt_knn, get_tgt_knn_lazy
from trafficbotsv15_tpu_torch.ops.transform import pos2local, rad2local, rad2rot


class MapEncoder(nn.Module):
    def __init__(self, cfg: MapEncoderCfg, tf_cfg: TransformerCfg, hidden_dim: int, n_tgt_knn: int,
                 dist_limit: float, pose_rpe: PoseEmbConfig, attr_dim: int, mp2mp_lazy: bool = False,
                 knn_kernel_on: bool = True, dtype=torch.float32):
        super().__init__()
        self.n_tgt_knn, self.dist_limit, self.pose_rpe = n_tgt_knn, dist_limit, pose_rpe
        self.mp2mp_lazy, self.knn_kernel_on = mp2mp_lazy, knn_kernel_on
        self.dtype = dtype
        self.pe_cfg = PoseEmbConfig(
            mode=cfg.pose_emb.mode,
            pe_dim=hidden_dim if cfg.input_encoder.mode == "add" else hidden_dim // 2,
            theta_xy=cfg.pose_emb.theta_xy, theta_cs=cfg.pose_emb.theta_cs,
        )
        self.input_encoder = InputEncoder(attr_dim, hidden_dim, pose_emb_out_dim(self.pe_cfg),
                                          cfg.input_encoder.n_layer, cfg.input_encoder.mode,
                                          cfg.input_encoder.mlp_use_layernorm, cfg.input_encoder.mlp_dropout_p,
                                          dtype=dtype)
        self.pl_encoder = PolylineEncoder(hidden_dim, cfg.pl_encoder.n_layer, cfg.pl_encoder.pooling_mode,
                                          cfg.pl_encoder.mlp_use_layernorm, cfg.pl_encoder.mlp_dropout_p, dtype=dtype)
        self.tf_mp2mp = TransformerBlock(tf_cfg, cfg.n_layer_tf, "enc_self_attn",
                                         d_rpe=pose_emb_out_dim(pose_rpe), dtype=dtype)

    def forward(self, mp_valid, mp_attr, mp_pose, mp_type) -> MapTokens:
        """mp_valid [n_sc, n_mp, n_node], mp_attr [n_sc, n_mp, n_mp_type] float,
        mp_pose [n_sc, n_mp, n_node, 3], mp_type [n_sc, n_mp, n_mp_type] bool."""
        n_sc, n_mp, n_node = mp_valid.shape
        mp_token_pose = mp_pose[:, :, 0]
        mp_token_invalid = ~mp_valid[:, :, 0]
        mp_invalid = ~mp_valid

        # per-node pose embedding in the polyline's own frame
        mp_xy = pos2local(mp_pose[..., :2], mp_token_pose[:, :, None, :2], rad2rot(mp_token_pose[..., 2]))
        mp_yaw = rad2local(mp_pose[..., 2], mp_token_pose[..., 2], cast=False)
        mp_pose_emb = apply_pose_emb(self.pe_cfg, mp_xy, mp_yaw[..., None])

        node_ohe = torch.eye(n_node, dtype=mp_attr.dtype, device=mp_attr.device)
        attr = torch.cat([mp_attr[:, :, None, :].expand(n_sc, n_mp, n_node, mp_attr.shape[-1]),
                          node_ohe[None, None].expand(n_sc, n_mp, n_node, n_node)], -1)
        feat = self.input_encoder(attr, mp_pose_emb)
        token_feat = self.pl_encoder(feat, mp_invalid)

        if self.mp2mp_lazy:
            knn_idx, knn_invalid, rpe = get_tgt_knn_lazy(
                mp_token_pose, mp_token_invalid, mp_token_pose, mp_token_invalid,
                self.n_tgt_knn, self.dist_limit, self.knn_kernel_on)
        else:
            rel_pose, rel_dist = get_rel_pose(mp_token_pose, mp_token_invalid)
            knn_idx, knn_invalid, rpe = get_tgt_knn(rel_pose, rel_dist, self.n_tgt_knn, self.dist_limit)
        rpe = apply_pose_emb(self.pose_rpe, rpe[..., :2], rpe[..., 2:3])

        token_feat = self.tf_mp2mp(token_feat, src_padding_mask=mp_token_invalid, tgt_idx=knn_idx,
                                   tgt_padding_mask=knn_invalid, rpe=rpe)
        return MapTokens(invalid=mp_token_invalid, feature=token_feat, pose=mp_token_pose, type=mp_type)
