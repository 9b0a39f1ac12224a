"""Agent encoder, HPTR temporal-token path (counterpart of `trafficbotsv15_tpu/models/agent_encoder.py`).

Per rollout step: KNN of each agent token to the map (the CUDA KNN kernel at
the flagship's 1024 polylines), to the traffic lights and to the other
agents; temporal tokens over the history window; then one dec-cross-attn
block over [map ⊕ TL] with agent->agent decoder self-attention. The RNN
paths come with a later slice.
"""

from __future__ import annotations

import torch
from torch import nn

from trafficbotsv15_tpu_torch.config import AgEncoderCfg, TransformerCfg
from trafficbotsv15_tpu_torch.models.mlp import InputEncoder, PolylineEncoder
from trafficbotsv15_tpu_torch.models.tokens import MapTokens
from trafficbotsv15_tpu_torch.models.transformer import TransformerBlock
from trafficbotsv15_tpu_torch.ops.pooling import seq_pooling
from trafficbotsv15_tpu_torch.ops.pose_emb import PoseEmbConfig, apply_pose_emb, pose_emb_out_dim
from trafficbotsv15_tpu_torch.ops.rpe import gather_tgt, get_tgt_knn_lazy
from trafficbotsv15_tpu_torch.ops.transform import pos2local, rad2local, rad2rot


class AgentEncoder(nn.Module):
    def __init__(self, cfg: AgEncoderCfg, tf_cfg: TransformerCfg, hidden_dim: int, temp_window_size: int,
                 n_tgt_knn: int, dist_limit: float, pose_rpe: PoseEmbConfig, attr_dim: int,
                 temp_encoder_n_layer: int = 3, temp_encoder_pooling: str = "max_valid",
                 temp_encoder_dropout_p: float = 0.1, knn_kernel_on: bool = True, dtype=torch.float32):
        super().__init__()
        if temp_window_size <= 0:
            raise NotImplementedError("the RNN agent encoder comes with the RNN slice")
        self.pose_rpe, self.dtype = pose_rpe, dtype
        self.temp_window_size = temp_window_size
        self.knn_kernel_on = knn_kernel_on
        self.n_knn_ag2mp = int(n_tgt_knn * cfg.k_tgt_knn_ag2mp)
        self.n_knn_ag2tl = int(n_tgt_knn * cfg.k_tgt_knn_ag2tl)
        self.n_knn_ag2ag = int(n_tgt_knn * cfg.k_tgt_knn_ag2ag)
        self.limit = dist_limit * cfg.k_dist_limit
        pe_dim = hidden_dim if cfg.input_encoder.mode == "add" else hidden_dim // 2
        self.pe_cfg = PoseEmbConfig(mode=cfg.pose_emb.mode, pe_dim=pe_dim,
                                    theta_xy=cfg.pose_emb.theta_xy, theta_cs=cfg.pose_emb.theta_cs)
        # per temporal token: ag_attr ++ motion (3) ++ one-hot window slot
        self.input_encoder = InputEncoder(attr_dim + 3 + temp_window_size, hidden_dim,
                                          pose_emb_out_dim(self.pe_cfg), cfg.input_encoder.n_layer,
                                          cfg.input_encoder.mode, cfg.input_encoder.mlp_use_layernorm,
                                          cfg.input_encoder.mlp_dropout_p, dtype=dtype)
        self.temp_encoder = PolylineEncoder(hidden_dim, temp_encoder_n_layer, temp_encoder_pooling,
                                            mlp_dropout_p=temp_encoder_dropout_p, dtype=dtype)
        self.tf_ag2agmptl = TransformerBlock(tf_cfg, cfg.n_layer_tf, "dec_cross_attn",
                                             d_rpe=pose_emb_out_dim(pose_rpe), dtype=dtype)

    def _knn(self, src_invalid, src_pose, tgt_invalid, tgt_pose, n_knn, tgt_feature=None):
        """KNN of one relation: dict(idx, invalid, rpe[, tgt])."""
        idx, invalid, rpe = get_tgt_knn_lazy(src_pose, src_invalid, tgt_pose, tgt_invalid, n_knn, self.limit,
                                             self.knn_kernel_on)
        out = {"idx": idx, "invalid": invalid, "rpe": apply_pose_emb(self.pose_rpe, rpe[..., :2], rpe[..., 2:3])}
        if tgt_feature is not None:
            out["tgt"] = gather_tgt(tgt_feature, idx)
        return out

    def hptr_temporal_tokens(self, ag_valid, ag_attr, ag_motion, ag_pose, ag_token_pose):
        """Temporal input tokens + PointNet aggregation. ag_valid [n_sc, n_ag, n_step] -> [n_sc, n_ag, hidden]."""
        n_sc, n_ag, n_step = ag_valid.shape
        w = self.temp_window_size
        ag_xy = pos2local(ag_pose[..., :2], ag_token_pose[:, :, None, :2], rad2rot(ag_token_pose[..., 2]))
        ag_yaw = rad2local(ag_pose[..., 2], ag_token_pose[..., 2], cast=False)
        pe = apply_pose_emb(self.pe_cfg, ag_xy, ag_yaw[..., None])
        ohe = torch.eye(w, dtype=self.dtype, device=ag_valid.device)[w - n_step:]
        attr = torch.cat([
            ag_attr[:, :, None, :].expand(n_sc, n_ag, n_step, ag_attr.shape[-1]).to(self.dtype),
            ag_motion.to(self.dtype),
            ohe[None, None].expand(n_sc, n_ag, n_step, w),
        ], -1)
        feat = self.input_encoder(attr, pe)
        return self.temp_encoder(feat, ~ag_valid)

    def forward(self, ag_valid, ag_attr, ag_motion, ag_pose, mp_tokens: MapTokens,
                tl_token_invalid, tl_token_feature, tl_token_pose):
        """ag_valid [n_sc, n_ag, n_step], ag_motion/ag_pose [n_sc, n_ag, n_step, 3],
        tl_token_feature [n_sc, n_tl, hidden] -> agent feature [n_sc, n_ag, hidden]."""
        ag_token_invalid = ~ag_valid.any(-1)
        ag_token_pose = seq_pooling(ag_pose, ~ag_valid, "last_valid")

        knn_ag2mp = self._knn(ag_token_invalid, ag_token_pose, mp_tokens.invalid, mp_tokens.pose,
                              self.n_knn_ag2mp, mp_tokens.feature)
        knn_ag2tl = self._knn(ag_token_invalid, ag_token_pose, tl_token_invalid, tl_token_pose,
                              self.n_knn_ag2tl, tl_token_feature)
        knn_ag2ag = self._knn(ag_token_invalid, ag_token_pose, ag_token_invalid, ag_token_pose, self.n_knn_ag2ag)

        ag_token_feature = self.hptr_temporal_tokens(ag_valid, ag_attr, ag_motion, ag_pose, ag_token_pose)
        return self.tf_ag2agmptl(
            ag_token_feature,
            src_padding_mask=ag_token_invalid,
            tgt=torch.cat([knn_ag2mp["tgt"], knn_ag2tl["tgt"]], 2),
            tgt_padding_mask=torch.cat([knn_ag2mp["invalid"], knn_ag2tl["invalid"]], 2),
            rpe=torch.cat([knn_ag2mp["rpe"], knn_ag2tl["rpe"]], 2),
            decoder_tgt_idx=knn_ag2ag["idx"],
            decoder_tgt_padding_mask=knn_ag2ag["invalid"],
            decoder_rpe=knn_ag2ag["rpe"],
        )
