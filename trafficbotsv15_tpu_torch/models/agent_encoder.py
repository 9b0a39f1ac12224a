"""Agent encoder (counterpart of `trafficbotsv15_tpu/models/agent_encoder.py`): the HPTR temporal-token
path and the TrafficBots RNN paths.

HPTR (temp_window_size > 0), per rollout step: KNN of each agent token to the
map (the CUDA KNN kernel at the flagship's 1024 polylines), to the traffic
lights and to the other agents; temporal tokens over the history window; then
one dec-cross-attn block over [map ⊕ TL] with agent->agent decoder
self-attention.

RNN (temp_window_size <= 0), with no absolute pose embedding in the pairwise-relative model:
  - `rnn_rollout`, per rollout step: the last step's token, enc-cross-attn to
    the map (`tf_ag2mp`, B2 with `use_pallas`), to the traffic lights
    (`tf_ag2tl`, B2), enc-self-attn to the agents (`tf_ag2ag`, dense or B4 by
    `dense_knn_max`), then the GRU (`temp_encoder`) with its hidden carried;
  - `rnn_latent`, the CVAE posterior/prior over a whole track: ag2mp over the
    flattened [n_ag * n_step] sources, ag2tl and ag2ag per step over
    [n_sc * n_step] scenes, the GRU over the steps, then temporal pooling.

The scene-centric model (`pairwise_relative=False`) embeds the agents' global
poses (every temporal token's in HPTR, the token's own in the RNN paths),
selects each relation's KNN by distance alone (`get_rel_dist` +
`get_tgt_knn`, the sort, never the KNN kernel) and attends without RPE.

`token_rep > 1` (K-futures token dedup, HPTR): the map and TL tokens hold the
unique scenarios, shared by token_rep consecutive agent rows; the ag2mp and
ag2tl selections and gathers read them (`ops/rpe.py`'s `tgt_rep`).
"""

from __future__ import annotations

import torch
from torch import nn

from trafficbotsv15_tpu_torch.config import AgEncoderCfg, TransformerCfg
from trafficbotsv15_tpu_torch.models.gru import MultiAgentGRU
from trafficbotsv15_tpu_torch.models.mlp import InputEncoder, PolylineEncoder
from trafficbotsv15_tpu_torch.models.tokens import MapTokens
from trafficbotsv15_tpu_torch.models.transformer import TransformerBlock
from trafficbotsv15_tpu_torch.ops.pooling import seq_pooling
from trafficbotsv15_tpu_torch.ops.pose_emb import PoseEmbConfig, apply_pose_emb, pose_emb_out_dim
from trafficbotsv15_tpu_torch.ops.rpe import broadcast_rep, gather_tgt, get_rel_dist, get_tgt_knn, get_tgt_knn_lazy
from trafficbotsv15_tpu_torch.ops.transform import pos2local, rad2local, rad2rot


class AgentEncoder(nn.Module):
    def __init__(self, cfg: AgEncoderCfg, tf_cfg: TransformerCfg, hidden_dim: int, temp_window_size: int,
                 n_tgt_knn: int, dist_limit: float, pose_rpe: PoseEmbConfig, attr_dim: int,
                 temp_encoder_n_layer: int = 3, temp_encoder_pooling: str = "max_valid",
                 temp_encoder_dropout_p: float = 0.1, knn_kernel_on: bool = True, pairwise_relative: bool = True,
                 dtype=torch.float32):
        super().__init__()
        self.pose_rpe, self.dtype = pose_rpe, dtype
        self.pairwise_relative = pairwise_relative
        self.temp_window_size = temp_window_size
        self.rnn = temp_window_size <= 0
        self.rnn_latent_temp_pool_mode = cfg.rnn_latent_temp_pool_mode
        self.knn_kernel_on = knn_kernel_on
        self.n_knn_ag2mp = int(n_tgt_knn * cfg.k_tgt_knn_ag2mp)
        self.n_knn_ag2tl = int(n_tgt_knn * cfg.k_tgt_knn_ag2tl)
        self.n_knn_ag2ag = int(n_tgt_knn * cfg.k_tgt_knn_ag2ag)
        self.limit = dist_limit * cfg.k_dist_limit
        d_rpe = pose_emb_out_dim(pose_rpe) if pairwise_relative else -1
        self.pe_cfg = None  # the absolute pose embedding (none in the pairwise-relative RNN)
        if not (self.rnn and pairwise_relative):
            pe_dim = hidden_dim if cfg.input_encoder.mode == "add" else hidden_dim // 2
            self.pe_cfg = PoseEmbConfig(mode=cfg.pose_emb.mode, pe_dim=pe_dim,
                                        theta_xy=cfg.pose_emb.theta_xy, theta_cs=cfg.pose_emb.theta_cs)
        pe_width = 0 if self.pe_cfg is None else pose_emb_out_dim(self.pe_cfg)
        if self.rnn:
            # per token ag_attr ++ motion (3)
            self.input_encoder = InputEncoder(attr_dim + 3, hidden_dim, pe_width, cfg.input_encoder.n_layer,
                                              cfg.input_encoder.mode, cfg.input_encoder.mlp_use_layernorm,
                                              cfg.input_encoder.mlp_dropout_p, dtype=dtype)
            self.tf_ag2mp = TransformerBlock(tf_cfg, cfg.n_layer_tf, "enc_cross_attn", d_rpe=d_rpe, dtype=dtype)
            self.tf_ag2tl = TransformerBlock(tf_cfg, cfg.n_layer_tf, "enc_cross_attn", d_rpe=d_rpe, dtype=dtype)
            self.tf_ag2ag = TransformerBlock(tf_cfg, cfg.n_layer_tf, "enc_self_attn", d_rpe=d_rpe, dtype=dtype)
            self.temp_encoder = MultiAgentGRU(hidden_dim, hidden_dim, temp_encoder_n_layer, temp_encoder_dropout_p,
                                              dtype=dtype)
            return
        # per temporal token: ag_attr ++ motion (3) ++ one-hot window slot
        self.input_encoder = InputEncoder(attr_dim + 3 + temp_window_size, hidden_dim,
                                          pe_width, cfg.input_encoder.n_layer,
                                          cfg.input_encoder.mode, cfg.input_encoder.mlp_use_layernorm,
                                          cfg.input_encoder.mlp_dropout_p, dtype=dtype)
        self.temp_encoder = PolylineEncoder(hidden_dim, temp_encoder_n_layer, temp_encoder_pooling,
                                            mlp_dropout_p=temp_encoder_dropout_p, dtype=dtype)
        self.tf_ag2agmptl = TransformerBlock(tf_cfg, cfg.n_layer_tf, "dec_cross_attn", d_rpe=d_rpe, dtype=dtype)

    def _knn(self, src_invalid, src_pose, tgt_invalid, tgt_pose, n_knn, tgt_feature=None, tgt_rep: int = 1):
        """KNN of one relation: dict(idx, invalid, rpe (None scene-centric)[, tgt])."""
        if self.pairwise_relative:
            idx, invalid, rpe = get_tgt_knn_lazy(src_pose, src_invalid, tgt_pose, tgt_invalid, n_knn, self.limit,
                                                 self.knn_kernel_on, tgt_rep)
            rpe = apply_pose_emb(self.pose_rpe, rpe[..., :2], rpe[..., 2:3])
        else:
            rel_dist = get_rel_dist(src_pose[..., :2], src_invalid, broadcast_rep(tgt_pose[..., :2], tgt_rep),
                                    broadcast_rep(tgt_invalid, tgt_rep))
            idx, invalid, rpe = get_tgt_knn(None, rel_dist, n_knn, self.limit)
        out = {"idx": idx, "invalid": invalid, "rpe": rpe}
        if tgt_feature is not None:
            out["tgt"] = gather_tgt(tgt_feature, idx, tgt_rep)
        return out

    def _pose_emb(self, pose):
        """The absolute pose embedding of global poses [.., 3] (scene-centric), None without one."""
        if self.pairwise_relative:
            return None
        return apply_pose_emb(self.pe_cfg, pose[..., :2], pose[..., 2:3])

    def hptr_temporal_tokens(self, ag_valid, ag_attr, ag_motion, ag_pose, ag_token_pose):
        """Temporal input tokens + PointNet aggregation. ag_valid [n_sc, n_ag, n_step] -> [n_sc, n_ag, hidden]."""
        n_sc, n_ag, n_step = ag_valid.shape
        w = self.temp_window_size
        ag_xy, ag_yaw = ag_pose[..., :2], ag_pose[..., 2]
        if self.pairwise_relative:  # in each agent's token frame
            ag_xy = pos2local(ag_xy, ag_token_pose[:, :, None, :2], rad2rot(ag_token_pose[..., 2]))
            ag_yaw = rad2local(ag_yaw, ag_token_pose[..., 2], cast=False)
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
                tl_token_invalid, tl_token_feature, tl_token_pose, rnn_hidden=None,
                called_by_latent_encoder: bool = False, token_rep: int = 1):
        """ag_valid [n_sc, n_ag, n_step], ag_motion/ag_pose [n_sc, n_ag, n_step, 3],
        tl_token_feature [n_sc, n_tl, hidden] ([n_sc, n_tl, n_step, hidden] for the RNN latent encoder)
        -> (agent feature [n_sc, n_ag, hidden], the GRU's new hidden in the RNN rollout, else None).
        token_rep > 1 (HPTR): the map and TL tokens are the unique scenarios' (see the module docstring)."""
        if self.rnn and called_by_latent_encoder:
            return self._forward_rnn_latent(ag_valid, ag_attr, ag_motion, ag_pose, mp_tokens, tl_token_invalid,
                                            tl_token_feature, tl_token_pose), None
        if self.rnn:
            return self._forward_rnn_rollout(ag_valid, ag_attr, ag_motion, ag_pose, mp_tokens, tl_token_invalid,
                                             tl_token_feature, tl_token_pose, rnn_hidden)
        return self._forward_hptr(ag_valid, ag_attr, ag_motion, ag_pose, mp_tokens, tl_token_invalid,
                                  tl_token_feature, tl_token_pose, token_rep), None

    def _forward_hptr(self, ag_valid, ag_attr, ag_motion, ag_pose, mp_tokens: MapTokens,
                      tl_token_invalid, tl_token_feature, tl_token_pose, token_rep: int = 1):
        ag_token_invalid = ~ag_valid.any(-1)
        ag_token_pose = seq_pooling(ag_pose, ~ag_valid, "last_valid")

        knn_ag2mp = self._knn(ag_token_invalid, ag_token_pose, mp_tokens.invalid, mp_tokens.pose,
                              self.n_knn_ag2mp, mp_tokens.feature, token_rep)
        knn_ag2tl = self._knn(ag_token_invalid, ag_token_pose, tl_token_invalid, tl_token_pose,
                              self.n_knn_ag2tl, tl_token_feature, token_rep)
        knn_ag2ag = self._knn(ag_token_invalid, ag_token_pose, ag_token_invalid, ag_token_pose, self.n_knn_ag2ag)

        ag_token_feature = self.hptr_temporal_tokens(ag_valid, ag_attr, ag_motion, ag_pose, ag_token_pose)
        return self.tf_ag2agmptl(
            ag_token_feature,
            src_padding_mask=ag_token_invalid,
            tgt=torch.cat([knn_ag2mp["tgt"], knn_ag2tl["tgt"]], 2),
            tgt_padding_mask=torch.cat([knn_ag2mp["invalid"], knn_ag2tl["invalid"]], 2),
            rpe=None if knn_ag2mp["rpe"] is None else torch.cat([knn_ag2mp["rpe"], knn_ag2tl["rpe"]], 2),
            decoder_tgt_idx=knn_ag2ag["idx"],
            decoder_tgt_padding_mask=knn_ag2ag["invalid"],
            decoder_rpe=knn_ag2ag["rpe"],
        )

    # ------------------------------------------------------------------ TrafficBots RNN
    def _forward_rnn_rollout(self, ag_valid, ag_attr, ag_motion, ag_pose, mp_tokens: MapTokens,
                             tl_token_invalid, tl_token_feature, tl_token_pose, rnn_hidden):
        """The last step's token through ag2mp, ag2tl and ag2ag, then one GRU step from rnn_hidden."""
        ag_token_pose = ag_pose[:, :, -1]
        ag_token_invalid = ~ag_valid[:, :, -1]
        knn_ag2mp = self._knn(ag_token_invalid, ag_token_pose, mp_tokens.invalid, mp_tokens.pose,
                              self.n_knn_ag2mp, mp_tokens.feature)
        knn_ag2tl = self._knn(ag_token_invalid, ag_token_pose, tl_token_invalid, tl_token_pose,
                              self.n_knn_ag2tl, tl_token_feature)
        knn_ag2ag = self._knn(ag_token_invalid, ag_token_pose, ag_token_invalid, ag_token_pose, self.n_knn_ag2ag)
        attr = torch.cat([ag_attr.to(self.dtype), ag_motion[:, :, -1].to(self.dtype)], -1)
        feat = self.input_encoder(attr, self._pose_emb(ag_token_pose))
        feat = self._cross(self.tf_ag2mp, feat, ag_token_invalid, knn_ag2mp)
        feat = self._cross(self.tf_ag2tl, feat, ag_token_invalid, knn_ag2tl)
        feat = self.tf_ag2ag(feat, src_padding_mask=ag_token_invalid, tgt_idx=knn_ag2ag["idx"],
                             tgt_padding_mask=knn_ag2ag["invalid"], rpe=knn_ag2ag["rpe"])
        return self.temp_encoder(feat, ag_token_invalid, rnn_hidden)

    @staticmethod
    def _cross(block, feat, src_invalid, knn):
        return block(feat, src_padding_mask=src_invalid, tgt=knn["tgt"], tgt_padding_mask=knn["invalid"],
                     rpe=knn["rpe"])

    def _forward_rnn_latent(self, ag_valid, ag_attr, ag_motion, ag_pose, mp_tokens: MapTokens,
                            tl_token_invalid, tl_token_feature, tl_token_pose):
        """The whole track [n_sc, n_ag, n_step] for the CVAE: ag2mp over [n_sc, n_ag * n_step] sources,
        ag2tl and ag2ag over [n_sc * n_step, n_ag], the GRU over the steps, pooled -> [n_sc, n_ag, hidden]."""
        n_sc, n_ag, n_step = ag_valid.shape
        ag_invalid = ~ag_valid
        attr = torch.cat([ag_attr[:, :, None, :].expand(n_sc, n_ag, n_step, ag_attr.shape[-1]).to(self.dtype),
                          ag_motion.to(self.dtype)], -1)
        feat = self.input_encoder(attr, self._pose_emb(ag_pose))
        h = feat.shape[-1]

        flat_invalid = ag_invalid.reshape(n_sc, n_ag * n_step)
        knn_ag2mp = self._knn(flat_invalid, ag_pose.reshape(n_sc, n_ag * n_step, 3), mp_tokens.invalid,
                              mp_tokens.pose, self.n_knn_ag2mp, mp_tokens.feature)
        feat = self._cross(self.tf_ag2mp, feat.reshape(n_sc, n_ag * n_step, h), flat_invalid, knn_ag2mp)

        n_tl = tl_token_invalid.shape[1]
        step_pose = ag_pose.movedim(2, 1).reshape(n_sc * n_step, n_ag, 3)
        step_invalid = ag_invalid.movedim(2, 1).reshape(n_sc * n_step, n_ag)
        tl_feat = tl_token_feature.movedim(2, 1).reshape(n_sc * n_step, n_tl, h)
        tl_pose = tl_token_pose[:, None].expand(n_sc, n_step, n_tl, 3).reshape(n_sc * n_step, n_tl, 3)
        tl_invalid = tl_token_invalid[:, None].expand(n_sc, n_step, n_tl).reshape(n_sc * n_step, n_tl)
        knn_ag2tl = self._knn(step_invalid, step_pose, tl_invalid, tl_pose, self.n_knn_ag2tl, tl_feat)
        feat = feat.reshape(n_sc, n_ag, n_step, h).movedim(2, 1).reshape(n_sc * n_step, n_ag, h)
        feat = self._cross(self.tf_ag2tl, feat, step_invalid, knn_ag2tl)
        knn_ag2ag = self._knn(step_invalid, step_pose, step_invalid, step_pose, self.n_knn_ag2ag)
        feat = self.tf_ag2ag(feat, src_padding_mask=step_invalid, tgt_idx=knn_ag2ag["idx"],
                             tgt_padding_mask=knn_ag2ag["invalid"], rpe=knn_ag2ag["rpe"])
        feat = feat.reshape(n_sc, n_step, n_ag, h).movedim(1, 2)
        feat, _ = self.temp_encoder(feat, ag_invalid)
        return seq_pooling(feat, ag_invalid, self.rnn_latent_temp_pool_mode)
