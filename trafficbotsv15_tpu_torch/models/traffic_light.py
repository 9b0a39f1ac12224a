"""Traffic-light encoder and next-state predictor, HPTR lane mode (counterpart of
`trafficbotsv15_tpu/models/traffic_light.py`).

`precompute` builds the scenario-static tokens, KNN/RPE and the per-layer
static K/V once; `forward` encodes one rolling TL-state window. The latent
encoder's posterior TL encoder is another instance: it does not read the
static K/V of the main encoder's parameters and attends over the raw map
targets instead (`called_by_latent_encoder`, the B2 route with
`use_pallas`). The RNN mode and the stop-line mode raise.
"""

from __future__ import annotations

import torch
from torch import nn

from trafficbotsv15_tpu_torch.config import TlEncoderCfg, TlStatePredictorCfg, TransformerCfg
from trafficbotsv15_tpu_torch.models.mlp import MLP, InputEncoder, PolylineEncoder
from trafficbotsv15_tpu_torch.models.tokens import MapTokens, TlTokens
from trafficbotsv15_tpu_torch.models.transformer import TransformerBlock
from trafficbotsv15_tpu_torch.ops.pose_emb import PoseEmbConfig, apply_pose_emb, pose_emb_out_dim
from trafficbotsv15_tpu_torch.ops.rpe import gather_tgt, get_rel_pose, get_tgt_knn


class TrafficLightEncoder(nn.Module):
    def __init__(self, cfg: TlEncoderCfg, tf_cfg: TransformerCfg, hidden_dim: int, tl_state_dim: int,
                 tl_mode: str, temp_window_size: int, n_tgt_knn: int, dist_limit: float,
                 pose_rpe: PoseEmbConfig, temp_encoder_n_layer: int = 3,
                 temp_encoder_pooling: str = "max_valid", temp_encoder_dropout_p: float = 0.1,
                 dtype=torch.float32):
        super().__init__()
        if tl_mode != "lane":
            raise NotImplementedError(f"tl_mode {tl_mode!r}: only the lane mode is on the joint-future path")
        if temp_window_size <= 0:
            raise NotImplementedError("the RNN (temp_window_size <= 0) TL encoder comes with the RNN slice")
        if cfg.temp_stack_input:
            raise NotImplementedError("temp_stack_input is not on the joint-future path")
        self.cfg, self.pose_rpe, self.dtype = cfg, pose_rpe, dtype
        self.detach_lane_feature = cfg.tl_lane_detach_mp_feature
        self.temp_window_size = temp_window_size
        self.n_knn_tl2tl = int(n_tgt_knn * cfg.k_tgt_knn_tl2tl)
        self.n_knn_tl2mp = int(n_tgt_knn * cfg.k_tgt_knn_tl2mp)
        self.dist_limit = dist_limit * cfg.k_dist_limit
        self.temp_encoder = PolylineEncoder(hidden_dim, temp_encoder_n_layer, temp_encoder_pooling,
                                            mlp_dropout_p=temp_encoder_dropout_p, dtype=dtype)
        self.tf_tl2tlmp = TransformerBlock(tf_cfg, cfg.n_layer_tf, "dec_cross_attn",
                                           d_rpe=pose_emb_out_dim(pose_rpe), dtype=dtype)
        # lane mode: the pose embedding is the lane's map feature (hidden wide)
        self.input_encoder = InputEncoder(tl_state_dim + temp_window_size, hidden_dim, hidden_dim,
                                          cfg.input_encoder.n_layer, cfg.input_encoder.mode,
                                          cfg.input_encoder.mlp_use_layernorm, cfg.input_encoder.mlp_dropout_p,
                                          dtype=dtype)

    def precompute(self, tl_valid, tl_attr, tl_pose, mp_tokens: MapTokens) -> TlTokens:
        """Static tokens + KNN/RPE + static K/V. tl_attr: lane index [n_sc, n_tl]."""
        tl_invalid = ~tl_valid
        mp_feat = mp_tokens.feature
        idx = torch.clamp(tl_attr, 0, mp_feat.shape[1] - 1).long()
        lane_feat = mp_feat.detach() if self.detach_lane_feature else mp_feat
        attr = torch.gather(lane_feat, 1, idx[..., None].expand(-1, -1, mp_feat.shape[-1]))

        rel_pose_tl2tl, rel_dist_tl2tl = get_rel_pose(tl_pose, tl_invalid)
        rel_pose_tl2mp, rel_dist_tl2mp = get_rel_pose(tl_pose, tl_invalid, mp_tokens.pose, mp_tokens.invalid)
        idx_tl2tl, inv_tl2tl, rpe_tl2tl = get_tgt_knn(rel_pose_tl2tl, rel_dist_tl2tl, self.n_knn_tl2tl, self.dist_limit)
        idx_tl2mp, inv_tl2mp, rpe_tl2mp = get_tgt_knn(rel_pose_tl2mp, rel_dist_tl2mp, self.n_knn_tl2mp, self.dist_limit)
        tok = TlTokens(
            valid=tl_valid, invalid=tl_invalid, pose=tl_pose, attr=attr,
            knn_idx_tl2tl=idx_tl2tl, knn_invalid_tl2tl=inv_tl2tl,
            rpe_tl2tl=apply_pose_emb(self.pose_rpe, rpe_tl2tl[..., :2], rpe_tl2tl[..., 2:3]),
            knn_tgt_tl2mp=gather_tgt(mp_feat, idx_tl2mp), knn_invalid_tl2mp=inv_tl2mp,
            rpe_tl2mp=apply_pose_emb(self.pose_rpe, rpe_tl2mp[..., :2], rpe_tl2mp[..., 2:3]),
        )
        # the cross-attention K/V of the static map targets and the decoder
        # self-attention rpe K/V are the same at every rollout step
        tok.static_kv = tuple(self.tf_tl2tlmp.compute_static_kv(
            tgt=tok.knn_tgt_tl2mp, rpe=tok.rpe_tl2mp, decoder_rpe=tok.rpe_tl2tl))
        return tok

    def forward(self, tl_state, tl_tokens: TlTokens, step_invalid=None, called_by_latent_encoder: bool = False):
        """tl_state [n_sc, n_tl, n_step <= W, 5], step_invalid [n_step] -> [n_sc, n_tl, hidden]."""
        n_sc, n_tl, n_step, _ = tl_state.shape
        invalid = tl_tokens.invalid
        w = self.temp_window_size
        ohe = torch.eye(w, dtype=self.dtype, device=tl_state.device)[w - n_step:]
        state_in = torch.cat([tl_state.to(self.dtype), ohe[None, None].expand(n_sc, n_tl, n_step, w)], -1)
        attr = tl_tokens.attr[:, :, None].expand(n_sc, n_tl, n_step, tl_tokens.attr.shape[-1])
        feat = self.input_encoder(state_in, attr)
        temp_invalid = invalid[:, :, None].expand(n_sc, n_tl, n_step)
        if step_invalid is not None:
            temp_invalid = temp_invalid | step_invalid[None, None, :]
        feat = self.temp_encoder(feat, temp_invalid)
        # the static K/V belong to the main encoder's parameters: the latent encoders' own
        # instances attend over the raw targets
        skv = None if called_by_latent_encoder else tl_tokens.static_kv
        return self.tf_tl2tlmp(
            feat, src_padding_mask=invalid, tgt=None if skv else tl_tokens.knn_tgt_tl2mp,
            tgt_padding_mask=tl_tokens.knn_invalid_tl2mp, rpe=None if skv else tl_tokens.rpe_tl2mp,
            decoder_tgt_idx=tl_tokens.knn_idx_tl2tl, decoder_tgt_padding_mask=tl_tokens.knn_invalid_tl2tl,
            decoder_rpe=None if skv else tl_tokens.rpe_tl2tl, static_kv=skv,
        )


class TrafficLightStatePredictor(nn.Module):
    """Next-step TL-state logits, clamped to ±3, float32."""

    def __init__(self, cfg: TlStatePredictorCfg, hidden_dim: int, tl_state_dim: int, temp_window_size: int,
                 dtype=torch.float32):
        super().__init__()
        if temp_window_size <= 0:
            raise NotImplementedError("the GRU TL-state predictor comes with the RNN slice")
        self.mlp = MLP(hidden_dim, [hidden_dim] * (cfg.n_layer - 1) + [tl_state_dim],
                       end_layer_activation=False, dtype=dtype)
        self.detach_tl_feature = cfg.detach_tl_feature

    def forward(self, tl_token_feature, tl_token_invalid):
        if self.detach_tl_feature:
            tl_token_feature = tl_token_feature.detach()
        logits = self.mlp(tl_token_feature, tl_token_invalid)
        return torch.clamp(logits, -3.0, 3.0).float()
