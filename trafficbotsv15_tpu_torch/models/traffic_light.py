"""Traffic-light encoder and next-state predictor (counterpart of
`trafficbotsv15_tpu/models/traffic_light.py`).

A TL token is a lane (`tl_mode="lane"`: the state fused with the lane's map
feature) or a stop line (`"stop"`: the state alone in the pairwise-relative
model, where the pose only places the token; with the stop line's global
pose embedding in the scene-centric model, `pairwise_relative=False`).
The scene-centric model selects the TL->TL and TL->map KNN by distance alone
(`get_rel_dist` + `get_tgt_knn`) and attends without RPE.

HPTR (temp_window_size > 0): `precompute` builds the scenario-static tokens,
KNN/RPE and the per-layer static K/V once; `forward` encodes one rolling
TL-state window, through a temporal PolylineEncoder over the window's states
(each with its one-hot slot), or with `temp_stack_input` as one input of
`tl_state_dim * temp_window_size` stacked states (left-padded with zeros).
The latent encoder's posterior TL encoder is another instance: it does not
read the static K/V of the main encoder's parameters and attends over the
raw map targets instead (`called_by_latent_encoder`, the B2 route with
`use_pallas`). With `apply_q_rpe` no K/V is hoisted: its query RPE is
projected with the targets' at every step, as the JAX package's attention
computes it.

TrafficBots RNN (temp_window_size <= 0): no temporal encoder and no
attention; `forward` fuses the window's last state (every step for the
latent encoder) with the lane's map feature, and the state predictor runs a
GRU over the TL tokens with its hidden carried by the rollout.
"""

from __future__ import annotations

import torch
from torch import nn

from trafficbotsv15_tpu_torch.config import TlEncoderCfg, TlStatePredictorCfg, TransformerCfg
from trafficbotsv15_tpu_torch.models.gru import MultiAgentGRU
from trafficbotsv15_tpu_torch.models.mlp import MLP, InputEncoder, PolylineEncoder
from trafficbotsv15_tpu_torch.models.tokens import MapTokens, TlTokens
from trafficbotsv15_tpu_torch.models.transformer import TransformerBlock
from trafficbotsv15_tpu_torch.ops.pose_emb import PoseEmbConfig, apply_pose_emb, pose_emb_out_dim
from trafficbotsv15_tpu_torch.ops.rpe import gather_tgt, get_rel_dist, get_rel_pose, get_tgt_knn


class TrafficLightEncoder(nn.Module):
    def __init__(self, cfg: TlEncoderCfg, tf_cfg: TransformerCfg, hidden_dim: int, tl_state_dim: int,
                 tl_mode: str, temp_window_size: int, n_tgt_knn: int, dist_limit: float,
                 pose_rpe: PoseEmbConfig, temp_encoder_n_layer: int = 3,
                 temp_encoder_pooling: str = "max_valid", temp_encoder_dropout_p: float = 0.1,
                 pairwise_relative: bool = True, dtype=torch.float32):
        super().__init__()
        if tl_mode not in ("lane", "stop"):
            raise ValueError(f"tl_mode {tl_mode!r}")
        self.cfg, self.pose_rpe, self.dtype = cfg, pose_rpe, dtype
        self.pairwise_relative = pairwise_relative
        self.tl_mode = tl_mode
        self.detach_lane_feature = cfg.tl_lane_detach_mp_feature
        self.temp_window_size = temp_window_size
        self.rnn = temp_window_size <= 0
        self.stacked = cfg.temp_stack_input and not self.rnn
        self.hoist_static_kv = not (tf_cfg.apply_q_rpe and pairwise_relative)
        ie = cfg.input_encoder
        self.pe_cfg = None  # the stop line's pose embedding (scene-centric stop mode)
        if tl_mode == "lane":
            pe_dim = hidden_dim  # the lane's map feature
        elif pairwise_relative:
            pe_dim = 0
        else:
            self.pe_cfg = PoseEmbConfig(mode=cfg.pose_emb.mode,
                                        pe_dim=hidden_dim if ie.mode == "add" else hidden_dim // 2,
                                        theta_xy=cfg.pose_emb.theta_xy, theta_cs=cfg.pose_emb.theta_cs)
            pe_dim = pose_emb_out_dim(self.pe_cfg)
        if self.rnn:
            attr_dim = tl_state_dim
        elif self.stacked:
            attr_dim = tl_state_dim * temp_window_size
        else:
            attr_dim = tl_state_dim + temp_window_size  # the one-hot window slot rides with each state
        self.input_encoder = InputEncoder(attr_dim, hidden_dim, pe_dim, ie.n_layer, ie.mode, ie.mlp_use_layernorm,
                                          ie.mlp_dropout_p, dtype=dtype)
        if self.rnn:
            return
        self.n_knn_tl2tl = int(n_tgt_knn * cfg.k_tgt_knn_tl2tl)
        self.n_knn_tl2mp = int(n_tgt_knn * cfg.k_tgt_knn_tl2mp)
        self.dist_limit = dist_limit * cfg.k_dist_limit
        if not self.stacked:
            self.temp_encoder = PolylineEncoder(hidden_dim, temp_encoder_n_layer, temp_encoder_pooling,
                                                mlp_dropout_p=temp_encoder_dropout_p, dtype=dtype)
        self.tf_tl2tlmp = TransformerBlock(tf_cfg, cfg.n_layer_tf, "dec_cross_attn",
                                           d_rpe=pose_emb_out_dim(pose_rpe) if pairwise_relative else -1, dtype=dtype)

    def precompute(self, tl_valid, tl_attr, tl_pose, mp_tokens: MapTokens) -> TlTokens:
        """Static tokens (+ KNN/RPE + static K/V in HPTR mode). tl_attr: lane index [n_sc, n_tl] (lane mode; None
        in stop mode)."""
        tl_invalid = ~tl_valid
        mp_feat = mp_tokens.feature
        attr = None
        if self.tl_mode == "lane":
            idx = torch.clamp(tl_attr, 0, mp_feat.shape[1] - 1).long()
            lane_feat = mp_feat.detach() if self.detach_lane_feature else mp_feat
            attr = torch.gather(lane_feat, 1, idx[..., None].expand(-1, -1, mp_feat.shape[-1]))
        if self.rnn:
            return TlTokens(valid=tl_valid, invalid=tl_invalid, pose=tl_pose, attr=attr)

        if self.pairwise_relative:
            rel_pose_tl2tl, rel_dist_tl2tl = get_rel_pose(tl_pose, tl_invalid)
            rel_pose_tl2mp, rel_dist_tl2mp = get_rel_pose(tl_pose, tl_invalid, mp_tokens.pose, mp_tokens.invalid)
        else:
            rel_pose_tl2tl = rel_pose_tl2mp = None
            rel_dist_tl2tl = get_rel_dist(tl_pose[..., :2], tl_invalid)
            rel_dist_tl2mp = get_rel_dist(tl_pose[..., :2], tl_invalid, mp_tokens.pose[..., :2], mp_tokens.invalid)
        idx_tl2tl, inv_tl2tl, rpe_tl2tl = get_tgt_knn(rel_pose_tl2tl, rel_dist_tl2tl, self.n_knn_tl2tl, self.dist_limit)
        idx_tl2mp, inv_tl2mp, rpe_tl2mp = get_tgt_knn(rel_pose_tl2mp, rel_dist_tl2mp, self.n_knn_tl2mp, self.dist_limit)
        def emb(rpe):
            return None if rpe is None else apply_pose_emb(self.pose_rpe, rpe[..., :2], rpe[..., 2:3])

        tok = TlTokens(
            valid=tl_valid, invalid=tl_invalid, pose=tl_pose, attr=attr,
            knn_idx_tl2tl=idx_tl2tl, knn_invalid_tl2tl=inv_tl2tl, rpe_tl2tl=emb(rpe_tl2tl),
            knn_tgt_tl2mp=gather_tgt(mp_feat, idx_tl2mp), knn_invalid_tl2mp=inv_tl2mp, rpe_tl2mp=emb(rpe_tl2mp),
        )
        if self.hoist_static_kv:
            # the cross-attention K/V of the static map targets and the decoder
            # self-attention rpe K/V are the same at every rollout step
            tok.static_kv = tuple(self.tf_tl2tlmp.compute_static_kv(
                tgt=tok.knn_tgt_tl2mp, rpe=tok.rpe_tl2mp, decoder_rpe=tok.rpe_tl2tl))
        return tok

    def _tl_feature(self, tl_state, tokens: TlTokens):
        """The input encoder over states [n_sc, n_tl, (n_step,) d]: with the lane's map feature (lane mode), the
        stop line's pose embedding (scene-centric stop mode), each broadcast over the steps, or alone."""
        pe = tokens.attr
        if self.pe_cfg is not None:
            pe = apply_pose_emb(self.pe_cfg, tokens.pose[..., :2], tokens.pose[..., 2:3])
        if pe is not None and tl_state.ndim == 4:
            pe = pe[:, :, None].expand(*tl_state.shape[:3], pe.shape[-1])
        return self.input_encoder(tl_state.to(self.dtype), pe)

    def forward(self, tl_state, tl_tokens: TlTokens, step_invalid=None, called_by_latent_encoder: bool = False):
        """tl_state [n_sc, n_tl, n_step <= W, 5], step_invalid [n_step] -> [n_sc, n_tl, hidden]
        ([n_sc, n_tl, n_step, hidden] for the RNN latent encoder, which reads every step)."""
        n_sc, n_tl, n_step, _ = tl_state.shape
        if self.rnn:
            if not called_by_latent_encoder:
                tl_state = tl_state[:, :, -1]
            return self._tl_feature(tl_state, tl_tokens)
        invalid = tl_tokens.invalid
        w = self.temp_window_size
        if self.stacked:
            # the window's states side by side, the unfilled leading slots zero
            padded = torch.nn.functional.pad(tl_state.to(self.dtype), (0, 0, w - n_step, 0))
            feat = self._tl_feature(padded.reshape(n_sc, n_tl, w * tl_state.shape[-1]), tl_tokens)
        else:
            ohe = torch.eye(w, dtype=self.dtype, device=tl_state.device)[w - n_step:]
            state_in = torch.cat([tl_state.to(self.dtype), ohe[None, None].expand(n_sc, n_tl, n_step, w)], -1)
            feat = self._tl_feature(state_in, tl_tokens)
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
    """Next-step TL-state logits, clamped to ±3, float32; in RNN mode a GRU (`rnn`) before the MLP."""

    def __init__(self, cfg: TlStatePredictorCfg, hidden_dim: int, tl_state_dim: int, temp_window_size: int,
                 dtype=torch.float32):
        super().__init__()
        self.rnn = (MultiAgentGRU(hidden_dim, hidden_dim, cfg.n_layer, cfg.rnn_dropout_p, dtype=dtype)
                    if temp_window_size <= 0 else None)
        self.mlp = MLP(hidden_dim, [hidden_dim] * (cfg.n_layer - 1) + [tl_state_dim],
                       end_layer_activation=False, dtype=dtype)
        self.detach_tl_feature = cfg.detach_tl_feature

    def forward(self, tl_token_feature, tl_token_invalid, rnn_hidden=None):
        """tl_token_feature [n_sc, n_tl, hidden] -> (logits [n_sc, n_tl, 5], the GRU's new hidden
        [n_layer, n_sc, n_tl, hidden] in RNN mode, else None). The GRU treats every token as valid."""
        if self.detach_tl_feature:
            tl_token_feature = tl_token_feature.detach()
        new_hidden = None
        if self.rnn is not None:
            tl_token_feature, new_hidden = self.rnn(tl_token_feature, torch.zeros_like(tl_token_invalid), rnn_hidden)
        logits = self.mlp(tl_token_feature, tl_token_invalid)
        return torch.clamp(logits, -3.0, 3.0).float(), new_hidden
