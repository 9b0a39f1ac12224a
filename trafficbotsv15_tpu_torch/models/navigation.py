"""Navigation encoder and predictor, `dest` mode (counterpart of `trafficbotsv15_tpu/models/navigation.py`).

The flagship navigates to a destination polyline: the predictor scores every
map polyline per agent with agent/map-type compatibility masking, and the
encoder embeds the chosen polyline relative to the agent each step. The
goal, cmd and RNN variants come with later slices.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from trafficbotsv15_tpu_torch.config import AgEncoderCfg, NaviEncoderCfg, NaviPredictorCfg
from trafficbotsv15_tpu_torch.models.mlp import MLP, InputEncoder, PolylineEncoder
from trafficbotsv15_tpu_torch.models.tokens import MapTokens
from trafficbotsv15_tpu_torch.ops.distributions import DestCategorical
from trafficbotsv15_tpu_torch.ops.pooling import seq_pooling
from trafficbotsv15_tpu_torch.ops.pose_emb import PoseEmbConfig, apply_pose_emb, pose_emb_out_dim
from trafficbotsv15_tpu_torch.ops.rpe import get_rel_pose
from trafficbotsv15_tpu_torch.ops.transform import pos2local, rad2local, rad2rot

_NEG = -1e9


def _check_dest(navi_mode: str) -> None:
    if navi_mode != "dest":
        raise NotImplementedError(f"navi_mode {navi_mode!r}: only 'dest' is on the joint-future path")


class NaviEncoder(nn.Module):
    """Per-agent feature of the destination polyline, relative to the agent's pose."""

    def __init__(self, cfg: NaviEncoderCfg, hidden_dim: int, navi_mode: str, pose_rpe: PoseEmbConfig,
                 dtype=torch.float32):
        super().__init__()
        _check_dest(navi_mode)
        self.pose_rpe = pose_rpe
        self.detach_mp_feature = cfg.dest_detach_mp_feature
        self.mlp_mp = MLP(hidden_dim, [hidden_dim], end_layer_activation=False, dtype=dtype)
        self.mlp_pe = MLP(pose_emb_out_dim(pose_rpe), [hidden_dim], end_layer_activation=False, dtype=dtype)

    def forward(self, ag_navi, ag_pose, mp_tokens: MapTokens):
        """ag_navi [n_sc, n_ag] polyline index, ag_pose [n_sc, n_ag, 3] -> [n_sc, n_ag, hidden]."""
        mp_feat = mp_tokens.feature.detach() if self.detach_mp_feature else mp_tokens.feature
        idx = torch.clamp(ag_navi, 0, mp_feat.shape[1] - 1).long()
        feat = self.mlp_mp(torch.gather(mp_feat, 1, idx[..., None].expand(-1, -1, mp_feat.shape[-1])))
        dest_pose = torch.gather(mp_tokens.pose, 1, idx[..., None].expand(-1, -1, 3))
        xy = pos2local(dest_pose[:, :, None, :2], ag_pose[:, :, None, :2], rad2rot(ag_pose[..., 2]))[:, :, 0]
        yaw = rad2local(dest_pose[..., 2:3], ag_pose[..., 2], cast=False)[..., 0]
        return feat + self.mlp_pe(apply_pose_emb(self.pose_rpe, xy, yaw[..., None]))


class NaviPredictor(nn.Module):
    """Destination distribution from the agent track (HPTR temporal tokens)."""

    def __init__(self, cfg: NaviPredictorCfg, ag_encoder_cfg: AgEncoderCfg, hidden_dim: int, navi_mode: str,
                 temp_window_size: int, pose_rpe: PoseEmbConfig, attr_dim: int,
                 temp_encoder_n_layer: int = 3, temp_encoder_pooling: str = "max_valid",
                 temp_encoder_dropout_p: float = 0.1, dtype=torch.float32):
        super().__init__()
        _check_dest(navi_mode)
        if temp_window_size <= 0:
            raise NotImplementedError("the GRU navi predictor comes with the RNN slice")
        self.pose_rpe, self.temp_window_size, self.hidden_dim = pose_rpe, temp_window_size, hidden_dim
        self.detach_input = cfg.detach_input
        ie = ag_encoder_cfg.input_encoder
        pe_dim = hidden_dim if ie.mode == "add" else hidden_dim // 2
        self.pe_cfg = PoseEmbConfig(mode=ag_encoder_cfg.pose_emb.mode, pe_dim=pe_dim,
                                    theta_xy=ag_encoder_cfg.pose_emb.theta_xy,
                                    theta_cs=ag_encoder_cfg.pose_emb.theta_cs)
        self.input_encoder = InputEncoder(attr_dim + 3 + temp_window_size, hidden_dim,
                                          pose_emb_out_dim(self.pe_cfg), ie.n_layer, ie.mode,
                                          ie.mlp_use_layernorm, ie.mlp_dropout_p, dtype=dtype)
        self.temp_encoder = PolylineEncoder(hidden_dim, temp_encoder_n_layer, temp_encoder_pooling,
                                            mlp_dropout_p=temp_encoder_dropout_p, dtype=dtype)
        self.mlp = MLP(2 * hidden_dim + pose_emb_out_dim(pose_rpe), [hidden_dim] * (cfg.n_layer_mlp - 1) + [1],
                       end_layer_activation=False, use_layernorm=cfg.mlp_use_layernorm, dtype=dtype)
        self.dtype = dtype

    def forward(self, ag_valid, ag_attr, ag_motion, ag_pose, ag_type, mp_tokens: MapTokens) -> DestCategorical:
        if self.detach_input:
            ag_motion, ag_pose = ag_motion.detach(), ag_pose.detach()
            mp_tokens = dataclasses.replace(mp_tokens, feature=mp_tokens.feature.detach())
        n_sc, n_ag, n_step = ag_valid.shape
        ag_token_valid = ag_valid.any(-1)
        ag_invalid, ag_token_invalid = ~ag_valid, ~ag_token_valid
        ag_token_pose = seq_pooling(ag_pose, ag_invalid, "last_valid")

        w = self.temp_window_size
        if n_step > w:
            ag_pose, ag_motion, ag_invalid = ag_pose[:, :, -w:], ag_motion[:, :, -w:], ag_invalid[:, :, -w:]
            n_step = w
        ag_xy = pos2local(ag_pose[..., :2], ag_token_pose[:, :, None, :2], rad2rot(ag_token_pose[..., 2]))
        ag_yaw = rad2local(ag_pose[..., 2], ag_token_pose[..., 2], cast=False)
        pe = apply_pose_emb(self.pe_cfg, ag_xy, ag_yaw[..., None])
        ohe = torch.eye(w, dtype=self.dtype, device=ag_valid.device)[w - n_step:]
        attr = torch.cat([
            ag_attr[:, :, None, :].expand(n_sc, n_ag, n_step, ag_attr.shape[-1]).to(self.dtype),
            ag_motion.to(self.dtype),
            ohe[None, None].expand(n_sc, n_ag, n_step, w),
        ], -1)
        ag_token_feature = self.temp_encoder(self.input_encoder(attr, pe), ag_invalid)

        n_mp, h = mp_tokens.invalid.shape[1], self.hidden_dim
        rpe_ag2mp, _ = get_rel_pose(ag_token_pose, ag_token_invalid, mp_tokens.pose, mp_tokens.invalid)
        rpe_ag2mp = apply_pose_emb(self.pose_rpe, rpe_ag2mp[..., :2], rpe_ag2mp[..., 2:3])
        pair = torch.cat([
            ag_token_feature[:, :, None].expand(n_sc, n_ag, n_mp, h),
            mp_tokens.feature[:, None].expand(n_sc, n_ag, n_mp, h),
            rpe_ag2mp.to(self.dtype),
        ], -1)
        logits = self.mlp(pair)[..., 0]

        # agent-type / lane-type compatibility (WOMD lane types 0-4)
        mp_type = mp_tokens.type
        mp_type_mask = mp_tokens.invalid | ~mp_type[:, :, :5].any(-1)
        m_veh = ag_type[:, :, 0:1] & mp_type[:, :, 3][:, None, :]
        m_ped = ag_type[:, :, 1:2] & mp_type[:, :, :4].any(-1)[:, None, :]
        m_cyc = ag_type[:, :, 2:3] & mp_type[:, :, :3].any(-1)[:, None, :]
        logits_invalid = mp_type_mask[:, None, :] | m_veh | m_ped | m_cyc
        logits = torch.where(logits_invalid, _NEG, logits)
        all_invalid = logits_invalid.all(-1, keepdim=True)
        logits = torch.where(ag_token_invalid[..., None] | all_invalid, 0.0, logits)
        return DestCategorical(logits=logits, valid=ag_token_valid)
