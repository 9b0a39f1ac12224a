"""Navigation encoder and predictor (counterpart of `trafficbotsv15_tpu/models/navigation.py`).

Four modes, as in the JAX package:
  - `dest` (the flagship): the predictor scores every map polyline per agent
    with agent/map-type compatibility masking; the encoder embeds the chosen
    polyline relative to the agent each step;
  - `goal`: the predictor cross-attends from the agent's track token to its
    K = n_tgt_knn * k_tgt_knn nearest map polylines (`tf_ag2mp`, KNARPE B2
    with `use_pallas`), then an MLP gives the goal (x, y, yaw, speed) in the
    agent's frame, taken back to the world frame, under a diagonal Gaussian
    with a learned `log_std`; the encoder embeds the goal's pose relative to
    the agent (stop-gradient on x, y and yaw) with its speed;
  - `cmd`: the same cross-attention and MLP give the logits of the
    `n_ag_cmd` driving commands; the encoder is an MLP over the command's
    one-hot;
  - `dummy`: no navigation; both return None.
The predictor encodes the agent's track with HPTR temporal tokens over the
last window, or, in the TrafficBots RNN family (temp_window_size <= 0), with
a GRU over the whole history (its input added back with `rnn_res_add`, then
pooled by `rnn_latent_temp_pool_mode`).

The scene-centric model (`pairwise_relative=False`) works in the global
frame: the encoder embeds a destination by its map feature alone (no
`mlp_pe`) and a goal's global pose with the map encoder's pose embedding;
the predictor's track tokens embed global poses (the RNN track too), its
dest MLP reads no relative pose, its goal / cmd KNN is selected by distance
alone (`get_rel_dist` + `get_tgt_knn`) and attended without RPE, and its
goal is the MLP's output as it is.

`mp_rep > 1` (K-futures token dedup): the map tokens hold the unique
scenarios, each shared by mp_rep consecutive rows; the destination gathers
fold the replicas into the agent axis.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from trafficbotsv15_tpu_torch.config import AgEncoderCfg, NaviEncoderCfg, NaviPredictorCfg, TransformerCfg
from trafficbotsv15_tpu_torch.models.gru import MultiAgentGRU
from trafficbotsv15_tpu_torch.models.mlp import MLP, InputEncoder, PolylineEncoder
from trafficbotsv15_tpu_torch.models.tokens import MapTokens
from trafficbotsv15_tpu_torch.models.transformer import TransformerBlock
from trafficbotsv15_tpu_torch.ops.distributions import DestCategorical, DiagGaussian
from trafficbotsv15_tpu_torch.ops.pooling import seq_pooling
from trafficbotsv15_tpu_torch.ops.pose_emb import PoseEmbConfig, apply_pose_emb, pose_emb_out_dim
from trafficbotsv15_tpu_torch.ops.rpe import gather_tgt, get_rel_dist, get_rel_pose, get_tgt_knn
from trafficbotsv15_tpu_torch.ops.transform import pos2global, pos2local, rad2global, rad2local, rad2rot

_NEG = -1e9
NAVI_MODES = ("dest", "goal", "cmd", "dummy")


def navi_dim(navi_mode: str, n_ag_cmd: int) -> Optional[int]:
    """Width of a goal (x, y, yaw, speed) or command (one-hot) navi; None for dest and dummy."""
    return {"cmd": n_ag_cmd, "goal": 4}.get(navi_mode)


def navi_of_draw(navi_mode: str, navi_dist, draw: torch.Tensor) -> torch.Tensor:
    """The encoder's navi for a draw of the predictor's navi_dist: a command's one-hot [.., n_ag_cmd] (bool, the
    form of the data's `agent/cmd`) for its class index; a destination index or a goal as it is. The JAX package
    hands the class index itself to the cmd encoder, whose first layer then fails on its shape."""
    if navi_mode == "cmd":
        return torch.nn.functional.one_hot(draw.long(), navi_dist.logits.shape[-1]).bool()
    return draw


def _check_mode(navi_mode: str) -> None:
    if navi_mode not in NAVI_MODES:
        raise NotImplementedError(f"navi_mode {navi_mode!r}")


class NaviEncoder(nn.Module):
    """Per-agent feature of the navigation target, relative to the agent's pose where it has one."""

    def __init__(self, cfg: NaviEncoderCfg, hidden_dim: int, navi_mode: str, pose_rpe: PoseEmbConfig,
                 navi_dim: Optional[int] = None, pairwise_relative: bool = True,
                 mp_pose_emb: Optional[PoseEmbConfig] = None, dtype=torch.float32):
        """mp_pose_emb: the map encoder's node pose embedding, which embeds a scene-centric goal."""
        super().__init__()
        _check_mode(navi_mode)
        self.navi_mode, self.pose_rpe = navi_mode, pose_rpe
        self.pairwise_relative = pairwise_relative
        self.goal_pe = pose_rpe if pairwise_relative else mp_pose_emb
        self.dummy = navi_mode == "dummy"
        if navi_mode == "dest":
            self.detach_mp_feature = cfg.dest_detach_mp_feature
            self.mlp_mp = MLP(hidden_dim, [hidden_dim], end_layer_activation=False, dtype=dtype)
            if pairwise_relative:
                self.mlp_pe = MLP(pose_emb_out_dim(pose_rpe), [hidden_dim], end_layer_activation=False, dtype=dtype)
        elif navi_mode == "goal":  # pose embedding ++ speed
            self.mlp = MLP(pose_emb_out_dim(self.goal_pe) + 1, [hidden_dim], end_layer_activation=False, dtype=dtype)
        elif navi_mode == "cmd":
            self.mlp = MLP(navi_dim, [hidden_dim], end_layer_activation=False, dtype=dtype)
        self.dtype = dtype

    def forward(self, ag_navi, ag_pose, mp_tokens: MapTokens, mp_rep: int = 1):
        """ag_navi: dest [n_sc, n_ag] polyline index, goal [n_sc, n_ag, 4], cmd [n_sc, n_ag, n_ag_cmd] one-hot;
        ag_pose [n_sc, n_ag, 3] -> [n_sc, n_ag, hidden], or None in dummy mode. mp_rep > 1: mp_tokens hold the
        unique scenarios [n_sc // mp_rep, ...] (see the module docstring)."""
        if self.dummy:
            return None
        if self.navi_mode == "cmd":
            return self.mlp(ag_navi.to(self.dtype))
        if self.navi_mode == "goal":
            xy, yaw, spd = ag_navi[..., :2].detach(), ag_navi[..., 2:3].detach(), ag_navi[..., 3:4]
            if self.pairwise_relative:
                xy = pos2local(xy[:, :, None], ag_pose[:, :, None, :2], rad2rot(ag_pose[..., 2]))[:, :, 0]
                yaw = rad2local(yaw, ag_pose[..., 2], cast=False)
            return self.mlp(torch.cat([apply_pose_emb(self.goal_pe, xy, yaw), spd], -1))
        mp_feat = mp_tokens.feature.detach() if self.detach_mp_feature else mp_tokens.feature
        n_sc, n_ag = ag_navi.shape
        # the replicas fold into the agent axis of the gathers (mp_rep 1: the same gathers)
        idx = torch.clamp(ag_navi, 0, mp_feat.shape[1] - 1).long().reshape(n_sc // mp_rep, mp_rep * n_ag)
        feat = torch.gather(mp_feat, 1, idx[..., None].expand(-1, -1, mp_feat.shape[-1]))
        feat = self.mlp_mp(feat.reshape(n_sc, n_ag, feat.shape[-1]))
        if not self.pairwise_relative:
            return feat
        dest_pose = torch.gather(mp_tokens.pose, 1, idx[..., None].expand(-1, -1, 3)).reshape(n_sc, n_ag, 3)
        xy = pos2local(dest_pose[:, :, None, :2], ag_pose[:, :, None, :2], rad2rot(ag_pose[..., 2]))[:, :, 0]
        yaw = rad2local(dest_pose[..., 2:3], ag_pose[..., 2], cast=False)[..., 0]
        return feat + self.mlp_pe(apply_pose_emb(self.pose_rpe, xy, yaw[..., None]))


class NaviPredictor(nn.Module):
    """Navigation distribution from the agent track (HPTR temporal tokens, or a GRU in RNN mode): a
    `DestCategorical` over the map polylines (dest) or the commands (cmd), a `DiagGaussian` goal (goal), or None
    (dummy)."""

    def __init__(self, cfg: NaviPredictorCfg, ag_encoder_cfg: AgEncoderCfg, tf_cfg: TransformerCfg,
                 hidden_dim: int, navi_mode: str, temp_window_size: int, n_tgt_knn: int, dist_limit: float,
                 pose_rpe: PoseEmbConfig, attr_dim: int, navi_dim: Optional[int] = None,
                 temp_encoder_n_layer: int = 3, temp_encoder_pooling: str = "max_valid",
                 temp_encoder_dropout_p: float = 0.1, pairwise_relative: bool = True, dtype=torch.float32):
        super().__init__()
        _check_mode(navi_mode)
        self.navi_mode = navi_mode
        if navi_mode == "dummy":
            return
        self.pose_rpe, self.temp_window_size, self.hidden_dim = pose_rpe, temp_window_size, hidden_dim
        self.pairwise_relative = pairwise_relative
        self.detach_input = cfg.detach_input
        self.rnn = temp_window_size <= 0
        self.rnn_res_add, self.rnn_pool_mode = cfg.rnn_res_add, ag_encoder_cfg.rnn_latent_temp_pool_mode
        ie = ag_encoder_cfg.input_encoder
        self.pe_cfg = None  # the track's pose embedding (none in the pairwise-relative RNN)
        if not (self.rnn and pairwise_relative):
            self.pe_cfg = PoseEmbConfig(mode=ag_encoder_cfg.pose_emb.mode,
                                        pe_dim=hidden_dim if ie.mode == "add" else hidden_dim // 2,
                                        theta_xy=ag_encoder_cfg.pose_emb.theta_xy,
                                        theta_cs=ag_encoder_cfg.pose_emb.theta_cs)
        pe_width = 0 if self.pe_cfg is None else pose_emb_out_dim(self.pe_cfg)
        if self.rnn:  # no window slot
            self.input_encoder = InputEncoder(attr_dim + 3, hidden_dim, pe_width, ie.n_layer, ie.mode,
                                              ie.mlp_use_layernorm, ie.mlp_dropout_p, dtype=dtype)
            self.temp_encoder = MultiAgentGRU(hidden_dim, hidden_dim, temp_encoder_n_layer, temp_encoder_dropout_p,
                                              dtype=dtype)
        else:
            self.input_encoder = InputEncoder(attr_dim + 3 + temp_window_size, hidden_dim, pe_width, ie.n_layer,
                                              ie.mode, ie.mlp_use_layernorm, ie.mlp_dropout_p, dtype=dtype)
            self.temp_encoder = PolylineEncoder(hidden_dim, temp_encoder_n_layer, temp_encoder_pooling,
                                                mlp_dropout_p=temp_encoder_dropout_p, dtype=dtype)
        dims = [hidden_dim] * (cfg.n_layer_mlp - 1)
        d_rpe = pose_emb_out_dim(pose_rpe) if pairwise_relative else -1
        if navi_mode == "dest":
            self.mlp = MLP(2 * hidden_dim + max(d_rpe, 0), dims + [1], end_layer_activation=False,
                           use_layernorm=cfg.mlp_use_layernorm, dtype=dtype)
        else:  # goal / cmd: cross-attention to the K nearest map polylines, then the MLP
            self.n_knn, self.limit = int(n_tgt_knn * cfg.k_tgt_knn), dist_limit * cfg.k_dist_limit
            self.tf_ag2mp = TransformerBlock(tf_cfg, cfg.n_layer_tf, "enc_cross_attn", d_rpe=d_rpe, dtype=dtype)
            self.mlp = MLP(hidden_dim, dims + [navi_dim], end_layer_activation=False,
                           use_layernorm=cfg.mlp_use_layernorm, dtype=dtype)
            if navi_mode == "goal":
                self.log_std = nn.Parameter(torch.full((navi_dim,), float(cfg.goal_log_std)))
        self.dtype = dtype

    def forward(self, ag_valid, ag_attr, ag_motion, ag_pose, ag_type, mp_tokens: MapTokens):
        if self.navi_mode == "dummy":
            return None
        if self.detach_input:
            ag_motion, ag_pose = ag_motion.detach(), ag_pose.detach()
            mp_tokens = dataclasses.replace(mp_tokens, feature=mp_tokens.feature.detach())
        ag_token_valid = ag_valid.any(-1)
        ag_invalid, ag_token_invalid = ~ag_valid, ~ag_token_valid
        ag_token_pose = seq_pooling(ag_pose, ag_invalid, "last_valid")
        ag_token_feature = (self._track_rnn if self.rnn else self._track_hptr)(ag_attr, ag_motion, ag_pose,
                                                                             ag_invalid, ag_token_pose)
        if self.navi_mode == "dest":
            return self._dest(ag_token_feature, ag_token_pose, ag_token_valid, ag_type, mp_tokens)

        if self.pairwise_relative:
            rel_pose, rel_dist = get_rel_pose(ag_token_pose, ag_token_invalid, mp_tokens.pose, mp_tokens.invalid)
        else:
            rel_pose = None
            rel_dist = get_rel_dist(ag_token_pose[..., :2], ag_token_invalid, mp_tokens.pose[..., :2],
                                    mp_tokens.invalid)
        idx, knn_invalid, rpe = get_tgt_knn(rel_pose, rel_dist, self.n_knn, self.limit)
        if rpe is not None:
            rpe = apply_pose_emb(self.pose_rpe, rpe[..., :2], rpe[..., 2:3])
        ag_token_feature = self.tf_ag2mp(ag_token_feature, src_padding_mask=ag_token_invalid,
                                         tgt=gather_tgt(mp_tokens.feature, idx), tgt_padding_mask=knn_invalid, rpe=rpe)
        out = self.mlp(ag_token_feature)
        if self.navi_mode == "cmd":
            return DestCategorical(logits=torch.where(ag_token_invalid[..., None], 0.0, out), valid=ag_token_valid)
        if self.pairwise_relative:
            # goal: from the agent's frame back to the world's (float32, as JAX promotes the compute dtype)
            ref_yaw = ag_token_pose[..., 2]
            xy = pos2global(out[:, :, None, :2], ag_token_pose[:, :, None, :2], rad2rot(ref_yaw))[:, :, 0]
            out = torch.cat([xy, rad2global(out[:, :, 2:3], ref_yaw), out[:, :, 3:4].float()], -1)
        out = torch.where(ag_token_invalid[..., None], 0.0, out)
        return DiagGaussian(out, torch.exp(self.log_std).expand(out.shape), valid=ag_token_valid)

    def _dest(self, ag_token_feature, ag_token_pose, ag_token_valid, ag_type, mp_tokens: MapTokens):
        """Logits over the map polylines of each agent's destination, masked by agent / lane type."""
        n_sc, n_ag, h = ag_token_feature.shape
        n_mp = mp_tokens.invalid.shape[1]
        ag_token_invalid = ~ag_token_valid
        pair = [ag_token_feature[:, :, None].expand(n_sc, n_ag, n_mp, h),
                mp_tokens.feature[:, None].expand(n_sc, n_ag, n_mp, h)]
        if self.pairwise_relative:
            rpe_ag2mp, _ = get_rel_pose(ag_token_pose, ag_token_invalid, mp_tokens.pose, mp_tokens.invalid)
            pair.append(apply_pose_emb(self.pose_rpe, rpe_ag2mp[..., :2], rpe_ag2mp[..., 2:3]).to(self.dtype))
        logits = self.mlp(torch.cat(pair, -1))[..., 0]

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

    def _track_rnn(self, ag_attr, ag_motion, ag_pose, ag_invalid, ag_token_pose):
        """The GRU over the whole track [n_sc, n_ag, n_step], pooled -> [n_sc, n_ag, hidden]."""
        n_sc, n_ag, n_step = ag_invalid.shape
        attr = torch.cat([ag_attr[:, :, None, :].expand(n_sc, n_ag, n_step, ag_attr.shape[-1]).to(self.dtype),
                          ag_motion.to(self.dtype)], -1)
        pe = None if self.pe_cfg is None else apply_pose_emb(self.pe_cfg, ag_pose[..., :2], ag_pose[..., 2:3])
        feat = self.input_encoder(attr, pe)
        out, _ = self.temp_encoder(feat, ag_invalid)
        if self.rnn_res_add:
            out = out + feat
        return seq_pooling(out, ag_invalid, self.rnn_pool_mode)

    def _track_hptr(self, ag_attr, ag_motion, ag_pose, ag_invalid, ag_token_pose):
        """Temporal tokens over the last window, PointNet-pooled -> [n_sc, n_ag, hidden]."""
        n_sc, n_ag, n_step = ag_invalid.shape
        w = self.temp_window_size
        if n_step > w:
            ag_pose, ag_motion, ag_invalid = ag_pose[:, :, -w:], ag_motion[:, :, -w:], ag_invalid[:, :, -w:]
            n_step = w
        ag_xy, ag_yaw = ag_pose[..., :2], ag_pose[..., 2]
        if self.pairwise_relative:
            ag_xy = pos2local(ag_xy, ag_token_pose[:, :, None, :2], rad2rot(ag_token_pose[..., 2]))
            ag_yaw = rad2local(ag_yaw, ag_token_pose[..., 2], cast=False)
        pe = apply_pose_emb(self.pe_cfg, ag_xy, ag_yaw[..., None])
        ohe = torch.eye(w, dtype=self.dtype, device=ag_invalid.device)[w - n_step:]
        attr = torch.cat([
            ag_attr[:, :, None, :].expand(n_sc, n_ag, n_step, ag_attr.shape[-1]).to(self.dtype),
            ag_motion.to(self.dtype),
            ohe[None, None].expand(n_sc, n_ag, n_step, w),
        ], -1)
        return self.temp_encoder(self.input_encoder(attr, pe), ag_invalid)
