"""TrafficBots policy (counterpart of `trafficbotsv15_tpu/models/traffic_bots.py`).

Wires the map / traffic-light / agent encoders, the CVAE latent encoder
(posterior and prior), the navigation predictor and encoder (dest, goal,
cmd or dummy, `models/navigation.py`), the fusion heads and the action head.
Submodule names follow the flax tree, so `utils/jax_import.py` maps a JAX
param tree onto `state_dict()` by path. Methods are the per-phase entry
points the joint-future path calls; the history window and, in the
TrafficBots RNN family (temp_window_size <= 0), the GRU hiddens live in the
rollout's carry. `cfg.pairwise_relative` picks the pairwise-relative model
(relative poses, RPE) or the scene-centric one (global poses, no RPE), as in
the JAX package; every encoder takes it.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from trafficbotsv15_tpu_torch.config import DataCfg, ModelCfg
from trafficbotsv15_tpu_torch.models.agent_encoder import AgentEncoder
from trafficbotsv15_tpu_torch.models.heads import AddNaviLatent, GaussianHead
from trafficbotsv15_tpu_torch.models.latent_encoder import LatentEncoder
from trafficbotsv15_tpu_torch.models.map_encoder import MapEncoder
from trafficbotsv15_tpu_torch.models.navigation import NaviEncoder, NaviPredictor, navi_dim
from trafficbotsv15_tpu_torch.models.tokens import MapTokens, TlTokens
from trafficbotsv15_tpu_torch.models.traffic_light import TrafficLightEncoder, TrafficLightStatePredictor
from trafficbotsv15_tpu_torch.ops.distributions import DiagGaussian
from trafficbotsv15_tpu_torch.ops.flags import OpsCfg, check_supported
from trafficbotsv15_tpu_torch.ops.pose_emb import PoseEmbConfig

TL_STATE_DIM = 5


class TrafficBots(nn.Module):
    def __init__(self, cfg: ModelCfg, data: DataCfg, ops: OpsCfg = OpsCfg(), action_dim: int = 2,
                 time_step_gt: int = 90, dtype=torch.float32):
        super().__init__()
        check_supported(ops)
        self.cfg, self.dtype = cfg, dtype
        # the kill switch turns the attention kernels off as in the JAX package (pallas_knarpe.py:53-59),
        # where use_pallas=True then takes the use_pallas=False branches
        c = dataclasses.replace(cfg, tf_cfg=dataclasses.replace(
            cfg.tf_cfg, use_pallas=cfg.tf_cfg.use_pallas and ops.use_pallas_attention))
        h = c.hidden_dim
        pose_rpe = PoseEmbConfig(mode=c.pose_rpe.mode, pe_dim=h, theta_xy=c.pose_rpe.theta_xy,
                                 theta_cs=c.pose_rpe.theta_cs)
        ag_attr_dim = 3 + data.n_ag_type  # size ++ type one-hot
        pw = c.pairwise_relative
        temp = dict(temp_encoder_n_layer=c.mp_encoder.pl_encoder.n_layer,
                    temp_encoder_pooling=c.mp_encoder.pl_encoder.pooling_mode,
                    temp_encoder_dropout_p=c.mp_encoder.pl_encoder.mlp_dropout_p)
        self.mp_encoder = MapEncoder(c.mp_encoder, c.tf_cfg, h, c.n_tgt_knn, c.dist_limit, pose_rpe,
                                     attr_dim=data.n_mp_type + data.n_mp_pl_node, mp2mp_lazy=ops.mp2mp_lazy,
                                     knn_kernel_on=ops.knn_pallas, pairwise_relative=pw, dtype=dtype)
        self.tl_encoder = TrafficLightEncoder(c.tl_encoder, c.tf_cfg, h, TL_STATE_DIM, c.tl_mode,
                                              c.temp_window_size, c.n_tgt_knn, c.dist_limit, pose_rpe,
                                              pairwise_relative=pw, dtype=dtype, **temp)
        self.tl_state_predictor = TrafficLightStatePredictor(c.tl_state_predictor, h, TL_STATE_DIM,
                                                             c.temp_window_size, dtype=dtype)
        self.ag_encoder = AgentEncoder(c.ag_encoder, c.tf_cfg, h, c.temp_window_size, c.n_tgt_knn,
                                       c.dist_limit, pose_rpe, ag_attr_dim, knn_kernel_on=ops.knn_pallas,
                                       pairwise_relative=pw, dtype=dtype, **temp)
        self.latent_encoder = LatentEncoder(
            c.latent_encoder, c.tl_encoder, c.ag_encoder, c.tf_cfg, h, c.temp_window_size, time_step_gt,
            enc_kw=dict(n_tgt_knn=c.n_tgt_knn, dist_limit=c.dist_limit, pose_rpe=pose_rpe, pairwise_relative=pw,
                        **temp),
            tl_kw=dict(tl_state_dim=TL_STATE_DIM, tl_mode=c.tl_mode),
            ag_kw=dict(attr_dim=ag_attr_dim, knn_kernel_on=ops.knn_pallas), n_ag_type=data.n_ag_type, dtype=dtype)
        n_navi = navi_dim(c.navi_mode, data.n_ag_cmd)
        mpe = c.mp_encoder.pose_emb
        mp_pose_emb = PoseEmbConfig(mode=mpe.mode, pe_dim=h if c.mp_encoder.input_encoder.mode == "add" else h // 2,
                                    theta_xy=mpe.theta_xy, theta_cs=mpe.theta_cs)
        self.navi_encoder = NaviEncoder(c.navi_encoder, h, c.navi_mode, pose_rpe, n_navi, pairwise_relative=pw,
                                        mp_pose_emb=mp_pose_emb, dtype=dtype)
        self.navi_predictor = NaviPredictor(c.navi_predictor, c.ag_encoder, c.tf_cfg, h, c.navi_mode,
                                            c.temp_window_size, c.n_tgt_knn, c.dist_limit, pose_rpe, ag_attr_dim,
                                            n_navi, pairwise_relative=pw, dtype=dtype, **temp)
        self.add_navi = AddNaviLatent(c.add_navi_latent, h, h, dummy=self.navi_encoder.dummy, dtype=dtype)
        self.add_latent = AddNaviLatent(c.add_navi_latent, h, max(c.latent_encoder.latent_dim, 1),
                                        dummy=self.latent_encoder.dummy, dtype=dtype)
        self.action_head = GaussianHead(c.action_head, h, action_dim, data.n_ag_type, dtype=dtype, fp32_out=True)

    # --- per-phase entry points ----------------------------------------------
    def encode_map(self, mp_valid, mp_attr, mp_pose, mp_type) -> MapTokens:
        return self.mp_encoder(mp_valid, mp_attr, mp_pose, mp_type)

    def precompute_tl(self, tl_valid, tl_attr, tl_pose, mp_tokens: MapTokens) -> TlTokens:
        return self.tl_encoder.precompute(tl_valid, tl_attr, tl_pose, mp_tokens)

    def encode_latent(self, ag_valid, ag_attr, ag_motion, ag_pose, ag_type, tl_state, mp_tokens: MapTokens,
                      tl_tokens: TlTokens, posterior: bool):
        return self.latent_encoder(ag_valid, ag_attr, ag_motion, ag_pose, ag_type, tl_state, mp_tokens, tl_tokens,
                                   posterior=posterior)

    def predict_navi(self, ag_valid, ag_attr, ag_motion, ag_pose, ag_type, mp_tokens: MapTokens):
        return self.navi_predictor(ag_valid, ag_attr, ag_motion, ag_pose, ag_type, mp_tokens)

    def step_tl(self, hist_tl_state, hist_step_invalid, tl_tokens: TlTokens):
        """TL feature + next-state logits for one history window [n_sc, n_tl, W, 5] (the TL pre-pass; HPTR mode
        only, as in the JAX package: the RNN-mode predictor carries a GRU hidden through the rollout)."""
        if self.cfg.temp_window_size <= 0:
            raise ValueError("the TL pre-pass needs HPTR mode (temp_window_size > 0)")
        feature = self.tl_encoder(hist_tl_state, tl_tokens, step_invalid=hist_step_invalid)
        return feature, self.tl_state_predictor(feature, tl_tokens.invalid)[0]

    def step(self, ag_valid, hist_ag_valid, hist_ag_pose, hist_ag_motion, ag_attr, ag_type,
             ag_latent, ag_latent_valid, ag_navi, ag_navi_valid, tl_tokens: TlTokens, mp_tokens: MapTokens,
             tl_token_feature=None, *, hist_tl_state=None, hist_step_invalid=None, rnn_hidden=None,
             tl_rnn_hidden=None, token_rep: int = 1):
        """One simulation step -> (action_dist, tl_logits, rnn_hidden, tl_rnn_hidden).

        With tl_token_feature (the TL pre-pass's, HPTR mode) the TL encoder and state predictor do not run
        and tl_logits is None. Without it they run inside the step on the TL history window hist_tl_state
        [n_sc, n_tl, W, 5] (hist_step_invalid [W] marks the unfilled slots) and the logits come back. In RNN
        mode (temp_window_size <= 0) the agent encoder's and the TL state predictor's GRU hiddens
        ([n_layer, n_sc, n_ag | n_tl, hidden], None for zeros) go in and come out; in HPTR mode they stay None.
        token_rep > 1 (K-futures token dedup, with the pre-pass): mp_tokens, tl_tokens and tl_token_feature hold
        the unique scenarios [n_sc // token_rep, ...], each shared by token_rep consecutive agent rows.
        """
        navi_feature = self.navi_encoder(ag_navi, hist_ag_pose[:, :, -1], mp_tokens, mp_rep=token_rep)
        tl_precomputed = tl_token_feature is not None
        if token_rep > 1 and not tl_precomputed:
            raise ValueError("token dedup needs the TL pre-pass: the in-rollout TL encoder reads the full batch")
        if tl_precomputed:
            tl_token_feature = tl_token_feature.to(self.dtype)
        else:
            tl_token_feature = self.tl_encoder(hist_tl_state, tl_tokens, step_invalid=hist_step_invalid)
        ag_feature, rnn_hidden = self.ag_encoder(hist_ag_valid, ag_attr, hist_ag_motion, hist_ag_pose, mp_tokens,
                                                 tl_tokens.invalid, tl_token_feature, tl_tokens.pose, rnn_hidden,
                                                 token_rep=token_rep)
        ag_feature = self.add_navi(ag_feature, navi_feature, ag_navi_valid)
        ag_feature = self.add_latent(ag_feature, ag_latent, ag_latent_valid)
        action_dist = self.action_head(ag_feature, ag_valid, ag_type)
        if tl_precomputed:
            return action_dist, None, rnn_hidden, tl_rnn_hidden
        tl_logits, tl_rnn_hidden = self.tl_state_predictor(tl_token_feature, tl_tokens.invalid, tl_rnn_hidden)
        return action_dist, tl_logits, rnn_hidden, tl_rnn_hidden
