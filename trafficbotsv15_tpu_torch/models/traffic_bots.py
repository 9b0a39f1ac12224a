"""TrafficBots policy (counterpart of `trafficbotsv15_tpu/models/traffic_bots.py`).

Wires the map / traffic-light / agent encoders, the CVAE latent encoder
(posterior and prior), the navigation predictor and encoder, the fusion
heads and the action head.
Submodule names follow the flax tree, so `utils/jax_import.py` maps a JAX
param tree onto `state_dict()` by path. Methods are the per-phase entry
points the joint-future path calls; the history window lives in the
rollout's carry.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from trafficbotsv15_tpu_torch.config import DataCfg, ModelCfg
from trafficbotsv15_tpu_torch.models.agent_encoder import AgentEncoder
from trafficbotsv15_tpu_torch.models.heads import ActionHead, AddNaviLatent
from trafficbotsv15_tpu_torch.models.latent_encoder import LatentEncoder
from trafficbotsv15_tpu_torch.models.map_encoder import MapEncoder
from trafficbotsv15_tpu_torch.models.navigation import NaviEncoder, NaviPredictor
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
        if not cfg.pairwise_relative:
            raise NotImplementedError("the scene-centric (pairwise_relative=False) model is not on the path")
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
        temp = dict(temp_encoder_n_layer=c.mp_encoder.pl_encoder.n_layer,
                    temp_encoder_pooling=c.mp_encoder.pl_encoder.pooling_mode,
                    temp_encoder_dropout_p=c.mp_encoder.pl_encoder.mlp_dropout_p)
        self.mp_encoder = MapEncoder(c.mp_encoder, c.tf_cfg, h, c.n_tgt_knn, c.dist_limit, pose_rpe,
                                     attr_dim=data.n_mp_type + data.n_mp_pl_node, mp2mp_lazy=ops.mp2mp_lazy,
                                     knn_kernel_on=ops.knn_pallas, dtype=dtype)
        self.tl_encoder = TrafficLightEncoder(c.tl_encoder, c.tf_cfg, h, TL_STATE_DIM, c.tl_mode,
                                              c.temp_window_size, c.n_tgt_knn, c.dist_limit, pose_rpe,
                                              dtype=dtype, **temp)
        self.tl_state_predictor = TrafficLightStatePredictor(c.tl_state_predictor, h, TL_STATE_DIM,
                                                             c.temp_window_size, dtype=dtype)
        self.ag_encoder = AgentEncoder(c.ag_encoder, c.tf_cfg, h, c.temp_window_size, c.n_tgt_knn,
                                       c.dist_limit, pose_rpe, ag_attr_dim, knn_kernel_on=ops.knn_pallas,
                                       dtype=dtype, **temp)
        self.latent_encoder = LatentEncoder(
            c.latent_encoder, c.tl_encoder, c.ag_encoder, c.tf_cfg, h, c.temp_window_size, time_step_gt,
            enc_kw=dict(n_tgt_knn=c.n_tgt_knn, dist_limit=c.dist_limit, pose_rpe=pose_rpe, **temp),
            tl_kw=dict(tl_state_dim=TL_STATE_DIM, tl_mode=c.tl_mode),
            ag_kw=dict(attr_dim=ag_attr_dim, knn_kernel_on=ops.knn_pallas), dtype=dtype)
        self.navi_encoder = NaviEncoder(c.navi_encoder, h, c.navi_mode, pose_rpe, dtype=dtype)
        self.navi_predictor = NaviPredictor(c.navi_predictor, c.ag_encoder, h, c.navi_mode, c.temp_window_size,
                                            pose_rpe, ag_attr_dim, dtype=dtype, **temp)
        self.add_navi = AddNaviLatent(c.add_navi_latent, h, h, dtype=dtype)
        self.add_latent = AddNaviLatent(c.add_navi_latent, h, max(c.latent_encoder.latent_dim, 1),
                                        dummy=self.latent_encoder.dummy, dtype=dtype)
        self.action_head = ActionHead(c.action_head, h, action_dim, n_ag_type=data.n_ag_type, dtype=dtype)

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
        """TL feature + next-state logits for one history window [n_sc, n_tl, W, 5]."""
        feature = self.tl_encoder(hist_tl_state, tl_tokens, step_invalid=hist_step_invalid)
        return feature, self.tl_state_predictor(feature, tl_tokens.invalid)

    def step(self, ag_valid, hist_ag_valid, hist_ag_pose, hist_ag_motion, ag_attr, ag_type,
             ag_latent, ag_latent_valid, ag_navi, ag_navi_valid, tl_tokens: TlTokens, mp_tokens: MapTokens,
             tl_token_feature) -> DiagGaussian:
        """One simulation step with the TL feature from the pre-pass; returns the action distribution."""
        if tl_token_feature is None:
            raise NotImplementedError("the in-rollout TL encoder is out of this slice: pass the pre-pass feature")
        navi_feature = self.navi_encoder(ag_navi, hist_ag_pose[:, :, -1], mp_tokens)
        ag_feature = self.ag_encoder(hist_ag_valid, ag_attr, hist_ag_motion, hist_ag_pose, mp_tokens,
                                     tl_tokens.invalid, tl_token_feature.to(self.dtype), tl_tokens.pose)
        ag_feature = self.add_navi(ag_feature, navi_feature, ag_navi_valid)
        ag_feature = self.add_latent(ag_feature, ag_latent, ag_latent_valid)
        return self.action_head(ag_feature, ag_valid, ag_type)
