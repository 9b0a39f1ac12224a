"""CVAE latent encoder: posterior and prior (counterpart of `trafficbotsv15_tpu/models/latent_encoder.py`).

The posterior sees the whole GT episode, down-sampled in time by
`temporal_down_sample_rate` (91 steps -> 19 at the flagship): its own TL and
agent encoders, with a (time_step_gt + 1) // rate + 1 window in HPTR mode
(the RNN encoders of the TrafficBots family, temp_window_size <= 0, read the
whole sequence: `AgentEncoder._forward_rnn_latent`), and a `diag_gaus`
head. The flagship prior is `std_gaus`, whose head runs no network. A
learned prior has encoders of its own, or the posterior's with
`share_post_prior_encoders`. The categorical heads (`cat`, `std_cat`) raise.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from trafficbotsv15_tpu_torch.config import AgEncoderCfg, DistEncoderCfg, LatentEncoderCfg, TlEncoderCfg, TransformerCfg
from trafficbotsv15_tpu_torch.models.agent_encoder import AgentEncoder
from trafficbotsv15_tpu_torch.models.heads import GaussianHead
from trafficbotsv15_tpu_torch.models.tokens import MapTokens, TlTokens
from trafficbotsv15_tpu_torch.models.traffic_light import TrafficLightEncoder
from trafficbotsv15_tpu_torch.ops.distributions import DiagGaussian


class StdGaussian(nn.Module):
    """The `std_gaus` latent head: a standard normal, no network."""

    skips_forward = True

    def __init__(self, out_dim: int, dtype=torch.float32):
        super().__init__()
        self.out_dim, self.dtype = out_dim, dtype

    def forward(self, x, valid: torch.Tensor, ag_type=None) -> DiagGaussian:
        """valid [n_sc, n_ag] -> [n_sc, n_ag, out_dim]; x and ag_type unused."""
        mean = torch.zeros(tuple(valid.shape) + (self.out_dim,), dtype=self.dtype, device=valid.device)
        return DiagGaussian(mean, torch.ones_like(mean), valid=valid)


def dist_encoder(cfg: DistEncoderCfg, hidden_dim: int, out_dim: int, n_ag_type: int,
                 dtype=torch.float32) -> nn.Module:
    """Latent distribution head: `std_gaus` (`StdGaussian`) or `diag_gaus` (`GaussianHead`, unbranched or
    type-branched, log_std a vector or an MLP). The categorical heads raise."""
    if cfg.dist_type == "std_gaus":
        return StdGaussian(out_dim, dtype)
    if cfg.dist_type == "diag_gaus":
        return GaussianHead(cfg, hidden_dim, out_dim, n_ag_type, dtype=dtype)
    raise NotImplementedError(f"latent head {cfg.dist_type!r} is not ported")


class LatentEncoder(nn.Module):
    def __init__(self, cfg: LatentEncoderCfg, tl_encoder_cfg: TlEncoderCfg, ag_encoder_cfg: AgEncoderCfg,
                 tf_cfg: TransformerCfg, hidden_dim: int, temp_window_size: int, time_step_gt: int,
                 enc_kw: dict, tl_kw: dict, ag_kw: dict, n_ag_type: int, dtype=torch.float32):
        """enc_kw: what the TL and agent encoders share (pose_rpe, n_tgt_knn, dist_limit, temporal
        encoder settings); tl_kw / ag_kw: what only one of them takes."""
        super().__init__()
        self.cfg = cfg
        self.dummy = cfg.latent_dim <= 0
        if self.dummy:
            return
        rate = cfg.temporal_down_sample_rate
        if temp_window_size <= 0:
            window = temp_window_size  # the RNN encoders
        else:
            window = (time_step_gt + 1) // rate + 1 if rate > 1 else time_step_gt + 1
        self.dist_post = dist_encoder(cfg.latent_post, hidden_dim, cfg.latent_dim, n_ag_type, dtype=dtype)
        self.dist_prior = dist_encoder(cfg.latent_prior, hidden_dim, cfg.latent_dim, n_ag_type, dtype=dtype)

        def encoders():
            return (TrafficLightEncoder(tl_encoder_cfg, tf_cfg, hidden_dim, temp_window_size=window, dtype=dtype,
                                        **enc_kw, **tl_kw),
                    AgentEncoder(ag_encoder_cfg, tf_cfg, hidden_dim, window, dtype=dtype, **enc_kw, **ag_kw))

        # flax creates parameters only for the encoders a call reaches
        self._prior_encoders = None
        if not self.dist_post.skips_forward:
            self.tl_encoder_post, self.ag_encoder_post = encoders()
        if not self.dist_prior.skips_forward:
            if cfg.share_post_prior_encoders and not self.dist_post.skips_forward:
                self._prior_encoders = (self.tl_encoder_post, self.ag_encoder_post)  # shared, one set of names
            else:
                self.tl_encoder_prior, self.ag_encoder_prior = encoders()
                self._prior_encoders = (self.tl_encoder_prior, self.ag_encoder_prior)

    def forward(self, ag_valid, ag_attr, ag_motion, ag_pose, ag_type, tl_state, mp_tokens: MapTokens,
                tl_tokens: TlTokens, posterior: bool) -> Optional[DiagGaussian]:
        """ag_valid [n_sc, n_ag, n_step], ag_motion / ag_pose [.., n_step, 3], tl_state [n_sc, n_tl, n_step, 5]
        -> distribution over [n_sc, n_ag, latent_dim] (None when the latent is disabled). Only the
        type-branched heads read ag_type."""
        if self.dummy:
            return None
        head = self.dist_post if posterior else self.dist_prior
        if head.skips_forward:
            return head(ag_attr, ag_valid.any(-1), ag_type)
        rate = self.cfg.temporal_down_sample_rate
        if rate > 1:
            ag_valid, ag_motion, ag_pose = ag_valid[:, :, ::rate], ag_motion[:, :, ::rate], ag_pose[:, :, ::rate]
            tl_state = tl_state[:, :, ::rate]
        tl_enc, ag_enc = (self.tl_encoder_post, self.ag_encoder_post) if posterior else self._prior_encoders
        tl_feature = tl_enc(tl_state, tl_tokens, called_by_latent_encoder=True)
        ag_feature, _ = ag_enc(ag_valid, ag_attr, ag_motion, ag_pose, mp_tokens, tl_tokens.invalid,
                               tl_feature, tl_tokens.pose, called_by_latent_encoder=True)
        return head(ag_feature, ag_valid.any(-1), ag_type)
