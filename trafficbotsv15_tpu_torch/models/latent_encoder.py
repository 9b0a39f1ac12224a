"""CVAE latent encoder: posterior and prior (counterpart of `trafficbotsv15_tpu/models/latent_encoder.py`).

The posterior sees the whole GT episode, down-sampled in time by
`temporal_down_sample_rate` (91 steps -> 19 at the flagship): its own TL and
agent encoders, with a (time_step_gt + 1) // rate + 1 window, and a
`diag_gaus` head. The flagship prior is `std_gaus`, whose head runs no
network. A learned prior has encoders of its own, or the posterior's with
`share_post_prior_encoders`. The categorical heads (`cat`, `std_cat`), the
type-branched heads and the RNN encoders (temp_window_size <= 0) raise.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from trafficbotsv15_tpu_torch.config import AgEncoderCfg, DistEncoderCfg, LatentEncoderCfg, TlEncoderCfg, TransformerCfg
from trafficbotsv15_tpu_torch.models.agent_encoder import AgentEncoder
from trafficbotsv15_tpu_torch.models.mlp import MLP
from trafficbotsv15_tpu_torch.models.tokens import MapTokens, TlTokens
from trafficbotsv15_tpu_torch.models.traffic_light import TrafficLightEncoder
from trafficbotsv15_tpu_torch.ops.distributions import DiagGaussian


class DistEncoder(nn.Module):
    """Latent distribution head: `std_gaus` (no network) or `diag_gaus` (MLP mean, learned log_std vector).
    The type-branched heads, an MLP log_std and the categorical heads raise."""

    def __init__(self, cfg: DistEncoderCfg, hidden_dim: int, out_dim: int, dtype=torch.float32):
        super().__init__()
        if cfg.dist_type not in ("std_gaus", "diag_gaus") or (
                cfg.dist_type == "diag_gaus" and (cfg.branch_type or cfg.log_std is None)):
            raise NotImplementedError(f"latent head {cfg.dist_type!r} (branch_type={cfg.branch_type}, "
                                      f"log_std={cfg.log_std}) is not ported")
        self.cfg, self.out_dim, self.dtype = cfg, out_dim, dtype
        if cfg.dist_type == "diag_gaus":
            self.mean = MLP(hidden_dim, [hidden_dim] * (cfg.n_layer - 1) + [out_dim], end_layer_activation=False,
                            use_layernorm=cfg.mlp_use_layernorm, dtype=dtype)
            self.log_std = nn.Parameter(torch.full((out_dim,), float(cfg.log_std)))

    @property
    def skips_forward(self) -> bool:
        return self.cfg.dist_type == "std_gaus"

    def forward(self, x, valid: torch.Tensor) -> DiagGaussian:
        """x [n_sc, n_ag, hidden] (unused by std_gaus), valid [n_sc, n_ag] -> [n_sc, n_ag, out_dim]."""
        shape = tuple(valid.shape) + (self.out_dim,)
        if self.skips_forward:
            mean = torch.zeros(shape, dtype=self.dtype, device=valid.device)
            return DiagGaussian(mean, torch.ones_like(mean), valid=valid)
        return DiagGaussian(self.mean(x, ~valid), torch.exp(self.log_std.expand(shape)), valid=valid)


class LatentEncoder(nn.Module):
    def __init__(self, cfg: LatentEncoderCfg, tl_encoder_cfg: TlEncoderCfg, ag_encoder_cfg: AgEncoderCfg,
                 tf_cfg: TransformerCfg, hidden_dim: int, temp_window_size: int, time_step_gt: int,
                 enc_kw: dict, tl_kw: dict, ag_kw: dict, dtype=torch.float32):
        """enc_kw: what the TL and agent encoders share (pose_rpe, n_tgt_knn, dist_limit, temporal
        encoder settings); tl_kw / ag_kw: what only one of them takes."""
        super().__init__()
        self.cfg = cfg
        self.dummy = cfg.latent_dim <= 0
        if self.dummy:
            return
        if temp_window_size <= 0:
            raise NotImplementedError("the RNN latent encoders come with the RNN slice")
        rate = cfg.temporal_down_sample_rate
        window = (time_step_gt + 1) // rate + 1 if rate > 1 else time_step_gt + 1
        self.dist_post = DistEncoder(cfg.latent_post, hidden_dim, cfg.latent_dim, dtype=dtype)
        self.dist_prior = DistEncoder(cfg.latent_prior, hidden_dim, cfg.latent_dim, dtype=dtype)

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
        -> distribution over [n_sc, n_ag, latent_dim] (None when the latent is disabled). ag_type
        keeps the JAX signature; only the type-branched heads, which raise here, read it."""
        if self.dummy:
            return None
        head = self.dist_post if posterior else self.dist_prior
        if head.skips_forward:
            return head(ag_attr, ag_valid.any(-1))
        rate = self.cfg.temporal_down_sample_rate
        if rate > 1:
            ag_valid, ag_motion, ag_pose = ag_valid[:, :, ::rate], ag_motion[:, :, ::rate], ag_pose[:, :, ::rate]
            tl_state = tl_state[:, :, ::rate]
        tl_enc, ag_enc = (self.tl_encoder_post, self.ag_encoder_post) if posterior else self._prior_encoders
        tl_feature = tl_enc(tl_state, tl_tokens, called_by_latent_encoder=True)
        ag_feature = ag_enc(ag_valid, ag_attr, ag_motion, ag_pose, mp_tokens, tl_tokens.invalid,
                            tl_feature, tl_tokens.pose)
        return head(ag_feature, ag_valid.any(-1))
