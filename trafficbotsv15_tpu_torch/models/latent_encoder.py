"""CVAE latent encoder: posterior and prior (counterpart of `trafficbotsv15_tpu/models/latent_encoder.py`).

The posterior sees the whole GT episode, down-sampled in time by
`temporal_down_sample_rate` (91 steps -> 19 at the flagship): its own TL and
agent encoders, with a (time_step_gt + 1) // rate + 1 window in HPTR mode
(the RNN encoders of the TrafficBots family, temp_window_size <= 0, read the
whole sequence: `AgentEncoder._forward_rnn_latent`), and a `diag_gaus`
head. The flagship prior is `std_gaus`, whose head runs no network. A
learned prior has encoders of its own, or the posterior's with
`share_post_prior_encoders`. The categorical heads draw a flattened one-hot
of `n_cat` factors of `latent_dim // n_cat` classes: `std_cat` (zero logits,
no network) and `cat` (an MLP's logits). The posterior and the prior must be
of one family, Gaussian or categorical: the KL between them and their shared
training noise are defined only so.
"""

from __future__ import annotations

from typing import Optional, Union

import torch
from torch import nn

from trafficbotsv15_tpu_torch.config import AgEncoderCfg, DistEncoderCfg, LatentEncoderCfg, TlEncoderCfg, TransformerCfg
from trafficbotsv15_tpu_torch.models.agent_encoder import AgentEncoder
from trafficbotsv15_tpu_torch.models.heads import GaussianHead
from trafficbotsv15_tpu_torch.models.mlp import MLP
from trafficbotsv15_tpu_torch.models.tokens import MapTokens, TlTokens
from trafficbotsv15_tpu_torch.models.traffic_light import TrafficLightEncoder
from trafficbotsv15_tpu_torch.ops.distributions import DiagGaussian, MultiCategorical

CATEGORICAL = ("cat", "std_cat")


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


class StdCategorical(nn.Module):
    """The `std_cat` latent head: uniform categoricals (zero logits), no network."""

    skips_forward = True

    def __init__(self, n_cat: int, out_dim: int, dtype=torch.float32):
        super().__init__()
        self.n_cat, self.n_class, self.dtype = n_cat, out_dim // n_cat, dtype

    def forward(self, x, valid: torch.Tensor, ag_type=None) -> MultiCategorical:
        """valid [n_sc, n_ag] -> logits [n_sc, n_ag, n_cat, n_class]; x and ag_type unused."""
        shape = tuple(valid.shape) + (self.n_cat, self.n_class)
        return MultiCategorical(torch.zeros(shape, dtype=self.dtype, device=valid.device), valid=valid)


class CategoricalHead(nn.Module):
    """The `cat` latent head: an MLP's logits, one MLP per agent type with `branch_type` (`logits{i}`, each masked
    to its type's valid agents and summed), else one (`logits`)."""

    skips_forward = False

    def __init__(self, cfg: DistEncoderCfg, hidden_dim: int, out_dim: int, n_ag_type: int, dtype=torch.float32):
        super().__init__()
        self.branch_type, self.n_cat, self.n_class = cfg.branch_type, cfg.n_cat, out_dim // cfg.n_cat
        self.branches = [str(i) for i in range(n_ag_type)] if cfg.branch_type else [""]
        dims = [hidden_dim] * (cfg.n_layer - 1) + [out_dim]
        for b in self.branches:
            self.add_module(f"logits{b}", MLP(hidden_dim, dims, end_layer_activation=False,
                                              use_layernorm=cfg.mlp_use_layernorm, dtype=dtype))

    def forward(self, x, valid, ag_type) -> MultiCategorical:
        """x [n_sc, n_ag, hidden], valid [n_sc, n_ag], ag_type one-hot [n_sc, n_ag, n_ag_type] (read by the
        type-branched head only) -> logits [n_sc, n_ag, n_cat, n_class]."""
        logits = 0.0
        for i, b in enumerate(self.branches):
            mask = ~(ag_type[..., i] & valid) if self.branch_type else ~valid
            logits = logits + getattr(self, f"logits{b}")(x, mask)
        return MultiCategorical(logits.reshape(tuple(valid.shape) + (self.n_cat, self.n_class)), valid=valid)


def dist_encoder(cfg: DistEncoderCfg, hidden_dim: int, out_dim: int, n_ag_type: int,
                 dtype=torch.float32) -> nn.Module:
    """Latent distribution head: `std_gaus` (`StdGaussian`), `diag_gaus` (`GaussianHead`, unbranched or
    type-branched, log_std a vector or an MLP), `std_cat` (`StdCategorical`) or `cat` (`CategoricalHead`,
    unbranched or type-branched)."""
    if cfg.dist_type == "std_gaus":
        return StdGaussian(out_dim, dtype)
    if cfg.dist_type == "diag_gaus":
        return GaussianHead(cfg, hidden_dim, out_dim, n_ag_type, dtype=dtype)
    if cfg.dist_type == "std_cat":
        return StdCategorical(cfg.n_cat, out_dim, dtype)
    if cfg.dist_type == "cat":
        return CategoricalHead(cfg, hidden_dim, out_dim, n_ag_type, dtype=dtype)
    raise ValueError(f"latent head {cfg.dist_type!r}")


def check_latent_cfg(cfg: LatentEncoderCfg) -> None:
    """The posterior and the prior of one family, with the same factors where categorical: the KL between them
    (`ops/distributions.py::balanced_kl`) and the one noise both draws take are defined only so."""
    post, prior = cfg.latent_post, cfg.latent_prior
    if cfg.latent_dim <= 0:
        return
    if (post.dist_type in CATEGORICAL) != (prior.dist_type in CATEGORICAL):
        raise ValueError(f"latent_post {post.dist_type!r} and latent_prior {prior.dist_type!r}: the posterior and "
                         f"the prior must both be Gaussian or both categorical")
    if post.dist_type in CATEGORICAL and (post.n_cat != prior.n_cat or cfg.latent_dim % post.n_cat):
        raise ValueError(f"categorical latents need one n_cat dividing latent_dim {cfg.latent_dim}: posterior "
                         f"{post.n_cat}, prior {prior.n_cat}")


class LatentEncoder(nn.Module):
    def __init__(self, cfg: LatentEncoderCfg, tl_encoder_cfg: TlEncoderCfg, ag_encoder_cfg: AgEncoderCfg,
                 tf_cfg: TransformerCfg, hidden_dim: int, temp_window_size: int, time_step_gt: int,
                 enc_kw: dict, tl_kw: dict, ag_kw: dict, n_ag_type: int, dtype=torch.float32):
        """enc_kw: what the TL and agent encoders share (pose_rpe, n_tgt_knn, dist_limit, temporal
        encoder settings); tl_kw / ag_kw: what only one of them takes."""
        super().__init__()
        check_latent_cfg(cfg)
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
                tl_tokens: TlTokens, posterior: bool) -> Optional[Union[DiagGaussian, MultiCategorical]]:
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
