"""CVAE latent: the prior that the joint-future path samples (counterpart of
`trafficbotsv15_tpu/models/latent_encoder.py`).

The flagship prior is `std_gaus`, whose `DistEncoder.skip_forward` runs no
network: a standard normal per valid agent. The posterior encoders are
training-only and come with the training slice; a learned prior raises too.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from trafficbotsv15_tpu_torch.config import DistEncoderCfg, LatentEncoderCfg
from trafficbotsv15_tpu_torch.ops.distributions import DiagGaussian


class DistEncoder(nn.Module):
    """Latent distribution head; only the network-free `std_gaus` head is ported."""

    def __init__(self, cfg: DistEncoderCfg, out_dim: int, dtype=torch.float32):
        super().__init__()
        if not self.skips_forward(cfg):
            raise NotImplementedError(
                f"dist_type {cfg.dist_type!r} runs a network; learned latent heads come with the training slice")
        self.out_dim, self.dtype = out_dim, dtype

    @staticmethod
    def skips_forward(cfg: DistEncoderCfg) -> bool:
        return cfg.dist_type == "std_gaus"

    def forward(self, valid: torch.Tensor) -> DiagGaussian:
        shape = tuple(valid.shape) + (self.out_dim,)
        mean = torch.zeros(shape, dtype=self.dtype, device=valid.device)
        return DiagGaussian(mean, torch.ones_like(mean), valid=valid)


class LatentEncoder(nn.Module):
    def __init__(self, cfg: LatentEncoderCfg, dtype=torch.float32):
        super().__init__()
        self.dummy = cfg.latent_dim <= 0
        if not self.dummy:
            self.dist_prior = DistEncoder(cfg.latent_prior, cfg.latent_dim, dtype=dtype)

    def forward(self, ag_valid: torch.Tensor, posterior: bool) -> Optional[DiagGaussian]:
        """ag_valid [n_sc, n_ag, n_step] -> prior over [n_sc, n_ag, latent_dim] (None when disabled)."""
        if posterior:
            raise NotImplementedError("the posterior latent encoder comes with the training slice")
        if self.dummy:
            return None
        return self.dist_prior(ag_valid.any(-1))
