"""Action head and navi/latent fusion (counterpart of `trafficbotsv15_tpu/models/heads.py`)."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from trafficbotsv15_tpu_torch.config import ActionHeadCfg, AddNaviLatentCfg
from trafficbotsv15_tpu_torch.models.mlp import MLP
from trafficbotsv15_tpu_torch.ops.distributions import DiagGaussian


class ActionHead(nn.Module):
    """MLP mean + learned log_std, branched per agent type (`mean{i}`, `log_std{i}`)."""

    def __init__(self, cfg: ActionHeadCfg, hidden_dim: int, action_dim: int, n_ag_type: int = 3,
                 dtype=torch.float32):
        super().__init__()
        if not cfg.branch_type or cfg.log_std is None:
            raise NotImplementedError("only the type-branched head with a learned log_std vector is on the path")
        self.n_ag_type = n_ag_type
        dims = [hidden_dim] * (cfg.n_layer - 1) + [action_dim]
        for i in range(n_ag_type):
            self.add_module(f"mean{i}", MLP(hidden_dim, dims, end_layer_activation=False,
                                            use_layernorm=cfg.mlp_use_layernorm, dtype=dtype))
            self.register_parameter(f"log_std{i}", nn.Parameter(torch.full((action_dim,), float(cfg.log_std))))

    def forward(self, x, valid, ag_type) -> DiagGaussian:
        """x [n_sc, n_ag, hidden], valid [n_sc, n_ag], ag_type one-hot [n_sc, n_ag, 3]."""
        mean = log_std = 0.0
        for i in range(self.n_ag_type):
            mask = ~(ag_type[..., i] & valid)
            mean = mean + getattr(self, f"mean{i}")(x, mask)
            log_std = log_std + torch.where(mask[..., None], 0.0, getattr(self, f"log_std{i}"))
        return DiagGaussian(mean.float(), torch.exp(log_std.float()), valid=valid)


class AddNaviLatent(nn.Module):
    """Fuse a conditioning vector (navi feature or latent) into the agent feature: cat mode + residual."""

    def __init__(self, cfg: AddNaviLatentCfg, hidden_dim: int, z_dim: int, dummy: bool = False,
                 dtype=torch.float32):
        super().__init__()
        self.dummy, self.res_add, self.dtype = dummy, cfg.res_add, dtype
        if dummy:
            return
        if cfg.mode != "cat":
            raise NotImplementedError(f"AddNaviLatent mode {cfg.mode!r} is not on the joint-future path")
        dims = [hidden_dim] * cfg.n_layer
        self.mlp_in = MLP(z_dim, dims, use_layernorm=cfg.mlp_use_layernorm, dropout_p=cfg.mlp_dropout_p, dtype=dtype)
        self.mlp = MLP(2 * hidden_dim, dims, use_layernorm=cfg.mlp_use_layernorm, dropout_p=cfg.mlp_dropout_p,
                       dtype=dtype)

    def forward(self, x, z, z_valid: Optional[torch.Tensor] = None):
        if self.dummy or z is None:
            return x
        if z_valid is None:
            z_valid = torch.ones(x.shape[:-1], dtype=torch.bool, device=x.device)
        z_invalid = ~z_valid
        z = self.mlp_in(z.to(self.dtype))
        h = self.mlp(torch.cat([x, torch.where(z_invalid[..., None], 0.0, z)], -1), z_invalid)
        if self.res_add:
            return h + x
        return h + torch.where(z_valid[..., None], 0.0, x)
