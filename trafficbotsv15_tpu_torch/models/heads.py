"""Gaussian head and navi/latent fusion (counterpart of `trafficbotsv15_tpu/models/heads.py`)."""

from __future__ import annotations

from typing import Optional, Union

import torch
from torch import nn

from trafficbotsv15_tpu_torch.config import ActionHeadCfg, AddNaviLatentCfg, DistEncoderCfg
from trafficbotsv15_tpu_torch.models.mlp import MLP
from trafficbotsv15_tpu_torch.ops.distributions import DiagGaussian


class GaussianHead(nn.Module):
    """Diagonal Gaussian head, the action head and the `diag_gaus` latent head: an MLP mean and a learned
    log_std vector or an MLP log_std, one of each per agent type with `branch_type` (`mean{i}`,
    `log_std{i}`), else one (`mean`, `log_std`). cfg is an `ActionHeadCfg` or a `DistEncoderCfg`."""

    skips_forward = False

    def __init__(self, cfg: Union[ActionHeadCfg, DistEncoderCfg], hidden_dim: int, out_dim: int, n_ag_type: int,
                 dtype=torch.float32, fp32_out: bool = False):
        """fp32_out: cast mean and log_std to float32 (the action head, which feeds the dynamics and the
        log-prob losses)."""
        super().__init__()
        self.branch_type, self.fp32_out = cfg.branch_type, fp32_out
        self.branches = [str(i) for i in range(n_ag_type)] if cfg.branch_type else [""]
        dims = [hidden_dim] * (cfg.n_layer - 1) + [out_dim]
        mlp = lambda: MLP(hidden_dim, dims, end_layer_activation=False, use_layernorm=cfg.mlp_use_layernorm,
                          dtype=dtype)
        for b in self.branches:
            self.add_module(f"mean{b}", mlp())
            if cfg.log_std is None:
                self.add_module(f"log_std{b}", mlp())
            else:
                self.register_parameter(f"log_std{b}", nn.Parameter(torch.full((out_dim,), float(cfg.log_std))))

    def forward(self, x, valid, ag_type) -> DiagGaussian:
        """x [n_sc, n_ag, hidden], valid [n_sc, n_ag], ag_type one-hot [n_sc, n_ag, n_ag_type] (read by the
        type-branched head only) -> [n_sc, n_ag, out_dim]."""
        mean = log_std = 0.0
        for i, b in enumerate(self.branches):
            mask = ~(ag_type[..., i] & valid) if self.branch_type else ~valid
            mean = mean + getattr(self, f"mean{b}")(x, mask)
            head = getattr(self, f"log_std{b}")
            if isinstance(head, nn.Module):
                log_std = log_std + head(x, mask)
            elif self.branch_type:
                log_std = log_std + torch.where(mask[..., None], 0.0, head)
            else:
                log_std = head.expand(mean.shape)
        if self.fp32_out:
            mean, log_std = mean.float(), log_std.float()
        return DiagGaussian(mean, torch.exp(log_std), valid=valid)


class AddNaviLatent(nn.Module):
    """Fuse a conditioning vector (navi feature or latent) into the agent feature: the vector through `mlp_in`,
    then added to the feature (`add`), multiplied into it (`mul`) or concatenated with it (`cat`), through `mlp`,
    plus a residual. An invalid vector adds 0 (multiplies by 1; is 0 in the concatenation)."""

    def __init__(self, cfg: AddNaviLatentCfg, hidden_dim: int, z_dim: int, dummy: bool = False,
                 dtype=torch.float32):
        super().__init__()
        self.dummy, self.mode, self.res_add, self.dtype = dummy, cfg.mode, cfg.res_add, dtype
        if dummy:
            return
        if cfg.mode not in ("add", "mul", "cat"):
            raise NotImplementedError(f"AddNaviLatent mode {cfg.mode!r}")
        dims = [hidden_dim] * cfg.n_layer
        self.mlp_in = MLP(z_dim, dims, use_layernorm=cfg.mlp_use_layernorm, dropout_p=cfg.mlp_dropout_p, dtype=dtype)
        self.mlp = MLP(2 * hidden_dim if cfg.mode == "cat" else hidden_dim, dims,
                       use_layernorm=cfg.mlp_use_layernorm, dropout_p=cfg.mlp_dropout_p, dtype=dtype)

    def forward(self, x, z, z_valid: Optional[torch.Tensor] = None):
        if self.dummy or z is None:
            return x
        if z_valid is None:
            z_valid = torch.ones(x.shape[:-1], dtype=torch.bool, device=x.device)
        z_invalid = ~z_valid
        z = self.mlp_in(z.to(self.dtype))
        if self.mode == "add":
            h = x + torch.where(z_invalid[..., None], 0.0, z)
        elif self.mode == "mul":
            h = x * torch.where(z_invalid[..., None], 1.0, z)
        else:
            h = torch.cat([x, torch.where(z_invalid[..., None], 0.0, z)], -1)
        h = self.mlp(h, z_invalid)
        if self.res_add:
            return h + x
        return h + torch.where(z_valid[..., None], 0.0, x)
