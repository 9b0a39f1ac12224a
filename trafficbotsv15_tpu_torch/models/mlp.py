"""Dense layers, MLP, InputEncoder and PolylineEncoder (counterpart of `trafficbotsv15_tpu/models/mlp.py`).

Parameters stay float32; each layer computes in its module's `dtype`
(bfloat16 for the flagship), as flax's `nn.Dense(dtype=...)` does.
Parameter names follow the flax tree (`fc0`, `ln0`, `pointnet0`, ...), so
`utils/jax_import.py` carries JAX weights over by path. Dropout sits where
the JAX modules put it and draws its masks only inside a training
`ops/dropout.py::dropout_scope`.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from trafficbotsv15_tpu_torch.ops.dropout import dropout

_NEG = -1e9


class Dense(nn.Module):
    """y = x @ weight.T + bias in the compute dtype (flax nn.Dense; weight is [out, in])."""

    def __init__(self, in_dim: int, out_dim: int, bias: bool = True, dtype=torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_dim, in_dim))
        self.bias = nn.Parameter(torch.zeros(out_dim)) if bias else None
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        return F.linear(x.to(dt), self.weight.to(dt), None if self.bias is None else self.bias.to(dt))


class LayerNorm(nn.Module):
    """LayerNorm with eps 1e-5, statistics in float32, output in the compute dtype."""

    def __init__(self, dim: int, dtype=torch.float32, eps: float = 1e-5):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.eps = eps
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), (x.shape[-1],), self.weight, self.bias, self.eps)
        return y.to(self.dtype)


class MLP(nn.Module):
    """Dense stack with ReLU (and optional LayerNorm before it) and dropout after each layer;
    invalid rows filled at the end."""

    def __init__(self, in_dim: int, fc_dims: Sequence[int], end_layer_activation: bool = True,
                 use_layernorm: bool = False, dropout_p: float = -1.0, dtype=torch.float32):
        super().__init__()
        self.n = len(fc_dims)
        self.dropout_p = dropout_p
        self.end_layer_activation = end_layer_activation
        self.use_layernorm = use_layernorm
        for i, dim in enumerate(fc_dims):
            self.add_module(f"fc{i}", Dense(in_dim, dim, dtype=dtype))
            if use_layernorm and (i < self.n - 1 or end_layer_activation):
                self.add_module(f"ln{i}", LayerNorm(dim, dtype=dtype))
            in_dim = dim

    def forward(self, x, invalid: Optional[torch.Tensor] = None, fill_invalid: float = 0.0):
        for i in range(self.n):
            x = getattr(self, f"fc{i}")(x)
            if i < self.n - 1 or self.end_layer_activation:
                if self.use_layernorm:
                    x = getattr(self, f"ln{i}")(x)
                x = torch.relu(x)
            x = dropout(x, self.dropout_p)
        if invalid is not None:
            x = torch.where(invalid[..., None], fill_invalid, x)
        return x


class InputEncoder(nn.Module):
    """Fuse attributes with a pose embedding: "cat" (MLP output ++ pe), "add" (MLP output + pe) or "input" (the
    MLP over attr ++ pe). With no pe (pe_dim 0) each is the MLP of the attributes."""

    def __init__(self, in_dim: int, hidden_dim: int, pe_dim: int, n_layer: int, mode: str,
                 mlp_use_layernorm: bool = False, mlp_dropout_p: float = 0.0, dtype=torch.float32):
        """in_dim: the attributes' width (the "input" MLP takes in_dim + pe_dim)."""
        super().__init__()
        if mode == "cat":
            out_dim = hidden_dim - pe_dim
        elif mode == "add":
            out_dim = hidden_dim
            if pe_dim not in (0, hidden_dim):
                raise ValueError(f"add mode needs pe_dim 0 or {hidden_dim}, got {pe_dim}")
        elif mode == "input":
            out_dim = hidden_dim
            in_dim += pe_dim
        else:
            raise ValueError(f"InputEncoder mode {mode!r}")
        self.mode = mode
        self.dtype = dtype
        self.mlp = MLP(in_dim, [out_dim] * n_layer, end_layer_activation=False,
                       use_layernorm=mlp_use_layernorm, dropout_p=mlp_dropout_p, dtype=dtype)

    def forward(self, attr, pe):
        if pe is None:
            return self.mlp(attr)
        if self.mode == "input":
            return self.mlp(torch.cat([attr.to(self.dtype), pe.to(self.dtype)], -1))
        if self.mode == "cat":
            return torch.cat([self.mlp(attr), pe.to(self.dtype)], -1)
        return self.mlp(attr) + pe.to(self.dtype)


class PolylineEncoder(nn.Module):
    """VectorNet PointNet: n_layer x [Dense -> half width, concat the masked max], then pooling."""

    def __init__(self, hidden_dim: int, n_layer: int, pooling_mode: str = "max_valid",
                 mlp_use_layernorm: bool = False, mlp_dropout_p: float = 0.0, dtype=torch.float32):
        super().__init__()
        self.n_layer = n_layer
        self.pooling_mode = pooling_mode
        for i in range(n_layer):
            self.add_module(f"pointnet{i}", MLP(hidden_dim, [hidden_dim // 2],
                                                use_layernorm=mlp_use_layernorm, dropout_p=mlp_dropout_p,
                                                dtype=dtype))

    def forward(self, x, invalid):
        """x [n_sc, n, n_node, hidden], invalid [n_sc, n, n_node] -> [n_sc, n, hidden]."""
        from trafficbotsv15_tpu_torch.ops.pooling import seq_pooling

        for i in range(self.n_layer):
            x = getattr(self, f"pointnet{i}")(x, invalid, fill_invalid=_NEG)
            pooled = x.amax(dim=2, keepdim=True)
            x = torch.cat([x, pooled.expand_as(x)], -1)
            x = torch.where(invalid[..., None], 0.0, x)
        return seq_pooling(x, invalid, self.pooling_mode)
