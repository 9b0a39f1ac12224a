"""Multi-agent stacked GRU (counterpart of `trafficbotsv15_tpu/models/gru.py`).

Each layer is flax's `nn.GRUCell`, which is not `torch.nn.GRUCell`: its
input projections `ir`, `iz`, `in` carry biases, its hidden projections
`hr`, `hz` none and `hn` one, and the candidate keeps `b_hn` inside the
reset gate:

    r = sigmoid(W_ir x + b_ir + W_hr h)
    z = sigmoid(W_iz x + b_iz + W_hz h)
    n = tanh(W_in x + b_in + r * (W_hn h + b_hn))
    h' = (1 - z) * n + z * h

The sub-layers are named after the flax paths (`gru{i}.ir`, ..., `gru{i}.hn`;
`in` is a Python keyword, so it is registered with `add_module`), so
`utils/jax_import.py` carries a JAX tree unchanged. The three input and the
three hidden projections each run as one matmul over the concatenated
weights. Dropout sits between layers on the output (not on the hidden),
drawn inside a training `ops/dropout.py::dropout_scope`. An invalid
(scene, agent[, step]) entry zeroes both the new hidden and the output, so
padded agents carry no state.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from trafficbotsv15_tpu_torch.models.mlp import Dense
from trafficbotsv15_tpu_torch.ops.dropout import dropout

_GATES = ("r", "z", "n")


class GRUCell(nn.Module):
    """flax `nn.GRUCell` in the compute dtype; parameters float32."""

    def __init__(self, in_dim: int, hidden_dim: int, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        for g in _GATES:
            self.add_module(f"i{g}", Dense(in_dim, hidden_dim, bias=True, dtype=dtype))
            self.add_module(f"h{g}", Dense(hidden_dim, hidden_dim, bias=g == "n", dtype=dtype))

    def forward(self, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """h [..., hidden], x [..., in] -> the new hidden (the dtype promotion of h's and the compute dtype's)."""
        dt = self.dtype
        lin = [self._modules[f"i{g}"] for g in _GATES]
        hid = [self._modules[f"h{g}"] for g in _GATES]
        gx = F.linear(x.to(dt), torch.cat([m.weight for m in lin]).to(dt), torch.cat([m.bias for m in lin]).to(dt))
        gh = F.linear(h.to(dt), torch.cat([m.weight for m in hid]).to(dt))
        xr, xz, xn = gx.chunk(3, -1)
        hr, hz, hn = gh.chunk(3, -1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * (hn + self._modules["hn"].bias.to(dt)))
        return (1.0 - z) * n + z * h


class MultiAgentGRU(nn.Module):
    """`n_layer` stacked GRU cells (`gru0`, `gru1`, ...) over agents, in step or sequence mode."""

    def __init__(self, in_dim: int, hidden_dim: int, n_layer: int, dropout_p: float = 0.0, dtype=torch.float32):
        super().__init__()
        self.hidden_dim, self.n_layer, self.dropout_p, self.dtype = hidden_dim, n_layer, dropout_p, dtype
        for i in range(n_layer):
            self.add_module(f"gru{i}", GRUCell(in_dim if i == 0 else hidden_dim, hidden_dim, dtype=dtype))

    def init_hidden(self, n_sc: int, n_ag: int, device) -> torch.Tensor:
        return torch.zeros((self.n_layer, n_sc, n_ag, self.hidden_dim), dtype=self.dtype, device=device)

    def _cell_stack(self, h: torch.Tensor, x: torch.Tensor, invalid: torch.Tensor):
        """One time step through the layers: h [n_layer, n_sc, n_ag, d], x [n_sc, n_ag, in],
        invalid [n_sc, n_ag] -> (out [n_sc, n_ag, d], new h)."""
        new_h, out = [], x
        for i in range(self.n_layer):
            out = self._modules[f"gru{i}"](h[i], out)
            new_h.append(out)
            if i < self.n_layer - 1:
                out = dropout(out, self.dropout_p)
        new_h = torch.where(invalid[None, :, :, None], 0.0, torch.stack(new_h))
        return torch.where(invalid[..., None], 0.0, out), new_h

    def forward(self, x: torch.Tensor, invalid: torch.Tensor,
                h: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """Step mode: x [n_sc, n_ag, in], invalid [n_sc, n_ag] -> (out [n_sc, n_ag, d], h [n_layer, n_sc, n_ag, d]).
        Sequence mode: x [n_sc, n_ag, n_step, in], invalid [n_sc, n_ag, n_step] -> (out [.., n_step, d], None).
        h None starts from zeros in the compute dtype."""
        if h is None:
            h = self.init_hidden(invalid.shape[0], invalid.shape[1], x.device)
        if invalid.ndim == 2:
            return self._cell_stack(h, x, invalid)
        outs = []
        for t in range(invalid.shape[2]):
            out, h = self._cell_stack(h, x[:, :, t], invalid[:, :, t])
            outs.append(out)
        return torch.stack(outs, 2), None
