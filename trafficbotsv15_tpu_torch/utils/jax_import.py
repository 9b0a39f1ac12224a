"""Carry the JAX package's weights into the port, without importing JAX.

`params_from_jax(tree)` takes the flax param tree of
`trafficbotsv15_tpu.models.traffic_bots.TrafficBots` as nested dicts of
numpy arrays and returns a state_dict for the port's `TrafficBots`. The
port names its parameters after the flax paths, so the carry is one walk
plus these layout rules:
  - `Dense/kernel [in, out]` -> `weight [out, in]` (transposed);
  - `LayerNorm/scale` -> `weight`;
  - raw params (`kv_w`, `rpe_proj_w` [in, out], `kv_b`, `rpe_proj_b`,
    `norm_tgt_scale`, `norm_tgt_bias`, `log_std{i}`) keep name and layout.
Every flax leaf maps to one port parameter, the posterior latent encoders'
included; `load_jax_params` raises on a leaf with no parameter and on a
parameter with no leaf.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def _walk(tree: Mapping, prefix: str = ""):
    for name, val in tree.items():
        path = f"{prefix}{name}"
        if isinstance(val, Mapping):
            yield from _walk(val, path + ".")
        else:
            yield path, np.asarray(val)


def params_from_jax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """The state_dict of the port's model: one entry per flax leaf."""
    state: Dict[str, torch.Tensor] = {}
    for path, arr in _walk(tree):
        head, _, leaf = path.rpartition(".")
        if leaf == "kernel":
            key, arr = f"{head}.weight", arr.T
        elif leaf == "scale":
            key = f"{head}.weight"
        else:
            key = path
        state[key] = torch.from_numpy(np.ascontiguousarray(arr, dtype=np.float32))
    return state


def load_jax_params(model: torch.nn.Module, tree: Mapping) -> None:
    """Load a flax tree into `model`: every flax leaf fills one port parameter and every port parameter is filled."""
    missing, unexpected = model.load_state_dict(params_from_jax(tree), strict=False)
    if missing or unexpected:
        raise KeyError(f"param carry mismatch: missing {missing[:8]}..., unexpected {unexpected[:8]}...")
