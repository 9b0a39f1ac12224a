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
Leaves under modules outside the slice (the posterior latent encoders) are
returned as skipped, never dropped silently.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Tuple

import numpy as np
import torch

# flax subtrees the slice never reads: training-only posterior encoders
SKIPPED_PREFIXES = ("latent_encoder.",)


def _walk(tree: Mapping, prefix: str = ""):
    for name, val in tree.items():
        path = f"{prefix}{name}"
        if isinstance(val, Mapping):
            yield from _walk(val, path + ".")
        else:
            yield path, np.asarray(val)


def params_from_jax(tree: Mapping) -> Tuple[Dict[str, torch.Tensor], List[str]]:
    """(state_dict, skipped flax paths). Every other flax leaf maps to one port parameter."""
    state: Dict[str, torch.Tensor] = {}
    skipped: List[str] = []
    for path, arr in _walk(tree):
        if path.startswith(SKIPPED_PREFIXES):
            skipped.append(path)
            continue
        head, _, leaf = path.rpartition(".")
        if leaf == "kernel":
            key, arr = f"{head}.weight", arr.T
        elif leaf == "scale":
            key = f"{head}.weight"
        else:
            key = path
        state[key] = torch.from_numpy(np.ascontiguousarray(arr, dtype=np.float32))
    return state, skipped


def load_jax_params(model: torch.nn.Module, tree: Mapping) -> List[str]:
    """Load a flax tree into `model`; every port parameter must be filled. Returns the skipped paths."""
    state, skipped = params_from_jax(tree)
    missing, unexpected = model.load_state_dict(state, strict=False)
    if missing or unexpected:
        raise KeyError(f"param carry mismatch: missing {missing[:8]}..., unexpected {unexpected[:8]}...")
    return skipped
