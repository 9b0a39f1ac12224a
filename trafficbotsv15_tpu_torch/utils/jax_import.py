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

The migration path for a JAX training run's checkpoint (Orbax, which the port
does not read): on a machine with the JAX package, restore it to numpy with
that package's `train/checkpoint.py::CheckpointManager(dir).restore("last")`,
build the port's model from `config.py::config_from_dict(<dir>/last.json's
"config">)`, `load_jax_params(model, state["params"])`, and save
`{"model": model.state_dict()}` with the port's
`train/checkpoint.py::CheckpointManager` (`save_last` for `action=validate`,
`save_best` for `action=test`); `python -m trafficbotsv15_tpu_torch.run
action=validate ckpt_dir=...` then runs from it (`tests/test_torch_checkpoint.py::test_jax_checkpoint_migrates_into_the_port`).
The optimizer state does not come across: a fit from it starts Adam afresh.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

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


def jax_leaf(name: str, ndim: int) -> Tuple[str, bool]:
    """(the flax path of the port parameter `name` of `ndim` axes, whether the port's tensor is the flax leaf
    transposed): `params_from_jax`'s map, inverted. A 2-D `weight` is a Dense kernel, a 1-D one a LayerNorm scale."""
    head, _, leaf = name.rpartition(".")
    if leaf == "weight":
        return (f"{head}.kernel", True) if ndim == 2 else (f"{head}.scale", False)
    return name, False


def load_jax_params(model: torch.nn.Module, tree: Mapping) -> None:
    """Load a flax tree into `model`: every flax leaf fills one port parameter and every port parameter is filled."""
    missing, unexpected = model.load_state_dict(params_from_jax(tree), strict=False)
    if missing or unexpected:
        raise KeyError(f"param carry mismatch: missing {missing[:8]}..., unexpected {unexpected[:8]}...")
