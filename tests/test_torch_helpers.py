"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py).

Weights are random, made from a seed with numpy in the shapes of the JAX
package's param tree (`jax.eval_shape` of its `init_params`, no compute),
and handed to both packages: JAX applies the tree, the port loads it through
`utils/jax_import.py`. Both run on the CPU.
"""

from __future__ import annotations

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import torch

from trafficbotsv15_tpu.ops import flags as jax_flags
from trafficbotsv15_tpu.ops.flags import OpsCfg as JaxOpsCfg

TORCH_THREADS = 2  # tier-1 runs several pytest workers side by side


def set_threads() -> None:
    torch.set_num_threads(TORCH_THREADS)


@contextlib.contextmanager
def jax_sort_knn():
    """JAX's KNN on the stable sort (the port's only selection), restored after."""
    prev = jax_flags._configured
    jax_flags.configure(JaxOpsCfg(knn_impl="sort"))
    try:
        yield
    finally:
        jax_flags.configure(prev)


def random_tree(shapes, seed: int, gain: float = 1.0):
    """Numpy params in the shapes of a flax tree of ShapeDtypeStructs; matrices
    are normal with std gain / sqrt(fan_in)."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        shape = tuple(s.shape)
        if len(shape) == 2:  # Dense kernel, kv_w, rpe_proj_w: [in, out]
            return (gain * rng.standard_normal(shape) / np.sqrt(shape[0])).astype(np.float32)
        if name in ("scale", "norm_tgt_scale"):
            return (1.0 + 0.1 * rng.standard_normal(shape)).astype(np.float32)
        if name.startswith("log_std"):
            return (-2.0 + 0.1 * rng.standard_normal(shape)).astype(np.float32)
        return (0.1 * rng.standard_normal(shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def jax_model_params(cfg, seed: int = 0, gain: float = 1.0):
    """(flax TrafficBots, numpy param tree) for cfg, from param shapes only."""
    from trafficbotsv15_tpu.data.synthetic import make_batch
    from trafficbotsv15_tpu.train.pipeline import build_model, init_params

    model = build_model(cfg)
    batch = {k: jnp.asarray(v) for k, v in make_batch(cfg.data, n_sc=1, seed=0).items()}
    shapes = jax.eval_shape(lambda: init_params(cfg, model, batch, jax.random.PRNGKey(0)))
    return model, random_tree(shapes, seed, gain)


def to_jnp(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def port_model(cfg, tree):
    """The port's TrafficBots on the CPU with the tree's weights; returns (model, skipped paths)."""
    from trafficbotsv15_tpu_torch.train.pipeline import build_model
    from trafficbotsv15_tpu_torch.utils.jax_import import load_jax_params

    model = build_model(port_cfg(cfg), device="cpu")
    skipped = load_jax_params(model, tree)
    return model, skipped


def port_cfg(jax_cfg):
    """The port's ExperimentCfg equal field by field to a JAX ExperimentCfg."""
    import dataclasses

    from trafficbotsv15_tpu_torch import config as pc

    def build(cls, d):
        default = cls()
        return cls(**{k: build(type(getattr(default, k)), v) if isinstance(v, dict) else v for k, v in d.items()})

    return build(pc.ExperimentCfg, dataclasses.asdict(jax_cfg))


def t2n(x):
    return x.detach().cpu().float().numpy() if x.dtype != torch.bool else x.detach().cpu().numpy()
