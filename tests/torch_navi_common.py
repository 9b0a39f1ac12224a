"""Shared set-up of the navigation-variant parity tests (tests/test_torch_navi*.py): the configs, the JAX cmd draw as
its one-hot, and the JAX package's `joint_future_pred` and `reactive_replay` run once under `jax.jit` with the
arguments of their rollout captured, beside the port's.

The configs are `tiny_config()` with `navi_mode` goal, cmd, dummy or dest, `AddNaviLatent` in cat, add or mul mode,
and optionally `pred_navi_after_reached`; with use_pallas at dense_knn_max 4, so that the map and agent
self-attentions take B4's wrapper and every KNN cross-attention, the navi predictor's `tf_ag2mp` among them, B2's
(on the CPU both packages take their plain versions). The weights are random with a gain of 0.5, as in
`tests/test_torch_slice.py`; the tolerances are `tests/torch_rnn_common.py`'s: 1e-3 m / rad / m/s on poses, motion
and actions, 1e-4 on log probabilities; validity, forcing, TL states and rule flags identical.

JAX's cmd draw is the class index, which its cmd navi encoder takes as an n_ag-wide vector (it fails on the shape,
`models/navigation.py::navi_of_draw` in the port); `jax_cmd_one_hot` makes the JAX draw the one-hot that the port
hands its encoder, and the log-prob read the index back, for the length of the block.

Re-prediction samples inside the rollout from JAX keys; the port gets JAX's noise per step
(`test_torch_helpers.jax_navi_noise`) as `navi_noise`.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_helpers import jax_model_params, jax_navi_noise, jax_sort_knn, port_cfg, port_model, repredicts, \
    to_jnp
from trafficbotsv15_tpu.config import tiny_config
from trafficbotsv15_tpu.data.synthetic import make_batch
from trafficbotsv15_tpu.ops.distributions import DestCategorical as JaxDestCategorical
from trafficbotsv15_tpu.sim import rollout as jax_rollout_lib
from trafficbotsv15_tpu.train import evaluation as jax_eval
from trafficbotsv15_tpu.train.losses import training_loss as jax_training_loss

K = 2
SAMPLES = ("ag_latent", "ag_latent_valid", "ag_navi", "ag_navi_valid", "ag_navi_log_prob")
# the batch seeds of the re-prediction tests, by rollout and mode: where the seed-0 gain-0.5 weights reach a goal
# or a destination (destinations are reached rarely in 20 steps: once at each of these)
REPREDICT_BATCH_SEED = {"replay": {"goal": 0, "dest": 8}, "futures": {"goal": 0, "dest": 2}}


def navi_cfg(navi_mode: str, use_pallas: bool = False, repredict: bool = False, add_mode: str = "cat", **kw):
    """tiny_config in a navigation mode (K0 futures deterministic); see the module docstring."""
    cfg = dataclasses.replace(tiny_config(), joint_future_pred_deterministic_k0=True, pred_navi_after_reached=repredict,
                              **kw)
    m = cfg.model
    tf = dataclasses.replace(m.tf_cfg, use_pallas=use_pallas, dense_knn_max=4 if use_pallas else m.tf_cfg.dense_knn_max)
    return dataclasses.replace(cfg, model=dataclasses.replace(
        m, navi_mode=navi_mode, tf_cfg=tf, add_navi_latent=dataclasses.replace(m.add_navi_latent, mode=add_mode)))


@contextlib.contextmanager
def jax_cmd_one_hot(active: bool = True):
    """Within the block the JAX `DestCategorical` draws a command as its one-hot (bool, `agent/cmd`'s form) and its
    log-prob takes one; a no-op unless active."""
    if not active:
        yield
        return
    real_sample, real_log_prob = JaxDestCategorical.sample, JaxDestCategorical.log_prob

    def sample(self, key, deterministic=False):
        return jax.nn.one_hot(real_sample(self, key, deterministic), self.logits.shape[-1], dtype=bool)

    def log_prob(self, x):
        return real_log_prob(self, jnp.argmax(x, -1) if x.ndim == self.logits.ndim else x)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JaxDestCategorical, "sample", sample)
        mp.setattr(JaxDestCategorical, "log_prob", log_prob)
        yield


def _captured_call(fn):
    """fn(params, batch) with JAX's rollout arguments (SAMPLES) and buffer captured: -> (fn's result, captured)."""
    real = jax_rollout_lib.rollout

    def traced(params, batch):
        captured = {}

        def capture(*args, **kwargs):
            buf = real(*args, **kwargs)
            captured.update({k: kwargs[k] for k in SAMPLES}, buffer=buf)
            return buf

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax_rollout_lib, "rollout", capture)
            return fn(params, batch), captured

    return traced


def _batch(cfg, seed: int):
    return make_batch(cfg.data, n_sc=2, seed=seed)


def _noise(cfg, key, n_sc: int, batch):
    """JAX's per-step re-prediction noise of a rollout keyed `key` over n_sc rows, or None."""
    if not repredicts(cfg):
        return None
    return jax_navi_noise(cfg, key, n_sc, cfg.data.n_ag, batch["map/valid"].shape[1])


def run_joint_future(cfg, check_level: int = 1, batch_seed: int = 1):
    """The JAX and the port's joint_future_pred on one batch and one set of weights; the port's K-future rollout
    again with JAX's latent and navi draws (and with re-prediction its per-step navi noise) injected."""
    jmodel, tree = jax_model_params(cfg, seed=0, gain=0.5)
    batch = _batch(cfg, batch_seed)
    key = jax.random.PRNGKey(0)

    def jfn(params, b):
        return jax_eval.joint_future_pred(cfg, jmodel, params, b, key, n_joint_future=K, check_level=check_level)[1]

    cmd = cfg.model.navi_mode == "cmd"
    with jax_sort_knn(), jax_cmd_one_hot(cmd):
        jbuf, captured = jax.jit(_captured_call(jfn))(to_jnp(tree), {k: jnp.asarray(v) for k, v in batch.items()})
    pmodel, pcfg = port_model(cfg, tree), port_cfg(cfg)
    from trafficbotsv15_tpu_torch.train import evaluation as port_eval

    _, pbuf = port_eval.joint_future_pred(pcfg, pmodel, batch, generator=torch.Generator().manual_seed(0),
                                          n_joint_future=K, check_level=check_level, device="cpu")
    batch_t = port_eval.batch_to_device(batch, torch.device("cpu"))
    scene = port_eval.prepare_joint_future(pcfg, pmodel, batch_t)
    samples = {k: None if captured[k] is None else torch.from_numpy(np.array(captured[k])) for k in SAMPLES}
    k_roll = jax.random.split(key, 4)[3]
    injected = port_eval.rollout_joint_futures(pcfg, pmodel, batch_t, scene, K, check_level=check_level,
                                               navi_noise=_noise(cfg, k_roll, 2 * K, batch), **samples)
    return dict(cfg=pcfg, model=pmodel, batch=batch, jbuf=jbuf, pbuf=pbuf, jroll=captured["buffer"],
                injected=injected, samples=samples)


def run_reactive_replay(cfg, check_level: int = 1, batch_seed: int = 1):
    """The JAX and the port's reactive_replay on one batch and one set of weights (re-prediction with JAX's noise),
    with the validation's loss terms of each (`training_loss(prefix="reactive_replay")`): -> (JAX outputs, port
    outputs), each dict(buffer, navi, post_mean, loss)."""
    jmodel, tree = jax_model_params(cfg, seed=0, gain=0.5)
    batch = _batch(cfg, batch_seed)
    key = jax.random.PRNGKey(0)

    def jfn(params, b):
        pp, buf, navi, post, prior = jax_eval.reactive_replay(cfg, jmodel, params, b, key, check_level=check_level)
        _, loss = jax_training_loss(cfg.training_metrics, buf, pp.ag_role, navi, pp.gt_navi, post, prior,
                                    prefix="reactive_replay")
        return dict(buffer=buf, navi=_navi_params(navi), post_mean=post.mean, loss=loss)

    with jax_sort_knn():
        want = jax.jit(jfn)(to_jnp(tree), {k: jnp.asarray(v) for k, v in batch.items()})
    from trafficbotsv15_tpu_torch.train import evaluation as port_eval
    from trafficbotsv15_tpu_torch.train.losses import training_loss

    pcfg = port_cfg(cfg)
    k_roll = jax.random.split(key, 3)[1]
    pp, buf, navi, post, prior = port_eval.reactive_replay(pcfg, port_model(cfg, tree), batch,
                                                           check_level=check_level, device="cpu",
                                                           navi_noise=_noise(cfg, k_roll, 2, batch))
    _, loss = training_loss(pcfg.training_metrics, buf, pp.ag_role, navi, pp.gt_navi, post, prior,
                            prefix="reactive_replay")
    return want, dict(buffer=buf, navi=_navi_params(navi), post_mean=post.mean, loss=loss)


def _navi_params(dist):
    """A navi distribution's parameters: {} (dummy), {"logits"} (dest, cmd) or {"mean", "std"} (goal)."""
    if dist is None:
        return {}
    if hasattr(dist, "logits"):
        return {"logits": dist.logits}
    return {"mean": dist.mean, "std": dist.std}
