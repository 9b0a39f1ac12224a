"""Shared set-up of the RNN-family parity tests (tests/test_torch_rnn*.py): the configs, and the JAX
package's `joint_future_pred` and `reactive_replay` run once under `jax.jit` (one compile, where an eager
call compiles every op of the scene encoders on its own), with the arguments of its rollout captured.

The weights are random with a gain of 0.5 on every matrix, as in `tests/test_torch_slice.py` (whose
`test_damped_random_policy_is_not_chaotic` says why); the tolerances are that file's: 1e-3 m / rad / m/s
on poses, motion and actions, 1e-4 on log probabilities; validity, forcing, TL states and rule flags
identical.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_helpers import jax_model_params, jax_sort_knn, port_cfg, port_model, t2n, to_jnp
from trafficbotsv15_tpu.config import tiny_config
from trafficbotsv15_tpu.data.synthetic import make_batch
from trafficbotsv15_tpu.sim import rollout as jax_rollout_lib
from trafficbotsv15_tpu.train import evaluation as jax_eval

K = 2
POSE_ATOL, LOGP_ATOL = 1e-3, 1e-4
SAMPLES = ("ag_latent", "ag_latent_valid", "ag_navi", "ag_navi_valid", "ag_navi_log_prob")
K0_FIELDS = [("pred_pose", POSE_ATOL), ("pred_action", POSE_ATOL), ("action_log_prob", LOGP_ATOL),
             ("pred_valid", 0), ("tl_state", 0), ("tl_state_nll", LOGP_ATOL), ("log_prob", LOGP_ATOL)]
ROW_FIELDS = [("pred_pose", POSE_ATOL), ("pred_motion", POSE_ATOL), ("pred_action", POSE_ATOL),
              ("action_log_prob", LOGP_ATOL), ("tl_state_nll", LOGP_ATOL), ("navi_log_prob", LOGP_ATOL),
              ("pred_valid", 0), ("mask_teacher_forcing", 0), ("tl_state", 0), ("tl_state_nll_invalid", 0),
              ("navi_log_prob_valid", 0)]


def rnn_cfg(use_pallas: bool = False, **kw):
    """tiny_config in the TrafficBots RNN family (temp_window_size=0), K0 futures deterministic; with use_pallas
    at dense_knn_max 4, below the tiny map's 32 polylines and its 8 agents, so that the map and the agent
    self-attentions take B4's wrapper and the agent cross-attentions B2's."""
    cfg = dataclasses.replace(tiny_config(), joint_future_pred_deterministic_k0=True, **kw)
    tf = dataclasses.replace(cfg.model.tf_cfg, use_pallas=use_pallas,
                             dense_knn_max=4 if use_pallas else cfg.model.tf_cfg.dense_knn_max)
    return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, temp_window_size=0, tf_cfg=tf))


def rnn_train_cfg(use_pallas: bool = False):
    """rnn_cfg with every dropout rate at 0, the GRU TL state predictor's `rnn_dropout_p` too: JAX keys and torch
    generators never draw the same masks."""
    from test_torch_helpers import no_dropout

    cfg = no_dropout(rnn_cfg(use_pallas=use_pallas))
    m = cfg.model
    return dataclasses.replace(cfg, model=dataclasses.replace(
        m, tl_state_predictor=dataclasses.replace(m.tl_state_predictor, rnn_dropout_p=0.0)))


def _captured_call(fn):
    """fn(params, batch) under jit with JAX's rollout arguments (SAMPLES, tl_forcing) and result captured:
    -> (fn's result, captured dict of numpy arrays)."""
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


def run_joint_future(cfg, check_level: int):
    """The JAX and the port's joint_future_pred on one batch and one set of weights."""
    jmodel, tree = jax_model_params(cfg, seed=0, gain=0.5)
    batch = make_batch(cfg.data, n_sc=2, seed=1)

    def jfn(params, b):
        return jax_eval.joint_future_pred(cfg, jmodel, params, b, jax.random.PRNGKey(0), n_joint_future=K,
                                          check_level=check_level)[1]

    with jax_sort_knn():
        jbuf, captured = jax.jit(_captured_call(jfn))(to_jnp(tree), {k: jnp.asarray(v) for k, v in batch.items()})
    pmodel, pcfg = port_model(cfg, tree), port_cfg(cfg)
    from trafficbotsv15_tpu_torch.train import evaluation as port_eval

    _, pbuf = port_eval.joint_future_pred(pcfg, pmodel, batch, generator=torch.Generator().manual_seed(0),
                                          n_joint_future=K, check_level=check_level, device="cpu")
    batch_t = port_eval.batch_to_device(batch, torch.device("cpu"))
    scene = port_eval.prepare_joint_future(pcfg, pmodel, batch_t)
    samples = {k: torch.from_numpy(np.array(captured[k])) for k in SAMPLES}
    injected = port_eval.rollout_joint_futures(pcfg, pmodel, batch_t, scene, K, check_level=check_level, **samples)
    return dict(cfg=pcfg, model=pmodel, batch=batch, jbuf=jbuf, pbuf=pbuf, jroll=captured["buffer"],
                injected=injected)


def run_reactive_replay(cfg, check_level: int = 1):
    """The JAX and the port's reactive_replay (which draws nothing) on one batch and one set of weights:
    (JAX outputs, port outputs), each (buffer, navi_pred, latent_post)."""
    jmodel, tree = jax_model_params(cfg, seed=0, gain=0.5)
    batch = make_batch(cfg.data, n_sc=2, seed=1)

    def jfn(params, b):
        _, buf, navi, post, _ = jax_eval.reactive_replay(cfg, jmodel, params, b, jax.random.PRNGKey(0),
                                                         check_level=check_level)
        return buf, navi.logits, post.mean

    with jax_sort_knn():
        want = jax.jit(jfn)(to_jnp(tree), {k: jnp.asarray(v) for k, v in batch.items()})
    from trafficbotsv15_tpu_torch.train import evaluation as port_eval

    _, buf, navi, post, _ = port_eval.reactive_replay(port_cfg(cfg), port_model(cfg, tree), batch,
                                                      check_level=check_level, device="cpu")
    return want, (buf, navi.logits, post.mean)


def assert_rows(jbuf, pbuf, field, atol, k0_only=False):
    j, p = np.asarray(getattr(jbuf, field)), t2n(getattr(pbuf, field))
    assert p.shape == j.shape, (field, p.shape, j.shape)
    if k0_only:
        j, p = j[:, 0], p[:, 0]
    np.testing.assert_allclose(p, j.astype(p.dtype), rtol=0, atol=atol, err_msg=field)


def assert_flags(jbuf, pbuf, k0_only=False):
    assert set(pbuf.violation) == set(jbuf.violation)
    for key, val in jbuf.violation.items():
        j, p = np.asarray(val), pbuf.violation[key].numpy()
        np.testing.assert_array_equal(p[:, 0] if k0_only else p, j[:, 0] if k0_only else j, err_msg=key)


def count_wrappers(monkeypatch):
    """Calls of the KNN and KNARPE wrappers inside the test (on the CPU they take the plain versions), by input
    shape: knn_xy (rows, sources, 2, targets, k); B4 and B2 (batch, sources, D, K)."""
    from trafficbotsv15_tpu_torch.ops import knarpe, knn

    calls = {"knn_xy": [], "knarpe_attention": [], "knarpe_cross_attention": []}

    def count(mod, name, key):
        real = getattr(mod, name)

        def counted(*args):
            calls[name].append(key(args))
            return real(*args)

        monkeypatch.setattr(mod, name, counted)

    count(knn, "knn_xy", lambda a: (*a[0].shape, a[2].shape[1], a[4]))
    for name in ("knarpe_attention", "knarpe_cross_attention"):  # a[3]: rpe [b, s, K, R], invalid [b, s, K]
        count(knarpe, name, lambda a: (*a[0].shape, a[3].shape[2]))
    return calls
