"""PyTorch port: the slice end to end, `joint_future_pred` on tiny_config against the JAX package.

One module-scoped fixture runs the JAX `joint_future_pred` once (KNN on the
stable sort, check_level=0, K0 futures deterministic) and captures the
arguments and result of its `rollout`. The port then
  - runs its own `joint_future_pred` on the same batch and weights: the K0
    rows, whose latent and destination are the modes, must match;
  - replays the rollout with the JAX-sampled latent and destinations fed in
    (JAX keys and torch generators never draw alike): every row must match.

The weights are random with a gain of 0.5 on every matrix: at gain 1 the
random policy's closed loop is chaotic over the 20 steps (a 1e-7 relative
weight change moves poses by more than the tolerance within the port alone),
which would measure the chaos, not the port; at gain 0.5 it moves them by
less than a tenth of it (test_damped_random_policy_is_not_chaotic). Tolerances: 1e-3 m / rad / m/s on poses, motion and actions
(float32 over 20 closed-loop steps on ~100 m coordinates), 1e-4 on log
probabilities; validity, forcing, TL states and rule flags identical.
"""

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
from trafficbotsv15_tpu_torch.ops import knn
from trafficbotsv15_tpu_torch.train import evaluation as port_eval

torch.set_num_threads(2)
K = 2
POSE_ATOL, LOGP_ATOL = 1e-3, 1e-4


@pytest.fixture(scope="module")
def slice_run():
    cfg = dataclasses.replace(tiny_config(), joint_future_pred_deterministic_k0=True)
    jmodel, tree = jax_model_params(cfg, seed=0, gain=0.5)
    batch = make_batch(cfg.data, n_sc=2, seed=1)
    captured = {}
    real_rollout = jax_rollout_lib.rollout

    def capture(*args, **kwargs):
        buf = real_rollout(*args, **kwargs)
        captured.update(kwargs, buffer=buf)
        return buf

    with jax_sort_knn(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_rollout_lib, "rollout", capture)
        _, jbuf = jax_eval.joint_future_pred(cfg, jmodel, to_jnp(tree), {k: jnp.asarray(v) for k, v in batch.items()},
                                             jax.random.PRNGKey(0), n_joint_future=K, check_level=0)
    pmodel, _ = port_model(cfg, tree)
    pcfg = port_cfg(cfg)
    _, pbuf = port_eval.joint_future_pred(pcfg, pmodel, batch, generator=torch.Generator().manual_seed(0),
                                          n_joint_future=K, check_level=0, device="cpu")
    return dict(cfg=pcfg, model=pmodel, batch=batch, jbuf=jbuf, pbuf=pbuf, captured=captured)


def _np(x):
    return np.asarray(x)


@pytest.mark.parametrize("field,atol", [("pred_pose", POSE_ATOL), ("pred_action", POSE_ATOL),
                                        ("action_log_prob", LOGP_ATOL), ("pred_valid", 0), ("log_prob", LOGP_ATOL)])
def test_joint_future_pred_k0_rows(slice_run, field, atol):
    j = _np(getattr(slice_run["jbuf"], field))
    p = t2n(getattr(slice_run["pbuf"], field))
    assert p.shape == j.shape
    np.testing.assert_allclose(p[:, 0], j[:, 0].astype(p.dtype), rtol=0, atol=atol)


def test_joint_future_pred_outputs(slice_run):
    buf, cfg = slice_run["pbuf"], slice_run["cfg"]
    n_sc, n_ag, n_step = 2, cfg.data.n_ag, cfg.time_step_end
    assert tuple(buf.pred_pose.shape) == (n_sc, K, n_ag, n_step, 3)
    assert tuple(buf.tl_state.shape) == (n_sc, K, cfg.data.n_tl_lane, n_step, 5)
    assert tuple(buf.log_prob.shape) == (n_sc, K, n_ag)
    assert torch.isfinite(buf.pred_pose).all() and torch.isfinite(buf.log_prob).all()
    assert set(buf.violation) == set(slice_run["jbuf"].violation)


@pytest.fixture(scope="module")
def injected(slice_run):
    cap = slice_run["captured"]
    cfg, model = slice_run["cfg"], slice_run["model"]
    batch = port_eval.batch_to_device(slice_run["batch"], torch.device("cpu"))
    scene = port_eval.prepare_joint_future(cfg, model, batch)
    samples = {k: torch.from_numpy(np.array(cap[k])) for k in
               ("ag_latent", "ag_latent_valid", "ag_navi", "ag_navi_valid", "ag_navi_log_prob")}
    pbuf = port_eval.rollout_joint_futures(cfg, model, batch, scene, K, check_level=0, **samples)
    return cap["buffer"], pbuf


@pytest.mark.parametrize("field,atol", [
    ("pred_pose", POSE_ATOL), ("pred_motion", POSE_ATOL), ("pred_action", POSE_ATOL),
    ("action_log_prob", LOGP_ATOL), ("tl_state_nll", LOGP_ATOL), ("navi_log_prob", LOGP_ATOL),
    ("pred_valid", 0), ("mask_teacher_forcing", 0), ("tl_state", 0), ("tl_state_nll_invalid", 0),
    ("navi_log_prob_valid", 0),
])
def test_rollout_with_injected_samples_every_row(injected, field, atol):
    jb, pb = injected
    j, p = _np(getattr(jb, field)), t2n(getattr(pb, field))
    assert p.shape == j.shape
    np.testing.assert_allclose(p, j.astype(p.dtype), rtol=0, atol=atol)


def test_rollout_with_injected_samples_rule_flags(injected):
    jb, pb = injected
    assert set(pb.violation) == set(jb.violation)
    for key, val in jb.violation.items():
        np.testing.assert_array_equal(pb.violation[key].numpy(), _np(val), err_msg=key)


def test_kernel_path_once_per_rollout_step(monkeypatch):
    """With 512 polylines the agent->map KNN passes the kernel gate: the rollout
    calls the KNN wrapper exactly once per step (plain version on the CPU)."""
    cfg = dataclasses.replace(port_cfg(tiny_config(n_mp=512)), joint_future_pred_deterministic_k0=True)
    from trafficbotsv15_tpu_torch.train.pipeline import build_model
    from trafficbotsv15_tpu_torch.data.synthetic import make_batch as port_make_batch

    model = build_model(cfg, seed=0, device="cpu")
    calls = []
    real = knn.knn_xy
    monkeypatch.setattr(knn, "knn_xy", lambda *a: calls.append(tuple(a[0].shape)) or real(*a))
    _, buf = port_eval.joint_future_pred(cfg, model, port_make_batch(cfg.data, n_sc=1, seed=0),
                                         generator=torch.Generator().manual_seed(0), n_joint_future=2, device="cpu")
    assert calls == [(2, cfg.data.n_ag, 2)] * cfg.time_step_end
    assert torch.isfinite(buf.pred_pose).all()


def test_damped_random_policy_is_not_chaotic():
    """Why the parity weights have gain 0.5: with the parity tests' random
    weights at gain 0.5, a 1e-7 relative change of every weight moves the
    20-step rollout far less than the pose tolerance; at gain 1 it moves it by
    more than the tolerance, so a comparison there would measure the chaos of
    the random closed loop, not the port."""
    cfg = dataclasses.replace(tiny_config(), joint_future_pred_deterministic_k0=True)
    pcfg = port_cfg(cfg)
    batch = make_batch(cfg.data, n_sc=2, seed=1)

    def moved(gain):
        _, tree = jax_model_params(cfg, seed=0, gain=gain)
        out = []
        for rel_change in (0.0, 1e-7):
            model, _ = port_model(cfg, tree)
            with torch.no_grad():
                for p in model.parameters():
                    p.mul_(1.0 + rel_change)
            _, buf = port_eval.joint_future_pred(pcfg, model, batch, generator=torch.Generator().manual_seed(0),
                                                 n_joint_future=K, device="cpu")
            out.append(buf.pred_pose)
        return float((out[0] - out[1]).abs().max())

    damped, full = moved(0.5), moved(1.0)
    assert damped < POSE_ATOL / 10, damped
    assert full > POSE_ATOL, full
