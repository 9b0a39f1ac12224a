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

The same comparisons run a second time with `TransformerCfg(use_pallas=True,
dense_knn_max=16)` at the default check_level=1: the 32 polylines then take
the project-then-gather route through kernel B4 and the agent decoder the
fused K/V + RPE route through kernel B2, in both packages (the JAX package
takes its `knarpe_*_reference` on the CPU, the port its plain versions),
with the same tolerances.
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
from trafficbotsv15_tpu_torch.ops import knarpe, knn
from trafficbotsv15_tpu_torch.train import evaluation as port_eval

torch.set_num_threads(2)
K = 2
POSE_ATOL, LOGP_ATOL = 1e-3, 1e-4


def _pallas_cfg(cfg):
    """use_pallas=True with dense_knn_max below the tiny map's 32 polylines (the B4 gate)."""
    tf = dataclasses.replace(cfg.model.tf_cfg, use_pallas=True, dense_knn_max=16)
    return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, tf_cfg=tf))


def _run_both(cfg, check_level):
    """The JAX and the port's joint_future_pred on one batch and one set of
    weights, with the JAX rollout's arguments and result captured."""
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
                                             jax.random.PRNGKey(0), n_joint_future=K, check_level=check_level)
    pmodel, _ = port_model(cfg, tree)
    pcfg = port_cfg(cfg)
    _, pbuf = port_eval.joint_future_pred(pcfg, pmodel, batch, generator=torch.Generator().manual_seed(0),
                                          n_joint_future=K, check_level=check_level, device="cpu")
    return dict(cfg=pcfg, model=pmodel, batch=batch, jbuf=jbuf, pbuf=pbuf, captured=captured,
                check_level=check_level)


@pytest.fixture(scope="module")
def slice_run():
    return _run_both(dataclasses.replace(tiny_config(), joint_future_pred_deterministic_k0=True), check_level=0)


@pytest.fixture(scope="module")
def pallas_run():
    return _run_both(_pallas_cfg(dataclasses.replace(tiny_config(), joint_future_pred_deterministic_k0=True)),
                     check_level=1)


def _np(x):
    return np.asarray(x)


K0_FIELDS = [("pred_pose", POSE_ATOL), ("pred_action", POSE_ATOL), ("action_log_prob", LOGP_ATOL),
             ("pred_valid", 0), ("log_prob", LOGP_ATOL)]
ROW_FIELDS = [("pred_pose", POSE_ATOL), ("pred_motion", POSE_ATOL), ("pred_action", POSE_ATOL),
              ("action_log_prob", LOGP_ATOL), ("tl_state_nll", LOGP_ATOL), ("navi_log_prob", LOGP_ATOL),
              ("pred_valid", 0), ("mask_teacher_forcing", 0), ("tl_state", 0), ("tl_state_nll_invalid", 0),
              ("navi_log_prob_valid", 0)]


def _assert_rows(jbuf, pbuf, field, atol, k0_only=False):
    j, p = _np(getattr(jbuf, field)), t2n(getattr(pbuf, field))
    assert p.shape == j.shape
    if k0_only:
        j, p = j[:, 0], p[:, 0]
    np.testing.assert_allclose(p, j.astype(p.dtype), rtol=0, atol=atol)


def _assert_flags(jbuf, pbuf, k0_only=False):
    assert set(pbuf.violation) == set(jbuf.violation)
    for key, val in jbuf.violation.items():
        j, p = _np(val), pbuf.violation[key].numpy()
        np.testing.assert_array_equal(p[:, 0] if k0_only else p, j[:, 0] if k0_only else j, err_msg=key)


@pytest.mark.parametrize("field,atol", K0_FIELDS)
def test_joint_future_pred_k0_rows(slice_run, field, atol):
    _assert_rows(slice_run["jbuf"], slice_run["pbuf"], field, atol, k0_only=True)


def test_joint_future_pred_outputs(slice_run):
    buf, cfg = slice_run["pbuf"], slice_run["cfg"]
    n_sc, n_ag, n_step = 2, cfg.data.n_ag, cfg.time_step_end
    assert tuple(buf.pred_pose.shape) == (n_sc, K, n_ag, n_step, 3)
    assert tuple(buf.tl_state.shape) == (n_sc, K, cfg.data.n_tl_lane, n_step, 5)
    assert tuple(buf.log_prob.shape) == (n_sc, K, n_ag)
    assert torch.isfinite(buf.pred_pose).all() and torch.isfinite(buf.log_prob).all()
    assert set(buf.violation) == set(slice_run["jbuf"].violation)


def _inject(run):
    """The port's rollout with the JAX-sampled latent and destinations: (JAX buffer, port buffer)."""
    cap = run["captured"]
    cfg, model = run["cfg"], run["model"]
    batch = port_eval.batch_to_device(run["batch"], torch.device("cpu"))
    scene = port_eval.prepare_joint_future(cfg, model, batch)
    samples = {k: torch.from_numpy(np.array(cap[k])) for k in
               ("ag_latent", "ag_latent_valid", "ag_navi", "ag_navi_valid", "ag_navi_log_prob")}
    pbuf = port_eval.rollout_joint_futures(cfg, model, batch, scene, K, check_level=run["check_level"], **samples)
    return cap["buffer"], pbuf


@pytest.fixture(scope="module")
def injected(slice_run):
    return _inject(slice_run)


@pytest.fixture(scope="module")
def pallas_injected(pallas_run):
    return _inject(pallas_run)


@pytest.mark.parametrize("field,atol", ROW_FIELDS)
def test_rollout_with_injected_samples_every_row(injected, field, atol):
    _assert_rows(*injected, field, atol)


def test_rollout_with_injected_samples_rule_flags(injected):
    _assert_flags(*injected)


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


@pytest.mark.parametrize("field,atol", K0_FIELDS)
def test_use_pallas_joint_future_pred_k0_rows(pallas_run, field, atol):
    _assert_rows(pallas_run["jbuf"], pallas_run["pbuf"], field, atol, k0_only=True)


def test_use_pallas_joint_future_pred_k0_rule_flags(pallas_run):
    _assert_flags(pallas_run["jbuf"], pallas_run["pbuf"], k0_only=True)


@pytest.mark.parametrize("field,atol", ROW_FIELDS)
def test_use_pallas_rollout_with_injected_samples_every_row(pallas_injected, field, atol):
    _assert_rows(*pallas_injected, field, atol)


def test_use_pallas_rollout_with_injected_samples_rule_flags(pallas_injected):
    _assert_flags(*pallas_injected)


def _count_attention_kernels(monkeypatch):
    calls = {"knarpe_attention": [], "knarpe_cross_attention": []}
    for name, seen in calls.items():
        real = getattr(knarpe, name)
        monkeypatch.setattr(knarpe, name, lambda *a, _real=real, _seen=seen: _seen.append(tuple(a[0].shape)) or _real(*a))
    return calls


@pytest.mark.parametrize("kill_switch_on", [True, False])
def test_attention_kernels_once_per_layer_and_step(monkeypatch, kill_switch_on):
    """With use_pallas=True the map encoder calls B4 once per map layer and the
    agent decoder B2 once per agent layer and rollout step; the TL encoder
    reads its static K/V and calls neither. With the OpsCfg kill switch off,
    neither is called (plain versions on the CPU)."""
    from trafficbotsv15_tpu_torch.data.synthetic import make_batch as port_make_batch
    from trafficbotsv15_tpu_torch.ops.flags import OpsCfg
    from trafficbotsv15_tpu_torch.train.pipeline import build_model

    cfg = _pallas_cfg(port_cfg(tiny_config()))
    cfg = dataclasses.replace(cfg, ops=OpsCfg(use_pallas_attention=kill_switch_on))
    model = build_model(cfg, seed=0, device="cpu")
    calls = _count_attention_kernels(monkeypatch)
    _, buf = port_eval.joint_future_pred(cfg, model, port_make_batch(cfg.data, n_sc=1, seed=0),
                                         generator=torch.Generator().manual_seed(0), n_joint_future=2, device="cpu")
    n_mp, n_ag = cfg.data.n_mp, cfg.data.n_ag
    if kill_switch_on:
        assert calls["knarpe_attention"] == [(1, n_mp, cfg.model.hidden_dim)] * cfg.model.mp_encoder.n_layer_tf
        n_b2 = cfg.model.ag_encoder.n_layer_tf * cfg.time_step_end
        assert calls["knarpe_cross_attention"] == [(2, n_ag, cfg.model.hidden_dim)] * n_b2
    else:
        assert calls == {"knarpe_attention": [], "knarpe_cross_attention": []}
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
