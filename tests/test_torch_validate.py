"""PyTorch port: the validation path against the JAX package on the CPU.

On `tiny_config()` with random weights at gain 0.5 (`test_torch_slice.py`
says why) and one synthetic batch:
  - `reactive_replay` with `use_pallas` False (the validate step's) and True: every buffer field,
    `diffbar_reward` included, and the `reactive_replay/*` loss terms of
    `training_loss` on it. Reactive replay draws nothing (the posterior's
    mean, the logged destination, spawn-all forcing, deterministic
    actions), so both packages run it alike. The parent's eval buffer had
    no reward, and its loss fails;
  - the whole `make_validate_step` (JAX's jitted, once), with the JAX joint
    futures' latent and destination draws handed to the port (JAX keys and
    torch generators never draw alike): every entry of `out`;
  - `validate` over a 2-batch loader: JAX's metric names, and values equal
    to the reduction of the port's per-step outputs.
Tolerances: poses, trajectories and distances 1e-3 (m, rad, m/s; float32
over 20 closed-loop steps, `test_torch_slice.py`'s POSE_ATOL), log
probabilities and scores 1e-4 (LOGP_ATOL), the loss terms, the error sums
and the realism fields 1e-4 relative; flags, rule counts and miss rates
exact.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_helpers import jax_model_params, jax_sort_knn, port_cfg, port_model, set_threads, t2n, to_jnp
from trafficbotsv15_tpu.config import tiny_config
from trafficbotsv15_tpu.data.synthetic import make_batch
from trafficbotsv15_tpu.eval import runner as jax_runner
from trafficbotsv15_tpu.sim import rollout as jax_rollout_lib
from trafficbotsv15_tpu.train import evaluation as jax_eval
from trafficbotsv15_tpu.train.losses import training_loss as jax_training_loss
from trafficbotsv15_tpu_torch.eval import runner as port_runner
from trafficbotsv15_tpu_torch.train import evaluation as port_eval
from trafficbotsv15_tpu_torch.train.losses import training_loss
from trafficbotsv15_tpu_torch.utils.logging import MetricsLogger

set_threads()
POSE_ATOL, LOGP_ATOL, REL = 1e-3, 1e-4, 1e-4
BUFFER_FIELDS = [("pred_pose", POSE_ATOL), ("pred_motion", POSE_ATOL), ("pred_action", POSE_ATOL),
                 ("action_log_prob", LOGP_ATOL), ("tl_state_nll", LOGP_ATOL), ("navi_log_prob", LOGP_ATOL),
                 ("pred_valid", 0), ("mask_teacher_forcing", 0), ("tl_state", 0), ("tl_state_nll_invalid", 0),
                 ("navi_log_prob_valid", 0)]


def _cfg(use_pallas: bool):
    cfg = tiny_config()
    if use_pallas:  # dense_knn_max below the tiny map's 32 polylines: the map encoder takes B4 (test_torch_slice.py)
        tf = dataclasses.replace(cfg.model.tf_cfg, use_pallas=True, dense_knn_max=16)
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, tf_cfg=tf))
    return cfg


def _np(x):
    return t2n(x) if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, atol=0.0, rtol=0.0, msg=""):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (msg, got.shape, want.shape)
    if atol == 0 and rtol == 0:
        np.testing.assert_array_equal(got, want.astype(got.dtype), err_msg=msg)
    else:
        np.testing.assert_allclose(got, want.astype(got.dtype), rtol=rtol, atol=atol, err_msg=msg)


def _assert_buffers(jbuf, pbuf):
    for field, atol in BUFFER_FIELDS:
        _close(getattr(pbuf, field), getattr(jbuf, field), atol=atol, msg=field)
    assert set(pbuf.violation) == set(jbuf.violation)
    for key, val in jbuf.violation.items():
        _close(pbuf.violation[key], val, msg=key)
    assert set(pbuf.diffbar_reward) == set(jbuf.diffbar_reward)
    for key, val in jbuf.diffbar_reward.items():
        _close(pbuf.diffbar_reward[key], val, atol=0 if val.dtype == bool else LOGP_ATOL, msg=key)


def _assert_losses(got, want):
    assert set(got) == set(want) and "reactive_replay/diffbar_reward" in want
    for key, val in want.items():
        _close(got[key], val, atol=1e-6, rtol=REL, msg=key)


@pytest.fixture(scope="module", params=[False, True], ids=["plain", "use_pallas"])
def replay(request):
    """JAX reactive replay and its loss (jitted, once; without use_pallas those of the validate step below) and
    the port's, on one batch and one set of weights."""
    cfg = _cfg(request.param)
    jmodel, tree = jax_model_params(cfg, seed=0, gain=0.5)
    batch = make_batch(cfg.data, n_sc=2, seed=1)

    def run(params, b, key):
        pp, buf, navi_pred, post, prior = jax_eval.reactive_replay(cfg, jmodel, params, b, key)
        _, loss = jax_training_loss(cfg.training_metrics, buf, pp.ag_role, navi_pred, pp.gt_navi, post, prior,
                                    prefix="reactive_replay")
        return buf, loss

    if request.param:
        with jax_sort_knn():
            jbuf, jloss = jax.jit(run)(to_jnp(tree), {k: jnp.asarray(v) for k, v in batch.items()},
                                       jax.random.PRNGKey(0))
    else:
        step = request.getfixturevalue("validate_step")
        jbuf, jloss = step["jax_rr_buffer"], step["jout"]["loss_metrics"]
    pcfg, pmodel = port_cfg(cfg), port_model(cfg, tree)
    pp, pbuf, navi_pred, post, prior = port_eval.reactive_replay(pcfg, pmodel, batch, device="cpu")
    _, ploss = training_loss(pcfg.training_metrics, pbuf, pp.ag_role, navi_pred, pp.gt_navi, post, prior,
                             prefix="reactive_replay")
    return dict(cfg=pcfg, jbuf=jbuf, jloss=jloss, pbuf=pbuf, ploss=ploss, loss_args=(pp, navi_pred, post, prior))


def test_reactive_replay_buffer_matches_jax(replay):
    assert tuple(replay["pbuf"].pred_pose.shape) == (2, replay["cfg"].data.n_ag, replay["cfg"].time_step_end, 3)
    _assert_buffers(replay["jbuf"], replay["pbuf"])


def test_reactive_replay_loss_matches_jax(replay):
    _assert_losses(replay["ploss"], replay["jloss"])
    assert float(replay["ploss"]["reactive_replay/diffbar_reward"]) != 0.0


def test_reactive_replay_loss_fails_without_the_reward(replay):
    """The parent's eval rollout left `diffbar_reward` None: the validation loss could not be taken."""
    pp, navi_pred, post, prior = replay["loss_args"]
    parent_buf = dataclasses.replace(replay["pbuf"], diffbar_reward=None)
    with pytest.raises(TypeError):
        training_loss(replay["cfg"].training_metrics, parent_buf, pp.ag_role, navi_pred, pp.gt_navi, post, prior,
                      prefix="reactive_replay")


def test_joint_future_pred_leaves_the_reward_out():
    """The main-path eval call runs no reward ops: its buffer's reward stays None."""
    pcfg = port_cfg(tiny_config())
    model = port_model(tiny_config(), jax_model_params(tiny_config(), seed=0, gain=0.5)[1])
    _, buf = port_eval.joint_future_pred(pcfg, model, make_batch(pcfg.data, n_sc=1, seed=1), n_joint_future=2,
                                         generator=torch.Generator().manual_seed(0), device="cpu")
    assert buf.diffbar_reward is None


JF_SAMPLES = ("ag_latent", "ag_latent_valid", "ag_navi", "ag_navi_valid", "ag_navi_log_prob")


@pytest.fixture(scope="module")
def validate_step():
    """The JAX validate step (jitted, once) with its joint-future draws, and the port's step on the same batch
    with those draws injected."""
    cfg = _cfg(False)
    jmodel, tree = jax_model_params(cfg, seed=0, gain=0.5)
    batch = make_batch(cfg.data, n_sc=2, seed=1)
    jstep = jax_runner.make_validate_step(cfg, jmodel)

    def step_and_draws(params, b, key):
        """The step's out, and the arguments of the joint futures' rollout (the second rollout) and the latent
        log-probabilities handed to compute_log_prob, captured while it is traced."""
        rollouts, log_probs = [], []
        real_rollout, real_log_prob = jax_rollout_lib.rollout, jax_rollout_lib.compute_log_prob

        def rollout(*args, **kwargs):
            buf = real_rollout(*args, **kwargs)
            rollouts.append(({k: kwargs[k] for k in JF_SAMPLES}, buf))
            return buf

        def compute_log_prob(buf, latent_log_prob):
            log_probs.append(latent_log_prob)
            return real_log_prob(buf, latent_log_prob)

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax_rollout_lib, "rollout", rollout)
            mp.setattr(jax_rollout_lib, "compute_log_prob", compute_log_prob)
            out = jstep(params, b, key)
        assert len(rollouts) == 2 and len(log_probs) == 1  # reactive replay, then the joint futures
        return out, dict(rollouts[1][0], latent_log_prob=log_probs[0]), rollouts[0][1]

    with jax_sort_knn():
        jout, draws, rr_buffer = jax.jit(step_and_draws)(to_jnp(tree), {k: jnp.asarray(v) for k, v in batch.items()},
                                                         jax.random.PRNGKey(0))
    draws = {k: torch.from_numpy(np.array(v)) for k, v in draws.items()}
    pcfg, pmodel = port_cfg(cfg), port_model(cfg, tree)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_eval, "sample_joint_futures", lambda *a, **kw: dict(draws))
        pout = port_runner.make_validate_step(pcfg, pmodel, device="cpu")(batch, torch.Generator().manual_seed(0))
    return dict(cfg=pcfg, model=pmodel, jout=jout, pout=pout, tree=tree, jax_rr_buffer=rr_buffer)


def test_validate_step_out_keys(validate_step):
    assert set(validate_step["pout"]) == set(validate_step["jout"])
    assert {"wosac_realism", "womd_metric_vals", "womd_rr_metric_vals"} <= set(validate_step["pout"])


@pytest.mark.parametrize("entry", ["loss_metrics", "err_sums", "rr_rule", "jf_rule", "womd_metric_vals",
                                   "womd_rr_metric_vals", "wosac_realism"])
def test_validate_step_sums_and_metrics_match_jax(validate_step, entry):
    got, want = validate_step["pout"][entry], validate_step["jout"][entry]
    assert set(got) == set(want)
    for key, val in want.items():
        if entry in ("rr_rule", "jf_rule") or "miss_rate" in key:  # counts and rates of counts
            _close(got[key], val, msg=key)
        elif entry.startswith("womd"):  # means of distances
            _close(got[key], val, atol=POSE_ATOL, msg=key)
        else:
            _close(got[key], val, atol=1e-6, rtol=REL, msg=key)


@pytest.mark.parametrize("entry,atol", [("womd_trajs", POSE_ATOL), ("womd_scores", LOGP_ATOL),
                                        ("wosac_trajs", POSE_ATOL), ("womd_rr_trajs", POSE_ATOL),
                                        ("womd_rr_scores", LOGP_ATOL)])
def test_validate_step_trajectories_match_jax(validate_step, entry, atol):
    _close(validate_step["pout"][entry], validate_step["jout"][entry], atol=atol, msg=entry)


def test_validate_over_two_batches(validate_step, monkeypatch):
    """The port's `validate` gives the JAX `validate`'s metric names (JAX's run over a stand-in step that returns
    the JAX step's out), and values equal to the reduction of its own per-step outputs."""
    cfg, model = validate_step["cfg"], validate_step["model"]
    loader = [make_batch(cfg.data, n_sc=2, seed=s) for s in (1, 2)]
    jcfg = tiny_config()
    jout = validate_step["jout"]
    monkeypatch.setattr(jax_runner, "make_validate_step", lambda c, m: lambda params, b, key: jout)
    jmetrics = jax_runner.validate(jcfg, loader, params=to_jnp(validate_step["tree"]),
                                   logger=jax_runner.MetricsLogger(None, echo=False))
    got = port_runner.validate(cfg, model, loader, logger=MetricsLogger(None, echo=False), device="cpu")
    assert set(got) == set(jmetrics)

    step = port_runner.make_validate_step(cfg, model, device="cpu")
    outs = [step(b, torch.Generator().manual_seed(cfg.seed + i)) for i, b in enumerate(loader)]
    n_sc = 4

    def total(entry, key):
        return sum(float(o[entry][key]) for o in outs)

    want = {"val/loss": total("loss_metrics", "reactive_replay/loss") / 2,
            "reactive_replay/err/pos_meter": total("err_sums", "err_pos_meter") / total("err_sums", "err_counter"),
            "joint_future_pred/traffic_rule/goal_reached":
                total("jf_rule", "goal_reached") / total("jf_rule", "counter_agent"),
            "joint_future_pred/womd/min_ade": total("womd_metric_vals", "min_ade") / 2,
            "reactive_replay/womd/miss_rate": total("womd_rr_metric_vals", "miss_rate") / 2,
            "wosac/realism_meta_metric": sum(float(o["wosac_realism"]["metametric"].sum()) for o in outs) / n_sc,
            "wosac/min_ade": sum(float(o["wosac_realism"]["min_average_displacement_error"].sum())
                                 for o in outs) / n_sc,
            "wosac_likelihood/offroad_indication_likelihood":
                sum(float(o["wosac_realism"]["offroad_indication_likelihood"].sum()) for o in outs) / n_sc}
    for key, val in want.items():
        assert got[key] == pytest.approx(val, rel=1e-6), key
    assert got["val/scenarios_per_sec"] > 0
