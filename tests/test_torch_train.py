"""PyTorch port: the training slice's modules against the JAX package, and its dropout and recompute.

Against the JAX functions, on the CPU, with inputs from a numpy seed and the
JAX draws handed to the port where the JAX function draws:
  - `sim/rewards.py::diffbar_reward` (every angular type, the 5-circle
    collision term both ways): values and gradients to 1e-5 (float32, same
    ops); with the collision term the JAX gradient is NaN (the norm of each
    box's zero distance to itself) and the port's is finite;
  - `train/losses.py::training_loss` with each switch of
    `TrainingMetricsCfg`: loss terms to 1e-5 relative, gradients with
    respect to the latent distributions, rewards, TL NLL and navi logits to
    1e-5 (the balanced KL's stop-gradients included);
  - the posterior latent encoder (`encode_latent(posterior=True)`, 5-step
    window at tiny size) with use_pallas False and True: mean and std to
    1e-4 (float32 through two encoders);
  - `build_forcing_masks` with random agent forcing over epochs and
    scheduled sampling, and the history dropout of `pre_processing`: equal;
  - `train/optimizer.py` against optax's chain on the same gradients, with
    clipping, the StepLR decay and the navi group: after the n-th of three
    updates, parameters within n float32 ulps (optax rounds p + update once
    per update; torch's AdamW rounds the decayed p, then p plus the Adam
    step), the global norm before clipping to 1e-6 relative.
Port only: dropout draws nothing outside a scope and the same masks inside
one; gradients with and without the per-step checkpoint agree with dropout
on (1e-6 relative; the recompute replays the masks); the training step
calls the kernels' paths as often as the config implies.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from test_torch_helpers import (jax_model_params, jax_sort_knn, jax_training_noise, port_cfg, port_model, set_threads,
                                t2n, to_jnp)
from trafficbotsv15_tpu.config import RewardCfg, TeacherForcingCfg, TrainingMetricsCfg, tiny_config
from trafficbotsv15_tpu.data.preprocessing import pre_processing as jax_pre
from trafficbotsv15_tpu.data.synthetic import make_batch
from trafficbotsv15_tpu.ops.distributions import DestCategorical as JDest
from trafficbotsv15_tpu.ops.distributions import DiagGaussian as JGauss
from trafficbotsv15_tpu.sim import rewards as jax_rewards
from trafficbotsv15_tpu.sim.rollout import RolloutBuffer as JBuffer
from trafficbotsv15_tpu.sim.teacher_forcing import build_forcing_masks as jax_forcing
from trafficbotsv15_tpu.train.losses import training_loss as jax_loss
from trafficbotsv15_tpu.train.optimizer import make_optimizer as jax_make_optimizer
from trafficbotsv15_tpu_torch import config as pc
from trafficbotsv15_tpu_torch.data.preprocessing import pre_processing as port_pre
from trafficbotsv15_tpu_torch.ops import dropout as drop
from trafficbotsv15_tpu_torch.ops import knarpe, knn
from trafficbotsv15_tpu_torch.ops.distributions import DestCategorical, DiagGaussian
from trafficbotsv15_tpu_torch.sim import rewards as port_rewards
from trafficbotsv15_tpu_torch.sim.rollout import RolloutBuffer
from trafficbotsv15_tpu_torch.sim.teacher_forcing import build_forcing_masks as port_forcing
from trafficbotsv15_tpu_torch.train import pipeline as port_pipeline
from trafficbotsv15_tpu_torch.train.losses import training_loss as port_loss
from trafficbotsv15_tpu_torch.train.optimizer import clip_by_global_norm, make_optimizer

set_threads()
ATOL = 1e-5


def T(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(t2n(got), np.asarray(want, dtype=np.float32), rtol=0, atol=atol)


# -- rewards -----------------------------------------------------------------
def _reward_inputs(seed):
    rng = np.random.default_rng(seed)
    n_sc, n_ag = 2, 6
    gt_pose = rng.normal(size=(n_sc, n_ag, 3)).astype(np.float32) * [5, 5, 2]
    pred_pose = (gt_pose + rng.normal(size=gt_pose.shape) * [1.5, 1.5, 1.0]).astype(np.float32)
    pred_motion = rng.normal(size=(n_sc, n_ag, 3)).astype(np.float32) * 3
    gt_motion = rng.normal(size=(n_sc, n_ag, 3)).astype(np.float32) * 3
    pred_valid = rng.uniform(size=(n_sc, n_ag)) < 0.8
    gt_valid = rng.uniform(size=(n_sc, n_ag)) < 0.8
    size = rng.uniform(1.0, 5.0, size=(n_sc, n_ag, 3)).astype(np.float32)
    return pred_valid, pred_pose, pred_motion, gt_valid, gt_pose, gt_motion, size


@pytest.mark.parametrize("cfg", [RewardCfg(), RewardCfg(angular_type="cast"), RewardCfg(angular_type="vector"),
                                 RewardCfg(angular_type="l1"), RewardCfg(w_collision=1.0),
                                 RewardCfg(w_collision=0.5, reduce_collision_with_max=False, use_il_loss=False)],
                         ids=["cosine", "cast", "vector", "l1", "collision_max", "collision_mean_only"])
def test_diffbar_reward_matches_jax(cfg):
    pv, pp, pm, gv, gp, gm, size = _reward_inputs(0)
    pcfg = pc.RewardCfg(**dataclasses.asdict(cfg))
    want = jax_rewards.diffbar_reward(cfg, jnp.asarray(pv), jnp.asarray(pp), jnp.asarray(pm), jnp.asarray(gv),
                                      jnp.asarray(gp), jnp.asarray(gm), jnp.asarray(size))
    tp, tm = T(pp).requires_grad_(True), T(pm).requires_grad_(True)
    got = port_rewards.diffbar_reward(pcfg, T(pv), tp, tm, T(gv), T(gp), T(gm), T(size))
    assert set(got) == set(want)
    for k in want:
        if k == "diffbar_reward_valid":
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
        else:
            _close(got[k], want[k])
    jg = jax.grad(lambda a, b: jnp.sum(jax_rewards.diffbar_reward(
        cfg, jnp.asarray(pv), a, b, jnp.asarray(gv), jnp.asarray(gp), jnp.asarray(gm),
        jnp.asarray(size))["diffbar_reward"]), argnums=(0, 1))(jnp.asarray(pp), jnp.asarray(pm))
    got["diffbar_reward"].sum().backward()
    if cfg.w_collision > 0:
        # the JAX gradient is NaN here: the norm of each box's zero distance to itself is
        # differentiated before the ego mask (0 * inf); torch's norm gives 0 there
        assert np.isnan(np.asarray(jg[0])).any()
        assert torch.isfinite(tp.grad).all()  # (pred_motion only reaches the imitation terms)
        return
    _close(tp.grad, jg[0])
    _close(tm.grad, jg[1])


# -- loss --------------------------------------------------------------------
LOSS_CASES = {
    "default": TrainingMetricsCfg(),
    "relevant_weighted_and_irrelevant_sampled": TrainingMetricsCfg(w_relevant_agent=2.0, p_loss_for_irrelevant=0.5),
    "discount_no_teacher_forced_steps": TrainingMetricsCfg(temporal_discount=0.9, loss_for_teacher_forcing=False),
    "plain_kl_seen_agents_from_step_0": TrainingMetricsCfg(kl_balance_scale=0.0, kl_free_nats=0.0,
                                                           kl_for_unseen_agent=False, step_training_start=0),
    "irrelevant_dropped": TrainingMetricsCfg(p_loss_for_irrelevant=0.0, w_navi=0.5, w_tl_state=2.0),
}


def _loss_inputs(seed):
    rng = np.random.default_rng(seed)
    n_sc, n_ag, n_tl, n_step, d, n_mp = 2, 5, 4, 12, 4, 7
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    b = lambda p, *s: rng.uniform(size=s) < p
    return dict(
        pred_valid=b(0.8, n_sc, n_ag, n_step), tf=b(0.3, n_sc, n_ag, n_step), r=f(n_sc, n_ag, n_step),
        r_valid=b(0.8, n_sc, n_ag, n_step), parts=[f(n_sc, n_ag, n_step) for _ in range(4)],
        tl_nll=np.abs(f(n_sc, n_tl, n_step)), tl_inv=b(0.3, n_sc, n_tl, n_step), role=b(0.3, n_sc, n_ag, 3),
        post_mean=f(n_sc, n_ag, d), post_log_std=0.3 * f(n_sc, n_ag, d), prior_mean=0.5 * f(n_sc, n_ag, d),
        prior_log_std=0.2 * f(n_sc, n_ag, d), post_valid=b(0.8, n_sc, n_ag), prior_valid=b(0.6, n_sc, n_ag),
        navi_logits=f(n_sc, n_ag, n_mp), navi_gt=rng.integers(0, n_mp, size=(n_sc, n_ag)).astype(np.int32),
        navi_valid=b(0.8, n_sc, n_ag))


DIFF_KEYS = ("post_mean", "post_log_std", "prior_mean", "prior_log_std", "r", "tl_nll", "navi_logits")


def _jax_loss(cfg, x, diff, key):
    rew_keys = ("r_imitation_pos", "r_imitation_rot", "r_imitation_spd", "r_traffic_rule_approx")
    z = jnp.zeros(x["pred_valid"].shape)
    buf = JBuffer(
        pred_valid=jnp.asarray(x["pred_valid"]), pred_pose=z, pred_motion=z, pred_action=z, action_log_prob=z,
        tl_state_nll=diff["tl_nll"], tl_state_nll_invalid=jnp.asarray(x["tl_inv"]),
        mask_teacher_forcing=jnp.asarray(x["tf"]),
        diffbar_reward={"diffbar_reward": diff["r"], "diffbar_reward_valid": jnp.asarray(x["r_valid"]),
                        **{k: jnp.asarray(v) for k, v in zip(rew_keys, x["parts"])}},
        violation={}, tl_state=z, navi_log_prob=z, navi_log_prob_valid=z)
    post = JGauss(diff["post_mean"], jnp.exp(diff["post_log_std"]), jnp.asarray(x["post_valid"]))
    prior = JGauss(diff["prior_mean"], jnp.exp(diff["prior_log_std"]), jnp.asarray(x["prior_valid"]))
    navi = JDest(diff["navi_logits"], jnp.asarray(x["navi_valid"]))
    return jax_loss(cfg, buf, jnp.asarray(x["role"]), navi, jnp.asarray(x["navi_gt"]), post, prior, key=key)


def _port_loss(cfg, x, diff, u_irrelevant):
    rew_keys = ("r_imitation_pos", "r_imitation_rot", "r_imitation_spd", "r_traffic_rule_approx")
    z = torch.zeros(x["pred_valid"].shape)
    buf = RolloutBuffer(
        pred_valid=T(x["pred_valid"]), pred_pose=z, pred_motion=z, pred_action=z, action_log_prob=z,
        tl_state_nll=diff["tl_nll"], tl_state_nll_invalid=T(x["tl_inv"]), mask_teacher_forcing=T(x["tf"]),
        violation={}, tl_state=z, navi_log_prob=z, navi_log_prob_valid=z,
        diffbar_reward={"diffbar_reward": diff["r"], "diffbar_reward_valid": T(x["r_valid"]),
                        **{k: T(v) for k, v in zip(rew_keys, x["parts"])}})
    post = DiagGaussian(diff["post_mean"], torch.exp(diff["post_log_std"]), T(x["post_valid"]))
    prior = DiagGaussian(diff["prior_mean"], torch.exp(diff["prior_log_std"]), T(x["prior_valid"]))
    navi = DestCategorical(diff["navi_logits"], T(x["navi_valid"]))
    pcfg = pc.TrainingMetricsCfg(**dataclasses.asdict(cfg))
    return port_loss(pcfg, buf, T(x["role"]), navi, T(x["navi_gt"]), post, prior, u_irrelevant=u_irrelevant)


@pytest.mark.parametrize("case", list(LOSS_CASES))
def test_training_loss_matches_jax(case):
    cfg = LOSS_CASES[case]
    x = _loss_inputs(1)
    key = jax.random.PRNGKey(5)
    u_irr = T(jax.random.uniform(key, x["role"].shape[:2] + (1,)))
    jdiff = {k: jnp.asarray(x[k]) for k in DIFF_KEYS}
    (jl, jm), jg = jax.value_and_grad(lambda d: _jax_loss(cfg, x, d, key), has_aux=True)(jdiff)
    pdiff = {k: T(x[k]).requires_grad_(True) for k in DIFF_KEYS}
    pl, pm = _port_loss(cfg, x, pdiff, u_irr)
    assert set(pm) == set(jm)
    for k in jm:
        assert abs(float(pm[k]) - float(jm[k])) <= ATOL * max(1.0, abs(float(jm[k]))), k
    pl.backward()
    for k in DIFF_KEYS:
        _close(pdiff[k].grad, jg[k])


# -- posterior latent encoder --------------------------------------------------
@pytest.mark.parametrize("use_pallas", [False, True])
def test_posterior_latent_encoder_matches_jax(use_pallas):
    cfg = tiny_config()
    if use_pallas:
        tf = dataclasses.replace(cfg.model.tf_cfg, use_pallas=True)
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, tf_cfg=tf))
    jmodel, tree = jax_model_params(cfg, seed=2, gain=0.5)
    pmodel = port_model(cfg, tree)
    batch = make_batch(cfg.data, n_sc=2, seed=6)
    jp = jax_pre({k: jnp.asarray(v) for k, v in batch.items()}, n_step_hist=cfg.n_step_hist)
    pp = port_pre({k: T(v) for k, v in batch.items()}, n_step_hist=cfg.n_step_hist)
    def posterior(params, jp):
        mp = jmodel.apply(params, jp.mp_valid, jp.mp_attr, jp.mp_pose, jp.mp_type, method="encode_map")
        tl = jmodel.apply(params, jp.tl_valid, jp.tl_attr, jp.tl_pose, mp, method="precompute_tl")
        return jmodel.apply(params, jp.gt_valid, jp.ag_attr, jp.gt_motion, jp.gt_pose, jp.ag_type,
                            jp.gt_tl_state.astype(jnp.float32), mp, tl, True, method="encode_latent")

    with jax_sort_knn():
        want = jax.jit(posterior)({"params": to_jnp(tree)}, jp)
    with torch.no_grad():
        pmp = pmodel.encode_map(pp.mp_valid, pp.mp_attr, pp.mp_pose, pp.mp_type)
        ptl = pmodel.precompute_tl(pp.tl_valid, pp.tl_attr, pp.tl_pose, pmp)
        got = pmodel.encode_latent(pp.gt_valid, pp.ag_attr, pp.gt_motion, pp.gt_pose, pp.ag_type,
                                   pp.gt_tl_state.float(), pmp, ptl, posterior=True)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    _close(got.mean, want.mean, 1e-4)
    _close(got.std, want.std, 1e-4)
    assert float(got.mean.abs().max()) > 0.01  # a real network output, not the std_gaus head


# -- teacher forcing and history dropout --------------------------------------
@pytest.mark.parametrize("epoch", [0, 1, 3])
@pytest.mark.parametrize("scheduled", [False, True])
def test_build_forcing_masks_matches_jax(epoch, scheduled):
    cfg = TeacherForcingCfg(prob_scheduled_sampling=0.2 if scheduled else 0.0,
                            prob_scheduled_sampling_decrease_per_epoch=0.05 if scheduled else 0.0)
    rng = np.random.default_rng(epoch)
    valid = rng.uniform(size=(3, 16, 21)) < 0.7
    tl = np.ones((3, 4, 21), bool)
    key = jax.random.PRNGKey(epoch + 10)
    want, _ = jax_forcing(cfg, jnp.asarray(valid), jnp.asarray(tl), epoch, key)
    k1, k2 = jax.random.split(key)
    got, tl_out = port_forcing(pc.TeacherForcingCfg(**dataclasses.asdict(cfg)), T(valid), T(tl), epoch,
                               u_agent=T(jax.random.uniform(k1, (3, 16))),
                               u_ss=T(jax.random.uniform(k2, (3, 16, 21))) if scheduled else None)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert torch.equal(tl_out, T(tl))


def test_history_dropout_matches_jax():
    cfg = tiny_config()
    batch = make_batch(cfg.data, n_sc=2, seed=3)
    key = jax.random.PRNGKey(7)
    want = jax_pre({k: jnp.asarray(v) for k, v in batch.items()}, n_step_hist=cfg.n_step_hist,
                   dropout_p_history=0.3, training=True, key=key)
    noise = jax_training_noise(cfg, batch, jax.random.split(jax.random.PRNGKey(0), 1)[0])
    k1, k2 = jax.random.split(key)
    n_sc, n_mp, n_node = batch["map/valid"].shape
    got = port_pre({k: T(v) for k, v in batch.items()}, n_step_hist=cfg.n_step_hist, dropout_p_history=0.3,
                   u_mp=T(jax.random.uniform(k1, (n_sc, n_mp, n_node - 1))),
                   u_ag=T(jax.random.uniform(k2, (n_sc, cfg.data.n_ag, cfg.n_step_hist - 1))))
    np.testing.assert_array_equal(got.mp_valid.numpy(), np.asarray(want.mp_valid))
    np.testing.assert_array_equal(got.ag_valid.numpy(), np.asarray(want.ag_valid))
    assert not np.array_equal(np.asarray(want.ag_valid), batch["agent/valid"][:, :, :cfg.n_step_hist])
    assert set(noise) >= {"u_mp", "u_ag", "u_prior", "latent_eps", "seeds_step"}


# -- optimizer ---------------------------------------------------------------
@pytest.mark.parametrize("lr_navi", [None, 1e-3])
def test_optimizer_updates_match_optax(lr_navi):
    cfg_kw = dict(lr=2e-3, lr_navi=lr_navi, scheduler_step_epochs=1)
    from trafficbotsv15_tpu.config import OptimizerCfg

    jcfg = OptimizerCfg(**cfg_kw)
    rng = np.random.default_rng(0)
    shapes = {"navi_predictor": {"w": (4, 3), "b": (3,)}, "ag_encoder": {"w": (5, 4)}, "action_head": {"b": (2,)}}
    params = {top: {k: rng.normal(size=s).astype(np.float32) for k, s in d.items()} for top, d in shapes.items()}
    tx = jax_make_optimizer(jcfg, steps_per_epoch=1)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    state = tx.init(jparams)
    model = torch.nn.ModuleDict({top: torch.nn.ParameterDict({k: torch.nn.Parameter(T(v)) for k, v in d.items()})
                                 for top, d in params.items()})
    opt, schedule = make_optimizer(pc.OptimizerCfg(**dataclasses.asdict(jcfg)), model, steps_per_epoch=1)
    assert len(opt.param_groups) == (2 if lr_navi else 1)
    for step in range(3):
        scale = 4.0 if step == 0 else 0.5  # the first gradient's norm is clipped, the others are not
        grads = {top: {k: (scale * rng.normal(size=s)).astype(np.float32) for k, s in d.items()}
                 for top, d in shapes.items()}
        updates, state = tx.update(jax.tree_util.tree_map(jnp.asarray, grads), state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for top, d in grads.items():
            for k, v in d.items():
                model[top][k].grad = T(v)
        gnorm = clip_by_global_norm(opt.param_groups, jcfg.grad_clip_norm)
        opt.step()
        schedule.step()
        want_norm = np.sqrt(sum(float(np.sum(v.astype(np.float64) ** 2)) for d in grads.values() for v in d.values()))
        assert float(gnorm) == pytest.approx(want_norm, rel=1e-6)
        for top, d in shapes.items():
            for k in d:
                np.testing.assert_array_max_ulp(model[top][k].detach().numpy(), np.asarray(jparams[top][k]),
                                                maxulp=step + 1)
    assert schedule.last_epoch == 3 and schedule.get_last_lr()[0] == pytest.approx(2e-3 * 0.5 ** 3)


def test_optimizer_refuses_accumulation():
    with pytest.raises(NotImplementedError):
        make_optimizer(pc.OptimizerCfg(accumulate_grad_batches=2), torch.nn.Linear(2, 2))


# -- dropout, recompute and launch counts -------------------------------------
def test_dropout_draws_only_inside_a_scope():
    x = torch.ones(64, 64)
    assert drop.dropout(x, 0.5) is x and not drop.active()
    with drop.dropout_scope(7, "cpu"):
        a = drop.dropout(x, 0.25)
        b = drop.dropout(x, 0.25)
    with drop.dropout_scope(7, "cpu"):
        a2 = drop.dropout(x, 0.25)
    assert torch.equal(a, a2) and not torch.equal(a, b)
    assert torch.equal(torch.unique(a), torch.tensor([0.0, 1.0 / 0.75]))
    assert abs(float((a == 0).float().mean()) - 0.25) < 0.03
    with drop.dropout_scope(None, "cpu"):
        assert drop.dropout(x, 0.5) is x


def test_eval_step_is_unaffected_by_dropout_rates():
    """Outside a training scope the model computes as it did before dropout existed."""
    cfg = port_cfg(tiny_config())
    lo = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, tf_cfg=dataclasses.replace(cfg.model.tf_cfg, dropout_p=0.0)))
    batch = {k: T(v) for k, v in make_batch(cfg.data, n_sc=1, seed=0).items()}
    outs = []
    for c in (cfg, lo):
        model = port_pipeline.build_model(c, seed=0, device="cpu")
        pp = port_pre(batch, n_step_hist=c.n_step_hist)
        with torch.no_grad():
            outs.append(model.encode_map(pp.mp_valid, pp.mp_attr, pp.mp_pose, pp.mp_type).feature)
    assert torch.equal(outs[0], outs[1])


def _grads_of(cfg, noise, batch):
    model = port_pipeline.build_model(cfg, seed=0, device="cpu")
    loss, _ = port_pipeline.training_forward(cfg, model, batch, noise)
    loss.backward()
    return {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None}


def test_per_step_checkpoint_replays_the_dropout_masks():
    """Dropout on: gradients with the per-step recompute equal those without it, and differ
    from those of other dropout seeds (so dropout really acts)."""
    cfg = port_cfg(tiny_config())
    assert cfg.model.tf_cfg.dropout_p > 0 and cfg.remat_policy != "none"
    batch = {k: T(v) for k, v in make_batch(cfg.data, n_sc=2, seed=1).items()}
    noise = port_pipeline.draw_training_noise(cfg, batch, torch.Generator().manual_seed(0), "cpu")
    remat = _grads_of(cfg, noise, batch)
    plain = _grads_of(dataclasses.replace(cfg, remat_policy="none"), noise, batch)
    other = _grads_of(cfg, dict(noise, seeds_step=[s + 1 for s in noise["seeds_step"]]), batch)
    assert set(remat) == set(plain)
    for n in remat:
        torch.testing.assert_close(remat[n], plain[n], rtol=1e-6, atol=1e-9)
    assert any(not torch.allclose(remat[n], other[n]) for n in remat)


def test_train_step_calls_each_kernel_path_as_the_config_implies(monkeypatch):
    """use_pallas=True, 512 polylines (the KNN kernel's gate): per training step the forward of
    B4 runs once per map layer; B2 twice per agent layer and rollout step (forward and the
    per-step recompute) plus once per posterior TL and agent layer; the KNN twice per step plus
    once for the posterior; each backward once per forward that is not a recompute."""
    cfg = pc.with_pallas(port_cfg(tiny_config(n_mp=512)), True)
    calls = {k: 0 for k in ("knarpe_attention", "knarpe_cross_attention", "bwd_attention", "bwd_cross", "knn")}

    def counted(key, fn):
        def wrap(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return wrap

    for name in ("knarpe_attention", "knarpe_cross_attention"):
        monkeypatch.setitem(knarpe._PLAIN, name, counted(name, knarpe._PLAIN[name]))
    monkeypatch.setattr(knarpe, "knarpe_attention_bwd_reference",
                        counted("bwd_attention", knarpe.knarpe_attention_bwd_reference))
    monkeypatch.setattr(knarpe, "knarpe_cross_attention_bwd_reference",
                        counted("bwd_cross", knarpe.knarpe_cross_attention_bwd_reference))
    monkeypatch.setattr(knn, "knn_xy", counted("knn", knn.knn_xy))
    model = port_pipeline.build_model(cfg, seed=0, device="cpu")
    step = port_pipeline.make_train_step(cfg, model, *make_optimizer(cfg.optimizer, model), device="cpu")
    metrics = step(make_batch(cfg.data, n_sc=1, seed=0), torch.Generator().manual_seed(0))
    m, n = cfg.model, cfg.time_step_end
    post = m.tl_encoder.n_layer_tf + m.ag_encoder.n_layer_tf
    assert calls == {"knarpe_attention": m.mp_encoder.n_layer_tf, "bwd_attention": m.mp_encoder.n_layer_tf,
                     "knarpe_cross_attention": 2 * m.ag_encoder.n_layer_tf * n + post,
                     "bwd_cross": m.ag_encoder.n_layer_tf * n + post, "knn": 2 * n + 1}
    assert torch.isfinite(metrics["training/loss"]) and float(metrics["grad_norm"]) > 0


def test_train_step_needs_a_card_or_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    cfg = port_cfg(tiny_config())
    model = port_pipeline.build_model(cfg, seed=0, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_pipeline.make_train_step(cfg, model, *make_optimizer(cfg.optimizer, model))
